// Decode attention (one new token against the KV cache) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/kernel.py :: decode_attention_kernel
//   (launched by decode_attention_pallas, adapter ops.py :: decode_attention).
// Same function: the G query heads of each KV head attend to a
// fixed-capacity cache; keys at or past `length` are masked and never read.
// m, l and the accumulator are fp32; p is rounded to V's dtype before P.V
// and l sums the unrounded p, as in the Pallas kernel.
//
// `length` is read on the device from an int32 tensor, so the host never
// waits on it and a decode step stays capturable in a CUDA graph.
// Contract: length >= 1 (the model writes the new token's K/V before it
// attends). At length == 0 the kernel writes zeros, as the Pallas kernel
// does; the plain reference would give the mean of V.
//
// Layout. q, o: (B, 1, H, D); k, v: (B, L, Hk, D), read through their batch,
// position and head strides (innermost stride 1): the layer slice of the
// model's stacked cache (n_layers, B, L, Hk, D) goes in as a view, with no
// transposed copy of the cache.
//
// What bounds it on this card: bytes. At the serving shape (B=8, Hk=4,
// D=64, bf16, length 528) the kernel must read 2*B*Hk*length*D*2 = 4.3 MB of
// cache, about 1.3 us at 3.35 TB/s; its arithmetic is a few MFLOP. A Pallas
// grid walks the keys of one (b, hk) in order on one core; on Hopper one
// block per (b, hk) gives B*Hk = 32 blocks for 132 SMs, each walking its
// keys with one load in flight, and is latency-bound far above the bytes.
//
// Design (flash-decoding): the key axis is split over blocks.
//   Split kernels: grid (B*Hk, n_split), n_split = ceil(L / kSplit) from
//     the cache capacity L, never from `length` (the host does not read
//     it). Each block takes the G query rows of its (b, hk) against its
//     kSplit = 64 keys (at the serving shape 32 x 9 = 288 blocks). It reads
//     the query rows while `length` is in flight, then issues its K rows
//     and its V rows as 16-byte cp.async copies (neighbouring lanes on
//     neighbouring 16 bytes of a row) and computes the scores while V is
//     still in flight. V rows past `length` are zeroed in shared memory and
//     their p is 0, so P.V runs over the whole split. The block writes its
//     partial (m, l, acc[G, D]) in fp32 to scratch that the wrapper
//     allocates. A split that starts at or past `length` exits at once: it
//     is empty, and the merge never reads it.
//     bf16 (split_bf16_kernel, 4 warps): S = Q K^T and O = P V on the
//       tensor cores (mma.sync m16n8k16, fp32 accumulate) with the G heads
//       as the 16 rows of M, as the Pallas kernel folds them; K comes
//       straight from shared memory as B fragments, V through
//       ldmatrix.trans, P (rounded to bf16) from shared memory as A
//       fragments. Softmax: one warp per head.
//     fp32 (split_kernel, 8 warps): IEEE scalar arithmetic (fmaf, expf; no
//       TF32). Each key row is split over D/4 lanes that dot their 16 bytes
//       with the G query rows and sum by shuffles; P.V gives each thread two
//       columns of one or a few heads.
//   Head sizes: D in {16, 32, 64, 112, 128, 256}, with G * D <= 2048. The
//   Pallas kernel takes any D (its block spans D whole); the port's D = 112
//   (kimi-k2-1t-a32b) tiles as follows. bf16: 7 k16 steps of Q.K^T and 14
//   n8 tiles of P.V, rows of 224 bytes (14 cp.async chunks, padded to 240 in
//   shared memory, which keeps the fragment loads on distinct banks). fp32:
//   a key row is 28 chunks of 16 bytes, so 28 lanes work on it inside a
//   group of 32 whose last 4 lanes add zeros to the shuffle tree (a tree
//   over 28 lanes would mix in the next row's); P.V has 56 column pairs, so
//   4 groups of heads take 224 threads and the last 32 have no columns.
//   combine_kernel: grid (B*Hk, G), the log-sum-exp merge of the
//     ceil(length / kSplit) live partials:
//     o = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M). It is a
//     programmatic dependent launch of the split kernel, so its launch and
//     set-up overlap the split kernel and only its reads wait for it.
//   Neither kernel allocates; nothing on this path synchronises the host.
//
// Partial entry (decode_attention_partial_*): the same two kernels over one
// rank's span of a cache cut on its sequence axis, for the split-K decode
// of a sharded model (models/attention.py). The merge writes the span's
// normalised output in fp32 and its log-sum-exp lse = M + log(L) (of the
// scaled scores, natural log), so that the ranks' partials merge exactly
// as the splits do here. A span with no valid key (a local length of 0)
// gives o = 0 and lse = -inf, whose merge weight e^(lse - max) is 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kSplit = 64;             // keys per split block
constexpr int kThreads = 256;          // fp32 split and merge blocks
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;              // query heads per KV head
constexpr int kMaxGD = 2048;           // G * D

struct Params {
  int H, Hk, G, L, n_split;
  long long qsb, qsh;                  // q strides of batch, head
  long long ksb, ksl, ksh;             // k strides of batch, position, head
  long long vsb, vsl, vsh;
  float scale;
};

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(bf16* dst, float x) {
  *dst = __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const uint32_t dst =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------- fp32 ---
template <int D>
__global__ void __launch_bounds__(kThreads)
split_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const int* __restrict__ length_ptr,
                 float* __restrict__ part_ml, float* __restrict__ part_acc,
                 const Params p) {
  constexpr int kVec = 4;                         // elements per 16 bytes
  constexpr int kChunks = D / kVec;               // 16-byte chunks per row
  constexpr int kCpl = kChunks > 32 ? kChunks / 32 : 1;  // chunks per lane
  constexpr int kLpr = kChunks / kCpl;            // lanes at work on a row
  // lanes a row takes: kLpr rounded up to a power of two, so the shuffle
  // tree over them stays inside the row (D = 112: 28 lanes at work in a
  // group of 32, lanes 28-31 add zeros)
  constexpr int kLpg = kLpr <= 4 ? 4 : kLpr <= 8 ? 8 : kLpr <= 16 ? 16 : 32;
  constexpr int kRpw = 32 / kLpg;                 // key rows per warp step
  constexpr int kSteps =                          // warp steps a split
      (kSplit + kWarps * kRpw - 1) / (kWarps * kRpw);
  constexpr int kPairs = D / 2;                   // P.V: column pairs
  constexpr int kGroups = kThreads / kPairs;      // P.V: head groups
  constexpr int kGMax = kMaxGD / D < kMaxG ? kMaxGD / D : kMaxG;
  constexpr int kGPer = (kGMax + kGroups - 1) / kGroups;  // heads a thread
  constexpr int kPerLane = kSplit / 32;           // softmax: keys a lane
  constexpr int kQPer = (kGMax * D + kThreads - 1) / kThreads;  // q a thread
  static_assert(kSplit % 32 == 0 && kPairs <= kThreads
                && kChunks == kCpl * kLpr && kLpr <= 32, "tiling");

  extern __shared__ __align__(16) unsigned char smem[];
  const int G = p.G;
  float* k_s = reinterpret_cast<float*>(smem);               // (kSplit, D)
  float* v_s = k_s + kSplit * D;                             // (kSplit, D)
  float* q_s = v_s + kSplit * D;                             // (G, D)
  float* p_s = q_s + G * D;                                  // (G, kSplit)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / p.Hk, hk = bh % p.Hk;
  const int key0 = split * kSplit;
  // the merge kernel may launch now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // the query rows are read while `length` is in flight
  const int len = *length_ptr;
  const float* qb = q + b * p.qsb + static_cast<long long>(hk) * G * p.qsh;
  float qv[kQPer];
#pragma unroll
  for (int r = 0; r < kQPer; ++r) {
    const int i = tid + r * kThreads;
    if (i < G * D) qv[r] = qb[(i / D) * p.qsh + i % D];
  }
  const int n = min(kSplit, min(len, p.L) - key0);  // live keys
  if (n <= 0) return;          // at or past `length`: the merge skips it

  // K rows, then V rows, 16 bytes a thread; only the split's live keys.
  // V rows past them are zeros, so P.V runs over the whole split.
  const float* kb = k + b * p.ksb + hk * p.ksh + key0 * p.ksl;
  const float* vb = v + b * p.vsb + hk * p.vsh + key0 * p.vsl;
  for (int c = tid; c < n * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * kVec;
    cp_async16(k_s + r * D + col, kb + r * p.ksl + col);
  }
  cp_async_commit();
  for (int c = tid; c < n * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * kVec;
    cp_async16(v_s + r * D + col, vb + r * p.vsl + col);
  }
  cp_async_commit();
  for (int c = n * kChunks + tid; c < kSplit * kChunks; c += kThreads)
    *reinterpret_cast<uint4*>(v_s + c * kVec) = make_uint4(0, 0, 0, 0);

#pragma unroll
  for (int r = 0; r < kQPer; ++r) {
    const int i = tid + r * kThreads;
    if (i < G * D) q_s[i] = qv[r];
  }
  cp_async_wait<1>();              // K has landed; V may be in flight
  __syncthreads();

  // 1. scores: kLpr lanes per key row, each over kCpl chunks of 16 bytes;
  //    the row's kLpg lanes sum by shuffles, every head at once.
  const int row_in_step = lane / kLpg, sub = lane % kLpg;
#pragma unroll
  for (int it = 0; it < kSteps; ++it) {
    const int r = (it * kWarps + warp) * kRpw + row_in_step;
    float s[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
    if (r < n && sub < kLpr) {
#pragma unroll
      for (int c = 0; c < kCpl; ++c) {
        const int col = (sub + c * kLpr) * kVec;
        const float4 kx4 = *reinterpret_cast<const float4*>(k_s + r * D + col);
        const float kx[kVec] = {kx4.x, kx4.y, kx4.z, kx4.w};
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float* qg = q_s + g * D + col;
#pragma unroll
            for (int i = 0; i < kVec; i += 4) {
              const float4 qx = *reinterpret_cast<const float4*>(qg + i);
              s[g] = fmaf(qx.x, kx[i], s[g]);
              s[g] = fmaf(qx.y, kx[i + 1], s[g]);
              s[g] = fmaf(qx.z, kx[i + 2], s[g]);
              s[g] = fmaf(qx.w, kx[i + 3], s[g]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int off = kLpg / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G && g % kLpg == sub && r < kSplit)
        p_s[g * kSplit + r] = r < n ? s[g] * p.scale : kNegInf;
  }
  __syncthreads();

  // 2. softmax over the split's keys, one warp per query row; masked keys
  //    give p = 0 exactly.
  float* ml = part_ml + (static_cast<long long>(bh) * p.n_split + split)
                       * 2 * G;                              // m (G), l (G)
  for (int g = warp; g < G; g += kWarps) {
    float* row = p_s + g * kSplit;
    float x[kPerLane];
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      x[i] = row[lane + 32 * i];
      mx = fmaxf(mx, x[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      x[i] = expf(x[i] - mx);
      sum += x[i];
      row[lane + 32 * i] = x[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      ml[g] = mx;
      ml[G + g] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 3. acc(g, d) = sum_j p(g, j) v(j, d): two columns, kGPer heads a thread,
  //    over all kSplit keys (p and the V rows past n are 0). Threads past
  //    kGroups * kPairs (D = 112: 32 of 256) have no columns.
  const int pair = tid % kPairs, grp = tid / kPairs;
  if (grp >= kGroups) return;
  float acc[kGPer][2];
#pragma unroll
  for (int i = 0; i < kGPer; ++i) acc[i][0] = acc[i][1] = 0.f;
#pragma unroll 16
  for (int j = 0; j < kSplit; ++j) {
    const float2 vv = *reinterpret_cast<const float2*>(v_s + j * D + 2 * pair);
#pragma unroll
    for (int i = 0; i < kGPer; ++i) {
      const int g = grp + i * kGroups;
      if (g < G) {
        const float pj = p_s[g * kSplit + j];
        acc[i][0] = fmaf(pj, vv.x, acc[i][0]);
        acc[i][1] = fmaf(pj, vv.y, acc[i][1]);
      }
    }
  }
  float* pa = part_acc
              + (static_cast<long long>(bh) * p.n_split + split) * G * D;
#pragma unroll
  for (int i = 0; i < kGPer; ++i) {
    const int g = grp + i * kGroups;
    if (g < G)
      *reinterpret_cast<float2*>(pa + g * D + 2 * pair) =
          make_float2(acc[i][0], acc[i][1]);
  }
}

// ---------------------------------------------------------------- bf16 ---
// The same split on the tensor cores (mma.sync m16n8k16, fp32 accumulate),
// with the G query heads as the 16 rows of M (zero-padded past G), as the
// Pallas kernel folds them: S = Q K^T takes K's rows straight from shared
// memory as B fragments; O = P V takes P (rounded to bf16) as A fragments
// and V through ldmatrix.trans. Rows are padded by 8 elements so that
// fragment loads hit 32 distinct banks.
constexpr int kMmaThreads = 128;           // 4 warps
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kPadB = 8;                   // bf16 row padding

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, fp32 out.
// Fragments (PTX ISA, mma.m16n8k16), gr = lane / 4, tq = lane % 4:
//   A {(gr, 2tq..+1), (gr+8, 2tq..+1), (gr, 2tq+8..+9), (gr+8, 2tq+8..+9)}
//   B {(2tq..+1, gr), (2tq+8..+9, gr)}    C {(gr, 2tq..+1), (gr+8, 2tq..+1)}
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 8x8 bf16 matrices, transposed: rows 0-7 from lanes 0-7's addresses,
// rows 8-15 from lanes 8-15's.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1) : "r"(a));
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
split_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v,
                  const int* __restrict__ length_ptr,
                  float* __restrict__ part_ml, float* __restrict__ part_acc,
                  const Params p) {
  constexpr int kRow = D + kPadB;                 // K, V, Q row stride
  constexpr int kPRow = kSplit + kPadB;           // P row stride
  constexpr int kChunks = D / 8;                  // 16-byte chunks per row
  constexpr int kQPer = (16 * D + kMmaThreads - 1) / kMmaThreads;
  static_assert(kSplit == 64, "4 warps x 16 keys");

  extern __shared__ __align__(16) unsigned char smem[];
  const int G = p.G;
  bf16* k_s = reinterpret_cast<bf16*>(smem);       // (kSplit, kRow)
  bf16* v_s = k_s + kSplit * kRow;                 // (kSplit, kRow)
  bf16* q_s = v_s + kSplit * kRow;                 // (16, kRow)
  bf16* pb_s = q_s + 16 * kRow;                    // (16, kPRow): p in bf16
  float* p_s = reinterpret_cast<float*>(pb_s + 16 * kPRow);  // (G, kSplit)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;
  // the merge kernel may launch now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / p.Hk, hk = bh % p.Hk;
  const int key0 = split * kSplit;
  // the query rows (zero past G) are read while `length` is in flight
  const int len = *length_ptr;
  const bf16* qb = q + b * p.qsb + static_cast<long long>(hk) * G * p.qsh;
  bf16 qv[kQPer];
#pragma unroll
  for (int r = 0; r < kQPer; ++r) {
    const int i = tid + r * kMmaThreads, g = i / D;
    qv[r] = g < G && i < 16 * D ? qb[g * p.qsh + i % D]
                                : __float2bfloat16(0.f);
  }
  const int n = min(kSplit, min(len, p.L) - key0);  // live keys
  if (n <= 0) return;          // at or past `length`: the merge skips it

  // K rows, then V rows, 16 bytes a thread; only the split's live keys.
  // V rows past them are zeros, so P.V runs over the whole split.
  const bf16* kb = k + b * p.ksb + hk * p.ksh + key0 * p.ksl;
  const bf16* vb = v + b * p.vsb + hk * p.vsh + key0 * p.vsl;
  for (int c = tid; c < n * kChunks; c += kMmaThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    cp_async16(k_s + r * kRow + col, kb + r * p.ksl + col);
  }
  cp_async_commit();
  for (int c = tid; c < n * kChunks; c += kMmaThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    cp_async16(v_s + r * kRow + col, vb + r * p.vsl + col);
  }
  cp_async_commit();
  for (int c = n * kChunks + tid; c < kSplit * kChunks; c += kMmaThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    *reinterpret_cast<uint4*>(v_s + r * kRow + col) = make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int r = 0; r < kQPer; ++r) {
    const int i = tid + r * kMmaThreads;
    if (i < 16 * D) q_s[(i / D) * kRow + i % D] = qv[r];
  }
  cp_async_wait<1>();              // K has landed; V may be in flight
  __syncthreads();

  // 1. S = Q K^T: warp w takes keys 16w .. 16w+15 (two n8 tiles).
  {
    float sc[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int d0 = ks * 16 + 2 * tq;
      const uint32_t a[4] = {lds32(q_s + gr * kRow + d0),
                             lds32(q_s + (gr + 8) * kRow + d0),
                             lds32(q_s + gr * kRow + d0 + 8),
                             lds32(q_s + (gr + 8) * kRow + d0 + 8)};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bf16* kr = k_s + (warp * 16 + i * 8 + gr) * kRow + d0;
        mma_16816(sc[i], a, lds32(kr), lds32(kr + 8));
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = gr + 8 * (e >> 1);
        const int key = warp * 16 + i * 8 + 2 * tq + (e & 1);
        if (g < G) p_s[g * kSplit + key] = key < n ? sc[i][e] * p.scale
                                                   : kNegInf;
      }
    }
  }
  __syncthreads();

  // 2. softmax over the split's keys, one warp per query row; masked keys
  //    give p = 0 exactly.
  float* ml = part_ml + (static_cast<long long>(bh) * p.n_split + split)
                       * 2 * G;                              // m (G), l (G)
  for (int g = warp; g < G; g += kMmaWarps) {
    const float* row = p_s + g * kSplit;
    const float x0 = row[lane], x1 = row[lane + 32];
    float mx = fmaxf(x0, x1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float e0 = expf(x0 - mx), e1 = expf(x1 - mx);
    float sum = e0 + e1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    pb_s[g * kPRow + lane] = __float2bfloat16(e0);
    pb_s[g * kPRow + lane + 32] = __float2bfloat16(e1);
    if (lane == 0) {
      ml[g] = mx;
      ml[G + g] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 3. O = P V over the split's 64 keys: warp w takes the n8 column tiles
  //    w, w + 4, ... of D; rows past G are never stored.
  uint32_t pa[kSplit / 16][4];
#pragma unroll
  for (int kk = 0; kk < kSplit / 16; ++kk) {
    const int c0 = kk * 16 + 2 * tq;
    pa[kk][0] = lds32(pb_s + gr * kPRow + c0);
    pa[kk][1] = lds32(pb_s + (gr + 8) * kPRow + c0);
    pa[kk][2] = lds32(pb_s + gr * kPRow + c0 + 8);
    pa[kk][3] = lds32(pb_s + (gr + 8) * kPRow + c0 + 8);
  }
  float* pacc = part_acc
                + (static_cast<long long>(bh) * p.n_split + split) * G * D;
#pragma unroll
  for (int nt = warp; nt < D / 8; nt += kMmaWarps) {
    float o[4] = {};
#pragma unroll
    for (int kk = 0; kk < kSplit / 16; ++kk) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, v_s + (kk * 16 + lane % 16) * kRow + nt * 8);
      mma_16816(o, pa[kk], b0, b1);
    }
    const int d = nt * 8 + 2 * tq;
    if (gr < G)
      *reinterpret_cast<float2*>(pacc + gr * D + d) = make_float2(o[0], o[1]);
    if (gr + 8 < G)
      *reinterpret_cast<float2*>(pacc + (gr + 8) * D + d) =
          make_float2(o[2], o[3]);
  }
}

template <int D>
size_t split_smem(const bf16*, int G) {
  return (2 * kSplit + 16) * (D + kPadB) * sizeof(bf16)
         + 16 * (kSplit + kPadB) * sizeof(bf16)
         + static_cast<size_t>(G) * kSplit * sizeof(float);
}
template <int D>
size_t split_smem(const float*, int G) {
  return 2 * kSplit * D * sizeof(float)
         + static_cast<size_t>(G) * (D + kSplit) * sizeof(float);
}

template <int D>
cudaError_t launch_split(const bf16* q, const bf16* k, const bf16* v,
                         const int* length, float* part_ml, float* part_acc,
                         int B, const Params& p, size_t smem,
                         cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  split_bf16_kernel<D><<<dim3(B * p.Hk, p.n_split), kMmaThreads, smem,
                         stream>>>(q, k, v, length, part_ml, part_acc, p);
  return cudaGetLastError();
}
template <int D>
cudaError_t launch_split(const float* q, const float* k, const float* v,
                         const int* length, float* part_ml, float* part_acc,
                         int B, const Params& p, size_t smem,
                         cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  split_f32_kernel<D><<<dim3(B * p.Hk, p.n_split), kThreads, smem,
                        stream>>>(q, k, v, length, part_ml, part_acc, p);
  return cudaGetLastError();
}

// The log-sum-exp merge of one (b, hk, g)'s live partials. Warp 0 finds M
// and L across the splits and leaves each split's weight e^(m_s - M) / L in
// shared memory; then each thread sums two columns over every groups-th
// split, and the groups' sums are added in shared memory. Launched as a
// programmatic dependent of the split kernel: its blocks start while the
// split kernel runs and wait (griddepcontrol.wait) before reading partials.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ part_ml,
               const float* __restrict__ part_acc,
               const int* __restrict__ length_ptr, T* __restrict__ o,
               float* __restrict__ lse, const Params p, const int D) {
  extern __shared__ float w_s[];          // (n_split,) then (groups, D)
  const int bh = blockIdx.x, g = blockIdx.y, G = p.G;
  const int tid = threadIdx.x, lane = tid % 32;
  const int b = bh / p.Hk, hk = bh % p.Hk;
  const int n_live = (max(min(*length_ptr, p.L), 0) + kSplit - 1) / kSplit;
  const long long part0 = static_cast<long long>(bh) * p.n_split;
  const float* ml = part_ml + part0 * 2 * G;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  if (tid < 32) {
    float M = kNegInf;
    for (int s = lane; s < n_live; s += 32) M = fmaxf(M, ml[s * 2 * G + g]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float L = 0.f;
    for (int s = lane; s < n_live; s += 32)
      L += ml[s * 2 * G + G + g] * expf(ml[s * 2 * G + g] - M);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      L += __shfl_xor_sync(0xffffffffu, L, off);
    const float inv = 1.f / fmaxf(L, 1e-30f);
    for (int s = lane; s < n_live; s += 32)
      w_s[s] = expf(ml[s * 2 * G + g] - M) * inv;
    // the partial entry's log-sum-exp; -inf over no valid key
    if (lse != nullptr && lane == 0)
      lse[static_cast<long long>(b) * p.H + hk * G + g] =
          n_live > 0 ? M + logf(L) : -__int_as_float(0x7f800000);
  }
  __syncthreads();

  const int pairs = D / 2, groups = kThreads / pairs;
  const int pair = tid % pairs, grp = tid / pairs;
  const float* acc = part_acc + (part0 * G + g) * D + 2 * pair;
  float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
  for (int s = grp; s < n_live; s += groups) {
    const float w = w_s[s];
    const float2 x = *reinterpret_cast<const float2*>(
        acc + static_cast<long long>(s) * G * D);
    a0 = fmaf(w, x.x, a0);
    a1 = fmaf(w, x.y, a1);
  }
  float2* red = reinterpret_cast<float2*>(w_s + (p.n_split + 1) / 2 * 2);
  red[grp * pairs + pair] = make_float2(a0, a1);
  __syncthreads();
  if (grp == 0) {
    for (int r = 1; r < groups; ++r) {
      const float2 x = red[r * pairs + pair];
      a0 += x.x;
      a1 += x.y;
    }
    T* out = o + (static_cast<long long>(b) * p.H + hk * G + g) * D;
    store(out + 2 * pair, a0);
    store(out + 2 * pair + 1, a1);
  }
}

template <typename T, typename TO, int D>
int run(const T* q, const T* k, const T* v, const int* length, TO* o,
        float* lse, float* part_ml, float* part_acc, int B, const Params& p,
        cudaStream_t stream) {
  const size_t smem_w = ((p.n_split + 1) / 2 * 2) * sizeof(float)
                        + kThreads * sizeof(float2);
  cudaError_t err = launch_split<D>(q, k, v, length, part_ml, part_acc, B, p,
                                    split_smem<D>(q, p.G), stream);
  if (err == cudaSuccess && smem_w > 48 * 1024)
    err = cudaFuncSetAttribute(combine_kernel<TO>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_w));
  if (err != cudaSuccess) return static_cast<int>(err);
  // the merge as a programmatic dependent launch of the split kernel
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * p.Hk, p.G);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_w;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, combine_kernel<TO>, static_cast<const float*>(part_ml),
      static_cast<const float*>(part_acc), length, o, lse, p, D));
}

template <typename T, typename TO>
int launch(const T* q, const T* k, const T* v, const int* length, TO* o,
           float* lse, float* scratch, long long scratch_floats, int B, int D,
           const Params& p, cudaStream_t stream) {
  const long long parts = static_cast<long long>(B) * p.Hk * p.n_split * p.G;
  if (p.G > kMaxG || p.G * D > kMaxGD || scratch_floats < parts * (2 + D))
    return static_cast<int>(cudaErrorInvalidValue);
  float* part_ml = scratch;                 // (B*Hk, n_split, 2, G)
  float* part_acc = scratch + parts * 2;    // (B*Hk, n_split, G, D)
  switch (D) {
#define DECODE_RUN(DIM)                                                        \
    case DIM:                                                                  \
      return run<T, TO, DIM>(q, k, v, length, o, lse, part_ml, part_acc, B,  \
                             p, stream);
    DECODE_RUN(16) DECODE_RUN(32) DECODE_RUN(64) DECODE_RUN(112)
    DECODE_RUN(128) DECODE_RUN(256)
#undef DECODE_RUN
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Keys per split block: the wrapper sizes its scratch with it,
// B*Hk*ceil(L/kSplit)*G*(2 + D) floats.
extern "C" int decode_attention_keys_per_split() { return kSplit; }

// C entry points. Pointers are device pointers; `length` points to one
// int32 on the device; `scratch` holds `scratch_floats` fp32 values. Strides
// are in elements (innermost stride 1); the caller guarantees H % Hk == 0,
// D in {16, 32, 64, 112, 128, 256} with (H / Hk) * D <= 2048 and H / Hk <= 16,
// and 16-byte aligned cache rows. o is a contiguous (B, 1, H, D): in q's
// dtype for decode_attention_*, fp32 for decode_attention_partial_*, whose
// `lse` is a contiguous fp32 (B, H) (nullptr elsewhere). Returns
// cudaGetLastError() after the two launches, or cudaErrorInvalidValue for a
// shape it does not take or a scratch too small.
#define DECODE_ENTRY(NAME, T, TO, LSE_ARG, LSE)                                \
  extern "C" int NAME(const void* q, const void* k, const void* v,            \
                      const void* length, void* o, LSE_ARG void* scratch,     \
                      long long scratch_floats, int B, int H, int Hk,         \
                      int L, int D, long long qsb, long long qsh,             \
                      long long ksb, long long ksl, long long ksh,            \
                      long long vsb, long long vsl, long long vsh,            \
                      void* stream) {                                          \
    const Params p{H, Hk, H / Hk, L, (L + kSplit - 1) / kSplit, qsb, qsh,      \
                   ksb, ksl, ksh, vsb, vsl, vsh,                               \
                   1.0f / sqrtf(static_cast<float>(D))};                       \
    return launch<T, TO>(static_cast<const T*>(q), static_cast<const T*>(k),   \
                         static_cast<const T*>(v),                             \
                         static_cast<const int*>(length), static_cast<TO*>(o), \
                         LSE, static_cast<float*>(scratch), scratch_floats, B, \
                         D, p, static_cast<cudaStream_t>(stream));             \
  }

#define NO_LSE_PARAM
#define LSE_PARAM void* lse,
DECODE_ENTRY(decode_attention_bf16, bf16, bf16, NO_LSE_PARAM, nullptr)
DECODE_ENTRY(decode_attention_f32, float, float, NO_LSE_PARAM, nullptr)
DECODE_ENTRY(decode_attention_partial_bf16, bf16, float, LSE_PARAM,
             static_cast<float*>(lse))
DECODE_ENTRY(decode_attention_partial_f32, float, float, LSE_PARAM,
             static_cast<float*>(lse))
