// Mamba-2 SSD chunked scan for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd/kernel.py :: ssd_kernel
//   (launched by ssd_pallas, adapter ops.py :: ssd).
// Same function, plus what the model's own scan (models/ssm.py ::
// ssd_chunked) has and the Pallas kernel leaves out: an incoming state and
// the final state. For each (b, h) the sequence is cut into chunks, an fp32
// (P, N) state is carried from chunk to chunk, and within a chunk
//   y     = ((C B^T) o L) (x dt)  +  exp(cum) * (C state^T)
//   state = state * exp(cum[-1])  +  ((x dt) * exp(cum[-1] - cum))^T B
// with cum the prefix sum of dt * A and L = exp(cum_i - cum_j) for i >= j,
// 0 above the diagonal. L is formed by selecting 0 above the diagonal,
// never by multiplying with a 0/1 mask: exp(cum_i - cum_j) overflows to inf
// there and inf * 0 is NaN. y is written in x's dtype, before the model
// adds its D skip, as the reference rounds it.
//
// The chunk length is the kernel's own, kQ = 64 positions. SSD's output and
// final state depend on the chunk length only through rounding, so the
// caller's chunk (256 on the serving path) is checked by the wrapper and
// not used here. A ragged tail (S not a multiple of kQ) is padded with
// dt = x = B = C = 0, which adds nothing and decays nothing.
//
// Layout. x, y: (B, S, H, P); dt: (B, S, H); B, C: (B, S, N), shared by the
// heads (G = 1); A: (H,) fp32; state0 and the final state: (B, H, P, N)
// fp32. All are read through their strides (innermost stride 1 except dt),
// so the model's tensors go in as they are; state0 and the final state may
// be the same memory (one layer's slice of the model's stacked cache,
// updated in place): every state row is read by the one warp that owns it,
// before its chunk loop, and written by the same warp after it.
//
// Bound on this card, at the serving shape (B=8, S=512, H=32, P=64,
// N=128, bf16, dt fp32, random state0): the bytes. The function must read
// x (16.8 MB bf16), dt (0.5 MB), B and C (1 MB each) and the incoming
// state (8.4 MB fp32) and write y (16.8 MB) and the final state (8.4 MB):
// 53 MB, or 0.0158 ms at 3.35 TB/s. Its products at kQ = 64, lower
// triangles only, are about 5.9 GFLOP, 0.006 ms at the bf16 tensor-core
// peak.
//
// bf16 design (ssd_bf16_kernel). The rows p of the state never mix:
// state[p, :] depends only on x[:, p], and y[:, p] only on state[p, :]. So
// each warp owns a slice of 16 state rows (the M of an mma.sync m16n8k16),
// held in its registers as fp32 accumulators for the whole sequence, and a
// block holds W = 4, 2 or 1 such slices of one (b, h), as many as P fills
// (the P axis splits over more blocks past 64 rows). The warps of a block
// share what is common to the head's rows: the chunk's B and C, dt and its
// prefix sum, and M = (C B^T) o L o dt_j. Per chunk, on the tensor cores
// (bf16 in, fp32 accumulate):
//   1. M: the ten 16x16 blocks of C B^T on or below the diagonal (exact: C
//      and B are bf16), split over the warps in loops of fixed length, times
//      exp(cum_i - cum_j) dt_j, rounded to bf16 into shared memory;
//   2. y^T = state C^T, with the state's accumulators reused as A fragments
//      (rounded to bf16), scaled by exp(cum_i);
//   3. y^T += x^T M^T, causal tiles only (x is exact bf16);
//   4. state = state * exp(cum[-1]) + (x w)^T B, w_j = dt_j exp(cum[-1] -
//      cum_j), with x w carried as a bf16 hi/lo pair (two products, about
//      2^-17 relative) so the state keeps fp32-level accuracy with no TF32.
// C B^T is computed once a block for its slices; each of a sequence's H
// heads repeats it (40 of a warp's ~250 mma a chunk at the serving shape).
// The single bf16 roundings in 1 and 2 only reach y, which is bf16 itself;
// tests/test_torch_ssd_split.py emulates this rounding on the CPU. The
// next chunk's x, B and C arrive by 16-byte cp.async into a second stage
// while this one computes, and warp 0 takes the next chunk's prefix sum at
// the end of this one. Shared memory at N = 128, W = 4: 99,328 bytes (two
// stages of B, C and x, M, the per-position scalars), so two blocks of
// four warps an SM, and the serving shape's B*H = 256 blocks fill 132 SMs
// in one wave. The P axis could split over more blocks (W = 2 or 1), but
// every block then stages the chunk's whole B and C and repeats C B^T, so
// two blocks an SM remain and the waves multiply: slower on the H100 at
// both the serving shape and a batch-1 8192-token prompt (PERF.md).
//
// Under grad (training) the caller may ask for the state entering each
// chunk, fp32 (B, H, nc, P, N): csrc/ssd_bwd.cu reads it. Each warp writes
// its own rows from its registers before the chunk's update (the fp32
// kernel from shared memory); serving passes null and writes none.
//
// fp32 design (ssd_f32_kernel, not on the serving path): scalar IEEE FMA,
// one block of 256 threads per (b, h), the state in shared memory
// transposed to (N, P), each product in 4x4 register tiles; 133 KB of
// shared memory at P = 64, N = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kQ = 64;           // positions per chunk

struct Params {
  int S, H, P, N;
  long long xsb, xss, xsh;       // x strides of batch, position, head
  long long dsb, dss, dsh;       // dt
  long long bsb, bss;            // B strides of batch, position
  long long csb, css;            // C
  long long ysb, yss, ysh;       // y
  long long isb, ish, isp;       // state0 strides of batch, head, p
  long long fsb, fsh, fsp;       // final state
  int dt_bf16;                   // dt is bf16 (else fp32); bf16 kernel only
};

// ---------------------------------------------------------------- fp32 ---
constexpr int kThreads = 256;
constexpr int kT = kQ / 4;       // 4x4 tiles along a chunk
constexpr int kQPad = kQ + 4;    // row stride of C^T in shared memory

__device__ __forceinline__ void unpack(const float* src, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// Shared memory of one block of the fp32 kernel, in floats.
__host__ __device__ constexpr int f32_smem_floats(int P, int N) {
  return kQ * P            // x * dt          (kQ, P)
         + kQ * N          // B               (kQ, N)
         + N * kQPad       // C^T             (N, kQ + 4)
         + N * (P + 4)     // state^T         (N, P + 4)
         + kQ * kQ         // M^T             (kQ, kQ)
         + 3 * kQ;         // dt, cum, decay  (kQ,) each
}

// One block per (b, h); per chunk, with every operand staged in shared
// memory as fp32:
//   1. M = (C B^T) o L, in 4x4 tiles, one per thread, above the diagonal
//      skipped;
//   2. y = M (x dt) + exp(cum) * (C state^T), in 4x4 tiles of (i, p);
//   3. state = state * exp(cum[-1]) + (x dt * decay)^T B, 4x4 tiles of (n, p).
__global__ void __launch_bounds__(kThreads)
ssd_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* state0,
               float* __restrict__ y, float* final_state,
               float* __restrict__ chunk_states, const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int P = p.P, N = p.N, PP = P + 4;
  const int P4 = P / 4, N4 = N / 4;
  float* xdt = smem;               // xdt[j * P + p]
  float* bs = xdt + kQ * P;        // bs[j * N + n]
  float* ct = bs + kQ * N;         // ct[n * kQPad + j]
  float* st = ct + N * kQPad;      // st[n * PP + p]
  float* mt = st + N * PP;         // mt[j * kQ + i] = M[i][j]
  float* dtv = mt + kQ * kQ;       // dt of each position
  float* cum = dtv + kQ;           // prefix sum of dt * A within the chunk
  float* dec = cum + kQ;           // exp(cum[kQ-1] - cum[j])

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const float a = A[h];
  const float* xb = x + b * p.xsb + h * p.xsh;
  const float* db = dt + b * p.dsb + h * p.dsh;
  const float* Bb = Bm + b * p.bsb;
  const float* Cb = Cm + b * p.csb;
  float* yb = y + b * p.ysb + h * p.ysh;

  for (int e = tid; e < P * N; e += kThreads) {
    const int pi = e / N, n = e % N;
    st[n * PP + pi] =
        state0 ? state0[b * p.isb + h * p.ish + pi * p.isp + n] : 0.f;
  }

  for (int s0 = 0; s0 < p.S; s0 += kQ) {
    const int nq = min(kQ, p.S - s0);
    __syncthreads();  // the previous chunk's operands are consumed
    if (chunk_states) {
      const long long nc = (p.S + kQ - 1) / kQ;
      float* dst = chunk_states + (blockIdx.x * nc + s0 / kQ) * P * N;
      for (int e = tid; e < P * N; e += kThreads)
        dst[e] = st[(e % N) * PP + e / N];
    }

    // 0. dt and the prefix sum of dt * A (warp 0, two positions a lane);
    //    padded positions have dt = 0, so cum stays flat past the tail.
    if (tid < 32) {
      const int j0 = 2 * tid, j1 = j0 + 1;
      const float d0 = j0 < nq ? db[(s0 + j0) * p.dss] : 0.f;
      const float d1 = j1 < nq ? db[(s0 + j1) * p.dss] : 0.f;
      const float l0 = d0 * a, l1 = d1 * a;
      float incl = l0 + l1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      const float last = __shfl_sync(0xffffffffu, incl, 31);
      const float c0 = excl + l0;
      dtv[j0] = d0;
      dtv[j1] = d1;
      cum[j0] = c0;
      cum[j1] = incl;
      dec[j0] = expf(last - c0);
      dec[j1] = expf(last - incl);
    }
    __syncthreads();

    // Operands of the chunk into shared memory; zero past the tail.
    for (int e = tid; e < kQ * P; e += kThreads) {
      const int j = e / P, pi = e % P;
      xdt[e] = j < nq ? xb[(s0 + j) * p.xss + pi] * dtv[j] : 0.f;
    }
    for (int e = tid; e < kQ * N; e += kThreads) {
      const int j = e / N, n = e % N;
      const bool live = j < nq;
      bs[e] = live ? Bb[(s0 + j) * p.bss + n] : 0.f;
      ct[n * kQPad + j] = live ? Cb[(s0 + j) * p.css + n] : 0.f;
    }
    __syncthreads();

    // 1. M = (C B^T) o L on and below the diagonal, stored transposed.
    for (int tile = tid; tile < kT * kT; tile += kThreads) {
      const int ti = tile % kT, tj = tile / kT;
      if (tj > ti) continue;
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float c[4];
        unpack(ct + n * kQPad + 4 * ti, c);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float bv = bs[(4 * tj + jj) * N + n];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
            acc[ii][jj] = fmaf(c[ii], bv, acc[ii][jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * tj + jj;
        float m[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int i = 4 * ti + ii;
          m[ii] = i >= j ? acc[ii][jj] * expf(cum[i] - cum[j]) : 0.f;
        }
        *reinterpret_cast<float4*>(mt + j * kQ + 4 * ti) =
            make_float4(m[0], m[1], m[2], m[3]);
      }
    }
    __syncthreads();

    // 2. y = M (x dt) + exp(cum) * (C state^T) for the chunk's live rows.
    for (int tile = tid; tile < kT * P4; tile += kThreads) {
      const int tp = tile % P4, ti = tile / P4;
      if (4 * ti >= nq) continue;
      float intra[4][4] = {}, inter[4][4] = {};
      const int jmax = min(4 * ti + 4, nq);  // causal: j <= i
      for (int j = 0; j < jmax; ++j) {
        float m[4], xv[4];
        unpack(mt + j * kQ + 4 * ti, m);
        unpack(xdt + j * P + 4 * tp, xv);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int pp = 0; pp < 4; ++pp)
            intra[ii][pp] = fmaf(m[ii], xv[pp], intra[ii][pp]);
      }
      for (int n = 0; n < N; ++n) {
        float c[4], sv[4];
        unpack(ct + n * kQPad + 4 * ti, c);
        unpack(st + n * PP + 4 * tp, sv);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int pp = 0; pp < 4; ++pp)
            inter[ii][pp] = fmaf(c[ii], sv[pp], inter[ii][pp]);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = 4 * ti + ii;
        if (i < nq) {
          const float din = expf(cum[i]);
          float* yr = yb + (s0 + i) * p.yss + 4 * tp;
#pragma unroll
          for (int pp = 0; pp < 4; ++pp)
            yr[pp] = intra[ii][pp] + inter[ii][pp] * din;
        }
      }
    }
    __syncthreads();  // step 2 read the state that step 3 overwrites

    // 3. state = state * exp(cum[-1]) + (x dt * decay)^T B.
    const float total = expf(cum[kQ - 1]);
    for (int tile = tid; tile < N4 * P4; tile += kThreads) {
      const int tp = tile % P4, tn = tile / P4;
      float acc[4][4] = {};   // [n][p]
      for (int j = 0; j < nq; ++j) {
        float xv[4], bv[4];
        unpack(xdt + j * P + 4 * tp, xv);
        unpack(bs + j * N + 4 * tn, bv);
        const float d = dec[j];
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) xv[pp] *= d;
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int pp = 0; pp < 4; ++pp)
            acc[nn][pp] = fmaf(bv[nn], xv[pp], acc[nn][pp]);
      }
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        float* row = st + (4 * tn + nn) * PP + 4 * tp;
        float sv[4];
        unpack(row, sv);
        *reinterpret_cast<float4*>(row) = make_float4(
            sv[0] * total + acc[nn][0], sv[1] * total + acc[nn][1],
            sv[2] * total + acc[nn][2], sv[3] * total + acc[nn][3]);
      }
    }
  }
  __syncthreads();

  if (final_state) {
    for (int e = tid; e < P * N; e += kThreads) {
      const int pi = e / N, n = e % N;
      final_state[b * p.fsb + h * p.fsh + pi * p.fsp + n] = st[n * PP + pi];
    }
  }
}

// ---------------------------------------------------------------- bf16 ---
constexpr int kSlice = 16;       // state rows a warp owns (the mma's M)
constexpr int kMaxWarps = 4;     // slices a block
constexpr int kPad = 8;          // bf16 row padding: ldmatrix rows hit
                                 // distinct banks
constexpr int kLowerPairs = 10;  // 16x16 blocks on or below the diagonal
                                 // of a kQ x kQ matrix (4 row bands of
                                 // 1..4 blocks)
constexpr int kRowM = kQ + kPad; // row stride of M in shared memory

// Shared memory of one block of the bf16 kernel, in bytes.
__host__ __device__ constexpr int bf16_smem_bytes(int N, int warps) {
  return 2 * 4 * kQ * 4                          // dt, cum, exp(cum), w x 2
         + 2 * 2 * kQ * (N + kPad) * 2           // C, B          x 2 stages
         + kQ * kRowM * 2                        // M
         + 2 * kQ * (kSlice * warps + kPad) * 2; // x (y staging) x 2 stages
}

template <int N, int W>
__global__ void __launch_bounds__(W * 32, 2)
ssd_bf16_kernel(const bf16* __restrict__ x, const void* __restrict__ dt,
                const float* __restrict__ A, const bf16* __restrict__ Bm,
                const bf16* __restrict__ Cm, const float* state0,
                bf16* __restrict__ y, float* final_state,
                float* __restrict__ chunk_states, const Params p) {
  constexpr int kRowBC = N + kPad;   // row stride of B and C
  constexpr int kNT = N / 8;         // 8-column tiles of a state row
  constexpr int kKS = N / 16;        // 16-deep steps over the state's N
  constexpr int kVecBC = N / 8;      // 16-byte pieces of a B or C row
  constexpr int PB = kSlice * W;     // state rows of this block
  constexpr int kRowX = PB + kPad;   // row stride of x
  static_assert(N % 16 == 0 && N <= 128 && W >= 1 && W <= kMaxWarps, "N, W");
  extern __shared__ __align__(16) unsigned char smem_tc[];
  float* sc = reinterpret_cast<float*>(smem_tc);         // [2][4][kQ]
  bf16* cs = reinterpret_cast<bf16*>(sc + 2 * 4 * kQ);   // [2][kQ][kRowBC]
  bf16* bs = cs + 2 * kQ * kRowBC;                       // [2][kQ][kRowBC]
  bf16* ms = bs + 2 * kQ * kRowBC;                       // [kQ][kRowM]
  bf16* xs = ms + kQ * kRowM;                            // [2][kQ][kRowX]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int S = p.S, P = p.P;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int p0 = blockIdx.y * PB;          // the block's first state row
  const int pw = p0 + kSlice * warp;       // the warp's first state row
  const int xcol = kSlice * warp;          // ... as a column of xs
  const float a = A[h];
  const bf16* xb = x + b * p.xsb + h * p.xsh;
  const bf16* Bb = Bm + b * p.bsb;
  const bf16* Cb = Cm + b * p.csb;
  bf16* yb = y + b * p.ysb + h * p.ysh;
  const long long dbase = b * p.dsb + h * p.dsh;
  const int nc = (S + kQ - 1) / kQ;

  // x, B and C of chunk c into stage `stage`, 16 bytes a copy, zeros past
  // the tail and past the last state row.
  auto load_chunk = [&](int c, int stage) {
    const int s0 = c * kQ, nq = min(kQ, S - s0);
    bf16* cd = cs + stage * kQ * kRowBC;
    bf16* bd = bs + stage * kQ * kRowBC;
    bf16* xd = xs + stage * kQ * kRowX;
#pragma unroll
    for (int e = tid; e < kQ * kVecBC; e += 32 * W) {
      const int j = e / kVecBC, q = e % kVecBC;
      const bool live = j < nq;
      const long long s = live ? s0 + j : 0;
      cp_async16(cd + j * kRowBC + 8 * q, Cb + s * p.css + 8 * q, live);
      cp_async16(bd + j * kRowBC + 8 * q, Bb + s * p.bss + 8 * q, live);
    }
    constexpr int xv = PB / 8;
#pragma unroll
    for (int e = tid; e < kQ * xv; e += 32 * W) {
      const int j = e / xv, q = e % xv;
      const bool live = j < nq && p0 + 8 * q < P;
      const long long off = live ? (s0 + j) * p.xss + p0 + 8 * q : 0;
      cp_async16(xd + j * kRowX + 8 * q, xb + off, live);
    }
    cp_async_commit();
  };

  // dt of chunk c, positions 2 lane and 2 lane + 1 (warp 0); 0 past the tail
  auto load_dt = [&](int c, float& d0, float& d1) {
    const int s0 = c * kQ, nq = min(kQ, S - s0), j0 = 2 * lane;
    const long long o0 = dbase + (s0 + j0) * p.dss, o1 = o0 + p.dss;
    if (p.dt_bf16) {
      const bf16* d = static_cast<const bf16*>(dt);
      d0 = j0 < nq ? __bfloat162float(d[o0]) : 0.f;
      d1 = j0 + 1 < nq ? __bfloat162float(d[o1]) : 0.f;
    } else {
      const float* d = static_cast<const float*>(dt);
      d0 = j0 < nq ? d[o0] : 0.f;
      d1 = j0 + 1 < nq ? d[o1] : 0.f;
    }
  };

  // The prefix sum of dt * A (warp 0), into scalar buffer `buf`: dt, cum,
  // exp(cum) and w = dt exp(cum[-1] - cum); padded positions have dt = 0,
  // so cum stays flat past the tail.
  auto scan = [&](float d0, float d1, int buf) {
    const int j0 = 2 * lane, j1 = j0 + 1;
    const float l0 = d0 * a, l1 = d1 * a;
    float incl = l0 + l1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    const float last = __shfl_sync(0xffffffffu, incl, 31);
    const float c0 = excl + l0;
    float* v = sc + buf * 4 * kQ;
    v[j0] = d0;
    v[j1] = d1;
    v[kQ + j0] = c0;
    v[kQ + j1] = incl;
    v[2 * kQ + j0] = expf(c0);
    v[2 * kQ + j1] = expf(incl);
    v[3 * kQ + j0] = d0 * expf(last - c0);
    v[3 * kQ + j1] = d1 * expf(last - incl);
  };

  load_chunk(0, 0);

  // The warp's 16 state rows, fp32, as accumulators: st[t] holds rows
  // pw + gr and pw + gr + 8, columns 8t + 2tq and 8t + 2tq + 1.
  float st[kNT][4];
#pragma unroll
  for (int t = 0; t < kNT; ++t)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = pw + gr + 8 * half, n = 8 * t + 2 * tq;
      const long long off = b * p.isb + h * p.ish + row * p.isp + n;
      const bool live = state0 != nullptr && row < P;
      st[t][2 * half] = live ? state0[off] : 0.f;
      st[t][2 * half + 1] = live ? state0[off + 1] : 0.f;
    }

  if (warp == 0) {
    float d0, d1;
    load_dt(0, d0, d1);
    scan(d0, d1, 0);
  }

  for (int c = 0; c < nc; ++c) {
    const int stage = c & 1, s0 = c * kQ, nq = min(kQ, S - s0);
    cp_async_wait_all();
    __syncthreads();   // chunk c and its scalars have landed; chunk c - 1
                       // is consumed by every warp
    if (c + 1 < nc) load_chunk(c + 1, stage ^ 1);
    float dn0 = 0.f, dn1 = 0.f;   // next chunk's dt, scanned at the end
    if (warp == 0 && c + 1 < nc) load_dt(c + 1, dn0, dn1);

    if (chunk_states) {   // the state entering chunk c, before step 4
      float* dst = chunk_states
                   + (static_cast<long long>(blockIdx.x) * nc + c) * P * N;
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = pw + gr + 8 * half;
          if (row < P)
            *reinterpret_cast<float2*>(dst + row * N + 8 * t + 2 * tq) =
                make_float2(st[t][2 * half], st[t][2 * half + 1]);
        }
    }

    const float* dtv = sc + stage * 4 * kQ;
    const float* cum = dtv + kQ;
    const float* ecum = cum + kQ;
    const float* wv = ecum + kQ;
    const bf16* cc = cs + stage * kQ * kRowBC;
    const bf16* bb = bs + stage * kQ * kRowBC;
    bf16* xx = xs + stage * kQ * kRowX;

    // 1. M = (C B^T) o L o dt_j, this warp's share of the ten 16x16 blocks
    //    on or below the diagonal, row-major: blocks u0..u1-1. The loops
    //    have fixed trip counts and no branch (a warp with one block fewer
    //    repeats its last and stores the same values again), so the
    //    compiler can issue the fragment loads ahead of the products.
    {
      constexpr int kPairs = (kLowerPairs + W - 1) / W;
      const int u0 = warp * kLowerPairs / W;
      const int u1 = (warp + 1) * kLowerPairs / W;
      int mt[kPairs], nt[kPairs];        // row band, column block
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const int u = min(u0 + k, u1 - 1);
        mt[k] = u >= 6 ? 3 : u >= 3 ? 2 : u >= 1 ? 1 : 0;
        nt[k] = u - mt[k] * (mt[k] + 1) / 2;
      }
      float acc[kPairs][2][4] = {};
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks)
#pragma unroll
        for (int k = 0; k < kPairs; ++k) {
          uint32_t af[4], bf[4];
          ldsm_x4(af, cc + (16 * mt[k] + (lane & 7) + (((lane >> 3) & 1) << 3))
                               * kRowBC + 16 * ks + ((lane >> 4) << 3));
          ldsm_x4(bf, bb + (16 * nt[k] + (lane & 7) + ((lane >> 4) << 3))
                               * kRowBC + 16 * ks + (((lane >> 3) & 1) << 3));
          mma_16816(acc[k][0], af, bf[0], bf[1]);
          mma_16816(acc[k][1], af, bf[2], bf[3]);
        }
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
#pragma unroll
        for (int sub = 0; sub < 2; ++sub) {
          const int j = 16 * nt[k] + 8 * sub + 2 * tq;
          const float cj0 = cum[j], cj1 = cum[j + 1];
          const float dj0 = dtv[j], dj1 = dtv[j + 1];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = 16 * mt[k] + gr + 8 * half;
            const float ci = cum[i];
            const float e0 = __expf(ci - cj0), e1 = __expf(ci - cj1);
            const float m0 = i >= j ? acc[k][sub][2 * half] * e0 * dj0 : 0.f;
            const float m1 =
                i >= j + 1 ? acc[k][sub][2 * half + 1] * e1 * dj1 : 0.f;
            *reinterpret_cast<uint32_t*>(ms + i * kRowM + j) = pack(m0, m1);
          }
        }
      }
    }

    // 2. y^T (16 rows p, 64 columns i) = state C^T, times exp(cum_i).
    float yacc[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int k = 0; k < 4; ++k) yacc[t][k] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const uint32_t af[4] = {
          pack(st[2 * ks][0], st[2 * ks][1]),
          pack(st[2 * ks][2], st[2 * ks][3]),
          pack(st[2 * ks + 1][0], st[2 * ks + 1][1]),
          pack(st[2 * ks + 1][2], st[2 * ks + 1][3])};
#pragma unroll
      for (int t2 = 0; t2 < 4; ++t2) {
        uint32_t bf[4];
        ldsm_x4(bf, cc + (16 * t2 + (lane & 7) + ((lane >> 4) << 3)) * kRowBC
                        + 16 * ks + (((lane >> 3) & 1) << 3));
        mma_16816(yacc[2 * t2], af, bf[0], bf[1]);
        mma_16816(yacc[2 * t2 + 1], af, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int i = 8 * t + 2 * tq;
      const float e0 = ecum[i], e1 = ecum[i + 1];
      yacc[t][0] *= e0;
      yacc[t][1] *= e1;
      yacc[t][2] *= e0;
      yacc[t][3] *= e1;
    }

    // x^T fragments of the warp's rows, one per 16 positions j (x is [j][p]
    // in shared memory: transposed loads); used by steps 3 and 4.
    uint32_t xa[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldsm_x4_trans(xa[ks], xx + (16 * ks + (lane & 7) + ((lane >> 4) << 3))
                                   * kRowX + xcol + (((lane >> 3) & 1) << 3));

    __syncthreads();   // M is complete

    // 3. y^T += x^T M^T, tiles on or below the diagonal only.
#pragma unroll
    for (int t2 = 0; t2 < 4; ++t2)
#pragma unroll
      for (int ks = 0; ks <= t2; ++ks) {
        uint32_t bf[4];
        ldsm_x4(bf, ms + (16 * t2 + (lane & 7) + ((lane >> 4) << 3)) * kRowM
                        + 16 * ks + (((lane >> 3) & 1) << 3));
        mma_16816(yacc[2 * t2], xa[ks], bf[0], bf[1]);
        mma_16816(yacc[2 * t2 + 1], xa[ks], bf[2], bf[3]);
      }

    // y through shared memory, over the warp's own columns of x (no other
    // warp reads them; this warp's x is in xa), then 16 bytes a lane.
    __syncwarp();
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int i = 8 * t + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = xcol + gr + 8 * half;
        xx[i * kRowX + col] = __float2bfloat16(yacc[t][2 * half]);
        xx[(i + 1) * kRowX + col] = __float2bfloat16(yacc[t][2 * half + 1]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int e = lane; e < 2 * kQ; e += 32) {
      const int i = e >> 1, q = e & 1;
      if (i < nq && pw + 8 * q < P)
        *reinterpret_cast<uint4*>(yb + (s0 + i) * p.yss + pw + 8 * q) =
            *reinterpret_cast<const uint4*>(xx + i * kRowX + xcol + 8 * q);
    }

    // 4. state = state * exp(cum[-1]) + (x w)^T B, x w as hi + lo.
    const float decay = expf(cum[kQ - 1]);
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int k = 0; k < 4; ++k) st[t][k] *= decay;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int j = 16 * ks + 2 * tq;
      const float w0 = wv[j], w1 = wv[j + 1], w8 = wv[j + 8], w9 = wv[j + 9];
      uint32_t ah[4], al[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v = unpack2(xa[ks][r]);
        const bool upper = r >= 2;       // positions j + 8, j + 9
        split(v.x * (upper ? w8 : w0), v.y * (upper ? w9 : w1), ah[r], al[r]);
      }
#pragma unroll
      for (int n2 = 0; n2 < kNT / 2; ++n2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, bb + (16 * ks + (lane & 7)
                                + (((lane >> 3) & 1) << 3)) * kRowBC
                              + 16 * n2 + ((lane >> 4) << 3));
        mma_16816(st[2 * n2], ah, bf[0], bf[1]);
        mma_16816(st[2 * n2], al, bf[0], bf[1]);
        mma_16816(st[2 * n2 + 1], ah, bf[2], bf[3]);
        mma_16816(st[2 * n2 + 1], al, bf[2], bf[3]);
      }
    }

    if (warp == 0 && c + 1 < nc) scan(dn0, dn1, stage ^ 1);
  }

  if (final_state) {
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = pw + gr + 8 * half, n = 8 * t + 2 * tq;
        if (row < P) {
          float* dst = final_state + b * p.fsb + h * p.fsh + row * p.fsp + n;
          dst[0] = st[t][2 * half];
          dst[1] = st[t][2 * half + 1];
        }
      }
  }
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(err);
}

template <int N, int W>
int launch_bf16(const void* x, const void* dt, const float* A, const void* Bm,
                const void* Cm, const float* state0, void* y,
                float* final_state, float* chunk_states, int batch,
                const Params& p, cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes(N, W);
  const int err = set_smem(ssd_bf16_kernel<N, W>, smem);
  if (err) return err;
  const dim3 grid(batch * p.H, (p.P + kSlice * W - 1) / (kSlice * W));
  ssd_bf16_kernel<N, W><<<grid, 32 * W, smem, stream>>>(
      static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), state0, static_cast<bf16*>(y),
      final_state, chunk_states, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points. Pointers are device pointers; state0 may be null (a zero
// state) and may equal final_state; chunk_states, the fp32 (B, H, nc, P, N)
// states entering each of the nc chunks (contiguous), may be null (none
// written). Strides are in elements; x, y, B, C and
// both states have innermost stride 1. Return cudaGetLastError() after the
// launch (or the error of setting the kernel's shared memory).
//
// ssd_bf16: x, B, C, y bf16; dt bf16 (dt_bf16 = 1) or fp32. The caller
// guarantees N in {16, 32, 64, 128}, P % 8 == 0, warps in {1, 2, 4}, S >= 1,
// and 16-byte alignment of x, B and C at every (batch, position, head)
// and of y's rows.
extern "C" int ssd_bf16(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* state0,
                        void* y, void* final_state, void* chunk_states,
                        int batch, int S, int H,
                        int P, int N, int dt_bf16, int warps, long long xsb,
                        long long xss, long long xsh, long long dsb,
                        long long dss, long long dsh, long long bsb,
                        long long bss, long long csb, long long css,
                        long long ysb, long long yss, long long ysh,
                        long long isb, long long ish, long long isp,
                        long long fsb, long long fsh, long long fsp,
                        void* stream) {
  const Params p{S,   H,   P,   N,   xsb, xss, xsh, dsb, dss, dsh, bsb, bss,
                 csb, css, ysb, yss, ysh, isb, ish, isp, fsb, fsh, fsp,
                 dt_bf16};
  const auto* a = static_cast<const float*>(A);
  const auto* s0 = static_cast<const float*>(state0);
  auto* fs = static_cast<float*>(final_state);
  auto* cst = static_cast<float*>(chunk_states);
  auto s = static_cast<cudaStream_t>(stream);
  // one instance per (N, warps): the state's registers and the loops'
  // trip counts are fixed at compile time
#define SSD_BF16_CASE(NN, WW)                                             \
  if (N == NN && warps == WW)                                             \
    return launch_bf16<NN, WW>(x, dt, a, Bm, Cm, s0, y, fs, cst, batch, p, \
                               s);
#define SSD_BF16_CASES(NN) \
  SSD_BF16_CASE(NN, 1) SSD_BF16_CASE(NN, 2) SSD_BF16_CASE(NN, 4)
  SSD_BF16_CASES(16)
  SSD_BF16_CASES(32)
  SSD_BF16_CASES(64)
  SSD_BF16_CASES(128)
#undef SSD_BF16_CASES
#undef SSD_BF16_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// ssd_f32: all fp32. The caller guarantees P % 4 == 0, N % 4 == 0, S >= 1
// and shared memory (ssd_f32_smem_bytes) within the card's 227 KB a block.
extern "C" int ssd_f32(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* state0,
                       void* y, void* final_state, void* chunk_states,
                       int batch, int S, int H,
                       int P, int N, long long xsb, long long xss,
                       long long xsh, long long dsb, long long dss,
                       long long dsh, long long bsb, long long bss,
                       long long csb, long long css, long long ysb,
                       long long yss, long long ysh, long long isb,
                       long long ish, long long isp, long long fsb,
                       long long fsh, long long fsp, void* stream) {
  const Params p{S,   H,   P,   N,   xsb, xss, xsh, dsb, dss, dsh, bsb, bss,
                 csb, css, ysb, yss, ysh, isb, ish, isp, fsb, fsh, fsp, 0};
  const size_t smem = static_cast<size_t>(f32_smem_floats(P, N)) * 4;
  if (smem > 48 * 1024) {
    const int err = set_smem(ssd_f32_kernel, smem);
    if (err) return err;
  }
  ssd_f32_kernel<<<batch * H, kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(state0),
      static_cast<float*>(y), static_cast<float*>(final_state),
      static_cast<float*>(chunk_states), p);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of one block, in bytes (the launcher's plan mirrors these).
extern "C" int ssd_bf16_smem_bytes(int N, int warps) {
  return bf16_smem_bytes(N, warps);
}
extern "C" int ssd_f32_smem_bytes(int P, int N) {
  return f32_smem_floats(P, N) * 4;
}
