// Flash attention (prefill) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py :: flash_attention_kernel
//   (launched by flash_attention_pallas, adapter ops.py :: flash_attention).
// Same function: blocked online-softmax attention scaled by 1/sqrt(D), with
// an optional causal mask qpos >= kpos (both counted from 0). m, l and the
// accumulator are fp32; p is rounded to V's dtype before P.V; the output
// takes q's dtype. KV tiles wholly above the causal diagonal are skipped.
//
// Layout. q, o: (B, Sq, H, D); k, v: (B, Skv, Hk, D), read through their
// batch / sequence / head strides (innermost stride 1), so the model's
// tensors go in without a transposed copy. Heads fold as h = hk * G + g.
//
// Design. One block per (16 query positions, b, hk); warp g of the block
// owns the 16 rows of query head hk*G + g, so the block's rows are the
// G x 16 query rows of one KV head and every K/V tile it stages in shared
// memory serves all G heads (no KV repeat, as in the Pallas kernel's
// (G*bq, D) fold).
//   bf16: Q.K^T and P.V on the tensor cores with mma.sync m16n8k16
//         (fp32 accumulate); Q stays in registers as A fragments, P goes
//         from the score accumulators straight into A fragments.
//   fp32: scalar fp32 FMA, one thread per query row (no TF32: the fp32
//         tolerance is 2e-5).
// Bound on this card: at the prefill shape (B=8, S=512, H=32, D=64, causal)
// it is the bf16 tensor-core rate (about 2*B*H*S^2*D operations over
// 989 TFLOP/s); the bytes (q, k, v, o once) are a few MB. mma.sync reaches
// a fraction of what wgmma would; wgmma with TMA-fed tiles is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // finite, as in the reference
constexpr int kQT = 16;            // query positions per block
constexpr int kBK = 64;            // keys per shared-memory tile (bf16)
constexpr int kBKF = 32;           // keys per shared-memory tile (fp32)
constexpr int kPad = 8;            // bf16 row padding: conflict-free reads

struct Strides {
  long long b, s, h;  // element strides of batch, sequence, head
};

struct Params {
  int Sq, Skv, Hk, G;
  Strides qs, ks, vs, os;
  int causal;
  float scale;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, fp32 out.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Number of KV tiles this block visits: up to the causal diagonal of its
// last valid query row.
__device__ __forceinline__ int kv_tiles(int q0, int Sq, int Skv, int bk,
                                        int causal) {
  int n = (Skv + bk - 1) / bk;
  if (causal) {
    int last_q = min(q0 + kQT - 1, Sq - 1);
    n = min(n, last_q / bk + 1);
  }
  return n;
}

// ---------------------------------------------------------------- bf16 ---
// Fragment layouts (PTX ISA, mma.m16n8k16): gr = lane / 4, tq = lane % 4.
//   A reg0 (row gr, k 2tq..+1)   reg1 (row gr+8, k 2tq..+1)
//     reg2 (row gr, k 2tq+8..+9) reg3 (row gr+8, k 2tq+8..+9)
//   B reg0 (k 2tq..+1, col gr)   reg1 (k 2tq+8..+9, col gr)
//   C c0,c1 (row gr, col 2tq, 2tq+1)  c2,c3 (row gr+8, same cols)
template <int D>
__global__ void __launch_bounds__(512)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  const Params p) {
  const int Sq = p.Sq, Skv = p.Skv, Hk = p.Hk, G = p.G, causal = p.causal;
  const Strides qs = p.qs, ks = p.ks, vs = p.vs, os = p.os;
  const float scale = p.scale;
  __shared__ __align__(16) bf16 Ks[kBK][D + kPad];
  __shared__ __align__(16) bf16 Vs[kBK][D + kPad];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2, tq = lane & 3;
  const int b = blockIdx.y / Hk, hk = blockIdx.y % Hk;
  const int h = hk * G + warp;
  const int q0 = blockIdx.x * kQT;

  // This warp's 16 query rows as A fragments, one per 16-wide slice of D.
  uint32_t qa[D / 16][4];
  const bf16* qb = q + b * qs.b + h * qs.h;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + gr + 8 * half;
      uint32_t lo = 0, hi = 0;
      if (row < Sq) {
        const bf16* qp = qb + row * qs.s + kc * 16 + 2 * tq;
        lo = *reinterpret_cast<const uint32_t*>(qp);
        hi = *reinterpret_cast<const uint32_t*>(qp + 8);
      }
      qa[kc][half] = lo;
      qa[kc][2 + half] = hi;
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  const int n_tiles = kv_tiles(q0, Sq, Skv, kBK, causal);

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBK;
    __syncthreads();  // every warp is done with the previous tile
    for (int c = threadIdx.x; c < kBK * D / 8; c += blockDim.x) {
      const int r = c / (D / 8), col = (c % (D / 8)) * 8;
      const int key = kv0 + r;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (key < Skv) {
        kx = *reinterpret_cast<const uint4*>(kb + key * ks.s + col);
        vx = *reinterpret_cast<const uint4*>(vb + key * vs.s + col);
      }
      *reinterpret_cast<uint4*>(&Ks[r][col]) = kx;
      *reinterpret_cast<uint4*>(&Vs[r][col]) = vx;
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys.
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const bf16* kr = &Ks[nt * 8 + gr][kc * 16 + 2 * tq];
        mma_16816(s[nt], qa[kc], *reinterpret_cast<const uint32_t*>(kr),
                  *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // Scale, mask, and the running max of each of this thread's two rows.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = gr + (e >= 2 ? 8 : 0);
        const int key = kv0 + nt * 8 + 2 * tq + (e & 1);
        float x = s[nt][e] * scale;
        if (key >= Skv || (causal && key > q0 + row)) x = kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);
        rs[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    // O += P V: P (rounded to bf16) from the score accumulators.
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const int r0 = kc * 16 + 2 * tq;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int col = dt * 8 + gr;
        mma_16816(acc[dt], pa, pack_bf16(Vs[r0][col], Vs[r0 + 1][col]),
                  pack_bf16(Vs[r0 + 8][col], Vs[r0 + 9][col]));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + gr + 8 * half;
    if (row >= Sq) continue;
    bf16* op = o + b * os.b + row * os.s + h * os.h;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(op + dt * 8 + 2 * tq) =
          pack_bf16(acc[dt][2 * half] / l[half], acc[dt][2 * half + 1] / l[half]);
    }
  }
}

// ---------------------------------------------------------------- fp32 ---
// One thread per query row: thread i of the block is head g = i / 16 of the
// group at query position q0 + i % 16.
template <int D>
__global__ void __launch_bounds__(256)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 const Params p) {
  const int Sq = p.Sq, Skv = p.Skv, Hk = p.Hk, G = p.G, causal = p.causal;
  const Strides qs = p.qs, ks = p.ks, vs = p.vs, os = p.os;
  const float scale = p.scale;
  __shared__ float Ks[kBKF][D];
  __shared__ float Vs[kBKF][D];

  const int g = threadIdx.x / kQT, qi = threadIdx.x % kQT;
  const int b = blockIdx.y / Hk, hk = blockIdx.y % Hk;
  const int h = hk * G + g;
  const int q0 = blockIdx.x * kQT;
  const int qpos = q0 + qi;

  float qr[D], acc[D];
  const float* qp = q + b * qs.b + qpos * qs.s + h * qs.h;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = qpos < Sq ? qp[d] : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  const int n_tiles = kv_tiles(q0, Sq, Skv, kBKF, causal);

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBKF;
    __syncthreads();
    for (int c = threadIdx.x; c < kBKF * D; c += blockDim.x) {
      const int r = c / D, d = c % D;
      const int key = kv0 + r;
      Ks[r][d] = key < Skv ? kb[key * ks.s + d] : 0.f;
      Vs[r][d] = key < Skv ? vb[key * vs.s + d] : 0.f;
    }
    __syncthreads();

    float s[kBKF];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kBKF; ++j) {
      float x = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) x = fmaf(qr[d], Ks[j][d], x);
      x *= scale;
      const int key = kv0 + j;
      if (key >= Skv || (causal && key > qpos)) x = kNegInf;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    const float corr = expf(m - mx);
    m = mx;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kBKF; ++j) {
      s[j] = expf(s[j] - m);
      rs += s[j];
    }
    l = l * corr + rs;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float a = acc[d] * corr;
#pragma unroll
      for (int j = 0; j < kBKF; ++j) a = fmaf(s[j], Vs[j][d], a);
      acc[d] = a;
    }
  }

  if (qpos < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    float* op = o + b * os.b + qpos * os.s + h * os.h;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = acc[d] / denom;
  }
}

// One launch per dtype and head size; blocks of G warps (bf16) or G x 16
// threads (fp32), one per (16 query positions, b, hk).
template <int D>
void run(const bf16* q, const bf16* k, const bf16* v, bf16* o, dim3 grid,
         const Params& p, cudaStream_t stream) {
  flash_bf16_kernel<D><<<grid, p.G * 32, 0, stream>>>(q, k, v, o, p);
}

template <int D>
void run(const float* q, const float* k, const float* v, float* o, dim3 grid,
         const Params& p, cudaStream_t stream) {
  flash_f32_kernel<D><<<grid, p.G * kQT, 0, stream>>>(q, k, v, o, p);
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, int B, int D,
           const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Sq + kQT - 1) / kQT, B * p.Hk);
  switch (D) {
    case 16: run<16>(q, k, v, o, grid, p, stream); break;
    case 32: run<32>(q, k, v, o, grid, p, stream); break;
    case 64: run<64>(q, k, v, o, grid, p, stream); break;
    case 128: run<128>(q, k, v, o, grid, p, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points. Pointers are device pointers; strides are in elements for
// the batch, sequence and head dims of q, k, v, o (innermost stride 1); the
// caller guarantees H % Hk == 0, H / Hk <= 16 and 16-byte aligned rows.
// Returns cudaGetLastError() after the launch (0 when it was accepted).
#define FLASH_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o,   \
                      int B, int Sq, int Skv, int H, int Hk, int D,           \
                      long long qsb, long long qss, long long qsh,            \
                      long long ksb, long long kss, long long ksh,            \
                      long long vsb, long long vss, long long vsh,            \
                      long long osb, long long oss, long long osh, int causal, \
                      void* stream) {                                          \
    const Params p{Sq, Skv, Hk, H / Hk,                                        \
                   Strides{qsb, qss, qsh}, Strides{ksb, kss, ksh},             \
                   Strides{vsb, vss, vsh}, Strides{osb, oss, osh},             \
                   causal, 1.0f / sqrtf(static_cast<float>(D))};               \
    return launch<T>(static_cast<const T*>(q), static_cast<const T*>(k),       \
                     static_cast<const T*>(v), static_cast<T*>(o), B, D, p,    \
                     static_cast<cudaStream_t>(stream));                       \
  }

FLASH_ENTRY(flash_attention_bf16, bf16)
FLASH_ENTRY(flash_attention_f32, float)
