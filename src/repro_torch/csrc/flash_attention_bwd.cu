// Flash attention backward for Hopper, sm_90a: dq, dk and dv of the causal
// (or full) GQA attention that flash_attention.cu computes.
//
// It has no TPU kernel to replace: the JAX package takes this gradient by
// autodiff of its attention under XLA (src/repro/models/attention.py,
// blockwise_attention); its Pallas forward
//   src/repro/kernels/flash_attention/kernel.py :: flash_attention_pallas
// has no backward. This is the gradient of that forward, as the port's
// forward (flash_attention.cu) computes it: s = q.k / sqrt(D), masked to
// qpos >= kpos (both from 0) when causal, p = softmax(s), o = p.v.
//
//   dv_j = sum_i p_ij do_i            dp_ij = do_i . v_j
//   ds_ij = p_ij (dp_ij - delta_i)    delta_i = do_i . o_i
//   dq_i = sum_j ds_ij k_j / sqrt(D)  dk_j = sum_i ds_ij q_i / sqrt(D)
//
// GQA is native: the G query heads of a KV head fold into rows R = pos * G
// + g (as the forward folds them), and dk, dv of a KV head sum over the
// rows of all G heads inside one block. K and V are never repeated.
//
// Layout. q, o, do, dq: (B, Sq, H, D); k, v, dk, dv: (B, Skv, Hk, D), read
// and written through their batch / sequence / head strides (innermost
// stride 1, rows 16-byte aligned).
//
// What bounds it on this card: at the training shape (B=8, S=512, H=32,
// Hk=4, D=64, bf16, causal) it must move 75.5 MB (q, o, do, dq at 16.8 MB,
// k, v, dk, dv at 2.1 MB), 22.5 us at 3.35 TB/s, and do 21.5 GFLOP of
// causal products (five products of the forward's two), 21.7 us at
// 989 TFLOP/s. This first design does not reach either: it is the simple
// one, right first (speed is later work).
//
// Design: two launches and no atomics, so a run reproduces bit for bit.
//  1. dq pass, one block of 64 folded query rows of one (b, hk) (4 warps,
//     16 rows each). The forward stores no log-sum-exp, so the block walks
//     its keys twice: first for the row max and sum (lse), then for
//     P = exp(s - lse), dP = dO.V^T, dS = P (dP - delta) and dq += dS.K.
//     delta = rowsum(dO o) comes from the forward's output. lse and delta
//     go to fp32 scratch (the wrapper allocates it) for pass 2.
//  2. dk/dv pass, one block of 64 keys of one (b, hk), each warp 16 keys.
//     It walks the folded query rows that the causal mask lets reach its
//     keys, in tiles: S^T = K.Q^T, P^T, dP^T = V.dO^T, dS^T, then
//     dv += P^T.dO and dk += dS^T.Q, all G heads summed in the registers.
// Under the causal mask a block's work grows with its last row (pass 1) or
// shrinks with its first key (pass 2); both grids launch the longest blocks
// first, so the short ones fill the last wave.
// Products run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate); a score tile's accumulators are, rounded to bf16, the A
// operand of the next product (P^T and dS^T stay in registers). Operands
// come from shared memory tiles padded by 8 elements a row (conflict-free
// fragment loads); an operand read along its rows (K in dq += dS.K, dO and
// Q in pass 2) is gathered two 16-bit loads a register. The exponentials
// are in base 2 with log2(e) folded into the scale. Inner tiles are 64 keys
// (pass 1) or 64 query rows (pass 2) for D <= 64, 32 for D = 128 (register
// room for the fp32 accumulators).
//
// fp32 (not on a training path): scalar fp32 FMA (no TF32), the same two
// passes, one thread per query row (pass 1) or per key (pass 2), K/V or
// Q/dO tiles staged in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // finite, as in the forward
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;          // rows (pass 1) or keys (pass 2) a block
constexpr int kThreads = 128;      // four warps, 16 rows each

struct Strides {
  long long b, s, h;  // element strides of batch, sequence, head
};

struct Params {
  int Sq, Skv, Hk, G, causal;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float scale;                     // 1 / sqrt(D)
  float* lse;                      // (B * Hk, Sq * G) fp32 scratch
  float* delta;                    // (B * Hk, Sq * G) fp32 scratch
};

// Number of key tiles of `bn` keys that rows [R0, R0 + rows) reach.
__device__ __forceinline__ int key_tiles(int R0, int rows, int bn,
                                         const Params& p) {
  int n = (p.Skv + bn - 1) / bn;
  if (p.causal) {
    const int last = min((R0 + rows - 1) / p.G, p.Sq - 1);
    n = min(n, last / bn + 1);
  }
  return n;
}

// First tile of `bm` folded query rows that keys from kv0 on are reached by.
__device__ __forceinline__ int first_row_tile(int kv0, int bm,
                                              const Params& p) {
  return p.causal ? (int)(((long long)kv0 * p.G) / bm) : 0;
}

// ---------------------------------------------------------------- bf16 ---
template <int D>
struct Cfg {
  static constexpr int LD = D + 8;            // padded row, elements
  static constexpr int kN = D <= 64 ? 64 : 32;  // inner tile
  static constexpr int kSmem1 = (2 * kRows + 2 * kN) * LD * 2 + kRows * 4;
  static constexpr int kSmem2 = (2 * kRows + 2 * kN) * LD * 2 + kN * 12;
};

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Elements (r, c) and (r, c + 1) of a shared tile with row stride LD.
template <int LD>
__device__ __forceinline__ uint32_t ld_row2(const bf16* t, int r, int c) {
  return *reinterpret_cast<const uint32_t*>(t + r * LD + c);
}

// Elements (r, c) and (r + 1, c).
template <int LD>
__device__ __forceinline__ uint32_t ld_col2(const bf16* t, int r, int c) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(t + r * LD + c);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(t + (r + 1) * LD + c);
  return lo | (hi << 16);
}

// acc (16 x N) = A[r0:r0+16, :D] . Bt[:N, :D]^T, both tiles row-major in
// shared memory (A fragment rows along D, B fragment columns along D).
template <int D, int N, int LD>
__device__ __forceinline__ void product_nt(float (&acc)[N / 8][4],
                                           const bf16* A, const bf16* Bt,
                                           int r0, int gq, int tq) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * tq;
    const uint32_t a[4] = {ld_row2<LD>(A, r0 + gq, c),
                           ld_row2<LD>(A, r0 + gq + 8, c),
                           ld_row2<LD>(A, r0 + gq, c + 8),
                           ld_row2<LD>(A, r0 + gq + 8, c + 8)};
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      mma16816(acc[j], a, ld_row2<LD>(Bt, j * 8 + gq, c),
               ld_row2<LD>(Bt, j * 8 + gq, c + 8));
  }
}

// acc (16 x D) += X (16 x N, the accumulators of a score tile, rounded to
// bf16) . Bm[:N, :D] (row-major in shared memory).
template <int D, int N, int LD>
__device__ __forceinline__ void product_acc(float (&acc)[D / 8][4],
                                            const float (&x)[N / 8][4],
                                            const bf16* Bm, int gq, int tq) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
    const int r = kk * 16 + 2 * tq;
#pragma unroll
    for (int dj = 0; dj < D / 8; ++dj)
      mma16816(acc[dj], a, ld_col2<LD>(Bm, r, dj * 8 + gq),
               ld_col2<LD>(Bm, r + 8, dj * 8 + gq));
  }
}

// Row `r` of the folded rows of (b, hk): its address in a (B, S, H, D)
// tensor, or nullptr past the last row.
__device__ __forceinline__ long long row_offset(int R, int b, int hk,
                                                const Strides& s,
                                                const Params& p) {
  const int pos = R / p.G, h = hk * p.G + R % p.G;
  return b * s.b + pos * s.s + h * s.h;
}

// Stage `rows` rows of a (B, S, heads, D) tensor into a shared tile: folded
// query rows from R0 (fold = true) or keys from R0 (fold = false); rows
// past `n` are zeros.
template <int D, int LD>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int rows,
                                      int R0, int n, bool fold, int b,
                                      int hk, const Strides& s,
                                      const Params& p) {
  constexpr int kChunks = D / 8;   // 16-byte chunks a row
  for (int c = threadIdx.x; c < rows * kChunks; c += blockDim.x) {
    const int r = c / kChunks, d = (c % kChunks) * 8;
    const int R = R0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (R < n) {
      const long long off = fold ? row_offset(R, b, hk, s, p)
                                 : b * s.b + R * s.s + hk * s.h;
      val = *reinterpret_cast<const uint4*>(src + off + d);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + d) = val;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Pass 1: dq, and lse / delta into scratch. Grid (B * Hk, row tiles): the
// blocks launch row tile by row tile, the longest rows (causal) first.
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ o,
            const bf16* __restrict__ dout, bf16* __restrict__ dq,
            const Params p) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, N = C::kN;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kRows * LD;
  bf16* Ks = dOs + kRows * LD;
  bf16* Vs = Ks + N * LD;
  float* delta_s = reinterpret_cast<float*>(Vs + N * LD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int NR = p.Sq * p.G;
  const int b = blockIdx.x / p.Hk, hk = blockIdx.x % p.Hk;
  // causal: the longest rows (last positions) first
  const int tile = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int R0 = tile * kRows;
  const long long scratch = (long long)blockIdx.x * NR;
  const float scale_log2 = p.scale * kLog2e;

  stage<D, LD>(Qs, q, kRows, R0, NR, true, b, hk, p.qs, p);
  stage<D, LD>(dOs, dout, kRows, R0, NR, true, b, hk, p.dos, p);
  __syncthreads();
  {  // delta = rowsum(dO o), two threads a row
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, R = R0 + r;
    float s = 0.f;
    if (R < NR) {
      const bf16* op = o + row_offset(R, b, hk, p.os, p);
      for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d)
        s = fmaf(__bfloat162float(dOs[r * LD + d]), __bfloat162float(op[d]),
                 s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (half == 0) {
      delta_s[r] = s;
      if (R < NR) p.delta[scratch + R] = s;
    }
  }
  __syncthreads();

  const int r0 = warp * 16;
  const int RA = R0 + r0 + gq, RB = RA + 8;    // this thread's two rows
  const int posA = RA / p.G, posB = RB / p.G;
  const float deltaA = delta_s[r0 + gq], deltaB = delta_s[r0 + gq + 8];
  const int n_tiles = key_tiles(R0, kRows, N, p);

  // walk 1: row max and sum of the scaled scores (base 2)
  float mA = kNegInf, mB = kNegInf, lA = 0.f, lB = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * N;
    __syncthreads();
    stage<D, LD>(Ks, k, N, kv0, p.Skv, false, b, hk, p.ks, p);
    __syncthreads();
    float s[N / 8][4];
    product_nt<D, N, LD>(s, Qs, Ks, r0, gq, tq);
    float mxA = mA, mxB = mB;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + j * 8 + 2 * tq + (e & 1);
        const int pos = e < 2 ? posA : posB;
        float x = s[j][e] * scale_log2;
        if (key >= p.Skv || (p.causal && key > pos)) x = kNegInf;
        s[j][e] = x;
        if (e < 2) mxA = fmaxf(mxA, x); else mxB = fmaxf(mxB, x);
      }
    mxA = quad_max(mxA);
    mxB = quad_max(mxB);
    lA *= exp2f(mA - mxA);
    lB *= exp2f(mB - mxB);
    mA = mxA;
    mB = mxB;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      lA += exp2f(s[j][0] - mA) + exp2f(s[j][1] - mA);
      lB += exp2f(s[j][2] - mB) + exp2f(s[j][3] - mB);
    }
  }
  lA = quad_sum(lA);
  lB = quad_sum(lB);
  const float lseA = mA + log2f(fmaxf(lA, 1e-30f));
  const float lseB = mB + log2f(fmaxf(lB, 1e-30f));
  if (tq == 0) {   // stored in natural-log units
    if (RA < NR) p.lse[scratch + RA] = lseA / kLog2e;
    if (RB < NR) p.lse[scratch + RB] = lseB / kLog2e;
  }

  // walk 2: dq += dS . K
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * N;
    __syncthreads();
    stage<D, LD>(Ks, k, N, kv0, p.Skv, false, b, hk, p.ks, p);
    stage<D, LD>(Vs, v, N, kv0, p.Skv, false, b, hk, p.vs, p);
    __syncthreads();
    float s[N / 8][4], dp[N / 8][4];
    product_nt<D, N, LD>(s, Qs, Ks, r0, gq, tq);
    product_nt<D, N, LD>(dp, dOs, Vs, r0, gq, tq);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + j * 8 + 2 * tq + (e & 1);
        const bool a = e < 2;
        const bool masked = key >= p.Skv || (p.causal && key > (a ? posA : posB));
        const float pr = masked ? 0.f
                                : exp2f(s[j][e] * scale_log2 - (a ? lseA : lseB));
        s[j][e] = pr * (dp[j][e] - (a ? deltaA : deltaB));
      }
    product_acc<D, N, LD>(acc, s, Ks, gq, tq);
  }

#pragma unroll
  for (int dj = 0; dj < D / 8; ++dj) {
    const int col = dj * 8 + 2 * tq;
    if (RA < NR)
      *reinterpret_cast<__nv_bfloat162*>(dq + row_offset(RA, b, hk, p.dqs, p)
                                         + col) =
          __floats2bfloat162_rn(acc[dj][0] * p.scale, acc[dj][1] * p.scale);
    if (RB < NR)
      *reinterpret_cast<__nv_bfloat162*>(dq + row_offset(RB, b, hk, p.dqs, p)
                                         + col) =
          __floats2bfloat162_rn(acc[dj][2] * p.scale, acc[dj][3] * p.scale);
  }
}

// Pass 2: dk and dv. Grid (B * Hk, key tiles): the blocks launch key tile
// by key tile, the first keys (the most query rows, causal) first.
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              bf16* __restrict__ dk, bf16* __restrict__ dv, const Params p) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, N = C::kN;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kRows * LD;
  bf16* Qs = Vs + kRows * LD;
  bf16* dOs = Qs + N * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + N * LD);
  float* delta_s = lse_s + N;
  int* pos_s = reinterpret_cast<int*>(delta_s + N);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int NR = p.Sq * p.G;
  const int b = blockIdx.x / p.Hk, hk = blockIdx.x % p.Hk;
  const int kv0 = blockIdx.y * kRows;
  const long long scratch = (long long)blockIdx.x * NR;
  const float scale_log2 = p.scale * kLog2e;

  stage<D, LD>(Ks, k, kRows, kv0, p.Skv, false, b, hk, p.ks, p);
  stage<D, LD>(Vs, v, kRows, kv0, p.Skv, false, b, hk, p.vs, p);

  const int r0 = warp * 16;
  const int keyA = kv0 + r0 + gq, keyB = keyA + 8;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  const int n_tiles = (NR + N - 1) / N;
  for (int t = first_row_tile(kv0, N, p); t < n_tiles; ++t) {
    const int R0 = t * N;
    __syncthreads();
    stage<D, LD>(Qs, q, N, R0, NR, true, b, hk, p.qs, p);
    stage<D, LD>(dOs, dout, N, R0, NR, true, b, hk, p.dos, p);
    if (threadIdx.x < N) {
      const int R = R0 + threadIdx.x;
      const bool ok = R < NR;
      lse_s[threadIdx.x] = ok ? p.lse[scratch + R] * kLog2e : 0.f;
      delta_s[threadIdx.x] = ok ? p.delta[scratch + R] : 0.f;
      pos_s[threadIdx.x] = ok ? R / p.G : -1;
    }
    __syncthreads();
    float s[N / 8][4], dp[N / 8][4];
    product_nt<D, N, LD>(s, Ks, Qs, r0, gq, tq);     // S^T
    product_nt<D, N, LD>(dp, Vs, dOs, r0, gq, tq);   // dP^T
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * tq + (e & 1);
        const int key = e < 2 ? keyA : keyB;
        const int pos = pos_s[col];
        const bool masked = pos < 0 || key >= p.Skv
                            || (p.causal && key > pos);
        const float pr = masked ? 0.f
                                : exp2f(s[j][e] * scale_log2 - lse_s[col]);
        s[j][e] = pr;
        dp[j][e] = pr * (dp[j][e] - delta_s[col]);
      }
    product_acc<D, N, LD>(dv_acc, s, dOs, gq, tq);
    product_acc<D, N, LD>(dk_acc, dp, Qs, gq, tq);
  }

#pragma unroll
  for (int dj = 0; dj < D / 8; ++dj) {
    const int col = dj * 8 + 2 * tq;
    if (keyA < p.Skv) {
      *reinterpret_cast<__nv_bfloat162*>(
          dk + b * p.dks.b + keyA * p.dks.s + hk * p.dks.h + col) =
          __floats2bfloat162_rn(dk_acc[dj][0] * p.scale,
                                dk_acc[dj][1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(
          dv + b * p.dvs.b + keyA * p.dvs.s + hk * p.dvs.h + col) =
          __floats2bfloat162_rn(dv_acc[dj][0], dv_acc[dj][1]);
    }
    if (keyB < p.Skv) {
      *reinterpret_cast<__nv_bfloat162*>(
          dk + b * p.dks.b + keyB * p.dks.s + hk * p.dks.h + col) =
          __floats2bfloat162_rn(dk_acc[dj][2] * p.scale,
                                dk_acc[dj][3] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(
          dv + b * p.dvs.b + keyB * p.dvs.s + hk * p.dvs.h + col) =
          __floats2bfloat162_rn(dv_acc[dj][2], dv_acc[dj][3]);
    }
  }
}

// ---------------------------------------------------------------- fp32 ---
constexpr int kF32Threads = 64;    // one row (pass 1) or key (pass 2) each
constexpr int kF32Keys = 32;       // keys a shared tile (pass 1)
constexpr int kF32Rows = 16;       // query rows a shared tile (pass 2)

template <int D>
__global__ void __launch_bounds__(kF32Threads)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ o,
           const float* __restrict__ dout, float* __restrict__ dq,
           const Params p) {
  __shared__ float Ks[kF32Keys][D];
  __shared__ float Vs[kF32Keys][D];
  const int NR = p.Sq * p.G;
  const int b = blockIdx.x / p.Hk, hk = blockIdx.x % p.Hk;
  const int tile = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int R0 = tile * kF32Threads;
  const int R = R0 + threadIdx.x;
  const bool ok = R < NR;
  const int pos = R / p.G;
  const long long scratch = (long long)blockIdx.x * NR;

  float qr[D], dor[D], acc[D];
  float delta = 0.f;
  {
    const long long qo = ok ? row_offset(R, b, hk, p.qs, p) : 0;
    const long long doo = ok ? row_offset(R, b, hk, p.dos, p) : 0;
    const long long oo = ok ? row_offset(R, b, hk, p.os, p) : 0;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = ok ? q[qo + d] : 0.f;
      dor[d] = ok ? dout[doo + d] : 0.f;
      delta = fmaf(dor[d], ok ? o[oo + d] : 0.f, delta);
      acc[d] = 0.f;
    }
  }
  const int n_tiles = key_tiles(R0, kF32Threads, kF32Keys, p);
  const float* kb = k + b * p.ks.b + hk * p.ks.h;
  const float* vb = v + b * p.vs.b + hk * p.vs.h;

  float m = kNegInf, l = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kF32Keys;
    __syncthreads();
    for (int c = threadIdx.x; c < kF32Keys * D; c += blockDim.x) {
      const int r = c / D, d = c % D, key = kv0 + r;
      Ks[r][d] = key < p.Skv ? kb[key * p.ks.s + d] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kF32Keys; ++j) {
      float x = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) x = fmaf(qr[d], Ks[j][d], x);
      x *= p.scale;
      const int key = kv0 + j;
      if (key >= p.Skv || (p.causal && key > pos)) continue;
      const float mx = fmaxf(m, x);
      l = l * expf(m - mx) + expf(x - mx);
      m = mx;
    }
  }
  const float lse = m + logf(fmaxf(l, 1e-30f));

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kF32Keys;
    __syncthreads();
    for (int c = threadIdx.x; c < kF32Keys * D; c += blockDim.x) {
      const int r = c / D, d = c % D, key = kv0 + r;
      Ks[r][d] = key < p.Skv ? kb[key * p.ks.s + d] : 0.f;
      Vs[r][d] = key < p.Skv ? vb[key * p.vs.s + d] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kF32Keys; ++j) {
      const int key = kv0 + j;
      if (key >= p.Skv || (p.causal && key > pos)) continue;
      float x = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        x = fmaf(qr[d], Ks[j][d], x);
        dp = fmaf(dor[d], Vs[j][d], dp);
      }
      const float ds = expf(x * p.scale - lse) * (dp - delta);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, Ks[j][d], acc[d]);
    }
  }
  if (ok) {
    float* dqp = dq + row_offset(R, b, hk, p.dqs, p);
#pragma unroll
    for (int d = 0; d < D; ++d) dqp[d] = acc[d] * p.scale;
    p.lse[scratch + R] = lse;
    p.delta[scratch + R] = delta;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             float* __restrict__ dk, float* __restrict__ dv,
             const Params p) {
  __shared__ float Qs[kF32Rows][D];
  __shared__ float dOs[kF32Rows][D];
  __shared__ float lse_s[kF32Rows], delta_s[kF32Rows];
  __shared__ int pos_s[kF32Rows];
  const int NR = p.Sq * p.G;
  const int b = blockIdx.x / p.Hk, hk = blockIdx.x % p.Hk;
  const int kv0 = blockIdx.y * kF32Threads;
  const int key = kv0 + threadIdx.x;
  const bool ok = key < p.Skv;
  const long long scratch = (long long)blockIdx.x * NR;

  float kr[D], vr[D], dk_acc[D], dv_acc[D];
  {
    const float* kp = k + b * p.ks.b + (ok ? key : 0) * p.ks.s + hk * p.ks.h;
    const float* vp = v + b * p.vs.b + (ok ? key : 0) * p.vs.s + hk * p.vs.h;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kr[d] = ok ? kp[d] : 0.f;
      vr[d] = ok ? vp[d] : 0.f;
      dk_acc[d] = dv_acc[d] = 0.f;
    }
  }
  const int n_tiles = (NR + kF32Rows - 1) / kF32Rows;
  for (int t = first_row_tile(kv0, kF32Rows, p); t < n_tiles; ++t) {
    const int R0 = t * kF32Rows;
    __syncthreads();
    for (int c = threadIdx.x; c < kF32Rows * D; c += blockDim.x) {
      const int r = c / D, d = c % D, R = R0 + r;
      const bool in = R < NR;
      Qs[r][d] = in ? q[row_offset(R, b, hk, p.qs, p) + d] : 0.f;
      dOs[r][d] = in ? dout[row_offset(R, b, hk, p.dos, p) + d] : 0.f;
    }
    if (threadIdx.x < kF32Rows) {
      const int R = R0 + threadIdx.x;
      const bool in = R < NR;
      lse_s[threadIdx.x] = in ? p.lse[scratch + R] : 0.f;
      delta_s[threadIdx.x] = in ? p.delta[scratch + R] : 0.f;
      pos_s[threadIdx.x] = in ? R / p.G : -1;
    }
    __syncthreads();
    for (int r = 0; r < kF32Rows; ++r) {
      const int pos = pos_s[r];
      if (!ok || pos < 0 || (p.causal && key > pos)) continue;
      float x = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        x = fmaf(Qs[r][d], kr[d], x);
        dp = fmaf(dOs[r][d], vr[d], dp);
      }
      const float pr = expf(x * p.scale - lse_s[r]);
      const float ds = pr * (dp - delta_s[r]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dv_acc[d] = fmaf(pr, dOs[r][d], dv_acc[d]);
        dk_acc[d] = fmaf(ds, Qs[r][d], dk_acc[d]);
      }
    }
  }
  if (ok) {
    float* dkp = dk + b * p.dks.b + key * p.dks.s + hk * p.dks.h;
    float* dvp = dv + b * p.dvs.b + key * p.dvs.s + hk * p.dvs.h;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dkp[d] = dk_acc[d] * p.scale;
      dvp[d] = dv_acc[d];
    }
  }
}

// ------------------------------------------------------------- launch ---
template <typename T, int D>
int run(const T* q, const T* k, const T* v, const T* o, const T* dout, T* dq,
        T* dk, T* dv, int B, const Params& p, cudaStream_t stream) {
  const int NR = p.Sq * p.G;
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    using C = Cfg<D>;
    err = cudaFuncSetAttribute(bwd_dq_bf16<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem1);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(bwd_dkdv_bf16<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem2);
    if (err != cudaSuccess) return err;
    bwd_dq_bf16<D><<<dim3(B * p.Hk, (NR + kRows - 1) / kRows), kThreads,
                     C::kSmem1, stream>>>(q, k, v, o, dout, dq, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bwd_dkdv_bf16<D><<<dim3(B * p.Hk, (p.Skv + kRows - 1) / kRows),
                       kThreads, C::kSmem2, stream>>>(q, k, v, dout, dk, dv,
                                                      p);
  } else {
    bwd_dq_f32<D><<<dim3(B * p.Hk, (NR + kF32Threads - 1) / kF32Threads),
                    kF32Threads, 0, stream>>>(q, k, v, o, dout, dq, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bwd_dkdv_f32<D><<<dim3(B * p.Hk,
                           (p.Skv + kF32Threads - 1) / kF32Threads),
                      kF32Threads, 0, stream>>>(q, k, v, dout, dk, dv, p);
  }
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, void* dq, void* dk, void* dv, float* lse,
             float* delta, int B, int Sq, int Skv, int H, int Hk, int D,
             const long long* st, int causal, void* stream) {
  auto S = [&](int i) {
    return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  };
  const Params p{Sq, Skv, Hk, H / Hk, causal,
                 S(0), S(1), S(2), S(3), S(4), S(5), S(6), S(7),
                 1.0f / sqrtf(static_cast<float>(D)), lse, delta};
  const T *cq = static_cast<const T*>(q), *ck = static_cast<const T*>(k),
          *cv = static_cast<const T*>(v), *co = static_cast<const T*>(o),
          *cdo = static_cast<const T*>(dout);
  T *mq = static_cast<T*>(dq), *mk = static_cast<T*>(dk),
    *mv = static_cast<T*>(dv);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return run<T, 16>(cq, ck, cv, co, cdo, mq, mk, mv, B, p, s);
    case 32: return run<T, 32>(cq, ck, cv, co, cdo, mq, mk, mv, B, p, s);
    case 64: return run<T, 64>(cq, ck, cv, co, cdo, mq, mk, mv, B, p, s);
    case 128: return run<T, 128>(cq, ck, cv, co, cdo, mq, mk, mv, B, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 24 element strides, (batch, sequence, head) of q, k, v, o, do,
// dq, dk, dv in that order. lse, delta: fp32 scratch of B * H * Sq floats
// each. Returns cudaGetLastError() after the launches.
#define BWD_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const void* o, const void* dout, void* dq, void* dk,  \
                      void* dv, float* lse, float* delta, int B, int Sq,    \
                      int Skv, int H, int Hk, int D,                        \
                      const long long* strides, int causal, void* stream) { \
    return dispatch<T>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq,     \
                       Skv, H, Hk, D, strides, causal, stream);             \
  }

BWD_ENTRY(flash_attention_bwd_bf16, bf16)
BWD_ENTRY(flash_attention_bwd_f32, float)
