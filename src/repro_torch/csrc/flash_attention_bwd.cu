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
// Hk=4, D=64, bf16, causal) it must move 76 MB (q, o, do, dq at 16.8 MB,
// k, v, dk, dv at 2.1 MB, the forward's lse at 0.5 MB), 22.7 us at
// 3.35 TB/s, and do 21.5 GFLOP of causal products (five products of the
// forward's two), 21.7 us at 989 TFLOP/s. This design does three more
// products (S and dP again in the dq pass, as no atomics may sum dq across
// key blocks, and P.K there, for delta below) and moves fp32 partials of
// dk and dv (below).
//
// Design: three launches and no atomics, so a run reproduces bit for bit.
// Both gradient passes are one warpgroup (4 warps) a block on wgmma
// m64n64k16 / m64nDk16 (bf16 in, fp32 accumulate), with shared tiles of 64
// rows stored as the TMA unit's swizzle lays them out (wgmma.cuh, the
// forward's layout), fed by a 2-stage cp.async ring so the next tile's
// copies overlap this tile's products.
//  1. dq pass: 64 folded query rows of one (b, hk) a block. It reads the
//     forward's lse and walks its keys once, 64 a tile: S = Q.K^T,
//     dP = dO.V^T (both operands in shared memory), P = 2^(s c -
//     lse log2(e)), dS = P (dP - delta), dq += dS.K and P.K (dS and P
//     from registers, K transposed by the descriptor). delta = rowsum(dO
//     o) is computed at its head; at its end each row's dS is corrected to
//     sum to 0 (its comment says why) and the corrected delta is handed to
//     pass 2 through fp32 scratch.
//  2. dk/dv pass: 64 keys of one (b, hk) and one range of the folded query
//     rows that reach them a block (the wrapper's n_split sets the ranges,
//     so the first keys' long walks spread over several blocks): S^T =
//     K.Q^T, dP^T = V.dO^T, then dv += P^T.dO and dk += dS^T.Q, all G heads
//     summed in the accumulators. Each block writes fp32 partial sums of
//     its 64 keys' dk and dv.
//  3. reduce: each key tile's partials summed in range order and rounded
//     once to the output type.
// Under the causal mask a block's work grows with its last row (pass 1) or
// shrinks with its first key (pass 2); pass 1 launches the longest blocks
// first, pass 2 cuts the long walks into ranges of equal rows. A thread's
// folded-row addresses move from tile to tile with no division.
// Exponentials are in base 2 (ex2.approx, as the forward) with log2(e)
// folded into the scale; only tiles across the diagonal, Skv or the last
// row evaluate the mask. Each product group is waited for before the next
// step: leaving the second product running into the next tile's scores (a
// 3-buffer ring) measured slower (PERF.md, the flash backward).
//
// fp32 (not on a training path): scalar fp32 FMA (no TF32), the same three
// passes, one thread per query row (pass 1) or per key (pass 2), K/V or
// Q/dO tiles staged in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

using namespace hopper;

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;          // rows (pass 1) or keys (pass 2) a block
constexpr int kThreads = 128;      // four warps, 16 rows each
constexpr int kStages = 2;         // inner tiles in flight (cp.async ring)

struct Strides {
  long long b, s, h;  // element strides of batch, sequence, head
};

struct Params {
  int Sq, Skv, Hk, G, causal;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float scale;                     // 1 / sqrt(D)
  const float* lse;                // (B * Hk, Sq * G): the forward's
  float* delta;                    // (B * Hk, Sq * G) fp32 scratch
  int span;                        // folded rows a range (pass 2), k * kRows
  int ranges;                      // ranges of all key tiles, a (b, hk)
  float* dk_part;                  // (B * Hk, ranges, kRows, D) fp32
  float* dv_part;                  //   partial sums of pass 2
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

// Pass 2 cuts the folded query rows that reach key tile t (64 keys from
// kv0 = 64 t: rows R >= kv0 G under the causal mask, as pos = R / G >= kv0,
// else all rows) into ranges of `span` rows, the last one shorter.
__host__ __device__ __forceinline__ int range_start(int t, const Params& p) {
  return p.causal ? t * kRows * p.G : 0;
}
__host__ __device__ __forceinline__ int ranges_of(int t, const Params& p) {
  const int lo = range_start(t, p), NR = p.Sq * p.G;
  return lo < NR ? (NR - lo + p.span - 1) / p.span : 0;
}

// ---------------------------------------------------------------- bf16 ---
// Row `r` of the folded rows of (b, hk): its address in a (B, S, H, D)
// tensor, or nullptr past the last row.
__device__ __forceinline__ long long row_offset(int R, int b, int hk,
                                                const Strides& s,
                                                const Params& p) {
  const int pos = R / p.G, h = hk * p.G + R % p.G;
  return b * s.b + pos * s.s + h * s.h;
}

// The folded query rows that this thread copies from each tile of N rows,
// r_i = threadIdx.x / (D / 8) + i * kStep, as (position, head in the
// group), moved N rows a tile with no division.
template <int D, int N>
struct RowCursor {
  static constexpr int kChunks = D / 8;            // 16-byte chunks a row
  static constexpr int kStep = kThreads / kChunks;
  static constexpr int kCount = N / kStep;
  int pos[kCount], g[kCount];
  __device__ __forceinline__ RowCursor(int R0, int G) {
#pragma unroll
    for (int i = 0; i < kCount; ++i) {
      const int R = R0 + threadIdx.x / kChunks + i * kStep;
      pos[i] = R / G;
      g[i] = R - pos[i] * G;
    }
  }
  __device__ __forceinline__ void next(int dpos, int dg, int G) {
#pragma unroll
    for (int i = 0; i < kCount; ++i) {
      pos[i] += dpos;
      g[i] += dg;
      if (g[i] >= G) {
        g[i] -= G;
        ++pos[i];
      }
    }
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `n` of this thread's newest groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}

// cp.async writes shared memory through the generic proxy, wgmma reads it
// through the async proxy: each thread fences its landed copies before the
// barrier that precedes the products.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory tiles of 64 rows x D, in wgmma.cuh's swizzled panels.
template <int D>
struct Cfg {
  static constexpr int kTile = kRows * D * 2;
  static constexpr int kPanel = kRows * Swizzle<D>::kSw;  // bytes a panel
  // pass 1: Q, dO, kStages stages of (K, V), delta; 1024: the alignment
  static constexpr int kSmem1 = 1024 + (2 + 2 * kStages) * kTile
                                + kRows * 4;
  // pass 2: K, V, kStages stages of (Q, dO), then of (lse, delta)
  static constexpr int kSmem2 = 1024 + (2 + 2 * kStages) * kTile
                                + kStages * kRows * 8;
};

// The swizzle repeats every 1024 bytes: tiles start on that boundary.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Keys kv0 .. kv0 + 63 of a (B, Skv, Hk, D) tensor into a swizzled tile by
// cp.async, zeros past Skv.
template <int D>
__device__ __forceinline__ void stage_keys(unsigned char* dst, const bf16* src,
                                           int kv0, int b, int hk,
                                           const Strides& s,
                                           const Params& p) {
  constexpr int kChunks = D / 8;            // 16-byte chunks a row
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks, ch = c % kChunks, key = kv0 + r;
    const bool ok = key < p.Skv;
    cp_async16(dst + Swizzle<D>::chunk(kRows, r, ch),
               src + (ok ? b * s.b + key * s.s + hk * s.h : 0) + ch * 8, ok);
  }
}

// d (64 x 64) = A (64 x D) . B (64 x D)^T, both swizzled tiles, K-major:
// D / 16 wgmma k16 steps (the caller fences and commits).
template <int D>
__device__ __forceinline__ void scores(float (&d)[32], uint32_t a_s,
                                       uint32_t b_s) {
  using Sw = Swizzle<D>;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t off = (ks / Sw::kStepsPerPanel) * Cfg<D>::kPanel
                         + (ks % Sw::kStepsPerPanel) * 32;
    wgmma_ss_n64(d, gmma_desc(a_s + off, 16, 8 * Sw::kSw, Sw::kLayout),
                 gmma_desc(b_s + off, 16, 8 * Sw::kSw, Sw::kLayout), ks > 0);
  }
}

// acc (64 x D) += X (64 x 64: registers, the bf16 A fragments of four k16
// steps, packed from a score tile's accumulators) . B (a swizzled 64 x D
// tile, read along its rows: the descriptor transposes it, 8-row groups
// 8 kSw bytes apart, panels kPanel apart).
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2],
                                           const uint32_t (&x)[4][4],
                                           uint32_t b_s) {
  using Sw = Swizzle<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<D>(acc, x[kk], gmma_desc(b_s + kk * 16 * Sw::kSw,
                                      Cfg<D>::kPanel, 8 * Sw::kSw,
                                      Sw::kLayout));
}

// Score accumulators j (8 columns each) into the A fragments of the next
// product: columns 16 kk .. 16 kk + 15 are k16 step kk, as the forward
// packs P.
__device__ __forceinline__ void pack_cols(uint32_t (&x)[4][4], int j,
                                          const float (&v)[4]) {
  x[j / 2][2 * (j & 1)] = pack_bf16(v[0], v[1]);
  x[j / 2][2 * (j & 1) + 1] = pack_bf16(v[2], v[3]);
}

// The sum of a packed pair, as the product reads it (rounded to bf16).
__device__ __forceinline__ float packed_sum(uint32_t x) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return f.x + f.y;
}

// Pass 1: dq, and delta into scratch. Grid (B * Hk, row tiles): the blocks
// launch row tile by row tile, the longest rows (causal) first. One
// warpgroup on wgmma: warp w holds rows 16 w .. 16 w + 15 of the
// accumulators (element i: row 16 w + gq + 8 ((i % 4) / 2), column
// 8 (i / 4) + 2 tq + i % 2).
//
// delta. rowsum(dO o) reads the forward's bf16 output, so it is off the
// exact sum_j p_ij dp_ij by o's rounding, and dS_i then sums to that error
// c_i in place of 0. dq_i = sum_j dS_ij k_j carries c_i (P K)_i, which a
// component common to all keys makes large against dq itself (in a
// seamless-m4t decoder layer whose keys' mean is 0.82 of their spread
// about it, 1.1% of dq's norm; tools/flash_bwd_tolerance.py, and measured
// on an H100). So the walk also sums each row's dS and P
// as the products read them (bf16) and accumulates P K, and dq takes
// dS - (c_i / sum_j P_ij) P: its row sums to 0, as the exact dS's. Pass 2
// gets delta + c_i / sum_j P_ij, the same correction.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 3 : 1)
bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ o,
            const bf16* __restrict__ dout, bf16* __restrict__ dq,
            const Params p) {
  using Sw = Swizzle<D>;
  constexpr int kTile = Cfg<D>::kTile;
  constexpr int kChunks = D / 8;            // 16-byte chunks a row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* dOs = Qs + kTile;
  unsigned char* KVs = dOs + kTile;         // stage st: K, then V
  float* delta_s = reinterpret_cast<float*>(KVs + kStages * 2 * kTile);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int NR = p.Sq * p.G;
  const int b = blockIdx.x / p.Hk, hk = blockIdx.x % p.Hk;
  // causal: the longest rows (last positions) first
  const int tile = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int R0 = tile * kRows;
  const long long scratch = (long long)blockIdx.x * NR;
  const float scale_log2 = p.scale * kLog2e;
  const int n_tiles = key_tiles(R0, kRows, kRows, p);

  // the ring's tile t of keys into stage t % kStages
  auto load_kv = [&](int t) {
    unsigned char* st = KVs + (t % kStages) * 2 * kTile;
    stage_keys<D>(st, k, t * kRows, b, hk, p.ks, p);
    stage_keys<D>(st + kTile, v, t * kRows, b, hk, p.vs, p);
  };
  {  // first group: this block's Q and dO rows, the ring's first tiles
    const RowCursor<D, kRows> rows(R0, p.G);
    const int ch = threadIdx.x % kChunks;
#pragma unroll
    for (int i = 0; i < RowCursor<D, kRows>::kCount; ++i) {
      const int ri = threadIdx.x / kChunks + i * RowCursor<D, kRows>::kStep;
      const bool ok = rows.pos[i] * p.G + rows.g[i] < NR;
      const int h = hk * p.G + rows.g[i];
      const long long oq = ok ? b * p.qs.b + rows.pos[i] * p.qs.s
                                + h * p.qs.h : 0;
      const long long od = ok ? b * p.dos.b + rows.pos[i] * p.dos.s
                                + h * p.dos.h : 0;
      const uint32_t at = Sw::chunk(kRows, ri, ch);
      cp_async16(Qs + at, q + oq + ch * 8, ok);
      cp_async16(dOs + at, dout + od + ch * 8, ok);
    }
  }
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();
  }
  // o's rows (for delta) and lse are read into registers meanwhile
  const int dr = threadIdx.x >> 1, half = threadIdx.x & 1;  // delta: two
  uint4 ov[D / 16];                                         // threads a row
  {
    const bool ok = R0 + dr < NR;
    const uint4* op = reinterpret_cast<const uint4*>(
        o + (ok ? row_offset(R0 + dr, b, hk, p.os, p) : 0) + half * (D / 2));
#pragma unroll
    for (int i = 0; i < D / 16; ++i)
      ov[i] = ok ? op[i] : make_uint4(0u, 0u, 0u, 0u);
  }
  const int RA = R0 + warp * 16 + gq, RB = RA + 8;  // this thread's rows
  // P = 2^(s c - lse log2(e)) with the forward's lse (natural units)
  const float lseA = RA < NR ? p.lse[scratch + RA] * kLog2e : 0.f;
  const float lseB = RB < NR ? p.lse[scratch + RB] * kLog2e : 0.f;
  cp_async_wait<kStages - 2>();             // the first group has landed
  __syncthreads();
  {  // delta = rowsum(dO o)
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      const uint4 x = *reinterpret_cast<const uint4*>(
          dOs + Sw::chunk(kRows, dr, half * (D / 16) + i));
      const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* ya =
          reinterpret_cast<const __nv_bfloat162*>(&ov[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 a = __bfloat1622float2(xa[j]);
        const float2 c = __bfloat1622float2(ya[j]);
        s = fmaf(a.x, c.x, fmaf(a.y, c.y, s));
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (half == 0) delta_s[dr] = s;
  }
  __syncthreads();

  const int posA = RA / p.G, posB = RB / p.G;
  const float deltaA = delta_s[RA - R0], deltaB = delta_s[RB - R0];
  const uint32_t q_s = smem_u32(Qs), do_s = smem_u32(dOs);

  // dq += dS . K and pk += P . K, one walk over the keys, the next tiles'
  // copies in flight; dS and P summed along the rows, as rounded to bf16
  float acc[D / 2], pk[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = pk[i] = 0.f;
  float dsA = 0.f, dsB = 0.f, pA = 0.f, pB = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kRows;
    if (t + kStages - 1 < n_tiles) load_kv(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();           // tile t has landed
    fence_async_smem();
    __syncthreads();
    const uint32_t k_s = smem_u32(KVs + (t % kStages) * 2 * kTile);
    const uint32_t v_s = k_s + kTile;

    // S = Q K^T, dP = dO V^T: 64 rows x 64 keys each
    float sc[32], dp[32];
    wgmma_fence();
    scores<D>(sc, q_s, k_s);
    scores<D>(dp, do_s, v_s);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // dS = P (dP - delta); only tiles across the diagonal or Skv mask
    // (causal: the block's first row, at position R0 / G, is before the
    // tile's last key)
    const bool edge = kv0 + kRows > p.Skv
                      || (p.causal && R0 < (kv0 + kRows - 1) * p.G);
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float pr[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + j * 8 + 2 * tq + (e & 1);
        const bool a = e < 2;
        const bool masked = edge && (key >= p.Skv
                                     || (p.causal && key > (a ? posA : posB)));
        pr[e] = masked ? 0.f
                       : ex2(fmaf(sc[4 * j + e], scale_log2,
                                  -(a ? lseA : lseB)));
        ds[e] = pr[e] * (dp[4 * j + e] - (a ? deltaA : deltaB));
      }
      pack_cols(pa, j, pr);
      pack_cols(da, j, ds);
      const int x = j / 2, y = 2 * (j & 1);
      pA += packed_sum(pa[x][y]);
      pB += packed_sum(pa[x][y + 1]);
      dsA += packed_sum(da[x][y]);
      dsB += packed_sum(da[x][y + 1]);
    }
    fence_regs(acc);
    fence_regs(pk);
    wgmma_fence();
    accumulate<D>(acc, da, k_s);
    accumulate<D>(pk, pa, k_s);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(pk);
    __syncthreads();                        // stage free for tile t + kStages
  }

  // the rows' sums over the quad of threads that holds them (tq = 0..3)
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    pA += __shfl_xor_sync(0xffffffffu, pA, m);
    pB += __shfl_xor_sync(0xffffffffu, pB, m);
    dsA += __shfl_xor_sync(0xffffffffu, dsA, m);
    dsB += __shfl_xor_sync(0xffffffffu, dsB, m);
  }
  // c = sum_j dS / sum_j P: dS - c P sums to 0 along the row
  const float cA = pA > 0.f ? dsA / pA : 0.f;
  const float cB = pB > 0.f ? dsB / pB : 0.f;
  if (tq == 0) {
    if (RA < NR) p.delta[scratch + RA] = deltaA + cA;
    if (RB < NR) p.delta[scratch + RB] = deltaB + cB;
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * tq;
    if (RA < NR)
      *reinterpret_cast<uint32_t*>(dq + row_offset(RA, b, hk, p.dqs, p)
                                   + col) =
          pack_bf16(fmaf(-cA, pk[4 * j], acc[4 * j]) * p.scale,
                    fmaf(-cA, pk[4 * j + 1], acc[4 * j + 1]) * p.scale);
    if (RB < NR)
      *reinterpret_cast<uint32_t*>(dq + row_offset(RB, b, hk, p.dqs, p)
                                   + col) =
          pack_bf16(fmaf(-cB, pk[4 * j + 2], acc[4 * j + 2]) * p.scale,
                    fmaf(-cB, pk[4 * j + 3], acc[4 * j + 3]) * p.scale);
  }
}

// Key tile t and folded rows [lo, hi) of pass 2's block y: key tile 0's
// ranges first, then key tile 1's, ...
__device__ __forceinline__ void block_range(int y, const Params& p, int& t,
                                            int& lo, int& hi) {
  t = 0;
  for (int n = ranges_of(0, p); y >= n; n = ranges_of(++t, p)) y -= n;
  lo = range_start(t, p) + y * p.span;
  hi = min(lo + p.span, p.Sq * p.G);
}

// Pass 2: partial dk and dv of 64 keys over one range of the rows that
// reach them, on wgmma. Grid (B * Hk, ranges). One warpgroup: warp w holds
// keys 16 w .. 16 w + 15 of the accumulators (wgmma's m64 layout); K and V
// stay in shared memory as the A operands of S^T = K Q^T and dP^T = V dO^T;
// P^T and dS^T, rounded to bf16, are the register A operands of
// dV += P^T dO and dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 3 : 1)
bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const Params p) {
  using Sw = Swizzle<D>;
  constexpr int N = kRows;                  // folded rows a tile
  constexpr int kTile = Cfg<D>::kTile;
  constexpr int kChunks = D / 8;            // 16-byte chunks a row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align1024(smem_raw);
  unsigned char* Vs = Ks + kTile;
  unsigned char* QdOs = Vs + kTile;         // stage st: Q, then dO
  float* ld_s = reinterpret_cast<float*>(QdOs + kStages * 2 * kTile);
                                            // stage st: lse, then delta

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int NR = p.Sq * p.G;
  const int b = blockIdx.x / p.Hk, hk = blockIdx.x % p.Hk;
  int key_tile, lo, hi;
  block_range(blockIdx.y, p, key_tile, lo, hi);
  const int kv0 = key_tile * kRows;
  const long long scratch = (long long)blockIdx.x * NR;
  const float scale_log2 = p.scale * kLog2e;
  const int t0 = lo / N, n_tiles = (hi + N - 1) / N;   // lo: a multiple of N

  // the ring's tile t of folded rows into stage t % kStages; tiles come
  // in order, one call each
  RowCursor<D, N> rows(t0 * N, p.G);
  const int dpos = N / p.G, dg = N % p.G;
  auto load_rows = [&](int t) {
    const int st = t % kStages, ch = threadIdx.x % kChunks;
    unsigned char* dst = QdOs + st * 2 * kTile;
#pragma unroll
    for (int i = 0; i < RowCursor<D, N>::kCount; ++i) {
      const int ri = threadIdx.x / kChunks + i * RowCursor<D, N>::kStep;
      const bool ok = rows.pos[i] * p.G + rows.g[i] < NR;
      const int h = hk * p.G + rows.g[i];
      const long long oq = ok ? b * p.qs.b + rows.pos[i] * p.qs.s
                                + h * p.qs.h : 0;
      const long long od = ok ? b * p.dos.b + rows.pos[i] * p.dos.s
                                + h * p.dos.h : 0;
      const uint32_t at = Sw::chunk(N, ri, ch);
      cp_async16(dst + at, q + oq + ch * 8, ok);
      cp_async16(dst + kTile + at, dout + od + ch * 8, ok);
    }
    rows.next(dpos, dg, p.G);
    if (threadIdx.x < 2 * N) {
      const int i = threadIdx.x % N, R = t * N + i;
      const float* src = threadIdx.x < N ? p.lse : p.delta;
      cp_async4(ld_s + st * 2 * N + threadIdx.x,
                src + scratch + (R < NR ? R : 0), R < NR);
    }
  };
  // first group: K, V and the ring's first tiles
  stage_keys<D>(Ks, k, kv0, b, hk, p.ks, p);
  stage_keys<D>(Vs, v, kv0, b, hk, p.vs, p);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (t0 + i < n_tiles) load_rows(t0 + i);
    cp_async_commit();
  }

  // this thread's accumulator rows: keys kv0 + 16 w + gq (+ 8)
  const int keyA = kv0 + warp * 16 + gq, keyB = keyA + 8;
  // causal: row R reaches a key iff R / G >= key, i.e. R >= key G
  const int keyGA = keyA * p.G, keyGB = keyB * p.G;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint32_t k_s = smem_u32(Ks), v_s = smem_u32(Vs);

  for (int t = t0; t < n_tiles; ++t) {
    const int R0 = t * N;
    if (t + kStages - 1 < n_tiles) load_rows(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();           // tile t has landed
    fence_async_smem();
    __syncthreads();
    const int st = t % kStages;
    const uint32_t q_s = smem_u32(QdOs + st * 2 * kTile);
    const uint32_t do_s = q_s + kTile;
    const float* lse_s = ld_s + st * 2 * N;
    const float* delta_s = lse_s + N;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 rows each
    float sc[32], dp[32];
    wgmma_fence();
    scores<D>(sc, k_s, q_s);
    scores<D>(dp, v_s, do_s);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // P^T = 2^(s c - lse log2(e)), dS^T = P^T (dP^T - delta); element i is
    // key keyA (i % 4 < 2) or keyB, row R0 + 8 (i / 4) + 2 tq + i % 2. Only
    // tiles across the diagonal, Skv or the last row mask.
    const bool edge = R0 + N > NR || kv0 + kRows > p.Skv
                      || (p.causal && R0 < (kv0 + kRows - 1) * p.G);
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float pr[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * tq + (e & 1);
        const int R = R0 + col;
        const bool masked = edge && (R >= NR || (e < 2 ? keyA : keyB) >= p.Skv
                                     || (p.causal && R < (e < 2 ? keyGA
                                                              : keyGB)));
        pr[e] = masked ? 0.f
                       : ex2(fmaf(sc[4 * j + e], scale_log2,
                                  -lse_s[col] * kLog2e));
        ds[e] = pr[e] * (dp[4 * j + e] - delta_s[col]);
      }
      pack_cols(pa, j, pr);
      pack_cols(da, j, ds);
    }

    // dV += P^T dO, dK += dS^T Q
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
    accumulate<D>(dv_acc, pa, do_s);
    accumulate<D>(dk_acc, da, q_s);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncthreads();                        // stage free for tile t + kStages
  }

  // fp32 partial sums, this block's (64, D) slice: accumulator i is key
  // 16 w + gq + 8 ((i % 4) / 2), column 8 (i / 4) + 2 tq + i % 2
  const long long part =
      ((long long)blockIdx.x * gridDim.y + blockIdx.y) * kRows * D;
  float* dkp = p.dk_part + part + (warp * 16 + gq) * D;
  float* dvp = p.dv_part + part + (warp * 16 + gq) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * tq;
    *reinterpret_cast<float2*>(dkp + col) =
        make_float2(dk_acc[4 * j] * p.scale, dk_acc[4 * j + 1] * p.scale);
    *reinterpret_cast<float2*>(dkp + 8 * D + col) =
        make_float2(dk_acc[4 * j + 2] * p.scale, dk_acc[4 * j + 3] * p.scale);
    *reinterpret_cast<float2*>(dvp + col) =
        make_float2(dv_acc[4 * j], dv_acc[4 * j + 1]);
    *reinterpret_cast<float2*>(dvp + 8 * D + col) =
        make_float2(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
  }
}

// ------------------------------------------------------------- reduce ---
__device__ __forceinline__ void store4(bf16* dst, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}
__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}
__device__ __forceinline__ void add4(float4& a, const float* src) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
}

constexpr int kReduceThreads = 256;

// Pass 3: dk, dv of key tile blockIdx.y = the sum of its ranges' partials,
// in range order (no atomics: a run reproduces bit for bit), rounded once
// to the output type. Zero where no row reaches the keys. Grid (B * Hk,
// key tiles).
template <typename T, int D>
__global__ void __launch_bounds__(kReduceThreads)
bwd_reduce(T* __restrict__ dk, T* __restrict__ dv, const Params p) {
  const int b = blockIdx.x / p.Hk, hk = blockIdx.x % p.Hk;
  const int t = blockIdx.y;
  int first = 0;
  for (int u = 0; u < t; ++u) first += ranges_of(u, p);
  const int n = ranges_of(t, p);
  const long long base = ((long long)blockIdx.x * p.ranges + first) * kRows
                         * D;
  for (int e = threadIdx.x * 4; e < kRows * D; e += kReduceThreads * 4) {
    const int key = t * kRows + e / D, d = e % D;
    if (key >= p.Skv) break;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int j = 0; j < n; ++j) {
      add4(sk, p.dk_part + base + (long long)j * kRows * D + e);
      add4(sv, p.dv_part + base + (long long)j * kRows * D + e);
    }
    store4(dk + b * p.dks.b + key * p.dks.s + hk * p.dks.h + d, sk);
    store4(dv + b * p.dvs.b + key * p.dvs.s + hk * p.dvs.h + d, sv);
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

  const float lse = ok ? p.lse[scratch + R] : 0.f;

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
    p.delta[scratch + R] = delta;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const Params p) {
  __shared__ float Qs[kF32Rows][D];
  __shared__ float dOs[kF32Rows][D];
  __shared__ float lse_s[kF32Rows], delta_s[kF32Rows];
  __shared__ int pos_s[kF32Rows];
  const int NR = p.Sq * p.G;
  const int b = blockIdx.x / p.Hk, hk = blockIdx.x % p.Hk;
  int key_tile, lo, hi;
  block_range(blockIdx.y, p, key_tile, lo, hi);
  const int kv0 = key_tile * kRows;          // kF32Threads == kRows keys
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
  for (int R0 = lo; R0 < hi; R0 += kF32Rows) {
    __syncthreads();
    for (int c = threadIdx.x; c < kF32Rows * D; c += blockDim.x) {
      const int r = c / D, d = c % D, R = R0 + r;
      const bool in = R < hi;
      Qs[r][d] = in ? q[row_offset(R, b, hk, p.qs, p) + d] : 0.f;
      dOs[r][d] = in ? dout[row_offset(R, b, hk, p.dos, p) + d] : 0.f;
    }
    if (threadIdx.x < kF32Rows) {
      const int R = R0 + threadIdx.x;
      const bool in = R < hi;
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
  const long long part =
      (((long long)blockIdx.x * gridDim.y + blockIdx.y) * kRows + threadIdx.x)
      * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    p.dk_part[part + d] = dk_acc[d] * p.scale;
    p.dv_part[part + d] = dv_acc[d];
  }
}

// ------------------------------------------------------------- launch ---
template <typename T, int D>
int run(const T* q, const T* k, const T* v, const T* o, const T* dout, T* dq,
        T* dk, T* dv, int B, const Params& p, cudaStream_t stream) {
  const int NR = p.Sq * p.G;
  const dim3 grid2(B * p.Hk, p.ranges);
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
    bwd_dkdv_bf16<D><<<grid2, kThreads, C::kSmem2, stream>>>(q, k, v, dout,
                                                            p);
  } else {
    bwd_dq_f32<D><<<dim3(B * p.Hk, (NR + kF32Threads - 1) / kF32Threads),
                    kF32Threads, 0, stream>>>(q, k, v, o, dout, dq, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bwd_dkdv_f32<D><<<grid2, kF32Threads, 0, stream>>>(q, k, v, dout, p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_reduce<T, D><<<dim3(B * p.Hk, (p.Skv + kRows - 1) / kRows),
                     kReduceThreads, 0, stream>>>(dk, dv, p);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, void* dq, void* dk, void* dv,
             float* delta, float* dk_part, float* dv_part, int B, int Sq,
             int Skv, int H, int Hk, int D, const long long* st, int causal,
             int span, int ranges, void* stream) {
  auto S = [&](int i) {
    return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  };
  const Params p{Sq, Skv, Hk, H / Hk, causal,
                 S(0), S(1), S(2), S(3), S(4), S(5), S(6), S(7),
                 1.0f / sqrtf(static_cast<float>(D)), lse, delta,
                 span, ranges, dk_part, dv_part};
  // the caller's count of ranges sized the partials: it must be this one
  if (span <= 0 || span % kRows) return cudaErrorInvalidValue;
  long long count = 0;
  for (int t = 0; t < (Skv + kRows - 1) / kRows; ++t) count += ranges_of(t, p);
  if (count != ranges || ranges < 1 || ranges > 65535)
    return cudaErrorInvalidValue;
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
// dq, dk, dv in that order. lse: the forward's (B, Hk, Sq * G) fp32 row
// log-sum-exp; delta: fp32 scratch of B * H * Sq floats; dk_part, dv_part:
// fp32 scratch of B * Hk * ranges * 64 * D floats each, where `ranges`
// counts the ranges of `span` rows (a multiple of 64) of every key tile
// (ranges_of above; cudaErrorInvalidValue if the count differs). Returns
// cudaGetLastError() after each of the three launches.
#define BWD_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const void* o, const void* dout, const float* lse,    \
                      void* dq, void* dk, void* dv, float* delta,           \
                      float* dk_part, float* dv_part, int B, int Sq,        \
                      int Skv, int H, int Hk, int D,                        \
                      const long long* strides, int causal, int span,       \
                      int ranges, void* stream) {                           \
    return dispatch<T>(q, k, v, o, dout, lse, dq, dk, dv, delta, dk_part,   \
                       dv_part, B, Sq, Skv, H, Hk, D, strides, causal, span,\
                       ranges, stream);                                     \
  }

BWD_ENTRY(flash_attention_bwd_bf16, bf16)
BWD_ENTRY(flash_attention_bwd_f32, float)
