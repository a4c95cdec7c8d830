// Flash attention (prefill) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py :: flash_attention_kernel
//   (launched by flash_attention_pallas, adapter ops.py :: flash_attention).
// Same function: blocked online-softmax attention scaled by 1/sqrt(D), with
// an optional causal mask qpos >= kpos (both counted from 0). m, l and the
// accumulator are fp32; p is rounded to V's dtype before P.V and l sums the
// unrounded p; masked scores are -1e30; the output takes q's dtype. KV
// tiles wholly above the causal diagonal are skipped.
//
// Layout. q, o: (B, Sq, H, D); k, v: (B, Skv, Hk, D), read through their
// batch / sequence / head strides (innermost stride 1), so the model's
// tensors go in without a transposed copy. Heads fold as h = hk * G + g.
// When the caller passes an lse pointer (the training forward), each row's
// fp32 log-sum-exp of the scaled scores, (m c + log2 l) / log2(e), goes
// there at the epilogue in the backward's folded layout (B, Hk, Sq * G),
// row pos * G + g: one store per row; serving passes none.
//
// What bounds it on this card: at the prefill shape (B=8, S=512, H=32,
// Hk=4, D=64, bf16, causal) it must move 37.7 MB (q, k, v, o once), 11.3 us
// at 3.35 TB/s, and do 8.6 GFLOP of causal products, 8.7 us at 989 TFLOP/s
// -- a rate only wgmma reaches (mma.sync gets a fraction of it). Both
// bounds are close, so the loads have to overlap the products. A Pallas
// grid steps its KV axis in order with the copies of the next tile
// overlapped by the compiler; on Hopper a tile loaded by all threads
// between two barriers leaves the tensor cores idle during the load.
//
// bf16 design (the usual Hopper shape):
//   * A block owns 64 query rows of one (b, hk): P = 64 / G positions x
//     the G heads of that KV head, rows in (position, g) order, as the Pallas
//     kernel's (G*bq, D) fold, so each K/V tile serves all G heads. One TMA
//     box (D, G, P) over q's (B, S, H, D) lands the rows in that order;
//     positions past Sq are filled with zeros by the TMA unit.
//   * One producer warp keeps a ring of kStages = 2 K/V tiles (64 keys) in
//     flight with TMA; `mbarrier`s signal full and empty stages. Shared
//     tiles use the 128-byte swizzle (64- and 32-byte for D = 32, 16), rows
//     of 64 columns, so wgmma reads them without bank conflicts.
//   * One consumer warpgroup runs wgmma m64nNk16 on the 64 rows:
//     S = Q.K^T with Q and K from shared memory (K-major), then
//     O += P.V with P from registers (the score accumulators rounded to
//     bf16 are exactly wgmma's A fragments) and V from shared memory
//     through the descriptor's transpose (V stays (keys, D)). Up to four
//     blocks share an SM (D <= 64), so one block's softmax runs while
//     another's products do; two consumer warpgroups a block measured
//     slower on the H100.
//   * The online softmax stays in registers, in base 2: log2(e) is folded
//     into the scale, and each p is one FFMA and one ex2.approx.
//   * Causal: the block walks keys up to its last row's position; only the
//     tiles that cross the diagonal (or Skv) are masked. Blocks start with
//     the longest rows (the last positions), so the short ones fill the
//     last wave.
// The wgmma helpers and the swizzled tile geometry are in wgmma.cuh,
// shared with the backward. The tensor maps are built on the host with
// cuTensorMapEncodeTiled (from cudaGetDriverEntryPoint: no link against
// libcuda) and passed as __grid_constant__ parameters.
//
// Head sizes: D in {16, 32, 64, 112, 128}. The Pallas kernel takes any D
// (its blocks span D whole); D = 112 (kimi-k2-1t-a32b) is not a whole number
// of 64-column swizzle panels, so it runs in the D = 128 tile: the tensor
// maps hold the real D as their inner extent, the TMA box of the second
// panel (columns 64-127) runs past it and the unit fills columns 112-127
// with zeros (the barrier still counts the whole box's bytes). Q.K^T takes
// only the 7 k16 steps that hold data; P.V runs at N = 128, its last 16
// columns zero, and the epilogue stores 112. The scale stays 1/sqrt(112).
// Cost: P.V does 128/112 of the products D = 112 needs, and the K/V panels
// move 128/112 of the bytes into shared memory (device memory reads only
// the 112 columns).
//
// fp32 design (not on a serving path): scalar fp32 FMA, one thread per query
// row (no TF32: the fp32 tolerance is 2e-5), 16 query positions x G heads a
// block, K/V tiles of 32 keys staged in shared memory (D = 112: 28 KB).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace hopper;

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // finite, as in the reference
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, s, h;  // element strides of batch, sequence, head
};

// ---------------------------------------------------------------- fp32 ---
constexpr int kQT = 16;            // query positions per block
constexpr int kBKF = 32;           // keys per shared-memory tile

struct Params {
  int Sq, Skv, Hk, G;
  Strides qs, ks, vs, os;
  int causal;
  float scale;
  float* lse;                      // (B, Hk, Sq * G) fp32, or nullptr
};

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
    if (p.lse != nullptr)
      p.lse[(static_cast<long long>(blockIdx.y) * Sq + qpos) * G + g] =
          m + logf(denom);
  }
}

template <int D>
void run_f32(const float* q, const float* k, const float* v, float* o,
             int B, const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Sq + kQT - 1) / kQT, B * p.Hk);
  flash_f32_kernel<D><<<grid, p.G * kQT, 0, stream>>>(q, k, v, o, p);
}

// ---------------------------------------------------------------- bf16 ---
constexpr int kBM = 64;            // query rows a block: one warpgroup
constexpr int kBN = 64;            // keys a K/V tile
constexpr int kStages = 2;         // K/V tiles in flight
constexpr int kConsumers = 128;    // threads of the consumer warpgroup
constexpr int kThreads = kConsumers + 32;  // and one producer warp

// Shared-memory tiles of one head size (wgmma.cuh: panels of kPanelCols
// columns, kSw-byte rows, each panel 1024-byte aligned).
template <int D>
struct Tile : Swizzle<D> {
  using Sw = Swizzle<D>;
  static constexpr int kQPanel = kBM * Sw::kSw;
  static constexpr int kKVPanel = kBN * Sw::kSw;
  static constexpr int kQBytes = Sw::kPanels * kQPanel;
  static constexpr int kKVBytes = Sw::kPanels * kKVPanel;  // K or V a stage
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kBarriers = 8 * (1 + 2 * kStages);
  static constexpr int kSmem = 1024 + kQBytes + kStages * kStageBytes
                               + kBarriers;               // 1024: alignment
};

struct TmaParams {
  int Sq, Skv, Hk, G, P, causal;
  Strides os;
  float scale_log2;                // 1/sqrt(D) * log2(e)
  float* lse;                      // (B, Hk, Sq * G) fp32, or nullptr
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// A TMA copy of one box of a 4-D tensor map into shared memory; it
// completes `bar`'s transaction count with the box's bytes.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Accumulator layout of wgmma m64nN (per warpgroup, fp32): warp w of the
// group owns rows 16w..16w+15; with gr = lane / 4 and tq = lane % 4,
// d[4j + e] is row 16w + gr + 8 * (e >> 1), column 8j + 2tq + (e & 1).
// A fragments from registers follow the same rows: for k16 step kk,
// a = {(gr, 2tq..+1), (gr+8, 2tq..+1), (gr, 2tq+8..+9), (gr+8, 2tq+8..+9)}
// of columns 16kk.., i.e. the packed accumulators d[8kk .. 8kk+7].
// D is the tile's head size, DH <= D the tensors' (columns DH..D-1 of the
// tiles are the TMA unit's zeros).
template <int D, int DH = D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 4 : 2)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  bf16* __restrict__ o, const TmaParams p) {
  using T = Tile<D>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: tiles start on that boundary
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + T::kQBytes;  // stage s: K, then V
  const uint32_t bars = kv_s + kStages * T::kStageBytes;
  const uint32_t q_full = bars;             // then full[s], empty[s]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / p.Hk, hk = blockIdx.x % p.Hk;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * p.P;  // longest rows first
  const int q_last = min(q0 + p.P, p.Sq) - 1;
  const int kv_end = p.causal ? min(p.Skv, q_last + 1) : p.Skv;
  const int n_tiles = (kv_end + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * (1 + s), 1);                    // full[s]
      mbar_init(bars + 8 * (1 + kStages + s), kConsumers);  // empty[s]
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- producer: Q once, then the ring of K/V tiles ----
    if (lane == 0) {
      mbar_expect_tx(q_full, T::kPanels * p.P * p.G * T::kSw);
#pragma unroll
      for (int c = 0; c < T::kPanels; ++c)
        tma_load_4d(q_s + c * T::kQPanel, &tm_q, q_full, c * T::kPanelCols,
                    hk * p.G, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t full = bars + 8 * (1 + s);
        if (t >= kStages)   // the consumers released this stage's last tile
          mbar_wait(bars + 8 * (1 + kStages + s), ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full, T::kStageBytes);
        const uint32_t k_dst = kv_s + s * T::kStageBytes;
#pragma unroll
        for (int c = 0; c < T::kPanels; ++c) {
          tma_load_4d(k_dst + c * T::kKVPanel, &tm_k, full,
                      c * T::kPanelCols, hk, t * kBN, b);
          tma_load_4d(k_dst + T::kKVBytes + c * T::kKVPanel, &tm_v, full,
                      c * T::kPanelCols, hk, t * kBN, b);
        }
      }
    }
    return;
  }

  // ---- consumers: the warpgroup of warps 0-3, 16 block rows a warp ----
  const int gr = lane / 4, tq = lane % 4;
  int qpos[2], head[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gr + 8 * i;                   // block row
    qpos[i] = q0 + r / p.G;
    head[i] = hk * p.G + r % p.G;
    live[i] = r < p.P * p.G && qpos[i] < p.Sq;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};     // this thread's share of its rows' sums

  mbar_wait(q_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(bars + 8 * (1 + s), (t / kStages) & 1);
    const uint32_t k_s = kv_s + s * T::kStageBytes;
    const uint32_t v_s = k_s + T::kKVBytes;

    // S = Q K^T: 64 rows x 64 keys, DH / 16 steps of k16 (the first one
    // overwrites the accumulators).
    float sc[kBN / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      const int panel = ks / T::kStepsPerPanel;
      const uint32_t col = (ks % T::kStepsPerPanel) * 32;
      wgmma_ss_n64(sc,
                   gmma_desc(q_s + panel * T::kQPanel + col, 16, 8 * T::kSw,
                             T::kLayout),
                   gmma_desc(k_s + panel * T::kKVPanel + col, 16, 8 * T::kSw,
                             T::kLayout),
                   ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // Online softmax: m tracks the raw scores, p = 2^(s c - m c) with
    // c = log2(e) / sqrt(D), one FFMA and one ex2 an element. Only tiles
    // across the diagonal or Skv mask.
    const float c = p.scale_log2;
    const int kv0 = t * kBN;
    const bool masked = (p.causal && kv0 + kBN - 1 > q0) || kv0 + kBN > p.Skv;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (masked) {
          const int key = kv0 + 8 * j + 2 * tq + (e & 1);
          if (key >= p.Skv || (p.causal && key > qpos[e >> 1]))
            sc[4 * j + e] = kNegInf;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
      }
    }
    float corr[2], mc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = ex2((m[i] - mx[i]) * c);
      m[i] = mx[i];
      mc[i] = mx[i] * c;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      sc[i] = ex2(fmaf(sc[i], c, -mc[(i >> 1) & 1]));
      rs[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

    // O += P V: P rounded to bf16 as wgmma's A fragments, V transposed by
    // the descriptor (MN-major: 8-key groups kSw * 8 bytes apart, panels of
    // 64 columns kKVPanel bytes apart).
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_rs<D>(acc, pa[kk],
                  gmma_desc(v_s + kk * 16 * T::kSw, T::kKVPanel, 8 * T::kSw,
                            T::kLayout));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(bars + 8 * (1 + kStages + s));   // empty[s]
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
    bf16* op = o + b * p.os.b + qpos[i] * p.os.s + head[i] * p.os.h;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<uint32_t*>(op + 8 * j + 2 * tq) =
          pack_bf16(acc[4 * j + 2 * i] / l[i], acc[4 * j + 2 * i + 1] / l[i]);
    // lse of the scaled scores, natural units: (m c + log2 l) / log2(e), at
    // folded row qpos * G + g of this (b, hk)
    if (p.lse != nullptr && tq == 0)
      p.lse[(static_cast<long long>(blockIdx.x) * p.Sq + qpos[i]) * p.G
            + head[i] - hk * p.G] =
          fmaf(m[i], p.scale_log2, log2f(l[i])) * kLn2;
  }
}

// cuTensorMapEncodeTiled, from libcuda through the runtime's entry-point
// lookup.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr) : nullptr;
  }();
  return fn;
}

// A bf16 tensor map over (D, heads, positions, batch) with a box of
// (cols, box_heads, box_rows, 1). Returns false if the encoder refuses it.
bool make_map(CUtensorMap* map, const void* base, int D, int heads, int seq,
              int batch, const Strides& st, int cols, int box_heads,
              int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(box_heads),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int DH = D>
int run_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
             int H, const Params& p, cudaStream_t stream) {
  using T = Tile<D>;
  const CUtensorMapSwizzle swizzle =
      T::kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : T::kSw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  const int P = kBM / p.G;          // query positions a block
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, DH, H, p.Sq, B, p.qs, T::kPanelCols, p.G, P,
                swizzle)
      || !make_map(&tm_k, k, DH, p.Hk, p.Skv, B, p.ks, T::kPanelCols, 1, kBN,
                   swizzle)
      || !make_map(&tm_v, v, DH, p.Hk, p.Skv, B, p.vs, T::kPanelCols, 1, kBN,
                   swizzle))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TmaParams tp{p.Sq, p.Skv, p.Hk, p.G, P, p.causal, p.os,
                     p.scale * kLog2e, p.lse};
  const dim3 grid(B * p.Hk, (p.Sq + P - 1) / P);
  flash_bf16_kernel<D, DH><<<grid, kThreads, T::kSmem, stream>>>(
      tm_q, tm_k, tm_v, o, tp);
  return static_cast<int>(cudaGetLastError());
}

int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
           int H, int D, const Params& p, cudaStream_t stream) {
  switch (D) {
    case 16: return run_bf16<16>(q, k, v, o, B, H, p, stream);
    case 32: return run_bf16<32>(q, k, v, o, B, H, p, stream);
    case 64: return run_bf16<64>(q, k, v, o, B, H, p, stream);
    case 112: return run_bf16<128, 112>(q, k, v, o, B, H, p, stream);
    case 128: return run_bf16<128>(q, k, v, o, B, H, p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch(const float* q, const float* k, const float* v, float* o, int B,
           int, int D, const Params& p, cudaStream_t stream) {
  switch (D) {
    case 16: run_f32<16>(q, k, v, o, B, p, stream); break;
    case 32: run_f32<32>(q, k, v, o, B, p, stream); break;
    case 64: run_f32<64>(q, k, v, o, B, p, stream); break;
    case 112: run_f32<112>(q, k, v, o, B, p, stream); break;
    case 128: run_f32<128>(q, k, v, o, B, p, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points. Pointers are device pointers; strides are in elements for
// the batch, sequence and head dims of q, k, v, o (innermost stride 1); the
// caller guarantees H % Hk == 0, H / Hk <= 16, D in {16, 32, 64, 112, 128},
// 16-byte aligned rows and strides that are multiples of 8 elements (the
// TMA unit's 16 bytes). lse, when not null, receives each row's fp32
// log-sum-exp of the scaled scores (natural units) in the backward's
// folded-row layout (B, Hk, Sq * G), row pos * G + g; serving passes null
// and nothing is written. Returns cudaGetLastError() after the launch (0
// when it was accepted), or cudaErrorInvalidValue when a tensor map is
// refused.
#define FLASH_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o,   \
                      float* lse, int B, int Sq, int Skv, int H, int Hk,      \
                      int D,                                                   \
                      long long qsb, long long qss, long long qsh,            \
                      long long ksb, long long kss, long long ksh,            \
                      long long vsb, long long vss, long long vsh,            \
                      long long osb, long long oss, long long osh, int causal, \
                      void* stream) {                                          \
    const Params p{Sq, Skv, Hk, H / Hk,                                        \
                   Strides{qsb, qss, qsh}, Strides{ksb, kss, ksh},             \
                   Strides{vsb, vss, vsh}, Strides{osb, oss, osh},             \
                   causal, 1.0f / sqrtf(static_cast<float>(D)), lse};          \
    return launch(static_cast<const T*>(q), static_cast<const T*>(k),          \
                  static_cast<const T*>(v), static_cast<T*>(o), B, H, D, p,    \
                  static_cast<cudaStream_t>(stream));                          \
  }

FLASH_ENTRY(flash_attention_bf16, bf16)
FLASH_ENTRY(flash_attention_f32, float)
