// Gradient of the Mamba-2 SSD chunked scan for Hopper, sm_90a.
//
// The JAX package has no kernel for it: it takes the gradient of
// src/repro/kernels/ssd/kernel.py :: ssd_pallas's function by autodiff
// (XLA) of repro/models/ssm.py :: ssd_chunked. This is the gradient of
// csrc/ssd.cu (ssd_cuda): dx, ddt, dA, dB, dC and the incoming state's
// gradient, from x, dt, A, B, C, dy (the cotangent of y), the final
// state's cotangent (or none) and the states that enter each chunk, which
// the forward writes when asked (ssd_cuda(..., return_states=True)).
//
// For each (b, h), in the forward's chunks of kQ = 64 positions, with
// a_t = dt_t A, cum_i = sum_{t <= i} a_t inside the chunk, xdt_j = x_j dt_j,
// s the state entering the chunk and g the cotangent of the state leaving
// it, e_in_i = exp(cum_i), e_out_j = exp(cum_Q - cum_j) (cum_Q the chunk's
// last) and L_ij = exp(cum_i - cum_j) for i >= j, else 0:
//   g_prev = exp(cum_Q) g + sum_i e_in_i dy_i C_i^T        (chunks in reverse)
//   dxdt_j = sum_{i>=j} (C_i.B_j) L_ij dy_i + e_out_j g B_j
//   dC_i   = sum_{j<=i} L_ij (dy_i.xdt_j) B_j + e_in_i s^T dy_i   (per head)
//   dB_j   = sum_{i>=j} L_ij (dy_i.xdt_j) C_i + e_out_j g^T xdt_j (per head)
//   dcum_i = C_i.dC_i - B_i.dB_i  (+ exp(cum_Q) <g, s> + sum_j w_j at i = Q)
//   da_t = sum_{i>=t} dcum_i; ddt_t = A da_t + x_t.dxdt_t; dx_t = dt_t dxdt_t;
//   dA = sum_{b,t} dt_t da_t
// where w_j = e_out_j xdt_j.(g B_j) = B_j.(e_out_j g^T xdt_j). The dcum line
// is the sum of K_ij = (C_i.B_j) L_ij (dy_i.xdt_j) over j, less its sum
// over the rows that reach i, plus the carried state's terms, each written
// as a dot of B or C with its own gradient: C_i.dC_i holds sum_j K_ij and
// e_in_i dy_i.(s C_i); B_i.dB_i holds sum_k K_ki and w_i. K_ii enters both
// sides and cancels. L is formed by selecting 0 above the diagonal, never
// by a 0/1 mask: exp(cum_i - cum_j) overflows there and inf * 0 is NaN.
// A ragged tail is padded with x = dt = B = C = dy = 0, which adds nothing
// (cum stays flat past it, so cum_Q is the last real position's).
//
// Two walks; the launcher picks one. Both walk the chunks of a head in
// reverse with g carried in fp32 and hold all P rows of the head in one
// warpgroup or block: the state's rows never mix, but dB, dC, ddt and dcum
// sum over P. Both write dx in x's dtype, ddt in fp32 and dA as one fp32
// partial of the (b, h); a second launch (ssd_bwd_reduce) sums the dA
// partials over the batch, and the dB and dC partials the walk leaves,
// in a fixed order, with no atomics, so two calls give the same bits.
// Every other sum (the row dots, <g, s>, sum_j w_j, dA's, the heads' sums
// below) is taken in a fixed order too.
//
// ssd_bwd_wgmma_kernel (bf16 at mamba2's heads, P = 64 and N = 128; its
// note below gives its steps and what it rounds) runs every product of a
// chunk on wgmma, a warpgroup a head. B and C are shared by the heads (one
// group), so the walk sums dB and dC over heads on chip: one or two heads
// a block (warpgroups that share the block's B and C tiles), blocks in
// thread-block clusters of two, so up to four heads, their sum through
// shared and distributed shared memory; H / 4 fp32 partials of each leave
// the walk at the training shape (8 at H = 32), none when the cluster holds
// every head (the walk writes dB and dC in x's dtype and the second launch
// sums dA alone). The layout is the one that fits the card at once:
// clusters of eight or four heads of one block a head hold only 120 of the
// training shape's 256 heads on an H100 at a time (15 clusters of 8, 30 of
// 4: the shared memory of the block's tiles allows one block an SM), and
// 240 or 248 with two blocks an SM, so either takes two or three waves;
// two heads a block in clusters of two hold 264. One head a block is taken
// where B H blocks fit the card's SMs at once (a rank's 16 heads, batch 1),
// since a warpgroup alone on an SM walks faster than two sharing it
// (tools/ssd_bwd_phases.py reads both). ssd_bwd_kernel (fp32, and bf16 at
// other sizes) writes per-head fp32 partials of dB and dC, stages every
// operand in shared memory as fp32, rows padded to an odd length so that
// neither a row nor a column walk meets a bank conflict, and runs each
// product as IEEE FMA in 4 x 4 register tiles whose rows and columns are
// interleaved over its 256 threads (row r + R/4 ii, column c + C/4 jj).
//
// Bound on this card, at the training shape (B=8, S=512, H=32, P=64,
// N=128, bf16, dt fp32): the bytes, counted in chip_smoke.py
// (ssd_bwd_moved_bytes). The function must move x, dy and dx (16.8 MB
// each), dt and ddt (0.5 MB each), B, C, dB and dC (1 MB each): 55.6 MB,
// 0.0166 ms at 3.35 TB/s. Its products, the five Q x Q ones over the ten
// 16 x 16 blocks on or below the diagonal, are 13.96 GFLOP, 0.0141 ms at
// the bf16 tensor-core peak (the wgmma walk runs all sixteen: its m64 tile
// is the whole chunk). Both walks also read the stored chunk states
// (67 MB). The scalar walk writes and reads back H per-head partials of dB
// and dC (268 MB: 391 MB in all, 0.117 ms); the wgmma walk H / 4 of them
// (67 MB: 190 MB, 0.057 ms). Shared memory at P = 64, N = 128: the wgmma
// walk 203,328 bytes (wg_smem_bytes; one block an SM), the scalar one
// 214,016. The walk is bound by its chunk's chain of dependent steps, not
// by bytes or products: a warpgroup takes ~27,000-42,000 cycles a chunk
// (tools/ssd_bwd_phases.py), where its products (28 m64n64k16 and 20
// m64n128k16 wgmma, 8.9 MFLOP) need ~2,200 at the tensor cores' peak.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kQ = 64;           // positions per chunk (ssd.cu's kQ)
constexpr int kThreads = 256;
constexpr int kQT = kQ / 4;      // 4-row tiles along a chunk

struct Params {
  int S, H, P, N, nc;
  long long xsb, xss, xsh;       // x strides of batch, position, head
  long long dsb, dss, dsh;       // dt
  long long bsb, bss;            // B strides of batch, position
  long long csb, css;            // C
  long long gsb, gss, gsh;       // dy
  int dt_bf16;                   // dt is bf16 (else fp32)
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// Shared memory of one block, in floats.
__host__ __device__ constexpr int smem_floats(int P, int N) {
  return 2 * kQ * (P + 1)        // x, dy          (kQ, P + 1) each
         + 2 * kQ * (N + 1)      // B, C           (kQ, N + 1) each
         + 2 * P * (N + 1)       // s, g           (P, N + 1) each
         + 2 * kQ * (kQ + 1)     // CBL, DXL       (kQ, kQ + 1) each
         + (N / 4) * kQ          // row dots C.dC - B.dB, per column tile
         + (P / 4) * kQ          // row dots x.dxdt, per column tile
         + 2 * kThreads          // per-thread sum_j w_j and <g, s>
         + 4 * kQ;               // dt, cum, e_in, e_out
}

// acc[ii][jj] += sum_k a(row ii, k) b(k, col jj), each operand read at
// a[ii * ra + k * ka] and b[k * kb + jj * cb] (strides in floats).
__device__ __forceinline__ void mm(float (&acc)[4][4], const float* a,
                                   int ra, int ka, const float* b, int kb,
                                   int cb, int K) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) av[ii] = a[ii * ra + k * ka];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) bv[jj] = b[k * kb + jj * cb];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        acc[ii][jj] = fmaf(av[ii], bv[jj], acc[ii][jj]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel(const T* __restrict__ x, const void* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const T* __restrict__ dy,
               const float* __restrict__ states,
               const float* __restrict__ dstate, T* __restrict__ dx,
               float* __restrict__ ddt, float* __restrict__ dBp,
               float* __restrict__ dCp, float* __restrict__ dAp,
               float* __restrict__ dstate0, const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int P = p.P, N = p.N, S = p.S;
  const int XP = P + 1, NP = N + 1, QP = kQ + 1;
  const int PT = P / 4, NT = N / 4;   // column tiles of width P and N
  float* xs = smem;                   // xs[j * XP + p]
  float* dys = xs + kQ * XP;          // dys[i * XP + p]
  float* bs = dys + kQ * XP;          // bs[j * NP + n]
  float* cs = bs + kQ * NP;           // cs[i * NP + n]
  float* ss = cs + kQ * NP;           // ss[p * NP + n]: state entering
  float* gs = ss + P * NP;            // gs[p * NP + n]: g
  float* cbl = gs + P * NP;           // cbl[i * QP + j] = (C_i.B_j) L_ij
  float* dxl = cbl + kQ * QP;         // dxl[i * QP + j] = (dy_i.xdt_j) L_ij
  float* rdp = dxl + kQ * QP;         // rdp[tc * kQ + i]: C.dC - B.dB
  float* xdp = rdp + NT * kQ;         // xdp[tc * kQ + j]: x.dxdt
  float* red = xdp + PT * kQ;         // red[t]: w; red[kThreads + t]: <g,s>
  float* dtv = red + 2 * kThreads;    // dt
  float* cum = dtv + kQ;              // prefix sum of dt A in the chunk
  float* ein = cum + kQ;              // exp(cum)
  float* eout = ein + kQ;             // exp(cum[kQ - 1] - cum)

  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const float a = A[h];
  const T* xb = x + b * p.xsb + h * p.xsh;
  const T* gb = dy + b * p.gsb + h * p.gsh;
  const T* Bb = Bm + b * p.bsb;
  const T* Cb = Cm + b * p.csb;
  const long long dbase = b * p.dsb + h * p.dsh;
  const long long bh = static_cast<long long>(b) * p.H + h;
  T* dxb = dx + (static_cast<long long>(b) * S * p.H + h) * P;
  float* ddtb = ddt + static_cast<long long>(b) * S * p.H + h;
  float* dBb = dBp + bh * S * N;
  float* dCb = dCp + bh * S * N;

  for (int e = tid; e < P * N; e += kThreads) {
    const int pi = e / N, n = e % N;
    gs[pi * NP + n] = dstate ? dstate[bh * P * N + e] : 0.f;
  }
  float dA_acc = 0.f;                 // warp 0: sum_t dt_t da_t, per lane

  for (int c = p.nc - 1; c >= 0; --c) {
    const int s0 = c * kQ, nq = min(kQ, S - s0);
    __syncthreads();  // the previous chunk's operands and partials are read

    // The chunk's operands, fp32, zero past the tail; its scalars (warp 0:
    // two positions a lane, the forward's prefix sum).
    for (int e = tid; e < kQ * P; e += kThreads) {
      const int j = e / P, pi = e % P;
      const bool live = j < nq;
      xs[j * XP + pi] = live ? ld(xb + (s0 + j) * p.xss + pi) : 0.f;
      dys[j * XP + pi] = live ? ld(gb + (s0 + j) * p.gss + pi) : 0.f;
    }
    for (int e = tid; e < kQ * N; e += kThreads) {
      const int j = e / N, n = e % N;
      const bool live = j < nq;
      bs[j * NP + n] = live ? ld(Bb + (s0 + j) * p.bss + n) : 0.f;
      cs[j * NP + n] = live ? ld(Cb + (s0 + j) * p.css + n) : 0.f;
    }
    const float* sg = states + (bh * p.nc + c) * P * N;
    for (int e = tid; e < P * N; e += kThreads)
      ss[(e / N) * NP + e % N] = sg[e];
    if (tid < 32) {
      const int j0 = 2 * lane, j1 = j0 + 1;
      const long long o0 = dbase + (s0 + j0) * p.dss, o1 = o0 + p.dss;
      float d0, d1;
      if (p.dt_bf16) {
        const bf16* d = static_cast<const bf16*>(dt);
        d0 = j0 < nq ? __bfloat162float(d[o0]) : 0.f;
        d1 = j1 < nq ? __bfloat162float(d[o1]) : 0.f;
      } else {
        const float* d = static_cast<const float*>(dt);
        d0 = j0 < nq ? d[o0] : 0.f;
        d1 = j1 < nq ? d[o1] : 0.f;
      }
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
      dtv[j0] = d0;
      dtv[j1] = d1;
      cum[j0] = c0;
      cum[j1] = incl;
      ein[j0] = expf(c0);
      ein[j1] = expf(incl);
      eout[j0] = expf(last - c0);
      eout[j1] = expf(last - incl);
    }
    __syncthreads();
    const float total = expf(cum[kQ - 1]);

    // 1. CBL = (C B^T) o L and DXL = (dy x^T) o L o dt_j, (kQ, kQ).
    for (int t = tid; t < kQT * kQT; t += kThreads) {
      const int tc = t % kQT, tr = t / kQT;
      float cb[4][4] = {}, dd[4][4] = {};
      mm(cb, cs + tr * NP, kQT * NP, 1, bs + tc * NP, 1, kQT * NP, N);
      mm(dd, dys + tr * XP, kQT * XP, 1, xs + tc * XP, 1, kQT * XP, P);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = tr + kQT * ii;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = tc + kQT * jj;
          const bool low = i >= j;
          const float l = low ? expf(cum[i] - cum[j]) : 0.f;
          cbl[i * QP + j] = low ? cb[ii][jj] * l : 0.f;
          dxl[i * QP + j] = low ? dd[ii][jj] * dtv[j] * l : 0.f;
        }
      }
    }
    __syncthreads();

    // 2a. dxdt (kQ, P) = CBL^T dy + e_out o (B g^T); dx = dt dxdt and the
    //     row dots x.dxdt of this thread's columns.
    for (int t = tid; t < kQT * PT; t += kThreads) {
      const int tc = t % PT, tr = t / PT;
      float in[4][4] = {}, ex[4][4] = {};
      mm(in, cbl + tr, kQT, QP, dys + tc, XP, PT, kQ);
      mm(ex, bs + tr * NP, kQT * NP, 1, gs + tc * NP, 1, PT * NP, N);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int j = tr + kQT * ii;
        float dot = 0.f;
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          const int pi = tc + PT * pp;
          const float v = fmaf(eout[j], ex[ii][pp], in[ii][pp]);
          dot = fmaf(xs[j * XP + pi], v, dot);
          if (j < nq)
            put(dxb + (static_cast<long long>(s0 + j) * p.H) * P + pi,
                dtv[j] * v);
        }
        xdp[tc * kQ + j] = dot;
      }
    }

    // 2b. dC (kQ, N) = DXL B + e_in o (dy s) and dB (kQ, N) = DXL^T C +
    //     e_out dt o (x g), this head's partials; the row dots C.dC - B.dB
    //     and this thread's share of sum_j w_j.
    float wsum = 0.f;
    for (int t = tid; t < kQT * NT; t += kThreads) {
      const int tc = t % NT, tr = t / NT;
      float rd[4] = {};
      {
        float in[4][4] = {}, ex[4][4] = {};
        mm(in, dxl + tr * QP, kQT * QP, 1, bs + tc, NP, NT, kQ);
        mm(ex, dys + tr * XP, kQT * XP, 1, ss + tc, NP, NT, P);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int i = tr + kQT * ii;
#pragma unroll
          for (int nn = 0; nn < 4; ++nn) {
            const int n = tc + NT * nn;
            const float v = fmaf(ein[i], ex[ii][nn], in[ii][nn]);
            rd[ii] = fmaf(cs[i * NP + n], v, rd[ii]);
            if (i < nq) dCb[static_cast<long long>(s0 + i) * N + n] = v;
          }
        }
      }
      {
        float in[4][4] = {}, ex[4][4] = {};
        mm(in, dxl + tr, kQT, QP, cs + tc, NP, NT, kQ);
        mm(ex, xs + tr * XP, kQT * XP, 1, gs + tc, NP, NT, P);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int j = tr + kQT * ii;
          const float sc = eout[j] * dtv[j];
#pragma unroll
          for (int nn = 0; nn < 4; ++nn) {
            const int n = tc + NT * nn;
            const float e = sc * ex[ii][nn];
            const float v = in[ii][nn] + e;
            const float bv = bs[j * NP + n];
            rd[ii] = fmaf(-bv, v, rd[ii]);
            wsum = fmaf(bv, e, wsum);
            if (j < nq) dBb[static_cast<long long>(s0 + j) * N + n] = v;
          }
          rdp[tc * kQ + j] = rd[ii];
        }
      }
    }
    red[tid] = wsum;
    __syncthreads();  // 2a and 2b read g, which 3 overwrites

    // 3. <g, s> (this thread's share), then g = exp(cum_Q) g +
    //    (e_in o dy)^T C, in place: each element is one thread's.
    float gsum = 0.f;
    for (int t = tid; t < PT * NT; t += kThreads) {
      const int tc = t % NT, tr = t / NT;
      float acc[4][4] = {};
#pragma unroll 4
      for (int i = 0; i < kQ; ++i) {
        const float e = ein[i];
        float av[4], bv[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) av[ii] = dys[i * XP + tr + PT * ii] * e;
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) bv[nn] = cs[i * NP + tc + NT * nn];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int nn = 0; nn < 4; ++nn)
            acc[ii][nn] = fmaf(av[ii], bv[nn], acc[ii][nn]);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          const int o = (tr + PT * ii) * NP + tc + NT * nn;
          const float g = gs[o];
          gsum = fmaf(g, ss[o], gsum);
          gs[o] = fmaf(total, g, acc[ii][nn]);
        }
    }
    red[kThreads + tid] = gsum;
    __syncthreads();

    // 4. (warp 0) dcum, its suffix sum da, ddt and dA, two positions a lane.
    if (tid < 32) {
      float w = 0.f, gsv = 0.f;
      for (int k = lane; k < kThreads; k += 32) {
        w += red[k];
        gsv += red[kThreads + k];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        w += __shfl_xor_sync(0xffffffffu, w, off);
        gsv += __shfl_xor_sync(0xffffffffu, gsv, off);
      }
      const int j0 = 2 * lane, j1 = j0 + 1;
      float d0 = 0.f, d1 = 0.f, x0 = 0.f, x1 = 0.f;
      for (int tc = 0; tc < NT; ++tc) {
        d0 += rdp[tc * kQ + j0];
        d1 += rdp[tc * kQ + j1];
      }
      for (int tc = 0; tc < PT; ++tc) {
        x0 += xdp[tc * kQ + j0];
        x1 += xdp[tc * kQ + j1];
      }
      if (lane == 31) d1 += fmaf(total, gsv, w);
      // suffix sums over the lanes after this one, then this pair's
      float incl = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += v;
      }
      float after = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) after = 0.f;
      const float da1 = d1 + after, da0 = d0 + da1;
      if (j0 < nq) ddtb[static_cast<long long>(s0 + j0) * p.H] =
          fmaf(a, da0, x0);
      if (j1 < nq) ddtb[static_cast<long long>(s0 + j1) * p.H] =
          fmaf(a, da1, x1);
      dA_acc = fmaf(dtv[j0], da0, dA_acc);
      dA_acc = fmaf(dtv[j1], da1, dA_acc);
    }
  }

  if (tid < 32) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dA_acc += __shfl_xor_sync(0xffffffffu, dA_acc, off);
    if (lane == 0) dAp[bh] = dA_acc;
  }
  if (dstate0) {
    __syncthreads();
    for (int e = tid; e < P * N; e += kThreads)
      dstate0[bh * P * N + e] = gs[(e / N) * NP + e % N];
  }
}

// dB = sum_q dBp, dC = sum_q dCp ((B, S, N) from the walk's `parts`
// partials a batch row, (B, parts, S, N)), q in order; none when parts is
// 0 (the walk wrote dB and dC). dA = sum_b dAp ((H,) from (B, H)), b in
// order (block 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce(const float* __restrict__ dBp, const float* __restrict__ dCp,
               const float* __restrict__ dAp, T* __restrict__ dB,
               T* __restrict__ dC, float* __restrict__ dA, int batch, int H,
               int parts, long long SN) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (parts > 0 && e < batch * SN) {
    const long long b = e / SN, sn = e % SN;
    const float* pb = dBp + b * parts * SN + sn;
    const float* pc = dCp + b * parts * SN + sn;
    float sb = 0.f, sc = 0.f;
    for (int q = 0; q < parts; ++q) {
      sb += pb[q * SN];
      sc += pc[q * SN];
    }
    put(dB + e, sb);
    put(dC + e, sc);
  }
  if (blockIdx.x == 0) {
    for (int h = threadIdx.x; h < H; h += kThreads) {
      float s = 0.f;
      for (int b = 0; b < batch; ++b) s += dAp[b * H + h];
      dA[h] = s;
    }
  }
}

// ------------------------------------------ bf16: wgmma, a cluster of heads
constexpr int kWg = 128;          // one warpgroup: four warps
constexpr int kPanel = kQ * 128;  // bytes of a swizzled 64-row panel
constexpr float kLog2e = 1.4426950408889634f;

// The wgmma walk's layout at batch x H heads on a card of `sms` SMs: one
// head a block when the batch's B H blocks fit the card at once (one a
// SM), else two (H even); blocks in clusters of two when that divides the
// heads' blocks of a batch row. A cluster sums the dB and dC of its
// heads_a_block x cluster_blocks heads on chip.
__host__ __device__ constexpr int heads_a_block(int batch, int H, int sms) {
  return H % 2 == 0 && batch * H > sms ? 2 : 1;
}
__host__ __device__ constexpr int cluster_blocks(int batch, int H, int sms) {
  return (H / heads_a_block(batch, H, sms)) % 2 == 0 ? 2 : 1;
}
__host__ __device__ constexpr int cluster_size(int batch, int H, int sms) {
  return heads_a_block(batch, H, sms) * cluster_blocks(batch, H, sms);
}
int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Shared memory of one block of the wgmma walk, in bytes: 1024 of alignment
// slack; the B and C tiles (kQ x N, bf16) and each head's x, dy (kQ x P),
// g and s (P x N) tiles; the stages of dC (fp32, kQ x N, over the two s
// tiles) and dB, and the receive buffer of the other block's rows (2 x
// kQ / 2 x N); each head's dt, cum, e_in, e_out, two row dots, K's row
// sums by warp, its column sums and the warps' w and <g, s>.
__host__ __device__ constexpr int wg_smem_bytes(int P, int N) {
  return 1024 + 2 * kQ * N * 2 + 2 * 2 * kQ * P * 2 + 2 * 2 * P * N * 2
         + 2 * kQ * N * 4 + 2 * 4 * (11 * kQ + 8);
}
static_assert(2 * 64 * 128 * 2 == kQ * 128 * 4,
              "dC's stage covers the two s tiles");

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// Named barrier `id` over n threads: bar_arrive signals it, bar_sync waits.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
// cp.async and st.shared write shared memory through the generic proxy,
// wgmma reads it through the async proxy: the writers fence before the
// barrier that precedes the products.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The swizzle repeats every 1024 bytes: tiles start on that boundary.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

// Byte offset of 16-byte chunk `ch` (columns 8 ch .. 8 ch + 7) of row r of
// a 64-row bf16 tile stored as the TMA unit's 128-byte swizzle lays it out
// (wgmma.cuh's Swizzle): panels of 64 columns, kPanel bytes apart.
__device__ __forceinline__ uint32_t sw(int r, int ch) {
  return hopper::Swizzle<128>::chunk(kQ, r, ch);
}
// The bf16 pair at (r, c), c even.
__device__ __forceinline__ uint32_t* pair_at(unsigned char* t, int r, int c) {
  return reinterpret_cast<uint32_t*>(t + sw(r, c >> 3) + (c & 7) * 2);
}
__device__ __forceinline__ float2 pair(const unsigned char* t, int r,
                                       int c) {
  return unpack2(*reinterpret_cast<const uint32_t*>(
      t + sw(r, c >> 3) + (c & 7) * 2));
}

// d (64 x 64) = A (64 x K) . B (64 x K)^T, both swizzled tiles read K-major:
// K / 16 wgmma k16 steps (the caller fences and commits).
template <int K>
__device__ __forceinline__ void wg_nt(float (&d)[32], uint32_t a,
                                      uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    const uint32_t off = (ks / 4) * kPanel + (ks % 4) * 32;
    hopper::wgmma_ss_n64(d, hopper::gmma_desc(a + off, 16, 1024, 1),
                         hopper::gmma_desc(b + off, 16, 1024, 1), ks > 0);
  }
}

// d (64 x W) += X (64 x 64: the bf16 A fragments of four k16 steps, in
// registers) . B (a swizzled 64 x W tile read along its rows: the
// descriptor transposes it, 8-row groups 1024 bytes apart, panels kPanel).
template <int W>
__device__ __forceinline__ void wg_rs(float (&d)[W / 2],
                                      const uint32_t (&x)[4][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::wgmma_rs<W>(d, x[kk], hopper::gmma_desc(b + kk * 16 * 128,
                                                    kPanel, 1024, 1));
}

// The A fragments of the warp's 16 rows over four k16 steps, from a
// swizzled 64 x 64 tile stored [row][k] (frags_mk) or [k][row] (frags_km,
// transposed loads): element for element the m16n8k16 A fragments; w is
// the warp in its warpgroup.
__device__ __forceinline__ void frags_mk(uint32_t (&f)[4][4],
                                         const unsigned char* t) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int r = 16 * w + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4(f[kk], reinterpret_cast<const bf16*>(
                       t + sw(r, 2 * kk + (lane >> 4))));
}
__device__ __forceinline__ void frags_km(uint32_t (&f)[4][4],
                                         const unsigned char* t) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4_trans(f[kk], reinterpret_cast<const bf16*>(
                             t + sw(16 * kk + (lane & 7) + ((lane >> 4) << 3),
                                    2 * w + ((lane >> 3) & 1))));
}

// Accumulator columns 8 t .. 8 t + 7 (v: rows gr, gr + 8) into the A
// fragments of the next product: columns 16 kk .. 16 kk + 15 are k16 step
// kk.
__device__ __forceinline__ void pack_cols(uint32_t (&x)[4][4], int t,
                                          const float (&v)[4]) {
  x[t / 2][2 * (t & 1)] = pack(v[0], v[1]);
  x[t / 2][2 * (t & 1) + 1] = pack(v[2], v[3]);
}

__device__ __forceinline__ uint32_t scale2(uint32_t u, float e0, float e1) {
  const float2 v = unpack2(u);
  return pack(v.x * e0, v.y * e1);
}

// The same function as ssd_bwd_kernel at P = 64, N = 128 in bf16. A block
// walks two heads of one batch row (one warpgroup each; one head when H is
// odd), which share its B and C tiles; a cluster of two blocks holds four
// heads, whose dB and dC it sums on chip. A wgmma accumulator holds 64
// rows, warp w of a warpgroup rows 16 w + gr and 16 w + gr + 8 (element i:
// column 8 (i / 4) + 2 tq + i % 2, the second row when i % 4 >= 2): the
// chunk's positions, or the state's P rows for g, which stays in registers
// as fp32 for the whole walk. Shared tiles are 64 rows in the 128-byte
// swizzle; x, dy, B and C arrive by cp.async, issued as soon as the last
// chunk's products are done, from L2, where the chunk before prefetched
// them with the stored state s, which is read from there into its bf16
// tile. Operands enter the products as bf16: x, dy, B and C exactly, s, g,
// (C B^T) o L, (dy x^T) o L dt and e_in dy rounded once; every product
// sums in fp32. The rounding reaches each gradient at ~0.3% of its norm
// (tools/ssd_bwd_tolerance.py emulates it). dcum takes its sums of K from
// fp32 products, not from the rounded CBL and DXL: dcum_i = sum_j K_ij -
// sum_k K_ki + C_i.dC'_i - B_i.dB'_i, with dC'_i = e_in_i s^T dy_i and
// dB'_j = e_out_j g^T xdt_j the carried-state parts (dA sums dt da over
// B S positions whose terms cancel, and the rounded products would cost it
// ~1% of its norm with a random state). Per chunk, each warpgroup for its
// head:
//   0. s's bf16 tile and <g, s> against the fp32 s (one head a block:
//      from a stage its copies fill; two: from L2); the scalars (its warp
//      0, two positions a lane, the forward's prefix sum);
//   1. rows j: B C^T, x dy^T and B g^T over all 64 x 64 (wgmma's tile is
//      the chunk); (C B^T o L)^T and (dy x^T o L dt)^T as register A
//      fragments, K's row and column sums (L is selected, so the blocks
//      above the diagonal are exact zeros); dxdt = e_out o (B g^T) +
//      (CBL)^T dy, dx and x.dxdt;
//   2. rows i: dy x^T and DXL; dC = e_in o (dy s) + DXL B, C_i.dC'_i;
//   3. rows j: dB = e_out dt o (x g) + (DXL)^T C, w and B_j.dB'_j;
//   4. g = exp(cum_Q) g + (e_in o dy)^T C; then (the tiles are free) the
//      next chunk's copies; dcum, da, ddt, dA (its warp 0); g's tile;
//   5. the block's rows of the cluster's sums, below, written out: fp32
//      partials of the four heads, or dB and dC in bf16 when they are all
//      the heads.
// The sums over the heads, in a fixed order: the block's pair first (head
// 2 k, then 2 k + 1: warpgroup 1 hands its dC to warpgroup 0 through
// shared memory, warpgroup 0 its dB to warpgroup 1), then the two blocks'
// pairs, rank 0's first. Block r of the cluster owns rows 32 r .. 32 r + 31
// of the chunk: the warpgroup that sums a pair keeps the block's own rows
// and pushes the others, in fp32, into the other block's receive buffer.
template <int P, int N>
__global__ void __launch_bounds__(2 * kWg, 1)
ssd_bwd_wgmma_kernel(const bf16* __restrict__ x, const void* __restrict__ dt,
                     const float* __restrict__ A,
                     const bf16* __restrict__ Bm,
                     const bf16* __restrict__ Cm,
                     const bf16* __restrict__ dy,
                     const float* __restrict__ states,
                     const float* __restrict__ dstate,
                     bf16* __restrict__ dx, float* __restrict__ ddt,
                     bf16* __restrict__ dB, bf16* __restrict__ dC,
                     float* __restrict__ dBp, float* __restrict__ dCp,
                     float* __restrict__ dAp, float* __restrict__ dstate0,
                     const Params p) {
  static_assert(P == 64 && N == 128, "built for mamba2's heads");
  constexpr int kX = kQ * P * 2, kB = kQ * N * 2;      // tile bytes
  constexpr int kAll = 2 * kWg;
  constexpr int kOwn = kQ / 2;                         // rows a block sums
  extern __shared__ unsigned char smem_raw[];
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int wg = w >> 2, wl = w & 3;   // warpgroup, warp in it
  const int gr = lane >> 2, tq = lane & 3;
  const int jA = 16 * wl + gr, jB = jA + 8;    // accumulator rows
  const int hb = blockDim.x / kWg;             // heads a block: 1 or 2
  const int csz = static_cast<int>(cl.num_blocks());   // 1 or 2
  const int rank = static_cast<int>(cl.block_rank());
  const int S = p.S, H = p.H, groups = H / hb;
  const int b = blockIdx.x / groups, h = (blockIdx.x % groups) * hb + wg;
  const int parts = H / (hb * csz);            // partials a batch row
  const int part = (blockIdx.x % groups) / csz;

  unsigned char* bs = align1024(smem_raw);             // B, C: shared
  unsigned char* cs = bs + kB;
  unsigned char* xs = cs + kB + wg * 2 * kX;           // this head's x, dy
  unsigned char* dys = xs + kX;
  unsigned char* gs = cs + kB + 4 * kX + wg * P * N * 2;   // g, bf16
  unsigned char* s16 = cs + kB + 4 * kX + 2 * P * N * 2 + wg * P * N * 2;
  float* sc = reinterpret_cast<float*>(cs + kB + 4 * kX + 2 * P * N * 2);
                                       // dC [kQ][N], over both s tiles
  float* sb = sc + kQ * N;             // dB [kQ][N]
  float* recv = sb + kQ * N;           // [2][kOwn][N]: the other block's
  // one head a block: its entering state, fp32, rows 0-31 over the second
  // warpgroup's x and dy tiles and rows 32-63 over its g tile
  float* stA = reinterpret_cast<float*>(cs + kB + 2 * kX);
  float* stB = reinterpret_cast<float*>(cs + kB + 4 * kX + P * N * 2);
  float* small = recv + 2 * kOwn * N + wg * (11 * kQ + 8);
  float* dtv = small;                  // this head's scalars and sums
  float* cum = dtv + kQ;
  float* ein = cum + kQ;
  float* eout = ein + kQ;
  float* rd = eout + kQ;               // the carried terms
  float* xd = rd + kQ;                 // x.dxdt
  float* krow = xd + kQ;               // [warp][i]: K rows
  float* kcol = krow + 4 * kQ;         // K columns
  float* red = kcol + kQ;              // w, <g, s>, a warp
  const uint32_t xs_u = hopper::smem_u32(xs), dys_u = xs_u + kX,
                 bs_u = hopper::smem_u32(bs), cs_u = bs_u + kB,
                 gs_u = hopper::smem_u32(gs), s16_u = hopper::smem_u32(s16);

  const float a = A[h];
  const bf16* xb = x + b * p.xsb + h * p.xsh;
  const bf16* gb = dy + b * p.gsb + h * p.gsh;
  const bf16* Bb = Bm + b * p.bsb;
  const bf16* Cb = Cm + b * p.csb;
  const long long dbase = b * p.dsb + h * p.dsh;
  const long long bh = static_cast<long long>(b) * H + h;
  bf16* dxb = dx + (static_cast<long long>(b) * S * H + h) * P;
  float* ddtb = ddt + static_cast<long long>(b) * S * H + h;

  // an fp32 [rows][N] stage's element (r, n), its 8-column groups rotated
  // by the row so that a warp's float2 and float4 accesses meet no conflict
  auto at = [](float* t, int r, int n) {
    return t + r * N + (n ^ ((r & 3) << 3));
  };
  // chunk c's x, dy (each warpgroup its head's), B, C and, one head a
  // block, its entering state, 16 bytes a copy, zeros past the tail, one
  // group
  auto load = [&](int c) {
    const int s0 = c * kQ, nq = min(kQ, S - s0);
    const int t = tid % kWg;
    for (int e = t; e < kQ * (P / 8); e += kWg) {
      const int j = e / (P / 8), q = e % (P / 8);
      const bool live = j < nq;
      const long long s = live ? s0 + j : 0;
      cp_async16(xs + sw(j, q), xb + s * p.xss + 8 * q, live);
      cp_async16(dys + sw(j, q), gb + s * p.gss + 8 * q, live);
    }
    for (int e = tid; e < kQ * (N / 8); e += hb * kWg) {
      const int j = e / (N / 8), q = e % (N / 8);
      const bool live = j < nq;
      const long long s = live ? s0 + j : 0;
      cp_async16(bs + sw(j, q), Bb + s * p.bss + 8 * q, live);
      cp_async16(cs + sw(j, q), Cb + s * p.css + 8 * q, live);
    }
    if (hb == 1) {
      const float* sg = states + (bh * p.nc + c) * P * N;
      for (int e = tid; e < P * N / 4; e += kWg) {
        const int r = e / (N / 4), n = 4 * (e % (N / 4));
        cp_async16(at(r < kOwn ? stA : stB, r % kOwn, n), sg + r * N + n,
                   true);
      }
    }
    cp_async_commit();
  };
  // chunk c's x, dy rows (128 bytes), B, C rows (256; warpgroup 0) and,
  // two heads a block, each one's entering state (32 KB) into L2, a
  // 128-byte line a step
  auto prefetch = [&](int c) {
    const int s0 = c * kQ, nq = min(kQ, S - s0), t = tid % kWg;
    auto line = [](const void* q) {
      asm volatile("prefetch.global.L2 [%0];\n" :: "l"(q));
    };
    if (t < kQ && t < nq) {
      const long long s = s0 + t;
      line(xb + s * p.xss);
      line(gb + s * p.gss);
      if (wg == 0) {
        line(Bb + s * p.bss);
        line(Bb + s * p.bss + 64);
        line(Cb + s * p.css);
        line(Cb + s * p.css + 64);
      }
    }
    if (hb == 2) {
      const char* sg = reinterpret_cast<const char*>(
          states + (bh * p.nc + c) * P * N);
      for (int o = t * 128; o < P * N * 4; o += kWg * 128) line(sg + o);
    }
  };
  // warp 0 of the warpgroup: dt at positions 2 lane, 2 lane + 1 of chunk c
  float dn0 = 0.f, dn1 = 0.f;
  auto load_dt = [&](int c) {
    const int s0 = c * kQ, nq = min(kQ, S - s0);
    const int j0 = 2 * lane, j1 = j0 + 1;
    const long long o0 = dbase + (s0 + j0) * p.dss, o1 = o0 + p.dss;
    if (p.dt_bf16) {
      const bf16* d = static_cast<const bf16*>(dt);
      dn0 = j0 < nq ? __bfloat162float(d[o0]) : 0.f;
      dn1 = j1 < nq ? __bfloat162float(d[o1]) : 0.f;
    } else {
      const float* d = static_cast<const float*>(dt);
      dn0 = j0 < nq ? d[o0] : 0.f;
      dn1 = j1 < nq ? d[o1] : 0.f;
    }
  };
  // a (64 x N) accumulator into a bf16 tile
  auto store_tile = [&](unsigned char* t, const float (&v)[N / 2]) {
#pragma unroll
    for (int c8 = 0; c8 < N / 8; ++c8)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *pair_at(t, half ? jB : jA, 8 * c8 + 2 * tq) =
            pack(v[4 * c8 + 2 * half], v[4 * c8 + 2 * half + 1]);
  };
  // a (64 x N) accumulator into an fp32 stage
  auto stage = [&](float* t, const float (&v)[N / 2]) {
#pragma unroll
    for (int c8 = 0; c8 < N / 8; ++c8)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(at(t, half ? jB : jA, 8 * c8 + 2 * tq)) =
            make_float2(v[4 * c8 + 2 * half], v[4 * c8 + 2 * half + 1]);
  };
  // the block's pair sum of matrix m (0 dC, 1 dB): `first` (registers of
  // the head that comes first, or the stage t holding it) plus the other;
  // the block's own rows into t, the others pushed to the other block
  auto pair_sum = [&](int m, float* t, const float (&v)[N / 2], bool mine) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? jB : jA;
      const bool own = csz == 1 || r / kOwn == rank;
      float* to = own ? nullptr : cl.map_shared_rank(
          recv + (m * kOwn + r % kOwn) * N, r / kOwn);
#pragma unroll
      for (int c8 = 0; c8 < N / 8; ++c8) {
        const int n = 8 * c8 + 2 * tq;
        float2* src = reinterpret_cast<float2*>(at(t, r, n));
        float2 s = make_float2(v[4 * c8 + 2 * half],
                               v[4 * c8 + 2 * half + 1]);
        if (hb == 2) {                 // head 2 k first
          const float2 o = *src;
          s = mine ? make_float2(s.x + o.x, s.y + o.y)
                   : make_float2(o.x + s.x, o.y + s.y);
        }
        if (own)
          *src = s;
        else
          *reinterpret_cast<float2*>(to + (n ^ ((r & 3) << 3))) = s;
      }
    }
  };

  float G[N / 2];                     // g's rows jA, jB (state rows)
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i & 2) ? jB : jA, n = 8 * (i / 4) + 2 * tq + (i & 1);
    G[i] = dstate != nullptr ? dstate[bh * P * N + r * N + n] : 0.f;
  }
  store_tile(gs, G);
  load(p.nc - 1);
  if (p.nc > 1) prefetch(p.nc - 2);
  if (wl == 0) load_dt(p.nc - 1);
  cluster_arrive();                   // pairs with the first chunk's wait
  float dA_acc = 0.f;                 // warp 0 of the warpgroup

  for (int c = p.nc - 1; c >= 0; --c) {
    const int s0 = c * kQ, nq = min(kQ, S - s0);

    // 0. s's tile and <g, s> (two heads a block: s from L2 while the
    //    copies land; one: from its stage, once they have); the scalars;
    //    the next chunk's dt in flight
    float gsum = 0.f;
    auto convert = [&](auto state) {
#pragma unroll
      for (int c8 = 0; c8 < N / 8; ++c8)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = half ? jB : jA, n = 8 * c8 + 2 * tq;
          const float2 sv = state(r, n);
          gsum = fmaf(G[4 * c8 + 2 * half], sv.x,
                      fmaf(G[4 * c8 + 2 * half + 1], sv.y, gsum));
          *pair_at(s16, r, n) = pack(sv.x, sv.y);
        }
    };
    if (hb == 2) {
      const float* sg = states + (bh * p.nc + c) * P * N;
      convert([&](int r, int n) {
        return *reinterpret_cast<const float2*>(sg + r * N + n);
      });
    }
    if (wl == 0) {
      const int j0 = 2 * lane, j1 = j0 + 1;
      const float l0 = dn0 * a, l1 = dn1 * a;
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
      dtv[j0] = dn0;
      dtv[j1] = dn1;
      cum[j0] = c0;
      cum[j1] = incl;
      ein[j0] = expf(c0);
      ein[j1] = expf(incl);
      eout[j0] = expf(last - c0);
      eout[j1] = expf(last - incl);
      if (c > 0) load_dt(c - 1);
    }
    cp_async_wait_all();              // this chunk's copies have landed
    fence_async_smem();
    cluster_wait();    // the other block has summed what this one pushed
    __syncthreads();
    if (hb == 1) {
      convert([&](int r, int n) {
        return *reinterpret_cast<const float2*>(
            at(r < kOwn ? stA : stB, r % kOwn, n));
      });
      fence_async_smem();
      __syncthreads();
    }
    const float total = expf(cum[kQ - 1]);

    // 1. rows j: B C^T, x dy^T, B g^T; (C B^T o L)^T and (dy x^T o L dt)^T
    //    rounded into A fragments; K = (C B^T) o L o (dy x^T) dt_j summed
    //    along both axes in fp32; dxdt = e_out o (B g^T) + (CBL)^T dy
    uint32_t cblf[4][4], dxlf[4][4];
    {
      float cb[32], dd[32], acc[32];
      hopper::wgmma_fence();
      wg_nt<N>(cb, bs_u, cs_u);
      wg_nt<P>(dd, xs_u, dys_u);
      wg_nt<N>(acc, bs_u, gs_u);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(cb);
      hopper::fence_regs(dd);
      hopper::fence_regs(acc);
      const float dtA = dtv[jA], dtB = dtv[jB], cA = cum[jA], cB = cum[jB];
      float kc[2] = {0.f, 0.f}, kr[16];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        float vc[4], vx[4];
        const float2 ci = *reinterpret_cast<const float2*>(cum + 8 * t
                                                           + 2 * tq);
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const int half = e4 >> 1, i = 8 * t + 2 * tq + (e4 & 1);
          const int j = half ? jB : jA;
          const float l = i >= j ? hopper::ex2(((e4 & 1 ? ci.y : ci.x)
                                                - (half ? cB : cA)) * kLog2e)
                                 : 0.f;
          const float xv = dd[4 * t + e4] * (half ? dtB : dtA);
          vc[e4] = cb[4 * t + e4] * l;
          vx[e4] = xv * l;
          const float k = vc[e4] * xv;
          kc[half] += k;
          if (half == 0) kr[2 * t + (e4 & 1)] = k;
          else kr[2 * t + (e4 & 1)] += k;
        }
        pack_cols(cblf, t, vc);
        pack_cols(dxlf, t, vx);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        kc[half] += __shfl_xor_sync(0xffffffffu, kc[half], 1);
        kc[half] += __shfl_xor_sync(0xffffffffu, kc[half], 2);
      }
      if (tq == 0) {
        kcol[jA] = kc[0];
        kcol[jB] = kc[1];
      }
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        kr[q] += __shfl_xor_sync(0xffffffffu, kr[q], 4);
        kr[q] += __shfl_xor_sync(0xffffffffu, kr[q], 8);
        kr[q] += __shfl_xor_sync(0xffffffffu, kr[q], 16);
      }
      if (gr == 0)
#pragma unroll
        for (int q = 0; q < 16; ++q)
          krow[wl * kQ + 8 * (q / 2) + 2 * tq + (q & 1)] = kr[q];

      const float eA = eout[jA], eB = eout[jB];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= (i & 2) ? eB : eA;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      wg_rs<P>(acc, cblf, dys_u);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(acc);
      float dot[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < P / 8; ++t)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = half ? jB : jA, pc = 8 * t + 2 * tq;
          const float v0 = acc[4 * t + 2 * half],
                      v1 = acc[4 * t + 2 * half + 1];
          const float2 xv = pair(xs, j, pc);
          dot[half] = fmaf(xv.x, v0, fmaf(xv.y, v1, dot[half]));
          if (j < nq)
            *reinterpret_cast<uint32_t*>(
                dxb + static_cast<long long>(s0 + j) * H * P + pc) =
                pack(dtv[j] * v0, dtv[j] * v1);
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        dot[half] += __shfl_xor_sync(0xffffffffu, dot[half], 1);
        dot[half] += __shfl_xor_sync(0xffffffffu, dot[half], 2);
      }
      if (tq == 0) {
        xd[jA] = dot[0];
        xd[jB] = dot[1];
      }
    }

    // 2. rows i: dy x^T, DXL = (dy x^T) o L dt rounded into A fragments;
    //    dC (rows i, N columns) = e_in o (dy s) + DXL B; C_i.dC'_i. The
    //    pair's sum: warpgroup 1 stages its dC over the s tiles, which
    //    both have read; warpgroup 0 adds its own to it
    float rdv[2] = {0.f, 0.f};
    {
      uint32_t xl[4][4], f[4][4];
      frags_mk(f, dys);
      float acc[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      {
        float dd[32];
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
        wg_nt<P>(dd, dys_u, xs_u);
        wg_rs<N>(acc, f, s16_u);
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        hopper::fence_regs(dd);
        hopper::fence_regs(acc);
        const float cA = cum[jA], cB = cum[jB];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          float vx[4];
          const float2 cj = *reinterpret_cast<const float2*>(cum + 8 * t
                                                             + 2 * tq);
          const float2 dj = *reinterpret_cast<const float2*>(dtv + 8 * t
                                                             + 2 * tq);
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) {
            const int half = e4 >> 1, j = 8 * t + 2 * tq + (e4 & 1);
            const int i = half ? jB : jA;
            const float l = i >= j ? hopper::ex2(((half ? cB : cA)
                                                  - (e4 & 1 ? cj.y : cj.x))
                                                 * kLog2e)
                                   : 0.f;
            vx[e4] = dd[4 * t + e4] * (e4 & 1 ? dj.y : dj.x) * l;
          }
          pack_cols(xl, t, vx);
        }
      }
      const float eA = ein[jA], eB = ein[jB];
#pragma unroll
      for (int t = 0; t < N / 8; ++t)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = half ? jB : jA;
          const float e = half ? eB : eA;
          float& v0 = acc[4 * t + 2 * half];
          float& v1 = acc[4 * t + 2 * half + 1];
          v0 *= e;
          v1 *= e;
          const float2 cv = pair(cs, i, 8 * t + 2 * tq);
          rdv[half] = fmaf(cv.x, v0, fmaf(cv.y, v1, rdv[half]));
        }
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      wg_rs<N>(acc, xl, bs_u);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(acc);
      if (hb == 2) bar_sync(1, kAll);   // both s tiles are read
      if (wg == 1) {
        stage(sc, acc);
        bar_arrive(2, kAll);
      } else {
        if (hb == 2) bar_sync(2, kAll);
        pair_sum(0, sc, acc, true);
      }
    }

    // 3. rows j: dB (N columns) = e_out dt o (x g) + (DXL)^T C; w_j and
    //    B_j.dB'_j. The pair's sum: warpgroup 0 stages its dB, warpgroup 1
    //    adds its own to it
    float wsum = 0.f;
    {
      uint32_t f[4][4];
      frags_mk(f, xs);
      float acc[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      wg_rs<N>(acc, f, gs_u);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(acc);
      const float sA = eout[jA] * dtv[jA], sB = eout[jB] * dtv[jB];
#pragma unroll
      for (int t = 0; t < N / 8; ++t)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = half ? jB : jA;
          const float s = half ? sB : sA;
          float& v0 = acc[4 * t + 2 * half];
          float& v1 = acc[4 * t + 2 * half + 1];
          v0 *= s;
          v1 *= s;
          const float2 bv = pair(bs, j, 8 * t + 2 * tq);
          const float wv = fmaf(bv.x, v0, bv.y * v1);
          wsum += wv;                                  // w_j
          rdv[half] -= wv;
        }
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      wg_rs<N>(acc, dxlf, cs_u);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(acc);
      if (hb == 1) {
        pair_sum(1, sb, acc, true);
      } else if (wg == 0) {
        stage(sb, acc);
        bar_arrive(3, kAll);
      } else {
        bar_sync(3, kAll);
        pair_sum(1, sb, acc, false);
      }
    }

    // 4. the state's rows: g = exp(cum_Q) g + (e_in o dy)^T C
    {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) G[i] *= total;
      uint32_t f[4][4];
      frags_km(f, dys);               // A (p, i) = dy[i][p]
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int i0 = 16 * kk + 2 * tq;
        f[kk][0] = scale2(f[kk][0], ein[i0], ein[i0 + 1]);
        f[kk][1] = scale2(f[kk][1], ein[i0], ein[i0 + 1]);
        f[kk][2] = scale2(f[kk][2], ein[i0 + 8], ein[i0 + 9]);
        f[kk][3] = scale2(f[kk][3], ein[i0 + 8], ein[i0 + 9]);
      }
      hopper::fence_regs(G);
      hopper::wgmma_fence();
      wg_rs<N>(G, f, cs_u);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(G);
    }
    cluster_arrive();                 // this block's pushes are done
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      rdv[half] += __shfl_xor_sync(0xffffffffu, rdv[half], 1);
      rdv[half] += __shfl_xor_sync(0xffffffffu, rdv[half], 2);
    }
    if (tq == 0) {
      rd[jA] = rdv[0];
      rd[jB] = rdv[1];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      wsum += __shfl_xor_sync(0xffffffffu, wsum, off);
      gsum += __shfl_xor_sync(0xffffffffu, gsum, off);
    }
    if (lane == 0) {
      red[wl] = wsum;
      red[4 + wl] = gsum;
    }
    __syncthreads();   // the tiles are read; the row dots are complete
    if (c > 0) {       // the next chunk lands while this one finishes
      load(c - 1);
      if (c > 1) prefetch(c - 2);
    }
    store_tile(gs, G);                // over the old g, read in 1 and 3
    if (wl == 0) {     // dcum, its suffix sum da, ddt and dA
      float wv = 0.f, gsv = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wv += red[k];
        gsv += red[4 + k];
      }
      const int j0 = 2 * lane, j1 = j0 + 1;
      // dcum_i = sum_j K_ij - sum_k K_ki + the carried terms
      float d0 = rd[j0], d1 = rd[j1];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        d0 += krow[k * kQ + j0];
        d1 += krow[k * kQ + j1];
      }
      d0 -= kcol[j0];
      d1 -= kcol[j1];
      if (lane == 31) d1 += fmaf(total, gsv, wv);
      float incl = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += v;
      }
      float after = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) after = 0.f;
      const float da1 = d1 + after, da0 = d0 + da1;
      if (j0 < nq) ddtb[static_cast<long long>(s0 + j0) * H] =
          fmaf(a, da0, xd[j0]);
      if (j1 < nq) ddtb[static_cast<long long>(s0 + j1) * H] =
          fmaf(a, da1, xd[j1]);
      dA_acc = fmaf(dtv[j0], da0, dA_acc);
      dA_acc = fmaf(dtv[j1], da1, dA_acc);
    }

    // 5. the block's own rows: the two pairs' sums, rank 0's first (warps
    //    1-3 of each warpgroup, while its warp 0 takes dcum)
    cluster_wait();                   // the other block's pushes are here
    if (wl != 0) {
      const int rows = csz == 1 ? kQ : kOwn, r0 = csz == 1 ? 0 : rank * kOwn;
      const int step = hb * (kWg - 32);
#pragma unroll 4
      for (int e = wg * (kWg - 32) + tid % kWg - 32; e < rows * (N / 4);
           e += step) {
        const int i = r0 + e / (N / 4), n = 4 * (e % (N / 4));
#pragma unroll
        for (int m = 0; m < 2; ++m) {                  // 0 dC, 1 dB
          float4 sum = *reinterpret_cast<const float4*>(
              at(m ? sb : sc, i, n));
          if (csz == 2) {
            const float4 o = *reinterpret_cast<const float4*>(
                at(recv + m * kOwn * N, i - r0, n));
            sum = rank == 0 ? make_float4(sum.x + o.x, sum.y + o.y,
                                          sum.z + o.z, sum.w + o.w)
                            : make_float4(o.x + sum.x, o.y + sum.y,
                                          o.z + sum.z, o.w + sum.w);
          }
          if (i < nq) {
            const long long row = s0 + i;
            if (parts > 1) {
              float* dst = (m ? dBp : dCp)
                           + ((static_cast<long long>(b) * parts + part) * S
                              + row) * N + n;
              *reinterpret_cast<float4*>(dst) = sum;
            } else {
              bf16* dst = (m ? dB : dC)
                          + (static_cast<long long>(b) * S + row) * N + n;
              *reinterpret_cast<uint2*>(dst) =
                  make_uint2(pack(sum.x, sum.y), pack(sum.z, sum.w));
            }
          }
        }
      }
    }
    cluster_arrive();                 // done reading the pushed rows
    fence_async_smem();               // g's tile, for the next products
    __syncthreads();                  // the stages are read
  }
  cluster_wait();      // no block leaves while the other may push to it

  if (wl == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dA_acc += __shfl_xor_sync(0xffffffffu, dA_acc, off);
    if (lane == 0) dAp[bh] = dA_acc;
  }
  if (dstate0 != nullptr) {
#pragma unroll
    for (int t = 0; t < N / 8; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(dstate0 + bh * P * N
                                   + (half ? jB : jA) * N + 8 * t + 2 * tq) =
            make_float2(G[4 * t + 2 * half], G[4 * t + 2 * half + 1]);
  }
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// The bf16 walk on wgmma at (P, N): blocks of heads_a_block heads in
// clusters of cluster_blocks, then the pass that sums what it leaves.
template <int P, int N>
int launch_wgmma(const void* x, const void* dt, const void* A,
                 const void* Bm, const void* Cm, const void* dy,
                 const void* states, const void* dstate, void* dx,
                 void* ddt, void* dA, void* dB, void* dC, void* dstate0,
                 void* dBp, void* dCp, void* dAp, int batch, const Params& p,
                 cudaStream_t stream) {
  const int sms = sm_count();
  const int hb = heads_a_block(batch, p.H, sms);
  const int csz = cluster_blocks(batch, p.H, sms);
  const int parts = p.H / (hb * csz);
  const size_t smem = wg_smem_bytes(P, N);
  auto kernel = ssd_bwd_wgmma_kernel<P, N>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * p.H / hb);
  cfg.blockDim = dim3(hb * kWg);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csz;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(x), dt,
      static_cast<const float*>(A), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<const bf16*>(dy),
      static_cast<const float*>(states), static_cast<const float*>(dstate),
      static_cast<bf16*>(dx), static_cast<float*>(ddt),
      static_cast<bf16*>(dB), static_cast<bf16*>(dC),
      static_cast<float*>(dBp), static_cast<float*>(dCp),
      static_cast<float*>(dAp), static_cast<float*>(dstate0), p));
  if (err) return err;
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long SN = static_cast<long long>(p.S) * p.N;
  const long long blocks =
      parts > 1 ? (batch * SN + kThreads - 1) / kThreads : 1;
  ssd_bwd_reduce<bf16><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(
      static_cast<const float*>(dBp), static_cast<const float*>(dCp),
      static_cast<const float*>(dAp), static_cast<bf16*>(dB),
      static_cast<bf16*>(dC), static_cast<float*>(dA), batch, p.H,
      parts > 1 ? parts : 0, SN);
  return static_cast<int>(cudaGetLastError());
}

// The scalar walk (per-head partials), then the reduce pass.
template <typename T>
int launch_scalar(const void* x, const void* dt, const void* A,
                  const void* Bm, const void* Cm, const void* dy,
                  const void* states, const void* dstate, void* dx,
                  void* ddt, void* dA, void* dB, void* dC, void* dstate0,
                  void* dBp, void* dCp, void* dAp, int batch,
                  const Params& p, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(smem_floats(p.P, p.N)) * 4;
  int err = set_smem(ssd_bwd_kernel<T>, smem);
  if (err) return err;
  ssd_bwd_kernel<T><<<batch * p.H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const T*>(dy), static_cast<const float*>(states),
      static_cast<const float*>(dstate), static_cast<T*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dBp),
      static_cast<float*>(dCp), static_cast<float*>(dAp),
      static_cast<float*>(dstate0), p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long SN = static_cast<long long>(p.S) * p.N;
  const long long blocks = (batch * SN + kThreads - 1) / kThreads;
  ssd_bwd_reduce<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const float*>(dBp), static_cast<const float*>(dCp),
      static_cast<const float*>(dAp), static_cast<T*>(dB),
      static_cast<T*>(dC), static_cast<float*>(dA), batch, p.H, p.H, SN);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point. Pointers are device pointers. x, B, C, dy (and dx, dB, dC)
// are bf16 (is_bf16 = 1) or fp32 (is_bf16 = 0), dt bf16 (dt_bf16 = 1) or
// fp32, A fp32 (H,); states the forward's fp32 chunk-entry states (B, H,
// nc, P, N), contiguous; dstate the final state's fp32 cotangent (B, H, P,
// N), contiguous, or null (zeros); dstate0 the incoming state's gradient,
// or null (not written). Written contiguous: dx (B, S, H, P), ddt fp32 (B,
// S, H), dA fp32 (H,), dB and dC (B, S, N); scratch: dAp fp32 (B, H), and
// dBp, dCp fp32 (B, parts, S, N), with parts = H on the scalar walk and
// H / ssd_bwd_cluster_size(batch, H) on the wgmma walk (null when that
// is 1).
// Strides in elements; x, B, C and dy have innermost stride 1. tc = 1
// takes the wgmma walk: bf16, P = 64, N = 128, and 16-byte alignment of x,
// dy, B and C at every (batch, position, head); else the scalar walk: P %
// 4 == 0, N % 4 == 0 and shared memory (smem_floats) within the card's 227
// KB a block, else setting it fails. S >= 1. Returns the first error of
// setting the walk's shared memory or launching it (a cluster that cannot
// be placed included), else cudaGetLastError() after the reduce pass.
extern "C" int ssd_bwd(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* dy,
                       const void* states, const void* dstate, void* dx,
                       void* ddt, void* dA, void* dB, void* dC, void* dstate0,
                       void* dBp, void* dCp, void* dAp, int is_bf16, int tc,
                       int dt_bf16, int batch, int S, int H, int P, int N,
                       long long xsb, long long xss, long long xsh,
                       long long dsb, long long dss, long long dsh,
                       long long bsb, long long bss, long long csb,
                       long long css, long long gsb, long long gss,
                       long long gsh, void* stream) {
  const Params p{S,   H,   P,   N,   (S + kQ - 1) / kQ, xsb, xss, xsh, dsb,
                 dss, dsh, bsb, bss, csb, css,          gsb, gss, gsh,
                 dt_bf16};
  auto s = static_cast<cudaStream_t>(stream);
#define SSD_BWD_ARGS x, dt, A, Bm, Cm, dy, states, dstate, dx, ddt, dA, dB, \
                     dC, dstate0, dBp, dCp, dAp, batch, p, s
  if (!is_bf16)
    return tc ? static_cast<int>(cudaErrorInvalidValue)
              : launch_scalar<float>(SSD_BWD_ARGS);
  if (!tc) return launch_scalar<bf16>(SSD_BWD_ARGS);
  // one instance per (P, N): the registers' tiles are fixed at compile
  // time; mamba2-370m's heads
  if (P == 64 && N == 128) return launch_wgmma<64, 128>(SSD_BWD_ARGS);
#undef SSD_BWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory of one block of the wgmma walk, in bytes.
extern "C" int ssd_bwd_tc_smem_bytes(int P, int N) {
  return wg_smem_bytes(P, N);
}

// Heads of one batch row whose dB and dC the wgmma walk sums on chip at
// batch x H heads on this card (cluster_size).
extern "C" int ssd_bwd_cluster_size(int batch, int H) {
  return cluster_size(batch, H, sm_count());
}
