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
// Two kernels walk the chunks; the launcher picks one. Both run one block
// per (b, h), walk the chunks in reverse with g carried in fp32, and hold
// all P rows of their head in the block: the state's rows never mix, but
// dB, dC, ddt and dcum sum over P. Both write dx in x's dtype and ddt in
// fp32; dB and dC leave the block as fp32 partials of their head, and dA
// as one fp32 partial of the (b, h); a second launch (ssd_bwd_reduce)
// sums the partials over heads (and dA over the batch) in a fixed order,
// with no atomics, so two calls give the same bits. Every other sum (the
// row dots, <g, s>, sum_j w_j, dA's) is taken in a fixed order too.
//
// ssd_bwd_tc_kernel (bf16, built for mamba2's heads, P = 64 and N = 128;
// the template takes P in {16, 32, 64} and N up to 128, and another pair
// is instantiated below when a configuration needs it) runs its products on the tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 accumulate), four warps of 16 positions each;
// its note below gives its steps and what it rounds. ssd_bwd_kernel (fp32,
// and bf16 at other sizes) stages every operand in shared memory as fp32,
// rows padded to an odd length so that neither a row nor a column walk
// meets a bank conflict, and runs each product as IEEE FMA in 4 x 4
// register tiles whose rows and columns are interleaved over its 256
// threads (row r + R/4 ii, column c + C/4 jj).
//
// Bound on this card, at the training shape (B=8, S=512, H=32, P=64,
// N=128, bf16, dt fp32): the bytes, counted in chip_smoke.py. The
// function must move x, dy and dx (16.8 MB each), dt and ddt (0.5 MB
// each), B, C, dB and dC (1 MB each): 55.6 MB, 0.0166 ms at 3.35 TB/s.
// Its products, the five Q x Q ones over the ten 16 x 16 blocks on or
// below the diagonal as the tensor-core kernel runs them, are 13.96 GFLOP,
// 0.0141 ms at the bf16 tensor-core peak. Both designs also read the stored chunk states (67 MB)
// and write and read back the per-head partials of dB and dC (67 MB each):
// 336 MB more, 0.10 ms at 3.35 TB/s, which bounds them. Shared memory at
// P = 64, N = 128: the tensor-core kernel 110,112 bytes (two blocks an SM,
// the training shape's 256 blocks in one wave), the scalar one 214,016
// (one block an SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

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

// dB = sum_h dBp, dC = sum_h dCp ((B, S, N) from (B, H, S, N)), h in order;
// dA = sum_b dAp ((H,) from (B, H)), b in order (block 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce(const float* __restrict__ dBp, const float* __restrict__ dCp,
               const float* __restrict__ dAp, T* __restrict__ dB,
               T* __restrict__ dC, float* __restrict__ dA, int batch, int H,
               long long SN) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (e < batch * SN) {
    const long long b = e / SN, sn = e % SN;
    const float* pb = dBp + b * H * SN + sn;
    const float* pc = dCp + b * H * SN + sn;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      sb += pb[h * SN];
      sc += pc[h * SN];
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

// ------------------------------------------------------ bf16, mma.sync ---
constexpr int kWarps = kQ / 16;  // 16 positions of a chunk a warp
constexpr int kPad = 8;          // bf16 row padding: ldmatrix rows hit
                                 // distinct banks
constexpr int kRowQ = kQ + kPad; // row stride of CBL and DXL
constexpr int kLowerPairs = 10;  // 16 x 16 blocks on or below the diagonal

// Shared memory of one block of the tensor-core kernel, in bytes.
__host__ __device__ constexpr int tc_smem_bytes(int P, int N) {
  return 2 * (2 * kQ * (P + kPad)      // x, dy        (kQ, P + 8) each
              + 2 * kQ * (N + kPad)    // B, C         (kQ, N + 8) each
              + 2 * P * (N + kPad)     // s, g         (P, N + 8) each
              + 2 * kQ * kRowQ)        // CBL, DXL     (kQ, kQ + 8) each
         + 4 * (6 * kQ                 // dt, cum, e_in, e_out, two row dots
                + 2 * kWarps * kQ      // K's row and column sums, by block
                + 2 * kWarps);         // per-warp sum_j w_j and <g, s>
}

__device__ __forceinline__ uint32_t scale2(uint32_t u, float e0, float e1) {
  const float2 v = unpack2(u);
  return pack(v.x * e0, v.y * e1);
}

// A warp's 16 rows (r0 + gr, r0 + gr + 8) of accumulators, NT 8-column
// tiles, rounded to bf16 into s (row stride ld).
template <int NT>
__device__ __forceinline__ void store_rows(bf16* s, int ld, int r0,
                                           const float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<uint32_t*>(s + (r0 + gr + 8 * half) * ld + 8 * t
                                   + 2 * tq) =
          pack(acc[t][2 * half], acc[t][2 * half + 1]);
}

// The same function as ssd_bwd_kernel, its products on the tensor cores:
// four warps, each owning 16 positions of the chunk (the rows of dxdt, dC
// and dB) and 16 rows of the state's g, held in its registers as fp32
// accumulators for the whole walk. Operands are staged in shared memory as
// bf16: x, dy, B and C exactly (cp.async, 16 bytes a copy), the entering
// state s, g, CBL and DXL rounded once (e_in dy rounded once in its
// fragments); every product sums in fp32. The rounding reaches each
// gradient at ~0.3% of its norm (tools/ssd_bwd_tolerance.py emulates it).
// dcum takes its sums of K from fp32 products, not from the rounded CBL
// and DXL: dcum_i = sum_j K_ij - sum_k K_ki + C_i.dC'_i - B_i.dB'_i, with
// dC'_i = e_in_i s^T dy_i and dB'_j = e_out_j g^T xdt_j the carried-state
// parts (dA sums dt da over B S positions whose terms cancel, and the
// rounded CBL and DXL cost it ~1% of its norm with a random state). Per
// chunk:
//   1. the ten 16 x 16 blocks on or below the diagonal, split over the
//      warps: C B^T and dy x^T, then CBL and DXL rounded into shared
//      memory, and the row and column sums of K = CBL o (dy x^T) dt_j in
//      fp32; blocks above the diagonal are never read;
//   2. per warp, its rows: dxdt = e_out o (B g^T) + CBL^T dy, then dx and
//      x.dxdt; dC = e_in o (dy s) + DXL B; dB = e_out dt o (x g) +
//      DXL^T C, the carried parts' dots with C and B and the warp's share
//      of sum_j w_j; its rows of g: <g, s> (s in fp32 from the stored
//      states), then g = exp(cum_Q) g + (e_in o dy)^T C;
//   3. g rounded into shared memory for the next chunk; warp 0 as step 4
//      of ssd_bwd_kernel, with K's sums and the carried parts' dots.
template <int P, int N>
__global__ void __launch_bounds__(kWarps * 32, 2)
ssd_bwd_tc_kernel(const bf16* __restrict__ x, const void* __restrict__ dt,
                  const float* __restrict__ A, const bf16* __restrict__ Bm,
                  const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                  const float* __restrict__ states,
                  const float* __restrict__ dstate, bf16* __restrict__ dx,
                  float* __restrict__ ddt, float* __restrict__ dBp,
                  float* __restrict__ dCp, float* __restrict__ dAp,
                  float* __restrict__ dstate0, const Params p) {
  constexpr int XP = P + kPad, NP = N + kPad;
  constexpr int PT = P / 8, NT = N / 8;      // 8-column tiles
  constexpr int PK = P / 16, NK = N / 16;    // 16-deep steps
  static_assert(P % 16 == 0 && P <= 16 * kWarps && N % 16 == 0 && N <= 128,
                "P, N");
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* xs = reinterpret_cast<bf16*>(smem_tc);   // [kQ][XP]
  bf16* dys = xs + kQ * XP;                      // [kQ][XP]
  bf16* bs = dys + kQ * XP;                      // [kQ][NP]
  bf16* cs = bs + kQ * NP;                       // [kQ][NP]
  bf16* ss = cs + kQ * NP;                       // [P][NP]
  bf16* gs = ss + P * NP;                        // [P][NP]
  bf16* cbl = gs + P * NP;                       // [kQ][kRowQ]
  bf16* dxl = cbl + kQ * kRowQ;                  // [kQ][kRowQ]
  float* dtv = reinterpret_cast<float*>(dxl + kQ * kRowQ);
  float* cum = dtv + kQ;
  float* ein = cum + kQ;
  float* eout = ein + kQ;
  float* rd = eout + kQ;                         // the carried terms
  float* xd = rd + kQ;                           // x.dxdt
  float* krow = xd + kQ;                         // [block col][i]: K rows
  float* kcol = krow + kWarps * kQ;              // [block row][j]: K cols
  float* red = kcol + kWarps * kQ;               // w, then <g, s>, a warp

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int S = p.S, H = p.H;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int r0 = 16 * warp;           // the warp's positions and state rows
  const float a = A[h];
  const bf16* xb = x + b * p.xsb + h * p.xsh;
  const bf16* gb = dy + b * p.gsb + h * p.gsh;
  const bf16* Bb = Bm + b * p.bsb;
  const bf16* Cb = Cm + b * p.csb;
  const long long dbase = b * p.dsb + h * p.dsh;
  const long long bh = static_cast<long long>(b) * H + h;
  bf16* dxb = dx + (static_cast<long long>(b) * S * H + h) * P;
  float* ddtb = ddt + static_cast<long long>(b) * S * H + h;
  float* dBb = dBp + bh * S * N;
  float* dCb = dCp + bh * S * N;

  // g, the warp's 16 state rows (r0 + gr, r0 + gr + 8) as accumulators:
  // G[t] holds columns 8 t + 2 tq and 8 t + 2 tq + 1
  float G[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long o = bh * P * N + (r0 + gr + 8 * half) * N + 8 * t
                          + 2 * tq;
      const bool live = dstate != nullptr && r0 < P;
      G[t][2 * half] = live ? dstate[o] : 0.f;
      G[t][2 * half + 1] = live ? dstate[o + 1] : 0.f;
    }
  if (r0 < P) store_rows<NT>(gs, NP, r0, G);
  float dA_acc = 0.f;                 // warp 0: sum_t dt_t da_t, per lane

  for (int c = p.nc - 1; c >= 0; --c) {
    const int s0 = c * kQ, nq = min(kQ, S - s0);
    __syncthreads();  // the previous chunk's operands and row dots are read

    // The chunk's x, dy, B and C (16 bytes a copy, zeros past the tail),
    // the entering state rounded to bf16, and the scalars (warp 0).
    constexpr int xv = P / 8, bv = N / 8;
    for (int e = tid; e < kQ * xv; e += kWarps * 32) {
      const int j = e / xv, q = e % xv;
      const bool live = j < nq;
      const long long s = live ? s0 + j : 0;
      cp_async16(xs + j * XP + 8 * q, xb + s * p.xss + 8 * q, live);
      cp_async16(dys + j * XP + 8 * q, gb + s * p.gss + 8 * q, live);
    }
    for (int e = tid; e < kQ * bv; e += kWarps * 32) {
      const int j = e / bv, q = e % bv;
      const bool live = j < nq;
      const long long s = live ? s0 + j : 0;
      cp_async16(bs + j * NP + 8 * q, Bb + s * p.bss + 8 * q, live);
      cp_async16(cs + j * NP + 8 * q, Cb + s * p.css + 8 * q, live);
    }
    cp_async_commit();
    const float* sg = states + (bh * p.nc + c) * P * N;
    for (int e = tid; e < P * N / 2; e += kWarps * 32) {
      const float2 v = reinterpret_cast<const float2*>(sg)[e];
      const int pi = 2 * e / N, n = 2 * e % N;
      *reinterpret_cast<uint32_t*>(ss + pi * NP + n) = pack(v.x, v.y);
    }
    if (warp == 0) {
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
    cp_async_wait_all();
    __syncthreads();
    const float total = expf(cum[kQ - 1]);

    // 1. CBL = (C B^T) o L, DXL = (dy x^T) o L o dt_j, and the row and
    //    column sums of K = (C B^T) o (dy x^T) o L o dt_j from their fp32
    //    products: the ten blocks on or below the diagonal, split over the
    //    warps.
    for (int v = warp; v < kLowerPairs; v += kWarps) {
      const int mt = v >= 6 ? 3 : v >= 3 ? 2 : v >= 1 ? 1 : 0;
      const int nt = v - mt * (mt + 1) / 2;
      float cb[2][4] = {}, dd[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < NK; ++ks) {
        uint32_t af[4], bf[4];
        a_mk(af, cs, NP, 16 * mt, 16 * ks);
        b_nk(bf, bs, NP, 16 * nt, 16 * ks);
        mma_16816(cb[0], af, bf[0], bf[1]);
        mma_16816(cb[1], af, bf[2], bf[3]);
      }
#pragma unroll
      for (int ks = 0; ks < PK; ++ks) {
        uint32_t af[4], bf[4];
        a_mk(af, dys, XP, 16 * mt, 16 * ks);
        b_nk(bf, xs, XP, 16 * nt, 16 * ks);
        mma_16816(dd[0], af, bf[0], bf[1]);
        mma_16816(dd[1], af, bf[2], bf[3]);
      }
      float rows[2] = {0.f, 0.f}, cols[2][2] = {};
#pragma unroll
      for (int sub = 0; sub < 2; ++sub)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 16 * mt + gr + 8 * half;
          float m[2][2];                               // [cb, dxl][e]
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 16 * nt + 8 * sub + 2 * tq + e;
            const float l = i >= j ? expf(cum[i] - cum[j]) : 0.f;
            m[0][e] = cb[sub][2 * half + e] * l;
            m[1][e] = dd[sub][2 * half + e] * dtv[j] * l;
            const float kij = m[0][e] * dd[sub][2 * half + e] * dtv[j];
            rows[half] += kij;
            cols[sub][e] += kij;
          }
          const int j = 16 * nt + 8 * sub + 2 * tq;
          *reinterpret_cast<uint32_t*>(cbl + i * kRowQ + j) =
              pack(m[0][0], m[0][1]);
          *reinterpret_cast<uint32_t*>(dxl + i * kRowQ + j) =
              pack(m[1][0], m[1][1]);
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        rows[half] += __shfl_xor_sync(0xffffffffu, rows[half], 1);
        rows[half] += __shfl_xor_sync(0xffffffffu, rows[half], 2);
        if (tq == 0) krow[nt * kQ + 16 * mt + gr + 8 * half] = rows[half];
      }
#pragma unroll
      for (int sub = 0; sub < 2; ++sub)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float c = cols[sub][e];
          c += __shfl_xor_sync(0xffffffffu, c, 4);
          c += __shfl_xor_sync(0xffffffffu, c, 8);
          c += __shfl_xor_sync(0xffffffffu, c, 16);
          if (gr == 0) kcol[mt * kQ + 16 * nt + 8 * sub + 2 * tq + e] = c;
        }
    }
    __syncthreads();

    uint32_t af[4], bf[4];
    // 2a. dxdt (rows j of the warp, P columns) = e_out o (B g^T) + CBL^T dy
    {
      float acc[PT][4] = {};
#pragma unroll
      for (int ks = 0; ks < NK; ++ks) {
        a_mk(af, bs, NP, r0, 16 * ks);
#pragma unroll
        for (int n2 = 0; n2 < P / 16; ++n2) {
          b_nk(bf, gs, NP, 16 * n2, 16 * ks);
          mma_16816(acc[2 * n2], af, bf[0], bf[1]);
          mma_16816(acc[2 * n2 + 1], af, bf[2], bf[3]);
        }
      }
      const float e0 = eout[r0 + gr], e1 = eout[r0 + gr + 8];
#pragma unroll
      for (int t = 0; t < PT; ++t) {
        acc[t][0] *= e0;
        acc[t][1] *= e0;
        acc[t][2] *= e1;
        acc[t][3] *= e1;
      }
      for (int ks = warp; ks < kWarps; ++ks) {     // i >= j
        a_km(af, cbl, kRowQ, r0, 16 * ks);
#pragma unroll
        for (int n2 = 0; n2 < P / 16; ++n2) {
          b_kn(bf, dys, XP, 16 * n2, 16 * ks);
          mma_16816(acc[2 * n2], af, bf[0], bf[1]);
          mma_16816(acc[2 * n2 + 1], af, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = r0 + gr + 8 * half;
        const float dj = dtv[j];
        float dot = 0.f;
#pragma unroll
        for (int t = 0; t < PT; ++t) {
          const int pc = 8 * t + 2 * tq;
          const float v0 = acc[t][2 * half], v1 = acc[t][2 * half + 1];
          const float2 xv2 = unpack2(
              *reinterpret_cast<const uint32_t*>(xs + j * XP + pc));
          dot = fmaf(xv2.x, v0, fmaf(xv2.y, v1, dot));
          if (j < nq)
            *reinterpret_cast<uint32_t*>(
                dxb + static_cast<long long>(s0 + j) * H * P + pc) =
                pack(dj * v0, dj * v1);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        if (tq == 0) xd[j] = dot;
      }
    }

    // 2b. dC (rows i of the warp, N columns) = e_in o (dy s) + DXL B
    float rdv[2] = {0.f, 0.f};
    {
      float acc[NT][4] = {};
#pragma unroll
      for (int ks = 0; ks < PK; ++ks) {
        a_mk(af, dys, XP, r0, 16 * ks);
#pragma unroll
        for (int n2 = 0; n2 < N / 16; ++n2) {
          b_kn(bf, ss, NP, 16 * n2, 16 * ks);
          mma_16816(acc[2 * n2], af, bf[0], bf[1]);
          mma_16816(acc[2 * n2 + 1], af, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = r0 + gr + 8 * half;
        const float e = ein[i];
#pragma unroll
        for (int t = 0; t < NT; ++t) {             // C_i . e_in_i s^T dy_i
          const float2 cv = unpack2(*reinterpret_cast<const uint32_t*>(
              cs + i * NP + 8 * t + 2 * tq));
          acc[t][2 * half] *= e;
          acc[t][2 * half + 1] *= e;
          rdv[half] = fmaf(cv.x, acc[t][2 * half],
                           fmaf(cv.y, acc[t][2 * half + 1], rdv[half]));
        }
      }
      for (int ks = 0; ks <= warp; ++ks) {         // j <= i
        a_mk(af, dxl, kRowQ, r0, 16 * ks);
#pragma unroll
        for (int n2 = 0; n2 < N / 16; ++n2) {
          b_kn(bf, bs, NP, 16 * n2, 16 * ks);
          mma_16816(acc[2 * n2], af, bf[0], bf[1]);
          mma_16816(acc[2 * n2 + 1], af, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = r0 + gr + 8 * half;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int n = 8 * t + 2 * tq;
          const float v0 = acc[t][2 * half], v1 = acc[t][2 * half + 1];
          if (i < nq)
            *reinterpret_cast<float2*>(
                dCb + static_cast<long long>(s0 + i) * N + n) =
                make_float2(v0, v1);
        }
      }
    }

    // 2c. dB (rows j of the warp, N columns) = e_out dt o (x g) + DXL^T C
    float wsum = 0.f;
    {
      float acc[NT][4] = {};
#pragma unroll
      for (int ks = 0; ks < PK; ++ks) {
        a_mk(af, xs, XP, r0, 16 * ks);
#pragma unroll
        for (int n2 = 0; n2 < N / 16; ++n2) {
          b_kn(bf, gs, NP, 16 * n2, 16 * ks);
          mma_16816(acc[2 * n2], af, bf[0], bf[1]);
          mma_16816(acc[2 * n2 + 1], af, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = r0 + gr + 8 * half;
        const float sc = eout[j] * dtv[j];
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float2 bv2 = unpack2(*reinterpret_cast<const uint32_t*>(
              bs + j * NP + 8 * t + 2 * tq));
          acc[t][2 * half] *= sc;
          acc[t][2 * half + 1] *= sc;
          const float w = fmaf(bv2.x, acc[t][2 * half],
                               bv2.y * acc[t][2 * half + 1]);
          wsum += w;                               // w_j
          rdv[half] -= w;
        }
      }
      for (int ks = warp; ks < kWarps; ++ks) {     // i >= j
        a_km(af, dxl, kRowQ, r0, 16 * ks);
#pragma unroll
        for (int n2 = 0; n2 < N / 16; ++n2) {
          b_kn(bf, cs, NP, 16 * n2, 16 * ks);
          mma_16816(acc[2 * n2], af, bf[0], bf[1]);
          mma_16816(acc[2 * n2 + 1], af, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = r0 + gr + 8 * half;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int n = 8 * t + 2 * tq;
          const float v0 = acc[t][2 * half], v1 = acc[t][2 * half + 1];
          if (j < nq)
            *reinterpret_cast<float2*>(
                dBb + static_cast<long long>(s0 + j) * N + n) =
                make_float2(v0, v1);
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      rdv[half] += __shfl_xor_sync(0xffffffffu, rdv[half], 1);
      rdv[half] += __shfl_xor_sync(0xffffffffu, rdv[half], 2);
      if (tq == 0) rd[r0 + gr + 8 * half] = rdv[half];
    }

    // 2d. the warp's rows of g: <g, s>, then g = exp(cum_Q) g +
    //     (e_in o dy)^T C
    float gsum = 0.f;
    if (r0 < P) {
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 sv = *reinterpret_cast<const float2*>(
              sg + (r0 + gr + 8 * half) * N + 8 * t + 2 * tq);
          gsum = fmaf(G[t][2 * half], sv.x,
                      fmaf(G[t][2 * half + 1], sv.y, gsum));
          G[t][2 * half] *= total;
          G[t][2 * half + 1] *= total;
        }
#pragma unroll
      for (int ks = 0; ks < kWarps; ++ks) {
        a_km(af, dys, XP, r0, 16 * ks);            // A (p, i) = dy[i][p]
        const int i0 = 16 * ks + 2 * tq;
        af[0] = scale2(af[0], ein[i0], ein[i0 + 1]);
        af[1] = scale2(af[1], ein[i0], ein[i0 + 1]);
        af[2] = scale2(af[2], ein[i0 + 8], ein[i0 + 9]);
        af[3] = scale2(af[3], ein[i0 + 8], ein[i0 + 9]);
#pragma unroll
        for (int n2 = 0; n2 < N / 16; ++n2) {
          b_kn(bf, cs, NP, 16 * n2, 16 * ks);
          mma_16816(G[2 * n2], af, bf[0], bf[1]);
          mma_16816(G[2 * n2 + 1], af, bf[2], bf[3]);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      wsum += __shfl_xor_sync(0xffffffffu, wsum, off);
      gsum += __shfl_xor_sync(0xffffffffu, gsum, off);
    }
    if (lane == 0) {
      red[warp] = wsum;
      red[kWarps + warp] = gsum;
    }
    __syncthreads();  // g, the row dots and the warps' sums are complete

    // 3. g into shared memory for the next chunk; dcum, da, ddt, dA.
    if (r0 < P) store_rows<NT>(gs, NP, r0, G);
    if (warp == 0) {
      float w = 0.f, gsv = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        w += red[k];
        gsv += red[kWarps + k];
      }
      const int j0 = 2 * lane, j1 = j0 + 1;
      // dcum_i = sum_j K_ij - sum_k K_ki + the carried terms; the blocks
      // of K on or below the diagonal: row i in block columns <= i / 16,
      // column i in block rows >= i / 16
      float d0 = rd[j0], d1 = rd[j1];
      for (int t = 0; t <= j0 / 16; ++t) {
        d0 += krow[t * kQ + j0];
        d1 += krow[t * kQ + j1];
      }
      for (int t = j0 / 16; t < kWarps; ++t) {
        d0 -= kcol[t * kQ + j0];
        d1 -= kcol[t * kQ + j1];
      }
      if (lane == 31) d1 += fmaf(total, gsv, w);
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
  }

  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dA_acc += __shfl_xor_sync(0xffffffffu, dA_acc, off);
    if (lane == 0) dAp[bh] = dA_acc;
  }
  if (dstate0 != nullptr && r0 < P) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        *reinterpret_cast<float2*>(dstate0 + bh * P * N
                                   + (r0 + gr + 8 * half) * N + 8 * t
                                   + 2 * tq) =
            make_float2(G[t][2 * half], G[t][2 * half + 1]);
      }
  }
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// The walk (scalar kernel, or the tensor-core one for bf16 when tc), then
// the reduce pass.
template <typename T, int P, int N>
int launch(bool tc, const void* x, const void* dt, const void* A,
           const void* Bm, const void* Cm, const void* dy,
           const void* states, const void* dstate, void* dx, void* ddt,
           void* dA, void* dB, void* dC, void* dstate0, void* dBp, void* dCp,
           void* dAp, int batch, const Params& p, cudaStream_t stream) {
  int err;
  if (tc) {
    if constexpr (P > 0) {
      const size_t smem = tc_smem_bytes(P, N);
      err = set_smem(ssd_bwd_tc_kernel<P, N>, smem);
      if (err) return err;
      ssd_bwd_tc_kernel<P, N><<<batch * p.H, kWarps * 32, smem, stream>>>(
          static_cast<const bf16*>(x), dt, static_cast<const float*>(A),
          static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm),
          static_cast<const bf16*>(dy), static_cast<const float*>(states),
          static_cast<const float*>(dstate), static_cast<bf16*>(dx),
          static_cast<float*>(ddt), static_cast<float*>(dBp),
          static_cast<float*>(dCp), static_cast<float*>(dAp),
          static_cast<float*>(dstate0), p);
    }
  } else {
    const size_t smem = static_cast<size_t>(smem_floats(p.P, p.N)) * 4;
    err = set_smem(ssd_bwd_kernel<T>, smem);
    if (err) return err;
    ssd_bwd_kernel<T><<<batch * p.H, kThreads, smem, stream>>>(
        static_cast<const T*>(x), dt, static_cast<const float*>(A),
        static_cast<const T*>(Bm), static_cast<const T*>(Cm),
        static_cast<const T*>(dy), static_cast<const float*>(states),
        static_cast<const float*>(dstate), static_cast<T*>(dx),
        static_cast<float*>(ddt), static_cast<float*>(dBp),
        static_cast<float*>(dCp), static_cast<float*>(dAp),
        static_cast<float*>(dstate0), p);
  }
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long SN = static_cast<long long>(p.S) * p.N;
  const long long blocks = (batch * SN + kThreads - 1) / kThreads;
  ssd_bwd_reduce<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const float*>(dBp), static_cast<const float*>(dCp),
      static_cast<const float*>(dAp), static_cast<T*>(dB),
      static_cast<T*>(dC), static_cast<float*>(dA), batch, p.H, SN);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point. Pointers are device pointers. x, B, C, dy (and dx, dB, dC)
// are bf16 (is_bf16 = 1) or fp32 (is_bf16 = 0), dt bf16 (dt_bf16 = 1) or
// fp32, A fp32 (H,); states the forward's fp32 chunk-entry states (B, H,
// nc, P, N), contiguous; dstate the final state's fp32 cotangent (B, H, P,
// N), contiguous, or null (zeros); dstate0 the incoming state's gradient,
// or null (not written). Written contiguous: dx (B, S, H, P), ddt fp32 (B,
// S, H), dA fp32 (H,), dB and dC (B, S, N); scratch: dBp and dCp fp32 (B,
// H, S, N), dAp fp32 (B, H). Strides in elements; x, B, C and dy have
// innermost stride 1. tc = 1 takes the tensor-core kernel: bf16, P = 64,
// N = 128, and 16-byte alignment of x, dy, B and C at every (batch,
// position, head); else the scalar kernel: P % 4 == 0, N % 4 == 0 and
// shared memory (smem_floats) within the card's 227 KB a block, else
// setting it fails. S >= 1. Returns cudaGetLastError() after the two
// launches (or the error of setting the kernel's shared memory).
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
              : launch<float, 0, 0>(false, SSD_BWD_ARGS);
  if (!tc) return launch<bf16, 0, 0>(false, SSD_BWD_ARGS);
  // one instance per (P, N): the registers' tiles are fixed at compile
  // time; mamba2-370m's heads
  if (P == 64 && N == 128) return launch<bf16, 64, 128>(true, SSD_BWD_ARGS);
#undef SSD_BWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory of one block of the tensor-core kernel, in bytes.
extern "C" int ssd_bwd_tc_smem_bytes(int P, int N) {
  return tc_smem_bytes(P, N);
}
