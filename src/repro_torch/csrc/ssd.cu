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
// there and inf * 0 is NaN. Every product accumulates in fp32 (scalar FMA,
// so TF32 never enters); y is written in x's dtype, before the model adds
// its D skip, as the reference rounds it.
//
// The chunk length is the kernel's own, kQ = 64 positions. SSD's output and
// final state depend on the chunk length only through fp32 rounding, so the
// caller's chunk (256 on the serving path) is checked by the wrapper and
// not used here. A ragged tail (S not a multiple of kQ) is padded with
// dt = x = B = C = 0, which adds nothing and decays nothing.
//
// Layout. x, y: (B, S, H, P); dt: (B, S, H); B, C: (B, S, N), shared by the
// heads (G = 1); A: (H,) fp32; state0 and the final state: (B, H, P, N)
// fp32. All are read through their strides (innermost stride 1 except dt),
// so the model's tensors go in as they are, with no transposed copy; state0
// and the final state may be the same memory (one layer's slice of the
// model's stacked cache, updated in place): each block reads its (b, h)
// slice before the chunk loop and writes it after.
//
// Design. One block of 256 threads per (b, h); a loop over the chunks
// inside the block takes the place of the TPU's sequential grid axis. The
// state lives in shared memory for the whole sequence, transposed to
// (N, P). Per chunk, with every operand of the chunk staged in shared
// memory as fp32 (x*dt (kQ, P), B (kQ, N), C^T (N, kQ), M^T (kQ, kQ)):
//   1. M = (C B^T) o L, in 4x4 tiles, one per thread; tiles above the
//      diagonal are skipped;
//   2. y = M (x dt) + exp(cum) * (C state^T), in 4x4 tiles of (i, p); the
//      intra-chunk sum stops at the diagonal;
//   3. state = state * exp(cum[-1]) + (x dt * decay)^T B, in 4x4 tiles of
//      (n, p).
// Shared memory at P = 64, N = 128: about 133 KB, one block per SM.
//
// Bound on this card, at the serving shape (B=8, S=512, H=32, P=64,
// N=128): the bytes. The function must read x (16.8 MB bf16), dt, B, C and
// the incoming state (16.8 MB fp32) and write y and the final state, about
// 53 MB, or 16 us at 3.35 TB/s; its operations at kQ = 64, counting only
// the lower triangle of each chunk's kQ x kQ products, are about 5.9 GFLOP,
// 6 us at the bf16 tensor-core peak. This kernel runs on the fp32 FMA units
// (67 TFLOP/s at best, 0.09 ms for that work) and is held back
// further by shared-memory traffic and by 256 blocks filling 132 SMs in two
// uneven waves. Moving the three products onto tensor cores (bf16 mma for
// C B^T, whose inputs are exactly bf16; split-fp32 for the others) and
// splitting the state's P axis over more blocks are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kQ = 64;           // positions per chunk
constexpr int kT = kQ / 4;       // 4x4 tiles along a chunk
constexpr int kQPad = kQ + 4;    // row stride of C^T in shared memory

struct Params {
  int S, H, P, N;
  long long xsb, xss, xsh;       // x strides of batch, position, head
  long long dsb, dss, dsh;       // dt
  long long bsb, bss;            // B strides of batch, position
  long long csb, css;            // C
  long long ysb, yss, ysh;       // y
  long long isb, ish, isp;       // state0 strides of batch, head, p
  long long fsb, fsh, fsp;       // final state
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(bf16* dst, float v) {
  *dst = __float2bfloat16(v);
}

__device__ __forceinline__ void unpack(const float* src, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// Shared memory of one block, in floats.
__host__ __device__ constexpr int smem_floats(int P, int N) {
  return kQ * P            // x * dt          (kQ, P)
         + kQ * N          // B               (kQ, N)
         + N * kQPad       // C^T             (N, kQ + 4)
         + N * (P + 4)     // state^T         (N, P + 4)
         + kQ * kQ         // M^T             (kQ, kQ)
         + 3 * kQ;         // dt, cum, decay  (kQ,) each
}

template <typename T, typename TD>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const TD* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* state0, T* __restrict__ y,
           float* final_state, const Params p) {
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
  const T* xb = x + b * p.xsb + h * p.xsh;
  const TD* db = dt + b * p.dsb + h * p.dsh;
  const T* Bb = Bm + b * p.bsb;
  const T* Cb = Cm + b * p.csb;
  T* yb = y + b * p.ysb + h * p.ysh;

  for (int e = tid; e < P * N; e += kThreads) {
    const int pi = e / N, n = e % N;
    st[n * PP + pi] =
        state0 ? state0[b * p.isb + h * p.ish + pi * p.isp + n] : 0.f;
  }

  for (int s0 = 0; s0 < p.S; s0 += kQ) {
    const int nq = min(kQ, p.S - s0);
    __syncthreads();  // the previous chunk's operands are consumed

    // 0. dt and the prefix sum of dt * A (warp 0, two positions a lane);
    //    padded positions have dt = 0, so cum stays flat past the tail.
    if (tid < 32) {
      const int j0 = 2 * tid, j1 = j0 + 1;
      const float d0 = j0 < nq ? to_float(db[(s0 + j0) * p.dss]) : 0.f;
      const float d1 = j1 < nq ? to_float(db[(s0 + j1) * p.dss]) : 0.f;
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

    // Operands of the chunk into shared memory, as fp32; zero past the tail.
    for (int e = tid; e < kQ * P; e += kThreads) {
      const int j = e / P, pi = e % P;
      xdt[e] = j < nq ? to_float(xb[(s0 + j) * p.xss + pi]) * dtv[j] : 0.f;
    }
    for (int e = tid; e < kQ * N; e += kThreads) {
      const int j = e / N, n = e % N;
      const bool live = j < nq;
      bs[e] = live ? to_float(Bb[(s0 + j) * p.bss + n]) : 0.f;
      ct[n * kQPad + j] = live ? to_float(Cb[(s0 + j) * p.css + n]) : 0.f;
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
          for (int ii = 0; ii < 4; ++ii) acc[ii][jj] = fmaf(c[ii], bv, acc[ii][jj]);
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
          T* yr = yb + (s0 + i) * p.yss + 4 * tp;
#pragma unroll
          for (int pp = 0; pp < 4; ++pp)
            store(yr + pp, intra[ii][pp] + inter[ii][pp] * din);
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

template <typename T, typename TD>
int launch(const T* x, const TD* dt, const float* A, const T* Bm, const T* Cm,
           const float* state0, T* y, float* final_state, int batch,
           const Params& p, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(smem_floats(p.P, p.N)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T, TD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_kernel<T, TD><<<batch * p.H, kThreads, smem, stream>>>(
      x, dt, A, Bm, Cm, state0, y, final_state, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points. Pointers are device pointers; state0 may be null (a zero
// state) and may equal final_state. Strides are in elements; x, y, B, C and
// both states have innermost stride 1. The caller guarantees P % 4 == 0,
// N % 4 == 0, S >= 1 and shared memory (smem_floats * 4 bytes) within the
// card's 227 KB per block. Returns cudaGetLastError() after the launch.
#define SSD_ENTRY(NAME, T, TD)                                                 \
  extern "C" int NAME(const void* x, const void* dt, const void* A,           \
                      const void* Bm, const void* Cm, const void* state0,     \
                      void* y, void* final_state, int batch, int S, int H,    \
                      int P, int N, long long xsb, long long xss,             \
                      long long xsh, long long dsb, long long dss,            \
                      long long dsh, long long bsb, long long bss,            \
                      long long csb, long long css, long long ysb,            \
                      long long yss, long long ysh, long long isb,            \
                      long long ish, long long isp, long long fsb,            \
                      long long fsh, long long fsp, void* stream) {           \
    const Params p{S,   H,   P,   N,   xsb, xss, xsh, dsb, dss, dsh, bsb,      \
                   bss, csb, css, ysb, yss, ysh, isb, ish, isp, fsb, fsh,      \
                   fsp};                                                       \
    return launch<T, TD>(                                                      \
        static_cast<const T*>(x), static_cast<const TD*>(dt),                  \
        static_cast<const float*>(A), static_cast<const T*>(Bm),               \
        static_cast<const T*>(Cm), static_cast<const float*>(state0),          \
        static_cast<T*>(y), static_cast<float*>(final_state), batch, p,        \
        static_cast<cudaStream_t>(stream));                                    \
  }

SSD_ENTRY(ssd_bf16_dtf32, bf16, float)
SSD_ENTRY(ssd_bf16_dtbf16, bf16, bf16)
SSD_ENTRY(ssd_f32, float, float)
