// Decode attention (one new token against the KV cache) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/kernel.py :: decode_attention_kernel
//   (launched by decode_attention_pallas, adapter ops.py :: decode_attention).
// Same function: the G query heads of each KV head attend to a
// fixed-capacity cache; keys at or past `length` are masked, and key tiles
// wholly past it are never read. m, l and the accumulator are fp32; p is
// rounded to V's dtype before P.V, as in the Pallas kernel.
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
// Design. One block of 256 threads per (b, hk); the block walks the valid
// keys in tiles of 256:
//   1. scores: thread j owns key j of the tile and dots its K row with the
//      G query rows (q staged in shared memory as fp32); the tile's V rows
//      are staged in shared memory meanwhile;
//   2. softmax: one warp per query row updates the running max and sum;
//   3. P.V: each thread owns (g, d) outputs and sums over the tile's keys.
// Bound on this card: bytes. At the serving shape (B=8, Hk=4, D=64, bf16)
// the kernel must read 2*B*Hk*length*D*2 bytes; that is about 1.1 us at
// length 544 over 3.35 TB/s. With one block per (b, hk) only B*Hk = 32
// of 132 SMs work and each walks its keys in order, so the kernel is
// latency-bound well above that; splitting the key axis over more blocks
// with a log-sum-exp combine is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;          // = keys per tile
constexpr int kMaxG = 16;              // query heads per KV head
constexpr int kMaxOut = 8;             // (g, d) outputs per thread: G*D <= 2048

struct Params {
  int H, Hk, G, L, D;
  long long qsb, qsh;                  // q strides of batch, head
  long long ksb, ksl, ksh;             // k strides of batch, position, head
  long long vsb, vsl, vsh;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(bf16* dst, float x) {
  *dst = __float2bfloat16(x);
}

// p rounded to the value dtype, as the reference casts p before P.V.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// Sixteen bytes of a row as floats.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}
__device__ __forceinline__ void load16(const bf16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ length_ptr,
              T* __restrict__ o, const Params p) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = p.G, D = p.D;
  float* q_s = reinterpret_cast<float*>(smem);          // (G, D)
  float* p_s = q_s + G * D;                             // (G, kThreads)
  float* m_s = p_s + G * kThreads;                      // (G,)
  float* l_s = m_s + G;                                 // (G,)
  float* c_s = l_s + G;                                 // (G,) correction
  T* v_s = reinterpret_cast<T*>(c_s + G + ((-3 * G) & 3));  // (kThreads, D)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / p.Hk, hk = blockIdx.x % p.Hk;
  const int length = min(*length_ptr, p.L);

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    q_s[i] = to_float(q[b * p.qsb + (hk * G + g) * p.qsh + d]);
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  float acc[kMaxOut];
#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) acc[r] = 0.f;

  const T* kb = k + b * p.ksb + hk * p.ksh;
  const T* vb = v + b * p.vsb + hk * p.vsh;
  const int n_tiles = (length + kThreads - 1) / kThreads;

  for (int t = 0; t < n_tiles; ++t) {
    const int key = t * kThreads + tid;
    const bool live = key < length;
    if (t > 0) __syncthreads();  // the previous tile's P and V are consumed

    // 1. scores for this thread's key, and its V row into shared memory.
    float s[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
    if (live) {
      const T* kr = kb + key * p.ksl;
      const T* vr = vb + key * p.vsl;
      for (int d0 = 0; d0 < D; d0 += kVec) {
        float kx[kVec];
        load16(kr + d0, kx);
        *reinterpret_cast<uint4*>(v_s + tid * D + d0) =
            *reinterpret_cast<const uint4*>(vr + d0);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
#pragma unroll
            for (int i = 0; i < kVec; ++i)
              s[g] = fmaf(q_s[g * D + d0 + i], kx[i], s[g]);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) p_s[g * kThreads + tid] = live ? s[g] * p.scale : kNegInf;
    __syncthreads();

    // 2. online softmax, one warp per query row.
    for (int g = warp; g < G; g += kThreads / 32) {
      float* row = p_s + g * kThreads;
      float mx = m_s[g];
      for (int j = lane; j < kThreads; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
      for (int j = lane; j < kThreads; j += 32) {
        const float e = expf(row[j] - mx);
        sum += e;
        row[j] = round_to(e, v);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_s[g] - mx);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = mx;
      }
    }
    __syncthreads();

    // 3. acc(g, d) = acc * corr(g) + sum_j p(g, j) v(j, d).
    const int n_keys = min(kThreads, length - t * kThreads);
#pragma unroll
    for (int r = 0; r < kMaxOut; ++r) {
      const int i = tid + r * kThreads;
      if (i < G * D) {
        const int g = i / D, d = i % D;
        const float* pr = p_s + g * kThreads;
        float a = acc[r] * c_s[g];
        for (int j = 0; j < n_keys; ++j)
          a = fmaf(pr[j], to_float(v_s[j * D + d]), a);
        acc[r] = a;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) {
    const int i = tid + r * kThreads;
    if (i < G * D) {
      const int g = i / D, d = i % D;
      const float out = acc[r] / fmaxf(l_s[g], 1e-30f);
      store(o + (static_cast<long long>(b) * p.H + hk * G + g) * D + d, out);
    }
  }
}

template <typename T>
size_t smem_bytes(int G, int D) {
  const int floats = G * D + G * kThreads + 3 * G;
  const int padded = floats + ((-floats) & 3);  // 16-byte align v_s
  return padded * sizeof(float) + static_cast<size_t>(kThreads) * D * sizeof(T);
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const int* length, T* o,
           int B, const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(p.G, p.D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_kernel<T><<<B * p.Hk, kThreads, smem, stream>>>(q, k, v, length, o, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points. Pointers are device pointers; `length` points to one
// int32 on the device. Strides are in elements (innermost stride 1); the
// caller guarantees H % Hk == 0, H / Hk <= 16, (H / Hk) * D <= 2048,
// D % (16 / sizeof(T)) == 0 and 16-byte aligned cache rows. o is a
// contiguous (B, 1, H, D). Returns cudaGetLastError() after the launch.
#define DECODE_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* q, const void* k, const void* v,            \
                      const void* length, void* o, int B, int H, int Hk,      \
                      int L, int D, long long qsb, long long qsh,             \
                      long long ksb, long long ksl, long long ksh,            \
                      long long vsb, long long vsl, long long vsh,            \
                      void* stream) {                                          \
    const Params p{H, Hk, H / Hk, L, D, qsb, qsh, ksb, ksl, ksh,               \
                   vsb, vsl, vsh, 1.0f / sqrtf(static_cast<float>(D))};        \
    return launch<T>(static_cast<const T*>(q), static_cast<const T*>(k),       \
                     static_cast<const T*>(v), static_cast<const int*>(length),\
                     static_cast<T*>(o), B, p,                                 \
                     static_cast<cudaStream_t>(stream));                       \
  }

DECODE_ENTRY(decode_attention_bf16, bf16)
DECODE_ENTRY(decode_attention_f32, float)
