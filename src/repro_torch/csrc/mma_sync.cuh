// mma.sync building blocks shared by the SSD kernels (ssd.cu, ssd_bwd.cu):
// 16-byte cp.async, ldmatrix, the bf16 m16n8k16 product with fp32
// accumulators, bf16 pair packing, and the four ways a warp loads its
// operand fragments from row-major shared memory.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes, or 16 zero bytes when !live (src is then not read)
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(smem_dst)), "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, fp32 out.
// Fragments (PTX ISA, mma.m16n8k16), gr = lane / 4, tq = lane % 4:
//   A {(gr, 2tq..+1), (gr+8, 2tq..+1), (gr, 2tq+8..+9), (gr+8, 2tq+8..+9)}
//   B {(2tq..+1, gr), (2tq+8..+9, gr)}    C {(gr, 2tq..+1), (gr+8, 2tq..+1)}
// The C fragments of two neighbouring 8-column tiles are, element for
// element, the A fragment of their 16 columns: accumulators feed the next
// product with no shuffle.
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
// (v0, v1) as bf16 pairs hi + lo, with hi + lo = v to about 2^-17.
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi,
                                      uint32_t& lo) {
  hi = pack(v0, v1);
  const float2 h = unpack2(hi);
  lo = pack(v0 - h.x, v1 - h.y);
}

// Fragment loads for a warp's 16 x 16 A tile at rows m0, columns k0, and
// for two 8-column B tiles (n0 and n0 + 8) at depth k0, from bf16 shared
// memory with row stride ld (a multiple of 8 elements):
//   a_mk: A stored [m][k];  a_km: A stored [k][m] (transposed loads);
//   b_nk: B stored [n][k];  b_kn: B stored [k][n] (transposed loads).
// b_* give {b0, b1} of tile n0 in r[0], r[1] and of tile n0 + 8 in r[2],
// r[3].
__device__ __forceinline__ void a_mk(uint32_t (&r)[4],
                                     const __nv_bfloat16* s, int ld, int m0,
                                     int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, s + (m0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + k0
                 + ((lane >> 4) << 3));
}
__device__ __forceinline__ void a_km(uint32_t (&r)[4],
                                     const __nv_bfloat16* s, int ld, int m0,
                                     int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(r, s + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0
                       + (((lane >> 3) & 1) << 3));
}
__device__ __forceinline__ void b_nk(uint32_t (&r)[4],
                                     const __nv_bfloat16* s, int ld, int n0,
                                     int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0
                 + (((lane >> 3) & 1) << 3));
}
__device__ __forceinline__ void b_kn(uint32_t (&r)[4],
                                     const __nv_bfloat16* s, int ld, int n0,
                                     int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(r, s + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld
                       + n0 + ((lane >> 4) << 3));
}

}  // namespace
