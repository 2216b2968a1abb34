// Small device helpers shared by the port's hand-written Hopper kernels (the
// TMA / wgmma / cluster helpers are in hopper.cuh): shared-memory addresses,
// bf16 packing, ldmatrix and warp reductions.  No kernel of the port uses
// mma.sync any more: every product is a wgmma.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ucod {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the
// addresses of the eight 16-byte rows of matrix i; register i holds matrix
// i's fragment (lane l: row l / 4, columns 2 (l % 4), + 1), the m16n8k16 A
// fragment order of a row-major [m][k] tile.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

}  // namespace ucod
