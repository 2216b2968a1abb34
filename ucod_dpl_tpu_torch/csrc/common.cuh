// Small device helpers shared by the port's hand-written Hopper kernels.
//
// The kernels use the warp-level tensor-core instruction mma.sync
// m16n8k16 (bf16 in, f32 accumulate) with fragments loaded from shared
// memory, and cp.async for global->shared copies.  Fragment layouts
// (PTX ISA, "Matrix fragments for mma.m16n8k16"), with g = lane / 4 and
// t = lane % 4:
//   A (16x16, row major), four 32-bit registers of two bf16 each:
//     a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]
//   B (16x8, column major), two registers:
//     b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C/D (16x8, f32), four floats:
//     c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ucod {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous global->shared copy.  When `valid` is false the
// source is not read and the 16 destination bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += A * B for one m16n8k16 tile, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A * B for one m16n8k32 tile, s8 operands, exact s32 accumulators.  In
// bytes its fragments are those of m16n8k16 bf16 above (a0 = A[g][4t..4t+3],
// b0 = B[4t..4t+3][g], ...), so the same ldmatrix addressing feeds both.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two adjacent bf16 values (the lower index in the low half).
__device__ __forceinline__ uint32_t ld_bf16x2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the
// addresses of the eight 16-byte rows of matrix i; register i holds matrix
// i's fragment (lane: row g, columns 2t, 2t+1).  Delivers A fragments from a
// row-major [m][k] tile and B fragments from a row-major [n][k] tile.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// Four 8x8 b16 matrices from shared memory, each delivered transposed:
// lanes 8i..8i+7 give the addresses of the eight 16-byte rows of matrix i.
// Delivers B fragments straight from a row-major [k][n] tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// Rows [row0, row0 + kRows) of a (seq_len, row_stride) bf16 matrix, 64
// columns from `src`, into a padded shared tile, by all kThreads threads with
// cp.async.  Rows >= seq_len are zero-filled and never read from global
// memory.
template <int kRows, int kLd, int kThreads>
__device__ __forceinline__ void load_rows64(__nv_bfloat16 (*dst)[kLd], const __nv_bfloat16* src,
                                            int row0, int seq_len, int64_t row_stride) {
  for (int idx = threadIdx.x; idx < kRows * 8; idx += kThreads) {
    const int r = idx >> 3;
    const int c = (idx & 7) * 8;
    const int row = row0 + r;
    const bool valid = row < seq_len;
    cp_async16(&dst[r][c], src + (int64_t)(valid ? row : 0) * row_stride + c, valid);
  }
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
