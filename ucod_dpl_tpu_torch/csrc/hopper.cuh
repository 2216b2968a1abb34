// Hopper (sm_90a) building blocks shared by the attention kernels: mbarrier
// pipelines, TMA loads through tensor maps, wgmma shared-memory descriptors
// and the wgmma instructions themselves, named barriers and register
// reallocation.  PTX ISA references: "Tensor Memory Accelerator",
// "Asynchronous Warpgroup Level Matrix Multiply-Accumulate" (wgmma), "mbarrier".
//
// Shared-memory tiles are what a TMA load with CU_TENSOR_MAP_SWIZZLE_128B
// writes: rows of 64 bf16 (128 bytes), 16-byte chunk c of row r stored at
// chunk c ^ (r % 8), in 1024-byte atoms of 8 rows; each tile starts on a
// 1024-byte boundary.  The same layout serves wgmma two ways (its
// descriptor's swizzle mode 1 = 128 bytes):
//   * K-major (the 64 columns are the product's reduction dim): 8-row groups
//     1024 bytes apart (SBO); the k-th 16-column step starts 32 * k bytes in;
//   * MN-major (the rows are the reduction dim, the "transpose" bit set):
//     16 rows per k-step, so the k-th step starts 2048 * k bytes in, 8-row
//     groups 1024 bytes apart.  LBO would step between 64-column atoms along
//     M/N, which a 64-wide operand never takes; it is set to 1024 as well.
// wgmma accumulator layout (m64nN, f32), thread t of the warpgroup, warp
// w = t / 32, g = (t % 32) / 4, q = t % 4: d[4j + e] holds row 16w + g + 8 *
// (e / 2), column 8j + 2q + (e % 2).  A register A fragment of a k-step
// (bf16, m64k16) is four 32-bit registers in the mma.m16n8k16 order:
// rows 16w + g and + 8, columns 2q, 2q + 1 and + 8; so accumulator blocks
// 2k and 2k + 1 of one product are the A fragment of k-step k of the next.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace ucod {

// ---- host: tensor maps -------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime's
// entry-point query, so the library links without -lcuda; nullptr where the
// installed CUDA lacks it.
inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p)
                                                                      : nullptr;
  }();
  return fn;
}

// A 3-D map over a contiguous bf16 (batch, rows, cols) tensor whose box is
// 64 columns x box_rows rows of one batch element, 128-byte swizzle.  A box
// reaching past `rows` (or `cols`) is filled with zeros: nothing outside the
// tensor is read.  Coordinates are (column, row, batch).  Returns false when
// the map cannot be made.
inline bool packed_tensor_map(CUtensorMap* map, const void* base, int batch, int rows, int cols, int box_rows) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)cols * 2 * rows};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- device: mbarriers, TMA, fences --------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier
// counts its phase "-1", parity 1, as complete).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16, 16-byte aligned ends) from global into shared
// memory; completes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Adds `bytes` (a multiple of 16) of f32 from shared memory into global
// memory, element by element, as one asynchronous bulk operation of this
// thread's current bulk group.
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// Wait until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until at most N of this thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy (wgmma, TMA) reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// 2^x by the MUFU unit, subnormal results flushed to zero (probabilities
// below 2^-126 that no bf16 product can tell from 0).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- device: wgmma -------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand tile at `p` (1024-byte aligned
// atoms; see the header note for LBO/SBO).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// K-major operand: k-step k starts 32 * k bytes into the tile.
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile, int k) {
  return desc_sw128(static_cast<const char*>(tile) + 32 * k, 16, 1024);
}

// MN-major operand (transpose bit set): k-step k starts 16 rows further.
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile, int k) {
  return desc_sw128(static_cast<const char*>(tile) + 2048 * k, 1024, 1024);
}

// Orders register writes (accumulators, A fragments) before the wgmmas
// issued after it.
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

// Wait until at most N committed wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving uses of wgmma results above the wait that
// completes them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A * B, m64nNk16, bf16 operands, f32 accumulators; scale_d = 0
// overwrites d.  _ss: A and B from shared memory; _rs: A from registers.
// kTransA / kTransB: 0 K-major, 1 MN-major.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(kTransB));
}

}  // namespace ucod
