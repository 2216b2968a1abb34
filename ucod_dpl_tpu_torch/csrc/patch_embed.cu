// K13: the ViT's 14 x 14 patch embed as one im2col GEMM with a bias (and
// position) epilogue, f32 pixels in, bf16 out, f32 accumulation.
//
// Replaces the TPU prototypes scripts/microbench/bench_patch_embed.py::
// pallas_patch and pallas_patch2 (kernels _patch_kernel, _patch_kernel2)
// and bench_patch_embed3.py::pallas_im2col (kernel _kernel), which compute
// one function:
//   y[b, i gw + j, n] = bf16(sum_{p, q, c} bf16(px[b, 14 i + p, 14 j + q, c])
//                            * W[(p * 14 + q) * 3 + c, n] + bias[n] (+ pos[i gw + j, n]))
// on NHWC pixels, with W the (588, D) weight in (p, q, c) order and the
// patches row-major (pallas_patch2 emitted them j-major and flipped them
// outside; pallas_im2col added the position embedding).  Mosaic refused the
// TPU kernels' in-VMEM relayout of 42-lane groups; Hopper has no such
// layout rule, so each thread gathers its own A fragments.  No product path
// calls it: the port's forward embeds with a cuDNN convolution
// (models/dino.py::_embed), as the JAX forward keeps its conv in XLA.
//
// What bounds it on the H100: at bs16 / 518px the 21,904 patches give 2 *
// 21904 * 588 * 768 = 19.78 GFLOP (0.020 ms at 989 TFLOP/s bf16) against
// 51.5 MB of f32 pixels, 33.6 MB of bf16 output, 2.1 MB of bf16 position
// and 0.9 MB of weight (0.026 ms at 3.35 TB/s): the bytes bound it.  The
// design, K6's persistent warp-specialised GEMM (csrc/layernorm_qkv.cu)
// with the im2col in its A operand:
//   * work tiles of 128 patches x 256 output columns, the column tiles of a
//     patch tile adjacent, so the CTAs that run together share its pixels
//     in L2; one producer warp issues TMA loads of W tiles (64 rows of K x
//     256 columns, four 64-column boxes with the 128-byte swizzle, read
//     MN-major by wgmma: W's natural (K, N) layout) into a three-stage ring;
//     K = 588 pads to ten 64-row tiles, the rows past 588 zero-filled by TMA
//     and the three all-zero k-steps of the last tile skipped;
//   * two consumer warpgroups own 64 patches each and gather their A
//     fragments straight from the NHWC pixels: a patch row is 42 contiguous
//     values (168 bytes, not a multiple of 16, so no TMA box fits it), and
//     the pairs of the m16n8k16 fragment never cross one (42 is even), so
//     each is one 8-byte load, rounded to bf16x2 in registers; a k-tile's
//     loads are in flight while the previous k-tile's wgmma m64n256k16 (A
//     from registers) run;
//   * the epilogue adds the f32 bias and the bf16 position row in f32,
//     rounds once into a 128-byte-swizzled staging tile and stores it with
//     TMA, which drops rows past the last patch (K6's epilogue).
// Patch 14, 3 channels; any H and W divisible by 14; D % 256 == 0.

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPatch = 14;
constexpr int kChannels = 3;
constexpr int kRowVals = kPatch * kChannels;      // 42 values of a patch row
constexpr int kDepth = kPatch * kRowVals;         // K = 588
constexpr int kDepthSteps = (kDepth + 15) / 16;   // 37 k-steps of 16, the last part zero
constexpr int kConsumers = 2;                     // warpgroups of 64 patches
constexpr int kBlockM = 64 * kConsumers;          // patches per work tile
constexpr int kBlockN = 256;                      // output columns per work tile
constexpr int kBlockK = 64;                       // W rows per stage
constexpr int kKTiles = (kDepth + kBlockK - 1) / kBlockK;  // 10
constexpr int kStages = 3;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr uint32_t kStageBytes = kBlockN * kBlockK * 2;
constexpr uint32_t kWLbo = kBlockK * 128;  // bytes between W's 64-column atoms along N
constexpr int kOutBar = 1;                 // named barriers 1, 2: each consumer warpgroup's epilogue

struct Smem {  // every tile 1024-byte aligned (128-byte swizzle atoms)
  bf16 w[kStages][kBlockN / 64][kBlockK * 64];
  bf16 out[kConsumers][kBlockN / 64][64 * 64];  // 64 x 64 boxes of the output tile
  uint64_t full[kStages], empty[kStages];
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // + alignment slack

// This thread's four 8-byte pixel pairs of k-step `step` (rows g and g + 8
// of its warp, columns 16 step + 2 tq and + 8: the m16n8k16 A fragment
// order), 0 past K.  `base0`/`base1`: the rows' patches' first pixel;
// `row_stride`: one image row, in floats.
__device__ __forceinline__ void load_step(float2 (&raw)[4], const float* base0, const float* base1, int step,
                                          int tq, int64_t row_stride) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = 16 * step + 2 * tq + 8 * h;
    if (col < kDepth) {
      const int64_t off = (int64_t)(col / kRowVals) * row_stride + col % kRowVals;
      raw[2 * h] = *reinterpret_cast<const float2*>(base0 + off);
      raw[2 * h + 1] = *reinterpret_cast<const float2*>(base1 + off);
    } else {
      raw[2 * h] = raw[2 * h + 1] = make_float2(0.f, 0.f);
    }
  }
}

__device__ __forceinline__ void load_tile(float2 (&raw)[4][4], const float* base0, const float* base1, int kt,
                                          int tq, int64_t row_stride) {
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    if (kt * 4 + kk < kDepthSteps) load_step(raw[kk], base0, base1, kt * 4 + kk, tq, row_stride);
  }
}

// One k-tile of a consumer warpgroup: rounds the pixels loaded for it into
// bf16 A fragments `a`, starts the next k-tile's loads into `raw`, waits for
// its W stage, issues its products into `acc` (overwriting it at the tile's
// first k-step), and frees the previous k-tile's stage once its products are
// done.
__device__ __forceinline__ void k_tile(float (&acc)[kBlockN / 2], uint32_t (&a)[4][4], float2 (&raw)[4][4],
                                       Smem& sm, int it, int kt, const float* base0, const float* base1, int tq,
                                       int lane, int64_t row_stride) {
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = ucod::pack_bf16x2(raw[kk][r].x, raw[kk][r].y);
  }
  if (kt + 1 < kKTiles) load_tile(raw, base0, base1, kt + 1, tq, row_stride);
  const int st = it % kStages;
  ucod::mbar_wait(&sm.full[st], (it / kStages) & 1);
  ucod::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    if (kt * 4 + kk < kDepthSteps) {
      ucod::wgmma_rs<kBlockN, 1>(acc, a[kk], ucod::desc_mnmajor(sm.w[st][0], kk, kWLbo), kt > 0 || kk > 0);
    }
  }
  ucod::wgmma_commit();
  ucod::wgmma_wait<1>();  // the previous k-tile's products are done
  if (kt > 0 && lane == 0) ucod::mbar_arrive(&sm.empty[(it + kStages - 1) % kStages]);
}

__global__ void __launch_bounds__(kThreads, 1)
    patch_embed_kernel(const float* __restrict__ px, const __grid_constant__ CUtensorMap tm_w,
                       const float* __restrict__ bias, const bf16* __restrict__ pos,
                       const __grid_constant__ CUtensorMap tm_o, int rows, int img_h, int img_w, int d, int n_ct,
                       int n_work) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (ucod::smem_addr(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      ucod::mbar_init(&sm.full[s], 1);
      ucod::mbar_init(&sm.empty[s], 4 * kConsumers);  // lane 0 of every consumer warp
    }
    ucod::fence_barrier_init();
  }
  __syncthreads();

  // Work tile t: patch tile t / n_ct, column tile t % n_ct; `it` counts the
  // k-tiles so far, across work tiles.
  if (wg == 0) {
    // producer: one thread keeps the ring of W tiles full
    ucod::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < n_work; t += gridDim.x) {
        const int n0 = t % n_ct * kBlockN;
        for (int kt = 0; kt < kKTiles; ++kt, ++it) {
          const int st = it % kStages;
          ucod::mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
          ucod::mbar_expect_tx(&sm.full[st], kStageBytes);
#pragma unroll
          for (int a = 0; a < kBlockN / 64; ++a) {
            ucod::tma_load_3d(sm.w[st][a], &tm_w, &sm.full[st], n0 + 64 * a, kt * kBlockK, 0);
          }
        }
      }
    }
  } else {
    ucod::reg_alloc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int tq = lane % 4;
    const int gw = img_w / kPatch;
    const int n_patches = img_h / kPatch * gw;  // per image
    const int64_t row_stride = (int64_t)img_w * kChannels;

    float acc[kBlockN / 2];  // 64 patches x 256 columns, f32
    uint32_t a[2][4][4];     // the A fragments of two k-tiles, in turn
    float2 raw[4][4];        // the pixels of the next k-tile, in flight
    int it = 0;
    for (int t = blockIdx.x; t < n_work; t += gridDim.x) {
      const int m0 = t / n_ct * kBlockM + 64 * c;  // this warpgroup's first patch
      const int r0 = m0 + 16 * warp + g;           // this thread's patches r0, r0 + 8
      const int n0 = t % n_ct * kBlockN;
      const float* base[2];
      int l_of[2];  // each patch's index in its image (the position row)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = min(r0 + 8 * r, rows - 1);  // a patch past the last is computed from the last, not stored
        const int bi = m / n_patches, l = m % n_patches;
        l_of[r] = l;
        base[r] = px + (((int64_t)bi * img_h + l / gw * kPatch) * img_w + l % gw * kPatch) * kChannels;
      }
      load_tile(raw, base[0], base[1], 0, tq, row_stride);
      int kt = 0;
      for (; kt + 1 < kKTiles; kt += 2) {
        k_tile(acc, a[0], raw, sm, it, kt, base[0], base[1], tq, lane, row_stride);
        k_tile(acc, a[1], raw, sm, it + 1, kt + 1, base[0], base[1], tq, lane, row_stride);
        it += 2;
      }
      if (kt < kKTiles) {
        k_tile(acc, a[0], raw, sm, it, kt, base[0], base[1], tq, lane, row_stride);
        ++it;
      }
      ucod::wgmma_wait<0>();
      ucod::fence_regs(acc);
      if (lane == 0) ucod::mbar_arrive(&sm.empty[(it + kStages - 1) % kStages]);

      // epilogue: the staging tile is free once the previous tile's stores
      // have read it
      if (tid == 0) ucod::bulk_wait_read<0>();
      ucod::named_sync(kOutBar + c, 128);
      uint8_t* stage = reinterpret_cast<uint8_t*>(sm.out[c]);
      const int srow = 16 * warp + g;  // rows srow, srow + 8 of the staging tile; both swizzle by g
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * tq;
        const float2 b2 = *reinterpret_cast<const float2*>(bias + n);
        float2 p2[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
        if (pos != nullptr) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint32_t pr = *reinterpret_cast<const uint32_t*>(pos + (int64_t)l_of[r] * d + n);
            p2[r] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pr));
          }
        }
        uint8_t* box = stage + (j / 8) * 64 * 64 * 2 + (((j % 8) ^ g) << 4) + 4 * tq;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          *reinterpret_cast<uint32_t*>(box + (srow + 8 * r) * 128) = ucod::pack_bf16x2(
              acc[4 * j + 2 * r] + b2.x + p2[r].x, acc[4 * j + 2 * r + 1] + b2.y + p2[r].y);
        }
      }
      ucod::fence_proxy_async();
      ucod::named_sync(kOutBar + c, 128);
      if (tid == 0) {
#pragma unroll
        for (int b = 0; b < kBlockN / 64; ++b) ucod::tma_store_3d(&tm_o, sm.out[c][b], n0 + 64 * b, m0, 0);
        ucod::bulk_commit();
      }
    }
    if (tid == 0) ucod::bulk_wait<0>();  // the last stores have completed
  }
}

}  // namespace

// px: contiguous f32 (batch, img_h, img_w, 3), 8-byte aligned, img_h and
// img_w multiples of 14; w: contiguous bf16 (588, d) in (p, q, c) row
// order; bias: f32 (d,); pos: contiguous bf16 (img_h / 14 * img_w / 14, d)
// or null; out: contiguous bf16 (batch, patches, d).  w and out 16-byte
// aligned, d % 256 == 0.  Launches min(work tiles, SMs) CTAs on `stream`;
// returns the launch's cudaError_t (cudaErrorInvalidValue for another shape
// or when a tensor map cannot be made).
extern "C" int ucod_patch_embed(const void* px, const void* w, const void* bias, const void* pos, void* out,
                                int batch, int img_h, int img_w, int d, void* stream) {
  if (batch < 1 || img_h < kPatch || img_w < kPatch || img_h % kPatch || img_w % kPatch || d < kBlockN ||
      d % kBlockN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t rows64 = (int64_t)batch * (img_h / kPatch) * (img_w / kPatch);
  if (rows64 > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (int)rows64;
  CUtensorMap tm_w, tm_o;
  if (!ucod::packed_tensor_map(&tm_w, w, 1, kDepth, d, kBlockK) ||
      !ucod::packed_tensor_map(&tm_o, out, 1, rows, d, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err =
      cudaFuncSetAttribute(patch_embed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  int device = 0, n_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_ct = d / kBlockN;
  const int n_work = (rows + kBlockM - 1) / kBlockM * n_ct;
  patch_embed_kernel<<<n_work < n_sm ? n_work : n_sm, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(px), tm_w, static_cast<const float*>(bias), static_cast<const bf16*>(pos), tm_o,
      rows, img_h, img_w, d, n_ct, n_work);
  return static_cast<int>(cudaGetLastError());
}
