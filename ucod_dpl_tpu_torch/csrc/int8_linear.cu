// K8, K9, K10, K11: the int8 (W8A8) kernels of the int8 serving path.
//
// Replace the TPU kernels of ucod_dpl_tpu/ops/fused_layers.py:
//   K8  _lnqkv_w8a8_kernel      LayerNorm + per-token int8 quantization + the
//                               three q/k/v products          -> ucod_layernorm_qkv_w8a8
//   K10 _quantdense_w8a8_kernel per-token quantization + one product (the
//                               attention out-projection)      -> ucod_quant_dense_w8a8
//   K9  _lnfc1gelu_w8a8_kernel  LayerNorm + quantization + fc1 + tanh GELU +
//                               per-token requantization       -> ucod_layernorm_fc1_gelu_w8a8
//   K11 _lnmlp_w8a8_kernel      K9, then fc2 on the codes kept on chip
//                                                              -> ucod_layernorm_mlp_w8a8
//
// Arithmetic, as the TPU kernels compute it: LayerNorm statistics in f32
// (mean, then mean((x - mean)^2), 1 / sqrt(var + eps), * scale + bias; h
// stays f32; the sums in an order the plain version repeats, and the
// reciprocal square root correctly rounded where the TPU used rsqrt);
// s = max(max|h| / 127, 1e-12) per row; codes = clip(rint(h / s), -127, 127)
// with a true division and ties to even.  The divisions by constants are
// multiplies, sum * (1 / d) and max * (1 / 127), as XLA computes them under
// jit; the plain versions do the same.  Exact s8 x s8 -> s32 products (the
// largest sum, 127^2 * 3072, is far inside int32); the epilogue
// acc * (s_x * w_s) + b in f32, in that order, rounded once at the store.
// Multiplies, adds and divisions that the plain PyTorch version rounds
// separately are written as __fmul_rn / __fadd_rn / __fdiv_rn, so nvcc
// contracts none of them into an fma.  Weights stay in the (out, in) layout
// of ops/quant.py: each output row is K-contiguous, the K-major B operand
// that s8 wgmma (which takes no transpose) wants.
//
// What bounds them on the H100, at bs16 / 518px (21,920 rows, D = 768,
// F = 3072): K8 78 GOP, K10 26 GOP, K9 103 GOP, 0.04-0.05 ms at the 1,979
// TOP/s int8 peak; K8 and K10 also store 101 and 34 MB of bf16 (0.03 and
// 0.01 ms at 3.35 TB/s), K9 67 MB of codes and evaluates 67 M accurate
// tanhf in its epilogue.  The design of K8, K9 and K10:
//   * a quantize pre-pass (one warp a row, quantize_row below) writes the
//     int8 codes (rows, d) and f32 scales (rows,) of LN(x) (K8, K9) or x
//     (K10) into scratch the wrapper allocates: the LayerNorm and the
//     quantization run once per row, not once per column tile, and the
//     codes (16.8 MB at bs16 518px) stay in the 50 MB L2 for the main
//     kernel, launched after it on the same stream (as a programmatic
//     dependent launch it was no faster on an H100: K8 0.1235 against
//     0.1263 ms, K9 0.3674 against 0.3723 at bs16 518px);
//   * K8 / K10 (quant_gemm_kernel): K6's shape in int8.  Persistent and
//     warp-specialised: work tiles of 128 rows x 256 output columns (9 per
//     row tile for K8's 3 x 768 columns, 3 for K10), column tiles of a row
//     tile adjacent so the CTAs that run together share codes in L2; one
//     producer warp keeps a three-stage TMA ring of codes (128 x 128 bytes)
//     and weight rows (256 x 128 bytes), 128-byte swizzled; two consumer
//     warpgroups of 64 rows run wgmma m64n256k32 .s32.s8.s8 with both
//     operands in shared memory; the epilogue rescales, adds the bias,
//     rounds to bf16 into a swizzled staging tile and stores it by TMA,
//     which drops rows past the last and drains under the next tile;
//   * K9 (fc1_gelu_quant_kernel): the requantization scale spans all F
//     outputs of a row, so the F columns of a 64-row tile are split over a
//     cluster of 8 CTAs (F / 8 columns each, F / 16 per consumer
//     warpgroup: wgmma m64n{64,96,128,192}k32 for F = 1024, 1536, 2048,
//     3072).  Every W1 byte a CTA stages feeds 64 rows (W1's L2 traffic at
//     bs16 518px: 343 x 2.36 MB = 0.81 GB).  Persistent: as many clusters
//     as the card holds at once (cudaOccupancyMaxActiveClusters: 15) walk
//     the row tiles, and the producer's ring runs on across tiles, so the
//     next tile's first stages load under this tile's epilogue.  The
//     epilogue works in registers: rescale + bias, tanh GELU (accurate
//     tanhf: tanh.approx's 2^-11 error would flip too many codes), the row
//     max |g| over the warpgroup's columns.  Each CTA publishes its partial
//     maxima in shared memory (two buffers, by tile parity) and arrives on
//     an mbarrier of every CTA of the cluster (release at cluster scope;
//     eight threads, one arrival each: one thread's eight in turn cost
//     0.04 ms more at bs16 518px);
//     once its own barrier has all the arrivals, a CTA reads its peers'
//     maxima through distributed shared memory.  (A barrier.cluster waits
//     for every live thread, the producer too, which runs ahead on the next
//     tile.)  A peer's arrival for the next tile says it has read this
//     tile's buffer, free again two tiles on; a last barrier.cluster keeps
//     every CTA alive until its peers have read.  Then the codes (true
//     division, ties to even) are staged in shared memory and stored by
//     TMA; the cluster's rank 0 writes the scales.  On an H100 the GELU and
//     the exchange, which nothing overlaps, take a quarter of K9's time;
//     clusters of 16 whose two consumer warpgroups take tiles in turn (so
//     one's epilogue runs under the other's products) were slower (0.53
//     against 0.41 ms at bs16 518px): 7 such clusters fit, and the exchange
//     over 16 CTAs cost more than the overlap gained.
//   * K11 keeps its first design (16 whole rows per CTA, mma.sync, the f32
//     GELU rows in shared memory, fc2 from the codes kept on chip).
// Rows at or past `rows` are never read (TMA zero-fills them) and never
// stored.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kQuantEps = 1e-12f;
constexpr float kInv127 = 1.f / 127.f;  // scales are max * (1 / 127), as XLA computes max / 127 under jit
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSmem = 232448;  // what one block may take on Hopper

__device__ __forceinline__ uint32_t quantize_code(float h, float s) {
  return static_cast<uint32_t>(
      static_cast<uint8_t>(static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(h, s)), -127.f), 127.f))));
}

__device__ __forceinline__ uint32_t quantize4(float a, float b, float c, float d, float s) {
  return quantize_code(a, s) | (quantize_code(b, s) << 8) | (quantize_code(c, s) << 16) | (quantize_code(d, s) << 24);
}

__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fmul_rn(amax, kInv127), kQuantEps);
}

// jax.nn.gelu(approximate=True) in f32: x * (0.5 * (1 + tanh(c * (x + 0.044715 x^3))))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float cube = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(x, __fmul_rn(0.044715f, cube)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(inner))));
}

// acc * (s_x * w_s) + b, rounded as the plain version rounds it
__device__ __forceinline__ float rescale(int acc, float sx, float ws, float b) {
  return __fadd_rn(__fmul_rn(static_cast<float>(acc), __fmul_rn(sx, ws)), b);
}

__device__ __forceinline__ float tree_sum8(const float (&a)[8]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), __fadd_rn(a[2], a[3])),
                   __fadd_rn(__fadd_rn(a[4], a[5]), __fadd_rn(a[6], a[7])));
}

// One row xr of k bf16 (k % 256 == 0, k <= 1024) -> k int8 codes at crow
// and the row's scale at *scale (global or shared memory), after a
// LayerNorm when kLN.  Called by a whole warp: lane l holds columns
// 256 j + 8 l .. + 7.
template <bool kLN>
__device__ __forceinline__ void quantize_row(const bf16* __restrict__ xr, const float* __restrict__ gamma,
                                             const float* __restrict__ beta, int k, float eps, int8_t* crow,
                                             float* scale) {
  const int lane = threadIdx.x & 31;
  const int chunks = k >> 8;
  xr += lane * 8;
  float v[4][8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < chunks) {
      const uint4 u = *reinterpret_cast<const uint4*>(xr + j * 256);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(p[i]);
        v[j][2 * i] = f.x;
        v[j][2 * i + 1] = f.y;
      }
    }
  }
  if (kLN) {
    // the statistics in a fixed order that the plain version repeats
    // (fused_layers.py::_kernel_row_sum): a pairwise tree over each lane's
    // 8 values, the chunks in order, then the xor butterfly of warp_sum
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < chunks) sum = __fadd_rn(sum, tree_sum8(v[j]));
    const float inv_k = __fdiv_rn(1.f, static_cast<float>(k));
    const float mean = __fmul_rn(ucod::warp_sum(sum), inv_k);
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < chunks) {
        float c2[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          v[j][i] = __fsub_rn(v[j][i], mean);
          c2[i] = __fmul_rn(v[j][i], v[j][i]);
        }
        sq = __fadd_rn(sq, tree_sum8(c2));
      }
    }
    const float var = __fmul_rn(ucod::warp_sum(sq), inv_k);
    const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < chunks) {
        const int c0 = j * 256 + lane * 8;
        const float4 g0 = *reinterpret_cast<const float4*>(gamma + c0);
        const float4 g1 = *reinterpret_cast<const float4*>(gamma + c0 + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(beta + c0);
        const float4 b1 = *reinterpret_cast<const float4*>(beta + c0 + 4);
        const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[j][i] = __fadd_rn(__fmul_rn(__fmul_rn(v[j][i], rstd), gv[i]), bv[i]);
      }
    }
  }
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < chunks)
#pragma unroll
      for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[j][i]));
  const float s = row_scale(ucod::warp_max(amax));
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < chunks) {
      const uint2 packed = make_uint2(quantize4(v[j][0], v[j][1], v[j][2], v[j][3], s),
                                      quantize4(v[j][4], v[j][5], v[j][6], v[j][7], s));
      *reinterpret_cast<uint2*>(crow + j * 256 + lane * 8) = packed;
    }
  }
  if (lane == 0) *scale = s;
}

// Rows [row0, row0 + nrows) of x (rows, k) bf16 -> int8 codes [nrows][ldc]
// and scales [nrows] in shared memory (K11's front), warp w taking rows w,
// w + 8, ...  Rows >= rows are not read: codes 0, scale 0.
template <bool kLN>
__device__ __forceinline__ void quantize_rows(const bf16* __restrict__ x, const float* __restrict__ gamma,
                                              const float* __restrict__ beta, int row0, int nrows, int rows, int k,
                                              float eps, int8_t* codes, int ldc, float* scales) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < nrows; r += kWarps) {
    int8_t* crow = codes + r * ldc;
    if (row0 + r >= rows) {
      for (int c = lane * 8; c < k; c += 256) *reinterpret_cast<uint2*>(crow + c) = make_uint2(0, 0);
      if (lane == 0) scales[r] = 0.f;
      continue;
    }
    quantize_row<kLN>(x + (int64_t)(row0 + r) * k, gamma, beta, k, eps, crow, scales + r);
  }
}

// The pre-pass of K8, K9 (kLN) and K10: one warp a row -> codes (rows, k),
// scales (rows,).  (Warps that walk several rows, the next one's loads in
// flight, took 0.042 against 0.029 ms at bs16 518px on an H100.)
template <bool kLN>
__global__ void __launch_bounds__(kThreads)
    quantize_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                         int8_t* __restrict__ codes, float* __restrict__ scales, int rows, int k, float eps) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  quantize_row<kLN>(x + (int64_t)row * k, gamma, beta, k, eps, codes + (int64_t)row * k, scales + row);
}

template <bool kLN>
cudaError_t launch_prepass(const void* x, const void* gamma, const void* beta, void* codes, void* scales, int rows,
                           int k, float eps, cudaStream_t s) {
  quantize_rows_kernel<kLN><<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<int8_t*>(codes), static_cast<float*>(scales), rows, k, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K8 / K10 main kernel: persistent, TMA + wgmma m64n256k32 s8
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;             // warpgroups of 64 rows
constexpr int kBlockM = 64 * kConsumers;  // rows per work tile
constexpr int kBlockN = 256;              // output columns per work tile
constexpr int kBlockK = 128;              // bytes (int8 values) of K per stage: one 128-byte swizzle row
constexpr int kStages = 3;
constexpr int kMainThreads = 128 * (1 + kConsumers);
constexpr uint32_t kGemmStageBytes = (kBlockM + kBlockN) * kBlockK;
constexpr int kOutBar = 1;     // named barriers 1, 2: each consumer warpgroup's epilogue
constexpr int kRowmaxBar = 3;  // K9: both consumer warpgroups, around the row-max exchange

// The main kernels' launch configuration (after the pre-pass on the same
// stream), in clusters of `cluster` (at most 8) CTAs along x when
// cluster > 1; `attr` holds the cluster's shape and outlives the result.
cudaLaunchConfig_t main_config(int grid, int cluster, size_t smem, cudaStream_t s, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kMainThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

constexpr int kMaxDevices = 64;

// The per-process set-up of a main kernel, done once per device rather than
// on every call: its dynamic shared memory allowed (cudaFuncSetAttribute
// applies to the current device), then count(device), a count the launches
// need (SMs, clusters at once), kept in cache[device] once positive.
// Returns the count, or a cudaError_t negated.
template <typename Kernel, typename Count>
int once_per_device(std::atomic<int> (&cache)[kMaxDevices], Kernel kernel, size_t smem, Count count) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return -static_cast<int>(cudaErrorInvalidDevice);
  int v = cache[device].load(std::memory_order_relaxed);
  if (v > 0) return v;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  v = count(device);
  if (v > 0) cache[device].store(v, std::memory_order_relaxed);
  return v;
}

// A count from once_per_device that is not positive, as a cudaError_t.
int count_error(int v) { return v < 0 ? -v : static_cast<int>(cudaErrorInvalidConfiguration); }

struct GemmSmem {  // every tile 1024-byte aligned (128-byte swizzle atoms)
  int8_t a[kStages][kBlockM * kBlockK];
  int8_t b[kStages][kBlockN * kBlockK];
  bf16 out[kConsumers][kBlockN / 64][64 * 64];  // 64 x 64 boxes of the output tile
  uint64_t full[kStages], empty[kStages];
};
constexpr size_t kGemmSmemBytes = sizeof(GemmSmem) + 1024;  // + alignment slack

struct Vec3 {
  const float* p[3];
};

template <typename T>
__device__ __forceinline__ T& aligned_smem(uint8_t* raw) {
  return *reinterpret_cast<T*>(raw + ((1024 - (ucod::smem_addr(raw) & 1023)) & 1023));
}

// out_p = codes W_p^T * (s_x * w_s_p) + b_p for the projection p that each
// work tile's 256 columns fall in; n columns per projection, n_ct column
// tiles per row tile.
__global__ void __launch_bounds__(kMainThreads, 1)
    quant_gemm_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w0,
                      const __grid_constant__ CUtensorMap tm_w1, const __grid_constant__ CUtensorMap tm_w2,
                      const __grid_constant__ CUtensorMap tm_o0, const __grid_constant__ CUtensorMap tm_o1,
                      const __grid_constant__ CUtensorMap tm_o2, const float* __restrict__ sx, Vec3 wscale,
                      Vec3 bias, int rows, int k, int n, int n_ct, int n_work) {
  extern __shared__ uint8_t smem_raw[];
  GemmSmem& sm = aligned_smem<GemmSmem>(smem_raw);
  const int wg = threadIdx.x / 128;
  const int n_k = k / kBlockK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      ucod::mbar_init(&sm.full[s], 1);
      ucod::mbar_init(&sm.empty[s], 4 * kConsumers);  // lane 0 of every consumer warp
    }
    ucod::fence_barrier_init();
  }
  __syncthreads();

  // Work tile t: row tile t / n_ct, column tile t % n_ct; `it` counts the
  // k-tiles so far, across work tiles.
  if (wg == 0) {
    // producer: one thread keeps the ring full
    ucod::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < n_work; t += gridDim.x) {
        const int m0 = t / n_ct * kBlockM;
        const int col = t % n_ct * kBlockN;
        const int which = col / n;
        const CUtensorMap* tm_w = which == 0 ? &tm_w0 : which == 1 ? &tm_w1 : &tm_w2;
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int st = it % kStages;
          ucod::mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
          ucod::mbar_expect_tx(&sm.full[st], kGemmStageBytes);
          ucod::tma_load_3d(sm.b[st], tm_w, &sm.full[st], kt * kBlockK, col - which * n, 0);
          ucod::tma_load_3d(sm.a[st], &tm_a, &sm.full[st], kt * kBlockK, m0, 0);
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

    int acc[kBlockN / 2];  // 64 rows x 256 columns, s32
    int it = 0;
    for (int t = blockIdx.x; t < n_work; t += gridDim.x) {
      const int m0 = t / n_ct * kBlockM + 64 * c;  // this warpgroup's first row
      const int r0 = m0 + 16 * warp + g;           // this thread's rows r0, r0 + 8
      const int col = t % n_ct * kBlockN;
      const int which = col / n;
      const int n0 = col - which * n;
      for (int kt = 0; kt < n_k; ++kt, ++it) {
        const int st = it % kStages;
        ucod::mbar_wait(&sm.full[st], (it / kStages) & 1);
        ucod::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockK / 32; ++kk) {
          ucod::wgmma_s8<kBlockN>(acc, ucod::desc_kmajor(sm.a[st] + 64 * c * kBlockK, kk),
                                  ucod::desc_kmajor(sm.b[st], kk), kt > 0 || kk > 0);
        }
        ucod::wgmma_commit();
        ucod::wgmma_wait<1>();  // the previous k-tile's products are done
        if (kt > 0 && lane == 0) ucod::mbar_arrive(&sm.empty[(it + kStages - 1) % kStages]);
      }
      ucod::wgmma_wait<0>();
      ucod::fence_regs(acc);
      if (lane == 0) ucod::mbar_arrive(&sm.empty[(it + kStages - 1) % kStages]);

      // epilogue: the staging tile is free once the previous tile's stores
      // have read it
      const float sx0 = r0 < rows ? sx[r0] : 0.f;
      const float sx1 = r0 + 8 < rows ? sx[r0 + 8] : 0.f;
      if (tid == 0) ucod::bulk_wait_read<0>();
      ucod::named_sync(kOutBar + c, 128);
      const float* ws = which == 0 ? wscale.p[0] : which == 1 ? wscale.p[1] : wscale.p[2];
      const float* bs = which == 0 ? bias.p[0] : which == 1 ? bias.p[1] : bias.p[2];
      uint8_t* stage = reinterpret_cast<uint8_t*>(sm.out[c]);
      const int srow = 16 * warp + g;  // rows srow, srow + 8 of the staging tile; both swizzle by g
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        const float2 w2 = *reinterpret_cast<const float2*>(ws + n0 + 8 * j + 2 * tq);
        const float2 b2 = *reinterpret_cast<const float2*>(bs + n0 + 8 * j + 2 * tq);
        uint8_t* box = stage + (j / 8) * 64 * 64 * 2 + (((j % 8) ^ g) << 4) + 4 * tq;
        *reinterpret_cast<uint32_t*>(box + srow * 128) = ucod::pack_bf16x2(
            rescale(acc[4 * j], sx0, w2.x, b2.x), rescale(acc[4 * j + 1], sx0, w2.y, b2.y));
        *reinterpret_cast<uint32_t*>(box + (srow + 8) * 128) = ucod::pack_bf16x2(
            rescale(acc[4 * j + 2], sx1, w2.x, b2.x), rescale(acc[4 * j + 3], sx1, w2.y, b2.y));
      }
      ucod::fence_proxy_async();
      ucod::named_sync(kOutBar + c, 128);
      if (tid == 0) {
        const CUtensorMap* tm_o = which == 0 ? &tm_o0 : which == 1 ? &tm_o1 : &tm_o2;
#pragma unroll
        for (int a = 0; a < kBlockN / 64; ++a) ucod::tma_store_3d(tm_o, sm.out[c][a], n0 + 64 * a, m0, 0);
        ucod::bulk_commit();
      }
    }
    if (tid == 0) ucod::bulk_wait<0>();  // the last stores have completed
  }
}

// The pre-pass (LN when kLN), then the main kernel over n_proj projections
// of n columns each.  Checks every shape before the first launch.
template <bool kLN>
int quant_gemm(const void* x, const void* gamma, const void* beta, const void* const (&w)[3],
               const float* const (&ws)[3], const float* const (&b)[3], void* const (&o)[3], void* codes,
               void* scales, int n_proj, int rows, int k, int n, float eps, void* stream) {
  if (k % 256 != 0 || k > 1024 || n % kBlockN != 0 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_a, tm_w[3], tm_o[3];
  if (!ucod::int8_tensor_map(&tm_a, codes, rows, k, kBlockM)) return static_cast<int>(cudaErrorInvalidValue);
  for (int p = 0; p < 3; ++p) {
    if (p >= n_proj) {  // never read: every column tile falls in a projection < n_proj
      tm_w[p] = tm_w[0];
      tm_o[p] = tm_o[0];
    } else if (!ucod::int8_tensor_map(&tm_w[p], w[p], n, k, kBlockN) ||
               !ucod::packed_tensor_map(&tm_o[p], o[p], 1, rows, n, 64)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  static std::atomic<int> sm_counts[kMaxDevices];
  const int n_sm = once_per_device(sm_counts, quant_gemm_kernel, kGemmSmemBytes, [](int device) {
    int count = 0;
    const cudaError_t e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    return e == cudaSuccess ? count : -static_cast<int>(e);
  });
  if (n_sm <= 0) return count_error(n_sm);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_prepass<kLN>(x, gamma, beta, codes, scales, rows, k, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_ct = n_proj * n / kBlockN;
  const int n_work = (rows + kBlockM - 1) / kBlockM * n_ct;
  const Vec3 wsv = {{ws[0], ws[n_proj > 1 ? 1 : 0], ws[n_proj > 2 ? 2 : 0]}};
  const Vec3 bv = {{b[0], b[n_proj > 1 ? 1 : 0], b[n_proj > 2 ? 2 : 0]}};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = main_config(n_work < n_sm ? n_work : n_sm, 1, kGemmSmemBytes, s, &attr);
  return static_cast<int>(cudaLaunchKernelEx(&cfg, quant_gemm_kernel, tm_a, tm_w[0], tm_w[1], tm_w[2], tm_o[0],
                                             tm_o[1], tm_o[2], static_cast<const float*>(scales), wsv, bv, rows, k,
                                             n, n_ct, n_work));
}

// ---------------------------------------------------------------------------
// K9 main kernel: a 64-row tile's F columns over a cluster of CTAs
// ---------------------------------------------------------------------------

constexpr int kCluster = 8;  // CTAs sharing one row tile's row maxima
constexpr int kTileM = 64;   // rows per tile
constexpr int kColumnParts = kCluster * kConsumers;  // F = kColumnParts * N, N the wgmma width of a consumer

template <int kN>
struct MlpSmem {  // every operand tile 1024-byte aligned
  int8_t a[kStages][kTileM * kBlockK];
  int8_t b[kStages][kConsumers][kN * kBlockK];
  int8_t out[kConsumers][64 * kN];  // each consumer's 64 x kN codes, row-major (unswizzled TMA box)
  // by tile parity: each consumer's partial row maxima (read by the whole
  // cluster), and an mbarrier with one arrival from each CTA of the cluster,
  // its partial maxima written
  float part[2][kConsumers][64];
  float rowmax[kTileM];
  uint64_t full[kStages], empty[kStages];
  uint64_t maxima[2];
};

template <int kN>
__global__ void __launch_bounds__(kMainThreads, 1)
    fc1_gelu_quant_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
                          const __grid_constant__ CUtensorMap tm_o, const float* __restrict__ sx,
                          const float* __restrict__ w1s, const float* __restrict__ b1,
                          float* __restrict__ out_scales, int rows, int k, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  MlpSmem<kN>& sm = aligned_smem<MlpSmem<kN>>(smem_raw);
  constexpr uint32_t kStageBytes = (kTileM + kConsumers * kN) * kBlockK;
  const int wg = threadIdx.x / 128;
  const int n_k = k / kBlockK;
  const uint32_t rank = ucod::cluster_ctarank();
  const int cluster = blockIdx.x / kCluster;  // the cluster takes row tiles cluster, + n_clusters, ...
  const int n_clusters = gridDim.x / kCluster;
  const int col0 = rank * kConsumers * kN;  // this CTA's first column

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      ucod::mbar_init(&sm.full[s], 1);
      ucod::mbar_init(&sm.empty[s], 4 * kConsumers);  // lane 0 of every consumer warp
    }
    ucod::mbar_init(&sm.maxima[0], kCluster);
    ucod::mbar_init(&sm.maxima[1], kCluster);
    ucod::fence_barrier_init();
  }
  ucod::cluster_sync();  // every CTA's barriers exist before a peer arrives on them

  if (wg == 0) {
    // producer: one thread keeps the ring full, across the cluster's tiles
    ucod::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = cluster; t < n_tiles; t += n_clusters) {
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int st = it % kStages;
          ucod::mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
          ucod::mbar_expect_tx(&sm.full[st], kStageBytes);
#pragma unroll
          for (int i = 0; i < kConsumers; ++i)
            ucod::tma_load_3d(sm.b[st][i], &tm_w, &sm.full[st], kt * kBlockK, col0 + i * kN, 0);
          ucod::tma_load_3d(sm.a[st], &tm_a, &sm.full[st], kt * kBlockK, t * kTileM, 0);
        }
      }
    }
    return;  // exited threads do not hold up the last cluster barrier
  }

  ucod::reg_alloc<240>();
  const int c = wg - 1;  // this consumer's kN-column part of the CTA's columns
  const int ct = threadIdx.x - 128;
  const int tid = ct % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int tq = lane % 4;

  int acc[kN / 2];
  int it = 0;
  for (int t = cluster, j = 0; t < n_tiles; t += n_clusters, ++j) {
    const int m0 = t * kTileM;
    for (int kt = 0; kt < n_k; ++kt, ++it) {
      const int st = it % kStages;
      ucod::mbar_wait(&sm.full[st], (it / kStages) & 1);
      ucod::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 32; ++kk) {
        ucod::wgmma_s8<kN>(acc, ucod::desc_kmajor(sm.a[st], kk), ucod::desc_kmajor(sm.b[st][c], kk),
                           kt > 0 || kk > 0);
      }
      ucod::wgmma_commit();
      ucod::wgmma_wait<1>();
      if (kt > 0 && lane == 0) ucod::mbar_arrive(&sm.empty[(it + kStages - 1) % kStages]);
    }
    ucod::wgmma_wait<0>();
    ucod::fence_regs(acc);
    if (lane == 0) ucod::mbar_arrive(&sm.empty[(it + kStages - 1) % kStages]);  // the next tile loads

    // epilogue in registers: h1 = acc * (s_x * w1_s) + b1, g = gelu(h1), and
    // this thread's rows' max |g| (rows lr and lr + 8 of the tile's 64)
    const int lr = 16 * warp + g;
    const int r0 = m0 + lr;
    const float s0 = r0 < rows ? sx[r0] : 0.f;
    const float s1 = r0 + 8 < rows ? sx[r0 + 8] : 0.f;
    const int cbase = col0 + c * kN + 2 * tq;
    float v[kN / 2];
    float m_0 = 0.f, m_1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < kN / 8; ++jj) {
      const float2 w2 = *reinterpret_cast<const float2*>(w1s + cbase + 8 * jj);
      const float2 b2 = *reinterpret_cast<const float2*>(b1 + cbase + 8 * jj);
      v[4 * jj] = gelu_tanh(rescale(acc[4 * jj], s0, w2.x, b2.x));
      v[4 * jj + 1] = gelu_tanh(rescale(acc[4 * jj + 1], s0, w2.y, b2.y));
      v[4 * jj + 2] = gelu_tanh(rescale(acc[4 * jj + 2], s1, w2.x, b2.x));
      v[4 * jj + 3] = gelu_tanh(rescale(acc[4 * jj + 3], s1, w2.y, b2.y));
      m_0 = fmaxf(m_0, fmaxf(fabsf(v[4 * jj]), fabsf(v[4 * jj + 1])));
      m_1 = fmaxf(m_1, fmaxf(fabsf(v[4 * jj + 2]), fabsf(v[4 * jj + 3])));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m_0 = fmaxf(m_0, __shfl_xor_sync(0xffffffffu, m_0, off));
      m_1 = fmaxf(m_1, __shfl_xor_sync(0xffffffffu, m_1, off));
    }
    float (&part)[kConsumers][64] = sm.part[j & 1];
    if (tq == 0) {
      part[c][lr] = m_0;
      part[c][lr + 8] = m_1;
    }
    // the cluster's row maxima: once this CTA's partial maxima are written,
    // it arrives on every CTA's barrier of this parity; once its own has
    // all kCluster arrivals, each row's max is gathered from all the CTAs'
    // shared memory (a peer's arrival for the next tile says it has read
    // this buffer, free again two tiles on); a CTA barrier publishes rowmax
    ucod::named_sync(kRowmaxBar, 128 * kConsumers);
    if (ct < kCluster) ucod::mbar_arrive_cluster(&sm.maxima[j & 1], ct);
    if (ct < kTileM) {
      ucod::mbar_wait_cluster(&sm.maxima[j & 1], (j >> 1) & 1);
      float m = 0.f;
#pragma unroll
      for (int q = 0; q < kCluster; ++q) {
        m = fmaxf(m, fmaxf(ucod::ld_shared_cluster_f32(&part[0][ct], q), ucod::ld_shared_cluster_f32(&part[1][ct], q)));
      }
      sm.rowmax[ct] = m;
    }
    ucod::named_sync(kRowmaxBar, 128 * kConsumers);
    const float sc0 = row_scale(sm.rowmax[lr]);
    const float sc1 = row_scale(sm.rowmax[lr + 8]);

    // the staging tile is free once the previous tile's store has read it
    if (tid == 0) ucod::bulk_wait_read<0>();
    ucod::named_sync(kOutBar + c, 128);
    int8_t* stage = sm.out[c];
#pragma unroll
    for (int jj = 0; jj < kN / 8; ++jj) {
      const int col = 8 * jj + 2 * tq;
      *reinterpret_cast<uint16_t*>(stage + lr * kN + col) =
          static_cast<uint16_t>(quantize_code(v[4 * jj], sc0) | (quantize_code(v[4 * jj + 1], sc0) << 8));
      *reinterpret_cast<uint16_t*>(stage + (lr + 8) * kN + col) =
          static_cast<uint16_t>(quantize_code(v[4 * jj + 2], sc1) | (quantize_code(v[4 * jj + 3], sc1) << 8));
    }
    ucod::fence_proxy_async();
    ucod::named_sync(kOutBar + c, 128);
    if (tid == 0) {
      ucod::tma_store_3d(&tm_o, stage, col0 + c * kN, m0, 0);
      ucod::bulk_commit();
    }
    if (rank == 0 && c == 0 && tq == 0) {
      if (r0 < rows) out_scales[r0] = sc0;
      if (r0 + 8 < rows) out_scales[r0 + 8] = sc1;
    }
  }
  ucod::cluster_sync();  // no CTA exits while a peer may still read its partial maxima
  if (tid == 0) ucod::bulk_wait<0>();
}

// K9's main kernel at width kN: its shared memory (+ alignment slack), and
// how many of its clusters the current card holds at once (set up once per
// device; a count, or a cudaError_t negated).
template <int kN>
constexpr size_t mlp_smem_bytes() {
  return sizeof(MlpSmem<kN>) + 1024;
}

template <int kN>
int k9_clusters() {
  static std::atomic<int> cache[kMaxDevices];
  return once_per_device(cache, fc1_gelu_quant_kernel<kN>, mlp_smem_bytes<kN>(), [](int) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = main_config(kCluster * 64, kCluster, mlp_smem_bytes<kN>(), nullptr, &attr);
    int clusters = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, fc1_gelu_quant_kernel<kN>, &cfg);
    return e == cudaSuccess ? clusters : -static_cast<int>(e);
  });
}

// fn(std::integral_constant<int, kN>()) at the K9 width kN = f / kColumnParts,
// one the main kernel is built for (64, 96, 128, 192: f = 1024, 1536, 2048,
// 3072); cudaErrorInvalidValue for any other f.
template <typename Fn>
int with_k9_width(int f, Fn fn) {
  switch (f % kColumnParts == 0 ? f / kColumnParts : 0) {
    case 64:
      return fn(std::integral_constant<int, 64>());
    case 96:
      return fn(std::integral_constant<int, 96>());
    case 128:
      return fn(std::integral_constant<int, 128>());
    case 192:
      return fn(std::integral_constant<int, 192>());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// K11 (the first design): 16 whole rows per CTA, mma.sync
// ---------------------------------------------------------------------------

// Weight rows [n0, n0 + BN), bytes [k0, k0 + BK) of an (N, k) int8 matrix
// into a [BN][LDW] shared tile.
template <int BN, int BK, int LDW>
__device__ __forceinline__ void load_w_tile(int8_t* dst, const int8_t* w, int n0, int k0, int k) {
  constexpr int kPerRow = BK / 16;
  for (int idx = threadIdx.x; idx < BN * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx - r * kPerRow) * 16;
    ucod::cp_async16(dst + r * LDW + c, w + (int64_t)(n0 + r) * k + k0 + c, true);
  }
}

constexpr int kRows = 16;
constexpr int kChunk = 128;  // output columns per pass; warp w owns 16 of them
constexpr int kBK2 = 64;
constexpr int kLdw2 = kBK2 + 16;  // 80-byte rows: conflict-free ldmatrix

int mlp_smem(int d, int f) {
  return 2 * kChunk * kLdw2 + kRows * (f + 4) * 4 + kRows * (d + 16) + 2 * kRows * 4;
}

// acc = A (16 x kdim int8, shared, row stride lda bytes) times the transpose
// of the (n_total, kdim) int8 matrix w, 128 columns at a time: after each
// chunk epi(chunk, acc) is called with this warp's 16 x 16 block (rows g and
// g + 8, columns chunk * 128 + 16 warp + 8 nj + 2 t, + 1).  W is streamed in
// 64-byte K slices, double-buffered across chunk boundaries.
template <typename Epi>
__device__ __forceinline__ void gemm_rows16(const int8_t* a, int lda, const int8_t* __restrict__ w,
                                            int n_total, int kdim, int8_t* wstage, Epi epi) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k_tiles = kdim / kBK2;
  const int stages = (n_total / kChunk) * k_tiles;
  const int8_t* a_base = a + (lane & 15) * lda + (lane >> 4) * 16;
  const int b_off = (warp * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdw2 + ((lane >> 3) & 1) * 16;
  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};

  load_w_tile<kChunk, kBK2, kLdw2>(wstage, w, 0, 0, kdim);
  ucod::cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    const int chunk = s / k_tiles;
    const int kt = s - chunk * k_tiles;
    if (s + 1 < stages) {
      const int nc = (s + 1) / k_tiles;
      load_w_tile<kChunk, kBK2, kLdw2>(wstage + ((s + 1) & 1) * kChunk * kLdw2, w, nc * kChunk,
                                       (s + 1 - nc * k_tiles) * kBK2, kdim);
      ucod::cp_async_commit();
      ucod::cp_async_wait<1>();
    } else {
      ucod::cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* wt = wstage + (s & 1) * kChunk * kLdw2 + b_off;
#pragma unroll
    for (int kk = 0; kk < kBK2 / 32; ++kk) {
      uint32_t af[4], b[4];
      ucod::ldmatrix_x4(af, a_base + kt * kBK2 + kk * 32);
      ucod::ldmatrix_x4(b, wt + kk * 32);
      ucod::mma_s8_16832(acc[0], af, b[0], b[1]);
      ucod::mma_s8_16832(acc[1], af, b[2], b[3]);
    }
    __syncthreads();
    if (kt == k_tiles - 1) {
      epi(chunk, acc);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) acc[nj][0] = acc[nj][1] = acc[nj][2] = acc[nj][3] = 0;
    }
  }
}

// K11's front: LN + quantization of 16 rows, fc1, GELU
// into gs (f32, [16][f + 4]) and each row's max |g| into rowmax (as int bits,
// all values >= 0).  Ends with a barrier.
__device__ __forceinline__ void ln_fc1_gelu_rows(const __nv_bfloat16* __restrict__ x,
                                                 const float* __restrict__ gamma,
                                                 const float* __restrict__ beta,
                                                 const int8_t* __restrict__ w1,
                                                 const float* __restrict__ w1s,
                                                 const float* __restrict__ b1, int row0, int rows,
                                                 int d, int f, float eps, unsigned char* smem,
                                                 float*& gs, float*& rowmax) {
  int8_t* wstage = reinterpret_cast<int8_t*>(smem);
  gs = reinterpret_cast<float*>(smem + 2 * kChunk * kLdw2);
  const int ldg = f + 4;
  int8_t* codes = reinterpret_cast<int8_t*>(gs + kRows * ldg);
  const int ldc = d + 16;
  float* sx = reinterpret_cast<float*>(codes + kRows * ldc);
  rowmax = sx + kRows;
  if (threadIdx.x < kRows) rowmax[threadIdx.x] = 0.f;
  quantize_rows<true>(x, gamma, beta, row0, kRows, rows, d, eps, codes, ldc, sx);
  // (gemm_rows16's first barrier orders the codes, sx and rowmax above)

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int warp = threadIdx.x >> 5;
  float m0 = 0.f, m1 = 0.f;
  float* gsl = gs;
  gemm_rows16(codes, ldc, w1, f, d, wstage, [&](int chunk, const int (&acc)[2][4]) {
    const float s0 = sx[g], s1 = sx[g + 8];
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      const int c = chunk * kChunk + warp * 16 + nj * 8 + 2 * t;
      const float wa = w1s[c], wb = w1s[c + 1], ba = b1[c], bb = b1[c + 1];
      const float2 lo = make_float2(
          gelu_tanh(__fadd_rn(__fmul_rn(static_cast<float>(acc[nj][0]), __fmul_rn(s0, wa)), ba)),
          gelu_tanh(__fadd_rn(__fmul_rn(static_cast<float>(acc[nj][1]), __fmul_rn(s0, wb)), bb)));
      const float2 hi = make_float2(
          gelu_tanh(__fadd_rn(__fmul_rn(static_cast<float>(acc[nj][2]), __fmul_rn(s1, wa)), ba)),
          gelu_tanh(__fadd_rn(__fmul_rn(static_cast<float>(acc[nj][3]), __fmul_rn(s1, wb)), bb)));
      *reinterpret_cast<float2*>(gsl + g * ldg + c) = lo;
      *reinterpret_cast<float2*>(gsl + (g + 8) * ldg + c) = hi;
      m0 = fmaxf(m0, fmaxf(fabsf(lo.x), fabsf(lo.y)));
      m1 = fmaxf(m1, fmaxf(fabsf(hi.x), fabsf(hi.y)));
    }
  });
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  if (t == 0) {
    atomicMax(reinterpret_cast<int*>(rowmax + g), __float_as_int(m0));
    atomicMax(reinterpret_cast<int*>(rowmax + g + 8), __float_as_int(m1));
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    ln_mlp_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, const int8_t* __restrict__ w1,
                  const float* __restrict__ w1s, const float* __restrict__ b1,
                  const int8_t* __restrict__ w2, const float* __restrict__ w2s,
                  const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int rows, int d,
                  int f, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.x * kRows;
  float* gs;
  float* rowmax;
  ln_fc1_gelu_rows(x, gamma, beta, w1, w1s, b1, row0, rows, d, f, eps, smem, gs, rowmax);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ldg = f + 4;
  // g -> codes in place: row r's codes take the first f bytes of its own f32
  // row.  A warp walks its row in 128-value steps; step j writes the bytes of
  // values 32 j .. 32 j + 31, all read at step j or before (hence the
  // __syncwarp between the reads and the writes of a step).
  for (int r = warp; r < kRows; r += kWarps) {
    const float s = row_scale(rowmax[r]);
    float* grow = gs + r * ldg;
    int8_t* crow = reinterpret_cast<int8_t*>(grow);
    for (int c = lane * 4; c < f; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(grow + c);
      __syncwarp();
      *reinterpret_cast<uint32_t*>(crow + c) = quantize4(v.x, v.y, v.z, v.w, s);
      __syncwarp();
    }
  }
  // (gemm_rows16's first barrier orders the codes before fc2 reads them; the
  // weight stages were last read before ln_fc1_gelu_rows' final barrier)

  const int g = lane >> 2;
  const int t = lane & 3;
  const float s0 = row_scale(rowmax[g]);
  const float s1 = row_scale(rowmax[g + 8]);
  const int r0 = row0 + g;
  gemm_rows16(reinterpret_cast<const int8_t*>(gs), ldg * 4, w2, d, f, reinterpret_cast<int8_t*>(smem),
              [&](int chunk, const int (&acc)[2][4]) {
#pragma unroll
                for (int nj = 0; nj < 2; ++nj) {
                  const int c = chunk * kChunk + warp * 16 + nj * 8 + 2 * t;
                  const float wa = w2s[c], wb = w2s[c + 1], ba = b2[c], bb = b2[c + 1];
                  if (r0 < rows) {
                    *reinterpret_cast<uint32_t*>(out + (int64_t)r0 * d + c) = ucod::pack_bf16x2(
                        __fadd_rn(__fmul_rn(static_cast<float>(acc[nj][0]), __fmul_rn(s0, wa)), ba),
                        __fadd_rn(__fmul_rn(static_cast<float>(acc[nj][1]), __fmul_rn(s0, wb)), bb));
                  }
                  if (r0 + 8 < rows) {
                    *reinterpret_cast<uint32_t*>(out + (int64_t)(r0 + 8) * d + c) = ucod::pack_bf16x2(
                        __fadd_rn(__fmul_rn(static_cast<float>(acc[nj][2]), __fmul_rn(s1, wa)), ba),
                        __fadd_rn(__fmul_rn(static_cast<float>(acc[nj][3]), __fmul_rn(s1, wb)), bb));
                  }
                }
              });
}

int check_mlp(int rows, int d, int f) {
  if (rows <= 0 || d % 256 != 0 || d > 1024 || f % kChunk != 0 || mlp_smem(d, f) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// The pre-pass (LN + quantization into x_codes, x_scales), then the main
// kernel at width kN.  Checks every shape before the first launch.
template <int kN>
int fc1_gelu_quant(const void* x, const void* gamma, const void* beta, const void* w1, const void* w1s,
                   const void* b1, void* codes, void* scales, void* x_codes, void* x_scales, int rows, int d, int f,
                   float eps, cudaStream_t s) {
  CUtensorMap tm_a, tm_w, tm_o;
  if (!ucod::int8_tensor_map(&tm_a, x_codes, rows, d, kTileM) || !ucod::int8_tensor_map(&tm_w, w1, f, d, kN) ||
      !ucod::int8_tensor_map(&tm_o, codes, rows, f, 64, kN, false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int max_clusters = k9_clusters<kN>();
  if (max_clusters <= 0) return count_error(max_clusters);
  const cudaError_t err = launch_prepass<true>(x, gamma, beta, x_codes, x_scales, rows, d, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (rows + kTileM - 1) / kTileM;
  const int n_clusters = n_tiles < max_clusters ? n_tiles : max_clusters;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = main_config(n_clusters * kCluster, kCluster, mlp_smem_bytes<kN>(), s, &attr);
  return static_cast<int>(cudaLaunchKernelEx(&cfg, fc1_gelu_quant_kernel<kN>, tm_a, tm_w, tm_o,
                                             static_cast<const float*>(x_scales), static_cast<const float*>(w1s),
                                             static_cast<const float*>(b1), static_cast<float*>(scales), rows, d,
                                             n_tiles));
}

}  // namespace

// x: contiguous bf16 (rows, d); gamma/beta: f32 (d,); wq/wk/wv: int8 (d, d)
// in (out, in) layout; sq/sk/sv (per-output-channel scales) and bq/bk/bv:
// f32 (d,); oq/ok/ov: bf16 (rows, d); codes: int8 scratch (rows, d) and
// scales: f32 scratch (rows,), written by the pre-pass and read by the main
// kernel.  d % 256 == 0, d <= 1024, 16-byte aligned pointers.  Launches both
// kernels on `stream`; returns the first nonzero cudaError_t.
extern "C" int ucod_layernorm_qkv_w8a8(const void* x, const void* gamma, const void* beta, const void* wq,
                                       const void* wk, const void* wv, const void* sq, const void* sk,
                                       const void* sv, const void* bq, const void* bk, const void* bv, void* oq,
                                       void* ok, void* ov, void* codes, void* scales, int rows, int d, float eps,
                                       void* stream) {
  const void* const w[3] = {wq, wk, wv};
  const float* const ws[3] = {static_cast<const float*>(sq), static_cast<const float*>(sk),
                              static_cast<const float*>(sv)};
  const float* const b[3] = {static_cast<const float*>(bq), static_cast<const float*>(bk),
                             static_cast<const float*>(bv)};
  void* const o[3] = {oq, ok, ov};
  return quant_gemm<true>(x, gamma, beta, w, ws, b, o, codes, scales, 3, rows, d, d, eps, stream);
}

// x: contiguous bf16 (rows, k); w: int8 (n, k); ws, b: f32 (n,); out: bf16
// (rows, n); codes (rows, k) int8 and scales (rows,) f32: scratch as above.
// k % 256 == 0, k <= 1024, n % 256 == 0.
extern "C" int ucod_quant_dense_w8a8(const void* x, const void* w, const void* ws, const void* b, void* out,
                                     void* codes, void* scales, int rows, int k, int n, void* stream) {
  const void* const wv[3] = {w, w, w};
  const float* const wsv[3] = {static_cast<const float*>(ws), nullptr, nullptr};
  const float* const bv[3] = {static_cast<const float*>(b), nullptr, nullptr};
  void* const o[3] = {out, out, out};
  return quant_gemm<false>(x, nullptr, nullptr, wv, wsv, bv, o, codes, scales, 1, rows, k, n, 0.f, stream);
}

// x: contiguous bf16 (rows, d); gamma/beta: f32 (d,); w1: int8 (f, d); w1s,
// b1: f32 (f,); codes: int8 (rows, f); scales: f32 (rows,); x_codes (rows,
// d) int8 and x_scales (rows,) f32: scratch of the pre-pass.  d % 256 == 0,
// d <= 1024, f / 16 one of the widths the main kernel is built for (64, 96,
// 128, 192: f = 1024, 1536, 2048, 3072).
extern "C" int ucod_layernorm_fc1_gelu_w8a8(const void* x, const void* gamma, const void* beta, const void* w1,
                                            const void* w1s, const void* b1, void* codes, void* scales,
                                            void* x_codes, void* x_scales, int rows, int d, int f, float eps,
                                            void* stream) {
  if (rows < 1 || d % 256 != 0 || d > 1024) return static_cast<int>(cudaErrorInvalidValue);
  return with_k9_width(f, [&](auto width) {
    return fc1_gelu_quant<decltype(width)::value>(x, gamma, beta, w1, w1s, b1, codes, scales, x_codes, x_scales,
                                                  rows, d, f, eps, static_cast<cudaStream_t>(stream));
  });
}

// For the measurement tool: the K8/K10 main kernel's shared memory, K9's
// for an expansion f, and how many K9 clusters of kCluster CTAs the card
// holds at once (cudaOccupancyMaxActiveClusters, as K9's launch asks it).
extern "C" int ucod_int8_kernel_info(int f, int* gemm_smem, int* mlp_smem, int* mlp_clusters) {
  *gemm_smem = static_cast<int>(kGemmSmemBytes);
  return with_k9_width(f, [&](auto width) {
    constexpr int kN = decltype(width)::value;
    *mlp_smem = static_cast<int>(mlp_smem_bytes<kN>());
    *mlp_clusters = k9_clusters<kN>();
    return *mlp_clusters > 0 ? 0 : count_error(*mlp_clusters);
  });
}

// x, gamma, beta, w1, w1s, b1 as ucod_layernorm_fc1_gelu_w8a8 (no scratch),
// then w2: int8 (d, f); w2s, b2: f32 (d,); out: bf16 (rows, d).  d % 256 ==
// 0, d <= 1024, f % 128 == 0, 16 rows of f32 GELU outputs within shared
// memory (f <= 3072 at d = 768).
extern "C" int ucod_layernorm_mlp_w8a8(const void* x, const void* gamma, const void* beta,
                                       const void* w1, const void* w1s, const void* b1,
                                       const void* w2, const void* w2s, const void* b2, void* out,
                                       int rows, int d, int f, float eps, void* stream) {
  if (const int bad = check_mlp(rows, d, f)) return bad;
  const int smem = mlp_smem(d, f);
  const cudaError_t err =
      cudaFuncSetAttribute(ln_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_mlp_kernel<<<(rows + kRows - 1) / kRows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const int8_t*>(w1), static_cast<const float*>(w1s),
      static_cast<const float*>(b1), static_cast<const int8_t*>(w2), static_cast<const float*>(w2s),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), rows, d, f, eps);
  return static_cast<int>(cudaGetLastError());
}
