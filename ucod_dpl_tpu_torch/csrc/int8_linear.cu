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
// F = 3072): K8 78 GOP, K10 26 GOP, K9 103 GOP, K11 207 GOP, 0.04-0.10 ms
// at the 1,979 TOP/s int8 peak; K8 and K10 also store 101 and 34 MB of bf16
// (0.03 and 0.01 ms at 3.35 TB/s), K9 67 MB of codes; K9 and K11 evaluate 67
// M accurate tanhf in their epilogue, and both stream their weights from L2
// once per 64-row tile (W1 0.81 GB a call, K11's W2 as much again).  The
// design of K8-K11:
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
//   * K9 (mlp_kernel<kN, 0>): the requantization scale spans all F
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
//   * K11 (mlp_kernel<kN, kN2>, kN2 = D / 8) is K9 up to the codes: the
//     same pre-pass, cluster, ring, GELU epilogue and exchange.  Then the
//     codes stay in shared memory and fc2 (the codes times W2^T, D output
//     columns) runs in the same kernel, W2 streamed by the same producer
//     after W1's stages of the tile, in 128-byte K boxes of kN2 rows.  The
//     cluster shares the codes by an all-gather: each CTA owns kN2 output
//     columns; consumer c takes the codes of CTAs 4c .. 4c + 3 (half of F),
//     its register A fragments loaded from their shared memory through
//     distributed shared memory (16 bytes a row and two k-steps, laid out by
//     gather_offset so a warp's loads fall on every bank four times), a
//     k-tile ahead of wgmma m64n{kN2}k32 with A in registers; consumer 1's
//     partial sums reach consumer 0 through shared memory, which adds them,
//     rescales (acc * (s_1 * w2_s) + b2), rounds to bf16 and stores.  An
//     mbarrier per CTA says every CTA's codes are written (one arrival a
//     CTA), another that every consumer of the cluster has read them (the
//     next tile's codes wait for it).  The other route, split-K (each CTA
//     multiplies its own codes by W2's slab and adds the s32 partial sums
//     into the owning CTA's shared memory with red.async), took 1.74 ms
//     against the all-gather's 0.96 in one process and was dropped.
//     The s32 sums are exact and the rescale is dense_w8a8_pre's, so K11's
//     output equals K9's codes through dense_w8a8_pre bit for bit.  On an
//     H100 (700 W) at bs16 518px K11 takes 0.98 ms of card time, K9 0.35;
//     K11 loses to the split MLP half (K9, then fc2 as torch._int_mm, 0.78
//     ms).  What bounds it: the peers' codes through distributed shared
//     memory (0.46 GB a call; the same fragments read
//     from the CTA's own codes save 0.18 ms), the fragment loads' latency
//     ahead of each k-tile (0.10), and W2 re-streamed from L2 for every
//     64-row tile (0.81 GB, as W1).  W2's stages hold two boxes a consumer
//     where the slot allows (0.98 against 1.00-1.01 ms with one).  The codes'
//     offsets, the W2 scale addresses and the fragment addresses are
//     computed inside the tile loop (fresh()); hoisted out of it they
//     spilled the GELU values to local memory (1.36 against 1.10 ms); 584
//     bytes of spill stores remain at F 3072 (none at F <= 2048).  Shared
//     memory at D 768, F 3072 (kN 192): K9's ring (3 stages of 64 x 128
//     codes and 2 x 192 x 128 W1; a W2 stage, 2 x 96 x 128, fits in one) 168
//     KB, the tile's codes 24 KB, the fc2 sums 32 KB (64 x 128 s32, for D up
//     to 1024), maxima and barriers: 231,760 bytes with the alignment slack,
//     of 232,448.  Nothing gave way: K9's output staging (24 KB) became the
//     codes, and the all-gather's codes need no padding (row r's 32-byte
//     blocks permuted by r % 4 instead).
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
// K9 and K11 main kernel: a 64-row tile's F columns over a cluster of CTAs
// ---------------------------------------------------------------------------

constexpr int kCluster = 8;  // CTAs sharing one row tile's row maxima
constexpr int kTileM = 64;   // rows per tile
constexpr int kColumnParts = kCluster * kConsumers;  // F = kColumnParts * N, N the wgmma width of a consumer

// What follows the exchange of row maxima: K9 (kN2 = 0) stores the codes;
// K11 (kN2 = D / 8) keeps them in shared memory and runs fc2 across the
// cluster (the header note).
constexpr int kMaxN2 = 128;  // K11's output columns per CTA, D / 8 (D <= 1024)
constexpr int kFc2Bar = 4;   // K11: both consumer warpgroups, around fc2's shared buffers

// K11: one tile row of codes (2 kN bytes), padded to whole 128-byte atoms.
template <int kN>
__host__ __device__ constexpr int code_row() {
  return (2 * kN + kBlockK - 1) / kBlockK * kBlockK;
}

template <int kN, bool kK11>
struct MlpSmem {  // every operand tile 1024-byte aligned
  // a stage's weight boxes: W1's kN rows a consumer, or K11's W2 boxes of D
  // / 8 <= kMaxN2 rows (one or two a consumer: kW2Boxes)
  static constexpr int kStageB = kConsumers * (!kK11 || kN >= kMaxN2 ? kN : kMaxN2) * kBlockK;
  int8_t a[kStages][kTileM * kBlockK];
  int8_t b[kStages][kStageB];
  // K9: each consumer's 64 x kN codes, row-major (unswizzled TMA box).  K11:
  // the tile's 64 x 2kN codes, fc2's A operand, in gather_offset's order
  int8_t codes[!kK11 ? kConsumers * 64 * kN : 64 * code_row<kN>()];
  // K11: consumer 1's partial fc2 sums, 64 x D / 8 s32, thread by thread
  int acc2[!kK11 ? 4 : 64 * kMaxN2];
  // by tile parity: each consumer's partial row maxima (read by the whole
  // cluster), and an mbarrier with one arrival from each CTA of the cluster,
  // its partial maxima written
  float part[2][kConsumers][64];
  float rowmax[kTileM];
  uint64_t full[kStages], empty[kStages];
  uint64_t maxima[2];
  // K11: fc2_full = every CTA's codes are in its shared memory (kCluster
  // arrivals), fc2_free = every consumer of the cluster has read this CTA's
  // codes (kCluster * kConsumers arrivals)
  uint64_t fc2_full, fc2_free;
};

// K11: where code `col` (of 2kN) of tile row `row` lies in
// `codes`.  Two 32-byte k-steps hold their bytes in the order the threads' A
// fragments take them: quad q's 16 bytes at 16q are its bytes 4q .. 4q + 3
// and 16 + 4q .. 16 + 4q + 3 of the first k-step, then the same of the
// second (one 16-byte load a row and two k-steps), and odd rows' 64-byte
// blocks sit at block ^ 1 within their 128 bytes, so the 8 rows x 4 quads of
// a warp's load hit every bank 4 times, the least 512 bytes can.
template <int kN>
__device__ __forceinline__ int gather_offset(int row, int col) {
  const int w = col & 63;
  const int pos = 16 * ((w & 15) >> 2) + 8 * (w >> 5) + 4 * ((w >> 4) & 1) + (w & 3);
  return row * code_row<kN>() + (((col & ~63) + pos) ^ ((row & 1) << 6));
}

// x as a value the compiler cannot move out of a loop: addresses derived
// from it are computed where they are used, not held in registers across
// the tile loop (K11's fc1 epilogue spilled its GELU values to local memory
// for the code offsets, W2 scales and fragment addresses hoisted out).
__device__ __forceinline__ int fresh(int x) {
  asm volatile("mov.b32 %0, %0;" : "+r"(x));
  return x;
}

struct MlpArgs {
  const float* sx;   // the pre-pass's row scales
  const float* w1s;  // fc1's output-channel scales and bias
  const float* b1;
  float* scales;     // K9: the codes' row scales
  const float* w2s;  // K11: fc2's output-channel scales and bias, the output
  const float* b2;
  bf16* out;
  int rows, d, n_tiles;
};

// K9 (kN2 = 0): tm_o maps the codes (rows, F); K11: tm_o maps W2 (D, F),
// whose boxes are kN2 = D / 8 rows x 128 bytes.
template <int kN, int kN2>
__global__ void __launch_bounds__(kMainThreads, 1)
    mlp_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
               const __grid_constant__ CUtensorMap tm_o, const MlpArgs args) {
  extern __shared__ uint8_t smem_raw[];
  constexpr bool kK11 = kN2 > 0;
  MlpSmem<kN, kK11>& sm = aligned_smem<MlpSmem<kN, kK11>>(smem_raw);
  constexpr uint32_t kStageBytes = (kTileM + kConsumers * kN) * kBlockK;
  // K11: 128-byte K boxes of W2 a consumer and stage (two where a stage's
  // weight slot holds them), stages a tile (half of F, 8 kN, a consumer)
  constexpr int kW2Boxes = kK11 && MlpSmem<kN, kK11>::kStageB >= 2 * kConsumers * kN2 * kBlockK ? 2 : 1;
  constexpr uint32_t kStage2Bytes = kConsumers * kW2Boxes * kN2 * kBlockK;
  constexpr int kStages2 = kK11 ? 8 * kN / kBlockK / kW2Boxes : 0;
  const int wg = threadIdx.x / 128;
  const int n_k = args.d / kBlockK;
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
    if constexpr (kK11) {
      ucod::mbar_init(&sm.fc2_full, kCluster);
      ucod::mbar_init(&sm.fc2_free, kCluster * kConsumers);
    }
    ucod::fence_barrier_init();
  }
  ucod::cluster_sync();  // every CTA's barriers exist before a peer uses them

  if (wg == 0) {
    // producer: one thread keeps the ring full, across the cluster's tiles
    ucod::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = cluster; t < args.n_tiles; t += n_clusters) {
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int st = it % kStages;
          ucod::mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
          ucod::mbar_expect_tx(&sm.full[st], kStageBytes);
#pragma unroll
          for (int i = 0; i < kConsumers; ++i)
            ucod::tma_load_3d(sm.b[st] + i * kN * kBlockK, &tm_w, &sm.full[st], kt * kBlockK, col0 + i * kN, 0);
          ucod::tma_load_3d(sm.a[st], &tm_a, &sm.full[st], kt * kBlockK, t * kTileM, 0);
        }
        // K11: W2's boxes for fc2, this CTA's kN2 output columns over
        // consumer i's half of F
        for (int s = 0; s < kStages2; ++s, ++it) {
          const int st = it % kStages;
          ucod::mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
          ucod::mbar_expect_tx(&sm.full[st], kStage2Bytes);
#pragma unroll
          for (int i = 0; i < kConsumers; ++i) {
#pragma unroll
            for (int h = 0; h < kW2Boxes; ++h) {
              const int k0 = i * 8 * kN + (s * kW2Boxes + h) * kBlockK;
              ucod::tma_load_3d(sm.b[st] + (i * kW2Boxes + h) * kN2 * kBlockK, &tm_o, &sm.full[st], k0, rank * kN2,
                                0);
            }
          }
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
  const int rows = args.rows;

  int it = 0;
  for (int t = cluster, j = 0; t < args.n_tiles; t += n_clusters, ++j) {
    const int m0 = t * kTileM;
    int acc[kN / 2];  // a tile's: nothing of it lives on into fc2 or the next tile
    for (int kt = 0; kt < n_k; ++kt, ++it) {
      const int st = it % kStages;
      ucod::mbar_wait(&sm.full[st], (it / kStages) & 1);
      ucod::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 32; ++kk) {
        ucod::wgmma_s8<kN>(acc, ucod::desc_kmajor(sm.a[st], kk), ucod::desc_kmajor(sm.b[st] + c * kN * kBlockK, kk),
                           kt > 0 || kk > 0);
      }
      ucod::wgmma_commit();
      ucod::wgmma_wait<1>();
      if (kt > 0 && lane == 0) ucod::mbar_arrive(&sm.empty[(it + kStages - 1) % kStages]);
    }
    ucod::wgmma_wait<0>();
    ucod::fence_regs(acc);
    if (lane == 0) ucod::mbar_arrive(&sm.empty[(it + kStages - 1) % kStages]);  // the next stages load

    // epilogue in registers: h1 = acc * (s_x * w1_s) + b1, g = gelu(h1), and
    // this thread's rows' max |g| (rows lr and lr + 8 of the tile's 64)
    const int lr = 16 * warp + g;
    const int r0 = m0 + lr;
    const float s0 = r0 < rows ? args.sx[r0] : 0.f;
    const float s1 = r0 + 8 < rows ? args.sx[r0 + 8] : 0.f;
    const int cbase = (kK11 ? fresh(col0) : col0) + c * kN + 2 * tq;
    float v[kN / 2];
    float m_0 = 0.f, m_1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < kN / 8; ++jj) {
      const float2 w2 = *reinterpret_cast<const float2*>(args.w1s + cbase + 8 * jj);
      const float2 b2 = *reinterpret_cast<const float2*>(args.b1 + cbase + 8 * jj);
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

    if constexpr (!kK11) {
      // the staging tile is free once the previous tile's store has read it
      if (tid == 0) ucod::bulk_wait_read<0>();
      ucod::named_sync(kOutBar + c, 128);
      int8_t* stage = sm.codes + c * 64 * kN;
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
        if (r0 < rows) args.scales[r0] = sc0;
        if (r0 + 8 < rows) args.scales[r0 + 8] = sc1;
      }
    } else {
      // K11: the codes into fc2's A operand, once every consumer of the
      // cluster has read the last tile's
      ucod::mbar_wait_cluster(&sm.fc2_free, (j & 1) ^ 1);
      const int lrf = fresh(lr);
#pragma unroll
      for (int jj = 0; jj < kN / 8; ++jj) {
        const int col = c * kN + 8 * jj + 2 * tq;
        const uint16_t lo =
            static_cast<uint16_t>(quantize_code(v[4 * jj], sc0) | (quantize_code(v[4 * jj + 1], sc0) << 8));
        const uint16_t hi =
            static_cast<uint16_t>(quantize_code(v[4 * jj + 2], sc1) | (quantize_code(v[4 * jj + 3], sc1) << 8));
        *reinterpret_cast<uint16_t*>(sm.codes + gather_offset<kN>(lrf, col)) = lo;
        *reinterpret_cast<uint16_t*>(sm.codes + gather_offset<kN>(lrf + 8, col)) = hi;
      }
      ucod::named_sync(kFc2Bar, 128 * kConsumers);

      // this CTA's kN2 output columns over all F: consumer c takes the codes
      // of CTAs 4c .. 4c + 3, A fragments loaded from their shared memory
      // into registers (16 bytes a row and two k-steps), a k-tile ahead
      int acc2[kN2 / 2];
      if (ct < kCluster) ucod::mbar_arrive_cluster(&sm.fc2_full, ct);
      ucod::mbar_wait_cluster(&sm.fc2_full, j & 1);
      constexpr int kTiles2 = 8 * kN / kBlockK;  // 128-byte k-tiles of this consumer's half of F
      constexpr int kStepsPerCta = 2 * kN / 32;
      const int lrf2 = fresh(lr);
      const uint32_t row_off = lrf2 * code_row<kN>();
      const uint32_t xr = (lrf2 & 1) << 6;
      // k-tile kt's fragments (4 k-steps): two 16-byte loads a row
      const auto load = [&](uint32_t (&fa)[4][4], int kt) {
#pragma unroll
        for (int kp = 0; kp < 2; ++kp) {
          const int step = 4 * kt + 2 * kp;  // k-step of this consumer's half of F
          const int q = 4 * c + step / kStepsPerCta;
          const uint32_t col = (step % kStepsPerCta) * 32;
          const uint32_t remote = ucod::map_shared_cluster(sm.codes + row_off + ((col + 16 * tq) ^ xr), q);
          const uint4 lo = ucod::ld_shared_cluster_v4(remote);                        // row lr
          const uint4 hi = ucod::ld_shared_cluster_v4(remote + 8 * code_row<kN>());  // row lr + 8
          fa[2 * kp][0] = lo.x;
          fa[2 * kp][1] = hi.x;
          fa[2 * kp][2] = lo.y;
          fa[2 * kp][3] = hi.y;
          fa[2 * kp + 1][0] = lo.z;
          fa[2 * kp + 1][1] = hi.z;
          fa[2 * kp + 1][2] = lo.w;
          fa[2 * kp + 1][3] = hi.w;
        }
      };
      // k-tile kt, box kt % kW2Boxes of its stage: (the stage's W2 arrived)
      // its products from fa; then (the previous k-tile done, and at a
      // stage's first box with it the previous stage) the next k-tile's
      // fragments into nxt
      const auto ktile = [&](uint32_t (&fa)[4][4], uint32_t (&nxt)[4][4], int kt) {
        const int h = kt % kW2Boxes;
        const int st = it % kStages;
        if (h == 0) ucod::mbar_wait(&sm.full[st], (it / kStages) & 1);
        ucod::wgmma_fence();
        const int8_t* box = sm.b[st] + (c * kW2Boxes + h) * kN2 * kBlockK;
#pragma unroll
        for (int kk = 0; kk < kBlockK / 32; ++kk) {
          ucod::wgmma_s8_rs<kN2>(acc2, fa[kk], ucod::desc_kmajor(box, kk), kt > 0 || kk > 0);
        }
        ucod::wgmma_commit();
        ucod::wgmma_wait<1>();
        if (h == 0 && kt > 0 && lane == 0) ucod::mbar_arrive(&sm.empty[(it + kStages - 1) % kStages]);
        if (kt + 1 < kTiles2) load(nxt, kt + 1);
        if (h == kW2Boxes - 1) ++it;
      };
      uint32_t fa[2][4][4];
      load(fa[0], 0);
#pragma unroll 1
      for (int kt = 0; kt < kTiles2; kt += 2) {  // kTiles2 = kN / 16 is even
        ktile(fa[0], fa[1], kt);
        ktile(fa[1], fa[0], kt + 1);
      }
      ucod::wgmma_wait<0>();
      ucod::fence_regs(acc2);
      if (lane == 0) ucod::mbar_arrive(&sm.empty[(it + kStages - 1) % kStages]);
      ucod::named_sync(kOutBar + c, 128);  // every warp of this consumer has loaded its codes
      if (tid < kCluster) ucod::mbar_arrive_cluster(&sm.fc2_free, tid);

      // consumer 1's partial sums through shared memory to consumer 0,
      // which adds them to its own, rescales, rounds and stores (acc2 is
      // rewritten only after the next tile's exchange, which consumer 0
      // reaches after this)
      if (c == 1) {
#pragma unroll
        for (int i = 0; i < kN2 / 2; ++i) sm.acc2[i * 128 + tid] = acc2[i];
      }
      ucod::named_sync(kFc2Bar, 128 * kConsumers);
      if (c == 0) {
        const int n0 = fresh(rank * kN2);
#pragma unroll
        for (int jj = 0; jj < kN2 / 8; ++jj) {
          const int col = n0 + 8 * jj + 2 * tq;
          const float2 w2 = *reinterpret_cast<const float2*>(args.w2s + col);
          const float2 b2 = *reinterpret_cast<const float2*>(args.b2 + col);
          const int* p = sm.acc2 + 4 * jj * 128 + tid;
          if (r0 < rows) {
            *reinterpret_cast<uint32_t*>(args.out + (int64_t)r0 * args.d + col) =
                ucod::pack_bf16x2(rescale(acc2[4 * jj] + p[0], sc0, w2.x, b2.x),
                                  rescale(acc2[4 * jj + 1] + p[128], sc0, w2.y, b2.y));
          }
          if (r0 + 8 < rows) {
            *reinterpret_cast<uint32_t*>(args.out + (int64_t)(r0 + 8) * args.d + col) =
                ucod::pack_bf16x2(rescale(acc2[4 * jj + 2] + p[256], sc1, w2.x, b2.x),
                                  rescale(acc2[4 * jj + 3] + p[384], sc1, w2.y, b2.y));
          }
        }
      }
    }
  }
  ucod::cluster_sync();  // no CTA exits while a peer may still read its shared memory
  if constexpr (!kK11) {
    if (tid == 0) ucod::bulk_wait<0>();
  }
}

// The main kernel <kN, kN2>: its shared memory (+ alignment slack), and how
// many of its clusters the current card holds at once (set up once per
// device; a count, or a cudaError_t negated).
template <int kN, int kN2>
constexpr size_t mlp_smem_bytes() {
  return sizeof(MlpSmem<kN, (kN2 > 0)>) + 1024;
}

template <int kN, int kN2>
int mlp_clusters() {
  static_assert(mlp_smem_bytes<kN, kN2>() <= kMaxSmem, "K9/K11 shared memory exceeds what a block may take");
  static std::atomic<int> cache[kMaxDevices];
  return once_per_device(cache, mlp_kernel<kN, kN2>, mlp_smem_bytes<kN, kN2>(), [](int) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = main_config(kCluster * 64, kCluster, mlp_smem_bytes<kN, kN2>(), nullptr, &attr);
    int clusters = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, mlp_kernel<kN, kN2>, &cfg);
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

// fn(std::integral_constant<int, kN2>()) at K11's fc2 width kN2 = d / 8 (32,
// 64, 96, 128: d = 256, 512, 768, 1024); cudaErrorInvalidValue for any other d.
template <typename Fn>
int with_fc2_width(int d, Fn fn) {
  switch (d % kCluster == 0 ? d / kCluster : 0) {
    case 32:
      return fn(std::integral_constant<int, 32>());
    case 64:
      return fn(std::integral_constant<int, 64>());
    case 96:
      return fn(std::integral_constant<int, 96>());
    case 128:
      return fn(std::integral_constant<int, 128>());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The pre-pass (LN + quantization into x_codes, x_scales), then the main
// kernel <kN, kN2>; `second`: K9's codes (rows, f), or K11's W2 (d, f).
// Checks every shape before the first launch.
template <int kN, int kN2>
int mlp(const void* x, const void* gamma, const void* beta, const void* w1, const void* second, MlpArgs args,
        int f, void* x_codes, void* x_scales, float eps, cudaStream_t s) {
  CUtensorMap tm_a, tm_w, tm_o;
  const int rows = args.rows, d = args.d;
  if (!ucod::int8_tensor_map(&tm_a, x_codes, rows, d, kTileM) || !ucod::int8_tensor_map(&tm_w, w1, f, d, kN) ||
      !(kN2 == 0 ? ucod::int8_tensor_map(&tm_o, second, rows, f, 64, kN, false)
                              : ucod::int8_tensor_map(&tm_o, second, d, f, kN2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int max_clusters = mlp_clusters<kN, kN2>();
  if (max_clusters <= 0) return count_error(max_clusters);
  const cudaError_t err = launch_prepass<true>(x, gamma, beta, x_codes, x_scales, rows, d, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  args.sx = static_cast<const float*>(x_scales);
  args.n_tiles = (rows + kTileM - 1) / kTileM;
  const int n_clusters = args.n_tiles < max_clusters ? args.n_tiles : max_clusters;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      main_config(n_clusters * kCluster, kCluster, mlp_smem_bytes<kN, kN2>(), s, &attr);
  return static_cast<int>(cudaLaunchKernelEx(&cfg, mlp_kernel<kN, kN2>, tm_a, tm_w, tm_o, args));
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
  const MlpArgs args = {nullptr, static_cast<const float*>(w1s), static_cast<const float*>(b1),
                        static_cast<float*>(scales), nullptr, nullptr, nullptr, rows, d, 0};
  return with_k9_width(f, [&](auto width) {
    return mlp<decltype(width)::value, 0>(x, gamma, beta, w1, codes, args, f, x_codes, x_scales, eps,
                                          static_cast<cudaStream_t>(stream));
  });
}

// x, gamma, beta, w1, w1s, b1 as ucod_layernorm_fc1_gelu_w8a8, then w2: int8
// (d, f); w2s, b2: f32 (d,); out: bf16 (rows, d); x_codes, x_scales: the
// pre-pass's scratch.  The shapes K9 takes.
extern "C" int ucod_layernorm_mlp_w8a8(const void* x, const void* gamma, const void* beta, const void* w1,
                                       const void* w1s, const void* b1, const void* w2, const void* w2s,
                                       const void* b2, void* out, void* x_codes, void* x_scales, int rows, int d,
                                       int f, float eps, void* stream) {
  if (rows < 1 || d % 256 != 0 || d > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const MlpArgs args = {nullptr, static_cast<const float*>(w1s), static_cast<const float*>(b1), nullptr,
                        static_cast<const float*>(w2s), static_cast<const float*>(b2), static_cast<bf16*>(out),
                        rows, d, 0};
  return with_k9_width(f, [&](auto width) {
    return with_fc2_width(d, [&](auto width2) {
      return mlp<decltype(width)::value, decltype(width2)::value>(
          x, gamma, beta, w1, w2, args, f, x_codes, x_scales, eps, static_cast<cudaStream_t>(stream));
    });
  });
}

// For the measurement tool: the K8/K10 main kernel's shared memory, K9's and
// K11's main kernels' for d and f, and how many clusters of kCluster CTAs of
// each the card holds at once (cudaOccupancyMaxActiveClusters, as their
// launches ask it).
extern "C" int ucod_int8_kernel_info(int d, int f, int* gemm_smem, int* k9_smem, int* k9_clusters, int* k11_smem,
                                     int* k11_clusters) {
  *gemm_smem = static_cast<int>(kGemmSmemBytes);
  return with_k9_width(f, [&](auto width) {
    constexpr int kN = decltype(width)::value;
    return with_fc2_width(d, [&](auto width2) {
      constexpr int kN2 = decltype(width2)::value;
      *k9_smem = static_cast<int>(mlp_smem_bytes<kN, 0>());
      *k9_clusters = mlp_clusters<kN, 0>();
      *k11_smem = static_cast<int>(mlp_smem_bytes<kN, kN2>());
      *k11_clusters = mlp_clusters<kN, kN2>();
      return *k9_clusters <= 0 ? count_error(*k9_clusters) : *k11_clusters <= 0 ? count_error(*k11_clusters) : 0;
    });
  });
}
