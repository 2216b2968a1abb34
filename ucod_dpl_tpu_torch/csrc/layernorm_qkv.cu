// K6: fused LayerNorm + q/k/v projections, and K7: fused LayerNorm + fc1 +
// tanh GELU, bf16 in and out: one main kernel, layernorm_gemm_kernel<kGelu>.
//
// K6 replaces the TPU kernel ucod_dpl_tpu/ops/fused_layers.py::_lnqkv_kernel
// (launched by _pallas_layernorm_qkv): h = LN(x) with f32 statistics (the
// mean, then the mean of (x - mean)^2; eps from the caller), rounded to bf16
// once as the TPU kernel does, then q/k/v = h W^T + b with f32 accumulation
// and f32 bias, each rounded to bf16 once into its own output.  K7 replaces
// _lnfc1_kernel (launched by _pallas_layernorm_fc1_gelu): the same h, then
// h1 = h W1^T + b1 rounded to bf16, and gelu_tanh(h1) computed in f32 from
// the bf16 h1 and rounded to bf16; no product path calls it.  K7 is K6 with
// one weight of F rows (F % 256 == 0) and that epilogue; it also takes a
// hidden size of any multiple of 64 (an odd count of 64-column k-tiles; the
// pre-pass reads whole 8-value chunks).  At bs16 518px it does 103 GFLOP
// (0.105 ms at 989 TFLOP/s) and evaluates 67 M accurate tanhf in an
// epilogue nothing overlaps: on an H100 (700 W) it takes 0.26 ms of card
// time (main kernel 0.245, pre-pass 0.017), against 0.57 for LayerNorm +
// one cuBLAS product + GELU as a layer composes them and 0.91 for its first
// design (one CTA per 64 x 256 tile, mma.sync, the LayerNorm redone for
// each of a row's column tiles).
//
// What bounds it on the H100: at bs16 / 518px the (B * L) = 21,920 rows give
// 2 * 21920 * 768 * 2304 = 78 GFLOP (0.078 ms at the 989 TFLOP/s bf16 peak)
// against 34 MB of x, 3.5 MB of weights and 101 MB of outputs (0.041 ms at
// 3.35 TB/s): the tensor cores bound it.  The normalised h never goes to
// HBM.  The design, the main loop of a Hopper GEMM (hopper.cuh) with the
// LayerNorm in its A operand:
//   * a statistics pre-pass (one warp a row) writes f32 (mean, rstd) per row
//     into scratch the wrapper allocates (8 bytes a row): a 128-row x 768
//     slab (192 KB) cannot sit beside the weight ring, and every column tile
//     of a row tile would otherwise repeat the row's statistics; the main
//     kernel is a programmatic dependent launch, so its CTAs start, set up
//     and load their first stages while the pre-pass ends, and only the
//     consumers wait for the statistics;
//   * the main kernel is persistent and warp-specialised: CTAs take work
//     tiles (128 rows x 256 of the 3 * D concatenated output columns)
//     blockIdx.x, + gridDim.x, ..., the column tiles of one row tile
//     adjacent, so the CTAs that run together share x rows in L2 (the 3.5 MB
//     of weights stay there too); a 256-column tile lies in one projection,
//     so D must be a multiple of 256;
//   * one producer warp issues TMA loads (2-D maps, 128-byte swizzle) of an x
//     tile (128 rows x 64 columns) and a W tile (256 rows x 64 columns, in
//     nn.Linear's (out, in) layout, K-major as wgmma's B wants it) into a
//     three-stage mbarrier ring that runs on across work tiles; rows past
//     the last are zero-filled by TMA, never read;
//   * two consumer warpgroups own 64 rows each: per 16-column k-step a warp
//     reads its x fragment with ldmatrix (through the swizzle), normalises it
//     in f32 with its rows' (mean, rstd) and the columns' gamma/beta (kept in
//     shared memory), packs it to bf16 A fragments in registers and issues
//     wgmma m64n256k16 with A from registers; the A fragments of two k-tiles
//     alternate, so one k-tile's normalisation runs under the other's
//     products, and a stage is freed once its products are done;
//   * the epilogue adds the f32 bias to the m64n256 f32 accumulators (128 a
//     thread), rounds once to bf16 into a 128-byte-swizzled staging tile in
//     shared memory (32 KB a warpgroup, conflict-free) and stores it with
//     TMA, which drops rows past the last and drains while the warpgroup
//     runs the next tile; the producer has loaded that tile's first stages
//     meanwhile.  Stored from registers (4 bytes a thread, 8 rows an
//     instruction) the outputs cost a third of the kernel's time on an H100.

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;             // warpgroups of 64 rows
constexpr int kBlockM = 64 * kConsumers;  // rows per work tile
constexpr int kBlockN = 256;              // output columns per work tile
constexpr int kBlockK = 64;               // columns of x per stage: one 128-byte swizzle row
constexpr int kStages = 3;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kMaxD = 1024;
constexpr uint32_t kStageBytes = (kBlockM + kBlockN) * kBlockK * 2;
constexpr int kStatsWarps = 8;  // rows per block of the statistics pre-pass

constexpr int kOutBar = 1;  // named barriers 1, 2: each consumer warpgroup's epilogue

struct Smem {  // every tile 1024-byte aligned (128-byte swizzle atoms)
  bf16 x[kStages][kBlockM * kBlockK];
  bf16 w[kStages][kBlockN * kBlockK];
  bf16 out[kConsumers][kBlockN / 64][64 * 64];  // 64 x 64 boxes of the output tile
  float2 gb[kMaxD];  // (gamma, beta) of each column
  uint64_t full[kStages], empty[kStages];
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // + alignment slack

// Per row: f32 mean and rstd = rsqrt(mean (x - mean)^2 + eps), two passes
// over the row held in registers: lane l sums its 8-value chunks 256 j + 8 l
// (those inside the row: d % 64 == 0) in turn, and the lanes combine by an
// xor butterfly.
__global__ void __launch_bounds__(32 * kStatsWarps)
    ln_stats_kernel(const bf16* __restrict__ x, float2* __restrict__ stats, int rows, int d, float eps) {
  ucod::launch_dependents();
  const int row = blockIdx.x * kStatsWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* xr = x + (int64_t)row * d;
  float v[kMaxD / 32];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxD / 256; ++j) {
    if (256 * j + 8 * lane < d) {
      const uint4 u = *reinterpret_cast<const uint4*>(xr + 256 * j + 8 * lane);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(p[i]);
        v[8 * j + 2 * i] = f.x;
        v[8 * j + 2 * i + 1] = f.y;
        sum += f.x + f.y;
      }
    }
  }
  const float inv_d = 1.f / static_cast<float>(d);
  const float mean = ucod::warp_sum(sum) * inv_d;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxD / 256; ++j) {
    if (256 * j + 8 * lane < d) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = v[8 * j + 2 * i] - mean;
        const float b = v[8 * j + 2 * i + 1] - mean;
        sq += a * a + b * b;
      }
    }
  }
  const float rstd = rsqrtf(ucod::warp_sum(sq) * inv_d + eps);
  if (lane == 0) stats[row] = make_float2(mean, rstd);
}

// jax.nn.gelu(approximate=True) in f32: x * (0.5 * (1 + tanh(c * (x + 0.044715 x^3))))
__device__ __forceinline__ float gelu_tanh(float x) {
  return x * (0.5f * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * (x * x * x)))));
}

// Two adjacent x values (bf16x2) of one row, normalised with the row's
// (mean, rstd) and the columns' (gamma, beta) pairs gb = (g0, b0, g1, b1),
// as the bf16x2 A-fragment register.
__device__ __forceinline__ uint32_t normalise2(uint32_t raw, float2 st, float4 gb) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  return ucod::pack_bf16x2((f.x - st.x) * st.y * gb.x + gb.y, (f.y - st.x) * st.y * gb.z + gb.w);
}

// One k-tile (64 columns of x) of a consumer warpgroup: waits for its stage,
// builds the four k-steps' A fragments of the normalised h into `a`, issues
// their products into `acc` (overwriting it at the tile's first k-step), and
// frees the previous k-tile's stage once its products are done.  `xs`: this
// lane's ldmatrix row (row * 128 bytes) in the stage's x tile, `xor_row` its
// swizzle (row % 8), `half` its 16-byte chunk within a k-step.
__device__ __forceinline__ void k_tile(float (&acc)[kBlockN / 2], uint32_t (&a)[4][4], Smem& sm, int it, int kt,
                                       uint32_t xs, int xor_row, int half, int tq, int lane, float2 st0,
                                       float2 st1) {
  const int st = it % kStages;
  ucod::mbar_wait(&sm.full[st], (it / kStages) & 1);
  const uint8_t* x_tile = reinterpret_cast<const uint8_t*>(sm.x[st]) + xs;
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    uint32_t raw[4];  // rows g, g + 8 x columns 2 tq, 2 tq + 1; then the same at + 8
    ucod::ldmatrix_x4(raw, x_tile + (((2 * kk + half) ^ xor_row) << 4));
    const int col = kt * kBlockK + 16 * kk + 2 * tq;
    const float4 gb0 = *reinterpret_cast<const float4*>(&sm.gb[col]);
    const float4 gb8 = *reinterpret_cast<const float4*>(&sm.gb[col + 8]);
    a[kk][0] = normalise2(raw[0], st0, gb0);
    a[kk][1] = normalise2(raw[1], st1, gb0);
    a[kk][2] = normalise2(raw[2], st0, gb8);
    a[kk][3] = normalise2(raw[3], st1, gb8);
  }
  ucod::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    ucod::wgmma_rs<kBlockN, 0>(acc, a[kk], ucod::desc_kmajor(sm.w[st], kk), kt > 0 || kk > 0);
  }
  ucod::wgmma_commit();
  ucod::wgmma_wait<1>();  // the previous k-tile's products are done
  if (kt > 0 && lane == 0) ucod::mbar_arrive(&sm.empty[(it + kStages - 1) % kStages]);
}

// The main kernel over `n_proj` projections of n output columns each (K6:
// q, k, v of n = d; K7: fc1 of n = f), a 256-column tile in one of them.
// kGelu (K7): out = bf16(gelu(bf16(acc + b))) in f32; else bf16(acc + b).
template <bool kGelu>
__global__ void __launch_bounds__(kThreads, 1)
    layernorm_gemm_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_wq,
                          const __grid_constant__ CUtensorMap tm_wk, const __grid_constant__ CUtensorMap tm_wv,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          const float2* __restrict__ stats, const float* __restrict__ bq,
                          const float* __restrict__ bk, const float* __restrict__ bv,
                          const __grid_constant__ CUtensorMap tm_oq, const __grid_constant__ CUtensorMap tm_ok,
                          const __grid_constant__ CUtensorMap tm_ov, int rows, int d, int n, int n_ct, int n_work) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (ucod::smem_addr(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128;
  const int n_k = d / kBlockK;

  for (int i = threadIdx.x; i < d; i += kThreads) sm.gb[i] = make_float2(gamma[i], beta[i]);
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
        const CUtensorMap* tm_w = which == 0 ? &tm_wq : which == 1 ? &tm_wk : &tm_wv;
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int st = it % kStages;
          ucod::mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
          ucod::mbar_expect_tx(&sm.full[st], kStageBytes);
          ucod::tma_load_3d(sm.x[st], &tm_x, &sm.full[st], kt * kBlockK, m0, 0);
          ucod::tma_load_3d(sm.w[st], tm_w, &sm.full[st], kt * kBlockK, col - which * n, 0);
        }
      }
    }
  } else {
    ucod::reg_alloc<240>();
    ucod::wait_prerequisite();  // the statistics pre-pass has completed
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int tq = lane % 4;
    // ldmatrix.x4: lanes 0-15 give rows 0-15 of the warp's 16 at the k-step's
    // first 8 columns, lanes 16-31 the same rows at its last 8
    const int lrow = 64 * c + 16 * warp + (lane & 15);
    const uint32_t xs = lrow * kBlockK * 2;
    const int xor_row = lrow & 7;
    const int half = lane >> 4;

    float acc[kBlockN / 2];  // 64 rows x 256 columns, f32
    uint32_t a[2][4][4];     // the A fragments of two k-tiles, in turn
    int it = 0;
    for (int t = blockIdx.x; t < n_work; t += gridDim.x) {
      const int m0 = t / n_ct * kBlockM + 64 * c;  // this warpgroup's first row
      const int r0 = m0 + 16 * warp + g;           // this thread's rows r0, r0 + 8
      const int col = t % n_ct * kBlockN;
      const int which = col / n;
      const int n0 = col - which * n;
      // rows past the last: TMA gave zeros, any finite statistics do
      const float2 st0 = r0 < rows ? stats[r0] : make_float2(0.f, 0.f);
      const float2 st1 = r0 + 8 < rows ? stats[r0 + 8] : make_float2(0.f, 0.f);
      int kt = 0;
      for (; kt + 1 < n_k; kt += 2) {
        k_tile(acc, a[0], sm, it, kt, xs, xor_row, half, tq, lane, st0, st1);
        k_tile(acc, a[1], sm, it + 1, kt + 1, xs, xor_row, half, tq, lane, st0, st1);
        it += 2;
      }
      if (kt < n_k) {  // n_k = d / 64 odd (K7 only: K6's d % 256 == 0)
        k_tile(acc, a[0], sm, it, kt, xs, xor_row, half, tq, lane, st0, st1);
        ++it;
      }
      ucod::wgmma_wait<0>();
      ucod::fence_regs(acc);
      if (lane == 0) ucod::mbar_arrive(&sm.empty[(it + kStages - 1) % kStages]);

      // epilogue: the staging tile is free once the previous tile's stores
      // have read it
      if (tid == 0) ucod::bulk_wait_read<0>();
      ucod::named_sync(kOutBar + c, 128);
      const float* bias = which == 0 ? bq : which == 1 ? bk : bv;
      uint8_t* stage = reinterpret_cast<uint8_t*>(sm.out[c]);
      const int srow = 16 * warp + g;  // rows srow, srow + 8 of the staging tile; both swizzle by g
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        const float2 b2 = *reinterpret_cast<const float2*>(bias + n0 + 8 * j + 2 * tq);
        uint8_t* box = stage + (j / 8) * 64 * 64 * 2 + (((j % 8) ^ g) << 4) + 4 * tq;
        if constexpr (kGelu) {
          const auto act = [](float a, float b) { return gelu_tanh(__bfloat162float(__float2bfloat16_rn(a + b))); };
          *reinterpret_cast<uint32_t*>(box + srow * 128) =
              ucod::pack_bf16x2(act(acc[4 * j], b2.x), act(acc[4 * j + 1], b2.y));
          *reinterpret_cast<uint32_t*>(box + (srow + 8) * 128) =
              ucod::pack_bf16x2(act(acc[4 * j + 2], b2.x), act(acc[4 * j + 3], b2.y));
        } else {
          *reinterpret_cast<uint32_t*>(box + srow * 128) =
              ucod::pack_bf16x2(acc[4 * j] + b2.x, acc[4 * j + 1] + b2.y);
          *reinterpret_cast<uint32_t*>(box + (srow + 8) * 128) =
              ucod::pack_bf16x2(acc[4 * j + 2] + b2.x, acc[4 * j + 3] + b2.y);
        }
      }
      ucod::fence_proxy_async();
      ucod::named_sync(kOutBar + c, 128);
      if (tid == 0) {
        const CUtensorMap* tm_o = which == 0 ? &tm_oq : which == 1 ? &tm_ok : &tm_ov;
#pragma unroll
        for (int a = 0; a < kBlockN / 64; ++a) ucod::tma_store_3d(tm_o, sm.out[c][a], n0 + 64 * a, m0, 0);
        ucod::bulk_commit();
      }
    }
    if (tid == 0) ucod::bulk_wait<0>();  // the last stores have completed
  }
}

// The statistics pre-pass, then the main kernel (a programmatic dependent
// launch) over n_proj projections of n columns: weights w[p] (n, d) bf16,
// biases b[p] (n,) f32, outputs o[p] (rows, n) bf16.
template <bool kGelu>
int layernorm_gemm(const void* x, const void* gamma, const void* beta, const void* const (&w)[3],
                   const void* const (&b)[3], void* const (&o)[3], void* stats, int n_proj, int rows, int d, int n,
                   float eps, cudaStream_t s) {
  CUtensorMap tm_x, tm_w[3], tm_o[3];
  if (!ucod::packed_tensor_map(&tm_x, x, 1, rows, d, kBlockM)) return static_cast<int>(cudaErrorInvalidValue);
  for (int p = 0; p < 3; ++p) {
    if (p >= n_proj) {  // never read: every column tile falls in a projection < n_proj
      tm_w[p] = tm_w[0];
      tm_o[p] = tm_o[0];
    } else if (!ucod::packed_tensor_map(&tm_w[p], w[p], 1, n, d, kBlockN) ||
               !ucod::packed_tensor_map(&tm_o[p], o[p], 1, rows, n, 64)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  ln_stats_kernel<<<(rows + kStatsWarps - 1) / kStatsWarps, 32 * kStatsWarps, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<float2*>(stats), rows, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(layernorm_gemm_kernel<kGelu>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
  }
  int device = 0, n_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_ct = n_proj * n / kBlockN;
  const int n_work = (rows + kBlockM - 1) / kBlockM * n_ct;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_work < n_sm ? n_work : n_sm);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = s;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, layernorm_gemm_kernel<kGelu>, tm_x, tm_w[0], tm_w[1], tm_w[2], static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float2*>(stats), static_cast<const float*>(b[0]),
      static_cast<const float*>(b[1]), static_cast<const float*>(b[2]), tm_o[0], tm_o[1], tm_o[2], rows, d, n, n_ct,
      n_work));
}

}  // namespace

// K6.  x: contiguous bf16 (rows, d), rows >= 1; gamma/beta: f32 (d,);
// wq/wk/wv: contiguous bf16 (d, d) in (out, in) layout; bq/bk/bv: f32 (d,);
// oq/ok/ov: bf16 (rows, d); stats: f32 scratch of 2 * rows values (written,
// then read).  Requires d % 256 == 0, d <= 1024, 16-byte aligned pointers.
// Launches the statistics pre-pass and the main kernel on `stream`; returns
// the first nonzero cudaError_t (cudaErrorInvalidValue for another d or when
// a tensor map cannot be made).
extern "C" int ucod_layernorm_qkv(const void* x, const void* gamma, const void* beta, const void* wq,
                                  const void* wk, const void* wv, const void* bq, const void* bk, const void* bv,
                                  void* oq, void* ok, void* ov, void* stats, int rows, int d, float eps,
                                  void* stream) {
  if (d % 256 != 0 || d > kMaxD || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const void* const w[3] = {wq, wk, wv};
  const void* const b[3] = {bq, bk, bv};
  void* const o[3] = {oq, ok, ov};
  return layernorm_gemm<false>(x, gamma, beta, w, b, o, stats, 3, rows, d, d, eps, static_cast<cudaStream_t>(stream));
}

// K7.  x: contiguous bf16 (rows, d), rows >= 1; gamma/beta: f32 (d,); w1:
// contiguous bf16 (f, d) in (out, in) layout; b1: f32 (f,); out: bf16 (rows,
// f); stats: f32 scratch of 2 * rows values.  Requires d % 64 == 0, d <=
// 1024, f % 256 == 0, 16-byte aligned pointers.  Launches as K6.
extern "C" int ucod_layernorm_fc1_gelu(const void* x, const void* gamma, const void* beta, const void* w1,
                                       const void* b1, void* out, void* stats, int rows, int d, int f, float eps,
                                       void* stream) {
  if (d % kBlockK != 0 || d > kMaxD || f % kBlockN != 0 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const void* const w[3] = {w1, w1, w1};
  const void* const b[3] = {b1, b1, b1};
  void* const o[3] = {out, out, out};
  return layernorm_gemm<true>(x, gamma, beta, w, b, o, stats, 1, rows, d, f, eps, static_cast<cudaStream_t>(stream));
}
