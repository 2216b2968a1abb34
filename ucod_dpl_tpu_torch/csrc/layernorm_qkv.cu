// K6: fused LayerNorm + q/k/v projections, bf16 in and out.
//
// Replaces the TPU kernel ucod_dpl_tpu/ops/fused_layers.py::_lnqkv_kernel
// (launched by _pallas_layernorm_qkv): h = LN(x) with f32 statistics
// (eps from the caller), rounded to bf16 as the TPU kernel does, then
// q/k/v = h W^T + b with f32 accumulation and f32 bias, stored as bf16 into
// three separate outputs.
//
// What bounds it on the H100: at bs16 / 518px the (B * L) = 21,920 rows give
// 2 * 21920 * 768 * 2304 = 78 GFLOP against 34 MB of x, 3.5 MB of weights and
// 101 MB of outputs, about 560 FLOP per byte, so the tensor cores bound it.
// The normalised h never goes to HBM; the weights are re-read from L2 by
// every row tile (1.2 GB per call), which with one CTA per SM is what limits
// this design.  Design, kept simple:
//   * one CTA of 8 warps per (64-row tile, 256-column tile of the 3 * D
//     concatenated output columns), the column tiles of a row tile adjacent
//     in the grid so its x rows stay hot in L2; a column tile lies in one of
//     the three projections, so D must be a multiple of 256;
//   * the CTA copies its x rows into dynamic shared memory with cp.async
//     (64 x 776 bf16 = 97 KB at D = 768; with the weight stages 170 KB, above
//     the 48 KB default: cudaFuncSetAttribute), computes the LN statistics
//     there (two-pass, f32) and normalises in place to bf16;
//   * weights stay in nn.Linear's (out, in) layout; 64-wide K slices of the
//     tile's weight rows are double-buffered with cp.async, and both operands
//     reach mma.sync m16n8k16 through ldmatrix.x4;
//   * rows at or past `rows` are never read; their staged h is zero and no
//     store happens.
// Not yet used: wgmma, TMA, a persistent schedule (later work).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBlockK = 64;
constexpr int kLdw = kBlockK + 8;  // padded weight-tile row (bf16 elements)

// BM x BN output tile per CTA, WM x WN warps, each owning a
// (BM / WM) x (BN / WN) block.
template <int BM, int BN, int WM, int WN>
struct Tile {
  static constexpr int kWarps = WM * WN;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTm = BM / WM;
  static constexpr int kTn = BN / WN;
  static constexpr int kMi = kTm / 16;  // m16 fragments per warp
  static constexpr int kNi = kTn / 8;   // n8 fragments per warp
  static_assert(kTm % 16 == 0 && kTn % 16 == 0, "warp tile must be a multiple of 16");
  static int smem_bytes(int d) { return (BM * (d + 8) + 2 * BN * kLdw) * 2; }
};

// Weight rows [n0, n0 + BN), columns [k0, k0 + 64) into a [BN][kLdw] tile.
template <int BN, int kThreads>
__device__ __forceinline__ void load_w_tile(__nv_bfloat16* dst, const __nv_bfloat16* w, int n0,
                                            int k0, int d) {
  for (int idx = threadIdx.x; idx < BN * (kBlockK / 8); idx += kThreads) {
    const int r = idx >> 3;
    const int c = (idx & 7) * 8;
    ucod::cp_async16(dst + r * kLdw + c, w + (int64_t)(n0 + r) * d + k0 + c, true);
  }
}

template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(Tile<BM, BN, WM, WN>::kThreads)
    layernorm_qkv_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                         const float* __restrict__ beta, const __nv_bfloat16* __restrict__ wq,
                         const __nv_bfloat16* __restrict__ wk, const __nv_bfloat16* __restrict__ wv,
                         const float* __restrict__ bq, const float* __restrict__ bk,
                         const float* __restrict__ bv, __nv_bfloat16* __restrict__ oq,
                         __nv_bfloat16* __restrict__ ok, __nv_bfloat16* __restrict__ ov, int rows,
                         int d, float eps) {
  using T = Tile<BM, BN, WM, WN>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldh = d + 8;  // padded h row: conflict-free ldmatrix rows
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = hs + BM * ldh;  // [2][BN][kLdw]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int col0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;
  const int which = col0 / d;
  const int n0 = col0 - which * d;
  const __nv_bfloat16* w = which == 0 ? wq : (which == 1 ? wk : wv);
  const float* bias = which == 0 ? bq : (which == 1 ? bk : bv);
  __nv_bfloat16* out = which == 0 ? oq : (which == 1 ? ok : ov);

  // x rows -> shared memory; rows past the last are zero-filled, never read
  const int chunks = d / 8;
  for (int idx = threadIdx.x; idx < BM * chunks; idx += T::kThreads) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    const bool valid = row0 + r < rows;
    ucod::cp_async16(hs + r * ldh + c, x + (int64_t)(valid ? row0 + r : 0) * d + c, valid);
  }
  ucod::cp_async_commit();
  load_w_tile<BN, T::kThreads>(ws, w, n0, 0, d);
  ucod::cp_async_commit();
  ucod::cp_async_wait<1>();  // the x rows have landed; the weights may still fly
  __syncthreads();

  // LayerNorm in place: warp w normalises rows w, w + kWarps, ...
  const float inv_d = 1.f / static_cast<float>(d);
  for (int r = warp; r < BM; r += T::kWarps) {
    if (row0 + r >= rows) continue;  // stays zero
    __nv_bfloat16* hrow = hs + r * ldh;
    float sum = 0.f;
    for (int c = lane * 8; c < d; c += 256) {
      const uint4 u = *reinterpret_cast<const uint4*>(hrow + c);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(p[i]);
        sum += f.x + f.y;
      }
    }
    const float mean = ucod::warp_sum(sum) * inv_d;
    float sq = 0.f;
    for (int c = lane * 8; c < d; c += 256) {
      const uint4 u = *reinterpret_cast<const uint4*>(hrow + c);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(p[i]);
        sq += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
      }
    }
    const float rstd = rsqrtf(ucod::warp_sum(sq) * inv_d + eps);
    for (int c = lane * 8; c < d; c += 256) {
      const uint4 u = *reinterpret_cast<const uint4*>(hrow + c);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float4 g0 = *reinterpret_cast<const float4*>(gamma + c);
      const float4 g1 = *reinterpret_cast<const float4*>(gamma + c + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(beta + c);
      const float4 b1 = *reinterpret_cast<const float4*>(beta + c + 4);
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float bv8[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      uint4 res;
      uint32_t* pr = reinterpret_cast<uint32_t*>(&res);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(p[i]);
        pr[i] = ucod::pack_bf16x2((f.x - mean) * rstd * gv[2 * i] + bv8[2 * i],
                                  (f.y - mean) * rstd * gv[2 * i + 1] + bv8[2 * i + 1]);
      }
      *reinterpret_cast<uint4*>(hrow + c) = res;
    }
  }

  // (BM x d) h times the (d x BN) slice of W^T
  const int wm = warp % WM;
  const int wn = warp / WM;
  float acc[T::kMi][T::kNi][4];
#pragma unroll
  for (int mi = 0; mi < T::kMi; ++mi)
#pragma unroll
    for (int nj = 0; nj < T::kNi; ++nj)
      acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] = 0.f;

  // per-lane ldmatrix row offsets: A rows (lane & 15), k half (lane >> 4);
  // B rows (lane & 7) + 8 * (lane >> 4), k half ((lane >> 3) & 1)
  const __nv_bfloat16* a_base = hs + (wm * T::kTm + (lane & 15)) * ldh + (lane >> 4) * 8;
  const int b_off = (wn * T::kTn + (lane & 7) + ((lane >> 4) << 3)) * kLdw + ((lane >> 3) & 1) * 8;

  const int k_tiles = d / kBlockK;
  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) {
      load_w_tile<BN, T::kThreads>(ws + ((kt + 1) & 1) * BN * kLdw, w, n0, (kt + 1) * kBlockK, d);
      ucod::cp_async_commit();
      ucod::cp_async_wait<1>();
    } else {
      ucod::cp_async_wait<0>();
    }
    __syncthreads();  // also orders the LayerNorm's writes before the first reads
    const __nv_bfloat16* wt = ws + (kt & 1) * BN * kLdw + b_off;
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[T::kMi][4];
#pragma unroll
      for (int mi = 0; mi < T::kMi; ++mi)
        ucod::ldmatrix_x4(a[mi], a_base + mi * 16 * ldh + kt * kBlockK + kk * 16);
#pragma unroll
      for (int nj = 0; nj < T::kNi; nj += 2) {
        uint32_t b[4];
        ucod::ldmatrix_x4(b, wt + nj * 8 * kLdw + kk * 16);
#pragma unroll
        for (int mi = 0; mi < T::kMi; ++mi) {
          ucod::mma_16816(acc[mi][nj], a[mi], b[0], b[1]);
          ucod::mma_16816(acc[mi][nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's copies
  }

#pragma unroll
  for (int mi = 0; mi < T::kMi; ++mi) {
    const int r0 = row0 + wm * T::kTm + mi * 16 + g;
#pragma unroll
    for (int nj = 0; nj < T::kNi; ++nj) {
      const int c = n0 + wn * T::kTn + nj * 8 + 2 * t;
      const float bias0 = bias[c];
      const float bias1 = bias[c + 1];
      if (r0 < rows) {
        *reinterpret_cast<uint32_t*>(out + (int64_t)r0 * d + c) =
            ucod::pack_bf16x2(acc[mi][nj][0] + bias0, acc[mi][nj][1] + bias1);
      }
      if (r0 + 8 < rows) {
        *reinterpret_cast<uint32_t*>(out + (int64_t)(r0 + 8) * d + c) =
            ucod::pack_bf16x2(acc[mi][nj][2] + bias0, acc[mi][nj][3] + bias1);
      }
    }
  }
}

template <int BM, int BN, int WM, int WN>
int launch_layernorm_qkv(const void* x, const void* gamma, const void* beta, const void* wq,
                         const void* wk, const void* wv, const void* bq, const void* bk,
                         const void* bv, void* oq, void* ok, void* ov, int rows, int d, float eps,
                         void* stream) {
  using T = Tile<BM, BN, WM, WN>;
  const auto kernel = layernorm_qkv_kernel<BM, BN, WM, WN>;
  const int smem = T::smem_bytes(d);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(3 * d / BN, (rows + BM - 1) / BM);
  kernel<<<grid, T::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const __nv_bfloat16*>(wq),
      static_cast<const __nv_bfloat16*>(wk), static_cast<const __nv_bfloat16*>(wv),
      static_cast<const float*>(bq), static_cast<const float*>(bk), static_cast<const float*>(bv),
      static_cast<__nv_bfloat16*>(oq), static_cast<__nv_bfloat16*>(ok),
      static_cast<__nv_bfloat16*>(ov), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: contiguous bf16 (rows, d); gamma/beta: f32 (d,); wq/wk/wv: contiguous
// bf16 (d, d) in (out, in) layout; bq/bk/bv: f32 (d,); oq/ok/ov: bf16
// (rows, d).  Requires d % 256 == 0, d <= 1024, 16-byte aligned pointers.
// Launches on `stream`; returns the launch's cudaError_t.
extern "C" int ucod_layernorm_qkv(const void* x, const void* gamma, const void* beta,
                                  const void* wq, const void* wk, const void* wv, const void* bq,
                                  const void* bk, const void* bv, void* oq, void* ok, void* ov,
                                  int rows, int d, float eps, void* stream) {
  // 64 x 256 tiles (8 warps of 32 x 64) measured fastest at ViT-B shapes
  if (d % 256 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_layernorm_qkv<64, 256, 2, 4>(x, gamma, beta, wq, wk, wv, bq, bk, bv, oq, ok, ov,
                                             rows, d, eps, stream);
}
