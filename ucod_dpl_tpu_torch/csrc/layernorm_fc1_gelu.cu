// K7: fused LayerNorm + fc1 + tanh GELU, bf16 in and out.
//
// Replaces the TPU kernel ucod_dpl_tpu/ops/fused_layers.py::_lnfc1_kernel
// (launched by _pallas_layernorm_fc1_gelu, exported as layernorm_fc1_gelu):
// h = LN(x) with f32 statistics (eps from the caller), rounded to bf16;
// h1 = h W1^T + b1 with f32 accumulation and an f32 bias, rounded to bf16;
// out = gelu_tanh(h1), computed in f32 from the bf16 h1 and rounded to bf16.
// No product path of the JAX package calls it (its ViT composes LN, dense and
// GELU instead); it is ported as the op the package exports.
//
// What bounds it on the H100: at bs16 / 518px the 21,920 rows give
// 2 * 21920 * 768 * 3072 = 103 GFLOP against 34 MB of x, 4.7 MB of W1 and
// 135 MB of output, about 600 FLOP per byte, so the tensor cores bound it
// (0.105 ms at 989 TFLOP/s), not HBM.  The normalised h never goes to HBM;
// W1 is re-read from L2 by every row tile (1.6 GB per call).  Design: K6's
// (layernorm_qkv.cu), with one weight and a GELU epilogue:
//   * one CTA of 8 warps per (64-row tile, 256-column tile of the F fc1
//     outputs), the column tiles of a row tile adjacent in the grid so its x
//     rows stay hot in L2; F must be a multiple of 256;
//   * the CTA copies its x rows into dynamic shared memory with cp.async
//     (64 x (D + 8) bf16), computes the LN statistics there (two-pass, f32)
//     and normalises in place to bf16;
//   * W1 stays in nn.Linear's (out, in) layout; 64-wide K slices of the tile's
//     256 weight rows are double-buffered with cp.async, and both operands
//     reach mma.sync m16n8k16 through ldmatrix.x4;
//   * rows at or past `rows` are never read; their staged h is zero and no
//     store happens.
// Not yet used: wgmma, TMA, a persistent schedule (later work).

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBM = 64;   // rows per CTA
constexpr int kBN = 256;  // fc1 outputs per CTA
constexpr int kWM = 2;    // warps along the rows
constexpr int kWN = 4;    // warps along the columns
constexpr int kWarps = kWM * kWN;
constexpr int kThreads = 32 * kWarps;
constexpr int kTm = kBM / kWM;  // 32 rows per warp
constexpr int kTn = kBN / kWN;  // 64 columns per warp
constexpr int kMi = kTm / 16;
constexpr int kNi = kTn / 8;
constexpr int kBlockK = 64;
constexpr int kLdw = kBlockK + 8;  // padded weight-tile row (bf16 elements)

int smem_bytes(int d) { return (kBM * (d + 8) + 2 * kBN * kLdw) * 2; }

// jax.nn.gelu(approximate=True) in f32: x * (0.5 * (1 + tanh(c * (x + 0.044715 x^3))))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
  return x * (0.5f * (1.f + tanhf(inner)));
}

// Weight rows [n0, n0 + kBN), columns [k0, k0 + 64) into a [kBN][kLdw] tile.
__device__ __forceinline__ void load_w_tile(__nv_bfloat16* dst, const __nv_bfloat16* w, int n0, int k0,
                                            int d) {
  for (int idx = threadIdx.x; idx < kBN * (kBlockK / 8); idx += kThreads) {
    const int r = idx >> 3;
    const int c = (idx & 7) * 8;
    ucod::cp_async16(dst + r * kLdw + c, w + (int64_t)(n0 + r) * d + k0 + c, true);
  }
}

__global__ void __launch_bounds__(kThreads)
    layernorm_fc1_gelu_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                              const float* __restrict__ beta, const __nv_bfloat16* __restrict__ w1,
                              const float* __restrict__ b1, __nv_bfloat16* __restrict__ out, int rows,
                              int d, int f, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldh = d + 8;  // padded h row: conflict-free ldmatrix rows
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = hs + kBM * ldh;  // [2][kBN][kLdw]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int row0 = blockIdx.y * kBM;

  // x rows -> shared memory; rows past the last are zero-filled, never read
  const int chunks = d / 8;
  for (int idx = threadIdx.x; idx < kBM * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    const bool valid = row0 + r < rows;
    ucod::cp_async16(hs + r * ldh + c, x + (int64_t)(valid ? row0 + r : 0) * d + c, valid);
  }
  ucod::cp_async_commit();
  load_w_tile(ws, w1, n0, 0, d);
  ucod::cp_async_commit();
  ucod::cp_async_wait<1>();  // the x rows have landed; the weights may still fly
  __syncthreads();

  // LayerNorm in place: warp w normalises rows w, w + kWarps, ...
  const float inv_d = 1.f / static_cast<float>(d);
  for (int r = warp; r < kBM; r += kWarps) {
    if (row0 + r >= rows) continue;  // stays zero
    __nv_bfloat16* hrow = hs + r * ldh;
    float sum = 0.f;
    for (int c = lane * 8; c < d; c += 256) {
      const uint4 u = *reinterpret_cast<const uint4*>(hrow + c);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 v = __bfloat1622float2(p[i]);
        sum += v.x + v.y;
      }
    }
    const float mean = ucod::warp_sum(sum) * inv_d;
    float sq = 0.f;
    for (int c = lane * 8; c < d; c += 256) {
      const uint4 u = *reinterpret_cast<const uint4*>(hrow + c);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 v = __bfloat1622float2(p[i]);
        sq += (v.x - mean) * (v.x - mean) + (v.y - mean) * (v.y - mean);
      }
    }
    const float rstd = rsqrtf(ucod::warp_sum(sq) * inv_d + eps);
    for (int c = lane * 8; c < d; c += 256) {
      const uint4 u = *reinterpret_cast<const uint4*>(hrow + c);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float4 g0 = *reinterpret_cast<const float4*>(gamma + c);
      const float4 g1 = *reinterpret_cast<const float4*>(gamma + c + 4);
      const float4 be0 = *reinterpret_cast<const float4*>(beta + c);
      const float4 be1 = *reinterpret_cast<const float4*>(beta + c + 4);
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float bv[8] = {be0.x, be0.y, be0.z, be0.w, be1.x, be1.y, be1.z, be1.w};
      uint4 res;
      uint32_t* pr = reinterpret_cast<uint32_t*>(&res);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 v = __bfloat1622float2(p[i]);
        pr[i] = ucod::pack_bf16x2((v.x - mean) * rstd * gv[2 * i] + bv[2 * i],
                                  (v.y - mean) * rstd * gv[2 * i + 1] + bv[2 * i + 1]);
      }
      *reinterpret_cast<uint4*>(hrow + c) = res;
    }
  }

  // (64 x d) h times the (d x 256) slice of W1^T
  const int wm = warp % kWM;
  const int wn = warp / kWM;
  float acc[kMi][kNi][4];
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNi; ++nj) acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] = 0.f;

  // per-lane ldmatrix row offsets: A rows (lane & 15), k half (lane >> 4);
  // B rows (lane & 7) + 8 * (lane >> 4), k half ((lane >> 3) & 1)
  const __nv_bfloat16* a_base = hs + (wm * kTm + (lane & 15)) * ldh + (lane >> 4) * 8;
  const int b_off = (wn * kTn + (lane & 7) + ((lane >> 4) << 3)) * kLdw + ((lane >> 3) & 1) * 8;

  const int k_tiles = d / kBlockK;
  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) {
      load_w_tile(ws + ((kt + 1) & 1) * kBN * kLdw, w1, n0, (kt + 1) * kBlockK, d);
      ucod::cp_async_commit();
      ucod::cp_async_wait<1>();
    } else {
      ucod::cp_async_wait<0>();
    }
    __syncthreads();  // also orders the LayerNorm's writes before the first reads
    const __nv_bfloat16* wt = ws + (kt & 1) * kBN * kLdw + b_off;
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[kMi][4];
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi) ucod::ldmatrix_x4(a[mi], a_base + mi * 16 * ldh + kt * kBlockK + kk * 16);
#pragma unroll
      for (int nj = 0; nj < kNi; nj += 2) {
        uint32_t b[4];
        ucod::ldmatrix_x4(b, wt + nj * 8 * kLdw + kk * 16);
#pragma unroll
        for (int mi = 0; mi < kMi; ++mi) {
          ucod::mma_16816(acc[mi][nj], a[mi], b[0], b[1]);
          ucod::mma_16816(acc[mi][nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's copies
  }

  // epilogue: h1 = bf16(acc + b1), out = bf16(gelu_tanh(h1)) in f32
  const auto act = [](float a, float b) {
    return gelu_tanh(__bfloat162float(__float2bfloat16_rn(a + b)));
  };
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi) {
    const int r0 = row0 + wm * kTm + mi * 16 + g;
#pragma unroll
    for (int nj = 0; nj < kNi; ++nj) {
      const int c = n0 + wn * kTn + nj * 8 + 2 * t;
      const float bias0 = b1[c];
      const float bias1 = b1[c + 1];
      if (r0 < rows) {
        *reinterpret_cast<uint32_t*>(out + (int64_t)r0 * f + c) =
            ucod::pack_bf16x2(act(acc[mi][nj][0], bias0), act(acc[mi][nj][1], bias1));
      }
      if (r0 + 8 < rows) {
        *reinterpret_cast<uint32_t*>(out + (int64_t)(r0 + 8) * f + c) =
            ucod::pack_bf16x2(act(acc[mi][nj][2], bias0), act(acc[mi][nj][3], bias1));
      }
    }
  }
}

}  // namespace

// x: contiguous bf16 (rows, d); gamma/beta: f32 (d,); w1: contiguous bf16
// (f, d) in (out, in) layout; b1: f32 (f,); out: bf16 (rows, f).  Requires
// d % 64 == 0, d <= 1024, f % 256 == 0, 16-byte aligned pointers.  Launches on
// `stream`; returns the launch's cudaError_t.
extern "C" int ucod_layernorm_fc1_gelu(const void* x, const void* gamma, const void* beta, const void* w1,
                                       const void* b1, void* out, int rows, int d, int f, float eps,
                                       void* stream) {
  if (d % kBlockK != 0 || d > 1024 || f % kBN != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(d);
  const cudaError_t err =
      cudaFuncSetAttribute(layernorm_fc1_gelu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(f / kBN, (rows + kBM - 1) / kBM);
  layernorm_fc1_gelu_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<__nv_bfloat16*>(out), rows, d, f, eps);
  return static_cast<int>(cudaGetLastError());
}
