// Backward of packed multi-head attention from a saved log-sum-exp, bf16 in,
// f32 accumulate, bf16 out.  The port of K3 and K4.
//
// Replaces the TPU kernels of ucod_dpl_tpu/ops/attention.py:
//   * _attention_bwd_kernel_headpair (launched by _pallas_attention_packed_bwd),
//     the whole-KV flash backward the VJP takes at 518px (L = 1370);
//   * _bwd2d_dq_kernel + _bwd2d_dkv_kernel (prelude _bwd2d_prelude, launched
//     by _pallas_attention_packed_bwd_longl), the KV-blocked backward from
//     saved denominators the VJP takes at 756px (L = 2917).
// On the TPU the choice between the two is a VMEM law; here one
// FlashAttention-2 style scheme covers every length.  With s = scale q k^T,
// P = exp(s - lse) (lse from the forward, attention_fwd.cu), D = rowsum(dO o O):
//   dS = P o (dO V^T - D) * scale, rounded to bf16 before its matmuls;
//   dQ = dS K,  dK = dS^T Q,  dV = P^T dO with P rounded to bf16,
// every product accumulated in f32 and rounded to bf16 once at the store
// (the rounding points of the JAX kernels).
//
// What bounds it on the H100: at bs16 / 518px (L = 1370, 12 heads of 64) one
// call is 7 * 2 * B * H * L^2 * 64 = 323 GFLOP (S and dP are computed by
// both kernels) against about 270 MB of q/k/v/o/dO/dq/dk/dv, so the tensor
// cores bound it, not HBM.  Design, kept simple (no wgmma, TMA or atomics):
//   * a pre-pass computes D in f32, one warp per (row, head);
//   * the dK/dV kernel gives each CTA of 4 warps one 64-row K/V tile (each
//     warp 16 keys, K and V fragments held in registers) and loops over every
//     q tile, double-buffering Q/dO tiles with cp.async.  It works on the
//     transposed scores S^T = K Q^T, whose accumulators are exactly the A
//     fragments of P^T and dS^T for dV += P^T dO and dK += dS^T Q;
//   * the dQ kernel gives each CTA one 64-row q tile and loops over every
//     K/V tile, as the forward does;
//   * no CTA depends on another, so no cross-block carry (the TPU kernels
//     accumulate dK/dV over sequential grid steps) and no atomic exists, and
//     the result is deterministic;
//   * it never reads a row >= L: such rows are zero-filled in shared memory,
//     key columns >= L get P = 0 in the dQ kernel, and query rows >= L get
//     lse = +inf (P = 0) and D = 0, so they add nothing to dK/dV; dK/dV rows
//     >= L and dQ rows >= L are not written.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kBlock = 64;  // rows of a q tile and of a K/V tile
constexpr int kWarps = kBlock / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kLds = kHeadDim + 8;  // padded row: conflict-free fragment loads
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDotWarps = 8;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void load_tile(bf16 (*dst)[kLds], const bf16* src, int row0, int seq_len,
                                          int64_t row_stride) {
  ucod::load_rows64<kBlock, kLds, kThreads>(dst, src, row0, seq_len, row_stride);
}

// A fragments (16 rows x 64 columns, four k-steps) of rows [wr, wr + 16) of a
// shared tile, held in registers for a whole loop.
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[kHeadDim / 16][4], const bf16 (*src)[kLds],
                                             int wr, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
    a[kk][0] = ucod::ld_bf16x2(&src[wr + g][16 * kk + 2 * t]);
    a[kk][1] = ucod::ld_bf16x2(&src[wr + g + 8][16 * kk + 2 * t]);
    a[kk][2] = ucod::ld_bf16x2(&src[wr + g][16 * kk + 8 + 2 * t]);
    a[kk][3] = ucod::ld_bf16x2(&src[wr + g + 8][16 * kk + 8 + 2 * t]);
  }
}

// c[j] = A * B^T for a warp's 16 rows x 64 columns, where A comes in
// registers and B is a row-major [column][dim] shared tile.
__device__ __forceinline__ void mma_abt(float (&c)[kBlock / 8][4], const uint32_t (&a)[kHeadDim / 16][4],
                                        const bf16 (*b)[kLds], int g, int t) {
#pragma unroll
  for (int j = 0; j < kBlock / 8; ++j) {
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      const bf16* br = &b[8 * j + g][16 * kk + 2 * t];
      ucod::mma_16816(c[j], a[kk], ucod::ld_bf16x2(br), ucod::ld_bf16x2(br + 8));
    }
  }
}

// acc += C * B for a warp's 16 rows, where C (16 x 64, f32 accumulators of
// mma_abt's layout) is rounded to bf16 as the A operand and B is a row-major
// [k][dim] shared tile delivered through ldmatrix.trans.
__device__ __forceinline__ void mma_cb(float (&acc)[kHeadDim / 8][4], const float (&c)[kBlock / 8][4],
                                       const bf16 (*b)[kLds], int lane) {
  const int mat = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < kBlock / 16; ++kk) {
    const uint32_t a[4] = {
        ucod::pack_bf16x2(c[2 * kk][0], c[2 * kk][1]),
        ucod::pack_bf16x2(c[2 * kk][2], c[2 * kk][3]),
        ucod::pack_bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1]),
        ucod::pack_bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3]),
    };
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; j += 2) {
      uint32_t bb[4];
      ucod::ldmatrix_x4_trans(bb, &b[16 * kk + (mat & 1) * 8 + (lane & 7)][8 * (j + (mat >> 1))]);
      ucod::mma_16816(acc[j], a, bb[0], bb[1]);
      ucod::mma_16816(acc[j + 1], a, bb[2], bb[3]);
    }
  }
}

// Rows r0 and r0 + 8 of a warp's f32 accumulators, rounded to bf16, into the
// packed layout; rows >= seq_len are not written.
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[kHeadDim / 8][4], int r0,
                                           int seq_len, int64_t row_stride, int t) {
#pragma unroll
  for (int j = 0; j < kHeadDim / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (r0 < seq_len) {
      *reinterpret_cast<uint32_t*>(dst + (int64_t)r0 * row_stride + c) =
          ucod::pack_bf16x2(acc[j][0], acc[j][1]);
    }
    if (r0 + 8 < seq_len) {
      *reinterpret_cast<uint32_t*>(dst + (int64_t)(r0 + 8) * row_stride + c) =
          ucod::pack_bf16x2(acc[j][2], acc[j][3]);
    }
  }
}

// D[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d] in f32; warp w handles
// packed row w / num_heads, head w % num_heads.
__global__ void __launch_bounds__(32 * kDotWarps)
    attention_bwd_dot_kernel(const bf16* __restrict__ o, const bf16* __restrict__ d_o,
                             float* __restrict__ dsum, int64_t n_rows, int seq_len, int num_heads) {
  const int64_t w = (int64_t)blockIdx.x * kDotWarps + (threadIdx.x >> 5);
  if (w >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t off = w * kHeadDim + 2 * lane;  // (b * L + i) * H * 64 + h * 64
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + off));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(d_o + off));
  const float s = ucod::warp_sum(a.x * c.x + a.y * c.y);
  if (lane == 0) {
    const int h = (int)(w % num_heads);
    const int64_t bi = w / num_heads;
    const int64_t b = bi / seq_len;
    dsum[(b * num_heads + h) * seq_len + bi % seq_len] = s;
  }
}

struct SmemDkv {
  bf16 q[2][kBlock][kLds];    // stage 1 holds the K tile before the loop
  bf16 d_o[2][kBlock][kLds];  // stage 1 holds the V tile before the loop
  float lse2[2][kBlock];      // lse * log2 e; +inf for rows >= seq_len
  float dsum[2][kBlock];      // D; 0 for rows >= seq_len
};

__device__ __forceinline__ void load_row_stats(float* lse2, float* dsum, const float* lse_h,
                                               const float* dsum_h, int row0, int seq_len) {
  if (threadIdx.x < kBlock) {
    const int row = row0 + threadIdx.x;
    const bool valid = row < seq_len;
    lse2[threadIdx.x] = valid ? lse_h[row] * kLog2e : INFINITY;
    dsum[threadIdx.x] = valid ? dsum_h[row] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ d_o,
                             const float* __restrict__ lse, const float* __restrict__ dsum,
                             bf16* __restrict__ dk, bf16* __restrict__ dv, int seq_len, int num_heads,
                             float scale, float scale_log2) {
  __shared__ __align__(16) SmemDkv sm;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.y / num_heads;
  const int h = blockIdx.y % num_heads;
  const int k0 = blockIdx.x * kBlock;
  const int64_t row_stride = (int64_t)num_heads * kHeadDim;
  const int64_t head_base = (int64_t)b * seq_len * row_stride + (int64_t)h * kHeadDim;
  const bf16* qh = q + head_base;
  const bf16* doh = d_o + head_base;
  const float* lse_h = lse + (int64_t)blockIdx.y * seq_len;
  const float* dsum_h = dsum + (int64_t)blockIdx.y * seq_len;

  load_tile(sm.q[1], k + head_base, k0, seq_len, row_stride);
  load_tile(sm.d_o[1], v + head_base, k0, seq_len, row_stride);
  load_tile(sm.q[0], qh, 0, seq_len, row_stride);
  load_tile(sm.d_o[0], doh, 0, seq_len, row_stride);
  ucod::cp_async_commit();
  load_row_stats(sm.lse2[0], sm.dsum[0], lse_h, dsum_h, 0, seq_len);
  ucod::cp_async_wait<0>();
  __syncthreads();

  const int wr = warp * 16;  // this warp's first key within the K/V tile
  uint32_t ka[kHeadDim / 16][4], va[kHeadDim / 16][4];
  load_a_frags(ka, sm.q[1], wr, g, t);
  load_a_frags(va, sm.d_o[1], wr, g, t);
  __syncthreads();  // stage 1 is refilled below

  float dk_acc[kHeadDim / 8][4], dv_acc[kHeadDim / 8][4];
#pragma unroll
  for (int j = 0; j < kHeadDim / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }

  const int n_tiles = (seq_len + kBlock - 1) / kBlock;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int st = qt & 1;
    if (qt + 1 < n_tiles) {
      load_tile(sm.q[st ^ 1], qh, (qt + 1) * kBlock, seq_len, row_stride);
      load_tile(sm.d_o[st ^ 1], doh, (qt + 1) * kBlock, seq_len, row_stride);
      ucod::cp_async_commit();
      load_row_stats(sm.lse2[st ^ 1], sm.dsum[st ^ 1], lse_h, dsum_h, (qt + 1) * kBlock, seq_len);
    }

    // P^T = exp2(S^T * scale log2 e - lse log2 e): 16 keys x 64 queries
    float s[kBlock / 8][4];
    mma_abt(s, ka, sm.q[st], g, t);
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] * scale_log2 - sm.lse2[st][8 * j + 2 * t + (e & 1)]);
      }
    }
    // dP^T = V dO^T, then dS^T = P^T o (dP^T - D) * scale
    float ds[kBlock / 8][4];
    mma_abt(ds, va, sm.d_o[st], g, t);
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ds[j][e] = s[j][e] * (ds[j][e] - sm.dsum[st][8 * j + 2 * t + (e & 1)]) * scale;
      }
    }
    mma_cb(dv_acc, s, sm.d_o[st], lane);  // dV += P^T dO
    mma_cb(dk_acc, ds, sm.q[st], lane);   // dK += dS^T Q

    if (qt + 1 < n_tiles) ucod::cp_async_wait<0>();
    __syncthreads();  // stage st is refilled by the next iteration's copies
  }

  const int r0 = k0 + wr + g;
  store_rows(dk + head_base, dk_acc, r0, seq_len, row_stride, t);
  store_rows(dv + head_base, dv_acc, r0, seq_len, row_stride, t);
}

struct SmemDq {
  bf16 k[2][kBlock][kLds];  // stage 1 holds the Q tile before the loop
  bf16 v[2][kBlock][kLds];  // stage 1 holds the dO tile before the loop
};

__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ d_o,
                            const float* __restrict__ lse, const float* __restrict__ dsum,
                            bf16* __restrict__ dq, int seq_len, int num_heads, float scale,
                            float scale_log2) {
  __shared__ __align__(16) SmemDq sm;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.y / num_heads;
  const int h = blockIdx.y % num_heads;
  const int q0 = blockIdx.x * kBlock;
  const int64_t row_stride = (int64_t)num_heads * kHeadDim;
  const int64_t head_base = (int64_t)b * seq_len * row_stride + (int64_t)h * kHeadDim;
  const bf16* kh = k + head_base;
  const bf16* vh = v + head_base;

  load_tile(sm.k[1], q + head_base, q0, seq_len, row_stride);
  load_tile(sm.v[1], d_o + head_base, q0, seq_len, row_stride);
  load_tile(sm.k[0], kh, 0, seq_len, row_stride);
  load_tile(sm.v[0], vh, 0, seq_len, row_stride);
  ucod::cp_async_commit();

  // this thread's rows r0 and r0 + 8: lse * log2 e (+inf past L) and D (0)
  const int wr = warp * 16;
  const int r0 = q0 + wr + g;
  const float* lse_h = lse + (int64_t)blockIdx.y * seq_len;
  const float* dsum_h = dsum + (int64_t)blockIdx.y * seq_len;
  float lse2[2], drow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    lse2[i] = row < seq_len ? lse_h[row] * kLog2e : INFINITY;
    drow[i] = row < seq_len ? dsum_h[row] : 0.f;
  }
  ucod::cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[kHeadDim / 16][4], da[kHeadDim / 16][4];
  load_a_frags(qa, sm.k[1], wr, g, t);
  load_a_frags(da, sm.v[1], wr, g, t);
  __syncthreads();  // stage 1 is refilled below

  float dq_acc[kHeadDim / 8][4];
#pragma unroll
  for (int j = 0; j < kHeadDim / 8; ++j) dq_acc[j][0] = dq_acc[j][1] = dq_acc[j][2] = dq_acc[j][3] = 0.f;

  const int n_tiles = (seq_len + kBlock - 1) / kBlock;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_tiles) {
      load_tile(sm.k[st ^ 1], kh, (kt + 1) * kBlock, seq_len, row_stride);
      load_tile(sm.v[st ^ 1], vh, (kt + 1) * kBlock, seq_len, row_stride);
      ucod::cp_async_commit();
    }

    // P = exp2(S * scale log2 e - lse log2 e), 0 for key columns >= seq_len
    const int k0 = kt * kBlock;
    float s[kBlock / 8][4];
    mma_abt(s, qa, sm.k[st], g, t);
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        s[j][e] = col < seq_len ? exp2f(s[j][e] * scale_log2 - lse2[e >> 1]) : 0.f;
      }
    }
    // dP = dO V^T, then dS = P o (dP - D) * scale
    float ds[kBlock / 8][4];
    mma_abt(ds, da, sm.v[st], g, t);
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = s[j][e] * (ds[j][e] - drow[e >> 1]) * scale;
    }
    mma_cb(dq_acc, ds, sm.k[st], lane);  // dQ += dS K

    if (kt + 1 < n_tiles) ucod::cp_async_wait<0>();
    __syncthreads();  // stage st is refilled by the next iteration's copies
  }

  store_rows(dq + head_base, dq_acc, r0, seq_len, row_stride, t);
}

}  // namespace

// q, k, v, o, d_o, dq, dk, dv: contiguous bf16 (batch, seq_len, num_heads *
// 64), 16-byte aligned; lse: contiguous f32 (batch, num_heads, seq_len) from
// ucod_attention_fwd_lse; dsum: f32 scratch of the same shape.  Launches the
// D pre-pass, the dK/dV kernel and the dQ kernel on `stream`; returns the
// first failed launch's cudaError_t, or 0.
extern "C" int ucod_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                  const void* d_o, const void* lse, void* dsum, void* dq, void* dk,
                                  void* dv, int batch, int seq_len, int num_heads, float scale,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_rows = (int64_t)batch * seq_len * num_heads;
  attention_bwd_dot_kernel<<<(unsigned)((n_rows + kDotWarps - 1) / kDotWarps), 32 * kDotWarps, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(d_o), static_cast<float*>(dsum), n_rows,
      seq_len, num_heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq_len + kBlock - 1) / kBlock, batch * num_heads);
  const float scale_log2 = scale * kLog2e;
  attention_bwd_dkv_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(d_o), static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq_len, num_heads, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(d_o), static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<bf16*>(dq), seq_len, num_heads, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
