// K1: packed multi-head attention forward, bf16 in, f32 accumulate; with an
// f32 log-sum-exp output it is also the port of K2.
//
// Replaces the TPU kernel ucod_dpl_tpu/ops/attention.py::_attention_kernel_headpair
// (launched by _pallas_attention_packed): o = softmax(q k^T * scale) v per
// head, with q/k/v/o in the packed (B, L, num_heads * 64) projection layout.
// The entry ucod_attention_fwd_lse replaces _attention_kernel_headpair_stats
// (launched by _pallas_attention_packed_stats), the forward of the
// differentiated path: it also writes lse = ln sum_j exp(scale q.k_j) per
// query row, f32 (B, num_heads, L), which the backward
// (attention_bwd.cu) recomputes the probabilities from.  The TPU kernel
// saves the shifted denominator den = sum exp2(s log2 e - 30) instead;
// lse = ln(den) + 30 ln 2.  Here lse = m ln 2 + ln l from the online
// softmax's running max m (log2 units) and sum l: one store per row.
//
// What bounds it on the H100: at bs16 / 518px (L = 1370, 12 heads of 64) one
// call is 4 * B * H * L^2 * 64 = 92 GFLOP against 135 MB of q/k/v/o, about
// 680 FLOP per byte, so the tensor cores bound it, not HBM; the L x L score
// matrix never leaves the SM.  Design, FlashAttention-2 style and kept simple:
//   * one CTA of 4 warps per (64-row q tile, batch * head); each warp owns 16
//     query rows and loops over 64-row K/V tiles with mma.sync m16n8k16;
//   * heads are read straight from the packed layout by stride (row stride
//     num_heads * 64), so no split/merge transposes exist;
//   * K/V tiles are double-buffered in shared memory with cp.async;
//   * online softmax in the exp2 domain with a running row max (scale * log2 e
//     arrives folded into `scale_log2`), so no fixed-shift guard band exists;
//   * it never reads a row >= L: the copies of such rows are zero-filled and
//     key columns >= L get a -inf score, so L need not be a multiple of 64
//     (1370 = 21 * 64 + 26).
// Not yet used: wgmma, TMA, warp specialisation (later work).

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = kBlockQ / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kLds = kHeadDim + 8;  // padded row: conflict-free fragment loads
constexpr float kLn2 = 0.69314718055994531f;
static_assert(kBlockQ == kBlockK, "load_tile serves both q and k/v tiles");

struct Smem {
  __nv_bfloat16 q[kBlockQ][kLds];
  __nv_bfloat16 k[2][kBlockK][kLds];
  __nv_bfloat16 v[2][kBlockK][kLds];
};

// Rows [row0, row0 + 64) of one head into shared memory; rows >= seq_len
// are zero-filled and never read from global memory.
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[kLds], const __nv_bfloat16* src,
                                          int row0, int seq_len, int64_t row_stride) {
  ucod::load_rows64<kBlockK, kLds, kThreads>(dst, src, row0, seq_len, row_stride);
}

template <bool kLse>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int seq_len, int num_heads, float scale_log2) {
  __shared__ __align__(16) Smem sm;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.y / num_heads;
  const int h = blockIdx.y % num_heads;
  const int q0 = blockIdx.x * kBlockQ;
  const int64_t row_stride = (int64_t)num_heads * kHeadDim;
  const int64_t head_base = (int64_t)b * seq_len * row_stride + (int64_t)h * kHeadDim;
  const __nv_bfloat16* qh = q + head_base;
  const __nv_bfloat16* kh = k + head_base;
  const __nv_bfloat16* vh = v + head_base;

  load_tile(sm.q, qh, q0, seq_len, row_stride);
  load_tile(sm.k[0], kh, 0, seq_len, row_stride);
  load_tile(sm.v[0], vh, 0, seq_len, row_stride);
  ucod::cp_async_commit();

  const int wr = warp * 16;  // this warp's first row within the q tile
  uint32_t qa[kHeadDim / 16][4];
  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int j = 0; j < kHeadDim / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // running max (log2 units) and partial denominators for rows g and g + 8
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  const int n_tiles = (seq_len + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_tiles) {
      load_tile(sm.k[st ^ 1], kh, (kt + 1) * kBlockK, seq_len, row_stride);
      load_tile(sm.v[st ^ 1], vh, (kt + 1) * kBlockK, seq_len, row_stride);
      ucod::cp_async_commit();
      ucod::cp_async_wait<1>();
    } else {
      ucod::cp_async_wait<0>();
    }
    __syncthreads();

    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        qa[kk][0] = ucod::ld_bf16x2(&sm.q[wr + g][16 * kk + 2 * t]);
        qa[kk][1] = ucod::ld_bf16x2(&sm.q[wr + g + 8][16 * kk + 2 * t]);
        qa[kk][2] = ucod::ld_bf16x2(&sm.q[wr + g][16 * kk + 8 + 2 * t]);
        qa[kk][3] = ucod::ld_bf16x2(&sm.q[wr + g + 8][16 * kk + 8 + 2 * t]);
      }
    }

    // S = Q K^T for this warp's 16 rows x 64 keys (B[k][n] = K[n][k]).
    float s[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        const __nv_bfloat16* kr = &sm.k[st][8 * j + g][16 * kk + 2 * t];
        ucod::mma_16816(s[j], qa[kk], ucod::ld_bf16x2(kr), ucod::ld_bf16x2(kr + 8));
      }
    }

    // scale into log2 units, mask key columns >= seq_len, online softmax
    const int k0 = kt * kBlockK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        s[j][e] = col < seq_len ? s[j][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2], mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      mu[i] = m_new == -INFINITY ? 0.f : m_new;  // a row with no finite score yet
      alpha[i] = exp2f(m[i] - mu[i]);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - mu[e >> 1]);
        l[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V.  The S accumulators of key tiles 2kk and 2kk+1 are exactly
    // the A fragment of P for k-step kk; V's B fragments come transposed
    // from its row-major [key][dim] tile through ldmatrix.trans.
    const int mat = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t pa[4] = {
          ucod::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
          ucod::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
          ucod::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          ucod::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int j = 0; j < kHeadDim / 8; j += 2) {
        uint32_t vb[4];
        ucod::ldmatrix_x4_trans(
            vb, &sm.v[st][16 * kk + (mat & 1) * 8 + (lane & 7)][8 * (j + (mat >> 1))]);
        ucod::mma_16816(acc[j], pa, vb[0], vb[1]);
        ucod::mma_16816(acc[j + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's copies
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / l[i];
  }
  const int r0 = q0 + wr + g;
  __nv_bfloat16* oh = o + head_base;
#pragma unroll
  for (int j = 0; j < kHeadDim / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (r0 < seq_len) {
      *reinterpret_cast<uint32_t*>(oh + (int64_t)r0 * row_stride + c) =
          ucod::pack_bf16x2(acc[j][0] * inv[0], acc[j][1] * inv[0]);
    }
    if (r0 + 8 < seq_len) {
      *reinterpret_cast<uint32_t*>(oh + (int64_t)(r0 + 8) * row_stride + c) =
          ucod::pack_bf16x2(acc[j][2] * inv[1], acc[j][3] * inv[1]);
    }
  }
  if (kLse && t == 0) {
    float* lh = lse + (int64_t)blockIdx.y * seq_len;
    if (r0 < seq_len) lh[r0] = m[0] * kLn2 + logf(l[0]);
    if (r0 + 8 < seq_len) lh[r0 + 8] = m[1] * kLn2 + logf(l[1]);
  }
}

}  // namespace

// q, k, v, o: contiguous bf16 (batch, seq_len, num_heads * 64), 16-byte
// aligned.  Launches on `stream`; returns the launch's cudaError_t.
extern "C" int ucod_attention_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                                  int seq_len, int num_heads, float scale_log2, void* stream) {
  const dim3 grid((seq_len + kBlockQ - 1) / kBlockQ, batch * num_heads);
  attention_fwd_kernel<false><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), nullptr, seq_len,
      num_heads, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// As ucod_attention_fwd, and also lse: contiguous f32 (batch, num_heads,
// seq_len), the natural-log log-sum-exp of each query row's scaled scores.
extern "C" int ucod_attention_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int batch, int seq_len, int num_heads,
                                      float scale_log2, void* stream) {
  const dim3 grid((seq_len + kBlockQ - 1) / kBlockQ, batch * num_heads);
  attention_fwd_kernel<true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), seq_len, num_heads, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
