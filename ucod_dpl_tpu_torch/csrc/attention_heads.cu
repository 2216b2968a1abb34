// K5: attention on the per-head (BH, L, d) layout, bf16 in, f32 accumulate.
//
// Replaces the TPU kernel ucod_dpl_tpu/ops/attention.py::_attention_kernel
// (launched by _pallas_attention): o = softmax(q k^T * scale) v for each of
// BH independent (L, d) heads.  multi_head_attention splits to this layout
// whenever the packed kernel (K1, attention_fwd.cu) cannot take the heads:
// an odd head count or a head_dim other than 64.  Its product path is
// tensor-parallel feature extraction, where each `model` shard holds
// num_heads / tp heads (dinov2-base over 4 shards: 3 heads of 64).
//
// What bounds it on the H100: at the TP path's shape (BH = 16 * 3 = 48,
// L = 1370, d = 64) one call is 4 * BH * L^2 * d = 23.1 GFLOP against 33.7 MB
// of q/k/v/o, about 680 FLOP per byte, so the tensor cores bound it (0.023 ms
// at 989 TFLOP/s), not HBM; the L x L score matrix never leaves the SM.
// Design: K1's FlashAttention-2 forward, with the head as the grid's y index
// and the row stride d:
//   * one CTA of 4 warps per (64-row q tile, head); each warp owns 16 query
//     rows and loops over 64-row K/V tiles with mma.sync m16n8k16;
//   * K/V tiles are double-buffered in dynamic shared memory with cp.async
//     ((64 + 4 * 64) rows of d + 8 bf16: 46 KB at d = 64, 87 KB at d = 128);
//   * online softmax in the exp2 domain with a running row max (scale *
//     log2 e arrives folded into `scale_log2`);
//   * it never reads a row >= L: such rows are zero-filled in shared memory
//     (the TPU kernel zeroes V rows past seq_len for the same reason) and key
//     columns >= L get a -inf score; rows >= L are never stored.
// Instantiated for d in {16, 32, 64, 128}; the entry point refuses any other.
// Not yet used: wgmma, TMA, warp specialisation (later work).

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = kBlockQ / 16;
constexpr int kThreads = 32 * kWarps;

template <int D>
constexpr int smem_bytes() {
  return (kBlockQ + 4 * kBlockK) * (D + 8) * 2;
}

// Rows [row0, row0 + 64) of one (seq_len, D) head into a padded shared tile;
// rows >= seq_len are zero-filled and never read from global memory.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                          int seq_len) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < kBlockK * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const int row = row0 + r;
    const bool valid = row < seq_len;
    ucod::cp_async16(dst + r * (D + 8) + c, src + (int64_t)(valid ? row : 0) * D + c, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    attention_heads_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                           int seq_len, float scale_log2) {
  static_assert(D % 16 == 0 && D >= 16, "mma k-steps of 16, V fragments in pairs of 8 columns");
  constexpr int kLd = D + 8;  // padded row: conflict-free fragment loads
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sk = sq + kBlockQ * kLd;  // [2][kBlockK][kLd]
  __nv_bfloat16* sv = sk + 2 * kBlockK * kLd;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kBlockQ;
  const int64_t head_base = (int64_t)blockIdx.y * seq_len * D;
  const __nv_bfloat16* qh = q + head_base;
  const __nv_bfloat16* kh = k + head_base;
  const __nv_bfloat16* vh = v + head_base;

  load_tile<D>(sq, qh, q0, seq_len);
  load_tile<D>(sk, kh, 0, seq_len);
  load_tile<D>(sv, vh, 0, seq_len);
  ucod::cp_async_commit();

  const int wr = warp * 16;  // this warp's first row within the q tile
  uint32_t qa[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // running max (log2 units) and partial denominators for rows g and g + 8
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  const int n_tiles = (seq_len + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    const __nv_bfloat16* ks = sk + st * kBlockK * kLd;
    const __nv_bfloat16* vs = sv + st * kBlockK * kLd;
    if (kt + 1 < n_tiles) {
      load_tile<D>(sk + (st ^ 1) * kBlockK * kLd, kh, (kt + 1) * kBlockK, seq_len);
      load_tile<D>(sv + (st ^ 1) * kBlockK * kLd, vh, (kt + 1) * kBlockK, seq_len);
      ucod::cp_async_commit();
      ucod::cp_async_wait<1>();
    } else {
      ucod::cp_async_wait<0>();
    }
    __syncthreads();

    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        qa[kk][0] = ucod::ld_bf16x2(sq + (wr + g) * kLd + 16 * kk + 2 * t);
        qa[kk][1] = ucod::ld_bf16x2(sq + (wr + g + 8) * kLd + 16 * kk + 2 * t);
        qa[kk][2] = ucod::ld_bf16x2(sq + (wr + g) * kLd + 16 * kk + 8 + 2 * t);
        qa[kk][3] = ucod::ld_bf16x2(sq + (wr + g + 8) * kLd + 16 * kk + 8 + 2 * t);
      }
    }

    // S = Q K^T for this warp's 16 rows x 64 keys (B[k][n] = K[n][k]).
    float s[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = ks + (8 * j + g) * kLd + 16 * kk + 2 * t;
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
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: the S accumulators of key tiles 2kk and 2kk+1 are the A
    // fragment of P for k-step kk; V's B fragments come transposed from its
    // row-major [key][dim] tile through ldmatrix.trans.
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
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t vb[4];
        ucod::ldmatrix_x4_trans(
            vb, vs + (16 * kk + (mat & 1) * 8 + (lane & 7)) * kLd + 8 * (j + (mat >> 1)));
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
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (r0 < seq_len) {
      *reinterpret_cast<uint32_t*>(oh + (int64_t)r0 * D + c) =
          ucod::pack_bf16x2(acc[j][0] * inv[0], acc[j][1] * inv[0]);
    }
    if (r0 + 8 < seq_len) {
      *reinterpret_cast<uint32_t*>(oh + (int64_t)(r0 + 8) * D + c) =
          ucod::pack_bf16x2(acc[j][2] * inv[1], acc[j][3] * inv[1]);
    }
  }
}

template <int D>
int launch_attention_heads(const void* q, const void* k, const void* v, void* o, int bh, int seq_len,
                           float scale_log2, void* stream) {
  const auto kernel = attention_heads_kernel<D>;
  constexpr int smem = smem_bytes<D>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq_len + kBlockQ - 1) / kBlockQ, bh);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), seq_len, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous bf16 (bh, seq_len, head_dim), 16-byte aligned;
// head_dim in {16, 32, 64, 128}, 1 <= bh <= 65535.  Launches on `stream`;
// returns the launch's cudaError_t (cudaErrorInvalidValue for another
// head_dim).
extern "C" int ucod_attention_heads(const void* q, const void* k, const void* v, void* o, int bh,
                                    int seq_len, int head_dim, float scale_log2, void* stream) {
  switch (head_dim) {
    case 16:
      return launch_attention_heads<16>(q, k, v, o, bh, seq_len, scale_log2, stream);
    case 32:
      return launch_attention_heads<32>(q, k, v, o, bh, seq_len, scale_log2, stream);
    case 64:
      return launch_attention_heads<64>(q, k, v, o, bh, seq_len, scale_log2, stream);
    case 128:
      return launch_attention_heads<128>(q, k, v, o, bh, seq_len, scale_log2, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
