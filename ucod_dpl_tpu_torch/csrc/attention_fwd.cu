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
// call is 4 * B * H * L^2 * 64 = 92 GFLOP, 0.093 ms at the 989 TFLOP/s bf16
// peak, against 135 MB of q/k/v/o (0.040 ms at 3.35 TB/s): the tensor cores
// bound it, not HBM.  At head dim 64 the exponentials weigh as much: one
// ex2 per score, B * H * L^2 = 360 M of them, and the SM's MUFU unit does 16
// a clock, about 0.09 ms over 132 SMs.  A kernel that runs the products and
// the softmax one after the other pays the sum of the two.  The design, in
// the outline of FlashAttention-3, built from Hopper's own parts
// (hopper.cuh):
//   * warp-specialised CTAs, one per SM, persistent: each takes the work
//     tiles (128-row q tile, batch * head) blockIdx.x, + gridDim.x, ...; one
//     producer warp issues TMA loads (registers dropped to 24 with
//     setmaxnreg), two consumer warpgroups own 64 query rows each (registers
//     raised to 240); at L = 1370 the last q tile holds 1408 - 1370 = 38
//     rows past L, which are computed and not stored;
//   * 3-D tensor maps over q, k and v as (H * 64 columns, L rows, B) with a
//     box of 64 columns (128 bytes, 128-byte swizzle) x 128 rows; the head
//     is the column coordinate.  Rows >= L lie outside the map: TMA fills
//     them with zeros and never reads past the tensor;
//   * K and V tiles of 128 keys through a three-stage ring with full/empty
//     mbarriers that runs on from one work tile to the next, and Q through
//     a buffer freed as soon as the tile's last S product is done, so the
//     next tile's loads overlap this tile's last products and epilogue;
//   * S = Q K^T by wgmma m64n128k16 with both operands in shared memory;
//     O += P V by wgmma m64n64k16 with P as bf16 A fragments straight from
//     the S accumulators and V read MN-major (transpose bit);
//   * the softmax kept off the critical path: the two consumer warpgroups
//     take turns issuing their wgmmas (named barriers, "ping-pong"), and in
//     each warpgroup the S product of tile j is issued together with the PV
//     product of tile j - 1 before tile j's softmax runs, so the
//     exponentials of one warpgroup run under the wgmmas of both;
//     per score one FFMA folds the scale into the exponent (exp2(s *
//     scale_log2 - m)), and the key mask (col >= L -> -inf) is applied on
//     the last K/V tile only; rows with no finite score yet keep the
//     running-max guard (m = -inf -> shift 0);
//   * the epilogue rounds O / l to bf16 once and stores rows < L.

#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 64;
constexpr int kConsumers = 2;             // warpgroups of 64 query rows
constexpr int kBlockQ = 64 * kConsumers;  // query rows per CTA
constexpr int kBlockK = 128;              // keys per K/V tile
constexpr int kStages = 3;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr uint32_t kKvBytes = kBlockK * kHeadDim * 2;
constexpr uint32_t kQBytes = kBlockQ * kHeadDim * 2;
constexpr int kSchedBar = 1;  // named barriers 1, 2: the consumers' turns
constexpr float kLn2 = 0.69314718055994531f;

struct Smem {  // every tile 1024-byte aligned (128-byte swizzle atoms)
  bf16 q[kBlockQ * kHeadDim];
  bf16 k[kStages][kBlockK * kHeadDim];
  bf16 v[kStages][kBlockK * kHeadDim];
  uint64_t q_full, q_empty;
  uint64_t k_full[kStages], k_empty[kStages], v_full[kStages], v_empty[kStages];
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // + alignment slack

// S = Q K^T for a warpgroup's 64 rows x 128 keys (one commit group).
__device__ __forceinline__ void issue_s(float (&s)[kBlockK / 2], const bf16* q_tile, const bf16* k_tile) {
  ucod::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
    ucod::wgmma_m64n128k16_ss<0, 0>(s, ucod::desc_kmajor(q_tile, kk), ucod::desc_kmajor(k_tile, kk), kk);
  }
  ucod::wgmma_commit();
}

// O += P V, P from registers, V read MN-major (one commit group).
__device__ __forceinline__ void issue_pv(float (&acc)[kHeadDim / 2], const uint32_t (&pa)[kBlockK / 16][4],
                                         const bf16* v_tile) {
  ucod::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    ucod::wgmma_m64n64k16_rs<1>(acc, pa[kk], ucod::desc_mnmajor(v_tile, kk), 1);
  }
  ucod::wgmma_commit();
}

// One K/V tile of the online softmax for this thread's rows g and g + 8:
// masks keys >= L (only a tile that reaches past L has any), updates the
// running max m (log2 units) and sum l, sets alpha to the rescale O owes,
// and turns S into P = exp2(s * scale_log2 - m) in place.
__device__ __forceinline__ void online_softmax(float (&s)[kBlockK / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int k0, int seq_len, int tq, float scale_log2) {
  if (k0 + kBlockK > seq_len) {
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) {
      if (k0 + 8 * (i >> 2) + 2 * tq + (i & 1) >= seq_len) s[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kBlockK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    mu[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with no finite score yet
    alpha[r] = ucod::exp2_ftz(m[r] - mu[r]);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < kBlockK / 2; ++i) {
    s[i] = ucod::exp2_ftz(fmaf(s[i], scale_log2, -mu[(i >> 1) & 1]));
    l[(i >> 1) & 1] += s[i];
  }
}

// The S accumulators of key blocks 2k and 2k + 1 as the bf16 A fragment of
// k-step k of O += P V (see hopper.cuh).
__device__ __forceinline__ void to_a_frags(uint32_t (&pa)[kBlockK / 16][4], const float (&s)[kBlockK / 2]) {
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = ucod::pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  }
}

template <bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
    attention_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, float* __restrict__ lse,
                         int seq_len, int num_heads, int n_work, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (ucod::smem_addr(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128;
  const int n_qt = (seq_len + kBlockQ - 1) / kBlockQ;
  const int n_kv = (seq_len + kBlockK - 1) / kBlockK;

  if (threadIdx.x == 0) {
    ucod::mbar_init(&sm.q_full, 1);
    ucod::mbar_init(&sm.q_empty, 4 * kConsumers);  // lane 0 of every consumer warp
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      ucod::mbar_init(&sm.k_full[s], 1);
      ucod::mbar_init(&sm.v_full[s], 1);
      ucod::mbar_init(&sm.k_empty[s], 4 * kConsumers);
      ucod::mbar_init(&sm.v_empty[s], 4 * kConsumers);
    }
    ucod::fence_barrier_init();
  }
  __syncthreads();

  // Persistent: this CTA takes work tiles blockIdx.x, + gridDim.x, ...; tile
  // t is q tile t % n_qt of batch * head t / n_qt.  The ring of K/V stages
  // runs on across tiles (`it` counts the K/V tiles so far), so the next
  // tile's Q and first K/V tiles load while this one finishes.
  if (wg == 0) {
    // producer: one thread keeps the ring full
    ucod::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      int it = 0;
      int n = 0;
      for (int t = blockIdx.x; t < n_work; t += gridDim.x, ++n) {
        const int bh = t / n_qt;
        const int b = bh / num_heads;
        const int h = bh % num_heads;
        ucod::mbar_wait(&sm.q_empty, (n & 1) ^ 1);
        ucod::mbar_expect_tx(&sm.q_full, kQBytes);
        ucod::tma_load_3d(sm.q, &tm_q, &sm.q_full, h * kHeadDim, t % n_qt * kBlockQ, b);
        for (int j = 0; j < n_kv; ++j, ++it) {
          const int st = it % kStages;
          const uint32_t ph = (it / kStages) & 1;
          ucod::mbar_wait(&sm.k_empty[st], ph ^ 1);
          ucod::mbar_expect_tx(&sm.k_full[st], kKvBytes);
          ucod::tma_load_3d(sm.k[st], &tm_k, &sm.k_full[st], h * kHeadDim, j * kBlockK, b);
          ucod::mbar_wait(&sm.v_empty[st], ph ^ 1);
          ucod::mbar_expect_tx(&sm.v_full[st], kKvBytes);
          ucod::tma_load_3d(sm.v[st], &tm_v, &sm.v_full[st], h * kHeadDim, j * kBlockK, b);
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
    const bf16* q_tile = sm.q + c * 64 * kHeadDim;
    const int64_t row_stride = (int64_t)num_heads * kHeadDim;

    float s[kBlockK / 2];   // S (then P in f32): 64 rows x 128 keys
    float acc[kHeadDim / 2];  // O: 64 rows x 64
    uint32_t pa[kBlockK / 16][4];  // P in bf16, the A fragments of O += P V

    // Warpgroup 0 issues first; every K/V tile is one turn of each
    // warpgroup, and warpgroup 1's last turn is not taken up.
    if (c == 1) ucod::named_arrive(kSchedBar, 256);
    int it = 0;
    int n = 0;
    for (int t = blockIdx.x; t < n_work; t += gridDim.x, ++n) {
      const bool last_work = t + (int)gridDim.x >= n_work;
      const int bh = t / n_qt;
#pragma unroll
      for (int i = 0; i < kHeadDim / 2; ++i) acc[i] = 0.f;
      // running max (log2 units), partial row sums and the pending rescale
      // of O, for rows g and g + 8 of this warp
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};
      float alpha[2] = {1.f, 1.f};
      ucod::mbar_wait(&sm.q_full, n & 1);

      // K/V tile 0: S alone
      {
        const int st = it % kStages;
        ucod::mbar_wait(&sm.k_full[st], (it / kStages) & 1);
        ucod::named_sync(kSchedBar + c, 256);
        issue_s(s, q_tile, sm.k[st]);
        if (!(c == 1 && last_work && n_kv == 1)) ucod::named_arrive(kSchedBar + (c ^ 1), 256);
        ucod::wgmma_wait<0>();
        ucod::fence_regs(s);
        if (lane == 0) {
          ucod::mbar_arrive(&sm.k_empty[st]);
          if (n_kv == 1) ucod::mbar_arrive(&sm.q_empty);  // Q's last product is done
        }
        online_softmax(s, m, l, alpha, 0, seq_len, tq, scale_log2);
        to_a_frags(pa, s);
      }

      for (int j = 1; j < n_kv; ++j) {
        const int st = (it + j) % kStages;
        const int pst = (it + j - 1) % kStages;  // stage of K/V tile j - 1
        ucod::mbar_wait(&sm.k_full[st], ((it + j) / kStages) & 1);
        ucod::named_sync(kSchedBar + c, 256);
        issue_s(s, q_tile, sm.k[st]);
        // O = alpha O + P_{j-1} V_{j-1}, issued behind S_j
#pragma unroll
        for (int i = 0; i < kHeadDim / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        ucod::mbar_wait(&sm.v_full[pst], ((it + j - 1) / kStages) & 1);
        issue_pv(acc, pa, sm.v[pst]);
        if (!(c == 1 && last_work && j == n_kv - 1)) ucod::named_arrive(kSchedBar + (c ^ 1), 256);
        ucod::wgmma_wait<1>();
        ucod::fence_regs(s);
        if (lane == 0) {
          ucod::mbar_arrive(&sm.k_empty[st]);
          if (j == n_kv - 1) ucod::mbar_arrive(&sm.q_empty);
        }
        online_softmax(s, m, l, alpha, j * kBlockK, seq_len, tq, scale_log2);  // under the PV product
        ucod::wgmma_wait<0>();
        ucod::fence_regs(acc);
        if (lane == 0) ucod::mbar_arrive(&sm.v_empty[pst]);
        to_a_frags(pa, s);
      }

      // the last K/V tile's O += P V
      const int lst = (it + n_kv - 1) % kStages;
#pragma unroll
      for (int i = 0; i < kHeadDim / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      ucod::mbar_wait(&sm.v_full[lst], ((it + n_kv - 1) / kStages) & 1);
      issue_pv(acc, pa, sm.v[lst]);
      ucod::wgmma_wait<0>();
      ucod::fence_regs(acc);
      if (lane == 0) ucod::mbar_arrive(&sm.v_empty[lst]);
      it += n_kv;

      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = 1.f / l[r];
      }
      const int r0 = t % n_qt * kBlockQ + 64 * c + 16 * warp + g;
      bf16* oh = o + (int64_t)(bh / num_heads) * seq_len * row_stride + (int64_t)(bh % num_heads) * kHeadDim;
#pragma unroll
      for (int jb = 0; jb < kHeadDim / 8; ++jb) {
        const int col = 8 * jb + 2 * tq;
        if (r0 < seq_len) {
          *reinterpret_cast<uint32_t*>(oh + (int64_t)r0 * row_stride + col) =
              ucod::pack_bf16x2(acc[4 * jb] * inv[0], acc[4 * jb + 1] * inv[0]);
        }
        if (r0 + 8 < seq_len) {
          *reinterpret_cast<uint32_t*>(oh + (int64_t)(r0 + 8) * row_stride + col) =
              ucod::pack_bf16x2(acc[4 * jb + 2] * inv[1], acc[4 * jb + 3] * inv[1]);
        }
      }
      if (kLse && tq == 0) {
        float* lh = lse + (int64_t)bh * seq_len;
        if (r0 < seq_len) lh[r0] = m[0] * kLn2 + logf(l[0]);
        if (r0 + 8 < seq_len) lh[r0 + 8] = m[1] * kLn2 + logf(l[1]);
      }
    }
  }
}

template <bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch, int seq_len, int num_heads,
           float scale_log2, void* stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  const int cols = num_heads * kHeadDim;
  if (!ucod::packed_tensor_map(&tm_q, q, batch, seq_len, cols, kBlockQ) ||
      !ucod::packed_tensor_map(&tm_k, k, batch, seq_len, cols, kBlockK) ||
      !ucod::packed_tensor_map(&tm_v, v, batch, seq_len, cols, kBlockK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  int device = 0, n_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_work = (seq_len + kBlockQ - 1) / kBlockQ * batch * num_heads;
  attention_fwd_kernel<kLse><<<n_work < n_sm ? n_work : n_sm, kThreads, kSmemBytes,
                               static_cast<cudaStream_t>(stream)>>>(tm_q, tm_k, tm_v, static_cast<bf16*>(o), lse,
                                                                    seq_len, num_heads, n_work, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous bf16 (batch, seq_len, num_heads * 64), 16-byte
// aligned.  Launches min(work tiles, SMs) CTAs on `stream`; returns the
// launch's cudaError_t (cudaErrorInvalidValue when a tensor map cannot be
// made).
extern "C" int ucod_attention_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                                  int seq_len, int num_heads, float scale_log2, void* stream) {
  return launch<false>(q, k, v, o, nullptr, batch, seq_len, num_heads, scale_log2, stream);
}

// As ucod_attention_fwd, and also lse: contiguous f32 (batch, num_heads,
// seq_len), the natural-log log-sum-exp of each query row's scaled scores.
extern "C" int ucod_attention_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int batch, int seq_len, int num_heads,
                                      float scale_log2, void* stream) {
  return launch<true>(q, k, v, o, static_cast<float*>(lse), batch, seq_len, num_heads, scale_log2, stream);
}
