// K1: packed multi-head attention forward, bf16 in, f32 accumulate; with an
// f32 log-sum-exp output it is also the port of K2, and at every head dim it
// is the port of K5.
//
// Replaces the TPU kernel ucod_dpl_tpu/ops/attention.py::_attention_kernel_headpair
// (launched by _pallas_attention_packed): o = softmax(q k^T * scale) v per
// head, with q/k/v/o in the packed (B, L, num_heads * D) projection layout.
// The same kernel, instantiated for head dims D in {16, 32, 64, 128} and any
// head count, replaces _attention_kernel (K5, launched by _pallas_attention):
// the per-head (B * H, L, D) layout is the packed one with one head, and the
// odd head counts the JAX dispatch splits to that layout (a TPU lane rule:
// heads paired into 128 lanes) read their heads in place here.
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
//   * 3-D tensor maps over q, k and v as (H * D columns, L rows, B) with a
//     box of min(D, 64) columns x 128 rows; the head is the column
//     coordinate.  A row of a box is 2 * min(D, 64) bytes and takes the
//     swizzle of that width (128, 64 or 32 bytes; hopper.cuh); at D = 128 a
//     tile is two 64-column boxes side by side, so S's k-steps cross from one
//     to the other and V's two column atoms lie LBO apart along N.  Rows >= L
//     lie outside the map: TMA fills them with zeros and never reads past the
//     tensor;
//   * K and V tiles of 128 keys through a three-stage ring with full/empty
//     mbarriers that runs on from one work tile to the next, and Q through
//     a buffer freed as soon as the tile's last S product is done, so the
//     next tile's loads overlap this tile's last products and epilogue; at
//     D = 128 the three stages and Q take 224 KB of the 227 KB a CTA may use;
//   * S = Q K^T by wgmma m64n128k16 (D / 16 k-steps) with both operands in
//     shared memory; O += P V by wgmma m64nDk16 with P as bf16 A fragments
//     straight from the S accumulators and V read MN-major (transpose bit);
//   * the softmax kept off the critical path: the two consumer warpgroups
//     take turns issuing their wgmmas (named barriers, "ping-pong"), and in
//     each warpgroup the S product of tile j is issued together with the PV
//     product of tile j - 1 before tile j's softmax runs, so the
//     exponentials of one warpgroup run under the wgmmas of both;
//     per score one FFMA folds the scale into the exponent (exp2(s *
//     scale_log2 - m)), and the key mask (col >= kv_len -> -inf) is applied
//     on the last K/V tile only; rows with no finite score yet keep the
//     running-max guard (m = -inf -> shift 0).  kv_len is L, but for the
//     forward with log-sum-exp of a sequence-parallel ring, whose last
//     chunks end in padding (parallel/sp.py): there the tiles past kv_len
//     are not loaded at all, and the output may be f32 (the ring merges its
//     partial outputs before it rounds);
//   * the epilogue rounds O / l to bf16 once and stores rows < L.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;             // warpgroups of 64 query rows
constexpr int kBlockQ = 64 * kConsumers;  // query rows per CTA
using ucod::flash::kBlockK;               // keys per K/V tile
constexpr int kStages = 3;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kSchedBar = 1;  // named barriers 1, 2: the consumers' turns
constexpr float kLn2 = 0.69314718055994531f;

// The shared-memory layout at head dim D (attention_common.cuh) and the
// sizes of this kernel's Q tile and K/V tiles.
template <int D>
struct Head : ucod::flash::Layout<D> {
  static constexpr uint32_t kQBytes = kBlockQ * D * 2;
};

template <int D>
struct Smem {  // every tile 1024-byte aligned (whole swizzle atoms)
  bf16 q[kBlockQ * D];
  bf16 k[kStages][kBlockK * D];
  bf16 v[kStages][kBlockK * D];
  uint64_t q_full, q_empty;
  uint64_t k_full[kStages], k_empty[kStages], v_full[kStages], v_empty[kStages];
};
template <int D>
constexpr size_t kSmemBytes = sizeof(Smem<D>) + 1024;  // + alignment slack
static_assert(kSmemBytes<128> <= 232448, "the head-dim-128 stages exceed a CTA's shared memory");

// The flash loop's products, online softmax and P fragments
// (attention_common.cuh), shared with K12 (attn_outproj.cu).
using ucod::flash::issue_pv;
using ucod::flash::issue_s;
using ucod::flash::online_softmax;
using ucod::flash::to_a_frags;

// OutT: bf16, or float for the f32 partial outputs of a sequence-parallel
// ring (merged by their log-sum-exps, then rounded once).
template <int D, bool kLse, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    attention_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, OutT* __restrict__ o, float* __restrict__ lse,
                         int seq_len, int kv_len, int num_heads, int n_work, float scale_log2) {
  using H = Head<D>;
  extern __shared__ uint8_t smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw + ((1024 - (ucod::smem_addr(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128;
  const int n_qt = (seq_len + kBlockQ - 1) / kBlockQ;
  const int n_kv = (kv_len + kBlockK - 1) / kBlockK;  // keys >= kv_len are never loaded

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
        ucod::mbar_expect_tx(&sm.q_full, H::kQBytes);
#pragma unroll
        for (int a = 0; a < H::kAtoms; ++a) {
          ucod::tma_load_3d(sm.q + a * kBlockQ * H::kAtomCols, &tm_q, &sm.q_full, h * D + a * H::kAtomCols,
                            t % n_qt * kBlockQ, b);
        }
        for (int j = 0; j < n_kv; ++j, ++it) {
          const int st = it % kStages;
          const uint32_t ph = (it / kStages) & 1;
          ucod::mbar_wait(&sm.k_empty[st], ph ^ 1);
          ucod::mbar_expect_tx(&sm.k_full[st], H::kKvBytes);
#pragma unroll
          for (int a = 0; a < H::kAtoms; ++a) {
            ucod::tma_load_3d(sm.k[st] + a * kBlockK * H::kAtomCols, &tm_k, &sm.k_full[st],
                              h * D + a * H::kAtomCols, j * kBlockK, b);
          }
          ucod::mbar_wait(&sm.v_empty[st], ph ^ 1);
          ucod::mbar_expect_tx(&sm.v_full[st], H::kKvBytes);
#pragma unroll
          for (int a = 0; a < H::kAtoms; ++a) {
            ucod::tma_load_3d(sm.v[st] + a * kBlockK * H::kAtomCols, &tm_v, &sm.v_full[st],
                              h * D + a * H::kAtomCols, j * kBlockK, b);
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
    const bf16* q_tile = sm.q + c * 64 * H::kAtomCols;
    const int64_t row_stride = (int64_t)num_heads * D;

    float s[kBlockK / 2];   // S (then P in f32): 64 rows x 128 keys
    float acc[D / 2];       // O: 64 rows x D
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
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
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
        issue_s<D, kBlockQ>(s, q_tile, sm.k[st]);
        if (!(c == 1 && last_work && n_kv == 1)) ucod::named_arrive(kSchedBar + (c ^ 1), 256);
        ucod::wgmma_wait<0>();
        ucod::fence_regs(s);
        if (lane == 0) {
          ucod::mbar_arrive(&sm.k_empty[st]);
          if (n_kv == 1) ucod::mbar_arrive(&sm.q_empty);  // Q's last product is done
        }
        online_softmax(s, m, l, alpha, 0, kv_len, tq, scale_log2);
        to_a_frags(pa, s);
      }

      for (int j = 1; j < n_kv; ++j) {
        const int st = (it + j) % kStages;
        const int pst = (it + j - 1) % kStages;  // stage of K/V tile j - 1
        ucod::mbar_wait(&sm.k_full[st], ((it + j) / kStages) & 1);
        ucod::named_sync(kSchedBar + c, 256);
        issue_s<D, kBlockQ>(s, q_tile, sm.k[st]);
        // O = alpha O + P_{j-1} V_{j-1}, issued behind S_j
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        ucod::mbar_wait(&sm.v_full[pst], ((it + j - 1) / kStages) & 1);
        issue_pv<D>(acc, pa, sm.v[pst]);
        if (!(c == 1 && last_work && j == n_kv - 1)) ucod::named_arrive(kSchedBar + (c ^ 1), 256);
        ucod::wgmma_wait<1>();
        ucod::fence_regs(s);
        if (lane == 0) {
          ucod::mbar_arrive(&sm.k_empty[st]);
          if (j == n_kv - 1) ucod::mbar_arrive(&sm.q_empty);
        }
        online_softmax(s, m, l, alpha, j * kBlockK, kv_len, tq, scale_log2);  // under the PV product
        ucod::wgmma_wait<0>();
        ucod::fence_regs(acc);
        if (lane == 0) ucod::mbar_arrive(&sm.v_empty[pst]);
        to_a_frags(pa, s);
      }

      // the last K/V tile's O += P V
      const int lst = (it + n_kv - 1) % kStages;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      ucod::mbar_wait(&sm.v_full[lst], ((it + n_kv - 1) / kStages) & 1);
      issue_pv<D>(acc, pa, sm.v[lst]);
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
      OutT* oh = o + (int64_t)(bh / num_heads) * seq_len * row_stride + (int64_t)(bh % num_heads) * D;
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb) {
        const int col = 8 * jb + 2 * tq;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (r0 + 8 * r < seq_len) {
            const float x = acc[4 * jb + 2 * r] * inv[r], y = acc[4 * jb + 2 * r + 1] * inv[r];
            if constexpr (std::is_same_v<OutT, float>) {
              *reinterpret_cast<float2*>(oh + (int64_t)(r0 + 8 * r) * row_stride + col) = make_float2(x, y);
            } else {
              *reinterpret_cast<uint32_t*>(oh + (int64_t)(r0 + 8 * r) * row_stride + col) = ucod::pack_bf16x2(x, y);
            }
          }
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

template <int D, bool kLse, typename OutT = bf16>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch, int seq_len, int kv_len,
           int num_heads, float scale_log2, void* stream) {
  using H = Head<D>;
  if (kv_len < 1 || kv_len > seq_len) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_q, tm_k, tm_v;
  const int cols = num_heads * D;
  if (!ucod::packed_tensor_map(&tm_q, q, batch, seq_len, cols, kBlockQ, H::kAtomCols) ||
      !ucod::packed_tensor_map(&tm_k, k, batch, seq_len, cols, kBlockK, H::kAtomCols) ||
      !ucod::packed_tensor_map(&tm_v, v, batch, seq_len, cols, kBlockK, H::kAtomCols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = (int)kSmemBytes<D>;
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<D, kLse, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, n_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_work = (seq_len + kBlockQ - 1) / kBlockQ * batch * num_heads;
  attention_fwd_kernel<D, kLse, OutT><<<n_work < n_sm ? n_work : n_sm, kThreads, smem,
                                        static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, static_cast<OutT*>(o), lse, seq_len, kv_len, num_heads, n_work, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous bf16 (batch, seq_len, num_heads * head_dim),
// 16-byte aligned, head_dim in {16, 32, 64, 128}.  Launches min(work tiles,
// SMs) CTAs on `stream`; returns the launch's cudaError_t
// (cudaErrorInvalidValue for another head dim or when a tensor map cannot be
// made).
extern "C" int ucod_attention_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                                  int seq_len, int num_heads, int head_dim, float scale_log2, void* stream) {
  switch (head_dim) {
    case 16:
      return launch<16, false>(q, k, v, o, nullptr, batch, seq_len, seq_len, num_heads, scale_log2, stream);
    case 32:
      return launch<32, false>(q, k, v, o, nullptr, batch, seq_len, seq_len, num_heads, scale_log2, stream);
    case 64:
      return launch<64, false>(q, k, v, o, nullptr, batch, seq_len, seq_len, num_heads, scale_log2, stream);
    case 128:
      return launch<128, false>(q, k, v, o, nullptr, batch, seq_len, seq_len, num_heads, scale_log2, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As ucod_attention_fwd at head dim 64, over the keys [0, kv_len) only (1 <=
// kv_len <= seq_len; the keys past it get probability 0 and are not read),
// and also lse: contiguous f32 (batch, num_heads, seq_len), the natural-log
// log-sum-exp of each query row's scaled scores over those keys.  o is bf16,
// or f32 when out_f32 is nonzero (a ring's partial outputs).
extern "C" int ucod_attention_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int batch, int seq_len, int kv_len, int num_heads,
                                      float scale_log2, int out_f32, void* stream) {
  float* l = static_cast<float*>(lse);
  return out_f32 ? launch<64, true, float>(q, k, v, o, l, batch, seq_len, kv_len, num_heads, scale_log2, stream)
                 : launch<64, true>(q, k, v, o, l, batch, seq_len, kv_len, num_heads, scale_log2, stream);
}
