// The flash-attention loop's pieces that K1 (attention_fwd.cu) and K12
// (attn_outproj.cu) share: the shared-memory layout of a head's tiles, the
// S = Q K^T and O += P V products of one 128-key K/V tile, the online
// softmax over that tile, and the repacking of P into the A fragments of
// the P V product.  A warpgroup owns 64 query rows; the products are
// wgmma m64n128k16 (S, both operands in shared memory) and m64nDk16 (P V,
// P from registers, V read MN-major).

#pragma once

#include <math.h>

#include "hopper.cuh"

namespace ucod {
namespace flash {

using bf16 = __nv_bfloat16;

constexpr int kBlockK = 128;  // keys per K/V tile

// The shared-memory layout at head dim D: a tile of R rows is kAtoms column
// atoms of R rows x kAtomCols, each swizzled over its kSwizzle-byte rows.
template <int D>
struct Layout {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dim 16, 32, 64 or 128");
  static constexpr int kAtomCols = D < 64 ? D : 64;
  static constexpr int kAtoms = D / kAtomCols;
  static constexpr int kSwizzle = 2 * kAtomCols;
  static constexpr int kStepsPerAtom = kAtomCols / 16;  // 16-column k-steps
  static constexpr uint32_t kKvBytes = kBlockK * D * 2;
  // V read MN-major: its column atoms along N lie a whole atom apart
  static constexpr uint32_t kVLbo = kAtoms > 1 ? kBlockK * kSwizzle : 1024;
};

// S = Q K^T for a warpgroup's 64 rows x 128 keys (one commit group); q_tile
// is the warpgroup's rows in the first column atom of a Q tile of kQRows rows.
template <int D, int kQRows>
__device__ __forceinline__ void issue_s(float (&s)[kBlockK / 2], const bf16* q_tile, const bf16* k_tile) {
  using L = Layout<D>;
  ucod::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int atom = kk / L::kStepsPerAtom;
    const int step = kk % L::kStepsPerAtom;
    ucod::wgmma_m64n128k16_ss<0, 0>(
        s, ucod::desc_kmajor<L::kSwizzle>(q_tile + atom * kQRows * L::kAtomCols, step),
        ucod::desc_kmajor<L::kSwizzle>(k_tile + atom * kBlockK * L::kAtomCols, step), kk);
  }
  ucod::wgmma_commit();
}

// O += P V, P from registers, V read MN-major (one commit group).
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&pa)[kBlockK / 16][4],
                                         const bf16* v_tile) {
  using L = Layout<D>;
  ucod::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    ucod::wgmma_rs<D, 1>(acc, pa[kk], ucod::desc_mnmajor<L::kSwizzle>(v_tile, kk, L::kVLbo), 1);
  }
  ucod::wgmma_commit();
}

// One K/V tile of the online softmax for this thread's rows g and g + 8:
// masks keys >= kv_len (only a tile that reaches past it has any), updates the
// running max m (log2 units) and sum l, sets alpha to the rescale O owes,
// and turns S into P = exp2(s * scale_log2 - m) in place.
__device__ __forceinline__ void online_softmax(float (&s)[kBlockK / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int k0, int kv_len, int tq, float scale_log2) {
  if (k0 + kBlockK > kv_len) {
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) {
      if (k0 + 8 * (i >> 2) + 2 * tq + (i & 1) >= kv_len) s[i] = -INFINITY;
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

}  // namespace flash
}  // namespace ucod
