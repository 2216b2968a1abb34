// K12: multi-head attention + out-projection + bias + layerscale + residual
// in one kernel, bf16 in and out, f32 accumulation.
//
// Replaces the TPU prototype scripts/microbench/bench_attn_outproj.py::fused
// (its pallas_call, kernel _kernel): for one image's query rows,
//   out = bf16(x + ((attn(q, k, v) over all heads) Wo^T + bo) * ls)
// with the prototype's roundings: each head's softmax(q k^T * scale) v in
// f32 (probabilities rounded to bf16 before the product with v, the sum of
// the unrounded ones as the denominator), rounded to bf16; the products of
// all heads with their 64 columns of Wo (bf16) summed in f32; then + bo,
// * ls, + x in f32 and one rounding.  Unlike the prototype, keys past L
// take no part: V's rows past L are zero-filled by TMA and their scores
// masked, where the prototype multiplied its padded (unsanitised) V tail by
// p = 0 and returned NaN wherever that tail was not finite.  No product path
// calls it: the serving forward keeps the out-projection in a cuBLAS product
// (models/dino.py), as the JAX forward keeps it in XLA.
//
// What bounds it on the H100: at bs16 / 518px (L = 1370, 12 heads of 64,
// D 768) the attention is K1's 92.25 GFLOP and the out-projection 2 * 21920
// * 768 * 768 = 25.86 GFLOP, 118.1 GFLOP in all (0.119 ms at 989 TFLOP/s
// bf16), against q, k, v, x and out (5 x 33.7 MB) and Wo (1.2 MB) moved once
// (0.050 ms at 3.35 TB/s): the tensor cores bound it.  What the fusion saves
// is the attention output's round trip through HBM and the three
// elementwise passes after the out-projection.  The TPU prototype carried
// an f32 (rows, D) accumulator over a sequential grid of head pairs; a
// Hopper CTA runs unordered beside the others and a 128 x 768 f32
// accumulator does not fit its registers, so the design is:
//   * one CTA per (image, 64-row query block): 16 x 22 = 352 at bs16 L1370;
//     one producer warp (TMA loads, registers dropped to 24) and two
//     consumer warpgroups (registers raised to 240) that take the heads in
//     turn: warpgroup c runs heads c, c + 2, ... over all 64 rows, as the
//     TPU kernel paired heads;
//   * per head, K1's flash loop (csrc/attention_common.cuh, shared with
//     csrc/attention_fwd.cu): Q (64 x 64) by TMA, K and V tiles of 128
//     keys through two three-stage rings whose slots
//     alternate between the warpgroups (slot 2n + c is warpgroup c's n-th
//     tile), S = Q K^T by wgmma m64n128k16 from shared memory, the online
//     softmax in registers, O += P V with P as bf16 register fragments, the
//     S product of tile j issued with the P V product of tile j - 1, and
//     K1's turns: the warpgroups take turns issuing their products (named
//     barriers), so one's softmax runs under the other's products;
//   * each head's normalised 64 x 64 output is rounded to bf16 into its
//     column atom of a 64 x D attention tile in shared memory (96 KB at D
//     768, 128-byte swizzle: the layout a TMA load writes, so it is wgmma's
//     K-major A operand as it stands);
//   * once both warpgroups' heads are in the tile, the out-projection runs
//     from it: Wo tiles (128 output columns x 64 of K, nn.Linear's (out, in)
//     layout, K-major) come by TMA, warpgroup 0's through the K ring and
//     warpgroup 1's through the V ring (three slots each, free of the other
//     warpgroup); warpgroup c takes the 128-column tiles c, c + 2, ..., each
//     over D / 64 k-tiles of wgmma m64n128k16 with both operands in shared
//     memory and f32 accumulators;
//   * the epilogue adds bo, multiplies by ls, adds x (bf16, read once) in
//     f32, rounds once and stores rows < L.
// D % 256 == 0 and D <= 768 (the attention tile and the rings fill 208 KB of
// the 227 KB a CTA may use), head dim 64, an even head count.

#include <cuda_runtime.h>
#include <math.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 64;
constexpr int kBlockQ = 64;        // query rows per CTA
using ucod::flash::kBlockK;        // keys per K/V tile
constexpr int kBlockN = 128;       // output columns per out-projection tile (Wo rows a ring slot)
constexpr int kConsumers = 2;      // warpgroups, heads c, c + 2, ...
constexpr int kStages = 3;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kMaxD = 768;
constexpr uint32_t kQBytes = kBlockQ * kHeadDim * 2;
constexpr uint32_t kTileBytes = kBlockK * kHeadDim * 2;  // a K, V or Wo tile
constexpr int kSchedBar = 1;  // named barriers 1, 2: the consumers' turns
constexpr int kAttnBar = 3;   // named barrier: every head is in the attention tile

struct Smem {  // every tile 1024-byte aligned (128-byte swizzle atoms)
  bf16 attn[kMaxD / kHeadDim][kBlockQ * kHeadDim];  // the block's attention output, one atom a head
  bf16 q[kConsumers][kBlockQ * kHeadDim];
  bf16 k[kStages][kBlockK * kHeadDim];  // K tiles, then warpgroup 0's Wo tiles
  bf16 v[kStages][kBlockK * kHeadDim];  // V tiles, then warpgroup 1's Wo tiles
  uint64_t q_full[kConsumers], q_empty[kConsumers];
  uint64_t k_full[kStages], k_empty[kStages], v_full[kStages], v_empty[kStages];
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // + alignment slack
static_assert(kSmemBytes <= 232448, "the attention tile and the rings exceed a CTA's shared memory");

// K1's flash loop pieces (attention_common.cuh) at head dim 64.
using ucod::flash::issue_pv;
using ucod::flash::issue_s;
using ucod::flash::online_softmax;
using ucod::flash::to_a_frags;

__global__ void __launch_bounds__(kThreads, 1)
    attn_outproj_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_wo,
                        const bf16* __restrict__ x, const float* __restrict__ bo, const float* __restrict__ ls,
                        bf16* __restrict__ out, int seq_len, int num_heads, int n_qt, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (ucod::smem_addr(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128;
  const int b = blockIdx.x / n_qt;
  const int q0 = blockIdx.x % n_qt * kBlockQ;
  const int n_kv = (seq_len + kBlockK - 1) / kBlockK;
  const int d = num_heads * kHeadDim;
  const int n_pairs = num_heads / 2;
  const int n_kt = d / kHeadDim;     // the out-projection's k-tiles: one a head
  const int n_ntp = d / kBlockN / 2;  // its column tiles, in pairs (one per warpgroup)

  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < kConsumers; ++c) {
      ucod::mbar_init(&sm.q_full[c], 1);
      ucod::mbar_init(&sm.q_empty[c], 4);  // lane 0 of each of its warpgroup's warps
    }
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      ucod::mbar_init(&sm.k_full[s], 1);
      ucod::mbar_init(&sm.v_full[s], 1);
      ucod::mbar_init(&sm.k_empty[s], 4);  // a slot is one warpgroup's
      ucod::mbar_init(&sm.v_empty[s], 4);
    }
    ucod::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread fills the rings in the order the warpgroups
    // consume them, slot 2n + c for warpgroup c's n-th tile
    ucod::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      int ik = 0, iv = 0;
      for (int hp = 0; hp < n_pairs; ++hp) {
#pragma unroll
        for (int c = 0; c < kConsumers; ++c) {
          ucod::mbar_wait(&sm.q_empty[c], (hp & 1) ^ 1);
          ucod::mbar_expect_tx(&sm.q_full[c], kQBytes);
          ucod::tma_load_3d(sm.q[c], &tm_q, &sm.q_full[c], (2 * hp + c) * kHeadDim, q0, b);
        }
        for (int j = 0; j < n_kv; ++j) {
#pragma unroll
          for (int c = 0; c < kConsumers; ++c, ++ik) {
            const int st = ik % kStages;
            ucod::mbar_wait(&sm.k_empty[st], ((ik / kStages) & 1) ^ 1);
            ucod::mbar_expect_tx(&sm.k_full[st], kTileBytes);
            ucod::tma_load_3d(sm.k[st], &tm_k, &sm.k_full[st], (2 * hp + c) * kHeadDim, j * kBlockK, b);
          }
#pragma unroll
          for (int c = 0; c < kConsumers; ++c, ++iv) {
            const int st = iv % kStages;
            ucod::mbar_wait(&sm.v_empty[st], ((iv / kStages) & 1) ^ 1);
            ucod::mbar_expect_tx(&sm.v_full[st], kTileBytes);
            ucod::tma_load_3d(sm.v[st], &tm_v, &sm.v_full[st], (2 * hp + c) * kHeadDim, j * kBlockK, b);
          }
        }
      }
      // the out-projection: warpgroup 0's Wo tiles through the K ring,
      // warpgroup 1's through the V ring
      for (int p = 0; p < n_ntp; ++p) {
        for (int kt = 0; kt < n_kt; ++kt, ++ik, ++iv) {
          int st = ik % kStages;
          ucod::mbar_wait(&sm.k_empty[st], ((ik / kStages) & 1) ^ 1);
          ucod::mbar_expect_tx(&sm.k_full[st], kTileBytes);
          ucod::tma_load_3d(sm.k[st], &tm_wo, &sm.k_full[st], kt * kHeadDim, 2 * p * kBlockN, 0);
          st = iv % kStages;
          ucod::mbar_wait(&sm.v_empty[st], ((iv / kStages) & 1) ^ 1);
          ucod::mbar_expect_tx(&sm.v_full[st], kTileBytes);
          ucod::tma_load_3d(sm.v[st], &tm_wo, &sm.v_full[st], kt * kHeadDim, (2 * p + 1) * kBlockN, 0);
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
    int nk = 0, nv = 0;  // this warpgroup's K-ring and V-ring tiles so far: slot 2n + c

    float s[kBlockK / 2];         // S (then P in f32): 64 rows x 128 keys
    float acc[kHeadDim / 2];      // O: 64 rows x 64
    uint32_t pa[kBlockK / 16][4];  // P in bf16, the A fragments of O += P V
    // Warpgroup 0 issues first; every K/V tile is one turn of each
    // warpgroup, and warpgroup 1's last turn is not taken up.
    if (c == 1) ucod::named_arrive(kSchedBar, 256);
    for (int hp = 0; hp < n_pairs; ++hp) {
      const int h = 2 * hp + c;
      const bool last_pair = hp == n_pairs - 1;
#pragma unroll
      for (int i = 0; i < kHeadDim / 2; ++i) acc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};
      float alpha[2] = {1.f, 1.f};
      ucod::mbar_wait(&sm.q_full[c], hp & 1);

      // K/V tile 0: S alone
      {
        const int slot = 2 * nk + c;
        const int st = slot % kStages;
        ucod::mbar_wait(&sm.k_full[st], (slot / kStages) & 1);
        ucod::named_sync(kSchedBar + c, 256);
        issue_s<kHeadDim, kBlockQ>(s, sm.q[c], sm.k[st]);
        if (!(c == 1 && last_pair && n_kv == 1)) ucod::named_arrive(kSchedBar + (c ^ 1), 256);
        ucod::wgmma_wait<0>();
        ucod::fence_regs(s);
        if (lane == 0) {
          ucod::mbar_arrive(&sm.k_empty[st]);
          if (n_kv == 1) ucod::mbar_arrive(&sm.q_empty[c]);  // Q's last product is done
        }
        ++nk;
        online_softmax(s, m, l, alpha, 0, seq_len, tq, scale_log2);
        to_a_frags(pa, s);
      }
      for (int j = 1; j < n_kv; ++j) {
        const int kslot = 2 * nk + c, vslot = 2 * nv + c;  // K tile j, V tile j - 1
        const int kst = kslot % kStages, vst = vslot % kStages;
        ucod::mbar_wait(&sm.k_full[kst], (kslot / kStages) & 1);
        ucod::named_sync(kSchedBar + c, 256);
        issue_s<kHeadDim, kBlockQ>(s, sm.q[c], sm.k[kst]);
        // O = alpha O + P_{j-1} V_{j-1}, issued behind S_j
#pragma unroll
        for (int i = 0; i < kHeadDim / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        ucod::mbar_wait(&sm.v_full[vst], (vslot / kStages) & 1);
        issue_pv<kHeadDim>(acc, pa, sm.v[vst]);
        if (!(c == 1 && last_pair && j == n_kv - 1)) ucod::named_arrive(kSchedBar + (c ^ 1), 256);
        ucod::wgmma_wait<1>();
        ucod::fence_regs(s);
        if (lane == 0) {
          ucod::mbar_arrive(&sm.k_empty[kst]);
          if (j == n_kv - 1) ucod::mbar_arrive(&sm.q_empty[c]);
        }
        ++nk;
        online_softmax(s, m, l, alpha, j * kBlockK, seq_len, tq, scale_log2);  // under the PV product
        ucod::wgmma_wait<0>();
        ucod::fence_regs(acc);
        if (lane == 0) ucod::mbar_arrive(&sm.v_empty[vst]);
        ++nv;
        to_a_frags(pa, s);
      }
      {  // the last K/V tile's O += P V
        const int vslot = 2 * nv + c;
        const int vst = vslot % kStages;
#pragma unroll
        for (int i = 0; i < kHeadDim / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        ucod::mbar_wait(&sm.v_full[vst], (vslot / kStages) & 1);
        issue_pv<kHeadDim>(acc, pa, sm.v[vst]);
        ucod::wgmma_wait<0>();
        ucod::fence_regs(acc);
        if (lane == 0) ucod::mbar_arrive(&sm.v_empty[vst]);
        ++nv;
      }

      // O / l rounded to bf16 into head h's atom of the attention tile
      // (rows 16 warp + g and + 8 both swizzle by g)
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = 1.f / l[r];
      }
      uint8_t* atom = reinterpret_cast<uint8_t*>(sm.attn[h]) + (16 * warp + g) * 128 + 4 * tq;
#pragma unroll
      for (int jb = 0; jb < kHeadDim / 8; ++jb) {
        *reinterpret_cast<uint32_t*>(atom + ((jb ^ g) << 4)) =
            ucod::pack_bf16x2(acc[4 * jb] * inv[0], acc[4 * jb + 1] * inv[0]);
        *reinterpret_cast<uint32_t*>(atom + 8 * 128 + ((jb ^ g) << 4)) =
            ucod::pack_bf16x2(acc[4 * jb + 2] * inv[1], acc[4 * jb + 3] * inv[1]);
      }
    }
    // every head's output is in the tile before either warpgroup reads it
    ucod::fence_proxy_async();
    ucod::named_sync(kAttnBar, 128 * kConsumers);

    // out-projection: column tiles 2p + c, each over the D / 64 k-tiles,
    // their Wo tiles in this warpgroup's ring (K for 0, V for 1), which
    // has held 2 * n_pairs * n_kv tiles of the attention so far
    uint64_t* full = c == 0 ? sm.k_full : sm.v_full;
    uint64_t* empty = c == 0 ? sm.k_empty : sm.v_empty;
    const bf16* tiles = c == 0 ? sm.k[0] : sm.v[0];
    int n = 2 * n_pairs * n_kv;
    float o[kBlockN / 2];  // 64 rows x 128 output columns, f32
    const int r0 = q0 + 16 * warp + g;  // this thread's rows r0 and r0 + 8
    for (int p = 0; p < n_ntp; ++p) {
      int prev = 0;
      for (int kt = 0; kt < n_kt; ++kt, ++n) {
        const int st = n % kStages;
        ucod::mbar_wait(&full[st], (n / kStages) & 1);
        ucod::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kHeadDim / 16; ++kk) {
          ucod::wgmma_m64n128k16_ss<0, 0>(o, ucod::desc_kmajor(sm.attn[kt], kk),
                                          ucod::desc_kmajor(tiles + st * kBlockK * kHeadDim, kk), kt > 0 || kk > 0);
        }
        ucod::wgmma_commit();
        ucod::wgmma_wait<1>();  // the previous k-tile's products are done
        if (kt > 0 && lane == 0) ucod::mbar_arrive(&empty[prev]);
        prev = st;
      }
      ucod::wgmma_wait<0>();
      ucod::fence_regs(o);
      if (lane == 0) ucod::mbar_arrive(&empty[prev]);

      // epilogue: x + (o + bo) * ls in f32, one rounding, rows < L
      const int n0 = (2 * p + c) * kBlockN;
#pragma unroll
      for (int jb = 0; jb < kBlockN / 8; ++jb) {
        const int n = n0 + 8 * jb + 2 * tq;
        const float2 b2 = *reinterpret_cast<const float2*>(bo + n);
        const float2 l2 = *reinterpret_cast<const float2*>(ls + n);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          if (row < seq_len) {
            const int64_t idx = ((int64_t)b * seq_len + row) * d + n;
            const uint32_t xr = *reinterpret_cast<const uint32_t*>(x + idx);
            const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr));
            *reinterpret_cast<uint32_t*>(out + idx) =
                ucod::pack_bf16x2(xf.x + (o[4 * jb + 2 * r] + b2.x) * l2.x, xf.y + (o[4 * jb + 2 * r + 1] + b2.y) * l2.y);
          }
        }
      }
    }
  }
}

}  // namespace

// q, k, v, x, out: contiguous bf16 (batch, seq_len, num_heads * 64); wo:
// contiguous bf16 (D, D) in nn.Linear's (out, in) layout; bo, ls: f32 (D,);
// all 16-byte aligned.  Requires an even num_heads with D = num_heads * 64 a
// multiple of 256 and at most 768, seq_len >= 1.  Launches batch *
// ceil(seq_len / 64) CTAs on `stream`; returns the launch's cudaError_t
// (cudaErrorInvalidValue for another shape or when a tensor map cannot be
// made).
extern "C" int ucod_attention_outproj(const void* q, const void* k, const void* v, const void* x, const void* wo,
                                      const void* bo, const void* ls, void* out, int batch, int seq_len,
                                      int num_heads, float scale_log2, void* stream) {
  const int d = num_heads * kHeadDim;
  if (batch < 1 || seq_len < 1 || num_heads < 2 || num_heads % 2 || d % 256 || d > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tm_q, tm_k, tm_v, tm_wo;
  if (!ucod::packed_tensor_map(&tm_q, q, batch, seq_len, d, kBlockQ) ||
      !ucod::packed_tensor_map(&tm_k, k, batch, seq_len, d, kBlockK) ||
      !ucod::packed_tensor_map(&tm_v, v, batch, seq_len, d, kBlockK) ||
      !ucod::packed_tensor_map(&tm_wo, wo, 1, d, d, kBlockN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err =
      cudaFuncSetAttribute(attn_outproj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (seq_len + kBlockQ - 1) / kBlockQ;
  attn_outproj_kernel<<<batch * n_qt, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, tm_wo, static_cast<const bf16*>(x), static_cast<const float*>(bo),
      static_cast<const float*>(ls), static_cast<bf16*>(out), seq_len, num_heads, n_qt, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
