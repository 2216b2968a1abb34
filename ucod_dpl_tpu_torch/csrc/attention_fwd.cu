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
//
// The schedule above is `Schedule`'s; the kernel and `launch` take it as a
// template parameter whose other values only the timing tool instantiates
// (tools/attention_ab.py, each the port of a TPU scheduling prototype in
// scripts/microbench/bench_attention*.py): 64 or 192 query rows a CTA, a
// head pair a CTA, all q tiles of a head in one CTA, and a TMA-store
// epilogue (with a head pair, one box of both heads).

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "attention_common.cuh"
#include "hopper.cuh"


namespace {

using bf16 = __nv_bfloat16;

using ucod::flash::kBlockK;  // keys per K/V tile
constexpr int kStages = 3;
constexpr int kSchedBar = 1;  // named barriers 1 .. consumers: the consumers' turns
constexpr float kLn2 = 0.69314718055994531f;

// How a CTA divides its work.  The product's entries take Schedule as it
// stands; the other values exist for the timing tool's variants
// (tools/attention_ab.py derives a struct from this one in a build of its
// own, each the port of a TPU scheduling prototype; the main library
// instantiates none of them):
//   kConsumers: warpgroups of 64 query rows, taking turns in a ring (1 to
//     3: three hold 160 registers a thread, so that 4 x 128 threads fit the
//     SM's 64 K, and cover L = 1370 with 8 tiles of 192 = 1536 rows);
//   kHeadPair: a CTA owns 64 query rows of heads 2p and 2p + 1, one a
//     warpgroup, and a K/V tile holds both heads' 64 columns (two boxes
//     side by side), as the TPU kernel's 128-lane head pairs do;
//   kQLoop: a CTA takes one (batch, head) and runs all its q tiles in turn,
//     so that its K/V come back from L2 to the same SM.  The TPU kernel
//     kept a whole head's K/V resident; here that is 360 KB at L 1408,
//     against the 227 KB a CTA may hold, so the tiles stream again for
//     every q tile;
//   kTmaStore: the epilogue stages O in shared memory and writes it by TMA
//     stores, not by per-thread 4-byte stores: a 64 x 64 box a warpgroup,
//     or with kHeadPair one 64-row box of both heads' 128 columns, stored
//     by one thread for the CTA, as the TPU kernel's one 128-lane store.
// Text edits of this source (the tool's other variants) reach what a
// member cannot.
struct Schedule {
  static constexpr int kConsumers = 2;
  static constexpr bool kHeadPair = false;
  static constexpr bool kQLoop = false;
  static constexpr bool kTmaStore = false;
};

// What a schedule's tiles come to.
template <typename S>
struct Tiling {
  static_assert(S::kConsumers >= 1 && S::kConsumers <= 3, "one to three consumer warpgroups");
  static_assert(!S::kHeadPair || S::kConsumers == 2, "a head pair takes one warpgroup a head");
  static constexpr int kHeads = S::kHeadPair ? 2 : 1;                     // heads of a work tile
  static constexpr int kBlockQ = S::kHeadPair ? 64 : 64 * S::kConsumers;  // query rows of a work tile
  static constexpr int kThreads = 128 * (1 + S::kConsumers);
  static constexpr int kConsumerRegs = S::kConsumers == 3 ? 160 : 240;  // with 24 for the producer
  static constexpr int kOutBar = kSchedBar + S::kConsumers;  // named barriers of the TMA-store epilogue
};

template <int D, typename S>
struct Smem {  // every tile 1024-byte aligned (whole swizzle atoms)
  bf16 q[Tiling<S>::kHeads * Tiling<S>::kBlockQ * D];
  bf16 k[kStages][Tiling<S>::kHeads * kBlockK * D];
  bf16 v[kStages][Tiling<S>::kHeads * kBlockK * D];
  uint64_t q_full, q_empty;
  uint64_t k_full[kStages], k_empty[kStages], v_full[kStages], v_empty[kStages];
};
template <int D, typename S>
struct SmemStaged : Smem<D, S> {  // + 64 rows x D of O staged per consumer warpgroup
  alignas(1024) bf16 o[S::kConsumers * 64 * D];
};
template <int D, typename S>
using SmemOf = std::conditional_t<S::kTmaStore, SmemStaged<D, S>, Smem<D, S>>;
template <int D, typename S = Schedule>
constexpr size_t kSmemBytes = sizeof(SmemOf<D, S>) + 1024;  // + alignment slack
static_assert(kSmemBytes<128> <= 232448, "the head-dim-128 stages exceed a CTA's shared memory");

// The output's tensor map where the epilogue stores by TMA; nothing else.
struct NoMap {};
template <typename S>
using OutMap = std::conditional_t<S::kTmaStore, CUtensorMap, NoMap>;

// The bf16 output (batch, rows, num_heads * 64) as a 4-D map (64 columns,
// head, row, batch) whose box is 64 columns x 2 heads x 64 rows: a head
// pair's 64 rows, one TMA store.  Shared memory holds the box as 128-byte
// rows u = 2 * row + head under the 128-byte swizzle (chunk c at c ^ u % 8).
inline bool head_pair_map(CUtensorMap* map, void* base, int batch, int rows, int num_heads) {
  const ucod::EncodeTiledFn encode = ucod::encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {64, (cuuint64_t)num_heads, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {128, (cuuint64_t)num_heads * 128, (cuuint64_t)num_heads * 128 * rows};  // bytes
  const cuuint32_t box[4] = {64, 2, 64, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// This CTA's work tiles: blockIdx.x, + gridDim.x, ...; with kQLoop every
// q tile of unit (batch, head) blockIdx.x in turn, then of unit + gridDim.x.
template <typename S>
__device__ __forceinline__ int first_tile(int n_qt) {
  return S::kQLoop ? blockIdx.x * n_qt : blockIdx.x;
}
template <typename S>
__device__ __forceinline__ int next_tile(int t, int n_qt) {
  if constexpr (S::kQLoop) {
    return (t + 1) % n_qt ? t + 1 : t + 1 + ((int)gridDim.x - 1) * n_qt;
  } else {
    return t + (int)gridDim.x;
  }
}

// The flash loop's products, online softmax and P fragments
// (attention_common.cuh), shared with K12 (attn_outproj.cu).
using ucod::flash::issue_pv;
using ucod::flash::issue_s;
using ucod::flash::online_softmax;
using ucod::flash::to_a_frags;

// OutT: bf16, or float for the f32 partial outputs of a sequence-parallel
// ring (merged by their log-sum-exps, then rounded once).
template <int D, bool kLse, typename OutT, typename S>
__global__ void __launch_bounds__(Tiling<S>::kThreads, 1)
    attention_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, OutT* __restrict__ o, float* __restrict__ lse,
                         int seq_len, int kv_len, int num_heads, int n_work, float scale_log2,
                         const __grid_constant__ OutMap<S> tm_o) {
  using H = ucod::flash::Layout<D>;
  using T = Tiling<S>;
  constexpr int kConsumers = S::kConsumers;
  constexpr int kBlockQ = T::kBlockQ;
  extern __shared__ uint8_t smem_raw[];
  SmemOf<D, S>& sm =
      *reinterpret_cast<SmemOf<D, S>*>(smem_raw + ((1024 - (ucod::smem_addr(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128;
  const int n_qt = (seq_len + kBlockQ - 1) / kBlockQ;
  const int n_kv = (kv_len + kBlockK - 1) / kBlockK;  // keys >= kv_len are never loaded
  const int groups = num_heads / T::kHeads;           // work tiles of a batch element and q tile

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

  // Persistent: this CTA takes its work tiles in turn (first_tile,
  // next_tile); tile t is q tile t % n_qt of batch * head group t / n_qt.
  // The ring of K/V stages runs on across tiles (`it` counts the K/V tiles
  // so far), so the next tile's Q and first K/V tiles load while this one
  // finishes.  A box of a head pair's tile is one head's columns.
  if (wg == 0) {
    // producer: one thread keeps the ring full
    if constexpr (kConsumers > 1) ucod::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      int it = 0;
      int n = 0;
      for (int t = first_tile<S>(n_qt); t < n_work; t = next_tile<S>(t, n_qt), ++n) {
        const int bh = t / n_qt;
        const int b = bh / groups;
        const int h = bh % groups * T::kHeads;
        ucod::mbar_wait(&sm.q_empty, (n & 1) ^ 1);
        ucod::mbar_expect_tx(&sm.q_full, T::kHeads * kBlockQ * D * 2);
#pragma unroll
        for (int a = 0; a < T::kHeads * H::kAtoms; ++a) {
          ucod::tma_load_3d(sm.q + a * kBlockQ * H::kAtomCols, &tm_q, &sm.q_full, h * D + a * H::kAtomCols,
                            t % n_qt * kBlockQ, b);
        }
        for (int j = 0; j < n_kv; ++j, ++it) {
          const int st = it % kStages;
          const uint32_t ph = (it / kStages) & 1;
          ucod::mbar_wait(&sm.k_empty[st], ph ^ 1);
          ucod::mbar_expect_tx(&sm.k_full[st], T::kHeads * H::kKvBytes);
#pragma unroll
          for (int a = 0; a < T::kHeads * H::kAtoms; ++a) {
            ucod::tma_load_3d(sm.k[st] + a * kBlockK * H::kAtomCols, &tm_k, &sm.k_full[st],
                              h * D + a * H::kAtomCols, j * kBlockK, b);
          }
          ucod::mbar_wait(&sm.v_empty[st], ph ^ 1);
          ucod::mbar_expect_tx(&sm.v_full[st], T::kHeads * H::kKvBytes);
#pragma unroll
          for (int a = 0; a < T::kHeads * H::kAtoms; ++a) {
            ucod::tma_load_3d(sm.v[st] + a * kBlockK * H::kAtomCols, &tm_v, &sm.v_full[st],
                              h * D + a * H::kAtomCols, j * kBlockK, b);
          }
        }
      }
    }
  } else {
    if constexpr (kConsumers > 1) ucod::reg_alloc<T::kConsumerRegs>();
    const int c = wg - 1;
    const int next_c = kConsumers == 2 ? c ^ 1 : (c + 1) % kConsumers;  // whose turn follows
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int tq = lane % 4;
    const bf16* q_tile = sm.q + c * 64 * H::kAtomCols;
    const int kv_off = S::kHeadPair ? c * kBlockK * D : 0;  // this warpgroup's head in a K/V stage
    const int64_t row_stride = (int64_t)num_heads * D;

    float s[kBlockK / 2];   // S (then P in f32): 64 rows x 128 keys
    float acc[D / 2];       // O: 64 rows x D
    uint32_t pa[kBlockK / 16][4];  // P in bf16, the A fragments of O += P V

    // Warpgroup 0 issues first; every K/V tile is one turn of each
    // warpgroup, and the last warpgroup's last turn is not taken up.
    if (kConsumers > 1 && c == kConsumers - 1) ucod::named_arrive(kSchedBar, 256);
    int it = 0;
    int n = 0;
    for (int t = first_tile<S>(n_qt); t < n_work; t = next_tile<S>(t, n_qt), ++n) {
      const bool last_work = next_tile<S>(t, n_qt) >= n_work;
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
        if (kConsumers > 1) ucod::named_sync(kSchedBar + c, 256);
        issue_s<D, kBlockQ>(s, q_tile, sm.k[st] + kv_off);
        if (kConsumers > 1 && !(c == kConsumers - 1 && last_work && n_kv == 1)) ucod::named_arrive(kSchedBar + next_c, 256);
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
        if (kConsumers > 1) ucod::named_sync(kSchedBar + c, 256);
        issue_s<D, kBlockQ>(s, q_tile, sm.k[st] + kv_off);
        // O = alpha O + P_{j-1} V_{j-1}, issued behind S_j
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        ucod::mbar_wait(&sm.v_full[pst], ((it + j - 1) / kStages) & 1);
        issue_pv<D>(acc, pa, sm.v[pst] + kv_off);
        if (kConsumers > 1 && !(c == kConsumers - 1 && last_work && j == n_kv - 1)) ucod::named_arrive(kSchedBar + next_c, 256);
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
      issue_pv<D>(acc, pa, sm.v[lst] + kv_off);
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
      const int b = bh / groups;
      const int head = bh % groups * T::kHeads + (S::kHeadPair ? c : 0);
      const int row0 = t % n_qt * kBlockQ + (S::kHeadPair ? 0 : 64 * c);  // this warpgroup's first row
      const int r0 = row0 + 16 * warp + g;
      if constexpr (S::kTmaStore) {
        static_assert(D == 64 && std::is_same_v<OutT, bf16>, "the TMA-store epilogue takes bf16 at head dim 64");
        // The staged box, swizzled as a load of the same map writes it
        // (hopper.cuh), free once the previous tile's store has read it; the
        // store drops the rows past L.  This warpgroup's 64 x 64 box, or with
        // a head pair the CTA's box of both heads (head_pair_map: 128-byte
        // row u = 2 * row + c), stored by warpgroup 0's first thread.
        constexpr int kBoxHeads = S::kHeadPair ? 2 : 1;
        uint8_t* stage = reinterpret_cast<uint8_t*>(sm.o + (S::kHeadPair ? 0 : c * 64 * D));
        const int bar = S::kHeadPair ? T::kOutBar : T::kOutBar + c;
        const bool issuer = tid == 0 && (!S::kHeadPair || c == 0);
        if (issuer) ucod::bulk_wait_read<0>();
        ucod::named_sync(bar, 128 * kBoxHeads);
        const int u = kBoxHeads * (16 * warp + g) + (S::kHeadPair ? c : 0);  // rows u, u + 8 * kBoxHeads
        const int sw = u & 7;                                                 // the swizzle of both
#pragma unroll
        for (int jb = 0; jb < D / 8; ++jb) {
          uint8_t* chunk = stage + ((jb ^ sw) << 4) + 4 * tq;
          *reinterpret_cast<uint32_t*>(chunk + u * 128) =
              ucod::pack_bf16x2(acc[4 * jb] * inv[0], acc[4 * jb + 1] * inv[0]);
          *reinterpret_cast<uint32_t*>(chunk + (u + 8 * kBoxHeads) * 128) =
              ucod::pack_bf16x2(acc[4 * jb + 2] * inv[1], acc[4 * jb + 3] * inv[1]);
        }
        ucod::fence_proxy_async();
        ucod::named_sync(bar, 128 * kBoxHeads);
        if (issuer) {
          if constexpr (S::kHeadPair) {
            ucod::tma_store_4d(&tm_o, stage, 0, head, row0, b);  // head: the pair's first (c = 0)
          } else {
            ucod::tma_store_3d(&tm_o, stage, head * D, row0, b);
          }
          ucod::bulk_commit();
        }
      } else {
        OutT* oh = o + (int64_t)b * seq_len * row_stride + (int64_t)head * D;
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
                *reinterpret_cast<uint32_t*>(oh + (int64_t)(r0 + 8 * r) * row_stride + col) =
                    ucod::pack_bf16x2(x, y);
              }
            }
          }
        }
      }
      if (kLse && tq == 0) {
        float* lh = lse + (int64_t)(bh * T::kHeads + (S::kHeadPair ? c : 0)) * seq_len;  // head b * H + head
        if (r0 < seq_len) lh[r0] = m[0] * kLn2 + logf(l[0]);
        if (r0 + 8 < seq_len) lh[r0 + 8] = m[1] * kLn2 + logf(l[1]);
      }
    }
    if constexpr (S::kTmaStore) {
      if (tid == 0) ucod::bulk_wait<0>();  // the last stores have completed
    }
  }
}

template <int D, bool kLse, typename OutT = bf16, typename S = Schedule>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch, int seq_len, int kv_len,
           int num_heads, float scale_log2, void* stream) {
  using H = ucod::flash::Layout<D>;
  using T = Tiling<S>;
  if (kv_len < 1 || kv_len > seq_len || num_heads % T::kHeads) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_q, tm_k, tm_v;
  OutMap<S> tm_o{};
  const int cols = num_heads * D;
  if (!ucod::packed_tensor_map(&tm_q, q, batch, seq_len, cols, T::kBlockQ, H::kAtomCols) ||
      !ucod::packed_tensor_map(&tm_k, k, batch, seq_len, cols, kBlockK, H::kAtomCols) ||
      !ucod::packed_tensor_map(&tm_v, v, batch, seq_len, cols, kBlockK, H::kAtomCols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (S::kTmaStore) {
    if (!(S::kHeadPair ? head_pair_map(&tm_o, o, batch, seq_len, num_heads)
                       : ucod::packed_tensor_map(&tm_o, o, batch, seq_len, cols, 64, H::kAtomCols))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  constexpr int smem = (int)kSmemBytes<D, S>;
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<D, kLse, OutT, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, n_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (seq_len + T::kBlockQ - 1) / T::kBlockQ;
  const int n_work = n_qt * batch * (num_heads / T::kHeads);
  const int n_units = S::kQLoop ? n_work / n_qt : n_work;  // what a CTA takes at a time
  attention_fwd_kernel<D, kLse, OutT, S><<<n_units < n_sm ? n_units : n_sm, T::kThreads, smem,
                                           static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, static_cast<OutT*>(o), lse, seq_len, kv_len, num_heads, n_work, scale_log2, tm_o);
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
