// Backward of packed multi-head attention from a saved log-sum-exp, bf16 in,
// f32 accumulate, bf16 out.  The port of K3 and K4.
//
// Replaces the TPU kernels of ucod_dpl_tpu/ops/attention.py:
//   * _attention_bwd_kernel_headpair (launched by _pallas_attention_packed_bwd),
//     the whole-KV flash backward the VJP takes at 518px (L = 1370);
//   * _bwd2d_dq_kernel + _bwd2d_dkv_kernel (prelude _bwd2d_prelude, launched
//     by _pallas_attention_packed_bwd_longl), the KV-blocked backward from
//     saved denominators the VJP takes at 756px (L = 2917).
// On the TPU the choice between the two is a VMEM law; here one scheme
// covers every length.  With s = scale q k^T, P = exp(s - lse) (lse from the
// forward, attention_fwd.cu), D = rowsum(dO o O):
//   dS = P o (dO V^T - D) * scale, rounded to bf16 before its matmuls;
//   dQ = dS K,  dK = dS^T Q,  dV = P^T dO with P rounded to bf16,
// every product accumulated in f32 and each gradient rounded to bf16 once
// (the rounding points of the JAX kernels).
//
// What bounds it on the H100: at bs16 / 518px (L = 1370, 12 heads of 64) the
// five products of 2 * B * H * L^2 * 64 (S, dP, dV, dK, dQ) are 231 GFLOP,
// 0.233 ms at the 989 TFLOP/s bf16 peak, against about 270 MB of
// q/k/v/o/dO/dq/dk/dv (0.08 ms at 3.35 TB/s): the tensor cores bound it,
// plus one ex2 per score (360 M, 0.09 ms of MUFU) and dQ's f32 traffic.
// The design:
//   * a pre-pass writes, per (batch * head, row) padded to a multiple of 64
//     rows, the pair {lse * log2 e, D} in f32: +inf and 0 for rows >= L, so
//     a query row past L gets P = 0 with no predicate; it also zeroes the
//     f32 dQ scratch dq_acc and the int32 semaphores behind it;
//   * the main kernel gives each CTA one 128-key K/V tile of one head: one
//     producer warp (setmaxnreg down to 24) loads K and V once by TMA, then
//     streams every 64-row q tile's Q, dO (3-D tensor maps, 128-byte
//     swizzle, rows >= L zero-filled) and its 512 bytes of {lse, D} through
//     a three-stage mbarrier ring; two consumer warpgroups (setmaxnreg up to
//     240) own 64 keys each.  The CTA of key tile j of n_k starts at q tile
//     floor(j * n_q / n_k) of n_q and walks them cyclically, so at any one
//     step the CTAs of a head work on distinct q tiles.  Per q tile a warpgroup runs five wgmma
//     products, each score computed once (a two-pass backward, dK/dV then dQ,
//     runs seven): S^T = K Q^T and dP^T = V dO^T from shared memory; P^T in
//     registers; dV += P^T dO and dK += dS^T Q with P^T and dS^T as bf16 A
//     fragments straight from the accumulators; dS^T stored to shared
//     memory (128-byte swizzled) and dQ_partial = dS K over the warpgroup's
//     64 keys.  The next q tile's S and dP are issued before this tile's dQ
//     is passed on, so the tensor cores have work meanwhile;
//   * the two warpgroups' dQ partials are summed through shared memory (each
//     adds the other's half of the 64 columns, handed over by mbarrier) into
//     a double-buffered half-tile, and one writer thread per warpgroup (in
//     the producer warpgroup) adds it to dq_acc by one TMA bulk reduce-add
//     (cp.reduce.async.bulk .add.f32, 8 KB); dq_acc holds per (batch *
//     head, q tile) the tile's sums contiguously (dq_half_offset);
//   * the additions into one half-tile happen in a fixed order, so dq is the
//     same bit for bit from run to run (the TPU kernels write dQ per q block
//     with no atomics): the CTAs of a head add q tile i in the order of the
//     step at which their cyclic walks reach it, and a semaphore per
//     (batch * head, q tile, half) counts the additions made.  The writer
//     spins on it (acquire, gpu scope) until it reads its CTA's rank, adds,
//     waits until the addition has completed (not only read its source),
//     fences the async proxy and releases the count plus one.  Since the
//     walks are staggered, the CTA ahead of it in a tile's order reached
//     the tile at least a step earlier, so the wait is short; a wait is
//     always on a CTA at an earlier step of its walk, so no cycle forms,
//     and a head's CTAs are adjacent in launch order (blockIdx.x the key
//     tile), so the CTAs waited on are resident, finished or next to be
//     launched once the heads before them have finished.  dK and dV are
//     summed in registers in the order of the walk;
//   * key rows >= L get P = 0 before any product uses P; the dK/dV stores
//     and the dq cast skip rows >= L;
//   * a last pass rounds dq_acc to bf16 into dq.

#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 64;
constexpr int kConsumers = 2;             // warpgroups of 64 keys
constexpr int kBlockK = 64 * kConsumers;  // keys per CTA
constexpr int kBlockQ = 64;               // query rows per step
constexpr int kStages = 3;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr uint32_t kKvBytes = kBlockK * kHeadDim * 2;
constexpr uint32_t kQBytes = kBlockQ * kHeadDim * 2;
constexpr uint32_t kStatBytes = kBlockQ * sizeof(float2);
constexpr int kWgBar = 1;  // named barrier 1 + c: warpgroup c's own
constexpr float kLog2e = 1.4426950408889634f;

struct Smem {  // every tile 1024-byte aligned (128-byte swizzle atoms)
  bf16 k[kBlockK * kHeadDim];
  bf16 v[kBlockK * kHeadDim];
  bf16 q[kStages][kBlockQ * kHeadDim];
  bf16 d_o[kStages][kBlockQ * kHeadDim];
  bf16 ds[kConsumers][64 * kBlockQ];  // dS^T, [key][query], per warpgroup
  float2 xchg[2][kConsumers][8][128];  // dQ half-partials, by step parity
  float dq_out[kConsumers][2][64 * 32];  // summed dQ halves on their way to dq_acc
  float2 stats[kStages][kBlockQ];      // {lse * log2 e, D}
  uint64_t kv_full;
  uint64_t full[kStages], empty[kStages];
  uint64_t xchg_full[kConsumers];  // warpgroup c's half-partial is written
  uint64_t dq_full[kConsumers][2];  // dq_out[c][s] holds a step's sums
  uint64_t dq_free[kConsumers][2];  // their addition to dq_acc has completed
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // + alignment slack

// stats[bh, i] = {lse * log2 e, D = sum_d dO o O} for i < L, {+inf, 0} for
// L <= i < padded_len, dq_acc's row i of head bh set to zero, and with the
// first row of a q tile the tile's two semaphores (one per half).  Eight
// lanes take one (padded row, head) unit u: row u / num_heads of batch
// element b, head u % num_heads, 16 bytes of the packed o/dO row and 16 of
// the dq_acc row each.
__global__ void __launch_bounds__(256)
    attention_bwd_stats_kernel(const bf16* __restrict__ o, const bf16* __restrict__ d_o,
                               const float* __restrict__ lse, float2* __restrict__ stats,
                               float* __restrict__ dq_acc, int* __restrict__ sem, int64_t n_units, int seq_len,
                               int padded_len, int num_heads) {
  const int64_t u = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 8;
  if (u >= n_units) return;
  const int part = threadIdx.x % 8;
  const int h = (int)(u % num_heads);
  const int64_t bi = u / num_heads;
  const int b = (int)(bi / padded_len);
  const int i = (int)(bi % padded_len);
  const int64_t bh = (int64_t)b * num_heads + h;
  // row i % 64 of both halves of tile i / 64 (see dq_half_offset); part p
  // zeroes columns [4p, 4p + 4) of the row in half 0 and in half 1
  float* dq_row = dq_acc + (bh * (padded_len / 64) + i / 64) * 64 * kHeadDim + (i % 64) * 32 + 4 * part;
  reinterpret_cast<float4*>(dq_row)[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  reinterpret_cast<float4*>(dq_row + 64 * 32)[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i % 64 == 0 && part < 2) sem[(bh * (padded_len / 64) + i / 64) * 2 + part] = 0;
  float dot = 0.f;
  if (i < seq_len) {
    const int64_t off = (((int64_t)b * seq_len + i) * num_heads + h) * kHeadDim + 8 * part;
    const uint4 a = *reinterpret_cast<const uint4*>(o + off);
    const uint4 c = *reinterpret_cast<const uint4*>(d_o + off);
    const uint32_t av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[k]));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&cv[k]));
      dot = fmaf(x.x, y.x, fmaf(x.y, y.y, dot));
    }
  }
  dot += __shfl_xor_sync(0xffffffffu, dot, 4);
  dot += __shfl_xor_sync(0xffffffffu, dot, 2);
  dot += __shfl_xor_sync(0xffffffffu, dot, 1);
  if (part == 0) {
    stats[bh * padded_len + i] = i < seq_len ? make_float2(lse[bh * seq_len + i] * kLog2e, dot)
                                             : make_float2(INFINITY, 0.f);
  }
}

// Offset (in floats) of (row, col) in a 64-row x 32-column f32 half-tile of
// dQ sums: rows of 128 bytes whose 16-byte chunk k is stored at k ^ (row %
// 8), so a warp's fragment stores meet no bank twice.
__device__ __forceinline__ int dq_half_offset(int row, int col) {
  return row * 32 + (((col >> 2) ^ (row & 7)) << 2) + (col & 3);
}

// dq = bf16(dq_acc).  dq_acc holds, per (batch * head, 64-row q tile), the
// tile's 64 x 64 f32 sums as two halves of columns [0, 32) and [32, 64),
// each laid out as dq_half_offset says; one float4 (four columns) a thread.
__global__ void attention_bwd_dq_cast_kernel(const float4* __restrict__ src, bf16* __restrict__ dq, int64_t n4,
                                             int seq_len, int n_q, int num_heads) {
  const int64_t row_stride = (int64_t)num_heads * kHeadDim;
  for (int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; f < n4; f += (int64_t)gridDim.x * blockDim.x) {
    const int64_t tile = f / 1024;
    const int half = (int)(f / 512 % 2);
    const int row_in = (int)(f % 512 / 8);
    const int row = (int)(tile % n_q) * 64 + row_in;
    if (row >= seq_len) continue;
    const int col = 32 * half + 4 * ((int)(f % 8) ^ (row_in & 7));
    const int64_t bh = tile / n_q;
    const float4 x = src[f];
    *reinterpret_cast<uint2*>(dq + ((bh / num_heads) * seq_len + row) * row_stride + (bh % num_heads) * kHeadDim +
                              col) = make_uint2(ucod::pack_bf16x2(x.x, x.y), ucod::pack_bf16x2(x.z, x.w));
  }
}

// Sum this warpgroup's dQ partial with the other's over the columns this
// warpgroup owns, [32C, 32C + 32), into the half-tile `out` (see
// dq_half_offset).  The hand-over is an mbarrier per
// writer, so a warpgroup waits only for the other's partial of this step
// and the two may run up to a step apart; the buffers alternate by step
// parity, and a writer two steps on has waited for the reader's next
// partial, written after its read.
template <int C>
__device__ __forceinline__ void dq_exchange_add(float (&dq)[32], float2 (*xchg)[8][128], uint64_t* xchg_full,
                                                uint32_t parity, int tid, float* out) {
  constexpr int kOther = C ^ 1;
#pragma unroll
  for (int t = 0; t < 8; ++t) xchg[C][t][tid] = make_float2(dq[16 * kOther + 2 * t], dq[16 * kOther + 2 * t + 1]);
  ucod::mbar_arrive(&xchg_full[C]);
  ucod::mbar_wait(&xchg_full[kOther], parity);
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const float2 p = xchg[kOther][t][tid];
    dq[16 * C + 2 * t] += p.x;
    dq[16 * C + 2 * t + 1] += p.y;
  }
  const int row = 16 * (tid / 32) + tid % 32 / 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int jb = 4 * C + j;
    const int col = 8 * j + 2 * (tid % 4);
    *reinterpret_cast<float2*>(out + dq_half_offset(row, col)) = make_float2(dq[4 * jb], dq[4 * jb + 1]);
    *reinterpret_cast<float2*>(out + dq_half_offset(row + 8, col)) = make_float2(dq[4 * jb + 2], dq[4 * jb + 3]);
  }
}

// Accumulator pairs of a 64 x 64 product, as bf16 A fragments of the next
// product's four k-steps (see hopper.cuh).
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = ucod::pack_bf16x2(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                         const float2* __restrict__ stats, float* __restrict__ dq_acc, int* __restrict__ sem,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int seq_len, int padded_len,
                         int num_heads, float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (ucod::smem_addr(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128;
  const int bh = blockIdx.y;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int k0 = blockIdx.x * kBlockK;
  const int n_q = padded_len / kBlockQ;
  const int q_first = blockIdx.x * n_q / gridDim.x;  // this CTA's first q tile; step i takes (q_first + i) % n_q

  if (threadIdx.x == 0) {
    ucod::mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      ucod::mbar_init(&sm.full[s], 1);
      ucod::mbar_init(&sm.empty[s], 4 * kConsumers);  // lane 0 of every consumer warp
    }
#pragma unroll
    for (int c = 0; c < kConsumers; ++c) {
      ucod::mbar_init(&sm.xchg_full[c], 128);
      ucod::mbar_init(&sm.dq_full[c][0], 128);
      ucod::mbar_init(&sm.dq_full[c][1], 128);
      ucod::mbar_init(&sm.dq_free[c][0], 1);
      ucod::mbar_init(&sm.dq_free[c][1], 1);
    }
    ucod::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    ucod::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      ucod::mbar_expect_tx(&sm.kv_full, 2 * kKvBytes);
      ucod::tma_load_3d(sm.k, &tm_k, &sm.kv_full, h * kHeadDim, k0, b);
      ucod::tma_load_3d(sm.v, &tm_v, &sm.kv_full, h * kHeadDim, k0, b);
      const float2* stats_h = stats + (int64_t)bh * padded_len;
      for (int i = 0; i < n_q; ++i) {
        const int st = i % kStages;
        const int tile = (q_first + i) % n_q;
        ucod::mbar_wait(&sm.empty[st], ((i / kStages) & 1) ^ 1);
        ucod::mbar_expect_tx(&sm.full[st], 2 * kQBytes + kStatBytes);
        ucod::tma_load_3d(sm.q[st], &tm_q, &sm.full[st], h * kHeadDim, tile * kBlockQ, b);
        ucod::tma_load_3d(sm.d_o[st], &tm_do, &sm.full[st], h * kHeadDim, tile * kBlockQ, b);
        ucod::bulk_load(sm.stats[st], stats_h + tile * kBlockQ, kStatBytes, &sm.full[st]);
      }
    } else if (threadIdx.x == 32 || threadIdx.x == 64) {
      // dQ writer of warpgroup c (lane 0 of warps 1 and 2): the ordered
      // addition of each step's half-tile.  This CTA's rank in q tile t's
      // order: m = ceil((t + 1) * n_k / n_q) CTAs start at or before t and
      // reach it first, the later-starting ones after them, each group in
      // descending key tile (the one that started nearest t first).
      const int c = threadIdx.x / 32 - 1;
      const int n_k = gridDim.x;
      float* dq_head = dq_acc + (int64_t)bh * n_q * 64 * kHeadDim;
      int* sem_h = sem + (int64_t)bh * n_q * 2 + c;
      for (int i = 0; i < n_q; ++i) {
        const int tile = (q_first + i) % n_q;
        const int m = ((tile + 1) * n_k + n_q - 1) / n_q;
        const int rank = (int)blockIdx.x < m ? m - 1 - (int)blockIdx.x : m + n_k - 1 - (int)blockIdx.x;
        const int64_t dst = (int64_t)tile * 64 * kHeadDim + c * 32 * 64;
        ucod::mbar_wait(&sm.dq_full[c][i & 1], (i >> 1) & 1);
        while (ucod::ld_acquire_gpu(sem_h + 2 * tile) != rank) {}
        ucod::fence_proxy_async_global();
        ucod::bulk_reduce_add_f32(dq_head + dst, sm.dq_out[c][i & 1], 32 * 64 * 4);
        ucod::bulk_commit();
        ucod::bulk_wait<0>();
        ucod::fence_proxy_async_global();
        ucod::st_release_gpu(sem_h + 2 * tile, rank + 1);
        ucod::mbar_arrive(&sm.dq_free[c][i & 1]);
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
    const bf16* k_c = sm.k + c * 64 * kHeadDim;
    const bf16* v_c = sm.v + c * 64 * kHeadDim;
    bf16* ds = sm.ds[c];
    const int key0 = k0 + 64 * c + 16 * warp + g;  // this thread's keys: key0, key0 + 8
    const bool keys_past_l = k0 + 64 * c + 64 > seq_len;
    const int64_t row_stride = (int64_t)num_heads * kHeadDim;

    float dk_acc[32], dv_acc[32], dq[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    float s[32], dp[32];
    ucod::mbar_wait(&sm.kv_full, 0);

    // Step i in three parts, software-pipelined: the S and dP products of
    // step i are issued before the dQ partial of step i - 1 is summed and
    // handed to the writer, so the tensor cores have work while this
    // warpgroup runs the exchange.  Every other product completes within its
    // step.
    auto issue_s_dp = [&](int i) {  // two commit groups: S^T = K Q^T, dP^T = V dO^T
      const int st = i % kStages;
      ucod::mbar_wait(&sm.full[st], (i / kStages) & 1);
      ucod::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        ucod::wgmma_m64n64k16_ss<0, 0>(s, ucod::desc_kmajor(k_c, kk), ucod::desc_kmajor(sm.q[st], kk), kk);
      }
      ucod::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        ucod::wgmma_m64n64k16_ss<0, 0>(dp, ucod::desc_kmajor(v_c, kk), ucod::desc_kmajor(sm.d_o[st], kk), kk);
      }
      ucod::wgmma_commit();
    };
    // with S and dP the only groups in flight: P, dV, dS, dK and the dQ
    // partial, all completed on return
    auto issue_rest = [&](int i) {
      const int st = i % kStages;
      ucod::wgmma_wait<1>();
      ucod::fence_regs(s);
      // P^T = exp2(S^T * scale log2 e - lse log2 e): query columns >= L have
      // lse = +inf (P = 0); key rows >= L are zeroed
      const float2* stat = sm.stats[st];
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        s[e] = ucod::exp2_ftz(fmaf(s[e], scale_log2, -stat[8 * (e >> 2) + 2 * tq + (e & 1)].x));
      }
      if (keys_past_l) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          if (key0 + 8 * ((e >> 1) & 1) >= seq_len) s[e] = 0.f;
        }
      }
      uint32_t pa[4][4];
      to_a_frags(pa, s);
      ucod::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockQ / 16; ++kk) {  // dV += P^T dO
        ucod::wgmma_m64n64k16_rs<1>(dv_acc, pa[kk], ucod::desc_mnmajor(sm.d_o[st], kk), 1);
      }
      ucod::wgmma_commit();
      ucod::wgmma_wait<1>();
      ucod::fence_regs(dp);

      // dS^T = P^T o (dP^T - D) * scale
#pragma unroll
      for (int e = 0; e < 32; ++e) dp[e] = s[e] * (dp[e] - stat[8 * (e >> 2) + 2 * tq + (e & 1)].y) * scale;
      uint32_t da[4][4];
      to_a_frags(da, dp);
      ucod::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockQ / 16; ++kk) {  // dK += dS^T Q
        ucod::wgmma_m64n64k16_rs<1>(dk_acc, da[kk], ucod::desc_mnmajor(sm.q[st], kk), 1);
      }
      ucod::wgmma_commit();

      // dS^T into shared memory, [key][query] with the 128-byte swizzle, for
      // dQ = dS K with dS read MN-major (the previous step's dQ has completed)
#pragma unroll
      for (int jb = 0; jb < kBlockQ / 8; ++jb) {
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int key = 16 * warp + g + 8 * rh;
          *reinterpret_cast<uint32_t*>(ds + key * kBlockQ + ((jb ^ (key & 7)) * 8) + 2 * tq) =
              da[jb >> 1][(jb & 1) * 2 + rh];
        }
      }
      ucod::fence_proxy_async();
      ucod::named_sync(kWgBar + c, 128);
      ucod::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 64 / 16; ++kk) {  // dQ partial = dS K over this warpgroup's keys
        ucod::wgmma_m64n64k16_ss<1, 1>(dq, ucod::desc_mnmajor(ds, kk), ucod::desc_mnmajor(k_c, kk), kk);
      }
      ucod::wgmma_commit();
      ucod::wgmma_wait<0>();
      ucod::fence_regs(dq);
      ucod::fence_regs(dk_acc);
      ucod::fence_regs(dv_acc);
    };
    // step i's products done: free its stage, sum its dQ partial into
    // dq_out[c][i & 1] once the writer has added that buffer's step i - 2,
    // and hand it over
    auto finish = [&](int i) {
      if (lane == 0) ucod::mbar_arrive(&sm.empty[i % kStages]);
      float* out = sm.dq_out[c][i & 1];
      ucod::mbar_wait(&sm.dq_free[c][i & 1], ((i >> 1) & 1) ^ 1);
      if (c == 0) {
        dq_exchange_add<0>(dq, sm.xchg[i & 1], sm.xchg_full, i & 1, tid, out);
      } else {
        dq_exchange_add<1>(dq, sm.xchg[i & 1], sm.xchg_full, i & 1, tid, out);
      }
      ucod::fence_proxy_async();
      ucod::mbar_arrive(&sm.dq_full[c][i & 1]);
    };

    issue_s_dp(0);
    issue_rest(0);
    for (int i = 1; i < n_q; ++i) {
      issue_s_dp(i);
      finish(i - 1);
      issue_rest(i);
    }
    finish(n_q - 1);

    bf16* dk_h = dk + (int64_t)b * seq_len * row_stride + (int64_t)h * kHeadDim;
    bf16* dv_h = dv + (int64_t)b * seq_len * row_stride + (int64_t)h * kHeadDim;
#pragma unroll
    for (int jb = 0; jb < kHeadDim / 8; ++jb) {
      const int col = 8 * jb + 2 * tq;
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int key = key0 + 8 * rh;
        if (key < seq_len) {
          *reinterpret_cast<uint32_t*>(dk_h + (int64_t)key * row_stride + col) =
              ucod::pack_bf16x2(dk_acc[4 * jb + 2 * rh], dk_acc[4 * jb + 2 * rh + 1]);
          *reinterpret_cast<uint32_t*>(dv_h + (int64_t)key * row_stride + col) =
              ucod::pack_bf16x2(dv_acc[4 * jb + 2 * rh], dv_acc[4 * jb + 2 * rh + 1]);
        }
      }
    }
  }
}

}  // namespace

// q, k, v, o, d_o, dq, dk, dv: contiguous bf16 (batch, seq_len, num_heads *
// 64), 16-byte aligned; lse: contiguous f32 (batch, num_heads, seq_len) from
// ucod_attention_fwd_lse; stats and dq_acc: f32 scratch of batch * num_heads
// * padded * 2 and * 64 values, padded = seq_len rounded up to a multiple of
// 64, 16-byte aligned, filled by the pre-pass; dq_acc followed by batch *
// num_heads * padded / 64 * 2 int32 semaphores (the same allocation).  Launches the pre-pass, the
// main kernel and the dq cast on `stream`; returns the first failed launch's
// cudaError_t (cudaErrorInvalidValue when a tensor map cannot be made), or 0.
extern "C" int ucod_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                  const void* d_o, const void* lse, void* stats, void* dq_acc, void* dq,
                                  void* dk, void* dv, int batch, int seq_len, int num_heads, float scale,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int padded = (seq_len + kBlockQ - 1) / kBlockQ * kBlockQ;
  const int64_t n_units = (int64_t)batch * padded * num_heads;
  int* sem = reinterpret_cast<int*>(static_cast<float*>(dq_acc) + n_units * kHeadDim);
  attention_bwd_stats_kernel<<<(unsigned)((n_units * 8 + 255) / 256), 256, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(d_o), static_cast<const float*>(lse),
      static_cast<float2*>(stats), static_cast<float*>(dq_acc), sem, n_units, seq_len, padded, num_heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  const int cols = num_heads * kHeadDim;
  if (!ucod::packed_tensor_map(&tm_q, q, batch, seq_len, cols, kBlockQ) ||
      !ucod::packed_tensor_map(&tm_do, d_o, batch, seq_len, cols, kBlockQ) ||
      !ucod::packed_tensor_map(&tm_k, k, batch, seq_len, cols, kBlockK) ||
      !ucod::packed_tensor_map(&tm_v, v, batch, seq_len, cols, kBlockK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaFuncSetAttribute(attention_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq_len + kBlockK - 1) / kBlockK, batch * num_heads);
  attention_bwd_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float2*>(stats), static_cast<float*>(dq_acc), sem,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq_len, padded, num_heads, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t n4 = (int64_t)batch * num_heads * padded * kHeadDim / 4;
  const unsigned blocks = (unsigned)((n4 + 255) / 256 < 8192 ? (n4 + 255) / 256 : 8192);
  attention_bwd_dq_cast_kernel<<<blocks, 256, 0, s>>>(static_cast<const float4*>(dq_acc), static_cast<bf16*>(dq),
                                                      n4, seq_len, padded / kBlockQ, num_heads);
  return static_cast<int>(cudaGetLastError());
}
