// K8, K9, K10, K11: the int8 (W8A8) kernels of the int8 serving path.
//
// Replace the TPU kernels of ucod_dpl_tpu/ops/fused_layers.py:
//   K8  _lnqkv_w8a8_kernel      LayerNorm + per-token int8 quantization + the
//                               three q/k/v products          -> ucod_layernorm_qkv_w8a8
//   K10 _quantdense_w8a8_kernel per-token quantization + one product (the
//                               attention out-projection)      -> ucod_quant_dense_w8a8
//   K9  _lnfc1gelu_w8a8_kernel  LayerNorm + quantization + fc1 + tanh GELU +
//                               per-token requantization       -> ucod_layernorm_fc1_gelu_w8a8
//   K11 _lnmlp_w8a8_kernel      K9, then fc2 on the codes kept on chip
//                                                              -> ucod_layernorm_mlp_w8a8
//
// Arithmetic, as the TPU kernels compute it: LayerNorm statistics in f32
// (mean, then mean((x - mean)^2), 1 / sqrt(var + eps), * scale + bias; h
// stays f32; the sums in an order the plain version repeats, and the
// reciprocal square root correctly rounded where the TPU used rsqrt);
// s = max(max|h| / 127, 1e-12) per row; codes = clip(rint(h / s), -127, 127)
// with a true division and ties to even.  The divisions by constants are
// multiplies, sum * (1 / d) and max * (1 / 127), as XLA computes them under
// jit; the plain versions do the same.  Exact s8 x s8 -> s32 products
// (mma.sync m16n8k32; the largest sum, 127^2 * 3072, is far inside int32);
// the epilogue acc * (s_x * w_s) + b in f32, in that order, rounded once at
// the store.  Multiplies, adds and divisions that the plain PyTorch version
// rounds separately are written as __fmul_rn / __fadd_rn / __fdiv_rn, so
// nvcc contracts none of them into an fma.
//
// Weights stay in the (out, in) layout of ops/quant.py: each output row is
// K-contiguous, the "col" B operand of mma.sync.  In bytes an s8 16x32 A tile
// and an 8x32 B tile have the fragments of bf16 16x16 / 8x16 tiles, so the
// bf16 ldmatrix addressing of common.cuh feeds them.
//
// What bounds them on the H100, at bs16 / 518px (21,920 rows, D = 768,
// F = 3072):
//   * K8 and K10 (78 and 26 GOP): the LayerNorm / quantization prologue is
//     recomputed by every column tile of a row tile (9 for K8, 3 for K10)
//     and the weights are re-read from L2 by every row tile (0.6 and 0.2 GB
//     per call); mma.sync runs at most at half of the int8 wgmma rate.
//     Design: a CTA of 8 warps owns a 64-row x 256-column output tile;
//     it normalises and quantizes its 64 rows straight from global memory
//     into shared memory as int8 (64 x 784 bytes), streams 128-byte K slices
//     of its 256 weight rows with cp.async (double-buffered) and runs
//     32 x 64 warp tiles.  124 KB of shared memory: one CTA per SM.
//   * K9 and K11 (103 and 207 GOP): the requantization scale spans all F
//     fc1 outputs of a row, so a CTA owns 16 whole rows.  It runs fc1 over
//     all F columns in 128-column chunks with W1 streamed in 64-byte K
//     slices, keeps g = gelu(h1) in f32 in shared memory (16 x 3076 x 4 =
//     197 KB, 230 KB in all, one CTA per SM), takes each row's max and
//     quantizes.  W1 (2.4 MB) is re-read from L2 once per 16-row tile, about
//     3.2 GB of L2 traffic per call, and every W1 byte feeds one m16 tile
//     only: L2 and shared-memory bandwidth bound them, not the tensor cores.
//     K9 stores the codes and scales; K11 converts g to codes in place (one
//     warp per row, reads before writes) and runs fc2 over W2 from them, so
//     the hidden expansion never leaves the SM.
// Rows at or past `rows` are never read (their codes are zero) and never
// stored.  Not yet used: wgmma, TMA, clusters sharing row maxima through
// distributed shared memory, a persistent schedule (later work).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kQuantEps = 1e-12f;
constexpr float kInv127 = 1.f / 127.f;  // scales are max * (1 / 127), as XLA computes max / 127 under jit
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSmem = 232448;  // what one block may take on Hopper

__device__ __forceinline__ uint32_t quantize4(float a, float b, float c, float d, float s) {
  const auto q = [s](float h) {
    return static_cast<uint32_t>(
        static_cast<uint8_t>(static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(h, s)), -127.f), 127.f))));
  };
  return q(a) | (q(b) << 8) | (q(c) << 16) | (q(d) << 24);
}

__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fmul_rn(amax, kInv127), kQuantEps);
}

// jax.nn.gelu(approximate=True) in f32: x * (0.5 * (1 + tanh(c * (x + 0.044715 x^3))))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float cube = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(x, __fmul_rn(0.044715f, cube)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(inner))));
}

__device__ __forceinline__ float tree_sum8(const float (&a)[8]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), __fadd_rn(a[2], a[3])),
                   __fadd_rn(__fadd_rn(a[4], a[5]), __fadd_rn(a[6], a[7])));
}

// Rows [row0, row0 + nrows) of x (rows, k) bf16 -> int8 codes [nrows][ldc]
// and scales [nrows] in shared memory, after a LayerNorm when kLN.  Warp w
// takes rows w, w + 8, ...; lane l holds columns 256 j + 8 l .. + 7 (k % 256
// == 0, k <= 1024).  Rows >= rows are not read: codes 0, scale 0.
template <bool kLN>
__device__ __forceinline__ void quantize_rows(const __nv_bfloat16* __restrict__ x,
                                              const float* __restrict__ gamma,
                                              const float* __restrict__ beta, int row0, int nrows,
                                              int rows, int k, float eps, int8_t* codes, int ldc,
                                              float* scales) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunks = k >> 8;
  for (int r = warp; r < nrows; r += kWarps) {
    int8_t* crow = codes + r * ldc;
    if (row0 + r >= rows) {
      for (int c = lane * 8; c < k; c += 256) *reinterpret_cast<uint2*>(crow + c) = make_uint2(0, 0);
      if (lane == 0) scales[r] = 0.f;
      continue;
    }
    const __nv_bfloat16* xr = x + (int64_t)(row0 + r) * k + lane * 8;
    float v[4][8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < chunks) {
        const uint4 u = *reinterpret_cast<const uint4*>(xr + j * 256);
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(p[i]);
          v[j][2 * i] = f.x;
          v[j][2 * i + 1] = f.y;
        }
      }
    }
    if (kLN) {
      // the statistics in a fixed order that the plain version repeats
      // (fused_layers.py::_kernel_row_sum): a pairwise tree over each lane's
      // 8 values, the chunks in order, then the xor butterfly of warp_sum
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < chunks) sum = __fadd_rn(sum, tree_sum8(v[j]));
      const float inv_k = __fdiv_rn(1.f, static_cast<float>(k));
      const float mean = __fmul_rn(ucod::warp_sum(sum), inv_k);
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < chunks) {
          float c2[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            v[j][i] = __fsub_rn(v[j][i], mean);
            c2[i] = __fmul_rn(v[j][i], v[j][i]);
          }
          sq = __fadd_rn(sq, tree_sum8(c2));
        }
      }
      const float var = __fmul_rn(ucod::warp_sum(sq), inv_k);
      const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < chunks) {
          const int c0 = j * 256 + lane * 8;
          const float4 g0 = *reinterpret_cast<const float4*>(gamma + c0);
          const float4 g1 = *reinterpret_cast<const float4*>(gamma + c0 + 4);
          const float4 b0 = *reinterpret_cast<const float4*>(beta + c0);
          const float4 b1 = *reinterpret_cast<const float4*>(beta + c0 + 4);
          const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
            v[j][i] = __fadd_rn(__fmul_rn(__fmul_rn(v[j][i], rstd), gv[i]), bv[i]);
        }
      }
    }
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < chunks)
#pragma unroll
        for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[j][i]));
    const float s = row_scale(ucod::warp_max(amax));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < chunks) {
        const uint2 packed = make_uint2(quantize4(v[j][0], v[j][1], v[j][2], v[j][3], s),
                                        quantize4(v[j][4], v[j][5], v[j][6], v[j][7], s));
        *reinterpret_cast<uint2*>(crow + j * 256 + lane * 8) = packed;
      }
    }
    if (lane == 0) scales[r] = s;
  }
}

// Weight rows [n0, n0 + BN), bytes [k0, k0 + BK) of an (N, k) int8 matrix
// into a [BN][LDW] shared tile.
template <int BN, int BK, int LDW>
__device__ __forceinline__ void load_w_tile(int8_t* dst, const int8_t* w, int n0, int k0, int k) {
  constexpr int kPerRow = BK / 16;
  for (int idx = threadIdx.x; idx < BN * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx - r * kPerRow) * 16;
    ucod::cp_async16(dst + r * LDW + c, w + (int64_t)(n0 + r) * k + k0 + c, true);
  }
}

// ---------------------------------------------------------------------------
// K8 / K10: 64 rows x 256 columns per CTA
// ---------------------------------------------------------------------------

constexpr int kBM = 64;
constexpr int kBN = 256;
constexpr int kBK = 128;
constexpr int kLdw = kBK + 16;  // 144-byte rows: conflict-free ldmatrix
constexpr int kWM = 2;          // warps along M (32 rows each) x 4 along N (64 columns)
constexpr int kMi = 2;
constexpr int kNi = 8;

struct Proj3 {
  const int8_t* w[3];
  const float* ws[3];
  const float* b[3];
  __nv_bfloat16* o[3];
};

int quant_gemm_smem(int k) { return 2 * kBN * kLdw + kBM * (k + 16) + kBM * 4; }

// out_p = (quantize(LN?(x)) W_p^T) * (s_x * w_s_p) + b_p for the projection p
// that column tile blockIdx.x falls in; n columns per projection.
template <bool kLN>
__global__ void __launch_bounds__(kThreads)
    quant_gemm_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, Proj3 p, int rows, int k, int n, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ws = reinterpret_cast<int8_t*>(smem);  // [2][kBN][kLdw]
  const int ldc = k + 16;
  int8_t* codes = ws + 2 * kBN * kLdw;  // [kBM][ldc]
  float* scales = reinterpret_cast<float*>(codes + kBM * ldc);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int col0 = blockIdx.x * kBN;
  const int which = col0 / n;
  const int n0 = col0 - which * n;
  const int row0 = blockIdx.y * kBM;
  const int8_t* w = which == 0 ? p.w[0] : (which == 1 ? p.w[1] : p.w[2]);
  const float* wscale = which == 0 ? p.ws[0] : (which == 1 ? p.ws[1] : p.ws[2]);
  const float* bias = which == 0 ? p.b[0] : (which == 1 ? p.b[1] : p.b[2]);
  __nv_bfloat16* out = which == 0 ? p.o[0] : (which == 1 ? p.o[1] : p.o[2]);

  load_w_tile<kBN, kBK, kLdw>(ws, w, n0, 0, k);  // flies while the rows are quantized
  ucod::cp_async_commit();
  quantize_rows<kLN>(x, gamma, beta, row0, kBM, rows, k, eps, codes, ldc, scales);

  const int wm = warp % kWM;
  const int wn = warp / kWM;
  int acc[kMi][kNi][4];
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNi; ++nj) acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] = 0;

  const int8_t* a_base = codes + (wm * 32 + (lane & 15)) * ldc + (lane >> 4) * 16;
  const int b_off = (wn * 64 + (lane & 7) + ((lane >> 4) << 3)) * kLdw + ((lane >> 3) & 1) * 16;
  const int k_tiles = k / kBK;
  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) {
      load_w_tile<kBN, kBK, kLdw>(ws + ((kt + 1) & 1) * kBN * kLdw, w, n0, (kt + 1) * kBK, k);
      ucod::cp_async_commit();
      ucod::cp_async_wait<1>();
    } else {
      ucod::cp_async_wait<0>();
    }
    __syncthreads();  // also orders the prologue's codes before the first reads
    const int8_t* wt = ws + (kt & 1) * kBN * kLdw + b_off;
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      uint32_t a[kMi][4];
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi) ucod::ldmatrix_x4(a[mi], a_base + mi * 16 * ldc + kt * kBK + kk * 32);
#pragma unroll
      for (int nj = 0; nj < kNi; nj += 2) {
        uint32_t b[4];
        ucod::ldmatrix_x4(b, wt + nj * 8 * kLdw + kk * 32);
#pragma unroll
        for (int mi = 0; mi < kMi; ++mi) {
          ucod::mma_s8_16832(acc[mi][nj], a[mi], b[0], b[1]);
          ucod::mma_s8_16832(acc[mi][nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's copies
  }

#pragma unroll
  for (int mi = 0; mi < kMi; ++mi) {
    const int lr = wm * 32 + mi * 16 + g;
    const float sx0 = scales[lr];
    const float sx1 = scales[lr + 8];
    const int r0 = row0 + lr;
#pragma unroll
    for (int nj = 0; nj < kNi; ++nj) {
      const int c = n0 + wn * 64 + nj * 8 + 2 * t;
      const float w0 = wscale[c], w1 = wscale[c + 1], b0 = bias[c], b1 = bias[c + 1];
      if (r0 < rows) {
        *reinterpret_cast<uint32_t*>(out + (int64_t)r0 * n + c) = ucod::pack_bf16x2(
            __fadd_rn(__fmul_rn(static_cast<float>(acc[mi][nj][0]), __fmul_rn(sx0, w0)), b0),
            __fadd_rn(__fmul_rn(static_cast<float>(acc[mi][nj][1]), __fmul_rn(sx0, w1)), b1));
      }
      if (r0 + 8 < rows) {
        *reinterpret_cast<uint32_t*>(out + (int64_t)(r0 + 8) * n + c) = ucod::pack_bf16x2(
            __fadd_rn(__fmul_rn(static_cast<float>(acc[mi][nj][2]), __fmul_rn(sx1, w0)), b0),
            __fadd_rn(__fmul_rn(static_cast<float>(acc[mi][nj][3]), __fmul_rn(sx1, w1)), b1));
      }
    }
  }
}

template <bool kLN>
int launch_quant_gemm(const void* x, const void* gamma, const void* beta, const Proj3& p, int n_proj,
                      int rows, int k, int n, float eps, void* stream) {
  if (k % 256 != 0 || k > 1024 || n % kBN != 0 || rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = quant_gemm_kernel<kLN>;
  const int smem = quant_gemm_smem(k);
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_proj * n / kBN, (rows + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), p, rows, k, n, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K9 / K11: 16 whole rows per CTA
// ---------------------------------------------------------------------------

constexpr int kRows = 16;
constexpr int kChunk = 128;  // output columns per pass; warp w owns 16 of them
constexpr int kBK2 = 64;
constexpr int kLdw2 = kBK2 + 16;  // 80-byte rows: conflict-free ldmatrix

int mlp_smem(int d, int f) {
  return 2 * kChunk * kLdw2 + kRows * (f + 4) * 4 + kRows * (d + 16) + 2 * kRows * 4;
}

// acc = A (16 x kdim int8, shared, row stride lda bytes) times the transpose
// of the (n_total, kdim) int8 matrix w, 128 columns at a time: after each
// chunk epi(chunk, acc) is called with this warp's 16 x 16 block (rows g and
// g + 8, columns chunk * 128 + 16 warp + 8 nj + 2 t, + 1).  W is streamed in
// 64-byte K slices, double-buffered across chunk boundaries.
template <typename Epi>
__device__ __forceinline__ void gemm_rows16(const int8_t* a, int lda, const int8_t* __restrict__ w,
                                            int n_total, int kdim, int8_t* wstage, Epi epi) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k_tiles = kdim / kBK2;
  const int stages = (n_total / kChunk) * k_tiles;
  const int8_t* a_base = a + (lane & 15) * lda + (lane >> 4) * 16;
  const int b_off = (warp * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdw2 + ((lane >> 3) & 1) * 16;
  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};

  load_w_tile<kChunk, kBK2, kLdw2>(wstage, w, 0, 0, kdim);
  ucod::cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    const int chunk = s / k_tiles;
    const int kt = s - chunk * k_tiles;
    if (s + 1 < stages) {
      const int nc = (s + 1) / k_tiles;
      load_w_tile<kChunk, kBK2, kLdw2>(wstage + ((s + 1) & 1) * kChunk * kLdw2, w, nc * kChunk,
                                       (s + 1 - nc * k_tiles) * kBK2, kdim);
      ucod::cp_async_commit();
      ucod::cp_async_wait<1>();
    } else {
      ucod::cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* wt = wstage + (s & 1) * kChunk * kLdw2 + b_off;
#pragma unroll
    for (int kk = 0; kk < kBK2 / 32; ++kk) {
      uint32_t af[4], b[4];
      ucod::ldmatrix_x4(af, a_base + kt * kBK2 + kk * 32);
      ucod::ldmatrix_x4(b, wt + kk * 32);
      ucod::mma_s8_16832(acc[0], af, b[0], b[1]);
      ucod::mma_s8_16832(acc[1], af, b[2], b[3]);
    }
    __syncthreads();
    if (kt == k_tiles - 1) {
      epi(chunk, acc);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) acc[nj][0] = acc[nj][1] = acc[nj][2] = acc[nj][3] = 0;
    }
  }
}

// The shared front of K9 and K11: LN + quantization of 16 rows, fc1, GELU
// into gs (f32, [16][f + 4]) and each row's max |g| into rowmax (as int bits,
// all values >= 0).  Ends with a barrier.
__device__ __forceinline__ void ln_fc1_gelu_rows(const __nv_bfloat16* __restrict__ x,
                                                 const float* __restrict__ gamma,
                                                 const float* __restrict__ beta,
                                                 const int8_t* __restrict__ w1,
                                                 const float* __restrict__ w1s,
                                                 const float* __restrict__ b1, int row0, int rows,
                                                 int d, int f, float eps, unsigned char* smem,
                                                 float*& gs, float*& rowmax) {
  int8_t* wstage = reinterpret_cast<int8_t*>(smem);
  gs = reinterpret_cast<float*>(smem + 2 * kChunk * kLdw2);
  const int ldg = f + 4;
  int8_t* codes = reinterpret_cast<int8_t*>(gs + kRows * ldg);
  const int ldc = d + 16;
  float* sx = reinterpret_cast<float*>(codes + kRows * ldc);
  rowmax = sx + kRows;
  if (threadIdx.x < kRows) rowmax[threadIdx.x] = 0.f;
  quantize_rows<true>(x, gamma, beta, row0, kRows, rows, d, eps, codes, ldc, sx);
  // (gemm_rows16's first barrier orders the codes, sx and rowmax above)

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int warp = threadIdx.x >> 5;
  float m0 = 0.f, m1 = 0.f;
  float* gsl = gs;
  gemm_rows16(codes, ldc, w1, f, d, wstage, [&](int chunk, const int (&acc)[2][4]) {
    const float s0 = sx[g], s1 = sx[g + 8];
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      const int c = chunk * kChunk + warp * 16 + nj * 8 + 2 * t;
      const float wa = w1s[c], wb = w1s[c + 1], ba = b1[c], bb = b1[c + 1];
      const float2 lo = make_float2(
          gelu_tanh(__fadd_rn(__fmul_rn(static_cast<float>(acc[nj][0]), __fmul_rn(s0, wa)), ba)),
          gelu_tanh(__fadd_rn(__fmul_rn(static_cast<float>(acc[nj][1]), __fmul_rn(s0, wb)), bb)));
      const float2 hi = make_float2(
          gelu_tanh(__fadd_rn(__fmul_rn(static_cast<float>(acc[nj][2]), __fmul_rn(s1, wa)), ba)),
          gelu_tanh(__fadd_rn(__fmul_rn(static_cast<float>(acc[nj][3]), __fmul_rn(s1, wb)), bb)));
      *reinterpret_cast<float2*>(gsl + g * ldg + c) = lo;
      *reinterpret_cast<float2*>(gsl + (g + 8) * ldg + c) = hi;
      m0 = fmaxf(m0, fmaxf(fabsf(lo.x), fabsf(lo.y)));
      m1 = fmaxf(m1, fmaxf(fabsf(hi.x), fabsf(hi.y)));
    }
  });
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  if (t == 0) {
    atomicMax(reinterpret_cast<int*>(rowmax + g), __float_as_int(m0));
    atomicMax(reinterpret_cast<int*>(rowmax + g + 8), __float_as_int(m1));
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    ln_fc1_gelu_quant_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                             const float* __restrict__ beta, const int8_t* __restrict__ w1,
                             const float* __restrict__ w1s, const float* __restrict__ b1,
                             int8_t* __restrict__ out_codes, float* __restrict__ out_scales,
                             int rows, int d, int f, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.x * kRows;
  float* gs;
  float* rowmax;
  ln_fc1_gelu_rows(x, gamma, beta, w1, w1s, b1, row0, rows, d, f, eps, smem, gs, rowmax);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kWarps) {
    if (row0 + r >= rows) continue;
    const float s = row_scale(rowmax[r]);
    const float* grow = gs + r * (f + 4);
    int8_t* orow = out_codes + (int64_t)(row0 + r) * f;
    for (int c = lane * 4; c < f; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(grow + c);
      *reinterpret_cast<uint32_t*>(orow + c) = quantize4(v.x, v.y, v.z, v.w, s);
    }
    if (lane == 0) out_scales[row0 + r] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
    ln_mlp_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, const int8_t* __restrict__ w1,
                  const float* __restrict__ w1s, const float* __restrict__ b1,
                  const int8_t* __restrict__ w2, const float* __restrict__ w2s,
                  const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int rows, int d,
                  int f, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.x * kRows;
  float* gs;
  float* rowmax;
  ln_fc1_gelu_rows(x, gamma, beta, w1, w1s, b1, row0, rows, d, f, eps, smem, gs, rowmax);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ldg = f + 4;
  // g -> codes in place: row r's codes take the first f bytes of its own f32
  // row.  A warp walks its row in 128-value steps; step j writes the bytes of
  // values 32 j .. 32 j + 31, all read at step j or before (hence the
  // __syncwarp between the reads and the writes of a step).
  for (int r = warp; r < kRows; r += kWarps) {
    const float s = row_scale(rowmax[r]);
    float* grow = gs + r * ldg;
    int8_t* crow = reinterpret_cast<int8_t*>(grow);
    for (int c = lane * 4; c < f; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(grow + c);
      __syncwarp();
      *reinterpret_cast<uint32_t*>(crow + c) = quantize4(v.x, v.y, v.z, v.w, s);
      __syncwarp();
    }
  }
  // (gemm_rows16's first barrier orders the codes before fc2 reads them; the
  // weight stages were last read before ln_fc1_gelu_rows' final barrier)

  const int g = lane >> 2;
  const int t = lane & 3;
  const float s0 = row_scale(rowmax[g]);
  const float s1 = row_scale(rowmax[g + 8]);
  const int r0 = row0 + g;
  gemm_rows16(reinterpret_cast<const int8_t*>(gs), ldg * 4, w2, d, f, reinterpret_cast<int8_t*>(smem),
              [&](int chunk, const int (&acc)[2][4]) {
#pragma unroll
                for (int nj = 0; nj < 2; ++nj) {
                  const int c = chunk * kChunk + warp * 16 + nj * 8 + 2 * t;
                  const float wa = w2s[c], wb = w2s[c + 1], ba = b2[c], bb = b2[c + 1];
                  if (r0 < rows) {
                    *reinterpret_cast<uint32_t*>(out + (int64_t)r0 * d + c) = ucod::pack_bf16x2(
                        __fadd_rn(__fmul_rn(static_cast<float>(acc[nj][0]), __fmul_rn(s0, wa)), ba),
                        __fadd_rn(__fmul_rn(static_cast<float>(acc[nj][1]), __fmul_rn(s0, wb)), bb));
                  }
                  if (r0 + 8 < rows) {
                    *reinterpret_cast<uint32_t*>(out + (int64_t)(r0 + 8) * d + c) = ucod::pack_bf16x2(
                        __fadd_rn(__fmul_rn(static_cast<float>(acc[nj][2]), __fmul_rn(s1, wa)), ba),
                        __fadd_rn(__fmul_rn(static_cast<float>(acc[nj][3]), __fmul_rn(s1, wb)), bb));
                  }
                }
              });
}

int check_mlp(int rows, int d, int f) {
  if (rows <= 0 || d % 256 != 0 || d > 1024 || f % kChunk != 0 || mlp_smem(d, f) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// x: contiguous bf16 (rows, d); gamma/beta: f32 (d,); wq/wk/wv: int8 (d, d)
// in (out, in) layout; sq/sk/sv (per-output-channel scales) and bq/bk/bv:
// f32 (d,); oq/ok/ov: bf16 (rows, d).  d % 256 == 0, d <= 1024, 16-byte
// aligned pointers.  Launches on `stream`; returns the launch's cudaError_t.
extern "C" int ucod_layernorm_qkv_w8a8(const void* x, const void* gamma, const void* beta,
                                       const void* wq, const void* wk, const void* wv,
                                       const void* sq, const void* sk, const void* sv,
                                       const void* bq, const void* bk, const void* bv, void* oq,
                                       void* ok, void* ov, int rows, int d, float eps,
                                       void* stream) {
  const Proj3 p = {{static_cast<const int8_t*>(wq), static_cast<const int8_t*>(wk),
                    static_cast<const int8_t*>(wv)},
                   {static_cast<const float*>(sq), static_cast<const float*>(sk),
                    static_cast<const float*>(sv)},
                   {static_cast<const float*>(bq), static_cast<const float*>(bk),
                    static_cast<const float*>(bv)},
                   {static_cast<__nv_bfloat16*>(oq), static_cast<__nv_bfloat16*>(ok),
                    static_cast<__nv_bfloat16*>(ov)}};
  return launch_quant_gemm<true>(x, gamma, beta, p, 3, rows, d, d, eps, stream);
}

// x: contiguous bf16 (rows, k); w: int8 (n, k); ws, b: f32 (n,); out: bf16
// (rows, n).  k % 256 == 0, k <= 1024, n % 256 == 0.
extern "C" int ucod_quant_dense_w8a8(const void* x, const void* w, const void* ws, const void* b,
                                     void* out, int rows, int k, int n, void* stream) {
  const Proj3 p = {{static_cast<const int8_t*>(w), nullptr, nullptr},
                   {static_cast<const float*>(ws), nullptr, nullptr},
                   {static_cast<const float*>(b), nullptr, nullptr},
                   {static_cast<__nv_bfloat16*>(out), nullptr, nullptr}};
  return launch_quant_gemm<false>(x, nullptr, nullptr, p, 1, rows, k, n, 0.f, stream);
}

// x: contiguous bf16 (rows, d); gamma/beta: f32 (d,); w1: int8 (f, d); w1s,
// b1: f32 (f,); codes: int8 (rows, f); scales: f32 (rows,).  d % 256 == 0,
// d <= 1024, f % 128 == 0, 16 rows of f32 GELU outputs within shared memory
// (f <= 3072 at d = 768).
extern "C" int ucod_layernorm_fc1_gelu_w8a8(const void* x, const void* gamma, const void* beta,
                                            const void* w1, const void* w1s, const void* b1,
                                            void* codes, void* scales, int rows, int d, int f,
                                            float eps, void* stream) {
  if (const int bad = check_mlp(rows, d, f)) return bad;
  const int smem = mlp_smem(d, f);
  const cudaError_t err =
      cudaFuncSetAttribute(ln_fc1_gelu_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_fc1_gelu_quant_kernel<<<(rows + kRows - 1) / kRows, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const int8_t*>(w1), static_cast<const float*>(w1s),
      static_cast<const float*>(b1), static_cast<int8_t*>(codes), static_cast<float*>(scales), rows, d,
      f, eps);
  return static_cast<int>(cudaGetLastError());
}

// As ucod_layernorm_fc1_gelu_w8a8, then w2: int8 (d, f); w2s, b2: f32 (d,);
// out: bf16 (rows, d).
extern "C" int ucod_layernorm_mlp_w8a8(const void* x, const void* gamma, const void* beta,
                                       const void* w1, const void* w1s, const void* b1,
                                       const void* w2, const void* w2s, const void* b2, void* out,
                                       int rows, int d, int f, float eps, void* stream) {
  if (const int bad = check_mlp(rows, d, f)) return bad;
  const int smem = mlp_smem(d, f);
  const cudaError_t err =
      cudaFuncSetAttribute(ln_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_mlp_kernel<<<(rows + kRows - 1) / kRows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const int8_t*>(w1), static_cast<const float*>(w1s),
      static_cast<const float*>(b1), static_cast<const int8_t*>(w2), static_cast<const float*>(w2s),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), rows, d, f, eps);
  return static_cast<int>(cudaGetLastError());
}
