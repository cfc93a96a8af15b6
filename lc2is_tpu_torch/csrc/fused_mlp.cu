// fused_mlp: the transformer feed-forward half in one pass over the tokens.
//
//   pre  (swin block):    out = [x +] W2 · act(W1 · LN(x) + b1) + b2
//   post (torch layer):   out = LN([x +] W2 · act(W1 · x + b1) + b2)
//
// With upre non-null the kernel also writes the (T, F) pre-activation
// W1 · h + b1, rounded to T, which the training backward differentiates from
// (lc2is_tpu/ops/fused_mlp.py:178-183 saves the same tensor).
//
// Replaces the TPU kernel lc2is_tpu/ops/fused_mlp.py::_kernel (:110, entry
// fused_mlp :318).
//
// What bounds it on the card: arithmetic.  Per token it does 2·C·4C
// multiply-adds against 2·C·bytes of token traffic (the 4C hidden never
// leaves the SM), far above the H100's operations-per-byte line at C >= 96.
//
// Design: one block owns BM = 32 whole rows (LayerNorm needs the full C row:
// C <= 768).  The block keeps the FF input rows (LN'd for pre) in shared
// memory and walks the hidden dimension in chunks: u = act(h · W1[chunk]ᵀ +
// b1) lands in shared memory (never in device memory), then y += u ·
// W2[:, chunk]ᵀ accumulates on chip.  Post-LN needs whole rows: a warp owns
// 4 rows and reduces their statistics with shuffles.  Two bodies:
// - bf16 (serving): the products on the tensor cores through WMMA
//   (16x16x16 bf16 tiles, f32 accumulators).  The 32 x C accumulator is
//   2·C/16 fragments spread over the 8 warps (96 registers a thread at
//   C = 768); W1/W2 fragments load straight from device memory (L2-resident,
//   re-read by every block).  Shared memory ≈ 112 KB at C = 768: two blocks
//   an SM.
// - f32: the products on the CUDA cores in f32 (tensor cores would round the
//   operands to TF32); lane l owns columns l + 32j of its warp's 4 rows, 96
//   accumulators a thread at C = 768; the FF input rows and a weight chunk
//   take ≈ 203 KB of shared memory.
#include <mma.h>

#include "common.cuh"

namespace lc2 {
namespace {

constexpr int kBM = 32;        // token rows per block
constexpr int kThreads = 256;  // 8 warps x 4 rows
constexpr int kRows = 4;       // rows per warp

enum Act { kRelu = 0, kGeluErf = 1, kGeluPoly = 2 };

__device__ __forceinline__ float gelu_poly(float x) {
  // division-free polynomial gelu of lc2is_tpu/ops/fused_mlp.py:62-86, the
  // bf16 policy there (max abs error 4.1e-4 against erf-gelu)
  float t = fminf(fmaxf(x, -4.0f), 4.0f);
  float u = t * t;
  float p = -1.5484756e-09f;
  p = p * u + 1.1899754e-07f;
  p = p * u + -4.014895e-06f;
  p = p * u + 7.932062e-05f;
  p = p * u + -0.001037015f;
  p = p * u + 0.00961666f;
  p = p * u + -0.066079915f;
  p = p * u + 0.3987861f;
  float y = 0.5f * t + u * p;
  return x > 4.0f ? x : y;
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kRelu) return fmaxf(v, 0.0f);
  if (act == kGeluErf) return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
  return gelu_poly(v);
}

// Row g of the FF input in the lane's columns lane + 32j: LN(x) rounded to T
// (pre) or x (post); zeros past the last token.  Called by a whole warp.
template <typename T, int NJ>
__device__ __forceinline__ void ff_input_row(const T* __restrict__ x, const T* __restrict__ lnw,
                                             const T* __restrict__ lnb, int g, int n_tok,
                                             int pre, float eps, float (&v)[NJ]) {
  constexpr int C = NJ * 32;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NJ; ++j) v[j] = g < n_tok ? to_f(x[(size_t)g * C + lane + 32 * j]) : 0.0f;
  if (!pre) return;
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) s += v[j];
  const float mean = warp_sum(s) / C;
  float q = 0.0f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) q += (v[j] - mean) * (v[j] - mean);
  const float rstd = rsqrtf(warp_sum(q) / C + eps);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = lane + 32 * j;
    v[j] = round_t<T>((v[j] - mean) * rstd * to_f(lnw[c]) + to_f(lnb[c]));
  }
}

// out[g] = y + b2 [+ x], then LayerNorm for post; y in the lane's columns.
// Called by a whole warp, g < n_tok.
template <typename T, int NJ>
__device__ __forceinline__ void store_row(const T* __restrict__ x, const T* __restrict__ lnw,
                                          const T* __restrict__ lnb, const T* __restrict__ b2,
                                          T* __restrict__ out, int g, int pre, int residual,
                                          float eps, float (&s)[NJ]) {
  constexpr int C = NJ * 32;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = lane + 32 * j;
    s[j] += to_f(b2[c]) + (residual ? to_f(x[(size_t)g * C + c]) : 0.0f);
  }
  if (!pre) {
    float a = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) a += s[j];
    const float mean = warp_sum(a) / C;
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) q += (s[j] - mean) * (s[j] - mean);
    const float rstd = rsqrtf(warp_sum(q) / C + eps);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      s[j] = (s[j] - mean) * rstd * to_f(lnw[c]) + to_f(lnb[c]);
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) out[(size_t)g * C + lane + 32 * j] = from_f<T>(s[j]);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (WMMA)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcFC = 64;          // hidden chunk: a 32 x 64 u tile, one 16x16 tile a warp
constexpr int kLdu = kTcFC + 8;    // bf16 u row stride (multiple of 8, spreads banks)
constexpr int kLds = kTcFC + 4;    // f32 pre-activation row stride

template <int C>
struct TcLayout {
  static constexpr int kLdh = C + 8;                 // bf16 FF input rows
  static constexpr int kLdy = C + 4;                 // f32 output staging
  static constexpr int kTiles = 2 * (C / 16);        // 16x16 tiles of the 32 x C output
  static constexpr int kPerWarp = (kTiles + 7) / 8;
  static constexpr size_t kRegion0 =                 // FF input, later the output staging
      (sizeof(float) * kBM * kLdy > sizeof(bf16) * kBM * kLdh ? sizeof(float) * kBM * kLdy
                                                              : sizeof(bf16) * kBM * kLdh);
  static constexpr size_t kOffU = (kRegion0 + 127) / 128 * 128;
  static constexpr size_t kOffS = kOffU + (sizeof(bf16) * kBM * kLdu + 127) / 128 * 128;
  static constexpr size_t kBytes = kOffS + sizeof(float) * kBM * kLds;
};

template <int C>
__global__ void __launch_bounds__(kThreads)
fused_mlp_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ lnw,
                    const bf16* __restrict__ lnb, const bf16* __restrict__ w1,
                    const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                    const bf16* __restrict__ b2, bf16* __restrict__ out,
                    bf16* __restrict__ upre, int n_tok, int F, int act, int pre, int residual,
                    float eps) {
  using namespace nvcuda;
  using L = TcLayout<C>;
  constexpr int NJ = C / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* hs = reinterpret_cast<bf16*>(smem_raw);             // [kBM][kLdh]
  float* ys = reinterpret_cast<float*>(smem_raw);           // [kBM][kLdy], after the loop
  bf16* ub = reinterpret_cast<bf16*>(smem_raw + L::kOffU);  // [kBM][kLdu]
  float* us = reinterpret_cast<float*>(smem_raw + L::kOffS);  // [kBM][kLds]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kBM;

  for (int i = 0; i < kRows; ++i) {
    const int r = warp * kRows + i;
    float v[NJ];
    ff_input_row<bf16, NJ>(x, lnw, lnb, row0 + r, n_tok, pre, eps, v);
#pragma unroll
    for (int j = 0; j < NJ; ++j) hs[r * L::kLdh + lane + 32 * j] = __float2bfloat16(v[j]);
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> yacc[L::kPerWarp];
#pragma unroll
  for (int i = 0; i < L::kPerWarp; ++i) wmma::fill_fragment(yacc[i], 0.0f);

  for (int f0 = 0; f0 < F; f0 += kTcFC) {
    __syncthreads();  // FF input written / previous chunk's u consumed
    {  // pre-activation tile (warp / 4, warp % 4) of the 32 x 64 chunk
      const int rt = warp >> 2, ct = warp & 3;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> ua;
      wmma::fill_fragment(ua, 0.0f);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      const bf16* wcol = w1 + (size_t)(f0 + ct * 16) * C;  // B[k][n] = W1[f0 + 16ct + n][k]
      for (int k = 0; k < C; k += 16) {
        wmma::load_matrix_sync(a, hs + rt * 16 * L::kLdh + k, L::kLdh);
        wmma::load_matrix_sync(b, wcol + k, C);
        wmma::mma_sync(ua, a, b, ua);
      }
      wmma::store_matrix_sync(us + rt * 16 * kLds + ct * 16, ua, kLds, wmma::mem_row_major);
    }
    __syncthreads();
    for (int idx = tid; idx < kBM * kTcFC; idx += kThreads) {
      const int r = idx / kTcFC, f = idx - r * kTcFC;
      const float pa = us[r * kLds + f] + __bfloat162float(b1[f0 + f]);
      ub[r * kLdu + f] = __float2bfloat16(activate(pa, act));
      if (upre && row0 + r < n_tok) upre[(size_t)(row0 + r) * F + f0 + f] = __float2bfloat16(pa);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < L::kPerWarp; ++i) {
      const int t = warp + 8 * i;
      if (t < L::kTiles) {  // warp-uniform
        const int rt = t / (C / 16), ct = t - rt * (C / 16);
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
#pragma unroll
        for (int kk = 0; kk < kTcFC; kk += 16) {
          wmma::load_matrix_sync(a, ub + rt * 16 * kLdu + kk, kLdu);
          // B[k][n] = W2[16ct + n][f0 + kk + k]
          wmma::load_matrix_sync(b, w2 + (size_t)(ct * 16) * F + f0 + kk, F);
          wmma::mma_sync(yacc[i], a, b, yacc[i]);
        }
      }
    }
  }

  __syncthreads();  // every warp done with the FF input: its region becomes ys
#pragma unroll
  for (int i = 0; i < L::kPerWarp; ++i) {
    const int t = warp + 8 * i;
    if (t < L::kTiles) {
      const int rt = t / (C / 16), ct = t - rt * (C / 16);
      wmma::store_matrix_sync(ys + rt * 16 * L::kLdy + ct * 16, yacc[i], L::kLdy,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = 0; i < kRows; ++i) {
    const int r = warp * kRows + i;
    if (row0 + r >= n_tok) break;  // warp-uniform
    float s[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] = ys[r * L::kLdy + lane + 32 * j];
    store_row<bf16, NJ>(x, lnw, lnb, b2, out, row0 + r, pre, residual, eps, s);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFC = 32;  // hidden chunk

template <int NJ>
struct FmaLayout {
  static constexpr int C = NJ * 32;
  static constexpr int kWb = (kFC * (C + 1) > C * (kFC + 1)) ? kFC * (C + 1) : C * (kFC + 1);
  static constexpr size_t kBytes = sizeof(float) * (kBM * C + kWb + kBM * kFC);
};

template <int NJ>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_fma_kernel(const float* __restrict__ x, const float* __restrict__ lnw,
                     const float* __restrict__ lnb, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ out,
                     float* __restrict__ upre, int n_tok, int F, int act, int pre, int residual,
                     float eps) {
  constexpr int C = NJ * 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* hs = reinterpret_cast<float*>(smem_raw);  // [kBM][C]: FF input rows
  float* wb = hs + kBM * C;                          // weight chunk
  float* us = wb + FmaLayout<NJ>::kWb;               // [kBM][kFC]: activated hidden chunk

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kBM;

  for (int i = 0; i < kRows; ++i) {
    const int r = warp * kRows + i;
    float v[NJ];
    ff_input_row<float, NJ>(x, lnw, lnb, row0 + r, n_tok, pre, eps, v);
#pragma unroll
    for (int j = 0; j < NJ; ++j) hs[r * C + lane + 32 * j] = v[j];
  }

  float y[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) y[i][j] = 0.0f;

  for (int f0 = 0; f0 < F; f0 += kFC) {
    __syncthreads();  // hs written / previous chunk's wb and us consumed
    for (int idx = tid; idx < kFC * C; idx += kThreads) {
      const int f = idx / C, k = idx - f * C;
      wb[f * (C + 1) + k] = w1[(size_t)(f0 + f) * C + k];
    }
    __syncthreads();
    {  // u[r][lane] = act(h[r] · W1[f0 + lane] + b1)
      float acc[kRows] = {0.0f, 0.0f, 0.0f, 0.0f};
      const float* wr = wb + lane * (C + 1);
      for (int k = 0; k < C; k += 4) {
        const float w0 = wr[k], w1_ = wr[k + 1], w2_ = wr[k + 2], w3 = wr[k + 3];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float4 h = *reinterpret_cast<const float4*>(hs + (warp * kRows + i) * C + k);
          acc[i] += h.x * w0 + h.y * w1_ + h.z * w2_ + h.w * w3;
        }
      }
      const float bias = b1[f0 + lane];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int g = row0 + warp * kRows + i;
        us[(warp * kRows + i) * kFC + lane] = activate(acc[i] + bias, act);
        if (upre && g < n_tok) upre[(size_t)g * F + f0 + lane] = acc[i] + bias;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < C * kFC; idx += kThreads) {
      const int c = idx / kFC, f = idx - c * kFC;
      wb[c * (kFC + 1) + f] = w2[(size_t)c * F + f0 + f];
    }
    __syncthreads();
    for (int f = 0; f < kFC; ++f) {
      float u[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) u[i] = us[(warp * kRows + i) * kFC + f];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float w = wb[(lane + 32 * j) * (kFC + 1) + f];
#pragma unroll
        for (int i = 0; i < kRows; ++i) y[i][j] += u[i] * w;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {  // unrolled: y stays in registers
    const int g = row0 + warp * kRows + i;
    if (g >= n_tok) continue;  // warp-uniform
    store_row<float, NJ>(x, lnw, lnb, b2, out, g, pre, residual, eps, y[i]);
  }
}

template <typename T, typename K>
cudaError_t launch_kernel(K kernel, size_t smem, const void* x, const void* lnw,
                          const void* lnb, const void* w1, const void* b1, const void* w2,
                          const void* b2, void* out, void* upre, int n_tok, int F, int act,
                          int pre, int residual, float eps, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_tok + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(lnw), static_cast<const T*>(lnb),
      static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), static_cast<T*>(upre), n_tok, F, act, pre,
      residual, eps);
  return cudaGetLastError();
}

template <int NJ>
cudaError_t launch_c(int dtype, const void* x, const void* lnw, const void* lnb,
                     const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                     void* upre, int n_tok, int F, int act, int pre, int residual, float eps,
                     cudaStream_t stream) {
  if (dtype == kBF16)
    return launch_kernel<bf16>(fused_mlp_tc_kernel<NJ * 32>, TcLayout<NJ * 32>::kBytes, x,
                               lnw, lnb, w1, b1, w2, b2, out, upre, n_tok, F, act, pre,
                               residual, eps, stream);
  if (dtype == kF32)
    return launch_kernel<float>(fused_mlp_fma_kernel<NJ>, FmaLayout<NJ>::kBytes, x, lnw, lnb,
                                w1, b1, w2, b2, out, upre, n_tok, F, act, pre, residual, eps,
                                stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace lc2

// C in {96, 128, 192, 256, 384, 512, 768}; F % 64 == 0.  act: 0 relu,
// 1 erf-gelu, 2 polynomial gelu.  All tensors contiguous, one dtype; upre
// (n_tok, F) or null.
extern "C" int lc2_fused_mlp(int dtype, const void* x, const void* lnw, const void* lnb,
                             const void* w1, const void* b1, const void* w2,
                             const void* b2, void* out, void* upre, int n_tok, int C, int F,
                             int act, int pre, int residual, float eps, void* stream) {
  if (F % lc2::kTcFC != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LC2_MLP_CASE(NJ)                                                                 \
  case NJ * 32:                                                                          \
    return lc2::launch_c<NJ>(dtype, x, lnw, lnb, w1, b1, w2, b2, out, upre, n_tok, F, act, \
                             pre, residual, eps, s);
  switch (C) {
    LC2_MLP_CASE(3)
    LC2_MLP_CASE(4)
    LC2_MLP_CASE(6)
    LC2_MLP_CASE(8)
    LC2_MLP_CASE(12)
    LC2_MLP_CASE(16)
    LC2_MLP_CASE(24)
    default:
      return cudaErrorInvalidValue;
  }
#undef LC2_MLP_CASE
}
