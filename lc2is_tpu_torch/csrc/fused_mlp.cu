// fused_mlp: the transformer feed-forward half.
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
// multiply-adds against 2·C·bytes of token traffic, far above the H100's
// operations-per-byte line at C >= 96.  Two bodies:
// - bf16: the two products on the tensor cores, on the
//   mma.sync GEMM of gemm_bf16.cuh (128 x 128 tiles, 3-stage cp.async ring,
//   ldmatrix), in three or four launches: [pre: h = round(LN(x))
//   (layer_norm.cuh)]; u = round(act(h · W1ᵀ + b1)) with the activation
//   (and upre) in the GEMM's epilogue; then pre: out = round(u · W2ᵀ + b2
//   [+ x]) in the second GEMM's epilogue, post: s = u · W2ᵀ + b2 [+ x] in
//   f32 and out = round(LN(s)).  Unlike the TPU kernel, which keeps the
//   hidden activation in VMEM, u makes a round trip through device memory
//   (2·T·F bytes each way, a few percent of the products' time at these
//   shapes); the workspace (lc2_fused_mlp_workspace_bf16, allocated by the
//   wrapper) holds u and h or s.  b1 and b2 arrive as f32 holding bf16
//   values: the TPU kernel adds the bf16 biases in f32.
// - f32 (the control): one block owns BM whole rows (LayerNorm needs the
//   full C row) and walks the hidden dimension in chunks: u = act(h ·
//   W1[chunk]ᵀ + b1) lands in shared memory (never in device memory), then
//   y += u · W2[:, chunk]ᵀ accumulates on chip, on the CUDA cores in f32
//   (tensor cores would round the operands to TF32); lane l owns columns
//   l + 32j of its warp's R rows.  BM = 32 (R = 4) up to C = 768, 96
//   accumulators a thread there, the FF input rows and a weight chunk
//   ≈ 203 KB of shared memory; BM = 16 (R = 2) at C = 1024, 64 accumulators
//   and ≈ 203 KB, since 32 rows of 1024 would not fit.  Post-LN needs whole
//   rows: a warp owns R rows and reduces their statistics with shuffles.
#include "activation.cuh"
#include "common.cuh"
#include "gemm_bf16.cuh"
#include "layer_norm.cuh"

namespace lc2 {
namespace {

constexpr int kThreads = 256;  // 8 warps

using bf16 = __nv_bfloat16;

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
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFC = 32;  // hidden chunk

template <int NJ>
struct FmaLayout {
  static constexpr int C = NJ * 32;
  static constexpr int kRows = C > 768 ? 2 : 4;  // rows per warp
  static constexpr int kBM = 8 * kRows;          // token rows per block
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
  constexpr int kRows = FmaLayout<NJ>::kRows, kBM = FmaLayout<NJ>::kBM;
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
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;
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
        us[(warp * kRows + i) * kFC + lane] = lc2::act::activate(acc[i] + bias, act);
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
cudaError_t launch_kernel(K kernel, size_t smem, int bm, const void* x, const void* lnw,
                          const void* lnb, const void* w1, const void* b1, const void* w2,
                          const void* b2, void* out, void* upre, int n_tok, int F, int act,
                          int pre, int residual, float eps, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_tok + bm - 1) / bm);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(lnw), static_cast<const T*>(lnb),
      static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), static_cast<T*>(upre), n_tok, F, act, pre,
      residual, eps);
  return cudaGetLastError();
}

// The bf16 body.  ws: u (n_tok, F) bf16, then h (n_tok, C) bf16 (pre) or s
// (n_tok, C) f32 (post).
cudaError_t fused_mlp_bf16(const bf16* x, const bf16* lnw, const bf16* lnb, const bf16* w1,
                           const float* b1, const bf16* w2, const float* b2, bf16* out,
                           bf16* upre, void* ws, int n_tok, int C, int F, int act, int pre,
                           int residual, float eps, cudaStream_t st) {
  using gemm16::Epilogue;
  bf16* u = static_cast<bf16*>(ws);
  void* rest = u + (long long)n_tok * F;
  const bf16* h = x;
  if (pre) {
    bf16* hb = static_cast<bf16*>(rest);
    LC2_TRY(ln::layer_norm(x, lnw, lnb, hb, n_tok, C, eps, st));
    h = hb;
  }
  Epilogue up{b1, nullptr, nullptr, nullptr, u, F, false};
  up.act = act;
  up.out_pre = upre;
  LC2_TRY((gemm16::gemm<false, false, true>(n_tok, F, C, h, C, w1, C, up, st)));
  const bf16* add = residual ? x : nullptr;
  if (pre)
    return gemm16::gemm<false, false>(n_tok, C, F, u, F, w2, F,
                                      Epilogue{b2, nullptr, add, nullptr, out, C, false}, st);
  float* s = static_cast<float*>(rest);
  LC2_TRY((gemm16::gemm<false, false>(n_tok, C, F, u, F, w2, F,
                                      Epilogue{b2, nullptr, add, s, nullptr, C, false}, st)));
  return ln::layer_norm(s, lnw, lnb, out, n_tok, C, eps, st);
}

}  // namespace
}  // namespace lc2

// x, lnw, lnb, w1 (F, C), w2 (C, F), out, upre of the dtype; b1 (F,), b2
// (C,) f32 (holding bf16 values in bf16: the TPU kernel adds the bias of
// its dtype in f32); upre (n_tok, F) or null.  ws: null in f32, in bf16
// lc2_fused_mlp_workspace_bf16 floats, with 16-byte aligned operands.
// C in {96, 128, 192, 256, 384, 512, 768, 1024}; F % 32 == 0.  act: 0 relu,
// 1 erf-gelu, 2 polynomial gelu.  All tensors contiguous.
extern "C" int lc2_fused_mlp(int dtype, const void* x, const void* lnw, const void* lnb,
                             const void* w1, const void* b1, const void* w2,
                             const void* b2, void* out, void* upre, void* ws, int n_tok, int C,
                             int F, int act, int pre, int residual, float eps, void* stream) {
  if (n_tok < 1 || F % lc2::kFC || act < 0 || act > 2) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lc2::kBF16) {
    if (C < 96 || C > 1024 || C % 32 || ws == nullptr) return cudaErrorInvalidValue;
    using bf = __nv_bfloat16;
    auto t = [](const void* p) { return static_cast<const bf*>(p); };
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    return lc2::fused_mlp_bf16(t(x), t(lnw), t(lnb), t(w1), f(b1), t(w2), f(b2),
                               static_cast<bf*>(out), static_cast<bf*>(upre), ws, n_tok, C, F,
                               act, pre, residual, eps, s);
  }
  if (dtype != lc2::kF32) return cudaErrorInvalidValue;
#define LC2_MLP_CASE(NJ)                                                                       \
  case NJ * 32:                                                                                \
    return lc2::launch_kernel<float>(lc2::fused_mlp_fma_kernel<NJ>, lc2::FmaLayout<NJ>::kBytes, \
                                     lc2::FmaLayout<NJ>::kBM, x, lnw, lnb, w1, b1, w2, b2, out,  \
                                     upre, n_tok, F, act, pre, residual, eps, s);
  switch (C) {
    LC2_MLP_CASE(3)
    LC2_MLP_CASE(4)
    LC2_MLP_CASE(6)
    LC2_MLP_CASE(8)
    LC2_MLP_CASE(12)
    LC2_MLP_CASE(16)
    LC2_MLP_CASE(24)
    LC2_MLP_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef LC2_MLP_CASE
}

// Workspace floats of the bf16 body: u (n_tok, F) bf16, then h (n_tok, C)
// bf16 for pre or s (n_tok, C) f32 for post.
extern "C" long long lc2_fused_mlp_workspace_bf16(int n_tok, int C, int F, int pre) {
  const long long u = (long long)n_tok * F, r = (long long)n_tok * C;
  return (u + 1) / 2 + (pre ? (r + 1) / 2 : r);
}
