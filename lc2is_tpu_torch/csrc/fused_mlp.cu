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
// operations-per-byte line at C >= 96.  Both bodies take the same three or
// four launches, the two products on the tensor cores: [pre: h = LN(x)
// rounded to T (layer_norm.cuh)]; u = act(h · W1ᵀ + b1) rounded to T, with
// the activation (and upre) in the GEMM's epilogue; then pre: out = u ·
// W2ᵀ + b2 [+ x] rounded to T in the second GEMM's epilogue, post: s = u ·
// W2ᵀ + b2 [+ x] in f32 and out = LN(s) rounded to T.  Unlike the TPU
// kernel, which keeps the hidden activation in VMEM, u makes a round trip
// through device memory (T·F elements each way, a few percent of the
// products' time at these shapes); the workspace (allocated by the
// wrapper) holds u and h or s.
// - bf16: the mma.sync GEMM of gemm_bf16.cuh (128 x 128 tiles, 3-stage
//   cp.async ring, ldmatrix); workspace lc2_fused_mlp_workspace_bf16.  b1
//   and b2 arrive as f32 holding bf16 values: the TPU kernel adds the bf16
//   biases in f32.
// - f32: the 3xTF32 GEMM of gemm_f32x3.cuh (each product three TF32
//   mma.sync products, f32-accurate; 64 x 64 tiles where 128 x 128 ones
//   would not fill the card, as at the prompt decoders' 2,416 rows);
//   workspace lc2_fused_mlp_workspace_f32.
#include "activation.cuh"
#include "common.cuh"
#include "gemm_bf16.cuh"
#include "gemm_f32x3.cuh"
#include "layer_norm.cuh"

namespace lc2 {
namespace {

using bf16 = __nv_bfloat16;

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

// The f32 body.  ws: u (n_tok, F), then h (pre) or s (post), (n_tok, C),
// all f32.
cudaError_t fused_mlp_f32(const float* x, const float* lnw, const float* lnb, const float* w1,
                          const float* b1, const float* w2, const float* b2, float* out,
                          float* upre, float* ws, int n_tok, int C, int F, int act, int pre,
                          int residual, float eps, cudaStream_t st) {
  using gemm32::Epilogue;
  float* u = ws;
  float* rest = u + (long long)n_tok * F;
  const float* h = x;
  if (pre) {
    LC2_TRY(ln::layer_norm(x, lnw, lnb, rest, n_tok, C, eps, st));
    h = rest;
  }
  Epilogue up{b1, nullptr, u, F};
  up.act = act;
  up.out_pre = upre;
  LC2_TRY((gemm32::gemm<true, true>(n_tok, F, C, h, C, w1, C, up, st)));
  const float* add = residual ? x : nullptr;
  if (pre)
    return gemm32::gemm<false, true>(n_tok, C, F, u, F, w2, F, Epilogue{b2, add, out, C}, st);
  LC2_TRY((gemm32::gemm<false, true>(n_tok, C, F, u, F, w2, F, Epilogue{b2, add, rest, C}, st)));
  return ln::layer_norm(rest, lnw, lnb, out, n_tok, C, eps, st);
}

}  // namespace
}  // namespace lc2

// x, lnw, lnb, w1 (F, C), w2 (C, F), out, upre of the dtype; b1 (F,), b2
// (C,) f32 (holding bf16 values in bf16: the TPU kernel adds the bias of
// its dtype in f32); upre (n_tok, F) or null.  ws: lc2_fused_mlp_workspace_bf16
// (bf16) or lc2_fused_mlp_workspace_f32 (f32) floats.  Every operand 16-byte
// aligned and contiguous.  C in {96, 128, 192, 256, 384, 512, 768, 1024};
// F % 8 == 0.  act: 0 relu, 1 erf-gelu, 2 polynomial gelu.
extern "C" int lc2_fused_mlp(int dtype, const void* x, const void* lnw, const void* lnb,
                             const void* w1, const void* b1, const void* w2,
                             const void* b2, void* out, void* upre, void* ws, int n_tok, int C,
                             int F, int act, int pre, int residual, float eps, void* stream) {
  if (n_tok < 1 || F < 8 || F % 8 || act < 0 || act > 2 || ws == nullptr)
    return cudaErrorInvalidValue;
  if (C < 96 || C > 1024 || C % 32) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (dtype == lc2::kBF16) {
    using bf = __nv_bfloat16;
    auto t = [](const void* p) { return static_cast<const bf*>(p); };
    return lc2::fused_mlp_bf16(t(x), t(lnw), t(lnb), t(w1), f(b1), t(w2), f(b2),
                               static_cast<bf*>(out), static_cast<bf*>(upre), ws, n_tok, C, F,
                               act, pre, residual, eps, s);
  }
  if (dtype != lc2::kF32) return cudaErrorInvalidValue;
  return lc2::fused_mlp_f32(f(x), f(lnw), f(lnb), f(w1), f(b1), f(w2), f(b2),
                            static_cast<float*>(out), static_cast<float*>(upre),
                            static_cast<float*>(ws), n_tok, C, F, act, pre, residual, eps, s);
}

// Workspace floats of the bf16 body: u (n_tok, F) bf16, then h (n_tok, C)
// bf16 for pre or s (n_tok, C) f32 for post.
extern "C" long long lc2_fused_mlp_workspace_bf16(int n_tok, int C, int F, int pre) {
  const long long u = (long long)n_tok * F, r = (long long)n_tok * C;
  return (u + 1) / 2 + (pre ? (r + 1) / 2 : r);
}

// Workspace floats of the f32 body: u (n_tok, F), then h (pre) or s (post)
// (n_tok, C).
extern "C" long long lc2_fused_mlp_workspace_f32(int n_tok, int C, int F, int pre) {
  return (long long)n_tok * (F + C);
}
