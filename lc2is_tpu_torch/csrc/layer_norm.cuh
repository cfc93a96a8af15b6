// LayerNorm over rows of C, one warp a row, for the bodies that run on the
// GEMMs of gemm_bf16.cuh and gemm_f32x3.cuh: the post-norm of the decoder
// attention block (csrc/attention_block.cu) and the pre- and post-norm of
// the feed-forward (csrc/fused_mlp.cu).  Statistics in f32, two passes over
// the row held in registers, as post_ln_bwd_bf16 (csrc/attention_block_bwd.cu)
// recomputes them: mean, then the mean of squared deviations, rstd =
// rsqrt(var + eps); out = (v − mean) · rstd · w + b with w, b widened to f32,
// rounded to the output's type (bf16 or f32): bf16 weights (rows 1 and 2 in
// bf16) or f32 ones (their f32 bodies; the int8 feed-forward's post-norm,
// csrc/fused_mlp_q.cu, whose LN weights stay f32 in both dtypes).
// Bytes-bound: each row is read once and written once.
#pragma once

#include "common.cuh"

namespace lc2 {
namespace ln {

// Rows of `in` (f32 or bf16; lane l holds columns l + 32i) into `out` (bf16
// or f32), weights TW (bf16 or f32); 8 rows a 256-thread block, blocks
// striding over the rows.
template <int CPL, typename TI, typename TW, typename TO>
__global__ void __launch_bounds__(256)
layer_norm_rows(const TI* __restrict__ in, const TW* __restrict__ w, const TW* __restrict__ b,
                TO* __restrict__ out, long long rows, float eps) {
  constexpr int C = 32 * CPL;
  const int lane = threadIdx.x & 31;
  float wv[CPL], bv[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    wv[i] = to_f(w[lane + 32 * i]);
    bv[i] = to_f(b[lane + 32 * i]);
  }
  for (long long m = blockIdx.x * 8LL + (threadIdx.x >> 5); m < rows; m += gridDim.x * 8LL) {
    const TI* r = in + m * C;
    float v[CPL];
    float a = 0.0f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      v[i] = to_f(r[lane + 32 * i]);
      a += v[i];
    }
    const float mu = warp_sum(a) / C;
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) q += (v[i] - mu) * (v[i] - mu);
    const float rs = rsqrtf(warp_sum(q) / C + eps);
#pragma unroll
    for (int i = 0; i < CPL; ++i)
      out[m * C + lane + 32 * i] = from_f<TO>((v[i] - mu) * rs * wv[i] + bv[i]);
  }
}

template <int CPL, typename TI, typename TW, typename TO>
inline cudaError_t launch_rows(const TI* in, const TW* w, const TW* b, TO* out, long long rows,
                               float eps, cudaStream_t s) {
  const long long want = (rows + 7) / 8;
  const int blocks = (int)(want < 132LL * 16 ? (want > 0 ? want : 1) : 132LL * 16);
  layer_norm_rows<CPL, TI, TW, TO><<<blocks, 256, 0, s>>>(in, w, b, out, rows, eps);
  return cudaGetLastError();
}

// out = LN(in) rounded to TO over rows of C, C in {64, 96, 128, 192, 256,
// 384, 512, 768, 1024}.
template <typename TI, typename TW, typename TO>
inline cudaError_t layer_norm(const TI* in, const TW* w, const TW* b, TO* out, long long rows,
                              int C, float eps, cudaStream_t s) {
  switch (C) {
    case 64: return launch_rows<2>(in, w, b, out, rows, eps, s);
    case 96: return launch_rows<3>(in, w, b, out, rows, eps, s);
    case 128: return launch_rows<4>(in, w, b, out, rows, eps, s);
    case 192: return launch_rows<6>(in, w, b, out, rows, eps, s);
    case 256: return launch_rows<8>(in, w, b, out, rows, eps, s);
    case 384: return launch_rows<12>(in, w, b, out, rows, eps, s);
    case 512: return launch_rows<16>(in, w, b, out, rows, eps, s);
    case 768: return launch_rows<24>(in, w, b, out, rows, eps, s);
    case 1024: return launch_rows<32>(in, w, b, out, rows, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ln
}  // namespace lc2
