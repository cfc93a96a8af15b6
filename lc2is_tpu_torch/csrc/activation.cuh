// The feed-forward activations of csrc/fused_mlp.cu, applied in the
// epilogues of the GEMMs its two bodies run (gemm_bf16.cuh, gemm_f32x3.cuh).
#pragma once

#include <math.h>

namespace lc2 {
namespace act {

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

}  // namespace act
}  // namespace lc2
