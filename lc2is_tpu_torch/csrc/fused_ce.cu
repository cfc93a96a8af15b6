// fused_ce: softmax cross-entropy of the bilinear ×r upsample of a low-res
// score map, and its gradient with respect to the LOW-res map, in one pass
// that never materialises the (B, K, rH, rW) upsampled map:
//
//   loss = Σ_valid nll(up_r(score)[b, :, y, x], label[b, y, x]) / max(#valid, 1)
//
// Replaces both TPU kernels of lc2is_tpu/ops/fused_ce.py: _fwd_kernel (:89,
// the Σ nll and Σ valid) and _bwd_kernel (:117, d loss / d low-res map).  The
// backward there only differs from the forward by its output; here one pass
// emits Σ nll, Σ valid and the unscaled gradient G = Σ w·(softmax − onehot),
// and the wrapper's backward scales G by g / max(#valid, 1).
//
// What bounds it on the card: the exponentials and the tap loads.  Each
// hi-res pixel costs K exps and 4·K loads of its 2 x 2 low-res taps (L1 and
// L2 hits: neighbouring pixels share taps); the map itself is small (8 x 151
// x 128² bf16 is 40 MB).
//
// Design: gather form, no atomics.  A warp owns one low-res pixel (b, i, j)
// with the K classes over its lanes (K <= 256, the score map channels-last),
// and walks every hi-res pixel whose bilinear taps reach (i, j): about
// 2r x 2r of them (the ±1 halo of the TPU kernel's row blocks).  For each it
// recomputes the K upsampled logits in f32 from the 4 taps (torch
// half-pixel centres, clamped edges: a clamped tap folds onto the edge row or
// column, as it does in the forward), their log-sum-exp, and adds
// w_y·w_x·(softmax − onehot(clip(label)))·valid to its lanes' accumulators.
// Each hi-res pixel is recomputed by the ≤ 4 low-res pixels its taps reach;
// its nll and validity count once, at the low-res pixel (y / r, x / r) under
// it, whose taps always reach it.  Per-block partial sums go to a buffer that
// a second small kernel reduces in a fixed order.
#include <math_constants.h>

#include "common.cuh"

namespace lc2 {
namespace {

constexpr int kMaxKU = 8;  // classes per lane: K <= 256

// bilinear taps of output coordinate o along an axis of n inputs, factor r
__device__ __forceinline__ void taps(int o, int n, float inv_r, int& a, int& b, float& f) {
  const float src = (o + 0.5f) * inv_r - 0.5f;
  const int i0 = (int)floorf(src);
  f = src - i0;
  a = min(max(i0, 0), n - 1);
  b = min(max(i0 + 1, 0), n - 1);
}

template <typename T>
__global__ void __launch_bounds__(256)
fused_ce_kernel(const T* __restrict__ score, const int* __restrict__ labels,
                float* __restrict__ grad, float* __restrict__ part, int B, int h, int w, int K,
                int r, int has_ignore, int ignore_index) {
  __shared__ float red[2][8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long pix = blockIdx.x * 8LL + warp;
  float nll_sum = 0.0f, n_valid = 0.0f;
  if (pix < (long long)B * h * w) {  // warp-uniform
    const int j = (int)(pix % w), i = (int)(pix / w % h), b = (int)(pix / ((long long)w * h));
    const int rh = r * h, rw = r * w;
    const float inv_r = 1.0f / r;
    const T* sb = score + (long long)b * h * w * K;
    const int* lb = labels + (long long)b * rh * rw;
    float acc[kMaxKU];
#pragma unroll
    for (int u = 0; u < kMaxKU; ++u) acc[u] = 0.0f;
    // hi-res rows / columns whose taps can reach i / j (a superset; zero weights skip)
    const int y_lo = max(0, r * i - r / 2 - 1), y_hi = min(rh, r * i + (3 * r) / 2 + 1);
    const int x_lo = max(0, r * j - r / 2 - 1), x_hi = min(rw, r * j + (3 * r) / 2 + 1);
    for (int y = y_lo; y < y_hi; ++y) {
      int ya, yb;
      float fy;
      taps(y, h, inv_r, ya, yb, fy);
      const float wy = (ya == i ? 1.0f - fy : 0.0f) + (yb == i ? fy : 0.0f);
      if (wy == 0.0f) continue;
      for (int x = x_lo; x < x_hi; ++x) {
        int xa, xb;
        float fx;
        taps(x, w, inv_r, xa, xb, fx);
        const float wx = (xa == j ? 1.0f - fx : 0.0f) + (xb == j ? fx : 0.0f);
        if (wx == 0.0f) continue;
        const int lab = lb[(long long)y * rw + x];
        if (has_ignore && lab == ignore_index) continue;
        const int lc = min(max(lab, 0), K - 1);
        const T* s00 = sb + ((long long)ya * w + xa) * K;
        const T* s01 = sb + ((long long)ya * w + xb) * K;
        const T* s10 = sb + ((long long)yb * w + xa) * K;
        const T* s11 = sb + ((long long)yb * w + xb) * K;
        float v[kMaxKU];
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int u = 0; u < kMaxKU; ++u) {
          const int k = lane + 32 * u;
          v[u] = -CUDART_INF_F;
          if (k < K) {
            const float top = (1.0f - fx) * to_f(s00[k]) + fx * to_f(s01[k]);
            const float bot = (1.0f - fx) * to_f(s10[k]) + fx * to_f(s11[k]);
            v[u] = (1.0f - fy) * top + fy * bot;
            mx = fmaxf(mx, v[u]);
          }
        }
        mx = warp_max(mx);
        float e[kMaxKU], se = 0.0f;
#pragma unroll
        for (int u = 0; u < kMaxKU; ++u) {
          e[u] = __expf(v[u] - mx);  // 0 past K
          se += e[u];
        }
        se = warp_sum(se);
        const float inv = 1.0f / se, wgt = wy * wx;
#pragma unroll
        for (int u = 0; u < kMaxKU; ++u)
          acc[u] += wgt * (e[u] * inv - (lane + 32 * u == lc ? 1.0f : 0.0f));
        if (y / r == i && x / r == j) {  // this low-res pixel owns the hi-res pixel's loss
          float mine = v[0];
#pragma unroll
          for (int u = 1; u < kMaxKU; ++u)
            if (u == (lc >> 5)) mine = v[u];
          const float picked = __shfl_sync(0xffffffffu, mine, lc & 31);
          nll_sum += mx + __logf(se) - picked;
          n_valid += 1.0f;
        }
      }
    }
    float* gr = grad + pix * K;
#pragma unroll
    for (int u = 0; u < kMaxKU; ++u)
      if (lane + 32 * u < K) gr[lane + 32 * u] = acc[u];
  }
  if (lane == 0) {
    red[0][warp] = nll_sum;
    red[1][warp] = n_valid;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.0f, c = 0.0f;
    for (int q = 0; q < 8; ++q) {
      a += red[0][q];
      c += red[1][q];
    }
    part[2 * blockIdx.x] = a;
    part[2 * blockIdx.x + 1] = c;
  }
}

// out[0] = Σ nll, out[1] = Σ valid over the per-block partials, in a fixed
// order (one block; doubles: up to 2M pixels a step)
__global__ void __launch_bounds__(256) ce_reduce_kernel(const float* __restrict__ part, int n,
                                                        float* __restrict__ out) {
  __shared__ double red[2][256];
  double a = 0.0, c = 0.0;
  for (int q = threadIdx.x; q < n; q += 256) {
    a += part[2 * q];
    c += part[2 * q + 1];
  }
  red[0][threadIdx.x] = a;
  red[1][threadIdx.x] = c;
  __syncthreads();
  for (int s = 128; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      red[0][threadIdx.x] += red[0][threadIdx.x + s];
      red[1][threadIdx.x] += red[1][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = (float)red[0][0];
    out[1] = (float)red[1][0];
  }
}

template <typename T>
cudaError_t launch(const void* score, const int* labels, float* grad, float* part, float* out,
                   int B, int h, int w, int K, int r, int has_ignore, int ignore_index,
                   cudaStream_t s) {
  const int blocks = (int)(((long long)B * h * w + 7) / 8);
  fused_ce_kernel<T><<<blocks, 256, 0, s>>>(static_cast<const T*>(score), labels, grad, part, B,
                                            h, w, K, r, has_ignore, ignore_index);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_reduce_kernel<<<1, 256, 0, s>>>(part, blocks, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lc2

// Partial-sum floats the kernel needs (the wrapper allocates them).
extern "C" long long lc2_fused_ce_partials(int B, int h, int w) {
  return 2 * (((long long)B * h * w + 7) / 8);
}

// score (B, h, w, K) channels-last of the dtype; labels (B, r·h, r·w) int32;
// grad (B, h, w, K) f32: Σ over hi-res pixels of tap weight · (softmax −
// onehot), unscaled; part: lc2_fused_ce_partials floats; out[2] f32 = (Σ nll,
// Σ valid).  Labels are clipped to [0, K); with has_ignore, pixels labelled
// ignore_index are left out.  K <= 256, r >= 1.
extern "C" int lc2_fused_ce(int dtype, const void* score, const void* labels, void* grad,
                            void* part, void* out, int B, int h, int w, int K, int r,
                            int has_ignore, int ignore_index, void* stream) {
  if (K < 1 || K > 32 * lc2::kMaxKU || r < 1 || h < 1 || w < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* g = static_cast<float*>(grad);
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  if (dtype == lc2::kF32)
    return lc2::launch<float>(score, lab, g, p, o, B, h, w, K, r, has_ignore, ignore_index, s);
  if (dtype == lc2::kBF16)
    return lc2::launch<__nv_bfloat16>(score, lab, g, p, o, B, h, w, K, r, has_ignore,
                                      ignore_index, s);
  return cudaErrorInvalidValue;
}
