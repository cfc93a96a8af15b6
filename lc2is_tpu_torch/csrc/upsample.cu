// upsample_tokens: channels-last integer-factor bilinear upsample
//   (B, H·W, C) -> (B, rH·rW, C), torch half-pixel centres, clamped edges,
// and its adjoint (upsample_tokens_adjoint, below) for the backward.
//
// Replaces the TPU kernel lc2is_tpu/ops/upsample.py::_kernel (:42, entry
// upsample_tokens :167).  Output (y, x) reads input rows y0, y0+1 and columns
// x0, x0+1 at src = (o + 0.5)/r - 0.5 (clamped), which for r = 2 is the fixed
// 0.25/0.75 phase blend of upsample.py:30-39.  Like the TPU kernel it blends
// along W first, rounds the widened rows to the element type, then blends
// along H (the bf16 two-pass rounding of lc2is_tpu/ops/resize.py:275-279).
//
// What bounds it on the card: device memory alone.  Each output element is a
// blend of four input elements with no reuse beyond L2 and no product to
// amortise, so the kernel is one coalesced pass: consecutive threads take
// consecutive channels of one output token.  Every grid shape is taken, with
// no fallback.
#include "common.cuh"

namespace lc2 {
namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W, int C, int r,
                long long total) {
  const int oh = H * r, ow = W * r;
  const float inv_r = 1.0f / r;
  for (long long idx = blockIdx.x * (long long)kThreads + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * kThreads) {
    const int c = (int)(idx % C);
    long long t = idx / C;
    const int ox = (int)(t % ow);
    t /= ow;
    const int oy = (int)(t % oh);
    const long long b = t / oh;

    const float sy = (oy + 0.5f) * inv_r - 0.5f;
    const float sx = (ox + 0.5f) * inv_r - 0.5f;
    const int y0 = (int)floorf(sy), x0 = (int)floorf(sx);
    const float fy = sy - y0, fx = sx - x0;
    const int ya = min(max(y0, 0), H - 1), yb = min(max(y0 + 1, 0), H - 1);
    const int xa = min(max(x0, 0), W - 1), xb = min(max(x0 + 1, 0), W - 1);

    const T* base = x + b * H * W * (long long)C + c;
    const float ra = round_t<T>((1.0f - fx) * to_f(base[((long long)ya * W + xa) * C]) +
                                fx * to_f(base[((long long)ya * W + xb) * C]));
    const float rb = round_t<T>((1.0f - fx) * to_f(base[((long long)yb * W + xa) * C]) +
                                fx * to_f(base[((long long)yb * W + xb) * C]));
    out[idx] = from_f<T>((1.0f - fy) * ra + fy * rb);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, int B, int H, int W, int C, int r,
                   cudaStream_t stream) {
  const long long total = (long long)B * H * r * W * r * C;
  if (total == 0) return cudaSuccess;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132LL * 64 ? want : 132LL * 64);
  upsample_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), H, W, C, r, total);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// upsample_tokens_adjoint: the backward of upsample_kernel (the op is linear,
// so its vector-Jacobian product is its adjoint).  Replaces the TPU kernel
// lc2is_tpu/ops/upsample.py::_adj_kernel (:186, launched by _adjoint_impl :232).
//
// Gather form, no atomics: the thread of input element (b, i, j, c) sums the
// output gradients whose taps reach (i, j), about 2r x 2r of them, with a
// clamped edge tap folded onto the edge row or column as in the forward.  It
// undoes the forward's two passes in reverse order and rounds where the
// forward's adjoint in the element type rounds: per output column x, the
// H-adjoint Σ_y w_y(i)·g[y][x] is rounded to T, then the W-adjoint sums
// w_x(j) times it.  Bounded by device memory like the forward: each output
// gradient element is read by ≤ 4 threads, from L1/L2.
// ---------------------------------------------------------------------------

// weight of input index i in the blend of output coordinate o (n inputs)
__device__ __forceinline__ float tap_weight(int o, int i, int n, float inv_r) {
  const float src = (o + 0.5f) * inv_r - 0.5f;
  const int i0 = (int)floorf(src);
  const float f = src - i0;
  const int a = min(max(i0, 0), n - 1), b = min(max(i0 + 1, 0), n - 1);
  return (a == i ? 1.0f - f : 0.0f) + (b == i ? f : 0.0f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample_adjoint_kernel(const T* __restrict__ g, T* __restrict__ dx, int H, int W, int C, int r,
                        long long total) {
  const int oh = H * r, ow = W * r;
  const float inv_r = 1.0f / r;
  for (long long idx = blockIdx.x * (long long)kThreads + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * kThreads) {
    const int c = (int)(idx % C);
    long long t = idx / C;
    const int j = (int)(t % W);
    t /= W;
    const int i = (int)(t % H);
    const long long b = t / H;
    const int y_lo = max(0, r * i - r / 2 - 1), y_hi = min(oh, r * i + (3 * r) / 2 + 1);
    const int x_lo = max(0, r * j - r / 2 - 1), x_hi = min(ow, r * j + (3 * r) / 2 + 1);
    const T* gb = g + b * oh * (long long)ow * C + c;
    float acc = 0.0f;
    for (int x = x_lo; x < x_hi; ++x) {
      const float wx = tap_weight(x, j, W, inv_r);
      if (wx == 0.0f) continue;
      float col = 0.0f;
      for (int y = y_lo; y < y_hi; ++y) {
        const float wy = tap_weight(y, i, H, inv_r);
        if (wy != 0.0f) col += wy * to_f(gb[((long long)y * ow + x) * C]);
      }
      acc += wx * round_t<T>(col);
    }
    dx[idx] = from_f<T>(acc);
  }
}

template <typename T>
cudaError_t launch_adjoint(const void* g, void* dx, int B, int H, int W, int C, int r,
                           cudaStream_t stream) {
  const long long total = (long long)B * H * W * C;
  if (total == 0) return cudaSuccess;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132LL * 64 ? want : 132LL * 64);
  upsample_adjoint_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<T*>(dx), H, W, C, r, total);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lc2

// g (B, rH·rW, C) contiguous (gradient of the upsample's output) -> dx
// (B, H·W, C); H, W are the INPUT grid; r >= 1.
extern "C" int lc2_upsample_adjoint(int dtype, const void* g, void* dx, int B, int H, int W,
                                    int C, int r, void* stream) {
  if (r < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lc2::kF32) return lc2::launch_adjoint<float>(g, dx, B, H, W, C, r, s);
  if (dtype == lc2::kBF16) return lc2::launch_adjoint<__nv_bfloat16>(g, dx, B, H, W, C, r, s);
  return cudaErrorInvalidValue;
}

// x (B, H·W, C) contiguous -> out (B, rH·rW, C); r >= 1.
extern "C" int lc2_upsample(int dtype, const void* x, void* out, int B, int H, int W, int C,
                            int r, void* stream) {
  if (r < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lc2::kF32) return lc2::launch<float>(x, out, B, H, W, C, r, s);
  if (dtype == lc2::kBF16) return lc2::launch<__nv_bfloat16>(x, out, B, H, W, C, r, s);
  return cudaErrorInvalidValue;
}
