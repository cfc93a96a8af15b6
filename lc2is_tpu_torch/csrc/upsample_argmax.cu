// The served mask head: per output pixel, the argmax over K classes of a
// torch-bilinear ×r upsample of a class-score map, without ever writing the
// (B, K, r·h, r·w) upsampled map.  Two entry points share one kernel:
//
//   lc2_score_upsample_argmax: the scores are computed in the kernel, from
//     the decoder tokens v (B, h·w, C), L2-normalised per token in T, and the
//     normalised class embeddings t (B, K, C): s = round_T(v̂ · t), summed in
//     f32.  Replaces lc2is_tpu/ops/upsample_argmax.py::_score_kernel (:117,
//     entry score_upsample_argmax :197).
//   lc2_upsample_argmax: the scores are read from a (B, K, h, w) map in T.
//     Replaces lc2is_tpu/ops/upsample_argmax.py::_kernel (:33, entry
//     upsample_argmax :72).
//
// The upsample is the TPU kernels' arithmetic, bit for bit: H blend first,
// then W blend, each w_other·other + w_cur·cur in f32 with the phase weights
// of lc2is_tpu/ops/upsample.py:30-39 (explicit _rn intrinsics, so no fused
// multiply-add changes a rounding); edge rows and columns clamp; ties go to
// the lowest class.  K needs no padding here (the TPU's k_pad and NEG rows
// are layout scaffolding).
//
// What bounds it on the card: at the served shape (16, 128², 512) tokens,
// 151 classes, the bytes (268 MB of tokens read once, 16.8 MB of masks
// written): 0.086 ms at 3.35 TB/s, against 0.041 ms for the 40.5 GFLOP
// score product at the bf16 tensor-core rate.  This first version runs the
// product on the CUDA cores in f32, so it is bound by that product.
//
// Design: one block per 8 x 16 tile of low-res pixels (r·8 x r·16 output
// pixels).  The block needs the scores of the tile and a one-pixel halo,
// 10 x 18 = 180 tokens, which it keeps in shared memory as [K][180] f32
// (109 KB at K = 151); the halo costs 1.4x the product of the tile itself.
//   1. scores: a warp per token takes its f32 norm; then a 192 x 160 tile
//      product over 32-channel chunks, each thread 12 tokens x 10 classes
//      in registers, the tokens normalised (and rounded to T) as they are
//      staged; K > 160 takes more passes.  The map entry point copies the
//      180 x K scores instead.
//   2. argmax: a thread per output pixel walks the K classes, blending its
//      two rows and two columns of the tile's scores.
#include "common.cuh"

namespace lc2 {
namespace {

constexpr int kTH = 8, kTW = 16;       // low-res pixels of a tile
constexpr int kHW = kTW + 2;           // halo columns
constexpr int kNT = (kTH + 2) * kHW;   // halo tokens (180)
constexpr int kThreads = 256;
constexpr int kNI = 12;                // tokens per thread: 16 x 12 = 192 >= kNT
constexpr int kNJ = 10;                // classes per thread and pass: 16 x 10 = 160
constexpr int kKC = 16 * kNJ;
constexpr int kCT = 32;                // channel chunk of the product
constexpr int kLdv = 16 * kNI + 1;     // staged tokens [kCT][kLdv]
constexpr int kLdt = kKC + 1;          // staged classes [kCT][kLdt]

// pixel (y·W + x) of halo token n of the tile at (i0, j0), clamped to the image
__device__ __forceinline__ int halo_pixel(int n, int i0, int j0, int H, int W) {
  const int hr = n / kHW, hc = n - hr * kHW;
  const int y = min(max(i0 - 1 + hr, 0), H - 1), x = min(max(j0 - 1 + hc, 0), W - 1);
  return y * W + x;
}

struct Phase {
  int prev;   // blend with the previous (1) or the next (0) row / column
  float wo, wc;
};

// lc2is_tpu/ops/upsample.py::_phase_weights, in double then rounded, as
// Python's float weights meet an f32 array
__device__ __forceinline__ Phase phase(int m, int r) {
  const double off = (m + 0.5) / r - 0.5;
  Phase p;
  p.prev = off < 0.0;
  p.wo = static_cast<float>(p.prev ? -off : off);
  p.wc = static_cast<float>(p.prev ? 1.0 + off : 1.0 - off);
  return p;
}

__device__ __forceinline__ float blend(float wo, float other, float wc, float cur) {
  return __fadd_rn(__fmul_rn(wo, other), __fmul_rn(wc, cur));
}

template <typename T>
__device__ void tile_scores(const T* __restrict__ v, const T* __restrict__ tn, float* S,
                            int b, int i0, int j0, int H, int W, int C, int K, float eps) {
  float* vt = S + (size_t)K * kNT;  // [kCT][kLdv]
  float* tt = vt + kCT * kLdv;      // [kCT][kLdt]
  float* dn = tt + kCT * kLdt;      // [kNT] per-token divisor max(‖v‖, eps), rounded to T
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const T* vb = v + (size_t)b * H * W * C;
  const T* tb = tn + (size_t)b * K * C;

  for (int n = warp; n < kNT; n += kThreads / 32) {
    const T* row = vb + (size_t)halo_pixel(n, i0, j0, H, W) * C;
    float ss = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float x = to_f(row[c]);
      ss += x * x;
    }
    ss = warp_sum(ss);
    if (lane == 0) dn[n] = round_t<T>(fmaxf(sqrtf(ss), eps));
  }

  for (int kc0 = 0; kc0 < K; kc0 += kKC) {
    float acc[kNI][kNJ];
#pragma unroll
    for (int i = 0; i < kNI; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.0f;
    for (int c0 = 0; c0 < C; c0 += kCT) {
      __syncthreads();  // dn written / previous chunk consumed
      for (int idx = tid; idx < 16 * kNI * kCT; idx += kThreads) {
        const int n = idx / kCT, kk = idx - n * kCT, c = c0 + kk;
        float x = 0.0f;
        if (n < kNT && c < C)
          x = round_t<T>(to_f(vb[(size_t)halo_pixel(n, i0, j0, H, W) * C + c]) / dn[n]);
        vt[kk * kLdv + n] = x;
      }
      for (int idx = tid; idx < kKC * kCT; idx += kThreads) {
        const int k = idx / kCT, kk = idx - k * kCT, c = c0 + kk;
        tt[kk * kLdt + k] = (kc0 + k < K && c < C) ? to_f(tb[(size_t)(kc0 + k) * C + c]) : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kCT; ++kk) {
        float a[kNI], w[kNJ];
#pragma unroll
        for (int i = 0; i < kNI; ++i) a[i] = vt[kk * kLdv + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kNJ; ++j) w[j] = tt[kk * kLdt + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kNI; ++i)
#pragma unroll
          for (int j = 0; j < kNJ; ++j) acc[i][j] += a[i] * w[j];
      }
    }
#pragma unroll
    for (int i = 0; i < kNI; ++i) {
      const int n = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int k = kc0 + tx + 16 * j;
        if (n < kNT && k < K) S[(size_t)k * kNT + n] = round_t<T>(acc[i][j]);
      }
    }
  }
}

template <typename T, bool kScores>
__global__ void __launch_bounds__(kThreads)
upsample_argmax_kernel(const T* __restrict__ src, const T* __restrict__ tn, int* __restrict__ out,
                       int H, int W, int C, int K, int r, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* S = reinterpret_cast<float*>(smem_raw);  // [K][kNT] scores of the tile and its halo
  const int tid = threadIdx.x;
  const int b = blockIdx.z, i0 = blockIdx.y * kTH, j0 = blockIdx.x * kTW;

  if (kScores) {
    tile_scores<T>(src, tn, S, b, i0, j0, H, W, C, K, eps);
  } else {
    const T* mb = src + (size_t)b * K * H * W;
    for (int idx = tid; idx < K * kNT; idx += kThreads) {
      const int k = idx / kNT, n = idx - k * kNT;
      S[idx] = to_f(mb[(size_t)k * H * W + halo_pixel(n, i0, j0, H, W)]);
    }
  }
  __syncthreads();

  const int tw = r * kTW, th = r * kTH;
  for (int idx = tid; idx < th * tw; idx += kThreads) {
    const int oyl = idx / tw, oxl = idx - oyl * tw;
    const int oy = r * i0 + oyl, ox = r * j0 + oxl;
    if (oy >= r * H || ox >= r * W) continue;
    const int li = oyl / r, lj = oxl / r;
    const Phase ph = phase(oyl - li * r, r), pw = phase(oxl - lj * r, r);
    const int rc = (li + 1) * kHW, ro = (ph.prev ? li : li + 2) * kHW;  // halo rows
    const int cc = lj + 1, co = pw.prev ? lj : lj + 2;                  // halo columns
    float best = 0.0f;
    int arg = 0;
    for (int k = 0; k < K; ++k) {
      const float* s = S + (size_t)k * kNT;
      const float hcur = blend(ph.wo, s[ro + cc], ph.wc, s[rc + cc]);
      const float hoth = blend(ph.wo, s[ro + co], ph.wc, s[rc + co]);
      const float val = blend(pw.wo, hoth, pw.wc, hcur);
      if (k == 0 || val > best) {  // strict: a tie keeps the lower class
        best = val;
        arg = k;
      }
    }
    out[((size_t)b * r * H + oy) * (size_t)(r * W) + ox] = arg;
  }
}

template <typename T, bool kScores>
cudaError_t launch(const void* src, const void* tn, void* out, int B, int H, int W, int C,
                   int K, int r, float eps, cudaStream_t stream) {
  size_t smem = sizeof(float) * (size_t)K * kNT;
  if (kScores) smem += sizeof(float) * (kCT * kLdv + kCT * kLdt + kNT);
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = upsample_argmax_kernel<T, kScores>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(src),
                                           static_cast<const T*>(tn), static_cast<int*>(out),
                                           H, W, C, K, r, eps);
  return cudaGetLastError();
}

template <bool kScores>
cudaError_t dispatch(int dtype, const void* src, const void* tn, void* out, int B, int H, int W,
                     int C, int K, int r, float eps, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || K < 1 || r < 1) return cudaErrorInvalidValue;
  if (dtype == kF32) return launch<float, kScores>(src, tn, out, B, H, W, C, K, r, eps, stream);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, kScores>(src, tn, out, B, H, W, C, K, r, eps, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace lc2

// v (B, H·W, C) tokens, tn (B, K, C) normalised class embeddings, both of
// one dtype, contiguous -> out (B, r·H, r·W) int32.
extern "C" int lc2_score_upsample_argmax(int dtype, const void* v, const void* tn, void* out,
                                         int B, int H, int W, int C, int K, int r, float eps,
                                         void* stream) {
  if (C < 1) return cudaErrorInvalidValue;
  return lc2::dispatch<true>(dtype, v, tn, out, B, H, W, C, K, r, eps,
                             static_cast<cudaStream_t>(stream));
}

// map (B, K, H, W) contiguous -> out (B, r·H, r·W) int32.
extern "C" int lc2_upsample_argmax(int dtype, const void* map, void* out, int B, int K, int H,
                                   int W, int r, void* stream) {
  return lc2::dispatch<false>(dtype, map, nullptr, out, B, H, W, 0, K, r, 0.0f,
                              static_cast<cudaStream_t>(stream));
}
