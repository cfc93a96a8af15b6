// window_attention: swin window attention on (N, p, C) windows with the heads
// packed in C, a (heads, p, p) f32 relative-position bias and optional
// (N, p) int32 shift-region labels:
//
//   out[n, :, h] = softmax(q_h·k_hᵀ / √dh + bias[h] [−1e30 where regions
//                  differ]) · v_h
//
// Replaces lc2is_tpu/ops/window_attention.py::_kernel (:164, entry
// window_attention :216) with its semantics: logits accumulated in f32 and
// scaled, the bias added, a cross-region pair set to −1e30, the row max
// subtracted, the row normalised by one reciprocal of its sum, the
// probabilities rounded to T before the P·V product, which accumulates in f32
// and is rounded to T.  The TPU kernel's padding of N to a block multiple
// (:279-289) is not needed: every window is independent.
//
// What bounds it on the card: bytes.  Per window and head it reads 3·p·dh
// values and writes p·dh, against 4·p²·dh operations, about 49 operations a
// byte in bf16 at p = 49: below the tensor cores' ridge, so the first version
// runs its products on the CUDA cores in f32 and keeps everything of one
// (window, head) in shared memory.
//
// Design: one block of 4 warps per (window, head).  The head's q, k and v
// tiles (p x dh, f32) sit in shared memory with an odd row stride, so the 32
// keys a warp reads at one d fall in 32 banks.  A warp owns a query row at a
// time: each lane forms the logits of keys lane, lane + 32, ... (p <= 144:
// at most 5 a lane), the row max and the sum of the exponentials are warp
// reductions, the probabilities (rounded to T) go to the warp's row of
// shared memory, and each lane then sums P·V for columns lane, lane + 32, ...
// (dh <= 128: at most 4).  Shared memory: 3·p·(dh + 1) + 4·160 floats, 223 KB
// at p = 144, dh = 128; 19.6 KB at swin's p = 49, dh = 32.
#include <math_constants.h>

#include "common.cuh"

namespace lc2 {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 144;             // window of 12
constexpr int kMaxDh = 128;
constexpr int kKeySlots = 5;           // ceil(kMaxP / 32)
constexpr int kColSlots = kMaxDh / 32;  // 4
constexpr float kNeg = -1e30f;          // window_attention.py:30

__host__ __device__ inline int row_stride(int dh) { return dh % 2 == 0 ? dh + 1 : dh; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        const int* __restrict__ regions, T* __restrict__ out, int P, int C,
                        int heads, float scale) {
  const int dh = C / heads, ld = row_stride(dh);
  const int n = blockIdx.x / heads, h = blockIdx.x - n * heads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [P][ld]
  float* ks = qs + P * ld;
  float* vs = ks + P * ld;
  float* ps = vs + P * ld;                          // [kWarps][kKeySlots * 32]
  int* lab = reinterpret_cast<int*>(ps + kWarps * kKeySlots * 32);  // [P]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)n * P * C + (size_t)h * dh;
  for (int idx = tid; idx < P * dh; idx += kThreads) {
    const int t = idx / dh, d = idx - t * dh;
    const size_t g = base + (size_t)t * C + d;
    qs[t * ld + d] = to_f(q[g]);
    ks[t * ld + d] = to_f(k[g]);
    vs[t * ld + d] = to_f(v[g]);
  }
  if (regions != nullptr)
    for (int t = tid; t < P; t += kThreads) lab[t] = regions[(size_t)n * P + t];
  __syncthreads();

  const float* bh = bias + (size_t)h * P * P;
  float* pw = ps + warp * kKeySlots * 32;
  for (int t = warp; t < P; t += kWarps) {
    const float* qr = qs + t * ld;
    const int lt = regions != nullptr ? lab[t] : 0;
    float s[kKeySlots];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int u = 0; u < kKeySlots; ++u) {
      const int j = lane + 32 * u;
      float a = -CUDART_INF_F;  // a key slot past the window: exp gives 0
      if (j < P) {
        const float* kr = ks + j * ld;
        a = 0.0f;
#pragma unroll 8
        for (int d = 0; d < dh; ++d) a = fmaf(qr[d], kr[d], a);
        a = __fadd_rn(__fmul_rn(a, scale), bh[t * P + j]);
        if (regions != nullptr && lab[j] != lt) a = kNeg;
      }
      s[u] = a;
      mx = fmaxf(mx, a);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int u = 0; u < kKeySlots; ++u) {
      s[u] = expf(s[u] - mx);
      sum += s[u];
    }
    const float inv = 1.0f / warp_sum(sum);
#pragma unroll
    for (int u = 0; u < kKeySlots; ++u) pw[lane + 32 * u] = round_t<T>(s[u] * inv);
    __syncwarp();
    float o[kColSlots];
#pragma unroll
    for (int i = 0; i < kColSlots; ++i) o[i] = 0.0f;
    for (int j = 0; j < P; ++j) {
      const float pj = pw[j];
      const float* vr = vs + j * ld;
#pragma unroll
      for (int i = 0; i < kColSlots; ++i) {
        const int d = lane + 32 * i;
        if (d < dh) o[i] = fmaf(pj, vr[d], o[i]);
      }
    }
    T* orow = out + base + (size_t)t * C;
#pragma unroll
    for (int i = 0; i < kColSlots; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) orow[d] = from_f<T>(o[i]);
    }
    __syncwarp();  // pw is rewritten by the warp's next row
  }
}

size_t smem_bytes(int P, int dh) {
  return sizeof(float) * ((size_t)3 * P * row_stride(dh) + kWarps * kKeySlots * 32) +
         sizeof(int) * P;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   const int* regions, void* out, int N, int P, int C, int heads,
                   cudaStream_t stream) {
  const int dh = C / heads;
  const size_t smem = smem_bytes(P, dh);
  auto kernel = window_attention_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)N * heads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      regions, static_cast<T*>(out), P, C, heads, static_cast<float>(1.0 / sqrt((double)dh)));
  return cudaGetLastError();
}

}  // namespace
}  // namespace lc2

// q, k, v, out (N, P, C) contiguous, heads packed in C; bias (heads, P, P)
// f32; regions (N, P) int32 or null (no region masking).  1 <= P <= 144,
// 1 <= C / heads <= 128.
extern "C" int lc2_window_attention(int dtype, const void* q, const void* k, const void* v,
                                    const void* bias, const void* regions, void* out, int N,
                                    int P, int C, int heads, void* stream) {
  if (N == 0) return cudaSuccess;
  if (N < 0 || P < 1 || P > lc2::kMaxP || heads < 1 || C % heads != 0 || C / heads < 1 ||
      C / heads > lc2::kMaxDh)
    return cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  const int* r = static_cast<const int*>(regions);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lc2::kF32) return lc2::launch<float>(q, k, v, b, r, out, N, P, C, heads, s);
  if (dtype == lc2::kBF16)
    return lc2::launch<__nv_bfloat16>(q, k, v, b, r, out, N, P, C, heads, s);
  return cudaErrorInvalidValue;
}
