// Building blocks of the port's backward kernels (csrc/swin_window_bwd.cu,
// csrc/attention_block_bwd.cu): a tiled f32 matrix product on the CUDA
// cores with strided operands, a column sum, and the 64 x 64 shared-memory
// tile product the attention backwards are written in.
//
// Every product of a backward is one of these kernels, launched by the
// backward's own C entry point: none goes to a library.  All of them read
// and accumulate f32; an operand that the forward rounds to bf16 is rounded
// by its producer, and a product can round its output (round_bf16) where the
// forward does.  They run on the CUDA cores, for the f32 bodies and for
// the swin backward; the decoder backward's bf16 body takes its products
// from gemm_bf16.cuh (tensor cores).
#pragma once

#include "common.cuh"

// return the error of a launch (or of a helper that launches) if it failed
#define LC2_TRY(expr)                 \
  do {                                \
    const cudaError_t e_ = (expr);    \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

namespace lc2 {
namespace {

constexpr int kGM = 64, kGN = 64, kGK = 16, kGThreads = 256;

// element (r, c) of a matrix at p[r * rs + c * cs]
struct Mat {
  const float* p;
  long long rs, cs;
};

__device__ __forceinline__ float round_bf16(float v) { return round_t<__nv_bfloat16>(v); }

// C(m, n) = Σ_k A(m, k) · B(k, n) over a 64 x 64 output tile per block, each
// thread a 4 x 4 sub-tile (rows ty + 16i, columns tx + 16j).
// kAtomic: atomicAdd into C (zeroed by the caller); blockIdx.z takes the K
//   range [z · kchunk, (z + 1) · kchunk), so a product with a long K and a
//   small output (a weight gradient summed over all tokens) fills the card.
// otherwise: C[m·ldc + n] = acc (+ bias[n]) (+ add[m·ldc + n]), rounded to
//   bf16 when round_bf16.
template <bool kAtomic>
__global__ void __launch_bounds__(kGThreads)
gemm_kernel(int M, int N, int K, Mat A, Mat B, float* __restrict__ C, long long ldc,
            const float* __restrict__ bias, const float* __restrict__ add, int round_out,
            int kchunk) {
  __shared__ float ta[kGK][kGM + 4];
  __shared__ float tb[kGK][kGN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int kbeg = blockIdx.z * kchunk, kend = min(K, kbeg + kchunk);
  const bool a_kfast = A.cs == 1, b_nfast = B.cs == 1;  // which index is contiguous
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = kbeg; k0 < kend; k0 += kGK) {
    for (int idx = tid; idx < kGM * kGK; idx += kGThreads) {
      int mm, kk;
      if (a_kfast) { kk = idx % kGK; mm = idx / kGK; } else { mm = idx % kGM; kk = idx / kGM; }
      const int m = m0 + mm, k = k0 + kk;
      ta[kk][mm] = (m < M && k < kend) ? A.p[m * A.rs + k * A.cs] : 0.0f;
    }
    for (int idx = tid; idx < kGN * kGK; idx += kGThreads) {
      int nn, kk;
      if (b_nfast) { nn = idx % kGN; kk = idx / kGN; } else { kk = idx % kGK; nn = idx / kGK; }
      const int n = n0 + nn, k = k0 + kk;
      tb[kk][nn] = (n < N && k < kend) ? B.p[k * B.rs + n * B.cs] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ta[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = tb[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float* dst = C + m * ldc + n;
      if (kAtomic) {
        atomicAdd(dst, acc[i][j]);
      } else {
        float v = acc[i][j];
        if (bias) v += bias[n];
        if (add) v += add[m * ldc + n];
        *dst = round_out ? round_bf16(v) : v;
      }
    }
  }
}

inline cudaError_t gemm(int M, int N, int K, Mat A, Mat B, float* C, long long ldc,
                        const float* bias, const float* add, int round_out, cudaStream_t s) {
  const dim3 grid((N + kGN - 1) / kGN, (M + kGM - 1) / kGM, 1);
  gemm_kernel<false><<<grid, kGThreads, 0, s>>>(M, N, K, A, B, C, ldc, bias, add, round_out, K);
  return cudaGetLastError();
}

// C (zeroed by the caller) += A · B, with K split over blocks so that about
// four blocks per SM run even when the output has a handful of tiles.
inline cudaError_t gemm_acc(int M, int N, int K, Mat A, Mat B, float* C, long long ldc,
                            cudaStream_t s) {
  const int tiles = ((N + kGN - 1) / kGN) * ((M + kGM - 1) / kGM);
  int splits = max(1, min((K + 255) / 256, (4 * 132 + tiles - 1) / tiles));
  const int kchunk = ((K + splits - 1) / splits + kGK - 1) / kGK * kGK;
  splits = (K + kchunk - 1) / kchunk;
  const dim3 grid((N + kGN - 1) / kGN, (M + kGM - 1) / kGM, splits);
  gemm_kernel<true><<<grid, kGThreads, 0, s>>>(M, N, K, A, B, C, ldc, nullptr, nullptr, 0,
                                               kchunk);
  return cudaGetLastError();
}

// out[n] += Σ_m a[m·lda + n] (out zeroed by the caller): a bias gradient.
// Threads take consecutive columns; a block sums a chunk of rows and adds
// its partial with one atomic per column.
__global__ void __launch_bounds__(256)
colsum_kernel(int M, int N, const float* __restrict__ a, long long lda, float* __restrict__ out,
              int rows) {
  const int m0 = blockIdx.y * rows, m1 = min(M, m0 + rows);
  const int n = blockIdx.x * 256 + threadIdx.x;
  if (n >= N) return;
  float s = 0.0f;
  for (int m = m0; m < m1; ++m) s += a[m * lda + n];
  atomicAdd(out + n, s);
}

inline cudaError_t colsum(int M, int N, const float* a, long long lda, float* out,
                          cudaStream_t s) {
  const int cols = (N + 255) / 256;
  const int chunks = max(1, min((M + 63) / 64, 4 * 132 / cols));
  const int rows = (M + chunks - 1) / chunks;
  colsum_kernel<<<dim3(cols, (M + rows - 1) / rows), 256, 0, s>>>(M, N, a, lda, out, rows);
  return cudaGetLastError();
}

// acc[i][j] += Σ_{k < K} A[(ty + 16i)·ars + k·aks] · B[(tx + 16j)·bcs + k·bks]
// over shared-memory operands, for a block of 256 threads (16 x 16): the
// 64 x 16·NJ tile product of the attention backwards.
template <int NI, int NJ>
__device__ __forceinline__ void tile_mm(float (&acc)[NI][NJ], const float* A, int ars, int aks,
                                        const float* B, int bcs, int bks, int K) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[NI], b[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i) a[i] = A[(ty + 16 * i) * ars + k * aks];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = B[(tx + 16 * j) * bcs + k * bks];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] += a[i] * b[j];
  }
}

template <int NI, int NJ>
__device__ __forceinline__ void zero(float (&acc)[NI][NJ]) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
}

}  // namespace
}  // namespace lc2
