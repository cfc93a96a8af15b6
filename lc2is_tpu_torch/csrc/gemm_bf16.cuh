// A bf16 tensor-core matrix product for the port's backward kernels
// (csrc/attention_block_bwd.cu): C = A · B with bf16 operands and f32
// accumulators, mma.sync m16n8k16 (mma_bf16.cuh), written by hand for sm_90a.
// csrc/gemm.cuh keeps the f32 CUDA-core product of the f32 bodies.
//
// Operands are row-major bf16 matrices in device memory, each in one of two
// orientations, chosen at compile time:
// - A (M x K): kAT false, element (m, k) at a[m · lda + k] (K contiguous);
//   kAT true, at a[k · lda + m] (M contiguous: the transpose of a row-major
//   (K, M) matrix, as a weight gradient's Xᵀ · Y reads its X);
// - B (K x N): kBT false, element (k, n) at b[n · ldb + k] (a torch-layout
//   weight W read as Wᵀ); kBT true, at b[k · ldb + n] (N contiguous).
// The contiguous dimension must be a multiple of 8 and its rows 16-byte
// aligned (the loads are 16-byte cp.async); the other dimension may be
// ragged: rows past it load as zeros.
//
// Design: a block computes a 128 x 128 tile of C with 8 warps (2 along M x 4
// along N, 64 x 32 each, 64 f32 accumulators a thread).  K advances in
// 32-wide slices through a 3-stage cp.async ring in shared memory (slice
// t + 2 issued before slice t is computed, one barrier a slice); the
// fragments come from the slices by ldmatrix (.trans for an M-contiguous A
// or N-contiguous B), whose rows sit at strides of an odd number of 16-byte
// units, so the 8 rows of one ldmatrix fall in 8 distinct bank groups.
// Epilogue, from the accumulators straight to device memory: + bias[n],
// + an f32 and/or a bf16 addend (m, n), stored as f32 or bf16 (rounded to
// nearest even); or, for a weight gradient whose K (the tokens) is long and
// whose output is small, K is split over blockIdx.z and each block adds its
// partial into the f32 output with atomics (so the sum's order, and its
// last bits, vary from run to run).
#pragma once

#include "common.cuh"
#include "mma_bf16.cuh"

namespace lc2 {
namespace gemm16 {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3, kThreads = 256;

// What the epilogue does with the accumulators; unused pointers are null.
struct Epilogue {
  const float* bias;       // (N,) added to every row
  const float* add_f32;    // (M, N) at row stride ldc
  const bf16* add_bf16;    // (M, N) at row stride ldc
  float* out_f32;          // f32 result (atomic: the split-K sum)
  bf16* out_bf16;          // bf16 result
  long long ldc;
  bool atomic;
};

// Elements of one stage's A or B slice in shared memory.
template <bool kT, int kRows>
struct Slice {
  // kT false: kRows rows of kBK (+8) elements; true: kBK rows of kRows (+8)
  static constexpr int kLd = kT ? kRows + 8 : kBK + 8;
  static constexpr int kElems = kT ? kBK * kLd : kRows * kLd;
};

// Rows [r0, r0 + kRows) x k-slice [k0, k0 + kBK) of an operand into a slice:
// kT false reads kRows rows of kBK contiguous elements, kT true kBK rows of
// kRows contiguous elements.  Zeros past `rows` (the M or N extent) and past
// kend.
template <bool kT, int kRows>
__device__ __forceinline__ void load_slice(const bf16* __restrict__ src, long long ld, int r0,
                                           int rows, int k0, int kend, bf16* dst) {
  using S = Slice<kT, kRows>;
  if constexpr (!kT) {
    constexpr int kChunks = kBK / 8;
#pragma unroll
    for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = (idx - r * kChunks) * 8;
      const bool full = r0 + r < rows && k0 + c < kend;
      mma::cp_async16(dst + r * S::kLd + c, full ? src + (r0 + r) * ld + k0 + c : src, full);
    }
  } else {
    constexpr int kChunks = kRows / 8;
#pragma unroll
    for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kThreads) {
      const int kk = idx / kChunks, c = (idx - kk * kChunks) * 8;
      const bool full = k0 + kk < kend && r0 + c < rows;
      mma::cp_async16(dst + kk * S::kLd + c, full ? src + (k0 + kk) * ld + r0 + c : src, full);
    }
  }
}

template <bool kAT, bool kBT>
__global__ void __launch_bounds__(kThreads, 2)
gemm_bf16_kernel(int M, int N, int K, const bf16* __restrict__ a, long long lda,
                 const bf16* __restrict__ b, long long ldb, Epilogue ep, int kchunk) {
  using SA = Slice<kAT, kBM>;
  using SB = Slice<kBT, kBN>;
  constexpr int kStage = SA::kElems + SB::kElems;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * kchunk, kend = min(K, kbeg + kchunk);
  const int n_slices = (kend - kbeg + kBK - 1) / kBK;

  auto issue = [&](int t) {  // slice t into stage t % kStages, one group
    if (t < n_slices) {
      bf16* st = ring + (t % kStages) * kStage;
      const int k0 = kbeg + t * kBK;
      load_slice<kAT, kBM>(a, lda, m0, M, k0, kend, st);
      load_slice<kBT, kBN>(b, ldb, n0, N, k0, kend, st + SA::kElems);
    }
    mma::cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  const int lr = lane & 7, l3 = (lane >> 3) & 1, l4 = lane >> 4;
  for (int t = 0; t < n_slices; ++t) {
    mma::cp_async_wait<kStages - 2>();  // slice t has landed (this thread's copies)
    __syncthreads();  // ... every thread's; and every warp is done with slice t - 1
    issue(t + kStages - 1);  // into slice t - 1's stage
    const bf16* as = ring + (t % kStages) * kStage;
    const bf16* bs = as + SA::kElems;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (!kAT)
          mma::ldsm_x4(af[i], as + (wm + 16 * i + lr + 8 * l3) * SA::kLd + kk + 8 * l4);
        else
          mma::ldsm_x4_t(af[i], as + (kk + lr + 8 * l4) * SA::kLd + wm + 16 * i + 8 * l3);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        if constexpr (!kBT)
          mma::ldsm_x4(bfr[np], bs + (wn + 16 * np + lr + 8 * l4) * SB::kLd + kk + 8 * l3);
        else
          mma::ldsm_x4_t(bfr[np], bs + (kk + lr + 8 * l3) * SB::kLd + wn + 16 * np + 8 * l4);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma::mma_bf16(acc[i][j], af[i], bfr[j >> 1][2 * (j & 1)], bfr[j >> 1][2 * (j & 1) + 1]);
    }
  }
  mma::cp_async_wait<0>();

  // lane's elements: rows g and g + 8 of each m-tile, columns c, c + 1 of each n-tile
  const int g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + wm + 16 * i + g + 8 * r;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + 8 * j + c;
        if (n >= N) continue;  // N is a multiple of 8: n + 1 < N too
        float v0 = acc[i][j][2 * r], v1 = acc[i][j][2 * r + 1];
        const long long o = m * ep.ldc + n;
        if (ep.atomic) {
          atomicAdd(ep.out_f32 + o, v0);
          atomicAdd(ep.out_f32 + o + 1, v1);
          continue;
        }
        if (ep.bias) {
          v0 += ep.bias[n];
          v1 += ep.bias[n + 1];
        }
        if (ep.add_f32) {
          const float2 ad = *reinterpret_cast<const float2*>(ep.add_f32 + o);
          v0 += ad.x;
          v1 += ad.y;
        }
        if (ep.add_bf16) {
          const float2 ad = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ep.add_bf16 + o));
          v0 += ad.x;
          v1 += ad.y;
        }
        if (ep.out_f32)
          *reinterpret_cast<float2*>(ep.out_f32 + o) = make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(ep.out_bf16 + o) = mma::pack_bf16(v0, v1);
      }
    }
}

template <bool kAT, bool kBT>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * kStages * (Slice<kAT, kBM>::kElems + Slice<kBT, kBN>::kElems);
}

// C = A · B (+ the epilogue's terms) over M x N, K.  With ep.atomic, the
// product is added into ep.out_f32 (zeroed by the caller), K split over
// blocks so that about two blocks per SM run even when the output has a
// handful of tiles.
template <bool kAT, bool kBT>
cudaError_t gemm(int M, int N, int K, const bf16* a, long long lda, const bf16* b,
                 long long ldb, const Epilogue& ep, cudaStream_t s) {
  // the contiguous dimension of each operand: a multiple of 8
  if (M < 1 || N < 1 || K < 1 || N % 8 || (kAT ? M % 8 : K % 8) || (!kBT && K % 8))
    return cudaErrorInvalidValue;
  const int tiles = ((N + kBN - 1) / kBN) * ((M + kBM - 1) / kBM);
  int splits = 1;
  if (ep.atomic) splits = max(1, min((K + 511) / 512, (2 * 132 + tiles - 1) / tiles));
  const int kchunk = ((K + splits - 1) / splits + kBK - 1) / kBK * kBK;
  splits = (K + kchunk - 1) / kchunk;
  constexpr size_t smem = smem_bytes<kAT, kBT>();
  auto kernel = gemm_bf16_kernel<kAT, kBT>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  kernel<<<grid, kThreads, smem, s>>>(M, N, K, a, lda, b, ldb, ep, kchunk);
  return cudaGetLastError();
}

}  // namespace gemm16
}  // namespace lc2
