// An f32 matrix product on the tensor cores for the port's f32 bodies (the
// feed-forward, csrc/fused_mlp.cu, and the decoder attention block's
// projections, csrc/attention_block.cu): C = A · B with f32 operands and f32
// accumulators, each product split into three TF32 products (3xTF32, the
// scheme of CUTLASS's OpMultiplyAddFastF32), written by hand for sm_90a.
//
// Why three products: a TF32 operand keeps 10 of f32's 23 mantissa bits,
// which is about 5e-4 relative, far from an f32 result.  Each operand value
// a is split into hi = cvt.rna.tf32(a) and lo = cvt.rna.tf32(a − hi), so
// that a = hi + lo to about 2^-22 relative, and a · b is accumulated as
// lo·hi' + hi·lo' + hi·hi' (the lo·lo' term, ~2^-22 of the product, is
// dropped).  Each term is one mma.sync.m16n8k8 TF32 product with f32
// accumulators: three tensor-core products at a third of the TF32 rate
// (495 TFLOP/s dense on an H100 at 700 W, so ~165 TFLOP/s of f32-accurate
// products) against 67 TFLOP/s for f32 on the CUDA cores.
// scripts/gemm_f32x3_sweep.cu times it against the variants named below.
//
// Operands: A (M x K) row-major, element (m, k) at a[m · lda + k]; B (K x N)
// read from a torch-layout weight W (N, K), element (k, n) at b[n · ldb + k].
// Both are K-contiguous, K a multiple of 4, rows 16-byte aligned (the loads
// are 16-byte cp.async); M and N may be ragged (rows past them load as
// zeros), N a multiple of 8.
//
// Design: a block computes a BM x BN tile of C with 2 x 2 warps, each a
// BM/2 x BN/2 warp tile of 16 x 8 products.  K advances in 32-wide slices
// through a 3-stage cp.async ring in shared memory (slice t + 2 issued
// before slice t is computed, one barrier a slice), rows at a stride of 40
// floats, so the 8-byte fragment loads of a half-warp (rows g, columns 2t,
// 2t + 1) fall in distinct banks.  Within each 8-wide k-step the k index of
// the mma is permuted (its k = t and t + 4 are the slice's columns 2t and
// 2t + 1, the same for A and B, which leaves the sum unchanged), so a
// fragment pair is one 8-byte load.  Each fragment is split right after its
// load, and the three terms are issued term by term over the warp tile, so
// that consecutive products go to different accumulators.  (Splitting each
// slice once a block in shared memory instead costs a second barrier a slice
// and twice the fragment loads, and ran slower.)  The tensor
// cores' f32 accumulation truncates, so a long chain of products into one
// accumulator drifts (1.5e-5 to 2.0e-5 of max |C| at K 2048): each slice
// sums into fresh accumulators, added to the running sums in f32 (round to
// nearest), which keeps K 2048 near 4.5e-7 for about 9 % of the rate.  Two
// tile shapes: 128 x 64 (64 x 32 a warp, two blocks an SM) where they give
// about a wave of blocks, else 64 x 64 (32 x 32 a warp, three an SM), which
// gives the prompt decoders' 2,416 x 512 products 304 blocks, not 76.  At
// 45-54 TFLOP/s of f32-accurate products it runs level with cuBLAS's f32
// SGEMM; this loop issues TF32 mma.sync products at 140-165 TFLOP/s (its
// rate with no split at all), and wgmma (495 dense) is the way past it.
// Epilogue, from the accumulators straight to device memory: + bias[n],
// + an f32 addend (m, n), with kAct the pre-activation stored and then an
// activation (activation.cuh) applied; f32 out.
#pragma once

#include "activation.cuh"
#include "common.cuh"
#include "mma_bf16.cuh"

namespace lc2 {
namespace gemm32 {

constexpr int kBK = 32, kStages = 3, kLd = kBK + 8;

// What the epilogue does with the accumulators; unused pointers are null.
struct Epilogue {
  const float* bias;  // (N,) added to every row
  const float* add;   // (M, N) at row stride ldc, added after the bias
  float* out;         // (M, N) at row stride ldc
  long long ldc;
  // read only by gemm<kAct = true>: the act::Act applied last, and where
  // the value before it goes (or null)
  int act = -1;
  float* out_pre = nullptr;
};

// a rounded to TF32 (nearest, ties away from zero: the 13 low mantissa bits
// cleared), as a 32-bit operand of the TF32 mma
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

// a = hi + lo, both TF32, each as cvt.rna.tf32.f32 rounds.  hi takes the two
// integer operations that instruction compiles to (add half a TF32 step to
// the magnitude's bits, clear the 13 low bits) without its third, a test
// that leaves Inf and NaN unrounded: for a finite a the bits are the same,
// and a NaN a still gives a NaN lo (a − hi), so NaN propagates; ~2 %
// faster than two cvt.rna.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
  lo = tf32_rna(a - __uint_as_float(hi));
}

// c += a · b (16x8 TF32 times 8x8 TF32, f32 accumulate).  Fragments (g =
// lane / 4, t = lane % 4): A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4);
// B (k t, n g), (k t + 4, n g); C (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A split fragment: the hi and lo halves of 4 (A) or 2 (B) values.
template <int N>
struct Split {
  uint32_t hi[N], lo[N];
};

// The A fragment of rows r and r + 8 from two 8-byte loads (columns 2t,
// 2t + 1 of each): mma k t <- column 2t, k t + 4 <- column 2t + 1.
__device__ __forceinline__ Split<4> split_a(float2 r, float2 r8) {
  Split<4> f;
  split(r.x, f.hi[0], f.lo[0]);
  split(r8.x, f.hi[1], f.lo[1]);
  split(r.y, f.hi[2], f.lo[2]);
  split(r8.y, f.hi[3], f.lo[3]);
  return f;
}

// The B fragment of column n from one 8-byte load of W's row n (columns 2t,
// 2t + 1), in the same k order as split_a.
__device__ __forceinline__ Split<2> split_b(float2 w) {
  Split<2> f;
  split(w.x, f.hi[0], f.lo[0]);
  split(w.y, f.hi[1], f.lo[1]);
  return f;
}

// acc[j] += a · b[j] to f32 accuracy for one 16-row A fragment, term by
// term (lo·hi, hi·lo, hi·hi) over the NI tiles.
template <int NI>
__device__ __forceinline__ void mma_x3_row(float (&acc)[NI][4], const Split<4>& a,
                                           const Split<2> (&b)[NI]) {
#pragma unroll
  for (int j = 0; j < NI; ++j) mma_tf32(acc[j], a.lo, b[j].hi[0], b[j].hi[1]);
#pragma unroll
  for (int j = 0; j < NI; ++j) mma_tf32(acc[j], a.hi, b[j].lo[0], b[j].lo[1]);
#pragma unroll
  for (int j = 0; j < NI; ++j) mma_tf32(acc[j], a.hi, b[j].hi[0], b[j].hi[1]);
}

// acc[i][j] += a[i] · b[j] to f32 accuracy, term by term (lo·hi, hi·lo,
// hi·hi) over the whole tile so that consecutive products are independent.
template <int MI, int NI>
__device__ __forceinline__ void mma_x3(float (&acc)[MI][NI][4], const Split<4> (&a)[MI],
                                       const Split<2> (&b)[NI]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) mma_tf32(acc[i][j], a[i].lo, b[j].hi[0], b[j].hi[1]);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) mma_tf32(acc[i][j], a[i].hi, b[j].lo[0], b[j].lo[1]);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) mma_tf32(acc[i][j], a[i].hi, b[j].hi[0], b[j].hi[1]);
}

// Rows [r0, r0 + ROWS) x k-slice [k0, k0 + kBK) of a K-contiguous operand
// into a slice at row stride kLd, by NT threads; zeros past `rows` and kend.
template <int ROWS, int NT>
__device__ __forceinline__ void load_slice(const float* __restrict__ src, long long ld, int r0,
                                           int rows, int k0, int kend, float* dst) {
  constexpr int kChunks = kBK / 4;
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += NT) {
    const int r = idx / kChunks, c = (idx - r * kChunks) * 4;
    const bool full = r0 + r < rows && k0 + c < kend;
    mma::cp_async16(dst + r * kLd + c, full ? src + (r0 + r) * ld + k0 + c : src, full);
  }
}

template <int BM, int BN, bool kAct>
__global__ void __launch_bounds__(128)
gemm_f32x3_kernel(int M, int N, int K, const float* __restrict__ a, long long lda,
                  const float* __restrict__ b, long long ldb, Epilogue ep) {
  constexpr int kThreads = 128;  // 2 x 2 warps
  constexpr int TM = BM / 2, TN = BN / 2, MI = TM / 16, NI = TN / 8;
  constexpr int kStage = (BM + BN) * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * TM, wn = (warp & 1) * TN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_slices = (K + kBK - 1) / kBK;

  auto issue = [&](int s) {  // slice s into stage s % kStages, one group
    if (s < n_slices) {
      float* st = ring + (s % kStages) * kStage;
      load_slice<BM, kThreads>(a, lda, m0, M, s * kBK, K, st);
      load_slice<BN, kThreads>(b, ldb, n0, N, s * kBK, K, st + BM * kLd);
    }
    mma::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  const int g = lane >> 2, t = lane & 3;
  for (int s = 0; s < n_slices; ++s) {
    mma::cp_async_wait<kStages - 2>();  // slice s has landed (this thread's copies)
    __syncthreads();  // ... every thread's; and every warp is done with slice s - 1
    issue(s + kStages - 1);  // into slice s - 1's stage
    const float* as = ring + (s % kStages) * kStage + (wm + g) * kLd + 2 * t;
    const float* bs = ring + (s % kStages) * kStage + (BM + wn + g) * kLd + 2 * t;
    float part[MI][NI][4];  // this slice's sums
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
        part[i][j][0] = part[i][j][1] = part[i][j][2] = part[i][j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      Split<4> af[MI];
      Split<2> bf[NI];
#pragma unroll
      for (int j = 0; j < NI; ++j)
        bf[j] = split_b(*reinterpret_cast<const float2*>(bs + 8 * j * kLd + kk));
#pragma unroll
      for (int i = 0; i < MI; ++i)
        af[i] = split_a(*reinterpret_cast<const float2*>(as + 16 * i * kLd + kk),
                        *reinterpret_cast<const float2*>(as + (16 * i + 8) * kLd + kk));
      mma_x3(part, af, bf);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  mma::cp_async_wait<0>();

  // lane's elements: rows g and g + 8 of each m-tile, columns 2t, 2t + 1 of each n-tile
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + wm + 16 * i + g + 8 * r;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = n0 + wn + 8 * j + 2 * t;
        if (n >= N) continue;  // N is a multiple of 8: n + 1 < N too
        float v0 = acc[i][j][2 * r], v1 = acc[i][j][2 * r + 1];
        const long long o = m * ep.ldc + n;
        if (ep.bias) {
          v0 += ep.bias[n];
          v1 += ep.bias[n + 1];
        }
        if (ep.add) {
          const float2 ad = *reinterpret_cast<const float2*>(ep.add + o);
          v0 += ad.x;
          v1 += ad.y;
        }
        if constexpr (kAct) {
          if (ep.out_pre) *reinterpret_cast<float2*>(ep.out_pre + o) = make_float2(v0, v1);
          v0 = lc2::act::activate(v0, ep.act);
          v1 = lc2::act::activate(v1, ep.act);
        }
        *reinterpret_cast<float2*>(ep.out + o) = make_float2(v0, v1);
      }
    }
}

template <int BM, int BN, bool kAct>
cudaError_t launch(int M, int N, int K, const float* a, long long lda, const float* b,
                   long long ldb, const Epilogue& ep, cudaStream_t s) {
  constexpr size_t smem = sizeof(float) * kStages * (BM + BN) * kLd;
  auto kernel = gemm_f32x3_kernel<BM, BN, kAct>;
  LC2_TRY(allow_smem(kernel, smem));
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, 128, smem, s>>>(M, N, K, a, lda, b, ldb, ep);
  return cudaGetLastError();
}

// C = A · B (+ the epilogue's terms) over M x N, K.  kAct: the epilogue
// applies ep.act (and writes ep.out_pre); a separate instantiation, so the
// other products compile without it.
template <bool kAct = false>
cudaError_t gemm(int M, int N, int K, const float* a, long long lda, const float* b,
                 long long ldb, const Epilogue& ep, cudaStream_t s) {
  if (M < 1 || N < 1 || K < 1 || N % 8 || K % 4 || lda % 4 || ldb % 4 || ep.ldc % 2)
    return cudaErrorInvalidValue;
  if ((long long)((M + 127) / 128) * ((N + 63) / 64) >= 240)  // about a wave, 2 blocks an SM
    return launch<128, 64, kAct>(M, N, K, a, lda, b, ldb, ep, s);
  return launch<64, 64, kAct>(M, N, K, a, lda, b, ldb, ep, s);
}

}  // namespace gemm32
}  // namespace lc2
