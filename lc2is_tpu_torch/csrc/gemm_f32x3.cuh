// An f32 matrix product on the tensor cores for the port's f32 bodies (the
// feed-forward, csrc/fused_mlp.cu; the decoder attention block's forward and
// backward, csrc/attention_block.cu and csrc/attention_block_bwd.cu; the swin
// backward, csrc/swin_window_bwd.cu): C = A · B with f32 operands and f32
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
// Operands, each in one of two orientations chosen at compile time (the
// forms of gemm_bf16.cuh):
// - A (M x K): kAT false, element (m, k) at a[m · lda + k] (K contiguous);
//   kAT true, at a[k · lda + m] (M contiguous: a weight gradient's dYᵀ);
// - B (K x N): kBT false, element (k, n) at b[n · ldb + k] (a torch-layout
//   weight W (N, K) read as Wᵀ); kBT true, at b[k · ldb + n] (N contiguous:
//   dY · W, or a weight gradient's X).
// The contiguous dimension is a multiple of 4 with 16-byte aligned rows
// (the loads are 16-byte cp.async), N a multiple of 8; the other dimension
// may be ragged: rows past it load as zeros.
//
// Design: a block computes a BM x BN tile of C with 2 x 2 warps, each a
// BM/2 x BN/2 warp tile of 16 x 8 products.  K advances in 32-wide slices
// through a 3-stage cp.async ring in shared memory (slice t + 2 issued
// before slice t is computed, one barrier a slice).  Within each 8-wide
// k-step the k index of the mma is permuted (its k = t and t + 4 are the
// slice's columns 2t and 2t + 1, the same for A and B, which leaves the sum
// unchanged).  A K-contiguous slice holds its rows at a stride of 40 floats,
// so the 8-byte fragment loads of a half-warp (rows g, columns 2t, 2t + 1)
// fall in distinct banks and a fragment pair is one load.  A transposed
// slice is staged as it lies, kBK rows of BM (or BN) + 4 floats: lane (g, t)
// reads its k 2t and 2t + 1 elements of column g with 4-byte loads at word
// 8t + g (mod 32), distinct banks, so no transpose pass is needed.  Each
// fragment is split right after its load, and the three terms are issued
// term by term over the warp tile, so that consecutive products go to
// different accumulators.  (Splitting each slice once a block in shared
// memory instead costs a second barrier a slice and twice the fragment
// loads, and ran slower.)  The tensor cores' f32 accumulation truncates,
// so a long chain of products into one accumulator drifts (1.5e-5 to
// 2.0e-5 of max |C| at K 2048): each slice sums into fresh accumulators,
// added to the running sums in f32 (round to nearest), which keeps K 2048
// near 4.5e-7 for about 9 % of the rate.  The forward bodies' products go
// further (kNearest): every mma sums into zero accumulators, added in f32
// round to nearest.  Even a slice's chain of 12 truncating adds biases a
// sum toward zero, and over the forward's blocks that bias moved a
// downstream relu unit's sign against the f32 references; per mma it
// halves the swin window block's f32 error (6.5e-7 to 3.4e-7 of max
// |plain|).  The backward bodies keep the slices: their gradients are held
// norm-relative, and the adds cost their products ~30 %.  Two tile shapes:
// 128 x 64 (64 x 32 a warp, two blocks an SM) where they give about a wave
// of blocks, else 64 x 64 (32 x 32 a warp, three an SM), which gives the
// prompt decoders' 2,416 x 512 products 304 blocks, not 76.  At 45-54 TFLOP/s of
// f32-accurate products it runs level with cuBLAS's f32 SGEMM; this loop
// issues TF32 mma.sync products at 140-165 TFLOP/s (its rate with no split
// at all), and wgmma (495 dense) is the way past it.
// Epilogue, from the accumulators straight to device memory: + bias[n],
// + an f32 addend (m, n), with kAct the pre-activation stored and then an
// activation (activation.cuh) applied; f32 out.  Or, for a weight gradient
// whose K (the tokens) is long and whose output is small, K is split over
// blockIdx.z and each block adds its partial into the f32 output with
// atomics (64 x 64 tiles; the sum's order, and its last bits, vary from run
// to run).  colsum beside it sums a bias gradient's columns.
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
  // add the product into out (zeroed by the caller) with atomics, K split
  // over blocks; bias and add are not read
  bool atomic = false;
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

// c += a · b (16x8 TF32 times 8x8 TF32, f32 accumulate): the mma adds into
// c (truncating), or with kNearest sums the products into zero accumulators
// that are added to c in f32, round to nearest.  Fragments (g = lane / 4, t
// = lane % 4): A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (k t, n
// g), (k t + 4, n g); C (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
template <bool kNearest>
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (kNearest) {
    float d[4];
    const float z = 0.0f;
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(z));
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], d[e]);
  } else {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// c += a · b as two m16n8k4 TF32 products (k t, then k t + 4: the same
// fragments), each summed into zero accumulators and added to c in f32,
// round to nearest: each of the tensor cores' internal sums, which drop the
// bits of its smaller products below its largest one's, holds 4 products,
// not 8.
__device__ __forceinline__ void mma_tf32_k4x2(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  const float z = 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float d[4];
    asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
        "{%7, %7, %7, %7};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[2 * h]), "r"(a[2 * h + 1]), "r"(h ? b1 : b0), "f"(z));
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], d[e]);
  }
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
template <int NI, bool kNearest = false>
__device__ __forceinline__ void mma_x3_row(float (&acc)[NI][4], const Split<4>& a,
                                           const Split<2> (&b)[NI]) {
#pragma unroll
  for (int j = 0; j < NI; ++j) mma_tf32<kNearest>(acc[j], a.lo, b[j].hi[0], b[j].hi[1]);
#pragma unroll
  for (int j = 0; j < NI; ++j) mma_tf32<kNearest>(acc[j], a.hi, b[j].lo[0], b[j].lo[1]);
#pragma unroll
  for (int j = 0; j < NI; ++j) mma_tf32<kNearest>(acc[j], a.hi, b[j].hi[0], b[j].hi[1]);
}

// mma_x3_row<NI, true> with its hi·hi term, which carries all but ~2^-11 of
// each product, as two 4-product mmas (mma_tf32_k4x2): flash attention's
// forward (csrc/flash_attention.cu says why).
template <int NI>
__device__ __forceinline__ void mma_x3_row_k4hi(float (&acc)[NI][4], const Split<4>& a,
                                                const Split<2> (&b)[NI]) {
#pragma unroll
  for (int j = 0; j < NI; ++j) mma_tf32<true>(acc[j], a.lo, b[j].hi[0], b[j].hi[1]);
#pragma unroll
  for (int j = 0; j < NI; ++j) mma_tf32<true>(acc[j], a.hi, b[j].lo[0], b[j].lo[1]);
#pragma unroll
  for (int j = 0; j < NI; ++j) mma_tf32_k4x2(acc[j], a.hi, b[j].hi[0], b[j].hi[1]);
}

// acc[i][j] += a[i] · b[j] to f32 accuracy, term by term (lo·hi, hi·lo,
// hi·hi) over the whole tile so that consecutive products are independent.
template <int MI, int NI, bool kNearest>
__device__ __forceinline__ void mma_x3(float (&acc)[MI][NI][4], const Split<4> (&a)[MI],
                                       const Split<2> (&b)[NI]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) mma_tf32<kNearest>(acc[i][j], a[i].lo, b[j].hi[0], b[j].hi[1]);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) mma_tf32<kNearest>(acc[i][j], a[i].hi, b[j].lo[0], b[j].lo[1]);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) mma_tf32<kNearest>(acc[i][j], a[i].hi, b[j].hi[0], b[j].hi[1]);
}

// acc[j] += a · B for NI 8-column tiles of B over one 8-wide k step, B read
// from a tile in shared memory at row stride LD, for attention cores whose
// own rows are the A fragment:
// - mma_x3_bt: B (k, n) = X[n][k] (X's rows K-contiguous, as Kᵀ in Q · Kᵀ);
//   x at the lane's row g, column k0 + 2t; tile j at rows 8j (8-byte loads);
// - mma_x3_bn: B (k, n) = Z[k][n] (Z's rows N-contiguous, as V in P · V);
//   z at the lane's row k0 + 2t, column g; tile j at columns 8j (4-byte
//   loads of rows 2t and 2t + 1).
template <int NI, int LD>
__device__ __forceinline__ void mma_x3_bt(float (&acc)[NI][4], const Split<4>& a, const float* x) {
  Split<2> b[NI];
#pragma unroll
  for (int j = 0; j < NI; ++j) b[j] = split_b(*reinterpret_cast<const float2*>(x + 8 * j * LD));
  mma_x3_row<NI>(acc, a, b);
}

template <int NI, int LD>
__device__ __forceinline__ void mma_x3_bn(float (&acc)[NI][4], const Split<4>& a, const float* z) {
  Split<2> b[NI];
#pragma unroll
  for (int j = 0; j < NI; ++j) b[j] = split_b(make_float2(z[8 * j], z[LD + 8 * j]));
  mma_x3_row<NI>(acc, a, b);
}

// The A fragment of a product over 8 k from a 16 x 8 C fragment c (rows g,
// g + 8; columns 2t, 2t + 1), in the k order above: k t <- column 2t, k
// t + 4 <- column 2t + 1.
__device__ __forceinline__ Split<4> split_c(const float (&c)[4]) {
  return split_a(make_float2(c[0], c[1]), make_float2(c[2], c[3]));
}

// acc += C · Z over 8 rows of Z: c a 16 x 8 C fragment, split into the A
// fragment of a product over those 8 rows (split_c); z the first of the rows,
// in a tile at row stride LD, whose DH columns are DH / 8 tiles of 8, G at a
// time.  The attention backwards' products of p or ds onto a warp's own rows
// (dq += ds · k, dv += pᵀ · dO, dk += dsᵀ · q).
template <int DH, int G, int LD>
__device__ __forceinline__ void mma_x3_rows(float (&acc)[DH / 8 / G][G][4], const float (&c)[4],
                                            const float* z, int lane) {
  const Split<4> af = split_c(c);
  const float* zl = z + 2 * (lane & 3) * LD + (lane >> 2);
#pragma unroll
  for (int jg = 0; jg < DH / 8 / G; ++jg) mma_x3_bn<G, LD>(acc[jg], af, zl + 8 * G * jg);
}

// Elements of one stage's A or B slice in shared memory.
template <bool kT, int kRows>
struct Slice {
  // kT false: kRows rows of kBK (+8) floats; true: kBK rows of kRows (+4)
  static constexpr int kStride = kT ? kRows + 4 : kLd;
  static constexpr int kElems = kT ? kBK * kStride : kRows * kStride;
};

// Rows [r0, r0 + ROWS) x k-slice [k0, k0 + kBK) of an operand into a slice,
// by NT threads: kT false reads ROWS rows of kBK contiguous floats, kT true
// kBK rows of ROWS contiguous floats.  Zeros past `rows` and past kend.
template <bool kT, int ROWS, int NT>
__device__ __forceinline__ void load_slice(const float* __restrict__ src, long long ld, int r0,
                                           int rows, int k0, int kend, float* dst) {
  constexpr int LD = Slice<kT, ROWS>::kStride;
  if constexpr (!kT) {
    constexpr int kChunks = kBK / 4;
#pragma unroll
    for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += NT) {
      const int r = idx / kChunks, c = (idx - r * kChunks) * 4;
      const bool full = r0 + r < rows && k0 + c < kend;
      mma::cp_async16(dst + r * LD + c, full ? src + (r0 + r) * ld + k0 + c : src, full);
    }
  } else {
    constexpr int kChunks = ROWS / 4;
#pragma unroll
    for (int idx = threadIdx.x; idx < kBK * kChunks; idx += NT) {
      const int kk = idx / kChunks, c = (idx - kk * kChunks) * 4;
      const bool full = k0 + kk < kend && r0 + c < rows;
      mma::cp_async16(dst + kk * LD + c, full ? src + (k0 + kk) * ld + r0 + c : src, full);
    }
  }
}

template <int BM, int BN, bool kAT, bool kBT, bool kAct, bool kNearest>
__global__ void __launch_bounds__(128)
gemm_f32x3_kernel(int M, int N, int K, const float* __restrict__ a, long long lda,
                  const float* __restrict__ b, long long ldb, Epilogue ep, int kchunk) {
  constexpr int kThreads = 128;  // 2 x 2 warps
  constexpr int TM = BM / 2, TN = BN / 2, MI = TM / 16, NI = TN / 8;
  using SA = Slice<kAT, BM>;
  using SB = Slice<kBT, BN>;
  constexpr int kStage = SA::kElems + SB::kElems, LA = SA::kStride, LB = SB::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * TM, wn = (warp & 1) * TN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * kchunk, kend = min(K, kbeg + kchunk);
  const int n_slices = (kend - kbeg + kBK - 1) / kBK;

  auto issue = [&](int s) {  // slice s into stage s % kStages, one group
    if (s < n_slices) {
      float* st = ring + (s % kStages) * kStage;
      const int k0 = kbeg + s * kBK;
      load_slice<kAT, BM, kThreads>(a, lda, m0, M, k0, kend, st);
      load_slice<kBT, BN, kThreads>(b, ldb, n0, N, k0, kend, st + SA::kElems);
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
    // this lane's first element of the warp tile: row (or column) g, k 2t
    const float* as = ring + (s % kStages) * kStage +
                      (kAT ? 2 * t * LA + wm + g : (wm + g) * LA + 2 * t);
    const float* bs = ring + (s % kStages) * kStage + SA::kElems +
                      (kBT ? 2 * t * LB + wn + g : (wn + g) * LB + 2 * t);
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
      for (int j = 0; j < NI; ++j) {
        if constexpr (kBT) {
          const float* p = bs + kk * LB + 8 * j;
          bf[j] = split_b(make_float2(p[0], p[LB]));
        } else {
          bf[j] = split_b(*reinterpret_cast<const float2*>(bs + 8 * j * LB + kk));
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        if constexpr (kAT) {
          const float* p = as + kk * LA + 16 * i;
          af[i] = split_a(make_float2(p[0], p[LA]), make_float2(p[8], p[LA + 8]));
        } else {
          af[i] = split_a(*reinterpret_cast<const float2*>(as + 16 * i * LA + kk),
                          *reinterpret_cast<const float2*>(as + (16 * i + 8) * LA + kk));
        }
      }
      mma_x3<MI, NI, kNearest>(part, af, bf);
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
        if (ep.atomic) {
          atomicAdd(ep.out + o, v0);
          atomicAdd(ep.out + o + 1, v1);
          continue;
        }
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

template <int BM, int BN, bool kAT, bool kBT, bool kAct, bool kNearest>
cudaError_t launch(int M, int N, int K, const float* a, long long lda, const float* b,
                   long long ldb, const Epilogue& ep, int splits, cudaStream_t s) {
  constexpr size_t smem =
      sizeof(float) * kStages * (Slice<kAT, BM>::kElems + Slice<kBT, BN>::kElems);
  auto kernel = gemm_f32x3_kernel<BM, BN, kAT, kBT, kAct, kNearest>;
  LC2_TRY(allow_smem(kernel, smem));
  const int kchunk = ((K + splits - 1) / splits + kBK - 1) / kBK * kBK;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, (K + kchunk - 1) / kchunk);
  kernel<<<grid, 128, smem, s>>>(M, N, K, a, lda, b, ldb, ep, kchunk);
  return cudaGetLastError();
}

// C = A · B (+ the epilogue's terms) over M x N, K, the operands in the
// orientations kAT, kBT (above).  With ep.atomic the product is added into
// ep.out (zeroed by the caller), K split over blocks so that about four
// blocks an SM run even when the output has a handful of tiles.  kAct: the
// epilogue applies ep.act (and writes ep.out_pre); a separate instantiation,
// so the other products compile without it.  kNearest: every mma's products
// added in f32, round to nearest (the forward bodies' products, above).
template <bool kAT, bool kBT, bool kAct = false, bool kNearest = false>
cudaError_t product(int M, int N, int K, const float* a, long long lda, const float* b,
                    long long ldb, const Epilogue& ep, cudaStream_t s) {
  // the contiguous dimension of each operand: a multiple of 4
  if (M < 1 || N < 1 || K < 1 || N % 8 || (kAT ? M % 4 : K % 4) || (!kBT && K % 4) ||
      lda % 4 || ldb % 4 || ep.ldc % 2)
    return cudaErrorInvalidValue;
  if (ep.atomic) {
    const long long tiles = (long long)((M + 63) / 64) * ((N + 63) / 64);
    const long long want = (4 * 132 + tiles - 1) / tiles, most = (K + 255) / 256;
    const int splits = (int)(want < most ? want : most);
    return launch<64, 64, kAT, kBT, kAct, kNearest>(M, N, K, a, lda, b, ldb, ep, splits, s);
  }
  if ((long long)((M + 127) / 128) * ((N + 63) / 64) >= 240)  // about a wave, 2 blocks an SM
    return launch<128, 64, kAT, kBT, kAct, kNearest>(M, N, K, a, lda, b, ldb, ep, 1, s);
  return launch<64, 64, kAT, kBT, kAct, kNearest>(M, N, K, a, lda, b, ldb, ep, 1, s);
}

// C = A · Wᵀ (+ the epilogue's terms): A (M, K) and the torch-layout W (N, K),
// both K-contiguous.
template <bool kAct = false, bool kNearest = false>
cudaError_t gemm(int M, int N, int K, const float* a, long long lda, const float* b,
                 long long ldb, const Epilogue& ep, cudaStream_t s) {
  return product<false, false, kAct, kNearest>(M, N, K, a, lda, b, ldb, ep, s);
}

// out[n] += Σ_m a[m·lda + n] (out zeroed by the caller): a bias gradient,
// summed in f32.  Threads take consecutive columns; a block sums a chunk of
// rows and adds its partial with one atomic a column.
template <typename T>
__global__ void __launch_bounds__(256)
colsum_kernel(int M, int N, const T* __restrict__ a, long long lda, float* __restrict__ out,
              int rows) {
  const int m0 = blockIdx.y * rows, m1 = min(M, m0 + rows);
  const int n = blockIdx.x * 256 + threadIdx.x;
  if (n >= N) return;
  float s = 0.0f;
  for (int m = m0; m < m1; ++m) s += to_f(a[m * lda + n]);
  atomicAdd(out + n, s);
}

template <typename T>
cudaError_t colsum(int M, int N, const T* a, long long lda, float* out, cudaStream_t s) {
  const int cols = (N + 255) / 256;
  const int chunks = max(1, min((M + 63) / 64, 4 * 132 / cols));
  const int rows = (M + chunks - 1) / chunks;
  colsum_kernel<T><<<dim3(cols, (M + rows - 1) / rows), 256, 0, s>>>(M, N, a, lda, out, rows);
  return cudaGetLastError();
}

}  // namespace gemm32
}  // namespace lc2
