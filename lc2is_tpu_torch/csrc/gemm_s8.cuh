// An int8 tensor-core matrix product for the bf16 bodies of the int8 serving
// row (the decoder attention block's, csrc/attention_block.cu, TPU row 2q;
// the feed-forward's, csrc/fused_mlp_q.cu, row 17): acc = A · Bᵀ with s8
// operands and s32 accumulators, mma.sync m16n8k32, written by hand for
// sm_90a, and the row and weight passes that quantise its operands.
// gemm_bf16.cuh is its bf16 sibling; the two stay separate.
//
// Operands: A (M x K), element (m, k) at a[m · lda + k], and B (N x K), a
// torch-layout weight, element (n, k) at b[n · ldb + k]: both K-contiguous,
// because ldmatrix's .trans moves 16-bit elements and cannot transpose
// bytes, so there are no transposed variants.  K and the row strides are
// multiples of 16 (16-byte cp.async); M and N may be ragged (N even): rows
// past them load as zeros and are not stored.
//
// Design: gemm_bf16.cuh's, in bytes.  A block computes a 128 x 128 tile with
// 8 warps (2 along M x 4 along N, 64 x 32 each, 64 s32 accumulators a
// thread).  K advances in 64-byte slices through a 3-stage cp.async ring
// (slice t + 2 issued before slice t is computed, one barrier a slice), rows
// at a stride of 80 bytes (5 16-byte units, odd: the 8 rows of one ldmatrix
// fall in 8 distinct bank groups).  The m16n8k32 s8 A and B fragments have
// the layout of the bf16 m16n8k16 ones read as byte quadruples (a register
// holds 4 consecutive k bytes where bf16 holds 2 consecutive k elements), so
// ldmatrix.x4 without .trans on the slices gives them.
//
// The s8 x s8 sums are exact in s32, so the accumulators equal the TPU
// kernel's s32 product whatever the order; all the rounding lives in the
// epilogue, which takes v = dequant(acc, s_row[m], s_col[n], bias[n])
// (common.cuh: (acc · s_row) · s_col + bias, left to right, no FMA) and then,
// by the compile-time kMode (each instantiation compiles lean):
//   kStore:   [v = v + add[m, n], a bf16 addend, one rounded f32 add], stored
//             as f32 or rounded to bf16;
//   kActMax:  v = act(v) in f32 (activation.cuh); rowmax[m] = the max of |v|
//             over the row, an atomicMax on the bits of a non-negative float
//             (integer order is float order there): order-free, so
//             deterministic;
//   kActCode: v = act(v) in f32; the int8 code quant_code(v,
//             quant_scale(rowmax[m])) stored.
// kActMax and kActCode run the same activation code on the same
// accumulators, so the max the second reads is the max of exactly the
// values it quantises.  A block's row scales are read (and kActCode's
// quant_scale and its reciprocal computed) once into shared memory, the
// column scales and biases once a tile; kActCode stages its codes in
// shared memory and stores them as 16-byte rows (quads' 2-byte stores
// would each fill a quarter of a 32-byte sector).
#pragma once

#include "activation.cuh"
#include "common.cuh"
#include "mma_bf16.cuh"

namespace lc2 {
namespace s8 {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3, kThreads = 256;
constexpr int kLd = kBK + 16;          // bytes a slice row
constexpr int kSlice = kBM * kLd;      // bytes of one operand's slice (kBM == kBN)
constexpr int kStage = 2 * kSlice;     // A and B
constexpr int kCodeLd = kBN + 16;      // bytes a row of the kActCode staging tile

enum Mode { kStore = 0, kActMax = 1, kActCode = 2 };

// shared memory: the ring, [kActCode: the codes' staging tile,] the block's
// 128 row scales [kActCode: and the hidden scales and their reciprocals]
template <int kMode>
constexpr size_t smem_bytes() {
  return kStages * kStage + (kMode == kActCode ? kBM * kCodeLd + 3 * 4 * kBM : 4 * kBM);
}

// What the epilogue reads and writes; unused pointers are null.
struct Epilogue {
  const float* s_row;    // (M,) row scales; with row_absmax the rows' max |h|
  const float* s_col;    // (N,) column (weight output-channel) scales
  const float* bias;     // (N,) f32
  const bf16* add;       // kStore: (M, N) addend at row stride ldc, or null
  float* out_f32;        // kStore: the f32 result, or null
  bf16* out_bf16;        // kStore: the bf16 result when out_f32 is null
  float* rowmax;         // kActMax: (M,) max |act(v)|, zeroed by the caller; kActCode: read
  int8_t* out_s8;        // kActCode: the codes
  long long ldc;
  int act;               // kActMax / kActCode: the act::Act
  bool row_absmax;       // s_row holds max |h| of each row: its scale is quant_scale of it
};

// c += a · b (16x32 s8 times 32x8 s8, s32 accumulate).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [r0, r0 + 128) x bytes [k0, k0 + 64) of a K-contiguous operand into a
// slice; zeros past `rows` and past K.
__device__ __forceinline__ void load_slice(const int8_t* __restrict__ src, long long ld, int r0,
                                           int rows, int k0, int K, int8_t* dst) {
  constexpr int kChunks = kBK / 16;
#pragma unroll
  for (int idx = threadIdx.x; idx < kBM * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx - r * kChunks) * 16;
    const bool full = r0 + r < rows && k0 + c < K;
    mma::cp_async16(dst + r * kLd + c, full ? src + (r0 + r) * ld + k0 + c : src, full);
  }
}

// round-half-even(v / s), bit for bit as quant_code gives it (the IEEE
// quotient rounded to an integer), without a division on the common path:
// with rs = 1 / s correctly rounded, q = v · rs lies within 2e-5 of v / s
// for |v / s| <= 128 and the IEEE quotient within 4e-6 of it, so the two
// round to the same integer unless q lies within 1e-4 of a half-integer,
// where the division decides.  (The division's own slow path, which a zero
// dividend takes, made the codes pass twice as slow as the max pass.)
__device__ __forceinline__ int quant_code_rcp(float v, float rs, float s) {
  const float q = __fmul_rn(v, rs);
  const float r = rintf(q);
  if (fabsf(q - r) > 0.4999f) return quant_code(v, s);  // |q - r| <= 0.5 always
  return static_cast<int>(r);
}

// A block walks n-tiles [blockIdx.x · nt, + nt) of one 128-row m-tile: the
// slices of all its tiles form one sequence through the ring, so the next
// tile's first slices load while this tile's epilogue runs (the products at
// K = C = 96 to 512 are a few slices a tile).
template <int kMode>
__global__ void __launch_bounds__(kThreads, 2)
gemm_s8_kernel(int M, int N, int K, const int8_t* __restrict__ a, long long lda,
               const int8_t* __restrict__ b, long long ldb, Epilogue ep, int nt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * kBM;
  const int nt0 = blockIdx.x * nt, n_tiles = min(nt, (N + kBN - 1) / kBN - nt0);
  const int n_slices = (K + kBK - 1) / kBK, total = n_tiles * n_slices;
  // kActCode: the codes of a tile, staged so that they leave as 16-byte rows
  int8_t* code_tile = ring + kStages * kStage;
  // the block's rows' scales, once a block (the loop's first barrier publishes them)
  float* srow = reinterpret_cast<float*>(ring + kStages * kStage +
                                         (kMode == kActCode ? kBM * kCodeLd : 0));
  float* su_row = srow + kBM;   // kActCode: quant_scale(rowmax)
  float* rsu_row = su_row + kBM;  // kActCode: its reciprocal
  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    const int m = m0 + r;
    if (m >= M) continue;
    srow[r] = ep.row_absmax ? quant_scale(ep.s_row[m]) : ep.s_row[m];
    if constexpr (kMode == kActCode) {
      const float su = quant_scale(ep.rowmax[m]);
      su_row[r] = su;
      rsu_row[r] = __frcp_rn(su);
    }
  }

  auto issue = [&](int t) {  // slice t of the walk into stage t % kStages, one group
    if (t < total) {
      const int tile = t / n_slices, k0 = (t - tile * n_slices) * kBK;
      int8_t* st = ring + (t % kStages) * kStage;
      load_slice(a, lda, m0, M, k0, K, st);
      load_slice(b, ldb, (nt0 + tile) * kBN, N, k0, K, st + kSlice);
    }
    mma::cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  // ldmatrix row addresses: lanes 8q..8q+7 address matrix q's rows
  const int lr = lane & 7, l3 = (lane >> 3) & 1, l4 = lane >> 4;
  // lane's elements: rows g and g + 8 of each m-tile, columns c, c + 1 of each n-tile
  const int g = lane >> 2, c = 2 * (lane & 3);
  int s_in_tile = 0, tile = 0;
  for (int t = 0; t < total; ++t) {
    mma::cp_async_wait<kStages - 2>();  // slice t has landed (this thread's copies)
    __syncthreads();  // ... every thread's; and every warp is done with slice t - 1
    issue(t + kStages - 1);  // into slice t - 1's stage
    const int8_t* as = ring + (t % kStages) * kStage;
    const int8_t* bs = as + kSlice;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4], bfr[2][4];
      // A: rows 0-7 / 8-15 of the m-tile, bytes 0-15 / 16-31 of the k-step
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mma::ldsm_x4(af[i], as + (wm + 16 * i + lr + 8 * l3) * kLd + kk + 16 * l4);
      // B: bytes 0-15 / 16-31 of n rows 0-7, then of n rows 8-15
#pragma unroll
      for (int np = 0; np < 2; ++np)
        mma::ldsm_x4(bfr[np], bs + (wn + 16 * np + lr + 8 * l4) * kLd + kk + 16 * l3);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], af[i], bfr[j >> 1][2 * (j & 1)], bfr[j >> 1][2 * (j & 1) + 1]);
    }
    if (++s_in_tile < n_slices) continue;

    // the tile's epilogue, while the ring loads the next tile's first slices
    const int n0 = (nt0 + tile) * kBN;
    s_in_tile = 0;
    ++tile;
    float2 sc[4], bi[4];  // the lane's columns' scales and biases
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn + 8 * j + c;
      sc[j] = n < N ? *reinterpret_cast<const float2*>(ep.s_col + n) : make_float2(0.f, 0.f);
      bi[j] = n < N ? *reinterpret_cast<const float2*>(ep.bias + n) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int mr = wm + 16 * i + g + 8 * r, m = m0 + mr;
        const bool live = m < M;  // uniform over a lane quad
        const float sr = live ? srow[mr] : 1.0f;
        float mx = 0.0f, su = 1.0f, rsu = 1.0f;
        if constexpr (kMode == kActCode) {
          su = live ? su_row[mr] : 1.0f;
          rsu = live ? rsu_row[mr] : 1.0f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nc = wn + 8 * j + c, n = n0 + nc;
          if (!live || n >= N) continue;  // N is even: n + 1 < N too
          float v0 = dequant(static_cast<float>(acc[i][j][2 * r]), sr, sc[j].x, bi[j].x);
          float v1 = dequant(static_cast<float>(acc[i][j][2 * r + 1]), sr, sc[j].y, bi[j].y);
          const long long o = m * ep.ldc + n;
          if constexpr (kMode == kStore) {
            if (ep.add) {
              const float2 ad =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ep.add + o));
              v0 = __fadd_rn(v0, ad.x);
              v1 = __fadd_rn(v1, ad.y);
            }
            if (ep.out_f32)
              *reinterpret_cast<float2*>(ep.out_f32 + o) = make_float2(v0, v1);
            else
              *reinterpret_cast<uint32_t*>(ep.out_bf16 + o) = mma::pack_bf16(v0, v1);
          } else {
            v0 = act::activate(v0, ep.act);
            v1 = act::activate(v1, ep.act);
            if constexpr (kMode == kActMax) {
              mx = fmaxf(mx, fmaxf(fabsf(v0), fabsf(v1)));
            } else {
              *reinterpret_cast<char2*>(code_tile + mr * kCodeLd + nc) =
                  make_char2(static_cast<signed char>(quant_code_rcp(v0, rsu, su)),
                             static_cast<signed char>(quant_code_rcp(v1, rsu, su)));
            }
          }
        }
        if constexpr (kMode == kActMax) {  // the quad holds the warp's 32 columns of row m
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          if (live && (lane & 3) == 0)
            atomicMax(reinterpret_cast<int*>(ep.rowmax) + m, __float_as_int(mx));
        }
      }
    if constexpr (kMode == kActCode) {  // the staged codes out as 16-byte rows (N % 16 == 0)
      __syncthreads();
      for (int idx = threadIdx.x; idx < kBM * (kBN / 16); idx += kThreads) {
        const int r = idx / (kBN / 16), q = 16 * (idx - r * (kBN / 16));
        if (m0 + r < M && n0 + q < N)
          *reinterpret_cast<int4*>(ep.out_s8 + (m0 + r) * ep.ldc + n0 + q) =
              *reinterpret_cast<const int4*>(code_tile + r * kCodeLd + q);
      }
      // the next tile's epilogue writes the staging tile after the loop's next barrier
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
  }
  mma::cp_async_wait<0>();
}

// acc = A · Bᵀ over M x N, K, through the epilogue of kMode.  s_col and bias
// 8-byte aligned (read in column pairs).  A block walks up to 8 n-tiles of
// its m-tile, as many as leave at least two waves of blocks (264 run at
// once, two an SM).
template <int kMode>
cudaError_t gemm(int M, int N, int K, const int8_t* a, long long lda, const int8_t* b,
                 long long ldb, const Epilogue& ep, cudaStream_t s) {
  if (M < 1 || N < 1 || K < 1 || N % 2 || K % 16 || lda % 16 || ldb % 16 || ep.ldc % 2 ||
      reinterpret_cast<uintptr_t>(ep.s_col) % 8 || reinterpret_cast<uintptr_t>(ep.bias) % 8)
    return cudaErrorInvalidValue;
  if (kMode == kActCode &&  // 16-byte code rows
      (N % 16 || ep.ldc % 16 || reinterpret_cast<uintptr_t>(ep.out_s8) % 16))
    return cudaErrorInvalidValue;
  const long long m_tiles = (M + kBM - 1) / kBM, n_tiles = (N + kBN - 1) / kBN;
  int nt = 1;
  while (nt < 8 && nt < n_tiles && m_tiles * ((n_tiles + 2 * nt - 1) / (2 * nt)) >= 2 * 264)
    nt *= 2;
  auto kernel = gemm_s8_kernel<kMode>;
  constexpr size_t smem = smem_bytes<kMode>();
  LC2_TRY(allow_smem(kernel, smem));
  const dim3 grid((n_tiles + nt - 1) / nt, m_tiles);
  kernel<<<grid, kThreads, smem, s>>>(M, N, K, a, lda, b, ldb, ep, nt);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The row pass: A's codes.  One warp a row (lane l holds columns l + 32i), 8
// rows a 256-thread block, blocks striding over the rows.  v = the bf16 row
// widened, or with lnw its LayerNorm in f32 (two-pass statistics, f32
// weights, not rounded: the TPU kernel keeps the LN output in f32 until it
// is quantised); scale = quant_scale(max |v|), codes = quant_code(v, scale)
// (ops/quant.py::quant_act); zero[row] = 0 when zero is not null (the
// feed-forward's hidden row max, which kActMax raises).  Bytes-bound: a row
// read once, its codes and scale written once.
// ---------------------------------------------------------------------------

template <int CPL>
__global__ void __launch_bounds__(256)
quant_rows_kernel(const bf16* __restrict__ in, const float* __restrict__ lnw,
                  const float* __restrict__ lnb, int8_t* __restrict__ codes,
                  float* __restrict__ scales, float* __restrict__ zero, long long rows,
                  float eps) {
  constexpr int C = 32 * CPL;
  const int lane = threadIdx.x & 31;
  float wv[CPL], bv[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    wv[i] = lnw ? lnw[lane + 32 * i] : 1.0f;
    bv[i] = lnw ? lnb[lane + 32 * i] : 0.0f;
  }
  for (long long m = blockIdx.x * 8LL + (threadIdx.x >> 5); m < rows; m += gridDim.x * 8LL) {
    const bf16* r = in + m * C;
    float v[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) v[i] = __bfloat162float(r[lane + 32 * i]);
    if (lnw) {
      float a = 0.0f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) a += v[i];
      const float mu = warp_sum(a) / C;
      float q = 0.0f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) q += (v[i] - mu) * (v[i] - mu);
      const float rs = rsqrtf(warp_sum(q) / C + eps);
#pragma unroll
      for (int i = 0; i < CPL; ++i) v[i] = (v[i] - mu) * rs * wv[i] + bv[i];
    }
    float mx = 0.0f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) mx = fmaxf(mx, fabsf(v[i]));
    const float s = quant_scale(warp_max(mx)), rs = __frcp_rn(s);
#pragma unroll
    for (int i = 0; i < CPL; ++i)
      codes[m * C + lane + 32 * i] = static_cast<int8_t>(quant_code_rcp(v[i], rs, s));
    if (lane == 0) {
      scales[m] = s;
      if (zero) zero[m] = 0.0f;
    }
  }
}

template <int CPL>
inline cudaError_t launch_rows(const bf16* in, const float* lnw, const float* lnb, int8_t* codes,
                               float* scales, float* zero, long long rows, float eps,
                               cudaStream_t s) {
  const long long want = (rows + 7) / 8;
  const int blocks = (int)(want < 132LL * 16 ? (want > 0 ? want : 1) : 132LL * 16);
  quant_rows_kernel<CPL><<<blocks, 256, 0, s>>>(in, lnw, lnb, codes, scales, zero, rows, eps);
  return cudaGetLastError();
}

// codes, scales (and zero) of rows of C bf16 values, [LN with f32 weights
// lnw, lnb first]; C a multiple of 32 from 64 to 768.
inline cudaError_t quant_rows(const bf16* in, const float* lnw, const float* lnb, int8_t* codes,
                              float* scales, float* zero, long long rows, int C, float eps,
                              cudaStream_t s) {
  switch (C) {
    case 64: return launch_rows<2>(in, lnw, lnb, codes, scales, zero, rows, eps, s);
    case 96: return launch_rows<3>(in, lnw, lnb, codes, scales, zero, rows, eps, s);
    case 128: return launch_rows<4>(in, lnw, lnb, codes, scales, zero, rows, eps, s);
    case 192: return launch_rows<6>(in, lnw, lnb, codes, scales, zero, rows, eps, s);
    case 256: return launch_rows<8>(in, lnw, lnb, codes, scales, zero, rows, eps, s);
    case 384: return launch_rows<12>(in, lnw, lnb, codes, scales, zero, rows, eps, s);
    case 512: return launch_rows<16>(in, lnw, lnb, codes, scales, zero, rows, eps, s);
    case 768: return launch_rows<24>(in, lnw, lnb, codes, scales, zero, rows, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The weight pass: the rows (output channels) of two f32 weights, W (N x K)
// each, into int8 codes and f32 scales, as ops/quant.py::quantize_weight
// gives them (scale = quant_scale(max |w_row|), codes = quant_code(w,
// scale), bit for bit), one launch for both weights of a call, so that a
// call runs no torch op to quantise them.  One warp a row, 8 rows a
// 256-thread block, blocks striding over the rows of both; K a multiple of
// 4 and rows 16-byte aligned (float4 loads).  Bytes-bound: a weight read
// twice (max, then codes; the second from L2), its codes written once.
// ---------------------------------------------------------------------------

struct WeightRows {
  const float* w;
  int8_t* codes;
  float* scales;
  int rows, K;
};

// static: a kernel that is no template, in a header several sources include
static __global__ void __launch_bounds__(256)
quant_weights_kernel(WeightRows w0, WeightRows w1) {
  const int lane = threadIdx.x & 31;
  const long long total = (long long)w0.rows + w1.rows;
  for (long long r = blockIdx.x * 8LL + (threadIdx.x >> 5); r < total; r += gridDim.x * 8LL) {
    const bool first = r < w0.rows;
    const long long row = first ? r : r - w0.rows;
    const int K = first ? w0.K : w1.K, k4 = K / 4;
    const float4* src = reinterpret_cast<const float4*>((first ? w0.w : w1.w) + row * K);
    char4* dst = reinterpret_cast<char4*>((first ? w0.codes : w1.codes) + row * K);
    float mx = 0.0f;
    for (int k = lane; k < k4; k += 32) {
      const float4 v = src[k];
      mx = fmaxf(mx, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
    }
    const float s = quant_scale(warp_max(mx)), rs = __frcp_rn(s);
    for (int k = lane; k < k4; k += 32) {
      const float4 v = src[k];
      dst[k] = make_char4(static_cast<signed char>(quant_code_rcp(v.x, rs, s)),
                          static_cast<signed char>(quant_code_rcp(v.y, rs, s)),
                          static_cast<signed char>(quant_code_rcp(v.z, rs, s)),
                          static_cast<signed char>(quant_code_rcp(v.w, rs, s)));
    }
    if (lane == 0) (first ? w0.scales : w1.scales)[row] = s;
  }
}

inline cudaError_t quant_weights(const WeightRows& w0, const WeightRows& w1, cudaStream_t s) {
  auto bad = [](const WeightRows& w) {
    return w.rows < 1 || w.K < 4 || w.K % 4 || reinterpret_cast<uintptr_t>(w.w) % 16 ||
           reinterpret_cast<uintptr_t>(w.codes) % 4;
  };
  if (bad(w0) || bad(w1)) return cudaErrorInvalidValue;
  const long long want = ((long long)w0.rows + w1.rows + 7) / 8;
  const int blocks = (int)(want < 132LL * 16 ? want : 132LL * 16);
  quant_weights_kernel<<<blocks, 256, 0, s>>>(w0, w1);
  return cudaGetLastError();
}

// Bytes of n int8 codes or floats rounded up to a 16-byte boundary: the
// workspaces put each region on one, as the 16-byte cp.async loads need.
__host__ __device__ constexpr long long align16(long long bytes) { return (bytes + 15) / 16 * 16; }

}  // namespace s8
}  // namespace lc2
