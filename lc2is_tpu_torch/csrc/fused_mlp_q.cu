// fused_mlp_q: the int8 twin of fused_mlp,
//
//   pre  (swin block):    out = [x +] W2q ⊙ act(W1q ⊙ LN(x) + b1) + b2
//   post (decoder layer): out = LN([x +] W2q ⊙ act(W1q ⊙ x + b1) + b2)
//
// where A ⊙ Wq is lc2is_tpu/ops/quant.py::qdot: A quantised per row to int8,
// an s8 x s8 product summed exactly in s32, dequantised (acc · s_row) · s_col
// in f32.  LN output and activation stay in f32 until quantised; LN
// statistics, LN weights, biases and the epilogue are f32.  Replaces the TPU
// kernel lc2is_tpu/ops/quant.py::_mlp_q_kernel (:70, entry fused_mlp_q :94).
//
// What bounds it on the card: operations.  Per token 2·C·4C int8
// multiply-adds against 2·C·bytes of token traffic (the weights are int8 and
// L2-resident), far above the line at C >= 96 even at the int8 rate.
//
// The trouble is the second product's row scale: it needs the max of the
// f32 activated hidden row over all of F before any code of that row exists.
//
// bf16 body (fused_mlp_q_bf16): the products on the tensor cores, on the
// mma.sync s8 GEMM of gemm_s8.cuh, the hidden recomputed rather than stored
// (route B: a T·F byte round trip of codes, against T·F·10 bytes for an f32
// hidden written, read, quantised and read again; 2·T·C·F more int8
// operations, cheaper while the GEMM runs above about C · 0.84 TOPS):
//   0. the weight pass (gemm_s8.cuh): W1 and W2, handed over in f32, into
//      per-output-channel codes and scales (ops/quant.py::quantize_weight,
//      bit for bit), one launch, so the call runs no torch op for them;
//   1. the row pass (gemm_s8.cuh): LN of x in f32 with f32 weights (pre) or
//      x (post), its row scale and int8 codes; zeroes the hidden row max;
//   2. GEMM x codes · W1qᵀ, epilogue kActMax: act(dequant + b1) in f32, the
//      hidden row max |u| by atomicMax (order-free, deterministic);
//   3. the same GEMM again, epilogue kActCode: the hidden codes, (T, F) int8;
//   4. GEMM hidden codes · W2qᵀ, epilogue kStore: dequant + b2 (the row
//      scale quant_scale of the row max), the residual added as the
//      reference adds it; pre: the rounded output; post: f32 s;
//   5. post: the LayerNorm pass (layer_norm.cuh) with f32 weights.
// Both weights stay in torch layout (N, K), K-contiguous as the GEMM reads
// them.  The workspace (lc2_fused_mlp_q_workspace_bf16, allocated by the
// wrapper) holds the x codes (under s in post), the hidden codes, the
// weights' codes, the x row scales, the hidden row maxima and the weights'
// scales.
//
// f32 body (the control), one pass over the tokens: the second product's
// row scale forces a block to keep the whole f32 hidden of its BM = 16 rows
// in shared memory (16 x 3072 x 4 = 197 KB at C = 768, one block an SM).
//   1. a warp per row: LN (pre) in f32, the row's scale, its int8 codes;
//   2. W1 product on the tensor cores (WMMA s8 16x16x16, s32 accumulators),
//      one 16-column tile of F at a time per warp, each tile's epilogue
//      (dequantise, + b1, activation) in place in the f32 hidden;
//   3. each hidden row's scale; its codes are made 64 columns at a time into
//      a small staging tile, and the W2 product accumulates over them;
//   4. the s32 results pass through shared memory to a warp per row for
//      dequantisation, + b2, the residual and the post-LN.
// Both weights arrive as [K/16][N][16] panels (ops/quant.py::k_panels), so
// every WMMA tile is a 256-byte-aligned 16 x 16 block with ldm 16.
#include <mma.h>

#include "common.cuh"
#include "gemm_s8.cuh"
#include "layer_norm.cuh"

namespace lc2 {
namespace {

constexpr int kBM = 16;        // token rows per block
constexpr int kThreads = 256;  // 8 warps, 2 rows each in the row passes
constexpr int kFC = 64;        // hidden columns quantised per W2 step
constexpr int kMaxF = 3072;

enum Act { kRelu = 0, kGeluErf = 1, kGeluPoly = 2 };

__device__ __forceinline__ float gelu_poly(float x) {
  // lc2is_tpu/ops/fused_mlp.py:62-86, the bf16 policy (as csrc/fused_mlp.cu)
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

// (x - mean) · rstd · w + b over a warp's row, the lane's columns lane + 32j
template <int NJ>
__device__ __forceinline__ void layer_norm(float (&v)[NJ], const float* __restrict__ w,
                                           const float* __restrict__ b, float eps) {
  constexpr int C = NJ * 32;
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) s += v[j];
  const float mean = warp_sum(s) / C;
  float q = 0.0f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) q += (v[j] - mean) * (v[j] - mean);
  const float rstd = rsqrtf(warp_sum(q) / C + eps);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = lane + 32 * j;
    v[j] = (v[j] - mean) * rstd * w[c] + b[c];
  }
}

// index of element (row, k) in [K/16][kBM][16] panels
__device__ __forceinline__ int panel_at(int row, int k) {
  return (k >> 4) * (kBM * 16) + row * 16 + (k & 15);
}

template <int C>
struct Layout {
  // f32 [kBM][F + 4]; later the s32 [kBM][C + 4] results
  __host__ __device__ static size_t hidden_bytes(int F) {
    return (sizeof(float) * kBM * ((F > C ? F : C) + 4) + 127) / 128 * 128;
  }
  static constexpr size_t kXq = kBM * C;    // int8 input codes, panels
  static constexpr size_t kUq = kBM * kFC;  // int8 hidden codes of one step, panels
  __host__ __device__ static size_t bytes(int F) {
    return hidden_bytes(F) + kXq + kUq + 2 * sizeof(float) * kBM;
  }
};

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_q_kernel(const T* __restrict__ x, const float* __restrict__ lnw,
                   const float* __restrict__ lnb, const int8_t* __restrict__ w1p,
                   const float* __restrict__ w1s, const float* __restrict__ b1,
                   const int8_t* __restrict__ w2p, const float* __restrict__ w2s,
                   const float* __restrict__ b2, T* __restrict__ out, int n_tok, int F, int act,
                   int pre, int residual, float eps) {
  using namespace nvcuda;
  constexpr int C = NJ * 32;
  using L = Layout<C>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldh = F + 4;
  float* hs = reinterpret_cast<float*>(smem_raw);  // [kBM][ldh] f32 hidden
  int* hi = reinterpret_cast<int*>(smem_raw);      // the same region as s32
  signed char* xq = reinterpret_cast<signed char*>(smem_raw + L::hidden_bytes(F));
  signed char* uq = xq + L::kXq;
  float* sx = reinterpret_cast<float*>(uq + L::kUq);  // [kBM] input row scales
  float* su = sx + kBM;                               // [kBM] hidden row scales

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kBM;

  // 1. FF input rows: LN (pre) or x (post), in f32; scale and codes
  for (int i = 0; i < kBM / 8; ++i) {
    const int r = warp * (kBM / 8) + i, g = row0 + r;
    float v[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      v[j] = g < n_tok ? to_f(x[(size_t)g * C + lane + 32 * j]) : 0.0f;
    if (pre) layer_norm<NJ>(v, lnw, lnb, eps);
    float m = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) m = fmaxf(m, fabsf(v[j]));
    const float s = quant_scale(warp_max(m));
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      xq[panel_at(r, lane + 32 * j)] = static_cast<signed char>(quant_code(v[j], s));
    if (lane == 0) sx[r] = s;
  }
  __syncthreads();

  // 2. hidden = act(dequant(xq ⊙ W1) + b1), one 16-column tile per warp step
  for (int n0 = warp * 16; n0 < F; n0 += 8 * 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
    wmma::fill_fragment(acc, 0);
    wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b;
#pragma unroll 4
    for (int kp = 0; kp < C / 16; ++kp) {
      wmma::load_matrix_sync(a, xq + kp * kBM * 16, 16);
      // B[k][n] = W1q[n0 + n][16kp + k]
      wmma::load_matrix_sync(b, w1p + ((size_t)kp * F + n0) * 16, 16);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(hi + n0, acc, ldh, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 16 * 16; e += 32) {
      const int r = e >> 4, f = n0 + (e & 15);
      const float u = dequant(static_cast<float>(hi[r * ldh + f]), sx[r], w1s[f], b1[f]);
      hs[r * ldh + f] = activate(u, act);
    }
  }
  __syncthreads();

  // 3. hidden row scales, then out = hidden codes ⊙ W2, 64 hidden columns a step
  for (int i = 0; i < kBM / 8; ++i) {
    const int r = warp * (kBM / 8) + i;
    float m = 0.0f;
    for (int f = lane; f < F; f += 32) m = fmaxf(m, fabsf(hs[r * ldh + f]));
    m = warp_max(m);
    if (lane == 0) su[r] = quant_scale(m);
  }
  constexpr int kTiles = C / 16;                   // 16-column output tiles
  constexpr int kPerWarp = (kTiles + 7) / 8;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> yacc[kPerWarp];
#pragma unroll
  for (int t = 0; t < kPerWarp; ++t) wmma::fill_fragment(yacc[t], 0);
  for (int f0 = 0; f0 < F; f0 += kFC) {
    __syncthreads();  // su written / previous step's codes consumed
    for (int e = tid; e < kBM * kFC; e += kThreads) {
      const int r = e / kFC, f = e - r * kFC;
      uq[panel_at(r, f)] = static_cast<signed char>(quant_code(hs[r * ldh + f0 + f], su[r]));
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kPerWarp; ++t) {
      const int tile = warp + 8 * t;
      if (tile < kTiles) {  // warp-uniform
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b;
#pragma unroll
        for (int kp = 0; kp < kFC / 16; ++kp) {
          wmma::load_matrix_sync(a, uq + kp * kBM * 16, 16);
          // B[k][n] = W2q[16·tile + n][f0 + 16kp + k]
          wmma::load_matrix_sync(b, w2p + ((size_t)(f0 / 16 + kp) * C + tile * 16) * 16, 16);
          wmma::mma_sync(yacc[t], a, b, yacc[t]);
        }
      }
    }
  }
  __syncthreads();  // every warp done with the hidden: its region takes the s32 results
#pragma unroll
  for (int t = 0; t < kPerWarp; ++t) {
    const int tile = warp + 8 * t;
    if (tile < kTiles)
      wmma::store_matrix_sync(hi + tile * 16, yacc[t], C + 4, wmma::mem_row_major);
  }
  __syncthreads();

  // 4. dequantise, + b2, residual, post-LN; a warp per row
  for (int i = 0; i < kBM / 8; ++i) {
    const int r = warp * (kBM / 8) + i, g = row0 + r;
    if (g >= n_tok) break;  // warp-uniform
    float v[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      const float y = dequant(static_cast<float>(hi[r * (C + 4) + c]), su[r], w2s[c], b2[c]);
      v[j] = residual ? __fadd_rn(to_f(x[(size_t)g * C + c]), y) : y;
    }
    if (!pre) layer_norm<NJ>(v, lnw, lnb, eps);
#pragma unroll
    for (int j = 0; j < NJ; ++j) out[(size_t)g * C + lane + 32 * j] = from_f<T>(v[j]);
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* x, const float* lnw, const float* lnb, const void* w1p,
                   const float* w1s, const float* b1, const void* w2p, const float* w2s,
                   const float* b2, void* out, int n_tok, int F, int act, int pre, int residual,
                   float eps, cudaStream_t stream) {
  const size_t smem = Layout<NJ * 32>::bytes(F);
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = fused_mlp_q_kernel<T, NJ>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_tok + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), lnw, lnb, static_cast<const int8_t*>(w1p), w1s, b1,
      static_cast<const int8_t*>(w2p), w2s, b2, static_cast<T*>(out), n_tok, F, act, pre,
      residual, eps);
  return cudaGetLastError();
}

// The bf16 body's workspace, byte offsets of its regions: the x codes (under
// s, f32, in post), the hidden codes, W1's and W2's codes, the x row scales,
// the hidden row maxima, W1's and W2's scales.
struct QWorkspace {
  long long xq, hq, w1q, w2q, sx, hmax, w1s, w2s, bytes;
  QWorkspace(long long n_tok, long long C, long long F, int pre) {
    xq = 0;
    hq = s8::align16(n_tok * C * (pre ? 1 : 4));
    w1q = hq + s8::align16(n_tok * F);
    w2q = w1q + s8::align16(F * C);
    sx = w2q + s8::align16(C * F);
    hmax = sx + s8::align16(4 * n_tok);
    w1s = hmax + s8::align16(4 * n_tok);
    w2s = w1s + s8::align16(4 * F);
    bytes = w2s + s8::align16(4 * C);
  }
};

cudaError_t fused_mlp_q_bf16(const __nv_bfloat16* x, const float* lnw, const float* lnb,
                             const float* w1f, const float* b1, const float* w2f,
                             const float* b2, __nv_bfloat16* out, void* ws, int n_tok, int C,
                             int F, int act, int pre, int residual, float eps, cudaStream_t st) {
  const QWorkspace lay(n_tok, C, F, pre);
  unsigned char* base = static_cast<unsigned char*>(ws);
  int8_t* xq = reinterpret_cast<int8_t*>(base + lay.xq);
  int8_t* hq = reinterpret_cast<int8_t*>(base + lay.hq);
  int8_t* w1 = reinterpret_cast<int8_t*>(base + lay.w1q);
  int8_t* w2 = reinterpret_cast<int8_t*>(base + lay.w2q);
  float* sx = reinterpret_cast<float*>(base + lay.sx);
  float* hmax = reinterpret_cast<float*>(base + lay.hmax);
  float* w1s = reinterpret_cast<float*>(base + lay.w1s);
  float* w2s = reinterpret_cast<float*>(base + lay.w2s);
  LC2_TRY(s8::quant_weights(s8::WeightRows{w1f, w1, w1s, F, C}, s8::WeightRows{w2f, w2, w2s, C, F},
                            st));
  LC2_TRY(s8::quant_rows(x, pre ? lnw : nullptr, pre ? lnb : nullptr, xq, sx, hmax, n_tok, C, eps,
                         st));
  s8::Epilogue up{sx, w1s, b1, nullptr, nullptr, nullptr, hmax, nullptr, F, act, false};
  LC2_TRY(s8::gemm<s8::kActMax>(n_tok, F, C, xq, C, w1, C, up, st));
  up.out_s8 = hq;
  LC2_TRY(s8::gemm<s8::kActCode>(n_tok, F, C, xq, C, w1, C, up, st));
  float* s = reinterpret_cast<float*>(base + lay.xq);  // the x codes are dead by now
  s8::Epilogue down{hmax, w2s, b2, residual ? x : nullptr, pre ? nullptr : s, pre ? out : nullptr,
                    nullptr, nullptr, C, -1, true};
  LC2_TRY(s8::gemm<s8::kStore>(n_tok, C, F, hq, F, w2, F, down, st));
  if (pre) return cudaSuccess;
  return ln::layer_norm(s, lnw, lnb, out, n_tok, C, eps, st);
}

}  // namespace
}  // namespace lc2

// x, out (n_tok, C) in dtype; lnw, lnb, b2 (C,), b1 (F,) f32.  f32: w1, w2
// the quantised W1 (F, C) and W2 (C, F), int8, as [C/16][F][16] and
// [F/16][C][16] panels, with their scales w1s (F,), w2s (C,); ws null.
// bf16: w1, w2 the float W1 and W2 in f32, torch layout, 16-byte aligned
// (the body quantises them), w1s, w2s null; ws lc2_fused_mlp_q_workspace_bf16
// floats, 16-byte aligned.  C in {96, 128, 192, 256, 384, 512, 768}; f32 F
// % 64 == 0 and F <= 3072, bf16 F % 16 == 0.  act: 0 relu, 1 erf-gelu, 2
// polynomial gelu.
extern "C" int lc2_fused_mlp_q(int dtype, const void* x, const void* lnw, const void* lnb,
                               const void* w1, const void* w1s, const void* b1,
                               const void* w2, const void* w2s, const void* b2, void* out,
                               void* ws, int n_tok, int C, int F, int act, int pre, int residual,
                               float eps, void* stream) {
  if (n_tok < 1 || act < 0 || act > 2) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_lnw = static_cast<const float*>(lnw);
  const float* f_lnb = static_cast<const float*>(lnb);
  const float* f_w1s = static_cast<const float*>(w1s);
  const float* f_b1 = static_cast<const float*>(b1);
  const float* f_w2s = static_cast<const float*>(w2s);
  const float* f_b2 = static_cast<const float*>(b2);
  if (dtype == lc2::kBF16) {
    if (F < 16 || F % 16 || C < 96 || C > 768 || C % 32 || ws == nullptr)
      return cudaErrorInvalidValue;
    using bf = __nv_bfloat16;
    return lc2::fused_mlp_q_bf16(static_cast<const bf*>(x), f_lnw, f_lnb,
                                 static_cast<const float*>(w1), f_b1,
                                 static_cast<const float*>(w2), f_b2, static_cast<bf*>(out), ws,
                                 n_tok, C, F, act, pre, residual, eps, s);
  }
  if (dtype != lc2::kF32 || F % lc2::kFC != 0 || F > lc2::kMaxF) return cudaErrorInvalidValue;
#define LC2_MLPQ_CASE(NJ)                                                                 \
  case NJ * 32:                                                                           \
    return lc2::launch<float, NJ>(x, f_lnw, f_lnb, w1, f_w1s, f_b1, w2, f_w2s, f_b2, out, \
                                  n_tok, F, act, pre, residual, eps, s);
  switch (C) {
    LC2_MLPQ_CASE(3)
    LC2_MLPQ_CASE(4)
    LC2_MLPQ_CASE(6)
    LC2_MLPQ_CASE(8)
    LC2_MLPQ_CASE(12)
    LC2_MLPQ_CASE(16)
    LC2_MLPQ_CASE(24)
    default:
      return cudaErrorInvalidValue;
  }
#undef LC2_MLPQ_CASE
}

// Workspace floats of the bf16 body: the x codes (n_tok, C) int8, which s
// (n_tok, C) f32 overwrites in post; the hidden codes (n_tok, F) int8; W1's
// and W2's codes (F·C int8 each); the x row scales and the hidden row maxima
// (n_tok,) f32; W1's (F,) and W2's (C,) scales; each region 16-byte aligned.
extern "C" long long lc2_fused_mlp_q_workspace_bf16(int n_tok, int C, int F, int pre) {
  return (lc2::QWorkspace(n_tok, C, F, pre).bytes + 3) / 4;
}
