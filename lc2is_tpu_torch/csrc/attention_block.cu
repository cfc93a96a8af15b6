// fused_attn_block: one post-norm attention half of a decoder layer,
//
//   out = LN(x + Wo · MHA(Wq · x + bq, K, V) + bo)
//
// with K/V already projected (B, L, C) and 1/sqrt(dh) folded into Wq/bq by
// the wrapper.  Replaces the TPU kernel
// lc2is_tpu/ops/attention_block.py::_kernel (:37, entry fused_attn_block :220).
//
// What bounds it on the card: arithmetic.  The q and out projections are
// 2·C² multiply-adds per token and the attention 2·L·C.
//
// bf16 body (attn_block_bf16): every product on the tensor cores, four
// launches.  Steps 1-3 are csrc/attn_block_fwd.cuh, the code the backward
// (csrc/attention_block_bwd.cu) recomputes the forward with: q = round(x ·
// Wqᵀ + bq) on the mma.sync GEMM of gemm_bf16.cuh; the FlashAttention-2-style
// core attn_fwd_mma (64 query rows a block, 64-key tiles through a cp.async
// ring, p rounded per tile, O scaled by 1/l and rounded), writing the head
// outputs over q's rows in the workspace; s = att · Woᵀ + bo + x in f32 on the
// GEMM; then 4. LayerNorm of s with f32 statistics, rounded
// (layer_norm.cuh).  The workspace (the wrapper allocates it,
// lc2_attn_block_fwd_workspace_bf16) holds q / att in bf16 and s in f32.
//
// f32 body (attn_block_f32): every product on the tensor cores in 3xTF32
// (gemm_f32x3.cuh: each product three TF32 mma.sync products, f32-accurate),
// four or five launches.  The FTN prompt decoders run it under bf16 (their
// queries are the f32 text): 151 queries over up to 16,384 keys, which
// give a grid of images x heads too small to fill the card unless the keys
// are cut into ranges.
//   1. q = x · Wqᵀ + bq on the 3xTF32 GEMM (1/√dh folded into Wq, bq);
//   2. the attention core attn_core_f32: a block owns one (image, head, key
//      range) and all of that head's query rows up to 160 (10 warps, 16 rows
//      each; more rows: query tiles of 128), so each K/V byte is read from
//      device memory once; 64-key K and V tiles stream through a 4-stage
//      cp.async ring and are split once a block in shared memory (not
//      again by each of the 10 warps that read them); S = Q ·
//      Kᵀ and O += P · V in 3xTF32 with Q and P split in registers; the
//      online softmax in f32 with the row max subtracted, in log2 units.
//      Key ranges are cut so that a call fills two waves of the 132 SMs
//      (CorePlan); with one range (enough query tiles, heads and images to
//      fill the card alone) the core writes O / l over q;
//   3. with several ranges, attn_merge_f32 merges each range's (m, l, O) in
//      range order and writes the normalised head outputs over q;
//   4. s = att · Woᵀ + bo + x in f32 on the GEMM; 5. LayerNorm of s with f32
//      statistics (layer_norm.cuh).
// Workspace (lc2_attn_block_fwd_workspace_f32, the wrapper allocates it): q
// (then the head outputs), s, the ranges' partials.
// Heads <= 8, dh in {16, 32, 64}, C in {64, 128, 256, 512}.
//
// lc2_attn_block_q is the int8 serving variant, the quant=True branch of the
// TPU kernel (attention_block.py:38-96, forward only): int8 q- and
// out-projections, the attention itself the float branch's, rounded to the
// dtype where the TPU kernel rounds.
// - bf16 (attn_block_q_bf16), seven launches on the tensor cores: 0. the
//   weight pass of gemm_s8.cuh, Wq (folded) and Wo, handed over in f32, into
//   per-output-channel codes and scales (ops/quant.py::quantize_weight, bit
//   for bit), so the call runs no torch op for them; 1. the row pass of
//   gemm_s8.cuh, x -> codes and row scales; 2. the mma.sync s8 GEMM
//   (gemm_s8.cuh), q = round(dequant(x codes · Wqᵀ codes) + bq); 3. the
//   attention core attn_fwd_mma of attn_block_fwd.cuh, unchanged, the head
//   outputs over q (its flash order rounds the unnormalised p where the TPU
//   kernel normalises first, as in the bf16 body above); 4. the row pass on
//   the head outputs; 5. the GEMM again, s = dequant(att codes · Woᵀ codes)
//   + bo + x in f32; 6. the LayerNorm pass (layer_norm.cuh).  Workspace
//   (lc2_attn_block_q_workspace_bf16, the wrapper allocates it): s in f32,
//   whose first half q / att occupies until step 5 overwrites it, the codes,
//   the row scales, and the weights' codes and scales.
// - f32 (the control): attn_block_q_kernel on the CUDA cores, one block a
//   tile of 32 query rows with all C channels (the out-projection and the
//   LayerNorm need every head of a row): x tile and its codes, q = dequant(x
//   codes · Wq codes) + bq in shared memory; warp h takes head h and lane r
//   query row r, an online softmax over 16-key K/V tiles; the head outputs
//   quantised, the out-projection, residual and LayerNorm.
#include <math_constants.h>

#include "attn_block_fwd.cuh"
#include "attn_core_f32.cuh"
#include "common.cuh"
#include "gemm_s8.cuh"
#include "layer_norm.cuh"

namespace lc2 {
namespace {

constexpr int kBQ = 32;  // query rows per block (one per lane)
constexpr int kBK = 16;  // keys per shared-memory tile
constexpr int kKT = 16;  // K tile of the projections
constexpr int kThreads = 256;
constexpr int kRows = 4;  // projection rows per warp

// acc[i][j] = Σ_k A[4w+i][k] · W[lane+32j][k] over k < C; A in shared memory
// (row stride lda), W (C, C) int8 codes in device memory, staged through wt
// in tiles.
template <int NJ>
__device__ __forceinline__ void project(const float* A, int lda, const int8_t* __restrict__ W,
                                        float* wt, float (&acc)[kRows][NJ]) {
  constexpr int C = NJ * 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < C; k0 += kKT) {
    __syncthreads();
    for (int idx = tid; idx < C * kKT; idx += kThreads) {
      const int c = idx / kKT, kk = idx - c * kKT;
      wt[c * (kKT + 1) + kk] = to_f(W[(size_t)c * C + k0 + kk]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKT; ++kk) {
      float a[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = A[(warp * kRows + i) * lda + k0 + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float w = wt[(lane + 32 * j) * (kKT + 1) + kk];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] += a[i] * w;
      }
    }
  }
}

// Rows 4w..4w+3 (warp w) of src, f32: each row's int8 scale into sc[r] and
// its codes, as f32 integers, into dst (dst may be src).
template <int NJ>
__device__ __forceinline__ void quantize_rows(const float* src, int lds, float* dst, int ldd,
                                              float* sc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp * kRows + i;
    float v[NJ], m = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      v[j] = src[r * lds + lane + 32 * j];
      m = fmaxf(m, fabsf(v[j]));
    }
    const float s = quant_scale(warp_max(m));
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dst[r * ldd + lane + 32 * j] = static_cast<float>(quant_code(v[j], s));
    if (lane == 0) sc[r] = s;
  }
}

// floats of the K/V-or-weight-tile region
template <int C>
__host__ __device__ constexpr int kv_floats() {
  return (2 * kBK * C > C * (kKT + 1)) ? 2 * kBK * C : C * (kKT + 1);
}

// The int8 serving variant's f32 block (the quant=True branch of the TPU
// kernel, attention_block.py:38-96): wq, wo hold per-output-channel codes
// with scales wqs, wos (C,), and x and the head outputs are quantised per row
// right before their projections (common.cuh: quant_scale / quant_code /
// dequant).  The products stay on the CUDA cores: each sums integer-valued
// f32 products, exact while |acc| < 2^24 (C·127² <= 8.3e6 at C <= 512), so
// the f32 sum equals the TPU's s32 one.
template <int NJ, int DH>
__global__ void __launch_bounds__(kThreads, 1)
attn_block_q_kernel(const float* __restrict__ x, const float* __restrict__ k,
                    const float* __restrict__ v, const int8_t* __restrict__ wq,
                    const float* __restrict__ wqs, const float* __restrict__ bq,
                    const int8_t* __restrict__ wo, const float* __restrict__ wos,
                    const float* __restrict__ bo, const float* __restrict__ lnw,
                    const float* __restrict__ lnb, float* __restrict__ out, int P, int L,
                    int heads, float eps) {
  constexpr int C = NJ * 32;
  constexpr int LDQ = C + 4;  // keeps float4 rows 16-byte aligned, spreads banks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [kBQ][C]   x tile
  float* qs = xs + kBQ * C;                          // [kBQ][LDQ] q, then head outputs
  float* kv = qs + kBQ * LDQ;                        // K/V tiles, or a weight tile
  float* ks = kv;                                    // [kBK][C]
  float* vs = kv + kBK * C;                          // [kBK][C]
  float* rsc = kv + kv_floats<C>();                  // [kBQ] int8 row scales

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, p0 = blockIdx.x * kBQ;
  const float* xb = x + (size_t)b * P * C;

  for (int idx = tid; idx < kBQ * C; idx += kThreads) {
    const int r = idx / C, c = idx - r * C;
    xs[idx] = p0 + r < P ? xb[(size_t)(p0 + r) * C + c] : 0.0f;
  }

  float acc[kRows][NJ];
  __syncthreads();  // the x tile is complete
  quantize_rows<NJ>(xs, C, qs, LDQ, rsc);
  project<NJ>(qs, LDQ, wq, kv, acc);
  __syncthreads();  // every warp done reading the codes before q overwrites them
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp * kRows + i;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      qs[r * LDQ + c] = dequant(acc[i][j], rsc[r], wqs[c], bq[c]);
    }
  }
  __syncthreads();

  // ---- attention: warp = head, lane = query row; online softmax over K/V ----
  const int h = warp;
  float qr[DH], o[DH];
  float m = -CUDART_INF_F, l = 0.0f;
  if (h < heads) {
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      const float4 q4 = *reinterpret_cast<const float4*>(qs + lane * LDQ + h * DH + d);
      qr[d] = q4.x; qr[d + 1] = q4.y; qr[d + 2] = q4.z; qr[d + 3] = q4.w;
      o[d] = o[d + 1] = o[d + 2] = o[d + 3] = 0.0f;
    }
  }
  const float* kb = k + (size_t)b * L * C;
  const float* vb = v + (size_t)b * L * C;
  for (int j0 = 0; j0 < L; j0 += kBK) {
    __syncthreads();  // previous tile consumed
    for (int idx = tid; idx < kBK * C; idx += kThreads) {
      const int j = idx / C, c = idx - j * C;
      const bool in = j0 + j < L;
      ks[idx] = in ? kb[(size_t)(j0 + j) * C + c] : 0.0f;
      vs[idx] = in ? vb[(size_t)(j0 + j) * C + c] : 0.0f;
    }
    __syncthreads();
    if (h < heads) {
      const int nk = min(kBK, L - j0);
      float s[kBK];
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        float a = 0.0f;
        const float* kr = ks + j * C + h * DH;
#pragma unroll
        for (int d = 0; d < DH; d += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
          a += qr[d] * k4.x + qr[d + 1] * k4.y + qr[d + 2] * k4.z + qr[d + 3] * k4.w;
        }
        s[j] = j < nk ? a : -CUDART_INF_F;
        tmax = fmaxf(tmax, s[j]);
      }
      const float m_new = fmaxf(m, tmax);
      const float corr = __expf(m - m_new);  // 0 on the first tile (m = -inf)
      l *= corr;
#pragma unroll
      for (int d = 0; d < DH; ++d) o[d] *= corr;
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        const float pj = __expf(s[j] - m_new);  // 0 for keys past L
        l += pj;
        const float* vr = vs + j * C + h * DH;
#pragma unroll
        for (int d = 0; d < DH; d += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(vr + d);
          o[d] += pj * v4.x; o[d + 1] += pj * v4.y; o[d + 2] += pj * v4.z; o[d + 3] += pj * v4.w;
        }
      }
      m = m_new;
    }
  }
  if (h < heads) {
    const float inv = 1.0f / l;
#pragma unroll
    for (int d = 0; d < DH; ++d) qs[lane * LDQ + h * DH + d] = o[d] * inv;
  }
  __syncthreads();

  // ---- out-projection + residual + LayerNorm ----
  quantize_rows<NJ>(qs, LDQ, qs, LDQ, rsc);  // a warp's own rows, in place
  project<NJ>(qs, LDQ, wo, kv, acc);
  float* ob = out + (size_t)b * P * C;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp * kRows + i;
    if (p0 + r >= P) continue;  // warp-uniform
    float s[NJ];
    float a = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      s[j] = __fadd_rn(dequant(acc[i][j], rsc[r], wos[c], bo[c]), xs[r * C + c]);
      a += s[j];
    }
    const float mean = warp_sum(a) / C;
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) q += (s[j] - mean) * (s[j] - mean);
    const float rstd = rsqrtf(warp_sum(q) / C + eps);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      ob[(size_t)(p0 + r) * C + c] = (s[j] - mean) * rstd * lnw[c] + lnb[c];
    }
  }
}

struct AttnArgs {
  const void *x, *k, *v, *wq, *wqs, *bq, *wo, *wos, *bo, *lnw, *lnb;
  void* out;
  int B, P, L, heads;
  float eps;
};

template <int NJ, int DH>
cudaError_t launch_q(const AttnArgs& a, cudaStream_t stream) {
  constexpr int C = NJ * 32;
  const size_t smem = sizeof(float) * (kBQ * C + kBQ * (C + 4) + kv_floats<C>() + kBQ);
  auto kernel = attn_block_q_kernel<NJ, DH>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.P + kBQ - 1) / kBQ, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const int8_t*>(a.wq),
      static_cast<const float*>(a.wqs), static_cast<const float*>(a.bq),
      static_cast<const int8_t*>(a.wo), static_cast<const float*>(a.wos),
      static_cast<const float*>(a.bo), static_cast<const float*>(a.lnw),
      static_cast<const float*>(a.lnb), static_cast<float*>(a.out), a.P, a.L, a.heads, a.eps);
  return cudaGetLastError();
}

template <int DH>
cudaError_t dispatch_q_c(int C, const AttnArgs& a, cudaStream_t stream) {
  switch (C) {
    case 64:
      return launch_q<2, DH>(a, stream);
    case 128:
      return launch_q<4, DH>(a, stream);
    case 256:
      return launch_q<8, DH>(a, stream);
    case 512:
      return launch_q<16, DH>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The int8 variant's f32 block.
cudaError_t attn_block_q_f32(const AttnArgs& a, int C, cudaStream_t s) {
  if (a.L < 1 || a.heads < 1 || a.heads > 8 || C % a.heads != 0) return cudaErrorInvalidValue;
  switch (C / a.heads) {
    case 16:
      return dispatch_q_c<16>(C, a, s);
    case 32:
      return dispatch_q_c<32>(C, a, s);
    case 64:
      return dispatch_q_c<64>(C, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The f32 body, steps 1-5.  ws: q / att (B·P, C), s (B·P, C), the partials.
cudaError_t attn_block_f32(const AttnArgs& a, int C, void* ws, cudaStream_t st) {
  using gemm32::Epilogue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const int rows = a.B * a.P;
  float* q = static_cast<float*>(ws);
  float* s = q + (long long)rows * C;
  float* part = s + (long long)rows * C;
  LC2_TRY((gemm32::gemm<false, true>(rows, C, C, f(a.x), C, f(a.wq), C,
                                     Epilogue{f(a.bq), nullptr, q, C}, st)));
  switch (C / a.heads) {
    case 16: LC2_TRY((attn_core_launch<16, false, true>(q, f(a.k), f(a.v), q, nullptr, part, a.B,
                                                        a.P, a.L, C, a.heads, st))); break;
    case 32: LC2_TRY((attn_core_launch<32, false, true>(q, f(a.k), f(a.v), q, nullptr, part, a.B,
                                                        a.P, a.L, C, a.heads, st))); break;
    case 64: LC2_TRY((attn_core_launch<64, false, true>(q, f(a.k), f(a.v), q, nullptr, part, a.B,
                                                        a.P, a.L, C, a.heads, st))); break;
    default: return cudaErrorInvalidValue;
  }
  LC2_TRY((gemm32::gemm<false, true>(rows, C, C, q, C, f(a.wo), C,
                                     Epilogue{f(a.bo), f(a.x), s, C}, st)));
  return ln::layer_norm(s, f(a.lnw), f(a.lnb), static_cast<float*>(a.out), rows, C, a.eps, st);
}

// The bf16 body: steps 1-3 (attn_block_fwd.cuh), then the LayerNorm of s.
cudaError_t attn_block_bf16(const AttnArgs& a, int C, void* ws, cudaStream_t st) {
  using bf = __nv_bfloat16;
  auto t = [](const void* p) { return static_cast<const bf*>(p); };
  bf* q = static_cast<bf*>(ws);
  float* s = reinterpret_cast<float*>(q + (long long)a.B * a.P * C);
  LC2_TRY(attn_block_fwd_bf16(t(a.x), t(a.k), t(a.v), t(a.wq), static_cast<const float*>(a.bq),
                              t(a.wo), static_cast<const float*>(a.bo), q, q, nullptr, s, a.B,
                              a.P, a.L, C, a.heads, st));
  return ln::layer_norm(s, t(a.lnw), t(a.lnb), static_cast<bf*>(a.out), (long long)a.B * a.P, C,
                        a.eps, st);
}

// The int8 bf16 body's workspace, byte offsets: s (f32, q and the head
// outputs in its first half until then), the codes, the row scales, Wq's and
// Wo's codes and scales.
struct QWorkspace {
  long long s, codes, scales, wqq, woq, wqs, wos, bytes;
  QWorkspace(long long rows, long long C) {
    s = 0;
    codes = s8::align16(4 * rows * C);
    scales = codes + s8::align16(rows * C);
    wqq = scales + s8::align16(4 * rows);
    woq = wqq + s8::align16(C * C);
    wqs = woq + s8::align16(C * C);
    wos = wqs + s8::align16(4 * C);
    bytes = wos + s8::align16(4 * C);
  }
};

// The int8 bf16 body: steps 1-6 above.  bq, bo f32 holding bf16 values.
cudaError_t attn_block_q_bf16(const AttnArgs& a, int C, void* ws, cudaStream_t st) {
  using bf = __nv_bfloat16;
  auto t = [](const void* p) { return static_cast<const bf*>(p); };
  const long long rows = (long long)a.B * a.P;
  const QWorkspace lay(rows, C);
  unsigned char* base = static_cast<unsigned char*>(ws);
  float* s = reinterpret_cast<float*>(base + lay.s);
  bf* q = reinterpret_cast<bf*>(base + lay.s);
  int8_t* codes = reinterpret_cast<int8_t*>(base + lay.codes);
  float* sc = reinterpret_cast<float*>(base + lay.scales);
  int8_t* wq = reinterpret_cast<int8_t*>(base + lay.wqq);
  int8_t* wo = reinterpret_cast<int8_t*>(base + lay.woq);
  float* wqs = reinterpret_cast<float*>(base + lay.wqs);
  float* wos = reinterpret_cast<float*>(base + lay.wos);
  LC2_TRY(s8::quant_weights(s8::WeightRows{static_cast<const float*>(a.wq), wq, wqs, C, C},
                            s8::WeightRows{static_cast<const float*>(a.wo), wo, wos, C, C}, st));
  const float* no_ln = nullptr;  // the row passes take no LayerNorm
  LC2_TRY(s8::quant_rows(t(a.x), no_ln, no_ln, codes, sc, nullptr, rows, C, 0.0f, st));
  LC2_TRY(s8::gemm<s8::kStore>(
      rows, C, C, codes, C, wq, C,
      s8::Epilogue{sc, wqs, static_cast<const float*>(a.bq), nullptr, nullptr, q, nullptr,
                   nullptr, C, -1, false},
      st));
  switch (C / a.heads) {
    case 16: LC2_TRY(attn_fwd_launch<16>(q, t(a.k), t(a.v), q, nullptr, a.B, a.P, a.L, C,
                                         a.heads, st)); break;
    case 32: LC2_TRY(attn_fwd_launch<32>(q, t(a.k), t(a.v), q, nullptr, a.B, a.P, a.L, C,
                                         a.heads, st)); break;
    case 64: LC2_TRY(attn_fwd_launch<64>(q, t(a.k), t(a.v), q, nullptr, a.B, a.P, a.L, C,
                                         a.heads, st)); break;
    default: return cudaErrorInvalidValue;
  }
  LC2_TRY(s8::quant_rows(q, no_ln, no_ln, codes, sc, nullptr, rows, C, 0.0f, st));
  LC2_TRY(s8::gemm<s8::kStore>(
      rows, C, C, codes, C, wo, C,
      s8::Epilogue{sc, wos, static_cast<const float*>(a.bo), t(a.x), s, nullptr, nullptr,
                   nullptr, C, -1, false},
      st));
  return ln::layer_norm(s, t(a.lnw), t(a.lnb), static_cast<bf*>(a.out), rows, C, a.eps, st);
}

}  // namespace
}  // namespace lc2

// x (B, P, C); k, v (B, L, C); wq, wo (C, C) torch layout; lnw, lnb (C,), all
// of the dtype; bq, bo (C,) f32 (holding bf16 values in bf16: the TPU kernel
// adds the bias of its dtype in f32).  ws: lc2_attn_block_fwd_workspace_bf16
// (bf16) or lc2_attn_block_fwd_workspace_f32 (f32) floats.  Every operand
// 16-byte aligned and contiguous.  C in {64, 128, 256, 512}; heads <= 8 with
// C / heads in {16, 32, 64}; L >= 1.
extern "C" int lc2_attn_block(int dtype, const void* x, const void* k, const void* v,
                              const void* wq, const void* bq, const void* wo,
                              const void* bo, const void* lnw, const void* lnb, void* out,
                              void* ws, int B, int P, int L, int C, int heads, float eps,
                              void* stream) {
  const lc2::AttnArgs a{x, k, v, wq, nullptr, bq, wo, nullptr, bo, lnw, lnb, out, B, P, L,
                        heads, eps};
  if (B < 1 || P < 1 || L < 1 || heads < 1 || heads > 8 || C % heads ||
      (C != 64 && C != 128 && C != 256 && C != 512) || ws == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lc2::kBF16) return lc2::attn_block_bf16(a, C, ws, s);
  if (dtype != lc2::kF32) return cudaErrorInvalidValue;
  return lc2::attn_block_f32(a, C, ws, s);
}

// The int8 variant.  f32: wq, wo (C, C) int8 codes with f32
// per-output-channel scales wqs, wos (C,); ws null.  bf16: wq (1/√dh folded,
// rounded to its dtype) and wo the float weights in f32, 16-byte aligned
// (the body quantises them), wqs, wos null; ws lc2_attn_block_q_workspace_bf16
// floats, 16-byte aligned.  bq, bo (C,) f32 (holding bf16 values in bf16);
// everything else as lc2_attn_block.
extern "C" int lc2_attn_block_q(int dtype, const void* x, const void* k, const void* v,
                                const void* wq, const void* wqs, const void* bq,
                                const void* wo, const void* wos, const void* bo,
                                const void* lnw, const void* lnb, void* out, void* ws, int B,
                                int P, int L, int C, int heads, float eps, void* stream) {
  const lc2::AttnArgs a{x, k, v, wq, wqs, bq, wo, wos, bo, lnw, lnb, out, B, P, L, heads, eps};
  if (dtype == lc2::kF32) return lc2::attn_block_q_f32(a, C, static_cast<cudaStream_t>(stream));
  if (dtype != lc2::kBF16) return cudaErrorInvalidValue;
  if (B < 1 || P < 1 || L < 1 || heads < 1 || heads > 8 || C % heads ||
      (C != 64 && C != 128 && C != 256 && C != 512) || ws == nullptr)
    return cudaErrorInvalidValue;
  return lc2::attn_block_q_bf16(a, C, ws, static_cast<cudaStream_t>(stream));
}

// Workspace floats of the int8 bf16 body: s (B·P, C) f32, whose first half
// holds q and then the head outputs in bf16 before s overwrites them; the
// codes (B·P, C) int8 and the row scales (B·P,) f32; Wq's and Wo's codes
// (C, C) int8 and scales (C,) f32; each region 16-byte aligned.
extern "C" long long lc2_attn_block_q_workspace_bf16(int B, int P, int L, int C, int heads) {
  return (lc2::QWorkspace((long long)B * P, C).bytes + 3) / 4;
}

// Workspace floats of the bf16 body: q, whose rows the head outputs
// overwrite, in bf16 and s in f32, B·P·C of each.
extern "C" long long lc2_attn_block_fwd_workspace_bf16(int B, int P, int L, int C, int heads) {
  const long long n = (long long)B * P * C;
  return (n + 1) / 2 + n;
}

// Workspace floats of the f32 body: q (whose rows the head outputs
// overwrite) and s, B·P·C of each, then the key ranges' partials (none when
// the call takes one range).
extern "C" long long lc2_attn_block_fwd_workspace_f32(int B, int P, int L, int C, int heads) {
  const long long n = (long long)B * P * C;
  return 2 * n + lc2::CorePlan(B, P, L, heads).partial_floats(B, P, C, heads);
}
