// fused_attn_block_bwd: the backward of one post-norm attention half of a
// decoder layer (csrc/attention_block.cu),
//
//   out = LN(x + Wo · MHA(Wq · x + bq, K, V) + bo)
//
// with K/V already projected and 1/√dh folded into Wq/bq by the wrapper.
// Replaces the TPU kernel lc2is_tpu/ops/attention_block.py::_bwd_kernel
// (:264, launched by _bwd_pallas :362).  Returns dx, dK, dV, dWq, dbq, dWo, dbo,
// dln_w, dln_b; dK and dV are sums over the P queries of each image.
//
// What bounds it on the card: arithmetic.  Per query row the q and out
// projections and their gradients are 6·C² multiply-adds, the attention
// recompute and backward 7·L·C (L keys: 64 … 1024 on the main path).
//
// Both bodies run the same sequence of launches; the TPU kernel's (T, L)
// logits and whole-image dK/dV accumulators live in VMEM, here they are
// recomputed per tile instead:
//   1. q = x·Wqᵀ + bq (rounded to T, as the forward);
//   2. attention forward recompute per (64-query tile, head, image): online
//      max-subtracted softmax over 64-key tiles, O (rounded to T) and the
//      row log-sum-exp;
//   3. s = O·Woᵀ + bo + x (f32), then the post-LN backward per row: the LN
//      statistics recomputed from s, ds, and dln_w / dln_b summed per block;
//   4. dWo = dsᵀ·O, dbo = Σ ds, dO = ds·Wo, D = rowsum(dO∘O) per head;
//   5. dQ per (query tile, head, image) looping over key tiles, and dK, dV
//      per (key tile, head, image) looping over all query tiles of the image
//      (no atomics: each block owns its keys' sums), P recomputed from the
//      log-sum-exp in both;
//   6. dWq = dQᵀ·x, dbq = Σ dQ, dx = dQ·Wq + ds.
//
// f32 body: every product on the tensor cores in 3xTF32 (each product three
// TF32 mma.sync products, f32-accurate; no rounding below f32 anywhere),
// f32 intermediates in the workspace.  The six C x C products are
// csrc/gemm_f32x3.cuh: q and s as the forward's (A · Wᵀ), dO and dx as
// dY · W (W read N-contiguous), dWo and dWq as dYᵀ · X (both operands
// staged as they lie, K = B·P split over blocks with f32 atomics).  The
// recompute's attention core is the forward's (csrc/attn_core_f32.cuh, key
// ranges merged), which also writes each row's log-sum-exp, with each
// 8-key group's P · V summed fresh (kFresh) so that O does not drift.  The backward
// core follows the bf16 body's dataflow (delta first; a dq kernel and a
// dk/dv kernel of 4 warps, each warp's own 16 rows in registers, 64-row
// tiles of the other operands through a two-stage cp.async ring), with every
// product three TF32 products: p and ds split into hi/lo halves where a C
// fragment becomes the next product's A fragment; each streamed tile's
// sums into fresh accumulators, added to the running sums in f32.  dbo sums
// in the post-LN pass, dbq in the dq kernel.
//
// bf16 body: every product on the tensor cores (mma.sync m16n8k16, f32
// accumulators), rounding where _bwd_kernel rounds (:290-358) and keeping
// f32 where it does:
// - bf16: x, k, v, g as given; Wq, Wo (the wrapper's f32 values are bf16
//   values, so narrowing them is exact); q; O (att); p for P·V and dV; ds for
//   dWo and dO (dsb); dO (datt); the score gradient for dq and dk (dlogb);
//   dq for dWq and dx (dqb);
// - f32: s and the post-LN backward; ds where it feeds dbo and dx's residual
//   term; dq where it feeds dbq (the dq kernel sums its own f32 rows into
//   dbq before rounding them); the score gradients and their row sums.
// The six C x C products are csrc/gemm_bf16.cuh (128 x 128 tiles, 3-stage
// cp.async ring, ldmatrix): the two weight gradients, over K = B·P tokens,
// split K over blocks and add with f32 atomics (dbq's and dbo's sums too),
// so their last bits vary from run to run.  The attention core at dh 16, 32
// or 64 is three FlashAttention-2-style kernels of 4 warps, each owning 16
// rows whose operands stay in registers as mma fragments (attn_tiles.cuh,
// shared with csrc/flash_attention*.cu): a two-stage cp.async ring streams
// 64-row tiles of the other operands straight from the strided (B, n, C)
// matrices (row stride C, head offset h·dh, no transpose pass); scores stay
// in registers, exp2 with log2 e folded in, p and ds rounded to bf16 into the
// A fragments of the next products; one barrier a tile.  The recompute
// (steps 1-3) is the forward kernel's own code, csrc/attn_block_fwd.cuh: it
// rounds p per key tile and scales O by 1/l at the end (the flash kernels'
// order; JAX normalises before rounding: the two differ by bf16 rounding).
// Intermediates stay bf16 in the workspace except s/ds, the lse and delta.
#include <math.h>
#include <math_constants.h>

#include <type_traits>

#include "attn_block_fwd.cuh"
#include "attn_core_f32.cuh"

namespace lc2 {
namespace {

// ===========================================================================
// shared by both bodies
// ===========================================================================

inline int elementwise_blocks(long long n) {
  const long long want = (n + 255) / 256;
  return (int)(want < 132LL * 16 ? (want > 0 ? want : 1) : 132LL * 16);
}

// Post-LN backward from s = x + proj (f32) in place: s becomes ds (f32: dx's
// residual term), in the bf16 body also dsb = ds rounded to bf16 (the
// operand of dWo and dO; null in the f32 body), and dln_w, dln_b and dbo =
// Σ ds summed per block; a warp per row (grid-stride), lane owning columns
// lane + 32i (CPL = C / 32 of them, in registers); g in T.
template <typename T, int CPL>
__global__ void __launch_bounds__(256)
post_ln_bwd(float* __restrict__ s, const T* __restrict__ g, const float* __restrict__ lnw,
            bf16* __restrict__ dsb, float* __restrict__ dlnw, float* __restrict__ dlnb,
            float* __restrict__ dbo, long long rows, float eps) {
  constexpr int C = 32 * CPL;
  __shared__ float red[3 * C];
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x; c < 3 * C; c += 256) red[c] = 0.0f;
  float pw[CPL], pb[CPL], po[CPL], w[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    pw[i] = pb[i] = po[i] = 0.0f;
    w[i] = lnw[lane + 32 * i];
  }
  for (long long m = blockIdx.x * 8LL + (threadIdx.x >> 5); m < rows; m += gridDim.x * 8LL) {
    float* sr = s + m * C;
    float sv[CPL], dy[CPL];
    float a = 0.0f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      sv[i] = sr[lane + 32 * i];
      dy[i] = to_f(g[m * C + lane + 32 * i]);
      a += sv[i];
    }
    const float mu = warp_sum(a) / C;
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) q += (sv[i] - mu) * (sv[i] - mu);
    const float rs = rsqrtf(warp_sum(q) / C + eps);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      sv[i] = (sv[i] - mu) * rs;  // ŝ
      const float dsh = dy[i] * w[i];
      s1 += dsh;
      s2 += dsh * sv[i];
      pw[i] += dy[i] * sv[i];
      pb[i] += dy[i];
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const float ds = rs * (dy[i] * w[i] - s1 - sv[i] * s2);
      po[i] += ds;
      sr[lane + 32 * i] = ds;
      if (dsb) dsb[m * C + lane + 32 * i] = __float2bfloat16(ds);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    atomicAdd(red + lane + 32 * i, pw[i]);
    atomicAdd(red + C + lane + 32 * i, pb[i]);
    atomicAdd(red + 2 * C + lane + 32 * i, po[i]);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += 256) {
    atomicAdd(dlnw + c, red[c]);
    atomicAdd(dlnb + c, red[C + c]);
    atomicAdd(dbo + c, red[2 * C + c]);
  }
}

template <typename T>
cudaError_t post_ln(float* sd, const T* g, const float* lnw, bf16* dsb, float* dlnw, float* dlnb,
                    float* dbo, long long rows, int C, float eps, cudaStream_t s) {
  const long long want = (rows + 7) / 8;
  const int blocks = (int)(want < 4 * 132 ? want : 4 * 132);
  switch (C) {
    case 64: post_ln_bwd<T, 2><<<blocks, 256, 0, s>>>(sd, g, lnw, dsb, dlnw, dlnb, dbo, rows, eps); break;
    case 128: post_ln_bwd<T, 4><<<blocks, 256, 0, s>>>(sd, g, lnw, dsb, dlnw, dlnb, dbo, rows, eps); break;
    case 256: post_ln_bwd<T, 8><<<blocks, 256, 0, s>>>(sd, g, lnw, dsb, dlnw, dlnb, dbo, rows, eps); break;
    case 512: post_ln_bwd<T, 16><<<blocks, 256, 0, s>>>(sd, g, lnw, dsb, dlnw, dlnb, dbo, rows, eps); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ===========================================================================
// f32 body: 3xTF32 on the tensor cores, f32 intermediates in the workspace
// ===========================================================================

constexpr int kX3Rows = 64;     // query (dq) or key (dk, dv) rows a block owns: 4 warps x 16
constexpr int kX3Cols = 64;     // rows of a streamed tile
constexpr int kX3Threads = 128;

// Shared memory of the two f32 attention kernels: a two-stage ring, each
// stage two streamed 64-row tiles at row stride DH + 4 floats (a lane's
// 4-byte loads of rows 2t and 2t + 1, column g, fall in distinct banks) and
// the streamed rows' lse and delta (dk/dv kernel); then the dq kernel's
// column sums (4 warps x DH) or the dk/dv kernel's running sums (DH floats a
// thread, thread-major so that a warp's accesses are conflict-free).
template <int DH>
struct X3Layout {
  static constexpr int kLd = DH + 4;
  static constexpr int kTile = kX3Cols * kLd;
  static constexpr int kStage = 2 * kTile + 2 * kX3Cols;
  static constexpr size_t kDqBytes = sizeof(float) * (2 * kStage + 4 * DH);
  static constexpr size_t kKvBytes = sizeof(float) * (2 * kStage + kX3Threads * DH);
};

// Rows r0 .. r0 + 63 of head h's DH columns of a (n, C) f32 matrix (src at
// the image's row 0 and the head's column 0) into a tile at row stride
// DH + 4, zeros past row n; cp.async by the block's 128 threads.
template <int DH>
__device__ __forceinline__ void x3_load_rows(const float* __restrict__ src, int r0, int n, int C,
                                             float* dst) {
  constexpr int kChunks = DH / 4, LD = X3Layout<DH>::kLd;
#pragma unroll
  for (int idx = threadIdx.x; idx < kX3Cols * kChunks; idx += kX3Threads) {
    const int r = idx / kChunks, c = (idx - r * kChunks) * 4;
    const bool full = r0 + r < n;
    mma::cp_async16(dst + r * LD + c, full ? src + (size_t)(r0 + r) * C + c : src, full);
  }
}

// A warp's own 16 rows r0 .. r0 + 15 (zero past n) as the raw A fragments of
// a product over DH: f[kc][0] row r0 + g, f[kc][1] row r0 + g + 8, columns
// 8kc + 2t and 2t + 1 (the GEMM's k order); split where they are used.
template <int DH>
__device__ __forceinline__ void x3_own_rows(const float* __restrict__ src, int r0, int n, int C,
                                            int lane, float2 (&f)[DH / 8][2]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    const float* p = src + (size_t)row * C + 2 * t;
#pragma unroll
    for (int kc = 0; kc < DH / 8; ++kc)
      f[kc][r] = row < n ? *reinterpret_cast<const float2*>(p + 8 * kc) : make_float2(0.0f, 0.0f);
  }
}

// s[j] += A(16 rows) · X[row0 + 8j + g]ᵀ and d[j] += B(16 rows) · Y[...]ᵀ over
// DH, j = 0, 1: the scores of 16 streamed rows (X, Y tiles) against the
// warp's own A and B fragments, in 3xTF32.
template <int DH>
__device__ __forceinline__ void x3_scores(const float2 (&a)[DH / 8][2], const float2 (&bb)[DH / 8][2],
                                          const float* xs, const float* ys, int row0, int lane,
                                          float (&s)[2][4], float (&d)[2][4]) {
  constexpr int LD = X3Layout<DH>::kLd;
  const int o = (row0 + (lane >> 2)) * LD + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = d[j][e] = 0.0f;
#pragma unroll
  for (int kc = 0; kc < DH / 8; ++kc) {
    gemm32::mma_x3_bt<2, LD>(s, gemm32::split_a(a[kc][0], a[kc][1]), xs + o + 8 * kc);
    gemm32::mma_x3_bt<2, LD>(d, gemm32::split_a(bb[kc][0], bb[kc][1]), ys + o + 8 * kc);
  }
}

// dq = Σ_keys ds · k with p = 2^(q·kᵀ·log2 e − lse) and ds = p ∘ (dO · vᵀ −
// delta), every product in 3xTF32; grid (P tiles, heads, B).  Warp w owns
// query rows 16w .. 16w + 15 of the block's 64 (their q and dO fragments in
// registers); 64-key K and V tiles stream through a two-stage cp.async ring,
// 16 keys at a time.  Each key tile's dq sums into fresh accumulators, added
// to the running sums in f32 (the GEMM's accuracy measure).  Writes dq and
// adds the block's column sums of it into dbq.
template <int DH>
__global__ void __launch_bounds__(kX3Threads, 2)
attn_dq_x3(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ dO, const float* __restrict__ lse,
           const float* __restrict__ delta, float* __restrict__ dq, float* __restrict__ dbq,
           int P, int L, int C) {
  using Lay = X3Layout<DH>;
  constexpr int KC = DH / 8, NO = DH / 8, G = NO < 4 ? NO : 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  float* red = ring + 2 * Lay::kStage;  // [4 warps][DH]
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y, p0 = blockIdx.x * kX3Rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n_tiles = (L + kX3Cols - 1) / kX3Cols;
  const float* kb = k + (size_t)b * L * C + h * DH;
  const float* vb = v + (size_t)b * L * C + h * DH;
  auto issue = [&](int i) {  // key tile i into stage i % 2, one group
    if (i < n_tiles) {
      float* ks = ring + (i & 1) * Lay::kStage;
      x3_load_rows<DH>(kb, i * kX3Cols, L, C, ks);
      x3_load_rows<DH>(vb, i * kX3Cols, L, C, ks + Lay::kTile);
    }
    mma::cp_async_commit();
  };
  issue(0);

  const int r0 = p0 + 16 * warp;
  const bool live = r0 < P;
  float2 qa[KC][2], ga[KC][2];
  x3_own_rows<DH>(q + (size_t)b * P * C + h * DH, r0, P, C, lane, qa);
  x3_own_rows<DH>(dO + (size_t)b * P * C + h * DH, r0, P, C, lane, ga);
  const size_t stat0 = ((size_t)b * heads + h) * P;
  float lse2[2], dl[2];  // rows g and g + 8: lse (log2 units; −∞ past P) and delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    lse2[r] = row < P ? lse[stat0 + row] : -INFINITY;
    dl[r] = row < P ? delta[stat0 + row] : 0.0f;
  }
  float acc[NO / G][G][4];
#pragma unroll
  for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
    for (int j = 0; j < G; ++j) acc[jg][j][0] = acc[jg][j][1] = acc[jg][j][2] = acc[jg][j][3] = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    mma::cp_async_wait<0>();
    __syncthreads();  // tile i is in place; every warp is done with tile i - 1
    issue(i + 1);     // into tile i - 1's stage
    if (!live) continue;
    const float* ks = ring + (i & 1) * Lay::kStage;
    const float* vs = ks + Lay::kTile;
    const int key0 = i * kX3Cols;
    float part[NO / G][G][4];  // this tile's dq
#pragma unroll
    for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
      for (int j = 0; j < G; ++j)
        part[jg][j][0] = part[jg][j][1] = part[jg][j][2] = part[jg][j][3] = 0.0f;
#pragma unroll
    for (int c16 = 0; c16 < kX3Cols / 16; ++c16) {
      if (key0 + 16 * c16 >= L) break;  // warp-uniform
      float s[2][4], dp[2][4];  // q · kᵀ and dO · vᵀ over keys 16c .. 16c + 15
      x3_scores<DH>(qa, ga, ks, vs, 16 * c16, lane, s, dp);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool on = key0 + 16 * c16 + 8 * j + 2 * t + (e & 1) < L && lse2[r] != -INFINITY;
          const float p = on ? mma::exp2_approx(fmaf(s[j][e], mma::kLog2e, -lse2[r])) : 0.0f;
          dp[j][e] = on ? p * (dp[j][e] - dl[r]) : 0.0f;  // ds
        }
#pragma unroll
      for (int j = 0; j < 2; ++j)  // dq += ds · k
        gemm32::mma_x3_rows<DH, G, Lay::kLd>(part, dp[j], ks + (16 * c16 + 8 * j) * Lay::kLd,
                                             lane);
    }
#pragma unroll
    for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jg][j][e] += part[jg][j][e];
  }
  // dbq: the column sums of the block's dq rows (0 past P), per warp over its
  // 16 rows (lanes of one column differ in g), then over the 4 warps in shared
  // memory, one atomic a column
#pragma unroll
  for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float cs = acc[jg][j][e] + acc[jg][j][2 + e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) cs += __shfl_xor_sync(0xffffffffu, cs, o);
        if (lane < 4) red[warp * DH + 8 * (G * jg + j) + 2 * t + e] = cs;
      }
  __syncthreads();
  if (threadIdx.x < DH)
    atomicAdd(dbq + h * DH + threadIdx.x, red[threadIdx.x] + red[DH + threadIdx.x] +
                                              red[2 * DH + threadIdx.x] + red[3 * DH + threadIdx.x]);
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= P) continue;
    float* dst = dq + ((size_t)b * P + row) * C + h * DH + 2 * t;
#pragma unroll
    for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
      for (int j = 0; j < G; ++j)
        *reinterpret_cast<float2*>(dst + 8 * (G * jg + j)) =
            make_float2(acc[jg][j][2 * r], acc[jg][j][2 * r + 1]);
  }
}

// dk = Σ_queries dsᵀ · q and dv = Σ_queries pᵀ · dO, every product in 3xTF32;
// grid (L tiles, heads, B).  Warp w owns key rows 16w .. 16w + 15 (their k
// and v fragments in registers) and computes sᵀ = k · qᵀ and (dO · vᵀ)ᵀ =
// v · dOᵀ for them over streamed 64-query tiles of q and dO (with their lse
// and delta), 16 queries at a time.  Each query tile sums into fresh
// accumulators, added in f32 to running sums a thread keeps in shared
// memory.  Each block owns its keys' sums: no atomics.
template <int DH>
__global__ void __launch_bounds__(kX3Threads, 2)
attn_dkdv_x3(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int P, int L, int C) {
  using Lay = X3Layout<DH>;
  constexpr int KC = DH / 8, NO = DH / 8, G = NO < 4 ? NO : 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  // this thread's DH running sums, element e at sums[e · 128]: dv's DH / 2, then dk's
  float* sums = ring + 2 * Lay::kStage + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y, k0 = blockIdx.x * kX3Rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n_tiles = (P + kX3Cols - 1) / kX3Cols;
  const size_t stat0 = ((size_t)b * heads + h) * P;
  const float* qb = q + (size_t)b * P * C + h * DH;
  const float* gb = dO + (size_t)b * P * C + h * DH;
  auto issue = [&](int i) {  // query tile i, its lse and delta (0 past P), into stage i % 2
    if (i < n_tiles) {
      float* qs = ring + (i & 1) * Lay::kStage;
      const int q0 = i * kX3Cols;
      x3_load_rows<DH>(qb, q0, P, C, qs);
      x3_load_rows<DH>(gb, q0, P, C, qs + Lay::kTile);
      const int c = threadIdx.x & (kX3Cols - 1);
      const bool in = q0 + c < P;
      const float* src = threadIdx.x < kX3Cols ? lse : delta;
      mma::cp_async4(qs + 2 * Lay::kTile + threadIdx.x, in ? src + stat0 + q0 + c : src, in);
    }
    mma::cp_async_commit();
  };
  issue(0);

  const int r0 = k0 + 16 * warp;
  const bool live = r0 < L;
  const bool keep[2] = {r0 + g < L, r0 + g + 8 < L};
  float2 ka[KC][2], va[KC][2];
  x3_own_rows<DH>(k + (size_t)b * L * C + h * DH, r0, L, C, lane, ka);
  x3_own_rows<DH>(v + (size_t)b * L * C + h * DH, r0, L, C, lane, va);
#pragma unroll
  for (int e = 0; e < DH; ++e) sums[e * kX3Threads] = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    mma::cp_async_wait<0>();
    __syncthreads();  // tile i is in place; every warp is done with tile i - 1
    issue(i + 1);
    if (!live) continue;
    const float* qs = ring + (i & 1) * Lay::kStage;
    const float* gs = qs + Lay::kTile;
    const float* st = gs + Lay::kTile;  // lse [64], then delta [64]
    const int q0 = i * kX3Cols;
    float pdv[NO / G][G][4], pdk[NO / G][G][4];  // this tile's sums
#pragma unroll
    for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pdv[jg][j][e] = pdk[jg][j][e] = 0.0f;
#pragma unroll
    for (int c16 = 0; c16 < kX3Cols / 16; ++c16) {
      if (q0 + 16 * c16 >= P) break;  // warp-uniform
      float s[2][4], dp[2][4];  // sᵀ = k · qᵀ, (dO · vᵀ)ᵀ; queries 16c .. 16c + 15
      x3_scores<DH>(ka, va, qs, gs, 16 * c16, lane, s, dp);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 16 * c16 + 8 * j + 2 * t + (e & 1);
          const bool on = keep[e >> 1] && q0 + col < P;
          const float p = on ? mma::exp2_approx(fmaf(s[j][e], mma::kLog2e, -st[col])) : 0.0f;
          dp[j][e] = on ? p * (dp[j][e] - st[kX3Cols + col]) : 0.0f;  // dsᵀ
          s[j][e] = p;                                                  // pᵀ
        }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = (16 * c16 + 8 * j) * Lay::kLd;
        gemm32::mma_x3_rows<DH, G, Lay::kLd>(pdv, s[j], gs + row, lane);   // dv += pᵀ · dO
        gemm32::mma_x3_rows<DH, G, Lay::kLd>(pdk, dp[j], qs + row, lane);  // dk += dsᵀ · q
      }
    }
#pragma unroll
    for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * (G * jg + j) + e;
          sums[x * kX3Threads] += pdv[jg][j][e];
          sums[(DH / 2 + x) * kX3Threads] += pdk[jg][j][e];
        }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!keep[r]) continue;
    const size_t o = ((size_t)b * L + r0 + g + 8 * r) * C + h * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int x = 4 * n + 2 * r;
      *reinterpret_cast<float2*>(dv + o + 8 * n) =
          make_float2(sums[x * kX3Threads], sums[(x + 1) * kX3Threads]);
      *reinterpret_cast<float2*>(dk + o + 8 * n) =
          make_float2(sums[(DH / 2 + x) * kX3Threads], sums[(DH / 2 + x + 1) * kX3Threads]);
    }
  }
}

// delta[b][h][p] = Σ_d dO · O over head h's columns (f32); a warp per row,
// 4 columns a lane, the dh / 4 lanes of a head summed by shuffles.
__global__ void __launch_bounds__(256)
attn_delta_f32(const float* __restrict__ dO, const float* __restrict__ O, float* __restrict__ D,
               long long rows, int P, int C, int heads) {
  const int lane = threadIdx.x & 31, dh = C / heads, span = dh / 4;
  for (long long m = blockIdx.x * 8LL + (threadIdx.x >> 5); m < rows; m += gridDim.x * 8LL) {
    const long long b = m / P, p = m - b * P;
    for (int c0 = 0; c0 < C; c0 += 128) {
      const int c = c0 + 4 * lane;
      float a = 0.0f;
      if (c < C) {
        const float4 x = *reinterpret_cast<const float4*>(dO + m * C + c);
        const float4 y = *reinterpret_cast<const float4*>(O + m * C + c);
        a = x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
      for (int o = 1; o < span; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (c < C && lane % span == 0) D[(b * heads + c / dh) * P + p] = a;
    }
  }
}

template <int DH>
cudaError_t attn_bwd_kernels_x3(const float* q, const float* k, const float* v, const float* lse,
                                const float* dO, const float* D, float* dq, float* dbq, float* dk,
                                float* dv, int B, int P, int L, int C, int heads,
                                cudaStream_t s) {
  constexpr size_t smem_dq = X3Layout<DH>::kDqBytes;
  LC2_TRY(allow_smem(attn_dq_x3<DH>, smem_dq));
  attn_dq_x3<DH><<<dim3((P + kX3Rows - 1) / kX3Rows, heads, B), kX3Threads, smem_dq, s>>>(
      q, k, v, dO, lse, D, dq, dbq, P, L, C);
  LC2_TRY(cudaGetLastError());
  constexpr size_t smem_kv = X3Layout<DH>::kKvBytes;
  LC2_TRY(allow_smem(attn_dkdv_x3<DH>, smem_kv));
  attn_dkdv_x3<DH><<<dim3((L + kX3Rows - 1) / kX3Rows, heads, B), kX3Threads, smem_kv, s>>>(
      q, k, v, dO, lse, D, dk, dv, P, L, C);
  return cudaGetLastError();
}

// The workspace of the f32 body, in floats, carved in this order.
struct F32Workspace {
  float *q, *att, *sd, *dO, *lse, *D, *part;
  F32Workspace(float* ws, long long BP, int C, long long stats) {
    const long long PC = BP * C;
    q = ws;            // [BP][C]
    att = q + PC;      // [BP][C]  the head outputs, then dq
    sd = att + PC;     // [BP][C]  s, then ds
    dO = sd + PC;      // [BP][C]
    lse = dO + PC;     // [B][heads][P], log2 units
    D = lse + stats;   // [B][heads][P]
    part = D + stats;  // the recompute's key-range partials (CorePlan)
  }
  static long long floats(int B, int P, int L, int C, int heads) {
    const long long BP = (long long)B * P;
    return 4 * BP * C + 2 * BP * heads + CorePlan(B, P, L, heads).partial_floats(B, P, C, heads);
  }
};

cudaError_t attn_bwd_f32(const float* x, const float* k, const float* v, const float* g,
                         const float* wq, const float* bq, const float* wo, const float* bo,
                         const float* lnw, float* dx, float* dk, float* dv, float* dwq, float* dbq,
                         float* dwo, float* dbo, float* dlnw, float* dlnb, float* ws, int B, int P,
                         int L, int C, int heads, float eps, cudaStream_t s) {
  using gemm32::Epilogue;
  const long long BP = (long long)B * P;
  const int bp = (int)BP;
  const F32Workspace w(ws, BP, C, BP * heads);
  // the forward: q, the head outputs and lse (attn_core_f32.cuh), s (f32)
  LC2_TRY(gemm32::gemm(bp, C, C, x, C, wq, C, Epilogue{bq, nullptr, w.q, C}, s));
  switch (C / heads) {
    case 16: LC2_TRY((attn_core_launch<16, true>(w.q, k, v, w.att, w.lse, w.part, B, P, L, C, heads, s))); break;
    case 32: LC2_TRY((attn_core_launch<32, true>(w.q, k, v, w.att, w.lse, w.part, B, P, L, C, heads, s))); break;
    case 64: LC2_TRY((attn_core_launch<64, true>(w.q, k, v, w.att, w.lse, w.part, B, P, L, C, heads, s))); break;
    default: return cudaErrorInvalidValue;
  }
  LC2_TRY(gemm32::gemm(bp, C, C, w.att, C, wo, C, Epilogue{bo, x, w.sd, C}, s));
  LC2_TRY(post_ln<float>(w.sd, g, lnw, nullptr, dlnw, dlnb, dbo, BP, C, eps, s));
  // dWo += dsᵀ · att; dO = ds · Wo
  LC2_TRY((gemm32::product<true, true>(C, C, bp, w.sd, C, w.att, C,
                                       Epilogue{nullptr, nullptr, dwo, C, true}, s)));
  LC2_TRY((gemm32::product<false, true>(bp, C, C, w.sd, C, wo, C,
                                        Epilogue{nullptr, nullptr, w.dO, C}, s)));
  {
    const long long want = (BP + 7) / 8;
    attn_delta_f32<<<(int)(want < 8 * 132 ? want : 8 * 132), 256, 0, s>>>(w.dO, w.att, w.D, BP,
                                                                           P, C, heads);
    LC2_TRY(cudaGetLastError());
  }
  float* dq = w.att;  // the head outputs are read for the last time above
  switch (C / heads) {
    case 16: LC2_TRY(attn_bwd_kernels_x3<16>(w.q, k, v, w.lse, w.dO, w.D, dq, dbq, dk, dv, B, P, L, C, heads, s)); break;
    case 32: LC2_TRY(attn_bwd_kernels_x3<32>(w.q, k, v, w.lse, w.dO, w.D, dq, dbq, dk, dv, B, P, L, C, heads, s)); break;
    case 64: LC2_TRY(attn_bwd_kernels_x3<64>(w.q, k, v, w.lse, w.dO, w.D, dq, dbq, dk, dv, B, P, L, C, heads, s)); break;
    default: return cudaErrorInvalidValue;
  }
  // dWq += dqᵀ · x; dx = dq · Wq + ds
  LC2_TRY((gemm32::product<true, true>(C, C, bp, dq, C, x, C,
                                       Epilogue{nullptr, nullptr, dwq, C, true}, s)));
  return gemm32::product<false, true>(bp, C, C, dq, C, wq, C, Epilogue{nullptr, w.sd, dx, C}, s);
}

// ===========================================================================
// bf16 body: tensor cores (mma.sync), bf16 intermediates where JAX rounds
// ===========================================================================

// (the forward it recomputes, its GEMM and its attention core, attn_fwd_mma,
// are csrc/attn_block_fwd.cuh, which the forward kernel runs too)

// dq = Σ_keys round(p · (dO · vᵀ − delta)) · k, with p = exp(q · kᵀ − lse);
// grid (P tiles, heads, B).  Writes dq rounded to bf16 (dqb: what dWq and dx
// read) and adds the f32 column sums of its rows into dbq (the unrounded dq,
// as JAX's dbq reads it).
template <int DH>
__global__ void __launch_bounds__(kAttnThreads, 2)
attn_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dO, const float* __restrict__ lse,
            const float* __restrict__ delta, bf16* __restrict__ dqb, float* __restrict__ dbq,
            int P, int L, int C) {
  using Lay = AttnLayout<DH, 2, false>;
  constexpr int KC = DH / 16, NO = DH / 8, LD = Lay::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + Lay::kTile;
  float* red = reinterpret_cast<float*>(smem_raw + Lay::kRed);  // [4 warps][DH]
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y, p0 = blockIdx.x * kAttnRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t4 = lane & 3;
  const int n_tiles = (L + kAttnCols - 1) / kAttnCols;
  auto issue = [&](int t) {
    if (t < n_tiles) {
      bf16* ks = Lay::a(smem_raw, t % kAttnStages);
      load_head_rows<DH>(k, b, L, C, h, t * kAttnCols, ks);
      load_head_rows<DH>(v, b, L, C, h, t * kAttnCols, ks + Lay::kTile);
    }
    mma::cp_async_commit();
  };
  load_head_rows<DH>(q, b, P, C, h, p0, qs);
  load_head_rows<DH>(dO, b, P, C, h, p0, gs);
  mma::cp_async_commit();
  issue(0);
  mma::cp_async_wait<1>();
  __syncthreads();

  const bool live = p0 + warp * 16 < P;
  uint32_t qa[KC][4], ga[KC][4];
  mma::own_fragments<DH>(qs + warp * 16 * LD, lane, qa);
  mma::own_fragments<DH>(gs + warp * 16 * LD, lane, ga);
  const size_t stat0 = ((size_t)b * heads + h) * P;
  float lse2[2], dl[2];  // rows g and g + 8: lse in log2 units (−∞ past P) and delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = p0 + warp * 16 + (lane >> 2) + 8 * r;
    lse2[r] = row < P ? lse[stat0 + row] * mma::kLog2e : -INFINITY;
    dl[r] = row < P ? delta[stat0 + row] : 0.0f;
  }
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    mma::cp_async_wait<0>();
    __syncthreads();
    issue(t + 1);
    const bf16* ks = Lay::a(smem_raw, t % kAttnStages);
    const bf16* vs = ks + Lay::kTile;
    const mma::KeyBits kept = mma::key_bits(nullptr, t * kAttnCols, L, lane);
    if (!live) continue;
    auto tile = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
#pragma unroll
      for (int c16 = 0; c16 < kAttnCols / 16; ++c16) {
        const uint32_t groups = (kept.any() >> (8 * c16)) & 0xffu;
        if (!kFull && !groups) continue;
        float s[2][4], dp[2][4];  // q · kᵀ and dO · vᵀ over keys 16c .. 16c + 15
        mma::two_products_mma<DH, kFull>(qa, ga, nullptr, ks, vs, c16, groups, lane, s, dp);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const bool keep = kFull || ((kept.b[e & 1] >> (8 * c16 + 4 * j + t4)) & 1u);
            const bool on = keep && lse2[r] != -INFINITY;
            const float p = on ? mma::exp2_approx(fmaf(s[j][e], mma::kLog2e, -lse2[r])) : 0.0f;
            dp[j][e] = on ? p * (dp[j][e] - dl[r]) : 0.0f;  // ds, rounded to bf16 in pb_mma
          }
        mma::pb_mma<DH>(acc, dp, ks, c16, lane);  // dq += ds · k
      }
    };
    if (kept.all())
      tile(std::true_type{});
    else
      tile(std::false_type{});
  }
  // dbq: the column sums of the block's f32 dq rows (0 past P), per warp
  // over its 16 rows (lanes of one column differ in lane / 4), then over the
  // 4 warps in shared memory, one atomic a column
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float cs = acc[j][e] + acc[j][2 + e];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) cs += __shfl_xor_sync(0xffffffffu, cs, o);
      if (lane < 4) red[warp * DH + 8 * j + 2 * t4 + e] = cs;
    }
  __syncthreads();
  if (threadIdx.x < DH)
    atomicAdd(dbq + h * DH + threadIdx.x, red[threadIdx.x] + red[DH + threadIdx.x] +
                                              red[2 * DH + threadIdx.x] + red[3 * DH + threadIdx.x]);
  if (!live) return;
  bf16* st = qs + warp * 16 * LD;  // the warp's own q rows stage its dq rows
  mma::stage_rows<DH, NO>(acc, 1.0f, 1.0f, st, lane);
  mma::store_rows_ld<DH>(st, dqb + (size_t)b * P * C + h * DH, p0 + warp * 16, P, C, lane);
}

// dk = Σ_queries round(ds)ᵀ · q and dv = Σ_queries round(p)ᵀ · dO in f32;
// grid (L tiles, heads, B): each warp owns 16 keys and computes sᵀ = k · qᵀ
// and (dO · vᵀ)ᵀ = v · dOᵀ for them over streamed 64-query tiles.
template <int DH>
__global__ void __launch_bounds__(kAttnThreads, 2)
attn_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ dO, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
              int P, int L, int C) {
  using Lay = AttnLayout<DH, 2, true>;
  constexpr int KC = DH / 16, NO = DH / 8, LD = Lay::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + Lay::kTile;
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y, k0 = blockIdx.x * kAttnRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t4 = lane & 3;
  const int n_tiles = (P + kAttnCols - 1) / kAttnCols;
  const size_t stat0 = ((size_t)b * heads + h) * P;
  auto issue = [&](int t) {  // q, dO rows and their lse and delta (0 past P)
    if (t < n_tiles) {
      bf16* qs = Lay::a(smem_raw, t % kAttnStages);
      float* st = Lay::stats(smem_raw, t % kAttnStages);
      const int r0 = t * kAttnCols;
      load_head_rows<DH>(q, b, P, C, h, r0, qs);
      load_head_rows<DH>(dO, b, P, C, h, r0, qs + Lay::kTile);
      const int i = threadIdx.x & (kAttnCols - 1);
      const bool in = r0 + i < P;
      const float* src = threadIdx.x < kAttnCols ? lse : delta;
      mma::cp_async4(st + (threadIdx.x < kAttnCols ? 0 : kAttnCols) + i,
                     in ? src + stat0 + r0 + i : src, in);
    }
    mma::cp_async_commit();
  };
  load_head_rows<DH>(k, b, L, C, h, k0, ks);
  load_head_rows<DH>(v, b, L, C, h, k0, vs);
  mma::cp_async_commit();
  issue(0);
  mma::cp_async_wait<1>();
  __syncthreads();

  const int key0 = k0 + warp * 16 + (lane >> 2);
  const bool keep[2] = {key0 < L, key0 + 8 < L};
  const bool live = k0 + warp * 16 < L;
  uint32_t ka[KC][4], va[KC][4];
  mma::own_fragments<DH>(ks + warp * 16 * LD, lane, ka);
  mma::own_fragments<DH>(vs + warp * 16 * LD, lane, va);
  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    mma::cp_async_wait<0>();
    __syncthreads();
    issue(t + 1);
    const bf16* qs = Lay::a(smem_raw, t % kAttnStages);
    const bf16* gs = qs + Lay::kTile;
    const float* st = Lay::stats(smem_raw, t % kAttnStages);
    const mma::KeyBits inq = mma::key_bits(nullptr, t * kAttnCols, P, lane);  // query < P
    if (!live) continue;
    auto tile = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
#pragma unroll
      for (int c16 = 0; c16 < kAttnCols / 16; ++c16) {
        const uint32_t groups = (inq.any() >> (8 * c16)) & 0xffu;
        if (!kFull && !groups) continue;
        float s[2][4], dp[2][4];  // sᵀ = k · qᵀ, (dO · vᵀ)ᵀ; queries 16c .. 16c + 15
        mma::two_products_mma<DH, kFull>(ka, va, nullptr, qs, gs, c16, groups, lane, s, dp);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 16 * c16 + 8 * j + 2 * t4 + (e & 1);
            const bool in = kFull || ((inq.b[e & 1] >> (8 * c16 + 4 * j + t4)) & 1u);
            const bool on = keep[e >> 1] && in;
            const float p =
                on ? mma::exp2_approx((s[j][e] - st[col]) * mma::kLog2e) : 0.0f;
            dp[j][e] = on ? p * (dp[j][e] - st[kAttnCols + col]) : 0.0f;  // dsᵀ
            s[j][e] = p;                                                   // pᵀ
          }
        mma::pb_mma<DH>(dv_acc, s, gs, c16, lane);  // dv += round(pᵀ) · dO
        mma::pb_mma<DH>(dk_acc, dp, qs, c16, lane);  // dk += round(dsᵀ) · q
      }
    };
    if (inq.all())
      tile(std::true_type{});
    else
      tile(std::false_type{});
  }
  if (!live) return;
  const int c = 2 * t4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!keep[r]) continue;
    const size_t o = ((size_t)b * L + key0 + 8 * r) * C + h * DH + c;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<float2*>(dk + o + 8 * j) = make_float2(dk_acc[j][2 * r], dk_acc[j][2 * r + 1]);
      *reinterpret_cast<float2*>(dv + o + 8 * j) = make_float2(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
}

// delta[b][h][p] = Σ_d dO · O over head h's columns (bf16 in, f32 sum); a
// warp per row, 8 columns a lane, the dh / 8 lanes of a head summed by
// shuffles.
__global__ void __launch_bounds__(256)
attn_delta_bf16(const bf16* __restrict__ dO, const bf16* __restrict__ O, float* __restrict__ D,
                long long rows, int P, int C, int heads) {
  const int lane = threadIdx.x & 31, dh = C / heads, span = dh / 8;
  for (long long m = blockIdx.x * 8LL + (threadIdx.x >> 5); m < rows; m += gridDim.x * 8LL) {
    const long long b = m / P, p = m - b * P;
    for (int c0 = 0; c0 < C; c0 += 256) {
      const int c = c0 + 8 * lane;
      float a = 0.0f;
      if (c < C) {
        const uint4 x = *reinterpret_cast<const uint4*>(dO + m * C + c);
        const uint4 y = *reinterpret_cast<const uint4*>(O + m * C + c);
        const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 u = __bfloat1622float2(xs[i]), w = __bfloat1622float2(ys[i]);
          a += u.x * w.x + u.y * w.y;
        }
      }
      for (int o = 1; o < span; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (c < C && lane % span == 0) D[(b * heads + c / dh) * P + p] = a;
    }
  }
}

// The f32 weights (holding bf16 values) as bf16 operands.
__global__ void __launch_bounds__(256)
weights_bf16(const float* __restrict__ wq, const float* __restrict__ wo, bf16* __restrict__ wqb,
             bf16* __restrict__ wob, long long n) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n; i += (long long)gridDim.x * 256) {
    wqb[i] = __float2bfloat16(wq[i]);
    wob[i] = __float2bfloat16(wo[i]);
  }
}

template <int DH>
cudaError_t attn_bwd_kernels_bf16(const bf16* q, const bf16* k, const bf16* v, const float* lse,
                                  const bf16* dO, const float* D, bf16* dqb, float* dbq, float* dk,
                                  float* dv, int B, int P, int L, int C, int heads,
                                  cudaStream_t s) {
  constexpr size_t smem_dq = AttnLayout<DH, 2, false>::kBytes;
  LC2_TRY(allow_smem(attn_dq_mma<DH>, smem_dq));
  attn_dq_mma<DH><<<dim3((P + kAttnRows - 1) / kAttnRows, heads, B), kAttnThreads, smem_dq, s>>>(
      q, k, v, dO, lse, D, dqb, dbq, P, L, C);
  LC2_TRY(cudaGetLastError());
  constexpr size_t smem_kv = AttnLayout<DH, 2, true>::kBytes;
  LC2_TRY(allow_smem(attn_dkdv_mma<DH>, smem_kv));
  attn_dkdv_mma<DH><<<dim3((L + kAttnRows - 1) / kAttnRows, heads, B), kAttnThreads, smem_kv, s>>>(
      q, k, v, dO, lse, D, dk, dv, P, L, C);
  return cudaGetLastError();
}

cudaError_t attn_bwd_kernels_bf16_dh(const bf16* q, const bf16* k, const bf16* v,
                                     const float* lse, const bf16* dO, const float* D, bf16* dqb,
                                     float* dbq, float* dk, float* dv, int B, int P, int L, int C,
                                     int heads, cudaStream_t s) {
  switch (C / heads) {
    case 16: return attn_bwd_kernels_bf16<16>(q, k, v, lse, dO, D, dqb, dbq, dk, dv, B, P, L, C, heads, s);
    case 32: return attn_bwd_kernels_bf16<32>(q, k, v, lse, dO, D, dqb, dbq, dk, dv, B, P, L, C, heads, s);
    case 64: return attn_bwd_kernels_bf16<64>(q, k, v, lse, dO, D, dqb, dbq, dk, dv, B, P, L, C, heads, s);
    default: return cudaErrorInvalidValue;
  }
}

// The workspace of the bf16 body, in bytes, carved in this order.
struct Bf16Workspace {
  bf16 *wqb, *wob, *q, *att, *dsb, *datt;
  float *sd, *lse, *D;
  Bf16Workspace(void* ws, long long BP, int C, long long stats) {
    const long long PC = BP * C;
    wqb = static_cast<bf16*>(ws);  // [C][C]
    wob = wqb + (long long)C * C;  // [C][C]
    q = wob + (long long)C * C;    // [BP][C]
    att = q + PC;                  // [BP][C]
    dsb = att + PC;                // [BP][C]  ds, then dq (rounded)
    datt = dsb + PC;               // [BP][C]  dO
    sd = reinterpret_cast<float*>(datt + PC);  // [BP][C]  s, then ds
    lse = sd + PC;                 // [B][heads][P]
    D = lse + stats;               // [B][heads][P]
  }
  static long long floats(long long BP, int C, long long stats) {
    return (long long)C * C + 3 * BP * C + 2 * stats;
  }
};

cudaError_t attn_bwd_bf16(const bf16* x, const bf16* k, const bf16* v, const bf16* g,
                          const float* wq, const float* bq, const float* wo, const float* bo,
                          const float* lnw, bf16* dx, float* dk, float* dv, float* dwq,
                          float* dbq, float* dwo, float* dbo, float* dlnw, float* dlnb, void* ws,
                          int B, int P, int L, int C, int heads, float eps, cudaStream_t s) {
  using gemm16::Epilogue;
  const long long BP = (long long)B * P;
  const int bp = (int)BP;
  const Bf16Workspace w(ws, BP, C, BP * heads);
  const long long cc = (long long)C * C;
  weights_bf16<<<elementwise_blocks(cc), 256, 0, s>>>(wq, wo, w.wqb, w.wob, cc);
  LC2_TRY(cudaGetLastError());
  // the forward: q, att, lse and s (f32)
  LC2_TRY(attn_block_fwd_bf16(x, k, v, w.wqb, bq, w.wob, bo, w.q, w.att, w.lse, w.sd, B, P, L, C,
                              heads, s));
  LC2_TRY(post_ln<bf16>(w.sd, g, lnw, w.dsb, dlnw, dlnb, dbo, BP, C, eps, s));
  // dWo += round(ds)ᵀ · att; dO = round(round(ds) · Wo)
  LC2_TRY((gemm16::gemm<true, true>(C, C, bp, w.dsb, C, w.att, C,
                                    Epilogue{nullptr, nullptr, nullptr, dwo, nullptr, C, true}, s)));
  LC2_TRY((gemm16::gemm<false, true>(bp, C, C, w.dsb, C, w.wob, C,
                                     Epilogue{nullptr, nullptr, nullptr, nullptr, w.datt, C, false},
                                     s)));
  {
    const long long want = (BP + 7) / 8;
    attn_delta_bf16<<<(int)(want < 8 * 132 ? want : 8 * 132), 256, 0, s>>>(w.datt, w.att, w.D, BP,
                                                                            P, C, heads);
    LC2_TRY(cudaGetLastError());
  }
  bf16* dqb = w.dsb;  // round(ds) is read for the last time above
  LC2_TRY(attn_bwd_kernels_bf16_dh(w.q, k, v, w.lse, w.datt, w.D, dqb, dbq, dk, dv, B, P, L, C,
                                   heads, s));
  // dWq += round(dq)ᵀ · x; dx = round(dq) · Wq + ds, rounded
  LC2_TRY((gemm16::gemm<true, true>(C, C, bp, dqb, C, x, C,
                                    Epilogue{nullptr, nullptr, nullptr, dwq, nullptr, C, true}, s)));
  return gemm16::gemm<false, true>(bp, C, C, dqb, C, w.wqb, C,
                                   Epilogue{nullptr, w.sd, nullptr, nullptr, dx, C, false}, s);
}

}  // namespace
}  // namespace lc2

// Workspace floats the f32 body needs (the wrapper allocates them).
extern "C" long long lc2_attn_block_bwd_workspace(int B, int P, int L, int C, int heads) {
  return lc2::F32Workspace::floats(B, P, L, C, heads);
}

// Workspace floats the bf16 body needs.
extern "C" long long lc2_attn_block_bwd_workspace_bf16(int B, int P, int L, int C, int heads) {
  const long long BP = (long long)B * P;
  return lc2::Bf16Workspace::floats(BP, C, BP * heads);
}

// x, g (gradient of out), dx (B, P, C) and k, v (B, L, C) of the dtype; wq
// (C, C) and bq (C,) with 1/sqrt(dh) folded in, wo (C, C), bo, lnw (C,): f32
// holding the values the forward kernel used.  dk, dv (B, L, C) f32;
// dwq, dbq, dwo, dbo, dlnw, dlnb f32, ZEROED by the caller.  ws: the dtype's
// workspace floats (lc2_attn_block_bwd_workspace, _bf16).  C / heads in
// {16, 32, 64}; bf16: C in {64, 128, 256, 512}, 16-byte aligned operands.
extern "C" int lc2_attn_block_bwd(int dtype, const void* x, const void* k, const void* v,
                                  const void* g, const void* wq, const void* bq, const void* wo,
                                  const void* bo, const void* lnw, void* dx, void* dk, void* dv,
                                  void* dwq, void* dbq, void* dwo, void* dbo, void* dlnw,
                                  void* dlnb, void* ws, int B, int P, int L, int C, int heads,
                                  float eps, void* stream) {
  if (L < 1 || P < 1 || heads < 1 || C % heads) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  if (dtype == lc2::kF32)
    return lc2::attn_bwd_f32(f(x), f(k), f(v), f(g), f(wq), f(bq), f(wo), f(bo), f(lnw), o(dx),
                             o(dk), o(dv), o(dwq), o(dbq), o(dwo), o(dbo), o(dlnw), o(dlnb),
                             o(ws), B, P, L, C, heads, eps, s);
  if (dtype == lc2::kBF16) {
    using bf = __nv_bfloat16;
    auto t = [](const void* p) { return static_cast<const bf*>(p); };
    return lc2::attn_bwd_bf16(t(x), t(k), t(v), t(g), f(wq), f(bq), f(wo), f(bo), f(lnw),
                              static_cast<bf*>(dx), o(dk), o(dv), o(dwq), o(dbq), o(dwo), o(dbo),
                              o(dlnw), o(dlnb), ws, B, P, L, C, heads, eps, s);
  }
  return cudaErrorInvalidValue;
}
