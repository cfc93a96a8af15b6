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
// f32 body: csrc/gemm.cuh's CUDA-core products (weight gradients split over
// blocks with f32 atomics) and 64 x 64 f32 tile products in shared memory,
// f32 intermediates (and f32 copies of x, k, v) in the workspace.
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
// rounds p per key tile and scales O by 1/l at the end (the flash kernels'
// order; JAX normalises before rounding: the two differ by bf16 rounding).
// Intermediates stay bf16 in the workspace except s/ds, the lse and delta.
#include <math.h>
#include <math_constants.h>

#include <type_traits>

#include "attn_tiles.cuh"
#include "gemm.cuh"
#include "gemm_bf16.cuh"

namespace lc2 {
namespace {

// ===========================================================================
// f32 body: CUDA cores, f32 intermediates in the workspace
// ===========================================================================

// copy of an operand into the workspace
__global__ void __launch_bounds__(256) to_f32_kernel(const float* __restrict__ in,
                                                     float* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n; i += (long long)gridDim.x * 256)
    out[i] = in[i];
}

inline int elementwise_blocks(long long n) {
  const long long want = (n + 255) / 256;
  return (int)(want < 132LL * 16 ? (want > 0 ? want : 1) : 132LL * 16);
}

template <int DH>
struct Tiles {
  static constexpr int kLD = DH + 1, kLP = 65, NJ = DH / 16;
};

// Q tile rows [p0, p0 + 64) of head h, zero past P: dst[64][LD]
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long row0, int rows,
                                          int C, int h) {
  constexpr int LD = Tiles<DH>::kLD;
  for (int idx = threadIdx.x; idx < 64 * DH; idx += 256) {
    const int t = idx / DH, d = idx - t * DH;
    dst[t * LD + d] = t < rows ? src[(row0 + t) * C + h * DH + d] : 0.0f;
  }
}

// 2. O and the log-sum-exp; grid (P tiles, heads, B)
template <int DH>
__global__ void __launch_bounds__(256)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ att, float* __restrict__ lse,
                int P, int L, int C) {
  constexpr int LD = Tiles<DH>::kLD, LP = Tiles<DH>::kLP, NJ = Tiles<DH>::NJ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + 64 * LD;
  float* vs = ks + 64 * LD;
  float* ps = vs + 64 * LD;  // [64][LP]
  float* mrow = ps + 64 * LP;  // [64] running max
  float* lrow = mrow + 64;     // [64] running sum
  float* crow = lrow + 64;     // [64] rescale of this tile
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y, p0 = blockIdx.x * 64;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, tx = tid & 15, ty = tid >> 4;
  load_tile<DH>(qs, q, (long long)b * P + p0, min(64, P - p0), C, h);
  if (tid < 64) {
    mrow[tid] = -CUDART_INF_F;
    lrow[tid] = 0.0f;
  }
  float o[4][NJ];
  zero(o);
  for (int j0 = 0; j0 < L; j0 += 64) {
    __syncthreads();
    load_tile<DH>(ks, k, (long long)b * L + j0, min(64, L - j0), C, h);
    load_tile<DH>(vs, v, (long long)b * L + j0, min(64, L - j0), C, h);
    __syncthreads();
    float s[4][4];
    zero(s);
    tile_mm<4, 4>(s, qs, LD, 1, ks, LD, 1, DH);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        ps[(ty + 16 * i) * LP + c] = j0 + c < L ? s[i][j] : -CUDART_INF_F;
      }
    __syncthreads();
    for (int r = warp; r < 64; r += 8) {
      const float a0 = ps[r * LP + lane], a1 = ps[r * LP + lane + 32];
      const float m_old = mrow[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a0, a1)));
      const float e0 = __expf(a0 - m_new), e1 = __expf(a1 - m_new);
      const float corr = __expf(m_old - m_new);  // 0 on the first tile
      const float sum = warp_sum(e0 + e1);
      ps[r * LP + lane] = e0;
      ps[r * LP + lane + 32] = e1;
      __syncwarp();
      if (lane == 0) {
        lrow[r] = lrow[r] * corr + sum;
        mrow[r] = m_new;
        crow[r] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[i][j] *= crow[ty + 16 * i];
    tile_mm<4, NJ>(o, ps, LP, 1, vs, 1, LD, 64);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (p0 + r >= P) continue;
    const float inv = 1.0f / lrow[r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float val = o[i][j] * inv;
      att[((long long)b * P + p0 + r) * C + h * DH + tx + 16 * j] = val;
    }
    if (tx == 0) lse[((long long)b * heads + h) * P + p0 + r] = mrow[r] + __logf(lrow[r]);
  }
}

// 3. post-LN backward from s = x + proj (f32, in place: s becomes ds); warp
// per row (grid-stride), dln_w / dln_b partials per block in shared memory
__global__ void __launch_bounds__(256)
post_ln_bwd_kernel(float* __restrict__ s, const float* __restrict__ g, const float* __restrict__ lnw,
                   float* __restrict__ dlnw, float* __restrict__ dlnb, long long rows, int C,
                   float eps) {
  extern __shared__ float red[];  // [2][C]
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x; c < 2 * C; c += 256) red[c] = 0.0f;
  __syncthreads();
  for (long long m = blockIdx.x * 8LL + (threadIdx.x >> 5); m < rows; m += gridDim.x * 8LL) {
    float* sr = s + m * C;
    const float* gr = g + m * C;
    float a = 0.0f;
    for (int c = lane; c < C; c += 32) a += sr[c];
    const float mu = warp_sum(a) / C;
    float q = 0.0f;
    for (int c = lane; c < C; c += 32) q += (sr[c] - mu) * (sr[c] - mu);
    const float rs = rsqrtf(warp_sum(q) / C + eps);
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float sh = (sr[c] - mu) * rs, dy = gr[c], dsh = dy * lnw[c];
      s1 += dsh;
      s2 += dsh * sh;
      atomicAdd(red + c, dy * sh);
      atomicAdd(red + C + c, dy);
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
    for (int c = lane; c < C; c += 32) {
      const float sh = (sr[c] - mu) * rs, dsh = gr[c] * lnw[c];
      sr[c] = rs * (dsh - s1 - sh * s2);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += 256) {
    atomicAdd(dlnw + c, red[c]);
    atomicAdd(dlnb + c, red[C + c]);
  }
}

// D[b][h][p] = Σ_d dO·O over head h's columns
__global__ void __launch_bounds__(256)
attn_delta_kernel(const float* __restrict__ dO, const float* __restrict__ O,
                  float* __restrict__ D, long long rows, int C, int heads) {
  const int dh = C / heads;
  const long long n = rows * heads;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n; i += (long long)gridDim.x * 256) {
    const long long m = i / heads;  // row b·P + p
    const int h = (int)(i - m * heads);
    float a = 0.0f;
    for (int d = 0; d < dh; ++d) a += dO[m * C + h * dh + d] * O[m * C + h * dh + d];
    D[i] = a;  // (b·P + p)·heads + h
  }
}

// 5a. dQ; grid (P tiles, heads, B)
template <int DH>
__global__ void __launch_bounds__(256)
attn_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dO,
               const float* __restrict__ lse, const float* __restrict__ D,
               float* __restrict__ dq, int P, int L, int C) {
  constexpr int LD = Tiles<DH>::kLD, LP = Tiles<DH>::kLP, NJ = Tiles<DH>::NJ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* os = qs + 64 * LD;
  float* ks = os + 64 * LD;
  float* vs = ks + 64 * LD;
  float* ds = vs + 64 * LD;  // [64][LP]
  float* lr = ds + 64 * LP;  // [64]
  float* dr = lr + 64;       // [64]
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y, p0 = blockIdx.x * 64;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rows = min(64, P - p0);
  load_tile<DH>(qs, q, (long long)b * P + p0, rows, C, h);
  load_tile<DH>(os, dO, (long long)b * P + p0, rows, C, h);
  if (tid < 64) {
    lr[tid] = tid < rows ? lse[((long long)b * heads + h) * P + p0 + tid] : 0.0f;
    dr[tid] = tid < rows ? D[((long long)b * P + p0 + tid) * heads + h] : 0.0f;
  }
  float acc[4][NJ];
  zero(acc);
  for (int j0 = 0; j0 < L; j0 += 64) {
    __syncthreads();
    load_tile<DH>(ks, k, (long long)b * L + j0, min(64, L - j0), C, h);
    load_tile<DH>(vs, v, (long long)b * L + j0, min(64, L - j0), C, h);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    tile_mm<4, 4>(s, qs, LD, 1, ks, LD, 1, DH);
    tile_mm<4, 4>(dp, os, LD, 1, vs, LD, 1, DH);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float p = (r < rows && j0 + c < L) ? __expf(s[i][j] - lr[r]) : 0.0f;
        ds[r * LP + c] = p * (dp[i][j] - dr[r]);
      }
    __syncthreads();
    tile_mm<4, NJ>(acc, ds, LP, 1, ks, 1, LD, 64);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[((long long)b * P + p0 + r) * C + h * DH + tx + 16 * j] = acc[i][j];
  }
}

// 5b. dK, dV; grid (L tiles, heads, B); rows of the tiles are keys
template <int DH>
__global__ void __launch_bounds__(256)
attn_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dO,
                 const float* __restrict__ lse, const float* __restrict__ D,
                 float* __restrict__ dk, float* __restrict__ dv, int P, int L, int C) {
  constexpr int LD = Tiles<DH>::kLD, LP = Tiles<DH>::kLP, NJ = Tiles<DH>::NJ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + 64 * LD;
  float* qs = vs + 64 * LD;
  float* os = qs + 64 * LD;
  float* pt = os + 64 * LD;   // [64 keys][LP] P
  float* dst = pt + 64 * LP;  // [64 keys][LP] dS
  float* lr = dst + 64 * LP;  // [64]
  float* dr = lr + 64;        // [64]
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y, j0 = blockIdx.x * 64;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int keys = min(64, L - j0);
  load_tile<DH>(ks, k, (long long)b * L + j0, keys, C, h);
  load_tile<DH>(vs, v, (long long)b * L + j0, keys, C, h);
  float dka[4][NJ], dva[4][NJ];
  zero(dka);
  zero(dva);
  for (int p0 = 0; p0 < P; p0 += 64) {
    const int rows = min(64, P - p0);
    __syncthreads();
    load_tile<DH>(qs, q, (long long)b * P + p0, rows, C, h);
    load_tile<DH>(os, dO, (long long)b * P + p0, rows, C, h);
    if (tid < 64) {
      lr[tid] = tid < rows ? lse[((long long)b * heads + h) * P + p0 + tid] : 0.0f;
      dr[tid] = tid < rows ? D[((long long)b * P + p0 + tid) * heads + h] : 0.0f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];  // (key ty + 16i, query tx + 16j)
    zero(st);
    zero(dpt);
    tile_mm<4, 4>(st, ks, LD, 1, qs, LD, 1, DH);
    tile_mm<4, 4>(dpt, vs, LD, 1, os, LD, 1, DH);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float p = (r < keys && c < rows) ? __expf(st[i][j] - lr[c]) : 0.0f;
        pt[r * LP + c] = p;
        dst[r * LP + c] = p * (dpt[i][j] - dr[c]);
      }
    __syncthreads();
    tile_mm<4, NJ>(dva, pt, LP, 1, os, 1, LD, 64);
    tile_mm<4, NJ>(dka, dst, LP, 1, qs, 1, LD, 64);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= keys) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const long long o = ((long long)b * L + j0 + r) * C + h * DH + tx + 16 * j;
      dk[o] = dka[i][j];
      dv[o] = dva[i][j];
    }
  }
}

template <int DH>
cudaError_t attn_core(const float* q, const float* k, const float* v, float* att, float* lse,
                      const float* dO, const float* D, float* dq, float* dk, float* dv, int B,
                      int P, int L, int C, int heads, int phase, cudaStream_t s) {
  constexpr int LD = Tiles<DH>::kLD, LP = Tiles<DH>::kLP;
  if (phase == 0) {
    const size_t smem = sizeof(float) * (3 * 64 * LD + 64 * LP + 3 * 64);
    LC2_TRY(allow_smem(attn_fwd_kernel<DH>, smem));
    attn_fwd_kernel<DH><<<dim3((P + 63) / 64, heads, B), 256, smem, s>>>(q, k, v, att, lse, P, L,
                                                                        C);
    return cudaGetLastError();
  }
  const size_t smem_dq = sizeof(float) * (4 * 64 * LD + 64 * LP + 2 * 64);
  LC2_TRY(allow_smem(attn_dq_kernel<DH>, smem_dq));
  attn_dq_kernel<DH><<<dim3((P + 63) / 64, heads, B), 256, smem_dq, s>>>(q, k, v, dO, lse, D, dq,
                                                                        P, L, C);
  LC2_TRY(cudaGetLastError());
  const size_t smem_kv = sizeof(float) * (4 * 64 * LD + 2 * 64 * LP + 2 * 64);
  LC2_TRY(allow_smem(attn_dkdv_kernel<DH>, smem_kv));
  attn_dkdv_kernel<DH><<<dim3((L + 63) / 64, heads, B), 256, smem_kv, s>>>(
      q, k, v, dO, lse, D, dk, dv, P, L, C);
  return cudaGetLastError();
}

cudaError_t attn_core_dh(int dh, const float* q, const float* k, const float* v, float* att,
                         float* lse, const float* dO, const float* D, float* dq, float* dk,
                         float* dv, int B, int P, int L, int C, int heads, int phase,
                         cudaStream_t s) {
  switch (dh) {
    case 16: return attn_core<16>(q, k, v, att, lse, dO, D, dq, dk, dv, B, P, L, C, heads, phase, s);
    case 32: return attn_core<32>(q, k, v, att, lse, dO, D, dq, dk, dv, B, P, L, C, heads, phase, s);
    case 64: return attn_core<64>(q, k, v, att, lse, dO, D, dq, dk, dv, B, P, L, C, heads, phase, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t attn_bwd_f32(const float* x, const float* k, const float* v, const float* g,
                         const float* wq, const float* bq, const float* wo, const float* bo,
                         const float* lnw, float* dx, float* dk, float* dv, float* dwq, float* dbq,
                         float* dwo, float* dbo, float* dlnw, float* dlnb, float* ws, int B, int P,
                         int L, int C, int heads, float eps, cudaStream_t s) {
  const long long BP = (long long)B * P, BL = (long long)B * L, PC = BP * C, LC = BL * C;
  const int bp = (int)BP, dh = C / heads;
  float* xf = ws;           // [BP][C]
  float* kf = xf + PC;      // [BL][C]
  float* vf = kf + LC;      // [BL][C]
  float* q = vf + LC;       // [BP][C]
  float* att = q + PC;      // [BP][C]
  float* sd = att + PC;     // [BP][C]  s, then ds
  float* dO = sd + PC;      // [BP][C]
  float* dq = dO + PC;      // [BP][C]
  float* lse = dq + PC;     // [B][heads][P]
  float* D = lse + BP * heads;  // [B·P][heads]
  to_f32_kernel<<<elementwise_blocks(PC), 256, 0, s>>>(x, xf, PC);
  LC2_TRY(cudaGetLastError());
  to_f32_kernel<<<elementwise_blocks(LC), 256, 0, s>>>(k, kf, LC);
  LC2_TRY(cudaGetLastError());
  to_f32_kernel<<<elementwise_blocks(LC), 256, 0, s>>>(v, vf, LC);
  LC2_TRY(cudaGetLastError());
  LC2_TRY(gemm(bp, C, C, Mat{xf, C, 1}, Mat{wq, 1, C}, q, C, bq, nullptr, 0, s));
  LC2_TRY(attn_core_dh(dh, q, kf, vf, att, lse, nullptr, nullptr, nullptr, nullptr, nullptr, B,
                       P, L, C, heads, 0, s));
  LC2_TRY(gemm(bp, C, C, Mat{att, C, 1}, Mat{wo, 1, C}, sd, C, bo, xf, 0, s));
  {
    const long long want = (BP + 7) / 8;
    const int blocks = (int)(want < 4 * 132 ? want : 4 * 132);
    post_ln_bwd_kernel<<<blocks, 256, sizeof(float) * 2 * C, s>>>(sd, g, lnw, dlnw, dlnb, BP, C,
                                                                  eps);
    LC2_TRY(cudaGetLastError());
  }
  LC2_TRY(gemm_acc(C, C, bp, Mat{sd, 1, C}, Mat{att, C, 1}, dwo, C, s));
  LC2_TRY(colsum(bp, C, sd, C, dbo, s));
  LC2_TRY(gemm(bp, C, C, Mat{sd, C, 1}, Mat{wo, C, 1}, dO, C, nullptr, nullptr, 0, s));
  attn_delta_kernel<<<elementwise_blocks(BP * heads), 256, 0, s>>>(dO, att, D, BP, C, heads);
  LC2_TRY(cudaGetLastError());
  LC2_TRY(attn_core_dh(dh, q, kf, vf, att, lse, dO, D, dq, dk, dv, B, P, L, C, heads, 1, s));
  LC2_TRY(gemm_acc(C, C, bp, Mat{dq, 1, C}, Mat{xf, C, 1}, dwq, C, s));
  LC2_TRY(colsum(bp, C, dq, C, dbq, s));
  return gemm(bp, C, C, Mat{dq, C, 1}, Mat{wq, C, 1}, dx, C, nullptr, sd, 0, s);
}

// ===========================================================================
// bf16 body: tensor cores (mma.sync), bf16 intermediates where JAX rounds
// ===========================================================================

using bf16 = __nv_bfloat16;
constexpr int kAttnRows = 64;  // query or key rows a block owns: 4 warps x 16
constexpr int kAttnThreads = 128;
constexpr int kAttnCols = 64;  // rows of a streamed tile
constexpr int kAttnStages = 2;

// Shared memory of the three attention kernels: NOWN own tiles of 64 rows,
// then the ring's stages of two streamed 64-row tiles (bf16 at stride DH + 8)
// and, with kStats, the lse and delta of the streamed rows; then 4 · DH
// floats (the dq kernel's column sums).
template <int DH, int NOWN, bool kStats>
struct AttnLayout {
  static constexpr int kLd = mma::row_stride<DH>();
  static constexpr int kTile = kAttnRows * kLd;
  static constexpr size_t kStage =
      sizeof(bf16) * 2 * kTile + (kStats ? 2 * sizeof(float) * kAttnCols : 0);
  static constexpr size_t kOwnBytes = sizeof(bf16) * NOWN * kTile;
  static constexpr size_t kRed = kOwnBytes + kAttnStages * kStage;
  static constexpr size_t kBytes = kRed + sizeof(float) * 4 * DH;
  __device__ static bf16* a(unsigned char* smem, int s) {
    return reinterpret_cast<bf16*>(smem + kOwnBytes + s * kStage);
  }
  __device__ static float* stats(unsigned char* smem, int s) {
    return reinterpret_cast<float*>(a(smem, s) + 2 * kTile);
  }
};

// Rows [r0, r0 + 64) of head h of a (B, n, C) bf16 matrix, image b.
template <int DH>
__device__ __forceinline__ void load_head_rows(const bf16* base, int b, int n, int C, int h,
                                               int r0, bf16* dst) {
  mma::load_rows_ld<DH, kAttnRows, kAttnThreads>(base + (size_t)b * n * C + h * DH, r0, n, C,
                                                 dst);
}

// The recompute: O = softmax(q · kᵀ) · v rounded to bf16 into att, and the
// row log-sum-exp; grid (P tiles, heads, B).  p is rounded per tile into
// P · V's A fragment and O scaled by 1 / l at the end (mma::fwd_tile).
template <int DH>
__global__ void __launch_bounds__(kAttnThreads, 3)
attn_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             bf16* __restrict__ att, float* __restrict__ lse, int P, int L, int C) {
  using Lay = AttnLayout<DH, 1, false>;
  constexpr int KC = DH / 16, NO = DH / 8, LD = Lay::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y, p0 = blockIdx.x * kAttnRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (L + kAttnCols - 1) / kAttnCols;
  auto issue = [&](int t) {  // k_t and v_t into stage t % 2, one group
    if (t < n_tiles) {
      bf16* ks = Lay::a(smem_raw, t % kAttnStages);
      load_head_rows<DH>(k, b, L, C, h, t * kAttnCols, ks);
      load_head_rows<DH>(v, b, L, C, h, t * kAttnCols, ks + Lay::kTile);
    }
    mma::cp_async_commit();
  };
  load_head_rows<DH>(q, b, P, C, h, p0, qs);
  mma::cp_async_commit();
  issue(0);
  mma::cp_async_wait<1>();
  __syncthreads();

  const bool live = p0 + warp * 16 < P;
  bf16* qw = qs + warp * 16 * LD;  // the warp's q rows, later its output staging
  uint32_t qa[KC][4];
  mma::own_fragments<DH>(qw, lane, qa);
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  for (int t = 0; t < n_tiles; ++t) {
    mma::cp_async_wait<0>();
    __syncthreads();
    issue(t + 1);
    const bf16* ks = Lay::a(smem_raw, t % kAttnStages);
    const mma::KeyBits kept = mma::key_bits(nullptr, t * kAttnCols, L, lane);
    if (!live) continue;
    if (kept.all())  // 1/√dh is folded into q: the scale is 1
      mma::fwd_tile<DH, true>(qa, ks, ks + Lay::kTile, kept, mma::kLog2e, lane, o, m, l);
    else
      mma::fwd_tile<DH, false>(qa, ks, ks + Lay::kTile, kept, mma::kLog2e, lane, o, m, l);
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  mma::stage_rows<DH, NO>(o, 1.0f / l[0], 1.0f / l[1], qw, lane);
  mma::store_rows_ld<DH>(qw, att + (size_t)b * P * C + h * DH, p0 + warp * 16, P, C, lane);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = p0 + warp * 16 + (lane >> 2) + 8 * r;
      if (row < P) lse[((size_t)b * heads + h) * P + row] = m[r] * mma::kLn2 + logf(l[r]);
    }
  }
}

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

// Post-LN backward from s = x + proj (f32) in place: s becomes ds (f32: dx's
// residual term), dsb = ds rounded to bf16 (the operand of dWo and dO), and
// dln_w, dln_b and dbo = Σ ds summed per block; a warp per row (grid-stride),
// lane owning columns lane + 32i (CPL = C / 32 of them, in registers).
template <int CPL>
__global__ void __launch_bounds__(256)
post_ln_bwd_bf16(float* __restrict__ s, const bf16* __restrict__ g, const float* __restrict__ lnw,
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
      dy[i] = __bfloat162float(g[m * C + lane + 32 * i]);
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
      dsb[m * C + lane + 32 * i] = __float2bfloat16(ds);
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
cudaError_t attn_kernels_bf16(int phase, const bf16* q, const bf16* k, const bf16* v, bf16* att,
                              float* lse, const bf16* dO, const float* D, bf16* dqb, float* dbq,
                              float* dk, float* dv, int B, int P, int L, int C, int heads,
                              cudaStream_t s) {
  if (phase == 0) {
    constexpr size_t smem = AttnLayout<DH, 1, false>::kBytes;
    LC2_TRY(allow_smem(attn_fwd_mma<DH>, smem));
    attn_fwd_mma<DH><<<dim3((P + kAttnRows - 1) / kAttnRows, heads, B), kAttnThreads, smem, s>>>(
        q, k, v, att, lse, P, L, C);
    return cudaGetLastError();
  }
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

cudaError_t attn_kernels_bf16_dh(int phase, const bf16* q, const bf16* k, const bf16* v,
                                 bf16* att, float* lse, const bf16* dO, const float* D,
                                 bf16* dqb, float* dbq, float* dk, float* dv, int B, int P, int L,
                                 int C, int heads, cudaStream_t s) {
  switch (C / heads) {
    case 16: return attn_kernels_bf16<16>(phase, q, k, v, att, lse, dO, D, dqb, dbq, dk, dv, B, P, L, C, heads, s);
    case 32: return attn_kernels_bf16<32>(phase, q, k, v, att, lse, dO, D, dqb, dbq, dk, dv, B, P, L, C, heads, s);
    case 64: return attn_kernels_bf16<64>(phase, q, k, v, att, lse, dO, D, dqb, dbq, dk, dv, B, P, L, C, heads, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t post_ln_bf16(float* sd, const bf16* g, const float* lnw, bf16* dsb, float* dlnw,
                         float* dlnb, float* dbo, long long rows, int C, float eps,
                         cudaStream_t s) {
  const long long want = (rows + 7) / 8;
  const int blocks = (int)(want < 4 * 132 ? want : 4 * 132);
  switch (C) {
    case 64: post_ln_bwd_bf16<2><<<blocks, 256, 0, s>>>(sd, g, lnw, dsb, dlnw, dlnb, dbo, rows, eps); break;
    case 128: post_ln_bwd_bf16<4><<<blocks, 256, 0, s>>>(sd, g, lnw, dsb, dlnw, dlnb, dbo, rows, eps); break;
    case 256: post_ln_bwd_bf16<8><<<blocks, 256, 0, s>>>(sd, g, lnw, dsb, dlnw, dlnb, dbo, rows, eps); break;
    case 512: post_ln_bwd_bf16<16><<<blocks, 256, 0, s>>>(sd, g, lnw, dsb, dlnw, dlnb, dbo, rows, eps); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
  // q = x · Wqᵀ + bq, rounded
  LC2_TRY((gemm16::gemm<false, false>(bp, C, C, x, C, w.wqb, C,
                                      Epilogue{bq, nullptr, nullptr, nullptr, w.q, C, false}, s)));
  LC2_TRY(attn_kernels_bf16_dh(0, w.q, k, v, w.att, w.lse, nullptr, nullptr, nullptr, nullptr,
                               nullptr, nullptr, B, P, L, C, heads, s));
  // s = att · Woᵀ + bo + x, f32
  LC2_TRY((gemm16::gemm<false, false>(bp, C, C, w.att, C, w.wob, C,
                                      Epilogue{bo, nullptr, x, w.sd, nullptr, C, false}, s)));
  LC2_TRY(post_ln_bf16(w.sd, g, lnw, w.dsb, dlnw, dlnb, dbo, BP, C, eps, s));
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
  LC2_TRY(attn_kernels_bf16_dh(1, w.q, k, v, nullptr, w.lse, w.datt, w.D, dqb, dbq, dk, dv, B, P,
                               L, C, heads, s));
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
  const long long BP = (long long)B * P;
  return 6 * BP * C + 2LL * B * L * C + 2 * BP * heads;
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
