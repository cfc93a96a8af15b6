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
// Design, a sequence of launches with f32 intermediates in a workspace the
// wrapper allocates (the TPU kernel's (T, L) logits and whole-image dK/dV
// accumulators live in VMEM; here they are recomputed per tile instead):
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
// Products are csrc/gemm.cuh's kernels (weight gradients split over blocks
// with f32 atomics) and 64 x 64 tile products in shared memory.
#include <math_constants.h>

#include "gemm.cuh"

namespace lc2 {
namespace {

// f32 copy of a T array (a kernel operand the products read as f32)
template <typename T>
__global__ void __launch_bounds__(256) to_f32_kernel(const T* __restrict__ in, float* __restrict__ out,
                                                     long long n) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n; i += (long long)gridDim.x * 256)
    out[i] = to_f(in[i]);
}

template <typename T>
__global__ void __launch_bounds__(256) from_f32_kernel(const float* __restrict__ in, T* __restrict__ out,
                                                       long long n) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n; i += (long long)gridDim.x * 256)
    out[i] = from_f<T>(in[i]);
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
                int P, int L, int C, int round_out) {
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
      att[((long long)b * P + p0 + r) * C + h * DH + tx + 16 * j] = round_out ? round_bf16(val) : val;
    }
    if (tx == 0) lse[((long long)b * heads + h) * P + p0 + r] = mrow[r] + __logf(lrow[r]);
  }
}

// 3. post-LN backward from s = x + proj (f32, in place: s becomes ds); warp
// per row (grid-stride), dln_w / dln_b partials per block in shared memory
template <typename T>
__global__ void __launch_bounds__(256)
post_ln_bwd_kernel(float* __restrict__ s, const T* __restrict__ g, const float* __restrict__ lnw,
                   float* __restrict__ dlnw, float* __restrict__ dlnb, long long rows, int C,
                   float eps) {
  extern __shared__ float red[];  // [2][C]
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x; c < 2 * C; c += 256) red[c] = 0.0f;
  __syncthreads();
  for (long long m = blockIdx.x * 8LL + (threadIdx.x >> 5); m < rows; m += gridDim.x * 8LL) {
    float* sr = s + m * C;
    const T* gr = g + m * C;
    float a = 0.0f;
    for (int c = lane; c < C; c += 32) a += sr[c];
    const float mu = warp_sum(a) / C;
    float q = 0.0f;
    for (int c = lane; c < C; c += 32) q += (sr[c] - mu) * (sr[c] - mu);
    const float rs = rsqrtf(warp_sum(q) / C + eps);
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float sh = (sr[c] - mu) * rs, dy = to_f(gr[c]), dsh = dy * lnw[c];
      s1 += dsh;
      s2 += dsh * sh;
      atomicAdd(red + c, dy * sh);
      atomicAdd(red + C + c, dy);
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
    for (int c = lane; c < C; c += 32) {
      const float sh = (sr[c] - mu) * rs, dsh = to_f(gr[c]) * lnw[c];
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
                 float* __restrict__ dk, float* __restrict__ dv, int P, int L, int C,
                 int round_out) {
  constexpr int LD = Tiles<DH>::kLD, LP = Tiles<DH>::kLP, NJ = Tiles<DH>::NJ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + 64 * LD;
  float* qs = vs + 64 * LD;
  float* os = qs + 64 * LD;
  float* pt = os + 64 * LD;   // [64 keys][LP] P (rounded to T: the forward's PV operand)
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
        pt[r * LP + c] = round_out ? round_bf16(p) : p;
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
                      int P, int L, int C, int heads, int phase, int round_out, cudaStream_t s) {
  constexpr int LD = Tiles<DH>::kLD, LP = Tiles<DH>::kLP;
  if (phase == 0) {
    const size_t smem = sizeof(float) * (3 * 64 * LD + 64 * LP + 3 * 64);
    LC2_TRY(allow_smem(attn_fwd_kernel<DH>, smem));
    attn_fwd_kernel<DH><<<dim3((P + 63) / 64, heads, B), 256, smem, s>>>(q, k, v, att, lse, P, L,
                                                                        C, round_out);
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
      q, k, v, dO, lse, D, dk, dv, P, L, C, round_out);
  return cudaGetLastError();
}

cudaError_t attn_core_dh(int dh, const float* q, const float* k, const float* v, float* att,
                         float* lse, const float* dO, const float* D, float* dq, float* dk,
                         float* dv, int B, int P, int L, int C, int heads, int phase,
                         int round_out, cudaStream_t s) {
  switch (dh) {
    case 16: return attn_core<16>(q, k, v, att, lse, dO, D, dq, dk, dv, B, P, L, C, heads, phase, round_out, s);
    case 32: return attn_core<32>(q, k, v, att, lse, dO, D, dq, dk, dv, B, P, L, C, heads, phase, round_out, s);
    case 64: return attn_core<64>(q, k, v, att, lse, dO, D, dq, dk, dv, B, P, L, C, heads, phase, round_out, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t attn_bwd(const T* x, const T* k, const T* v, const T* g, const float* wq,
                     const float* bq, const float* wo, const float* bo, const float* lnw,
                     T* dx, float* dk, float* dv, float* dwq, float* dbq, float* dwo,
                     float* dbo, float* dlnw, float* dlnb, float* ws, int B, int P, int L, int C,
                     int heads, float eps, cudaStream_t s) {
  const long long BP = (long long)B * P, BL = (long long)B * L, PC = BP * C, LC = BL * C;
  const int rnd = sizeof(T) == 2, bp = (int)BP, dh = C / heads;
  float* xf = ws;           // [BP][C]
  float* kf = xf + PC;      // [BL][C]
  float* vf = kf + LC;      // [BL][C]
  float* q = vf + LC;       // [BP][C]
  float* att = q + PC;      // [BP][C]
  float* sd = att + PC;     // [BP][C]  s, then ds
  float* dO = sd + PC;      // [BP][C]
  float* dq = dO + PC;      // [BP][C]
  float* dxf = dq + PC;     // [BP][C]
  float* lse = dxf + PC;    // [B][heads][P]
  float* D = lse + BP * heads;  // [B·P][heads]
  const int eb = elementwise_blocks(PC);
  to_f32_kernel<T><<<eb, 256, 0, s>>>(x, xf, PC);
  LC2_TRY(cudaGetLastError());
  to_f32_kernel<T><<<elementwise_blocks(LC), 256, 0, s>>>(k, kf, LC);
  LC2_TRY(cudaGetLastError());
  to_f32_kernel<T><<<elementwise_blocks(LC), 256, 0, s>>>(v, vf, LC);
  LC2_TRY(cudaGetLastError());
  LC2_TRY(gemm(bp, C, C, Mat{xf, C, 1}, Mat{wq, 1, C}, q, C, bq, nullptr, rnd, s));
  LC2_TRY(attn_core_dh(dh, q, kf, vf, att, lse, nullptr, nullptr, nullptr, nullptr, nullptr, B,
                       P, L, C, heads, 0, rnd, s));
  LC2_TRY(gemm(bp, C, C, Mat{att, C, 1}, Mat{wo, 1, C}, sd, C, bo, xf, 0, s));
  {
    const long long want = (BP + 7) / 8;
    const int blocks = (int)(want < 4 * 132 ? want : 4 * 132);
    post_ln_bwd_kernel<T><<<blocks, 256, sizeof(float) * 2 * C, s>>>(sd, g, lnw, dlnw, dlnb, BP,
                                                                     C, eps);
    LC2_TRY(cudaGetLastError());
  }
  LC2_TRY(gemm_acc(C, C, bp, Mat{sd, 1, C}, Mat{att, C, 1}, dwo, C, s));
  LC2_TRY(colsum(bp, C, sd, C, dbo, s));
  LC2_TRY(gemm(bp, C, C, Mat{sd, C, 1}, Mat{wo, C, 1}, dO, C, nullptr, nullptr, 0, s));
  attn_delta_kernel<<<elementwise_blocks(BP * heads), 256, 0, s>>>(dO, att, D, BP, C, heads);
  LC2_TRY(cudaGetLastError());
  LC2_TRY(attn_core_dh(dh, q, kf, vf, att, lse, dO, D, dq, dk, dv, B, P, L, C, heads, 1, rnd, s));
  LC2_TRY(gemm_acc(C, C, bp, Mat{dq, 1, C}, Mat{xf, C, 1}, dwq, C, s));
  LC2_TRY(colsum(bp, C, dq, C, dbq, s));
  float* dx_out = sizeof(T) == 4 ? reinterpret_cast<float*>(dx) : dxf;
  LC2_TRY(gemm(bp, C, C, Mat{dq, C, 1}, Mat{wq, C, 1}, dx_out, C, nullptr, sd, 0, s));
  if (sizeof(T) == 2) {
    from_f32_kernel<T><<<eb, 256, 0, s>>>(dxf, dx, PC);
    LC2_TRY(cudaGetLastError());
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace lc2

// Workspace floats the backward needs (the wrapper allocates them).
extern "C" long long lc2_attn_block_bwd_workspace(int B, int P, int L, int C, int heads) {
  const long long BP = (long long)B * P;
  return 7 * BP * C + 2LL * B * L * C + 2 * BP * heads;
}

// x, g (gradient of out), dx (B, P, C) and k, v (B, L, C) of the dtype; wq
// (C, C) and bq (C,) with 1/sqrt(dh) folded in, wo (C, C), bo, lnw (C,): f32
// holding the values the forward kernel used.  dk, dv (B, L, C) f32;
// dwq, dbq, dwo, dbo, dlnw, dlnb f32, ZEROED by the caller.  ws:
// lc2_attn_block_bwd_workspace floats.  C / heads in {16, 32, 64}.
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
    return lc2::attn_bwd<float>(f(x), f(k), f(v), f(g), f(wq), f(bq), f(wo), f(bo), f(lnw), o(dx),
                                o(dk), o(dv), o(dwq), o(dbq), o(dwo), o(dbo), o(dlnw), o(dlnb),
                                o(ws), B, P, L, C, heads, eps, s);
  if (dtype == lc2::kBF16) {
    using bf = __nv_bfloat16;
    auto t = [](const void* p) { return static_cast<const bf*>(p); };
    return lc2::attn_bwd<bf>(t(x), t(k), t(v), t(g), f(wq), f(bq), f(wo), f(bo), f(lnw),
                             static_cast<bf*>(dx), o(dk), o(dv), o(dwq), o(dbq), o(dwo), o(dbo),
                             o(dlnw), o(dlnb), o(ws), B, P, L, C, heads, eps, s);
  }
  return cudaErrorInvalidValue;
}
