// swin_window_block_bwd: the backward of one swin attention half on the
// (B, H, W, C) canvas (csrc/swin_window.cu), HF SwinLayer semantics,
//
//   out = [x +] Wo · WindowAttention(QKV(pad(LN(x)) rolled by -shift)) + bo
//
// with the forward recomputed.  Replaces the two TPU backwards of the same
// function: lc2is_tpu/ops/swin_canvas.py::_canvas_bwd_kernel (:530, launched by
// _canvas_bwd_pallas :773; stages 1-3) and
// lc2is_tpu/ops/window_attention.py::_block_bwd_kernel (:701, launched by
// _fused_block_bwd_pallas :843; stage 4).  One entry point serves every
// stage.
//
// What bounds it on the card: arithmetic.  Per token the forward recompute
// and the backward do 3C² (QKV) + 2·C² (dWo, d heads) + 6C² (dWqkv, dLN
// input) multiply-adds, plus 4·49·C in the attention core.
//
// Design.  The TPU kernels keep a whole window block in VMEM; on Hopper a
// window's C-wide intermediates do not fit in shared memory beside the weight
// gradients (49 x 768 f32 is 150 KB per buffer), so the backward is a
// sequence of launches over the window-ordered tokens (B · nW · win² rows of
// HF's rolled, padded canvas; the roll, pad and crop are index arithmetic,
// never copies), with f32 intermediates in a workspace the wrapper allocates:
//   1. ln_gather: LN(x) per token (f32 statistics, rounded to T as in the
//      forward; a HF pad token is post-LN zero, pad AFTER the LN), and the
//      output gradient gathered into window order (zero on pad tokens: the
//      crop's adjoint);
//   2. qkv = LN · Wqkvᵀ + bqkv (rounded to T), dA = g · Wo;
//   3. attention core per (window group, head), all of it in shared memory:
//      recompute S = q·kᵀ + bias + region mask, the max-subtracted softmax of
//      the forward, O = round(P)·v (written for dWo); then dP = dA·vᵀ,
//      dV = round(P)ᵀ·dA, dS = P∘(dP − rowsum(P∘dP)), dQ = dS·k, dK = dSᵀ·q.
//      dbias sums dS over the windows a block owns in registers and adds
//      once per block;
//   4. dWo = gᵀ·O, dWqkv = dQKVᵀ·LN (products with K = all tokens, split
//      over blocks, f32 atomics), dbo, dbqkv (column sums);
//   5. dLN = dQKV · Wqkv, then LN backward with the scatter back to the canvas
//      (each real pixel is written once: the roll is a permutation) and
//      dln_w / dln_b summed per block, one atomic per channel per block.
// A pad token's k = bk and v = bv, so its dK and dV reach bqkv and nothing
// else.  Weight-gradient sums use f32 atomics, chosen over per-block partials
// and a second pass for simplicity; their order varies from run to run
// within f32 rounding.  The 1/√dh fold into the q rows is the wrapper's.
#include <math_constants.h>

#include "gemm.cuh"

namespace lc2 {
namespace {

struct Canvas {
  int H, W, C, win, shift, nwh, nww;
  __device__ __forceinline__ int n_win() const { return nwh * nww; }
  // canvas pixel (b·H·W + y·W + x) of window-ordered token m, or -1 for a HF
  // pad token; rolled (R, Cc) is canvas ((R + shift) % Hp, (Cc + shift) % Wp)
  __device__ __forceinline__ long long pixel(long long m) const {
    const int n = win * win;
    const int t = (int)(m % n);
    const long long wb = m / n;
    const int w = (int)(wb % n_win());
    const long long b = wb / n_win();
    const int wi = w / nww, wj = w - wi * nww;
    const int r = wi * win + t / win, c = wj * win + t % win;
    const int y = (r + shift) % (nwh * win), x = (c + shift) % (nww * win);
    if (y >= H || x >= W) return -1;
    return (b * H + y) * W + x;
  }
};

// 1. warp per window-ordered token
template <typename T>
__global__ void __launch_bounds__(256)
ln_gather_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ lnw,
                 const float* __restrict__ lnb, float* __restrict__ hn, float* __restrict__ gw,
                 float* __restrict__ mean_o, float* __restrict__ rstd_o, long long M, Canvas cv,
                 float eps) {
  const int lane = threadIdx.x & 31;
  const long long m = blockIdx.x * 8LL + (threadIdx.x >> 5);
  if (m >= M) return;  // warp-uniform
  const int C = cv.C;
  const long long pix = cv.pixel(m);
  float* hr = hn + m * C;
  float* gr = gw + m * C;
  if (pix < 0) {
    for (int c = lane; c < C; c += 32) hr[c] = gr[c] = 0.0f;
    if (lane == 0) mean_o[m] = rstd_o[m] = 0.0f;
    return;
  }
  const T* xr = x + pix * C;
  const T* g_r = g + pix * C;
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s += to_f(xr[c]);
  const float mu = warp_sum(s) / C;
  float q = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f(xr[c]) - mu;
    q += d * d;
  }
  const float rs = rsqrtf(warp_sum(q) / C + eps);
  for (int c = lane; c < C; c += 32) {
    hr[c] = round_t<T>((to_f(xr[c]) - mu) * rs * lnw[c] + lnb[c]);
    gr[c] = to_f(g_r[c]);
  }
  if (lane == 0) {
    mean_o[m] = mu;
    rstd_o[m] = rs;
  }
}

// 3. attention core forward recompute + backward; block = (window group,
// head, image), 256 threads; win² <= 64 tokens padded to 64.
template <int DH>
struct AttnSmem {
  static constexpr int kLD = DH + 1;
  static constexpr int kLP = 65;
  static constexpr size_t kBytes = sizeof(float) * (4 * 64 * kLD + 3 * 64 * kLP + 64) +
                                   sizeof(int) * 64;
};

template <int DH>
__global__ void __launch_bounds__(256)
swin_attn_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ dA,
                     const float* __restrict__ bias, float* __restrict__ att,
                     float* __restrict__ dqkv, float* __restrict__ dbias, Canvas cv, int wpb,
                     int round_out) {
  constexpr int LD = AttnSmem<DH>::kLD, LP = AttnSmem<DH>::kLP, NJ = DH / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [64][LD]
  float* ks = qs + 64 * LD;
  float* vs = ks + 64 * LD;
  float* os = vs + 64 * LD;   // dA head slice (gradient of the head outputs)
  float* ps = os + 64 * LD;   // [64][LP] P, f32
  float* pr = ps + 64 * LP;   // [64][LP] P rounded to T (the forward's PV operand)
  float* dps = pr + 64 * LP;  // [64][LP] dP, then dS
  float* dsum = dps + 64 * LP;  // [64] rowsum(P∘dP)
  int* lab = reinterpret_cast<int*>(dsum + 64);  // [64] shift region

  const int C = cv.C, C3 = 3 * C, win = cv.win, N = win * win, nW = cv.n_win();
  const int Hp = cv.nwh * win, Wp = cv.nww * win;
  const int hd = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, tx = tid & 15, ty = tid >> 4;
  const float* bh = bias + (size_t)hd * N * N;
  float dbacc[4][4];
  zero(dbacc);

  const int w_end = min(nW, (blockIdx.x + 1) * wpb);
  for (int w = blockIdx.x * wpb; w < w_end; ++w) {
    const long long tok0 = ((long long)b * nW + w) * N;
    __syncthreads();  // the previous window's tiles consumed
    for (int idx = tid; idx < 64 * DH; idx += 256) {
      const int t = idx / DH, d = idx - t * DH;
      float q = 0.0f, k = 0.0f, v = 0.0f, o = 0.0f;
      if (t < N) {
        const float* row = qkv + (tok0 + t) * C3 + hd * DH + d;
        q = row[0];
        k = row[C];
        v = row[2 * C];
        o = dA[(tok0 + t) * C + hd * DH + d];
      }
      qs[t * LD + d] = q;
      ks[t * LD + d] = k;
      vs[t * LD + d] = v;
      os[t * LD + d] = o;
    }
    if (tid < 64) {
      int l = 0;
      if (cv.shift > 0 && tid < N) {
        const int wi = w / cv.nww, wj = w - wi * cv.nww;
        const int R = wi * win + tid / win, Cc = wj * win + tid % win;
        l = ((R >= Hp - win) + (R >= Hp - cv.shift)) * 3 + (Cc >= Wp - win) +
            (Cc >= Wp - cv.shift);
      }
      lab[tid] = l;
    }
    __syncthreads();

    {  // S = q·kᵀ + bias + region mask (q carries 1/√dh)
      float s[4][4];
      zero(s);
      tile_mm<4, 4>(s, qs, LD, 1, ks, LD, 1, DH);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          float v = -CUDART_INF_F;
          if (r < N && c < N) v = s[i][j] + bh[r * N + c] - (lab[r] != lab[c] ? 100.0f : 0.0f);
          ps[r * LP + c] = v;
        }
    }
    __syncthreads();
    for (int r = warp; r < 64; r += 8) {  // max-subtracted softmax, as the forward
      float p0 = 0.0f, p1 = 0.0f;
      if (r < N) {
        const float a0 = ps[r * LP + lane], a1 = ps[r * LP + lane + 32];
        const float mx = warp_max(fmaxf(a0, a1));
        const float e0 = __expf(a0 - mx), e1 = __expf(a1 - mx);
        const float inv = 1.0f / warp_sum(e0 + e1);
        p0 = e0 * inv;
        p1 = e1 * inv;
      }
      ps[r * LP + lane] = p0;
      ps[r * LP + lane + 32] = p1;
      pr[r * LP + lane] = round_out ? round_bf16(p0) : p0;
      pr[r * LP + lane + 32] = round_out ? round_bf16(p1) : p1;
    }
    __syncthreads();

    float dp[4][4];
    {  // O = round(P)·v (head outputs for dWo), dP = dA·vᵀ
      float o[4][NJ];
      zero(o);
      tile_mm<4, NJ>(o, pr, LP, 1, vs, 1, LD, 64);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= N) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float v = o[i][j];
          att[(tok0 + r) * C + hd * DH + tx + 16 * j] = round_out ? round_bf16(v) : v;
        }
      }
      zero(dp);
      tile_mm<4, 4>(dp, os, LD, 1, vs, LD, 1, DH);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dps[(ty + 16 * i) * LP + tx + 16 * j] = dp[i][j];
    }
    __syncthreads();
    for (int r = warp; r < 64; r += 8) {
      const float d = warp_sum(ps[r * LP + lane] * dps[r * LP + lane] +
                               ps[r * LP + lane + 32] * dps[r * LP + lane + 32]);
      if (lane == 0) dsum[r] = d;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // dS = P∘(dP − rowsum(P∘dP)); the mask is constant
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float ds = ps[r * LP + c] * (dp[i][j] - dsum[r]);
        dbacc[i][j] += ds;
        dps[r * LP + c] = ds;
      }
    __syncthreads();

    float* dq_row = dqkv + tok0 * C3 + hd * DH;
    {  // dV = round(P)ᵀ·dA
      float a[4][NJ];
      zero(a);
      tile_mm<4, NJ>(a, pr, 1, LP, os, 1, LD, 64);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= N) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) dq_row[r * C3 + 2 * C + tx + 16 * j] = a[i][j];
      }
    }
    {  // dQ = dS·k
      float a[4][NJ];
      zero(a);
      tile_mm<4, NJ>(a, dps, LP, 1, ks, 1, LD, 64);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= N) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) dq_row[r * C3 + tx + 16 * j] = a[i][j];
      }
    }
    {  // dK = dSᵀ·q
      float a[4][NJ];
      zero(a);
      tile_mm<4, NJ>(a, dps, 1, LP, qs, 1, LD, 64);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= N) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) dq_row[r * C3 + C + tx + 16 * j] = a[i][j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      if (r < N && c < N) atomicAdd(dbias + (size_t)hd * N * N + r * N + c, dbacc[i][j]);
    }
}

// 5. LN backward + scatter to the canvas; warp per token (grid-stride), the
// block's dln_w / dln_b partials in shared memory.
template <typename T>
__global__ void __launch_bounds__(256)
ln_bwd_scatter_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ dhn, const float* __restrict__ mean,
                      const float* __restrict__ rstd, const float* __restrict__ lnw,
                      T* __restrict__ dx, float* __restrict__ dlnw, float* __restrict__ dlnb,
                      long long M, Canvas cv, int residual) {
  extern __shared__ float red[];  // [2][C]
  const int C = cv.C, lane = threadIdx.x & 31;
  for (int c = threadIdx.x; c < 2 * C; c += 256) red[c] = 0.0f;
  __syncthreads();
  for (long long m = blockIdx.x * 8LL + (threadIdx.x >> 5); m < M; m += gridDim.x * 8LL) {
    const long long pix = cv.pixel(m);
    if (pix < 0) continue;  // warp-uniform; a pad token's LN output is a constant
    const float mu = mean[m], rs = rstd[m];
    const T* xr = x + pix * C;
    const float* dr = dhn + m * C;
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float xh = (to_f(xr[c]) - mu) * rs, dy = dr[c], dxh = dy * lnw[c];
      s1 += dxh;
      s2 += dxh * xh;
      atomicAdd(red + c, dy * xh);
      atomicAdd(red + C + c, dy);
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
    for (int c = lane; c < C; c += 32) {
      const float xh = (to_f(xr[c]) - mu) * rs, dxh = dr[c] * lnw[c];
      float v = rs * (dxh - s1 - xh * s2);
      if (residual) v += to_f(g[pix * C + c]);
      dx[pix * C + c] = from_f<T>(v);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += 256) {
    atomicAdd(dlnw + c, red[c]);
    atomicAdd(dlnb + c, red[C + c]);
  }
}

template <int DH>
cudaError_t attn_core(const float* qkv, const float* dA, const float* bias, float* att,
                      float* dqkv, float* dbias, Canvas cv, int B, int heads, int round_out,
                      cudaStream_t s) {
  const size_t smem = AttnSmem<DH>::kBytes;
  LC2_TRY(allow_smem(swin_attn_bwd_kernel<DH>, smem));
  const int nW = cv.nwh * cv.nww;
  const int wpb = max(1, nW * heads * B / (4 * 132));  // about four blocks per SM
  const dim3 grid((nW + wpb - 1) / wpb, heads, B);
  swin_attn_bwd_kernel<DH><<<grid, 256, smem, s>>>(qkv, dA, bias, att, dqkv, dbias, cv, wpb,
                                                   round_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t swin_bwd(const T* x, const T* g, const float* lnw, const float* lnb,
                     const float* wqkv, const float* bqkv, const float* wo, const float* bias,
                     T* dx, float* dlnw, float* dlnb, float* dwqkv, float* dbqkv, float* dwo,
                     float* dbo, float* dbias, float* ws, int B, int H, int W, int C, int heads,
                     int win, int shift, int residual, float eps, cudaStream_t s) {
  const Canvas cv{H, W, C, win, shift, (H + win - 1) / win, (W + win - 1) / win};
  const long long M = (long long)B * cv.nwh * cv.nww * win * win;
  const long long MC = M * C;
  float* hn = ws;            // [M][C]  LN(x), window order
  float* gw = hn + MC;       // [M][C]  output gradient, window order
  float* qkv = gw + MC;      // [M][3C]
  float* dA = qkv + 3 * MC;  // [M][C]  gradient of the head outputs
  float* att = dA + MC;      // [M][C]  head outputs
  float* dqkv = att + MC;    // [M][3C]
  float* dhn = dqkv + 3 * MC;  // [M][C]
  float* mean = dhn + MC;    // [M]
  float* rstd = mean + M;    // [M]
  const int rnd = sizeof(T) == 2;
  const int mi = (int)M;

  ln_gather_kernel<T><<<(unsigned)((M + 7) / 8), 256, 0, s>>>(x, g, lnw, lnb, hn, gw, mean, rstd,
                                                              M, cv, eps);
  LC2_TRY(cudaGetLastError());
  LC2_TRY(gemm(mi, 3 * C, C, Mat{hn, C, 1}, Mat{wqkv, 1, C}, qkv, 3 * C, bqkv, nullptr, rnd, s));
  LC2_TRY(gemm(mi, C, C, Mat{gw, C, 1}, Mat{wo, C, 1}, dA, C, nullptr, nullptr, 0, s));
  switch (C / heads) {
    case 16: LC2_TRY(attn_core<16>(qkv, dA, bias, att, dqkv, dbias, cv, B, heads, rnd, s)); break;
    case 32: LC2_TRY(attn_core<32>(qkv, dA, bias, att, dqkv, dbias, cv, B, heads, rnd, s)); break;
    case 64: LC2_TRY(attn_core<64>(qkv, dA, bias, att, dqkv, dbias, cv, B, heads, rnd, s)); break;
    default: return cudaErrorInvalidValue;
  }
  LC2_TRY(gemm_acc(C, C, mi, Mat{gw, 1, C}, Mat{att, C, 1}, dwo, C, s));
  LC2_TRY(colsum(mi, C, gw, C, dbo, s));
  LC2_TRY(gemm_acc(3 * C, C, mi, Mat{dqkv, 1, 3 * C}, Mat{hn, C, 1}, dwqkv, C, s));
  LC2_TRY(colsum(mi, 3 * C, dqkv, 3 * C, dbqkv, s));
  LC2_TRY(gemm(mi, C, 3 * C, Mat{dqkv, 3 * C, 1}, Mat{wqkv, C, 1}, dhn, C, nullptr, nullptr, 0, s));
  const long long want = (M + 7) / 8;
  const int blocks = (int)(want < 4 * 132 ? want : 4 * 132);
  ln_bwd_scatter_kernel<T><<<blocks, 256, sizeof(float) * 2 * C, s>>>(
      x, g, dhn, mean, rstd, lnw, dx, dlnw, dlnb, M, cv, residual);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lc2

// Workspace floats the backward needs (the wrapper allocates them).
extern "C" long long lc2_swin_window_bwd_workspace(int B, int H, int W, int C, int win) {
  const long long M = (long long)B * ((H + win - 1) / win) * ((W + win - 1) / win) * win * win;
  return M * (11LL * C + 2);
}

// x, g (gradient of out), dx (B, H, W, C) of the dtype; lnw, lnb (C,),
// wqkv (3C, C) packed q|k|v with 1/sqrt(dh) folded into the q rows, bqkv
// (3C,), wo (C, C), bias (heads, win², win²): all f32, holding the values the
// forward kernel used.  dlnw, dlnb, dwqkv, dbqkv, dwo, dbo, dbias f32 of the
// same shapes, ZEROED by the caller (the kernels accumulate into them).
// ws: lc2_swin_window_bwd_workspace floats.  win <= 8, 0 <= shift < win,
// C / heads in {16, 32, 64}.
extern "C" int lc2_swin_window_bwd(int dtype, const void* x, const void* g, const void* lnw,
                                   const void* lnb, const void* wqkv, const void* bqkv,
                                   const void* wo, const void* bias, void* dx, void* dlnw,
                                   void* dlnb, void* dwqkv, void* dbqkv, void* dwo, void* dbo,
                                   void* dbias, void* ws, int B, int H, int W, int C, int heads,
                                   int win, int shift, int residual, float eps, void* stream) {
  if (win < 1 || win * win > 64 || shift < 0 || shift >= win || heads < 1 || C % heads)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  if (dtype == lc2::kF32)
    return lc2::swin_bwd<float>(f(x), f(g), f(lnw), f(lnb), f(wqkv), f(bqkv), f(wo), f(bias),
                                o(dx), o(dlnw), o(dlnb), o(dwqkv), o(dbqkv), o(dwo), o(dbo),
                                o(dbias), o(ws), B, H, W, C, heads, win, shift, residual, eps, s);
  if (dtype == lc2::kBF16) {
    using bf = __nv_bfloat16;
    return lc2::swin_bwd<bf>(static_cast<const bf*>(x), static_cast<const bf*>(g), f(lnw), f(lnb),
                             f(wqkv), f(bqkv), f(wo), f(bias), static_cast<bf*>(dx), o(dlnw),
                             o(dlnb), o(dwqkv), o(dbqkv), o(dwo), o(dbo), o(dbias), o(ws), B, H,
                             W, C, heads, win, shift, residual, eps, s);
  }
  return cudaErrorInvalidValue;
}
