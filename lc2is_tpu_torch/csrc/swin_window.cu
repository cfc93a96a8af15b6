// swin_window_block: one swin attention half straight on the (B, H, W, C)
// canvas, in HF SwinLayer semantics:
//
//   out = [x +] Wo · WindowAttention(QKV(pad(LN(x)) rolled by -shift)) + bo
//
// (residual = 0 returns the branch alone: the stochastic-depth training path
// adds the residual outside, as lc2is_tpu/nn/swin.py:316-335 does).
//
// Replaces two TPU kernels that compute this same function and were split
// only by VMEM and compile gates (lc2is_tpu/nn/swin.py:277-306):
// lc2is_tpu/ops/swin_canvas.py::_canvas_kernel (:224, entry swin_canvas_block
// :974; stages 1-3) and lc2is_tpu/ops/window_attention.py::_block_kernel
// (:386, entry fused_window_block :645; stage 4).  One kernel serves all four
// stages, with no C gate.
//
// What bounds it on the card: arithmetic.  Per token it does 3C² (QKV) + C²
// (out-proj) + 2·49·C (attention) multiply-adds against 2·C·bytes of canvas
// traffic; this first version runs them on the CUDA cores in f32.
//
// Design: one block per window of HF's padded, rolled canvas.  The block
// computes window, shift and pad membership of its 49 tokens from canvas
// coordinates (explicit roll indexing: rolled (R, Cc) is canvas
// ((R + shift) % Hp, (Cc + shift) % Wp)), so it reads the raw canvas and
// writes each real token back exactly once; no pad, roll or partition pass
// runs outside.  Per window:
//   1. LayerNorm statistics per token in f32 (two-pass);
//   2. per head: q/k/v (49 x dh each) by a tiled product whose A tiles are
//      LayerNorm'd on the fly from the canvas (rounded to T, as the reference
//      rounds the LN output), so no C-wide LN copy has to fit in shared
//      memory.  HF pads AFTER layernorm_before: a token at row >= H or col >= W
//      of the padded canvas is post-LN zero, so its k = bk and v = bv, and it
//      takes part in attention (swin_canvas.py:19-25);
//   3. per head, softmax(q·kᵀ + relative-position bias + region mask) · v;
//      the region mask is HF's 9-region img_mask on rolled coordinates with
//      its additive -100.  Unlike the TPU kernel (window_attention.py:51-55)
//      the softmax subtracts the row max: no row of a real token is fully
//      masked, so this changes nothing but the rounding;
//   4. the head outputs (49 x C, rounded to T) stay in shared memory and the
//      out-projection, + bo and the residual run per 128-column chunk.
// The TPU's head-pair MXU packing is not carried over.
// Shared memory: 49·C floats for the head outputs + tiles (≈ 200 KB at C = 768).
#include <math_constants.h>

#include "common.cuh"

namespace lc2 {
namespace {

constexpr int kThreads = 256;
constexpr int kNP = 64;   // window tokens, padded (window <= 8)
constexpr int kKT = 32;   // K tile
constexpr int kLD = kKT + 1;
constexpr int kNO = 128;  // out-projection column chunk

template <int DH>
struct Layout {
  static constexpr int kNQ = 3 * DH;                 // q|k|v columns of one head
  static constexpr int kQJ = kNQ / 16;               // columns per thread (16 column groups)
  static constexpr int kTileRows = (kNP + kNQ > kNO) ? kNP + kNQ : kNO;
  static constexpr int kLDH = DH + 1;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
swin_window_kernel(const T* __restrict__ x, const T* __restrict__ lnw,
                   const T* __restrict__ lnb, const T* __restrict__ wqkv,
                   const T* __restrict__ bqkv, const T* __restrict__ wo,
                   const T* __restrict__ bo, const float* __restrict__ bias,
                   T* __restrict__ out, int H, int W, int C, int heads, int win,
                   int shift, int nww, int residual, float eps) {
  using Lay = Layout<DH>;
  const int N = win * win;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* as = reinterpret_cast<float*>(smem_raw);  // [N][C] head outputs
  float* tiles = as + N * C;                          // A|B tiles, or the Wo tile
  float* at = tiles;                                  // [kNP][kLD]
  float* bt = tiles + kNP * kLD;                      // [kNQ][kLD]
  float* qs = tiles + Lay::kTileRows * kLD;           // [kNP][kLDH]
  float* ks = qs + kNP * Lay::kLDH;
  float* vs = ks + kNP * Lay::kLDH;
  float* ps = vs + kNP * Lay::kLDH;                   // [8 warps][kNP] probabilities
  float* mean = ps + 8 * kNP;                         // [kNP]
  float* rstd = mean + kNP;                           // [kNP]
  int* tok = reinterpret_cast<int*>(rstd + kNP);      // [kNP] canvas pixel, -1 = HF pad
  int* lab = tok + kNP;                               // [kNP] shift region

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, wi = blockIdx.x / nww, wj = blockIdx.x - wi * nww;
  const int Hp = gridDim.x / nww * win, Wp = nww * win;
  const T* xb = x + (size_t)b * H * W * C;
  T* ob = out + (size_t)b * H * W * C;

  // ---- token geometry: roll, HF pad, 9-region labels ----
  if (tid < kNP) {
    int t_pix = -1, t_lab = 0;
    if (tid < N) {
      const int R = wi * win + tid / win, Cc = wj * win + tid % win;  // rolled coords
      const int y = (R + shift) % Hp, xq = (Cc + shift) % Wp;        // canvas coords
      if (y < H && xq < W) t_pix = y * W + xq;
      if (shift > 0) {
        const int rh = (R >= Hp - win) + (R >= Hp - shift);
        const int rc = (Cc >= Wp - win) + (Cc >= Wp - shift);
        t_lab = rh * 3 + rc;
      }
    }
    tok[tid] = t_pix;
    lab[tid] = t_lab;
  }
  __syncthreads();

  // ---- LayerNorm statistics (f32, two-pass) ----
  for (int t = warp; t < N; t += 8) {
    const int pix = tok[t];
    float mu = 0.0f, rs = 0.0f;
    if (pix >= 0) {
      const T* xr = xb + (size_t)pix * C;
      float s = 0.0f;
      for (int c = lane; c < C; c += 32) s += to_f(xr[c]);
      mu = warp_sum(s) / C;
      float q = 0.0f;
      for (int c = lane; c < C; c += 32) {
        const float d = to_f(xr[c]) - mu;
        q += d * d;
      }
      rs = rsqrtf(warp_sum(q) / C + eps);
    }
    if (lane == 0) {
      mean[t] = mu;
      rstd[t] = rs;
    }
  }

  // ---- per head: q/k/v, then windowed attention into as ----
  const int tx = tid & 15, ty = tid >> 4;  // QKV product: 16 column groups x 16 row groups
  for (int hd = 0; hd < heads; ++hd) {
    float acc[4][Lay::kQJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < Lay::kQJ; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < C; k0 += kKT) {
      __syncthreads();  // previous tiles consumed (and mean/rstd/tok visible)
      for (int idx = tid; idx < kNP * kKT; idx += kThreads) {
        const int m = idx / kKT, kk = idx - m * kKT, c = k0 + kk;
        float a = 0.0f;
        if (m < N) {
          const int pix = tok[m];
          if (pix >= 0)
            a = round_t<T>((to_f(xb[(size_t)pix * C + c]) - mean[m]) * rstd[m] * to_f(lnw[c]) +
                           to_f(lnb[c]));
        }
        at[m * kLD + kk] = a;
      }
      for (int idx = tid; idx < Lay::kNQ * kKT; idx += kThreads) {
        const int n = idx / kKT, kk = idx - n * kKT;
        const int row = (n / DH) * C + hd * DH + (n % DH);  // q, k or v row of wqkv
        bt[n * kLD + kk] = to_f(wqkv[(size_t)row * C + k0 + kk]);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKT; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = at[(ty * 4 + i) * kLD + kk];
#pragma unroll
        for (int j = 0; j < Lay::kQJ; ++j) {
          const float w = bt[(tx + 16 * j) * kLD + kk];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] += a[i] * w;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < Lay::kQJ; ++j) {
      const int n = tx + 16 * j, part = n / DH, d = n % DH;
      const float bb = to_f(bqkv[part * C + hd * DH + d]);
      float* dst = part == 0 ? qs : (part == 1 ? ks : vs);
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[(ty * 4 + i) * Lay::kLDH + d] = round_t<T>(acc[i][j] + bb);
    }
    __syncthreads();

    const float* bh = bias + (size_t)hd * N * N;
    float* pw = ps + warp * kNP;
    for (int t = warp; t < N; t += 8) {
      float s[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u;
        float a = -CUDART_INF_F;
        if (j < N) {
          a = 0.0f;
#pragma unroll
          for (int d = 0; d < DH; ++d) a += qs[t * Lay::kLDH + d] * ks[j * Lay::kLDH + d];
          a += bh[t * N + j];
          if (lab[t] != lab[j]) a -= 100.0f;
        }
        s[u] = a;
      }
      const float mx = warp_max(fmaxf(s[0], s[1]));
      const float e0 = __expf(s[0] - mx), e1 = __expf(s[1] - mx);
      const float inv = 1.0f / warp_sum(e0 + e1);
      pw[lane] = round_t<T>(e0 * inv);
      pw[lane + 32] = round_t<T>(e1 * inv);
      __syncwarp();
      for (int d = lane; d < DH; d += 32) {
        float o = 0.0f;
        for (int j = 0; j < N; ++j) o += pw[j] * vs[j * Lay::kLDH + d];
        as[t * C + hd * DH + d] = round_t<T>(o);
      }
      __syncwarp();
    }
  }

  // ---- out-projection + bo + residual, 128 columns at a time ----
  for (int n0 = 0; n0 < C; n0 += kNO) {
    float acc[8][kNO / 32];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < kNO / 32; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < C; k0 += kKT) {
      __syncthreads();
      for (int idx = tid; idx < kNO * kKT; idx += kThreads) {
        const int n = idx / kKT, kk = idx - n * kKT;
        tiles[n * kLD + kk] = n0 + n < C ? to_f(wo[(size_t)(n0 + n) * C + k0 + kk]) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = warp * 8 + i;
        if (m >= N) break;  // warp-uniform
        const float* ar = as + m * C + k0;
#pragma unroll 8
        for (int kk = 0; kk < kKT; ++kk) {
          const float a = ar[kk];
#pragma unroll
          for (int j = 0; j < kNO / 32; ++j) acc[i][j] += a * tiles[(lane + 32 * j) * kLD + kk];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = warp * 8 + i;
      if (m >= N) break;
      const int pix = tok[m];
      if (pix < 0) continue;  // HF pad: cropped
#pragma unroll
      for (int j = 0; j < kNO / 32; ++j) {
        const int c = n0 + lane + 32 * j;
        if (c < C) {
          const size_t o = (size_t)pix * C + c;
          ob[o] = from_f<T>(acc[i][j] + to_f(bo[c]) + (residual ? to_f(xb[o]) : 0.0f));
        }
      }
    }
  }
}

template <int DH>
size_t smem_bytes(int N, int C) {
  using Lay = Layout<DH>;
  return sizeof(float) * ((size_t)N * C + Lay::kTileRows * kLD + 3 * kNP * Lay::kLDH +
                          8 * kNP + 2 * kNP) +
         sizeof(int) * 2 * kNP;
}

template <typename T, int DH>
cudaError_t launch(const void* x, const void* lnw, const void* lnb, const void* wqkv,
                   const void* bqkv, const void* wo, const void* bo, const float* bias,
                   void* out, int B, int H, int W, int C, int heads, int win, int shift,
                   int residual, float eps, cudaStream_t stream) {
  const int nwh = (H + win - 1) / win, nww = (W + win - 1) / win;
  const size_t smem = smem_bytes<DH>(win * win, C);
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = swin_window_kernel<T, DH>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nwh * nww, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(lnw), static_cast<const T*>(lnb),
      static_cast<const T*>(wqkv), static_cast<const T*>(bqkv), static_cast<const T*>(wo),
      static_cast<const T*>(bo), bias, static_cast<T*>(out), H, W, C, heads, win, shift,
      nww, residual, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* x, const void* lnw, const void* lnb, const void* wqkv,
                        const void* bqkv, const void* wo, const void* bo, const float* bias,
                        void* out, int B, int H, int W, int C, int heads, int win, int shift,
                        int residual, float eps, cudaStream_t stream) {
  if (heads < 1 || C % heads != 0) return cudaErrorInvalidValue;
  switch (C / heads) {
    case 16:
      return launch<T, 16>(x, lnw, lnb, wqkv, bqkv, wo, bo, bias, out, B, H, W, C, heads,
                           win, shift, residual, eps, stream);
    case 32:
      return launch<T, 32>(x, lnw, lnb, wqkv, bqkv, wo, bo, bias, out, B, H, W, C, heads,
                           win, shift, residual, eps, stream);
    case 64:
      return launch<T, 64>(x, lnw, lnb, wqkv, bqkv, wo, bo, bias, out, B, H, W, C, heads,
                           win, shift, residual, eps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace lc2

// x, out (B, H, W, C) contiguous; wqkv (3C, C) packed q|k|v torch layout with
// 1/sqrt(dh) folded into the q rows; bqkv (3C,); wo (C, C); bo, lnw, lnb (C,);
// bias (heads, win², win²) f32 in standard token order; residual 0 drops the
// + x.  win <= 8,
// 0 <= shift < win, C % 32 == 0, C / heads in {16, 32, 64}.
extern "C" int lc2_swin_window(int dtype, const void* x, const void* lnw, const void* lnb,
                               const void* wqkv, const void* bqkv, const void* wo,
                               const void* bo, const void* bias, void* out, int B, int H,
                               int W, int C, int heads, int win, int shift, int residual,
                               float eps, void* stream) {
  if (win < 1 || win * win > lc2::kNP || shift < 0 || shift >= win || C % lc2::kKT != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  if (dtype == lc2::kF32)
    return lc2::dispatch_dh<float>(x, lnw, lnb, wqkv, bqkv, wo, bo, bf, out, B, H, W, C,
                                   heads, win, shift, residual, eps, s);
  if (dtype == lc2::kBF16)
    return lc2::dispatch_dh<__nv_bfloat16>(x, lnw, lnb, wqkv, bqkv, wo, bo, bf, out, B, H,
                                           W, C, heads, win, shift, residual, eps, s);
  return cudaErrorInvalidValue;
}
