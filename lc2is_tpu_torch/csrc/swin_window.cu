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
// (:386, entry fused_window_block :645; C > 384).  The f32 and int8 bodies
// serve every stage with no C gate; the bf16 float block takes two plans,
// split at the JAX package's gate (C 384).
//
// What bounds it on the card: arithmetic.  Per token it does 3C² (QKV) + C²
// (out-proj) + 2·49·C (attention) multiply-adds against 2·C·bytes of canvas
// traffic.
//
// Token geometry, shared by every body: a block computes window, shift and
// pad membership of its tokens from canvas coordinates (explicit roll
// indexing: rolled (R, Cc) is canvas ((R + shift) % Hp, (Cc + shift) % Wp)),
// so it reads canvas-ordered rows and writes each real token back exactly
// once; no pad, roll or partition pass runs outside.  HF pads AFTER
// layernorm_before: a token at row >= H or col >= W of the padded canvas is
// post-LN zero, so its k = bk and v = bv, and it takes part in attention
// (swin_canvas.py:19-25).  The region mask is HF's 9-region img_mask on
// rolled coordinates with its additive -100.  Unlike the TPU kernel
// (window_attention.py:51-55) the softmax subtracts the row max: no row of a
// real token is fully masked, so this changes nothing but the rounding.  The
// TPU's head-pair MXU packing is not carried over.
//
// int8 block (swin_window_kernel, lc2_swin_window_q): one block per window,
// on the CUDA cores.  Per window:
//   1. LayerNorm statistics per token in f32 (two-pass);
//   2. per head: q/k/v (49 x dh each) by a tiled product whose A tiles are
//      LayerNorm'd and quantised on the fly from the canvas, so no C-wide LN
//      copy has to fit in shared memory;
//   3. per head, softmax(q·kᵀ + relative-position bias + region mask) · v;
//   4. the head outputs (49 x C) stay in shared memory and the
//      out-projection, + bo and the residual run per 128-column chunk.
// Shared memory: 49·C floats for the head outputs + tiles (the q, k, v tiles
// overlay the product's A|B tiles, which are consumed before they are
// written): ≈ 200 KB at C = 768, ≈ 224 KB at C = 1024 with dh 32.
//
// bf16 float block, C <= 384 (TPU row 6; swin_mma_kernel, the one-kernel
// plan): tensor cores, mma.sync m16n8k16 with f32 accumulators
// (mma_bf16.cuh).  A block takes 4, 2 or 1 windows, as many as fit the
// SM's shared memory with one or two blocks an SM (one_kernel_wpb: 2 at
// each of the swin-small stages 1-3), their tokens packed at N = win² rows
// a window, so each bf16 k-slice of Wqkv and Wo serves up to 4·N token rows:
//   1. LayerNorm once per token (two-pass f32 statistics, rounded to bf16 as
//      the reference rounds the LN output; HF pad tokens zero) into a bf16
//      tile that serves every head's QKV product;
//   2. per head, q|k|v = LN · Wqkv rowsᵀ + bias on the tensor cores (the
//      weight rows stream through a 2-stage cp.async ring of 64-wide
//      k-slices (32 where C is no multiple of 64), one stream over every head
//      and then Wo, so the next head's first slice loads during this head's
//      attention), rounded to bf16;
//   3. per head and window, a warp per 16 query rows: S = q · kᵀ over the
//      window's 64-row key tile in registers (keys past the window's N
//      dropped), + the relative-position bias and the -100 region mask, the
//      row max and sum over the row's 4 lanes by 2 shuffles each; the
//      unnormalised e = exp(s − max) is rounded to bf16 straight into the A
//      fragment of P · V and the result scaled by 1 / Σ e afterwards, the
//      rounding order of the TPU canvas kernel (swin_canvas.py:394-398);
//      the head outputs go to a bf16 tile in shared memory;
//   4. the out-projection on the tensor cores in 64-column chunks from that
//      tile, + bo and the residual in the epilogue, written for real tokens
//      only (HF pad tokens are cropped).
// Shared memory: 2 · 49 · windows · (C + 8) bf16 for the LN and head-output
// tiles, the q, k, v tiles of one head and the ring.
//
// bf16 float block, C > 384 (TPU row 9's range, the JAX package's gate
// lc2is_tpu/nn/swin.py:290-306; the token-major plan, launch_token_major).
// There one window a block is all that fits an SM, so every block would
// stream all of Wqkv and Wo for 49 token rows.  Instead the plan runs four
// launches from the one C entry, through a workspace the wrapper allocates
// (lc2_swin_window_workspace_bf16), keeping every rounding point above:
//   1. swin_ln_kernel: the LayerNorm of step 1 for the B·H·W real tokens in
//      canvas order, a warp a row, into a (B·H·W, C) bf16 buffer (and bqkv,
//      bo widened to f32 for the two epilogues);
//   2. q|k|v = LN · Wqkvᵀ + bqkv for the real tokens on the GEMM of
//      gemm_bf16.cuh, rounded to bf16 into a (B·H·W, 3C) buffer; an HF pad
//      token gets no row: its LN output is zero, so its q|k|v is bqkv;
//   3. swin_core_mma, step 3 with the tokens gathered: a block walks windows
//      of one head, each window's q, k and v head slices gathered from that
//      buffer by the roll and pad indexing (bqkv's slices at HF pad tokens)
//      through a 2-stage cp.async ring, the head's bias in shared memory;
//      the head outputs of real tokens, rounded as in step 3, into step 1's
//      buffer (consumed by then);
//   4. the out-projection of the real tokens on the same GEMM, + bo and the
//      residual in its epilogue, rounded once as step 4 rounds.
// The products run at the GEMM's rate over M = B·H·W rows, and each weight
// matrix is read once a 128-row tile instead of once a window.
//
// f32 float block, every C (TPU rows 6 and 9; launch_f32_plan): the same
// token-major plan with every product on the tensor cores in 3xTF32
// (gemm_f32x3.cuh: each operand split into TF32 hi and lo halves, lo·hi' +
// hi·lo' + hi·hi' on mma.sync m16n8k8, f32-accurate) and nothing rounded
// below f32, through lc2_swin_window_workspace_f32 (4·B·H·W·C floats):
//   1. swin_ln_f32_kernel: the LayerNorm of the real tokens, a warp a row,
//      two-pass f32 statistics, into a (B·H·W, C) f32 buffer;
//   2. q|k|v = LN · Wqkvᵀ + bqkv on gemm32::gemm into a (B·H·W, 3C) buffer;
//   3. swin_core_x3: grid (window group, head), a warp per 16 of a window's
//      64 rows, each window's q, k and v head slices gathered as
//      swin_core_mma gathers them (f32, through a 2-stage cp.async ring),
//      k and v split into hi and lo once a window in shared memory, S = q·kᵀ
//      + bias − 100 across regions (keys past win² dropped), the
//      max-subtracted softmax in f32, O = e·v · (1 / Σ e) (the tiles and
//      fragment orders of the forward half of swin_window_bwd.cu's
//      swin_attn_bwd_x3); each product sums 32-wide k-slices apart, and
//      every mma's products are added in f32 (round to nearest), as in the
//      GEMM, so that the tensor cores' truncating adds do not drift; the
//      head outputs of real tokens into step 1's buffer;
//   4. out = head outputs · Woᵀ + bo [+ x] on gemm32::gemm, x the epilogue's
//      f32 addend.
//
// The int8 block, lc2_swin_window_q, is the serving variant: the
// quant=True branch of window_attention.py::_block_kernel (:414-418,
// :468-476, forward only): the LN output, in f32 and re-zeroed at pad tokens,
// is quantised per token for an int8 packed QKV product, and the head
// outputs per token for an int8 out-projection (common.cuh: quant_scale /
// quant_code / dequant; per-output-channel weight codes with f32 scales).
// Both products stay on the CUDA cores as integer-valued f32 sums, exact
// while |acc| < 2^24 (C·127² <= 1.66e7 at C <= 1024).
#include <math.h>
#include <math_constants.h>

#include <algorithm>
#include <type_traits>

#include "attn_tiles.cuh"
#include "common.cuh"
#include "gemm_bf16.cuh"
#include "gemm_f32x3.cuh"

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
  // the A|B tiles (or the Wo tile), overlaid by the q, k, v tiles
  static constexpr int kRegion =
      kTileRows * kLD > 3 * kNP * kLDH ? kTileRows * kLD : 3 * kNP * kLDH;
};

// LayerNorm of one value with the int8 block's fixed rounding: the same
// value wherever it is evaluated (the row max and the A tile)
__device__ __forceinline__ float ln_value(float x, float mu, float rs, float w, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), rs), w), b);
}

// The int8 block: wqkv, wo int8 codes, wqkvs, wos their f32 scales
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
swin_window_kernel(const T* __restrict__ x, const T* __restrict__ lnw,
                   const T* __restrict__ lnb, const int8_t* __restrict__ wqkv,
                   const float* __restrict__ wqkvs, const T* __restrict__ bqkv,
                   const int8_t* __restrict__ wo, const float* __restrict__ wos,
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
  float* qs = tiles;                                  // [kNP][kLDH], over the A|B tiles
  float* ks = qs + kNP * Lay::kLDH;
  float* vs = ks + kNP * Lay::kLDH;
  float* ps = tiles + Lay::kRegion;                   // [8 warps][kNP] probabilities
  float* mean = ps + 8 * kNP;                         // [kNP]
  float* rstd = mean + kNP;                           // [kNP]
  float* qsc = rstd + kNP;                            // [kNP] LN-output row scales
  float* osc = qsc + kNP;                             // [kNP] head-output row scales
  int* tok = reinterpret_cast<int*>(osc + kNP);       // [kNP] canvas pixel, -1 = HF pad
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
    qsc[tid] = quant_scale(0.0f);  // a pad token's LN output is zero
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
      float m = 0.0f;
      for (int c = lane; c < C; c += 32)
        m = fmaxf(m, fabsf(ln_value(to_f(xr[c]), mu, rs, to_f(lnw[c]), to_f(lnb[c]))));
      m = warp_max(m);
      if (lane == 0) qsc[t] = quant_scale(m);
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
            a = static_cast<float>(quant_code(
                ln_value(to_f(xb[(size_t)pix * C + c]), mean[m], rstd[m], to_f(lnw[c]),
                         to_f(lnb[c])),
                qsc[m]));
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
    __syncthreads();  // the last A|B tiles consumed: q, k, v overwrite them
#pragma unroll
    for (int j = 0; j < Lay::kQJ; ++j) {
      const int n = tx + 16 * j, part = n / DH, d = n % DH, wrow = part * C + hd * DH + d;
      const float bb = to_f(bqkv[wrow]);
      float* dst = part == 0 ? qs : (part == 1 ? ks : vs);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = ty * 4 + i;
        dst[m * Lay::kLDH + d] = round_t<T>(dequant(acc[i][j], qsc[m], wqkvs[wrow], bb));
      }
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

  // the head outputs' row scales and codes, in place
  __syncthreads();
  for (int t = warp; t < N; t += 8) {
    float m = 0.0f;
    for (int c = lane; c < C; c += 32) m = fmaxf(m, fabsf(as[t * C + c]));
    const float s = quant_scale(warp_max(m));
    for (int c = lane; c < C; c += 32)
      as[t * C + c] = static_cast<float>(quant_code(as[t * C + c], s));
    if (lane == 0) osc[t] = s;
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
          float y = dequant(acc[i][j], osc[m], wos[c], to_f(bo[c]));
          if (residual) y = __fadd_rn(y, to_f(xb[o]));
          ob[o] = from_f<T>(y);
        }
      }
    }
  }
}

template <int DH>
size_t smem_bytes(int N, int C) {
  using Lay = Layout<DH>;
  return sizeof(float) * ((size_t)N * C + Lay::kRegion + 8 * kNP + 4 * kNP) +
         sizeof(int) * 2 * kNP;
}

struct SwinArgs {
  const void *x, *lnw, *lnb, *wqkv, *wqkvs, *bqkv, *wo, *wos, *bo;
  const float* bias;
  void* out;
  void* ws;  // the token-major plans' workspace: f32, and bf16 above C 384
  int B, H, W, C, heads, win, shift, residual;
  float eps;
};

template <typename T, int DH>
cudaError_t launch_q(const SwinArgs& a, cudaStream_t stream) {
  const int nwh = (a.H + a.win - 1) / a.win, nww = (a.W + a.win - 1) / a.win;
  const size_t smem = smem_bytes<DH>(a.win * a.win, a.C);
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = swin_window_kernel<T, DH>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nwh * nww, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.lnw), static_cast<const T*>(a.lnb),
      static_cast<const int8_t*>(a.wqkv), static_cast<const float*>(a.wqkvs),
      static_cast<const T*>(a.bqkv), static_cast<const int8_t*>(a.wo),
      static_cast<const float*>(a.wos), static_cast<const T*>(a.bo), a.bias,
      static_cast<T*>(a.out), a.H, a.W, a.C, a.heads, a.win, a.shift, nww, a.residual, a.eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 float block (T = TW = bf16): tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kOutCols = 64;        // out-projection column chunk
constexpr int kOneKernelMaxC = 384;  // above it, the token-major plan

// The canvas a launch reads: a window gw of the B·nwh·nww windows, token t
// (< win²) of it.
struct Canvas {
  int H, W, win, shift, nwh, nww;
  // canvas pixel of the token (-1: an HF pad token) and, where shift > 0,
  // its region label (HF's 9-region img_mask on rolled coordinates; else 0)
  __device__ __forceinline__ int pixel(int gw, int t, int* label) const {
    const int per = nwh * nww, b = gw / per, wr = gw - b * per, wi = wr / nww, wj = wr - wi * nww;
    const int Hp = nwh * win, Wp = nww * win;
    const int R = wi * win + t / win, Cc = wj * win + t % win;  // rolled coords
    const int y = (R + shift) % Hp, xq = (Cc + shift) % Wp;     // canvas coords
    *label = shift > 0
                 ? ((R >= Hp - win) + (R >= Hp - shift)) * 3 + (Cc >= Wp - win) + (Cc >= Wp - shift)
                 : 0;
    return y < H && xq < W ? (b * H + y) * W + xq : -1;
  }
};

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// The LayerNorm of one token row by a warp: two-pass f32 statistics, the
// output rounded to bf16 into dst (xr null: an HF pad token, zeros).  Lane
// l holds the row's 8-column chunks c = 8 · l + 256 · i (C <= 1024), read
// once.  Both plans' step 1.
__device__ __forceinline__ void ln_row(const bf16* __restrict__ xr, const bf16* __restrict__ lnw,
                                       const bf16* __restrict__ lnb, int C, float eps, int lane,
                                       bf16* __restrict__ dst) {
  constexpr int kV = 4;
  if (xr == nullptr) {  // warp-uniform
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int c = 8 * lane + 256 * i;
      if (c < C) *reinterpret_cast<uint4*>(dst + c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  uint4 xv[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int c = 8 * lane + 256 * i;
    xv[i] = c < C ? *reinterpret_cast<const uint4*>(xr + c) : make_uint4(0, 0, 0, 0);
  }
  float f[kV][8], s = 0.0f;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    unpack8(xv[i], f[i]);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += f[i][e];
  }
  const float mu = warp_sum(s) / C;
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < kV; ++i)
    if (8 * lane + 256 * i < C)
#pragma unroll
      for (int e = 0; e < 8; ++e) q += (f[i][e] - mu) * (f[i][e] - mu);
  const float rs = rsqrtf(warp_sum(q) / C + eps);
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int c = 8 * lane + 256 * i;
    if (c >= C) continue;
    float w8[8], b8[8];
    unpack8(*reinterpret_cast<const uint4*>(lnw + c), w8);
    unpack8(*reinterpret_cast<const uint4*>(lnb + c), b8);
    uint4 o;
    uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      op[e] = mma::pack_bf16((f[i][2 * e] - mu) * rs * w8[2 * e] + b8[2 * e],
                             (f[i][2 * e + 1] - mu) * rs * w8[2 * e + 1] + b8[2 * e + 1]);
    *reinterpret_cast<uint4*>(dst + c) = o;
  }
}

// ---- the one-kernel plan (C <= 384) ----

// A block takes WPB windows, its tokens packed at N = win² rows a window
// (token t of window w is row w·N + t), Mp = N·WPB rounded up to 16 rows.
// Its 8 warps split the products' 16-row m-tiles (4·WPB at most): with one
// window, two warps share an m-tile, each taking half its columns; with
// four, a warp takes two m-tiles.
template <int DH, int WPB>
struct MmaPlan {
  static constexpr int kSplit = WPB == 1 ? 2 : 1;         // column shares of an m-tile
  static constexpr int kTPW = 4 * WPB * kSplit / 8;        // m-tiles a warp takes
  static constexpr int kQkvNT = 3 * DH / 8 / kSplit;       // its 8-column tiles of q|k|v
  static constexpr int kOutNT = kOutCols / 8 / kSplit;     // ... of an out-projection chunk
  static constexpr int kLdh = DH + 8;
  static constexpr int kRingRows = 3 * DH > kOutCols ? 3 * DH : kOutCols;
  // two blocks an SM (128 registers a thread) where that spills nothing:
  // several windows a block, 12 or fewer 8-column q|k|v tiles a warp
  static constexpr int kMinBlocks = WPB >= 2 && kTPW * kQkvNT <= 12 ? 2 : 1;
};

struct MmaSizes {
  int n, mreal, mp, rq, lda;
  __host__ __device__ MmaSizes(int win, int wpb, int C) {
    n = win * win;
    mreal = n * wpb;
    mp = (mreal + 15) / 16 * 16;
    // rows of the q, k, v tiles: the last window's 64-row key tile
    rq = max(mp, n * (wpb - 1) + 64);
    lda = C + 8;
  }
};

// Shared memory: the LayerNorm tile and the head outputs (N·WPB rows of C
// bf16 each), the q, k and v tiles of one head (rq rows of DH), the 2-stage
// weight ring, the tokens' canvas pixel and region label.  A product's last
// m-tile reads up to 15 rows past its tile (past the LN tile into the head
// outputs; past the head outputs into what follows them; rows that are
// dropped), which the size covers.
template <int DH, int WPB>
size_t mma_smem_bytes(int win, int C, int kt) {
  using Plan = MmaPlan<DH, WPB>;
  const MmaSizes z(win, WPB, C);
  const size_t body = sizeof(bf16) * (2 * (size_t)z.mreal * z.lda +
                                      3 * (size_t)z.rq * Plan::kLdh +
                                      2 * (size_t)Plan::kRingRows * (kt + 8)) +
                      sizeof(int) * 2 * z.mp;
  return std::max(body, sizeof(bf16) * (size_t)(z.mreal + z.mp) * z.lda);
}

template <int DH, int WPB>
__global__ void __launch_bounds__(kThreads, MmaPlan<DH, WPB>::kMinBlocks)
swin_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ lnw,
                const bf16* __restrict__ lnb, const bf16* __restrict__ wqkv,
                const bf16* __restrict__ bqkv, const bf16* __restrict__ wo,
                const bf16* __restrict__ bo, const float* __restrict__ bias,
                bf16* __restrict__ out, Canvas cv, int C, int heads, int nwin, int residual,
                float eps, int KT) {
  using Plan = MmaPlan<DH, WPB>;
  constexpr int LDH = Plan::kLdh, TPW = Plan::kTPW;
  const int LDR = KT + 8, STAGE = Plan::kRingRows * LDR;
  const MmaSizes z(cv.win, WPB, C);
  const int N = z.n, Mreal = z.mreal, Mp = z.mp, LDA = z.lda;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [Mreal][LDA] LN(x), rounded
  bf16* Ho = As + Mreal * LDA;                    // [Mreal][LDA] head outputs
  bf16* Qs = Ho + Mreal * LDA;                    // [rq][LDH] one head's q, k, v
  bf16* Ks = Qs + z.rq * LDH;
  bf16* Vs = Ks + z.rq * LDH;
  bf16* ring = Vs + z.rq * LDH;                   // [2][kRingRows][LDR]
  int* tok = reinterpret_cast<int*>(ring + 2 * STAGE);  // [Mp] pixel, -1: HF pad / none
  int* lab = tok + Mp;                                          // [Mp] shift region

  const int tid = threadIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int lr = lane & 7, l3 = (lane >> 3) & 1, l4 = lane >> 4;

  // ---- token geometry: roll, HF pad, 9-region labels ----
  for (int r = tid; r < Mp; r += kThreads) {
    int pix = -1, t_lab = 0;
    const int w = r / N, gw = blockIdx.x * WPB + w;
    if (r < Mreal && gw < nwin) pix = cv.pixel(gw, r - w * N, &t_lab);
    tok[r] = pix;
    lab[r] = t_lab;
  }
  // k and v rows past Mp (the last window's key tile overhangs): zeros
  for (int i = tid; i < (z.rq - Mp) * LDH; i += kThreads) {
    Ks[Mp * LDH + i] = __float2bfloat16(0.0f);
    Vs[Mp * LDH + i] = __float2bfloat16(0.0f);
  }

  // ---- the weight ring: one stream of KT-wide k-slices, the heads' q|k|v
  // rows (3·DH each) and then the out-projection's 64-row chunks of Wo ----
  const int ks_per = C / KT, n_qkv = heads * ks_per, kchunks = KT / 8;
  const int n_slices = n_qkv + (C + kOutCols - 1) / kOutCols * ks_per;
  auto issue = [&](int u) {
    if (u < n_slices) {
      bf16* st = ring + (u % 2) * STAGE;
      const int k0 = (u % ks_per) * KT;
      if (u < n_qkv) {
        const int hd = u / ks_per;
        for (int idx = tid; idx < 3 * DH * kchunks; idx += kThreads) {
          const int n = idx / kchunks, c = (idx - n * kchunks) * 8, part = n / DH;
          mma::cp_async16(st + n * LDR + c,
                          wqkv + (size_t)(part * C + hd * DH + n - part * DH) * C + k0 + c, true);
        }
      } else {
        const int n0 = (u - n_qkv) / ks_per * kOutCols;
        for (int idx = tid; idx < kOutCols * kchunks; idx += kThreads) {
          const int n = idx / kchunks, c = (idx - n * kchunks) * 8;
          const bool full = n0 + n < C;
          mma::cp_async16(st + n * LDR + c, full ? wo + (size_t)(n0 + n) * C + k0 + c : wo, full);
        }
      }
    }
    mma::cp_async_commit();
  };
  int u = 0;  // the next slice to consume
  issue(0);
  // Wait for slice u, issue u + 1 into the other stage (every warp is done
  // with u - 1 past the barrier) and return slice u's stage.
  auto next_slice = [&]() {
    mma::cp_async_wait<0>();
    __syncthreads();
    issue(u + 1);
    return ring + (u++ % 2) * STAGE;
  };
  __syncthreads();  // tok, lab

  // ---- LayerNorm once per token, rounded to bf16; HF pad tokens zero ----
  for (int r = warp; r < Mreal; r += 8) {
    const int pix = tok[r];
    ln_row(pix >= 0 ? x + (size_t)pix * C : nullptr, lnw, lnb, C, eps, lane, As + r * LDA);
  }

  // the warp's m-tiles and its column share of each product
  int mts[TPW];
#pragma unroll
  for (int i = 0; i < TPW; ++i) mts[i] = WPB == 1 ? warp >> 1 : warp + 8 * i;
  const int share = WPB == 1 ? warp & 1 : 0;

  // acc (the warp's m-tiles x NT 8-column tiles from ring row n0) += A · slice,
  // A's rows from `a` (row stride LDA) at columns k0 .. k0 + KT - 1
  auto slice_mma = [&](auto& acc, const bf16* a, int k0, const bf16* st, int n0) {
    constexpr int NT = sizeof(acc[0]) / sizeof(acc[0][0]);
#pragma unroll
    for (int kk = 0; kk < KT; kk += 16) {
      uint32_t bfr[(NT + 1) / 2][4];
#pragma unroll
      for (int np = 0; np < (NT + 1) / 2; ++np)
        mma::ldsm_x4(bfr[np], st + (n0 + 16 * np + lr + 8 * l4) * LDR + kk + 8 * l3);
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        if (16 * mts[i] >= Mp) continue;  // warp-uniform
        uint32_t af[4];
        mma::ldsm_x4(af, a + (16 * mts[i] + lr + 8 * l3) * LDA + k0 + kk + 8 * l4);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma::mma_bf16(acc[i][j], af, bfr[j >> 1][2 * (j & 1)], bfr[j >> 1][2 * (j & 1) + 1]);
      }
    }
  };

  const int qt = (N + 15) / 16;  // 16-row query tiles of a window
  for (int hd = 0; hd < heads; ++hd) {
    // ---- q|k|v of head hd for every token: LN(x) · Wqkv rowsᵀ + bias ----
    constexpr int QNT = Plan::kQkvNT;
    float acc[TPW][QNT][4];
#pragma unroll
    for (int i = 0; i < TPW; ++i)
#pragma unroll
      for (int j = 0; j < QNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
    for (int t = 0; t < ks_per; ++t) slice_mma(acc, As, t * KT, next_slice(), share * QNT * 8);
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      if (16 * mts[i] >= Mp) continue;
#pragma unroll
      for (int j = 0; j < QNT; ++j) {
        const int n = share * QNT * 8 + 8 * j + c2, part = n / DH, d = n - part * DH;
        if (n >= 3 * DH) continue;
        const int wrow = part * C + hd * DH + d;
        const float b0 = __bfloat162float(bqkv[wrow]), b1 = __bfloat162float(bqkv[wrow + 1]);
        bf16* dst = (part == 0 ? Qs : part == 1 ? Ks : Vs) + d;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // rows past the windows' tokens read what follows the LN tile:
          // zeros instead (the last window's key tile reads their k and v)
          const int m = 16 * mts[i] + g + 8 * r;
          *reinterpret_cast<uint32_t*>(dst + m * LDH) =
              m < Mreal ? mma::pack_bf16(acc[i][j][2 * r] + b0, acc[i][j][2 * r + 1] + b1) : 0u;
        }
      }
    }
    __syncthreads();

    // ---- windowed attention of head hd, a warp per 16 query rows of a
    // window: S = q · kᵀ over the window's 64-row key tile (keys past N
    // dropped), + bias + region mask, softmax in registers, P · V ----
    const float* bh = bias + (size_t)hd * N * N;
    for (int task = warp; task < WPB * qt; task += 8) {
      const int w = task / qt, i0 = 16 * (task - w * qt), R = w * N;
      if (blockIdx.x * WPB + w >= nwin) continue;
      // the bias of the lane's (row, key) pairs, loaded ahead of S
      float bb[2][8][2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = i0 + g + 8 * r;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = 8 * j + c2 + e;
            bb[r][j][e] = t < N && key < N ? __ldg(bh + t * N + key) : 0.0f;
          }
      }
      uint32_t qa[DH / 16][4];
      mma::own_fragments<DH>(Qs + (R + i0) * LDH, lane, qa);
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int np = 0; np < 4; ++np)
#pragma unroll
        for (int kc = 0; kc < DH / 16; ++kc) {
          uint32_t b[4];
          mma::ldsm_x4(b, Ks + (R + 16 * np + lr + 8 * l4) * LDH + kc * 16 + 8 * l3);
          mma::mma_bf16(s[2 * np], qa[kc], b[0], b[1]);
          mma::mma_bf16(s[2 * np + 1], qa[kc], b[2], b[3]);
        }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = i0 + g + 8 * r;
        const bool real = t < N;  // rows past N are computed and dropped
        const int lt = real ? lab[R + t] : 0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = 8 * j + c2 + e;
            float v = -INFINITY;
            if (key < N) {
              v = s[j][2 * r + e] + bb[r][j][e];
              if (lab[R + key] != lt) v -= 100.0f;
            }
            s[j][2 * r + e] = v;
            mx[r] = fmaxf(mx[r], v);
          }
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      // e = exp(v − max), unnormalised; the row sum of the unrounded e
      float l[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = mma::exp2_approx((s[j][e] - mx[e >> 1]) * mma::kLog2e);
          l[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      // O = round(e) · V, then · 1 / sum (swin_canvas.py:394-398's order)
      float o[DH / 8][4];
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4];
        mma::pack_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < DH / 16; ++dn) {
          uint32_t b[4];
          mma::ldsm_x4_t(b, Vs + (R + 16 * kk + lr + 8 * l3) * LDH + 16 * dn + 8 * l4);
          mma::mma_bf16(o[2 * dn], pa, b[0], b[1]);
          mma::mma_bf16(o[2 * dn + 1], pa, b[2], b[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = i0 + g + 8 * r;
        if (t >= N) continue;
        const float inv = 1.0f / l[r];
        bf16* dst = Ho + (R + t) * LDA + hd * DH + c2;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              mma::pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
      }
    }
    // (the next head's first slice barrier orders these reads of q, k, v
    // before its epilogue rewrites them)
  }

  // ---- out-projection + bo + residual, 64 columns at a time, real tokens
  // only (HF pad tokens are cropped) ----
  constexpr int ONT = Plan::kOutNT;
  for (int n0 = 0; n0 < C; n0 += kOutCols) {
    float acc[TPW][ONT][4];
#pragma unroll
    for (int i = 0; i < TPW; ++i)
#pragma unroll
      for (int j = 0; j < ONT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
    for (int t = 0; t < ks_per; ++t) slice_mma(acc, Ho, t * KT, next_slice(), share * ONT * 8);
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      if (16 * mts[i] >= Mp) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = 16 * mts[i] + g + 8 * r;
        const int pix = m < Mreal ? tok[m] : -1;
        if (pix < 0) continue;
#pragma unroll
        for (int j = 0; j < ONT; ++j) {
          const int n = n0 + share * ONT * 8 + 8 * j + c2;
          if (n >= C) continue;
          const size_t o = (size_t)pix * C + n;
          float y0 = acc[i][j][2 * r] + __bfloat162float(bo[n]);
          float y1 = acc[i][j][2 * r + 1] + __bfloat162float(bo[n + 1]);
          if (residual) {
            const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + o));
            y0 += xv.x;
            y1 += xv.y;
          }
          *reinterpret_cast<uint32_t*>(out + o) = mma::pack_bf16(y0, y1);
        }
      }
    }
  }
  mma::cp_async_wait<0>();
}

template <int DH, int WPB>
cudaError_t launch_mma_wpb(const SwinArgs& a, const Canvas& cv, int kt, size_t smem,
                           cudaStream_t stream) {
  auto kernel = swin_mma_kernel<DH, WPB>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int nwin = a.B * cv.nwh * cv.nww;
  kernel<<<(nwin + WPB - 1) / WPB, kThreads, smem, stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.lnw),
      static_cast<const bf16*>(a.lnb), static_cast<const bf16*>(a.wqkv),
      static_cast<const bf16*>(a.bqkv), static_cast<const bf16*>(a.wo),
      static_cast<const bf16*>(a.bo), a.bias, static_cast<bf16*>(a.out), cv, a.C, a.heads, nwin,
      a.residual, a.eps, kt);
  return cudaGetLastError();
}

// The most windows a block (4, 2 or 1; 2 at most at DH 64, whose q|k|v
// accumulators would not fit four) for which two blocks fit an SM (shared
// memory, and kMinBlocks' registers), else the most for which one does;
// 64-wide weight slices where C allows.  On the H100 at the swin-small
// stages 1-3: two blocks of 2 windows at C 96, one of 2 at C 192 and 384
// (one window at C 384 with dh 64); a third or fourth ring stage, or 32-wide
// slices to fit two blocks, timed no faster.  Returns the windows a block
// and sets *smem, or returns 0 where no window fits.
template <int DH>
int one_kernel_wpb(int win, int C, int kt, size_t* smem) {
  constexpr size_t kOne = 232448, kTwo = 115712;  // bytes a block, 1 or 2 an SM
  for (const size_t cap : {kTwo, kOne}) {
    auto fits = [&](size_t sm, int min_blocks) {
      return sm <= cap && (cap == kOne || min_blocks == 2);
    };
    if (DH < 64) {
      constexpr int W4 = DH < 64 ? 4 : 2;
      *smem = mma_smem_bytes<DH, W4>(win, C, kt);
      if (fits(*smem, MmaPlan<DH, W4>::kMinBlocks)) return W4;
    }
    *smem = mma_smem_bytes<DH, 2>(win, C, kt);
    if (fits(*smem, MmaPlan<DH, 2>::kMinBlocks)) return 2;
    *smem = mma_smem_bytes<DH, 1>(win, C, kt);
    if (fits(*smem, MmaPlan<DH, 1>::kMinBlocks)) return 1;
  }
  return 0;
}

inline int slice_width(int C) { return C % 64 == 0 ? 64 : 32; }

template <int DH>
cudaError_t launch_one_kernel(const SwinArgs& a, const Canvas& cv, cudaStream_t stream) {
  const int kt = slice_width(a.C);
  size_t smem = 0;
  switch (one_kernel_wpb<DH>(a.win, a.C, kt, &smem)) {
    case 4: return launch_mma_wpb<DH, DH < 64 ? 4 : 2>(a, cv, kt, smem, stream);
    case 2: return launch_mma_wpb<DH, 2>(a, cv, kt, smem, stream);
    case 1: return launch_mma_wpb<DH, 1>(a, cv, kt, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- the token-major plan (C > 384) ----

// Step 1: the LayerNorm of every real token, a warp a row, rounded to bf16
// into ln (rows in canvas order); and bqkv, bo widened to f32 into vec32
// (3C + C floats) for the two GEMMs' epilogues.
__global__ void __launch_bounds__(kThreads)
swin_ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ lnw,
               const bf16* __restrict__ lnb, const bf16* __restrict__ bqkv,
               const bf16* __restrict__ bo, bf16* __restrict__ ln, float* __restrict__ vec32,
               long long rows, int C, float eps) {
  const int lane = threadIdx.x & 31;
  for (long long r = blockIdx.x * 8LL + (threadIdx.x >> 5); r < rows; r += gridDim.x * 8LL)
    ln_row(x + r * C, lnw, lnb, C, eps, lane, ln + r * C);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < 4 * C; i += gridDim.x * kThreads)
    vec32[i] = __bfloat162float(i < 3 * C ? bqkv[i] : bo[i - 3 * C]);
}

// Step 3's shared memory: the head's bias (kNP rows at a stride of kNP + 8
// floats: the float2 a lane reads of its two rows and keys fall in distinct
// banks), then two stages of one window's q, k and v head slices (kNP rows
// of DH + 8 bf16 each, mma_bf16.cuh's stride), its tokens' canvas pixel and
// region label.
constexpr int kCoreThreads = 128;  // a warp per 16 of a window's kNP rows
constexpr int kLdb = kNP + 8;

template <int DH>
struct CoreLayout {
  static constexpr int kLd = DH + 8;
  static constexpr size_t kStage = sizeof(bf16) * 3 * kNP * kLd + sizeof(int) * 2 * kNP;
  static constexpr size_t kBytes = sizeof(float) * kNP * kLdb + 2 * kStage;
};

// Step 3: the window attention of one head over a group of windows: grid
// (window group, head), `wpb` windows a block.  Each window's q, k and v
// head slices are gathered from qkv (rows in canvas order, 3C wide) by the
// token geometry, bqkv's slices at HF pad tokens and zeros past the window,
// through a 2-stage cp.async ring (window t + 1 loads while window t
// computes); a warp per 16 query rows computes as step 3 of the one-kernel
// plan (the same operations in the same order) and writes the head outputs
// of real tokens to ho, through its own q rows, in 16-byte stores.
template <int DH>
__global__ void __launch_bounds__(kCoreThreads)
swin_core_mma(const bf16* __restrict__ qkv, const bf16* __restrict__ bqkv,
              const float* __restrict__ bias, bf16* __restrict__ ho, Canvas cv, int C, int nwin,
              int wpb) {
  using Lay = CoreLayout<DH>;
  constexpr int LD = Lay::kLd, kChunks = DH / 8;
  const int N = cv.win * cv.win, hd = blockIdx.y;
  const int w0 = blockIdx.x * wpb, nw = min(wpb, nwin - w0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int lr = lane & 7, l3 = (lane >> 3) & 1, l4 = lane >> 4;
  const long long ld3 = 3LL * C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* bs = reinterpret_cast<float*>(smem_raw);  // [kNP][kLdb]
  unsigned char* ring = smem_raw + sizeof(float) * kNP * kLdb;

  // window t of the block into stage t % 2 (called by every thread, past a
  // barrier that freed the stage): its tokens' pixels and labels, then one
  // cp.async group of its q, k and v rows (empty past the block's windows)
  auto issue = [&](int t) {
    if (t < nw) {
      bf16* qs = reinterpret_cast<bf16*>(ring + (t & 1) * Lay::kStage);
      int* tok = reinterpret_cast<int*>(qs + 3 * kNP * LD);
      if (tid < kNP) {
        int lab = 0;
        tok[tid] = tid < N ? cv.pixel(w0 + t, tid, &lab) : -1;
        tok[kNP + tid] = lab;
      }
      __syncthreads();
      for (int idx = tid; idx < 3 * kNP * kChunks; idx += kCoreThreads) {
        const int part = idx / (kNP * kChunks), rem = idx - part * kNP * kChunks;
        const int r = rem / kChunks, c = (rem - r * kChunks) * 8;
        const int pix = r < N ? tok[r] : -1;
        const bf16* src = (pix >= 0 ? qkv + pix * ld3 : bqkv) + part * C + hd * DH + c;
        mma::cp_async16(qs + (part * kNP + r) * LD + c, src, r < N);
      }
    }
    mma::cp_async_commit();
  };
  issue(0);
  issue(1);
  // the head's bias, zeros past N (rows and keys that are dropped)
  const float* bh = bias + (size_t)hd * N * N;
  for (int idx = tid; idx < kNP * kNP; idx += kCoreThreads) {
    const int r = idx / kNP, c = idx - r * kNP;
    bs[r * kLdb + c] = r < N && c < N ? bh[r * N + c] : 0.0f;
  }

  const int r0 = 16 * warp;
  for (int t = 0; t < nw; ++t) {
    mma::cp_async_wait<1>();
    __syncthreads();  // window t's tiles, pixels and labels (and the bias)
    bf16* qs = reinterpret_cast<bf16*>(ring + (t & 1) * Lay::kStage);
    const bf16* ks = qs + kNP * LD;
    const bf16* vs = ks + kNP * LD;
    const int* tok = reinterpret_cast<const int*>(vs + kNP * LD);
    const int* lab = tok + kNP;
    if (r0 < N) {  // warp-uniform
      uint32_t qa[DH / 16][4];
      mma::own_fragments<DH>(qs + r0 * LD, lane, qa);
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int np = 0; np < 4; ++np)
#pragma unroll
        for (int kc = 0; kc < DH / 16; ++kc) {
          uint32_t b[4];
          mma::ldsm_x4(b, ks + (16 * np + lr + 8 * l4) * LD + kc * 16 + 8 * l3);
          mma::mma_bf16(s[2 * np], qa[kc], b[0], b[1]);
          mma::mma_bf16(s[2 * np + 1], qa[kc], b[2], b[3]);
        }
      // + bias, −100 across regions, keys past N dropped; the row max
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + g + 8 * r;
        const int lt = row < N ? lab[row] : 0;  // rows past N are computed and dropped
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int key = 8 * j + c2;
          const float2 b2 = *reinterpret_cast<const float2*>(bs + row * kLdb + key);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = -INFINITY;
            if (key + e < N) {
              v = s[j][2 * r + e] + (e ? b2.y : b2.x);
              if (lab[key + e] != lt) v -= 100.0f;
            }
            s[j][2 * r + e] = v;
            mx[r] = fmaxf(mx[r], v);
          }
        }
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      // e = exp(v − max), unnormalised; the row sum of the unrounded e
      float l[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = mma::exp2_approx((s[j][e] - mx[e >> 1]) * mma::kLog2e);
          l[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      // O = round(e) · V, then · 1 / sum, rounded
      float o[DH / 8][4];
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4];
        mma::pack_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < DH / 16; ++dn) {
          uint32_t b[4];
          mma::ldsm_x4_t(b, vs + (16 * kk + lr + 8 * l3) * LD + 16 * dn + 8 * l4);
          mma::mma_bf16(o[2 * dn], pa, b[0], b[1]);
          mma::mma_bf16(o[2 * dn + 1], pa, b[2], b[3]);
        }
      }
      // through the warp's own q rows (read above, by this warp only) to
      // the real tokens' rows of ho
      bf16* st = qs + r0 * LD;
      __syncwarp();
      mma::stage_rows<DH, DH / 8>(o, 1.0f / l[0], 1.0f / l[1], st, lane);
      __syncwarp();
      for (int idx = lane; idx < 16 * kChunks; idx += 32) {
        const int r = idx / kChunks, c = (idx - r * kChunks) * 8;
        const int pix = r0 + r < N ? tok[r0 + r] : -1;
        if (pix >= 0)
          *reinterpret_cast<uint4*>(ho + (size_t)pix * C + hd * DH + c) =
              *reinterpret_cast<const uint4*>(st + r * LD + c);
      }
    }
    __syncthreads();  // every warp is done with stage t % 2
    issue(t + 2);
  }
  mma::cp_async_wait<0>();
}

// Floats of the token-major plan's workspace: bqkv and bo in f32 (4C), then
// the LN output, later the head outputs (B·H·W·C bf16), and q|k|v
// (B·H·W·3C bf16).
long long token_major_ws_floats(const SwinArgs& a) {
  return 4LL * a.C + 2LL * a.B * a.H * a.W * a.C;
}

template <int DH>
cudaError_t launch_token_major(const SwinArgs& a, const Canvas& cv, cudaStream_t stream) {
  if (a.ws == nullptr || a.heads > 65535) return cudaErrorInvalidValue;
  const long long M = (long long)a.B * a.H * a.W;
  if (M * 3 * a.C > 0x7fffffffLL) return cudaErrorInvalidValue;  // the GEMMs' int rows
  const int C = a.C;
  float* vec32 = static_cast<float*>(a.ws);
  bf16* ln = reinterpret_cast<bf16*>(vec32 + 4 * C);  // later the head outputs
  bf16* qkv = ln + M * C;
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* bqkv = static_cast<const bf16*>(a.bqkv);
  // 1. LayerNorm
  const int ln_blocks = (int)std::min<long long>((M + 7) / 8, 132LL * 16);
  swin_ln_kernel<<<ln_blocks, kThreads, 0, stream>>>(
      x, static_cast<const bf16*>(a.lnw), static_cast<const bf16*>(a.lnb), bqkv,
      static_cast<const bf16*>(a.bo), ln, vec32, M, C, a.eps);
  LC2_TRY(cudaGetLastError());
  // 2. q|k|v = LN · Wqkvᵀ + bqkv, rounded
  const gemm16::Epilogue ep_qkv{vec32, nullptr, nullptr, nullptr, qkv, 3LL * C, false};
  LC2_TRY((gemm16::gemm<false, false>((int)M, 3 * C, C, ln, C,
                                      static_cast<const bf16*>(a.wqkv), C, ep_qkv, stream)));
  // 3. the gathered window attention, head outputs into ln's buffer; about
  // 8 blocks an SM in all: enough windows a block to share its bias load,
  // enough blocks to fill the card
  using Lay = CoreLayout<DH>;
  auto core = swin_core_mma<DH>;
  LC2_TRY(allow_smem(core, Lay::kBytes));
  const int nwin = a.B * cv.nwh * cv.nww;
  const long long units = (long long)nwin * a.heads;
  const int wpb = (int)std::max(1LL, (units + 8 * 132 - 1) / (8 * 132));
  core<<<dim3((nwin + wpb - 1) / wpb, a.heads), kCoreThreads, Lay::kBytes, stream>>>(
      qkv, bqkv, a.bias, ln, cv, C, nwin, wpb);
  LC2_TRY(cudaGetLastError());
  // 4. out = head outputs · Woᵀ + bo [+ x], rounded once
  const gemm16::Epilogue ep_out{vec32 + 3 * C, nullptr, a.residual ? x : nullptr, nullptr,
                                static_cast<bf16*>(a.out), C, false};
  return gemm16::gemm<false, false>((int)M, C, C, ln, C, static_cast<const bf16*>(a.wo), C,
                                    ep_out, stream);
}

template <int DH>
cudaError_t launch_mma(const SwinArgs& a, cudaStream_t stream) {
  if (a.C > 1024) return cudaErrorInvalidValue;  // ln_row's registers
  const Canvas cv{a.H, a.W, a.win, a.shift, (a.H + a.win - 1) / a.win,
                  (a.W + a.win - 1) / a.win};
  return a.C > kOneKernelMaxC ? launch_token_major<DH>(a, cv, stream)
                              : launch_one_kernel<DH>(a, cv, stream);
}

// ---------------------------------------------------------------------------
// f32 float block (T = TW = float): the token-major plan in 3xTF32
// ---------------------------------------------------------------------------

// Step 1: the LayerNorm of every real token, a warp a row, two-pass f32
// statistics (1 / sqrtf, correctly rounded, not the approximate rsqrtf),
// into ln (rows in canvas order).  Lane l holds the row's 4-column chunks
// c = 4 · l + 128 · i (C <= 1024), read once.
__global__ void __launch_bounds__(kThreads)
swin_ln_f32_kernel(const float* __restrict__ x, const float* __restrict__ lnw,
                   const float* __restrict__ lnb, float* __restrict__ ln, long long rows, int C,
                   float eps) {
  constexpr int kV = 8;
  const int lane = threadIdx.x & 31;
  for (long long r = blockIdx.x * 8LL + (threadIdx.x >> 5); r < rows; r += gridDim.x * 8LL) {
    const float* xr = x + r * C;
    float4 v[kV];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int c = 4 * lane + 128 * i;
      v[i] = c < C ? *reinterpret_cast<const float4*>(xr + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
    }
    const float mu = warp_sum(s) / C;
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < kV; ++i)
      if (4 * lane + 128 * i < C) {
        const float a = v[i].x - mu, b = v[i].y - mu, c = v[i].z - mu, d = v[i].w - mu;
        q += (a * a + b * b) + (c * c + d * d);
      }
    const float rs = 1.0f / sqrtf(warp_sum(q) / C + eps);
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int c = 4 * lane + 128 * i;
      if (c >= C) continue;
      const float4 w = *reinterpret_cast<const float4*>(lnw + c);
      const float4 b = *reinterpret_cast<const float4*>(lnb + c);
      *reinterpret_cast<float4*>(ln + r * C + c) =
          make_float4((v[i].x - mu) * rs * w.x + b.x, (v[i].y - mu) * rs * w.y + b.y,
                      (v[i].z - mu) * rs * w.z + b.z, (v[i].w - mu) * rs * w.w + b.w);
    }
  }
}

// Step 3's shared memory: two stages of one window's q, k and v head slices
// in f32 (q and k at a row stride of DH + 8, so that a half-warp's 8-byte
// fragment loads of rows g, columns 2t and 2t + 1, fall in distinct banks; v
// at DH + 4, so that its 4-byte loads of rows 2t and 2t + 1, column g, do),
// each with its tokens' canvas pixels and region labels, then the TF32 lo
// halves of the current window's k and v (their hi halves overwrite the
// stage in place).
constexpr int kX3Threads = 128;  // a warp per 16 of a window's kNP rows

template <int DH>
struct X3Layout {
  static constexpr int kLdQ = DH + 8, kLdK = DH + 8, kLdV = DH + 4;
  static constexpr int kQ = kNP * kLdQ, kK = kNP * kLdK, kV = kNP * kLdV;  // floats
  static constexpr int kStage = kQ + kK + kV + 2 * kNP;  // + pixels and labels (ints)
  static constexpr size_t kBytes = sizeof(float) * (2 * kStage + kK + kV);
};

// Step 3: the window attention of one head over a group of windows in
// 3xTF32: grid (window group, head), `wpb` windows a block, 4 warps.  Each
// window's q, k and v head slices are gathered from qkv (rows in canvas
// order, 3C wide) by the token geometry, bqkv's slices at HF pad tokens and
// zeros past the window, through a 2-stage cp.async ring (window t + 1 loads
// while window t computes).  Once a window landed, the block splits its k
// and v into TF32 hi (in place) and lo halves; warp w then owns query rows
// 16w .. 16w + 15 (rows past win² are computed and dropped), its q split in
// registers: S = q·kᵀ (q carries 1/√dh), + bias (the lane's elements in
// registers, loaded once a block) − 100 across regions, keys past win²
// dropped; e = exp2((S − max) · log2 e), Σ e over the row's quad; O = e·v
// · (1 / Σ e).  S's C fragment is e·v's A fragment with the mma's k order
// permuted (k t <- key 2t, k t + 4 <- key 2t + 1), and v's B fragment is read
// in that order.  Each product sums 32-wide k-slices (of dh, or of the keys)
// apart, added in f32.  The head outputs of real tokens go to ho, 8 bytes a
// store.
template <int DH>
__global__ void __launch_bounds__(kX3Threads, 2)
swin_core_x3(const float* __restrict__ qkv, const float* __restrict__ bqkv,
             const float* __restrict__ bias, float* __restrict__ ho, Canvas cv, int C, int nwin,
             int wpb) {
  using L = X3Layout<DH>;
  constexpr int KC = DH / 8, NO = DH / 8, G = NO < 4 ? NO : 4, kChunks = DH / 4;
  const int N = cv.win * cv.win, hd = blockIdx.y;
  const int w0 = blockIdx.x * wpb, nw = min(wpb, nwin - w0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp;
  const long long ld3 = 3LL * C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  float* lo = ring + 2 * L::kStage;  // [kNP][kLdK] k's lo halves, then [kNP][kLdV] v's

  // window i of the block into stage i % 2 (called by every thread, past a
  // barrier that freed the stage): its tokens' pixels and labels, then one
  // cp.async group of its q, k and v rows (empty past the block's windows)
  auto issue = [&](int i) {
    if (i < nw) {
      float* st = ring + (i & 1) * L::kStage;
      int* tok = reinterpret_cast<int*>(st + L::kQ + L::kK + L::kV);
      if (tid < kNP) {
        int lab = 0;
        tok[tid] = tid < N ? cv.pixel(w0 + i, tid, &lab) : -1;
        tok[kNP + tid] = lab;
      }
      __syncthreads();
      for (int idx = tid; idx < 3 * kNP * kChunks; idx += kX3Threads) {
        const int part = idx / (kNP * kChunks), rem = idx - part * kNP * kChunks;
        const int r = rem / kChunks, c = (rem - r * kChunks) * 4;
        const int pix = r < N ? tok[r] : -1;
        const float* src = (pix >= 0 ? qkv + pix * ld3 : bqkv) + part * C + hd * DH + c;
        float* dst = part == 0   ? st + r * L::kLdQ
                     : part == 1 ? st + L::kQ + r * L::kLdK
                                 : st + L::kQ + L::kK + r * L::kLdV;
        mma::cp_async16(dst + c, src, r < N);
      }
    }
    mma::cp_async_commit();
  };
  issue(0);
  issue(1);
  // the lane's bias elements: rows r0 + g (+ 8), keys 8(4jg + j) + 2t (+ 1); 0 past N
  const float* bh = bias + (size_t)hd * N * N;
  float bz[2][4][4];
#pragma unroll
  for (int jg = 0; jg < 2; ++jg)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + 8 * (e >> 1), key = 8 * (4 * jg + j) + 2 * t + (e & 1);
        bz[jg][j][e] = row < N && key < N ? bh[row * N + key] : 0.0f;
      }

  for (int i = 0; i < nw; ++i) {
    mma::cp_async_wait<1>();
    __syncthreads();  // window i's tiles, pixels and labels are in place
    float* qs = ring + (i & 1) * L::kStage;
    float* ks = qs + L::kQ;
    const float* vs = ks + L::kK;
    const int* tok = reinterpret_cast<const int*>(vs + L::kV);
    const int* lab = tok + kNP;
    // k and v (adjacent in the stage, as their lo halves are) split once
    for (int idx = tid; idx < 2 * kNP * kChunks; idx += kX3Threads) {
      const int r = idx / kChunks, c = (idx - r * kChunks) * 4;  // rows kNP.. are v's
      const int o = r < kNP ? r * L::kLdK + c : L::kK + (r - kNP) * L::kLdV + c;
      const float4 v = *reinterpret_cast<const float4*>(ks + o);
      uint4 h, l;
      gemm32::split(v.x, h.x, l.x);
      gemm32::split(v.y, h.y, l.y);
      gemm32::split(v.z, h.z, l.z);
      gemm32::split(v.w, h.w, l.w);
      *reinterpret_cast<uint4*>(ks + o) = h;
      *reinterpret_cast<uint4*>(lo + o) = l;
    }
    __syncthreads();  // k and v split
    if (r0 < N) {  // warp-uniform
      // the warp's q rows g and g + 8, columns 2t, 2t + 1 of each 8-wide step
      gemm32::Split<4> qf[KC];
      const float* qr = qs + (r0 + g) * L::kLdQ + 2 * t;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        qf[kc] = gemm32::split_a(*reinterpret_cast<const float2*>(qr + 8 * kc),
                                 *reinterpret_cast<const float2*>(qr + 8 * L::kLdQ + 8 * kc));
      // S = q · kᵀ: key group 4jg + j in s[jg][j], dh in 32-wide slices
      const int kofs = g * L::kLdK + 2 * t;
      float s[2][4][4];
#pragma unroll
      for (int jg = 0; jg < 2; ++jg)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[jg][j][0] = s[jg][j][1] = s[jg][j][2] = s[jg][j][3] = 0.0f;
#pragma unroll
      for (int k0 = 0; k0 < KC; k0 += 4) {
        float part[2][4][4];
#pragma unroll
        for (int jg = 0; jg < 2; ++jg)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            part[jg][j][0] = part[jg][j][1] = part[jg][j][2] = part[jg][j][3] = 0.0f;
#pragma unroll
        for (int kc = k0; kc < k0 + 4 && kc < KC; ++kc)
#pragma unroll
          for (int jg = 0; jg < 2; ++jg) {
            gemm32::Split<2> kf[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int o = kofs + 8 * (4 * jg + j) * L::kLdK + 8 * kc;
              const uint2 h = *reinterpret_cast<const uint2*>(ks + o);
              const uint2 l = *reinterpret_cast<const uint2*>(lo + o);
              kf[j] = gemm32::Split<2>{{h.x, h.y}, {l.x, l.y}};
            }
            gemm32::mma_x3_row<4, true>(part[jg], qf[kc], kf);
          }
#pragma unroll
        for (int jg = 0; jg < 2; ++jg)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[jg][j][e] += part[jg][j][e];
      }
      // + bias, −100 across regions, keys past N dropped; the row max
      float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lt = lab[r0 + g + 8 * r];  // 0 past N: those rows are dropped
#pragma unroll
        for (int jg = 0; jg < 2; ++jg)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = 8 * (4 * jg + j) + 2 * t + e;
              float v = -INFINITY;
              if (key < N) {
                v = s[jg][j][2 * r + e] + bz[jg][j][2 * r + e];
                if (lab[key] != lt) v -= 100.0f;
              }
              s[jg][j][2 * r + e] = v;
              mx[r] = fmaxf(mx[r], v);
            }
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      // e = exp(v − max), unnormalised, and its row sum
#pragma unroll
      for (int jg = 0; jg < 2; ++jg)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[jg][j][e] = mma::exp2_approx((s[jg][j][e] - mx[e >> 1]) * mma::kLog2e);
            l[e >> 1] += s[jg][j][e];
          }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      // O = e · v over the key groups below N, in two 32-key slices
      const int vofs = 2 * t * L::kLdV + g;
      const float* vh = vs + vofs;
      const float* vl = lo + L::kK + vofs;
      float o[NO / G][G][4];
#pragma unroll
      for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
        for (int j = 0; j < G; ++j) o[jg][j][0] = o[jg][j][1] = o[jg][j][2] = o[jg][j][3] = 0.0f;
#pragma unroll
      for (int k0 = 0; k0 < 8; k0 += 4) {
        if (8 * k0 >= N) break;  // block-uniform
        float part[NO / G][G][4];
#pragma unroll
        for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
          for (int j = 0; j < G; ++j)
            part[jg][j][0] = part[jg][j][1] = part[jg][j][2] = part[jg][j][3] = 0.0f;
#pragma unroll
        for (int kk = k0; kk < k0 + 4; ++kk) {
          if (8 * kk >= N) break;
          const float* sk = s[kk >> 2][kk & 3];
          const gemm32::Split<4> pf =
              gemm32::split_a(make_float2(sk[0], sk[1]), make_float2(sk[2], sk[3]));
#pragma unroll
          for (int jg = 0; jg < NO / G; ++jg) {
            gemm32::Split<2> vf[G];
#pragma unroll
            for (int j = 0; j < G; ++j) {
              const int off = 8 * kk * L::kLdV + 8 * (G * jg + j);
              vf[j] = gemm32::Split<2>{
                  {__float_as_uint(vh[off]), __float_as_uint(vh[off + L::kLdV])},
                  {__float_as_uint(vl[off]), __float_as_uint(vl[off + L::kLdV])}};
            }
            gemm32::mma_x3_row<G, true>(part[jg], pf, vf);
          }
        }
#pragma unroll
        for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
          for (int j = 0; j < G; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[jg][j][e] += part[jg][j][e];
      }
      // the real tokens' rows of ho
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + g + 8 * r;
        const int pix = row < N ? tok[row] : -1;
        if (pix < 0) continue;
        const float inv = 1.0f / l[r];
        float* dst = ho + (size_t)pix * C + hd * DH + 2 * t;
#pragma unroll
        for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
          for (int j = 0; j < G; ++j)
            *reinterpret_cast<float2*>(dst + 8 * (G * jg + j)) =
                make_float2(o[jg][j][2 * r] * inv, o[jg][j][2 * r + 1] * inv);
      }
    }
    __syncthreads();  // every warp is done with stage i % 2 and the lo halves
    issue(i + 2);
  }
  mma::cp_async_wait<0>();
}

// Floats of the f32 plan's workspace: the LN output, later the head outputs
// (B·H·W·C), and q|k|v (B·H·W·3C).
long long f32_plan_ws_floats(const SwinArgs& a) { return 4LL * a.B * a.H * a.W * a.C; }

template <int DH>
cudaError_t launch_f32_plan(const SwinArgs& a, cudaStream_t stream) {
  if (a.C > 1024 || a.ws == nullptr || a.heads > 65535) return cudaErrorInvalidValue;
  const long long M = (long long)a.B * a.H * a.W;
  if (M * 3 * a.C > 0x7fffffffLL) return cudaErrorInvalidValue;  // the GEMMs' int rows
  const int C = a.C;
  const Canvas cv{a.H, a.W, a.win, a.shift, (a.H + a.win - 1) / a.win,
                  (a.W + a.win - 1) / a.win};
  float* ln = static_cast<float*>(a.ws);  // later the head outputs
  float* qkv = ln + M * C;
  const float* x = static_cast<const float*>(a.x);
  const float* bqkv = static_cast<const float*>(a.bqkv);
  // 1. LayerNorm
  const int ln_blocks = (int)std::min<long long>((M + 7) / 8, 132LL * 16);
  swin_ln_f32_kernel<<<ln_blocks, kThreads, 0, stream>>>(
      x, static_cast<const float*>(a.lnw), static_cast<const float*>(a.lnb), ln, M, C, a.eps);
  LC2_TRY(cudaGetLastError());
  // 2. q|k|v = LN · Wqkvᵀ + bqkv
  LC2_TRY((gemm32::gemm<false, true>((int)M, 3 * C, C, ln, C,
                                     static_cast<const float*>(a.wqkv), C,
                                     gemm32::Epilogue{bqkv, nullptr, qkv, 3LL * C}, stream)));
  // 3. the gathered window attention, head outputs into ln's buffer; about
  // four waves of two blocks an SM: enough windows a block to share its bias
  // load
  using L = X3Layout<DH>;
  LC2_TRY(allow_smem(swin_core_x3<DH>, L::kBytes));
  const int nwin = a.B * cv.nwh * cv.nww;
  const long long units = (long long)nwin * a.heads;
  const int wpb = (int)std::max(1LL, (units + 8 * 132 - 1) / (8 * 132));
  swin_core_x3<DH><<<dim3((nwin + wpb - 1) / wpb, a.heads), kX3Threads, L::kBytes, stream>>>(
      qkv, bqkv, a.bias, ln, cv, C, nwin, wpb);
  LC2_TRY(cudaGetLastError());
  // 4. out = head outputs · Woᵀ + bo [+ x]
  return gemm32::gemm<false, true>(
      (int)M, C, C, ln, C, static_cast<const float*>(a.wo), C,
      gemm32::Epilogue{static_cast<const float*>(a.bo), a.residual ? x : nullptr,
                       static_cast<float*>(a.out), C},
      stream);
}

// The int8 blocks run swin_window_kernel, the float blocks a plan on the
// tensor cores (bf16: one of two by C; f32: the 3xTF32 token-major plan).
template <typename T, typename TW, int DH>
cudaError_t launch_body(const SwinArgs& a, cudaStream_t stream) {
  if constexpr (std::is_same<TW, int8_t>::value)
    return launch_q<T, DH>(a, stream);
  else if constexpr (std::is_same<T, bf16>::value)
    return launch_mma<DH>(a, stream);
  else
    return launch_f32_plan<DH>(a, stream);
}

template <typename T, typename TW>
cudaError_t dispatch_dh(const SwinArgs& a, cudaStream_t stream) {
  if (a.heads < 1 || a.C % a.heads != 0) return cudaErrorInvalidValue;
  switch (a.C / a.heads) {
    case 16:
      return launch_body<T, TW, 16>(a, stream);
    case 32:
      return launch_body<T, TW, 32>(a, stream);
    case 64:
      return launch_body<T, TW, 64>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// kQ false: the float block (weights in dtype); true: the int8 one
template <bool kQ>
cudaError_t dispatch(int dtype, const SwinArgs& a, void* stream) {
  if (a.win < 1 || a.win * a.win > kNP || a.shift < 0 || a.shift >= a.win || a.C % kKT != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return kQ ? dispatch_dh<float, int8_t>(a, s) : dispatch_dh<float, float>(a, s);
  if (dtype == kBF16)
    return kQ ? dispatch_dh<__nv_bfloat16, int8_t>(a, s)
              : dispatch_dh<__nv_bfloat16, __nv_bfloat16>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace lc2

// x, out (B, H, W, C) contiguous; wqkv (3C, C) packed q|k|v torch layout with
// 1/sqrt(dh) folded into the q rows; bqkv (3C,); wo (C, C); bo, lnw, lnb (C,);
// bias (heads, win², win²) f32 in standard token order; residual 0 drops the
// + x.  win <= 8,
// 0 <= shift < win, C % 32 == 0, C / heads in {16, 32, 64}.
// ws: lc2_swin_window_workspace_f32 floats in f32; in bf16,
// lc2_swin_window_workspace_bf16 floats where that is not 0 (else null).  In
// f32, and in bf16 above C 384, the entry launches a token-major plan's four
// kernels in order on the stream and returns the first error.
extern "C" int lc2_swin_window(int dtype, const void* x, const void* lnw, const void* lnb,
                               const void* wqkv, const void* bqkv, const void* wo,
                               const void* bo, const void* bias, void* out, void* ws, int B,
                               int H, int W, int C, int heads, int win, int shift,
                               int residual, float eps, void* stream) {
  const lc2::SwinArgs a{x, lnw, lnb, wqkv, nullptr, bqkv, wo, nullptr, bo,
                        static_cast<const float*>(bias), out, ws, B, H, W, C, heads, win, shift,
                        residual, eps};
  return lc2::dispatch<false>(dtype, a, stream);
}

// Floats of the bf16 float block's workspace for these sizes: 0 at C <= 384
// (the one-kernel plan needs none), the token-major plan's above; -1 for
// sizes no plan takes.
extern "C" long long lc2_swin_window_workspace_bf16(int B, int H, int W, int C, int heads,
                                                    int win) {
  if (heads < 1 || C % heads || win < 1 || win * win > lc2::kNP || C % lc2::kKT || C > 1024)
    return -1;
  const int dh = C / heads;
  if (dh != 16 && dh != 32 && dh != 64) return -1;
  const lc2::SwinArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                        nullptr, nullptr, nullptr, nullptr, B, H, W, C, heads, win, 0, 1, 0.0f};
  return C > lc2::kOneKernelMaxC ? lc2::token_major_ws_floats(a) : 0;
}

// Floats of the f32 float block's workspace for these sizes (the token-major
// plan's at every C); -1 for sizes it does not take.
extern "C" long long lc2_swin_window_workspace_f32(int B, int H, int W, int C, int heads,
                                                   int win) {
  if (heads < 1 || C % heads || win < 1 || win * win > lc2::kNP || C % lc2::kKT || C > 1024)
    return -1;
  const int dh = C / heads;
  if (dh != 16 && dh != 32 && dh != 64) return -1;
  const lc2::SwinArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                        nullptr, nullptr, nullptr, nullptr, B, H, W, C, heads, win, 0, 1, 0.0f};
  return lc2::f32_plan_ws_floats(a);
}

// The int8 variant: wqkv (3C, C) and wo (C, C) int8 codes with f32
// per-output-channel scales wqkvs (3C,), wos (C,); everything else as
// lc2_swin_window.
extern "C" int lc2_swin_window_q(int dtype, const void* x, const void* lnw, const void* lnb,
                                 const void* wqkv, const void* wqkvs, const void* bqkv,
                                 const void* wo, const void* wos, const void* bo,
                                 const void* bias, void* out, int B, int H, int W, int C,
                                 int heads, int win, int shift, int residual, float eps,
                                 void* stream) {
  const lc2::SwinArgs a{x, lnw, lnb, wqkv, wqkvs, bqkv, wo, wos, bo,
                        static_cast<const float*>(bias), out, nullptr, B, H, W, C, heads, win,
                        shift, residual, eps};
  return lc2::dispatch<true>(dtype, a, stream);
}
