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
// (:386, entry fused_window_block :645; stage 4).  Each body below serves all four
// stages, with no C gate.
//
// What bounds it on the card: arithmetic.  Per token it does 3C² (QKV) + C²
// (out-proj) + 2·49·C (attention) multiply-adds against 2·C·bytes of canvas
// traffic.
//
// Token geometry, shared by both bodies: the block computes window, shift and
// pad membership of its tokens from canvas coordinates (explicit roll
// indexing: rolled (R, Cc) is canvas ((R + shift) % Hp, (Cc + shift) % Wp)),
// so it reads the raw canvas and writes each real token back exactly once;
// no pad, roll or partition pass runs outside.  HF pads AFTER
// layernorm_before: a token at row >= H or col >= W of the padded canvas is
// post-LN zero, so its k = bk and v = bv, and it takes part in attention
// (swin_canvas.py:19-25).  The region mask is HF's 9-region img_mask on
// rolled coordinates with its additive -100.  Unlike the TPU kernel
// (window_attention.py:51-55) the softmax subtracts the row max: no row of a
// real token is fully masked, so this changes nothing but the rounding.  The
// TPU's head-pair MXU packing is not carried over.
//
// f32 and int8 blocks (swin_window_kernel): one block per window, on the CUDA
// cores.  Per window:
//   1. LayerNorm statistics per token in f32 (two-pass);
//   2. per head: q/k/v (49 x dh each) by a tiled product whose A tiles are
//      LayerNorm'd on the fly from the canvas, so no C-wide LN copy has to
//      fit in shared memory;
//   3. per head, softmax(q·kᵀ + relative-position bias + region mask) · v;
//   4. the head outputs (49 x C) stay in shared memory and the
//      out-projection, + bo and the residual run per 128-column chunk.
// Shared memory: 49·C floats for the head outputs + tiles (≈ 200 KB at C = 768).
//
// bf16 float block (swin_mma_kernel): tensor cores, mma.sync m16n8k16 with
// f32 accumulators (mma_bf16.cuh).  A block takes 4, 2 or 1 windows, as
// many as fit the SM's shared memory with one or two blocks an SM
// (launch_mma: at the swin-small stages 2, 2, 2 and 1), their tokens packed
// at N = win² rows a window, so each bf16 k-slice of Wqkv and Wo serves up
// to 4·N token rows:
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
// tiles, the q, k, v tiles of one head and the ring: with one 7 x 7 window
// C <= 992 at dh 16 and 32, 864 at dh 64 (8 x 8: 800, 736, 608).
//
// lc2_swin_window_q is the int8 serving variant of the same kernel, the
// quant=True branch of window_attention.py::_block_kernel (:414-418,
// :468-476, forward only): the LN output, in f32 and re-zeroed at pad tokens,
// is quantised per token for an int8 packed QKV product, and the head
// outputs per token for an int8 out-projection (common.cuh: quant_scale /
// quant_code / dequant; per-output-channel weight codes with f32 scales).
// Both products stay on the CUDA cores as integer-valued f32 sums, exact
// while |acc| < 2^24 (C·127² <= 1.24e7 at C <= 768).
#include <math.h>
#include <math_constants.h>

#include <algorithm>
#include <type_traits>

#include "attn_tiles.cuh"
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

// LayerNorm of one value with the int8 variant's fixed rounding: the same
// value wherever it is evaluated (the row max and the A tile)
__device__ __forceinline__ float ln_value(float x, float mu, float rs, float w, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), rs), w), b);
}

// TW = T: the float block; TW = int8_t: the int8 variant (wqkvs, wos: the
// f32 scales of the weight codes, unused by the float block)
template <typename T, typename TW, int DH>
__global__ void __launch_bounds__(kThreads, 1)
swin_window_kernel(const T* __restrict__ x, const T* __restrict__ lnw,
                   const T* __restrict__ lnb, const TW* __restrict__ wqkv,
                   const float* __restrict__ wqkvs, const T* __restrict__ bqkv,
                   const TW* __restrict__ wo, const float* __restrict__ wos,
                   const T* __restrict__ bo, const float* __restrict__ bias,
                   T* __restrict__ out, int H, int W, int C, int heads, int win,
                   int shift, int nww, int residual, float eps) {
  constexpr bool kQ = sizeof(TW) == 1;
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
  float* qsc = rstd + kNP;                            // [kNP] int8: LN-output row scales
  float* osc = qsc + kNP;                             // [kNP] int8: head-output row scales
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
      if (kQ) {
        float m = 0.0f;
        for (int c = lane; c < C; c += 32)
          m = fmaxf(m, fabsf(ln_value(to_f(xr[c]), mu, rs, to_f(lnw[c]), to_f(lnb[c]))));
        m = warp_max(m);
        if (lane == 0) qsc[t] = quant_scale(m);
      }
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
          if (pix >= 0 && kQ)
            a = static_cast<float>(quant_code(
                ln_value(to_f(xb[(size_t)pix * C + c]), mean[m], rstd[m], to_f(lnw[c]),
                         to_f(lnb[c])),
                qsc[m]));
          else if (pix >= 0)
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
      const int n = tx + 16 * j, part = n / DH, d = n % DH, wrow = part * C + hd * DH + d;
      const float bb = to_f(bqkv[wrow]);
      float* dst = part == 0 ? qs : (part == 1 ? ks : vs);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = ty * 4 + i;
        dst[m * Lay::kLDH + d] =
            round_t<T>(kQ ? dequant(acc[i][j], qsc[m], wqkvs[wrow], bb) : acc[i][j] + bb);
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

  if (kQ) {  // the head outputs' row scales and codes, in place
    __syncthreads();
    for (int t = warp; t < N; t += 8) {
      float m = 0.0f;
      for (int c = lane; c < C; c += 32) m = fmaxf(m, fabsf(as[t * C + c]));
      const float s = quant_scale(warp_max(m));
      for (int c = lane; c < C; c += 32)
        as[t * C + c] = static_cast<float>(quant_code(as[t * C + c], s));
      if (lane == 0) osc[t] = s;
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
          float y;
          if (kQ) {
            y = dequant(acc[i][j], osc[m], wos[c], to_f(bo[c]));
            if (residual) y = __fadd_rn(y, to_f(xb[o]));
          } else {
            y = acc[i][j] + to_f(bo[c]) + (residual ? to_f(xb[o]) : 0.0f);
          }
          ob[o] = from_f<T>(y);
        }
      }
    }
  }
}

template <int DH>
size_t smem_bytes(int N, int C) {
  using Lay = Layout<DH>;
  return sizeof(float) * ((size_t)N * C + Lay::kTileRows * kLD + 3 * kNP * Lay::kLDH +
                          8 * kNP + 4 * kNP) +
         sizeof(int) * 2 * kNP;
}

struct SwinArgs {
  const void *x, *lnw, *lnb, *wqkv, *wqkvs, *bqkv, *wo, *wos, *bo;
  const float* bias;
  void* out;
  int B, H, W, C, heads, win, shift, residual;
  float eps;
};

template <typename T, typename TW, int DH>
cudaError_t launch(const SwinArgs& a, cudaStream_t stream) {
  const int nwh = (a.H + a.win - 1) / a.win, nww = (a.W + a.win - 1) / a.win;
  const size_t smem = smem_bytes<DH>(a.win * a.win, a.C);
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = swin_window_kernel<T, TW, DH>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nwh * nww, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.lnw), static_cast<const T*>(a.lnb),
      static_cast<const TW*>(a.wqkv), static_cast<const float*>(a.wqkvs),
      static_cast<const T*>(a.bqkv), static_cast<const TW*>(a.wo),
      static_cast<const float*>(a.wos), static_cast<const T*>(a.bo), a.bias,
      static_cast<T*>(a.out), a.H, a.W, a.C, a.heads, a.win, a.shift, nww, a.residual, a.eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 float block (T = TW = bf16): tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kOutCols = 64;  // out-projection column chunk

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
// m-tile reads up to 15 rows past either tile (past the head outputs, into
// what follows them; rows that are dropped), which the size covers.
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

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

template <int DH, int WPB>
__global__ void __launch_bounds__(kThreads, MmaPlan<DH, WPB>::kMinBlocks)
swin_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ lnw,
                const bf16* __restrict__ lnb, const bf16* __restrict__ wqkv,
                const bf16* __restrict__ bqkv, const bf16* __restrict__ wo,
                const bf16* __restrict__ bo, const float* __restrict__ bias,
                bf16* __restrict__ out, int H, int W, int C, int heads, int win, int shift,
                int nwh, int nww, int nwin, int residual, float eps, int KT) {
  using Plan = MmaPlan<DH, WPB>;
  constexpr int LDH = Plan::kLdh, TPW = Plan::kTPW;
  const int LDR = KT + 8, STAGE = Plan::kRingRows * LDR;
  const MmaSizes z(win, WPB, C);
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
  const int Hp = nwh * win, Wp = nww * win;

  // ---- token geometry: roll, HF pad, 9-region labels (as the f32 block) ----
  for (int r = tid; r < Mp; r += kThreads) {
    int pix = -1, t_lab = 0;
    const int w = r / N, t = r - w * N, gw = blockIdx.x * WPB + w;
    if (r < Mreal && gw < nwin) {
      const int b = gw / (nwh * nww), wr = gw - b * nwh * nww, wi = wr / nww, wj = wr - wi * nww;
      const int R = wi * win + t / win, Cc = wj * win + t % win;  // rolled coords
      const int y = (R + shift) % Hp, xq = (Cc + shift) % Wp;     // canvas coords
      if (y < H && xq < W) pix = (b * H + y) * W + xq;
      if (shift > 0)
        t_lab = ((R >= Hp - win) + (R >= Hp - shift)) * 3 + (Cc >= Wp - win) + (Cc >= Wp - shift);
    }
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

  // ---- LayerNorm once per token: two-pass f32 statistics, the output
  // rounded to bf16; HF pad tokens zero.  A lane holds its 8-column chunks
  // c = 8 · lane + 256 · i of a row (C <= 1024), read once ----
  for (int r = warp; r < Mreal; r += 8) {
    constexpr int kV = 4;
    const int pix = tok[r];
    uint4 xv[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int c = 8 * lane + 256 * i;
      xv[i] = make_uint4(0, 0, 0, 0);
      if (pix >= 0 && c < C) xv[i] = *reinterpret_cast<const uint4*>(x + (size_t)pix * C + c);
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
      uint4 o = make_uint4(0, 0, 0, 0);
      if (pix >= 0) {
        float w8[8], b8[8];
        unpack8(*reinterpret_cast<const uint4*>(lnw + c), w8);
        unpack8(*reinterpret_cast<const uint4*>(lnb + c), b8);
        uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          op[e] = mma::pack_bf16((f[i][2 * e] - mu) * rs * w8[2 * e] + b8[2 * e],
                                 (f[i][2 * e + 1] - mu) * rs * w8[2 * e + 1] + b8[2 * e + 1]);
      }
      *reinterpret_cast<uint4*>(As + r * LDA + c) = o;
    }
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
cudaError_t launch_mma_wpb(const SwinArgs& a, int nwh, int nww, int kt, size_t smem,
                           cudaStream_t stream) {
  auto kernel = swin_mma_kernel<DH, WPB>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int nwin = a.B * nwh * nww;
  kernel<<<(nwin + WPB - 1) / WPB, kThreads, smem, stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.lnw),
      static_cast<const bf16*>(a.lnb), static_cast<const bf16*>(a.wqkv),
      static_cast<const bf16*>(a.bqkv), static_cast<const bf16*>(a.wo),
      static_cast<const bf16*>(a.bo), a.bias, static_cast<bf16*>(a.out), a.H, a.W, a.C,
      a.heads, a.win, a.shift, nwh, nww, nwin, a.residual, a.eps, kt);
  return cudaGetLastError();
}

// The plan: the most windows a block (4, 2 or 1; 2 at most at DH 64, whose
// q|k|v accumulators would not fit four) for which two blocks fit an SM
// (shared memory, and kMinBlocks' registers), else the most for which one
// does; 64-wide weight slices where C allows.  On the H100 at the swin-small
// stages: two blocks of 2 windows at C 96, one of 2 at C 192 and 384, one of
// 1 at C 768; a third or fourth ring stage, or 32-wide slices to fit two
// blocks, timed no faster.
template <int DH>
cudaError_t launch_mma(const SwinArgs& a, cudaStream_t stream) {
  if (a.C > 1024) return cudaErrorInvalidValue;  // the LayerNorm's registers
  const int nwh = (a.H + a.win - 1) / a.win, nww = (a.W + a.win - 1) / a.win;
  const int kt = a.C % 64 == 0 ? 64 : 32;
  constexpr size_t kOne = 232448, kTwo = 115712;  // bytes a block, 1 or 2 an SM
  for (const size_t cap : {kTwo, kOne}) {
    auto fits = [&](size_t sm, int min_blocks) {
      return sm <= cap && (cap == kOne || min_blocks == 2);
    };
    if (DH < 64) {
      constexpr int W4 = DH < 64 ? 4 : 2;
      const size_t sm = mma_smem_bytes<DH, W4>(a.win, a.C, kt);
      if (fits(sm, MmaPlan<DH, W4>::kMinBlocks))
        return launch_mma_wpb<DH, W4>(a, nwh, nww, kt, sm, stream);
    }
    const size_t s2 = mma_smem_bytes<DH, 2>(a.win, a.C, kt);
    if (fits(s2, MmaPlan<DH, 2>::kMinBlocks)) return launch_mma_wpb<DH, 2>(a, nwh, nww, kt, s2, stream);
    const size_t s1 = mma_smem_bytes<DH, 1>(a.win, a.C, kt);
    if (fits(s1, MmaPlan<DH, 1>::kMinBlocks)) return launch_mma_wpb<DH, 1>(a, nwh, nww, kt, s1, stream);
  }
  return cudaErrorInvalidValue;
}

// The f32 and int8 blocks run swin_window_kernel; the bf16 float block the
// tensor-core kernel.
template <typename T, typename TW, int DH>
cudaError_t launch_body(const SwinArgs& a, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value && std::is_same<TW, bf16>::value)
    return launch_mma<DH>(a, stream);
  else
    return launch<T, TW, DH>(a, stream);
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
extern "C" int lc2_swin_window(int dtype, const void* x, const void* lnw, const void* lnb,
                               const void* wqkv, const void* bqkv, const void* wo,
                               const void* bo, const void* bias, void* out, int B, int H,
                               int W, int C, int heads, int win, int shift, int residual,
                               float eps, void* stream) {
  const lc2::SwinArgs a{x, lnw, lnb, wqkv, nullptr, bqkv, wo, nullptr, bo,
                        static_cast<const float*>(bias), out, B, H, W, C, heads, win, shift,
                        residual, eps};
  return lc2::dispatch<false>(dtype, a, stream);
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
                        static_cast<const float*>(bias), out, B, H, W, C, heads, win, shift,
                        residual, eps};
  return lc2::dispatch<true>(dtype, a, stream);
}
