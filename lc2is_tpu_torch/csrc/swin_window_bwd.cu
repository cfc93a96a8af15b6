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
// input) multiply-adds, plus 6·64·C in the attention core at 64-key tiles.
//
// Design.  The TPU kernels keep a whole window block in VMEM; on Hopper a
// window's C-wide intermediates do not fit in shared memory beside the weight
// gradients (49 x 768 f32 is 150 KB per buffer), so the backward is a
// sequence of launches over the window-ordered tokens (B · nW · win² rows of
// HF's rolled, padded canvas; the roll, pad and crop are index arithmetic,
// never copies), with intermediates in a workspace the wrapper allocates:
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
//
// f32 body: every product on the tensor cores in 3xTF32, f32-accurate, f32
// intermediates (M·(10C + 2) floats of workspace; dLN reuses dA's slot).
// Phases 2, 4 and 5 run on csrc/gemm_f32x3.cuh (qkv as LN · Wqkvᵀ, dA and
// dLN as dY · W with W read N-contiguous, the weight gradients as dYᵀ · X
// with both operands staged as they lie and K split over blocks with f32
// atomics), phase 3 on swin_attn_bwd_x3 (below), the bf16 body's plan with
// every product three TF32 products and no rounding below f32.
//
// bf16 body: the dataflow of _canvas_bwd_kernel, rounded where it rounds, so
// that every product takes bf16 operands on the tensor cores (mma.sync
// m16n8k16, f32 accumulators): the LN output, qkv, the gathered output
// gradient g, dA, the probabilities (the P·V and dV operand), the head
// outputs, dS (the dQ and dK operand), dq, dk, dv and dLN are bf16; dbias
// sums the f32 dS, dbo the f32 g, dbqkv the bf16 dq, dk, dv in f32; the
// weight gradients and the LayerNorm backward are f32.  Phases 2, 4 and 5
// run on gemm_bf16.cuh (3-stage cp.async ring, 128 x 128 tiles, split-K
// atomics for the weight gradients), phase 3 on swin_attn_bwd_mma (below).
// Under the 1/√dh fold dS is rounded unscaled and meets the folded q (dK) or
// feeds the folded q's gradient (dQ), where the reference rounds dS·scale and
// meets the unfolded q: the same products, rounded at a point scaled by
// 1/√dh (tests/test_torch_window_tiles.py holds the two within the bf16
// gate).  Workspace: 10·M·C bf16 + 2·M f32 (dLN reuses dA's slot).
#include <math_constants.h>

#include <algorithm>

#include "attn_tiles.cuh"
#include "gemm_bf16.cuh"
#include "gemm_f32x3.cuh"

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

// 1. warp per window-ordered token; the LN output and the gathered gradient
// in T (f32 for the f32 body, bf16 for the bf16 one)
template <typename T>
__global__ void __launch_bounds__(256)
ln_gather_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ lnw,
                 const float* __restrict__ lnb, T* __restrict__ hn, T* __restrict__ gw,
                 float* __restrict__ mean_o, float* __restrict__ rstd_o, long long M, Canvas cv,
                 float eps) {
  const int lane = threadIdx.x & 31;
  const long long m = blockIdx.x * 8LL + (threadIdx.x >> 5);
  if (m >= M) return;  // warp-uniform
  const int C = cv.C;
  const long long pix = cv.pixel(m);
  T* hr = hn + m * C;
  T* gr = gw + m * C;
  if (pix < 0) {
    for (int c = lane; c < C; c += 32) hr[c] = gr[c] = from_f<T>(0.0f);
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
    hr[c] = from_f<T>((to_f(xr[c]) - mu) * rs * lnw[c] + lnb[c]);
    gr[c] = g_r[c];
  }
  if (lane == 0) {
    mean_o[m] = mu;
    rstd_o[m] = rs;
  }
}

// 3. attention core of the f32 body on the tensor cores, every product in
// 3xTF32 (gemm_f32x3.cuh: each operand split into TF32 hi and lo halves,
// lo·hi' + hi·lo' + hi·hi' on mma.sync.m16n8k8, f32-accurate).  The plan of
// the bf16 body's swin_attn_bwd_mma: block (group of windows, head), 4 warps;
// each window is a 64-row tile whose rows past win² load as zeros, its q, k,
// v and dA head tiles (f32 at row stride DH + 4, so a lane's 4-byte loads of
// rows 2t and 2t + 1, column g, fall in distinct banks) through a two-stage
// cp.async ring with the window's region labels.  Per window, warp w first
// owns query rows 16w .. 16w + 15: S = q·kᵀ (q carries 1/√dh) + bias − 100
// across regions, keys past win² dropped; P = softmax (max subtracted, one
// reciprocal of the sum); O = P·v → att; dP = dA·vᵀ; dS = P∘(dP −
// rowsum(P∘dP)), summed into the lane's dbias registers; dQ = dS·k; P and dS
// go to shared memory (f32, row stride 68).  A C fragment becomes the next
// product's A fragment with the mma's k order permuted (k t <- key 2t, k
// t + 4 <- key 2t + 1), and is split there.  Then warp w owns key rows
// 16w .. 16w + 15: dV = Pᵀ·dA and dK = dSᵀ·q, the transposed A fragments
// read as they lie (4-byte loads).  The bias stays in registers (the lane's
// 32 elements of its rows), dbias is added once per block.
constexpr int kX3Threads = 128;        // 4 warps, 16 rows each of a window's 64-row tile
constexpr int kX3Rows = 64;            // win² <= 64 tokens, padded
constexpr int kX3Ldp = kX3Rows + 4;    // the P and dS tiles' row stride (floats)

template <int DH>
struct X3CoreLayout {
  static constexpr int kLd = DH + 4;
  static constexpr int kTile = kX3Rows * kLd;
  static constexpr int kStage = 4 * kTile + kX3Rows;  // q, k, v, dA; the labels (ints)
  static constexpr size_t kBytes = sizeof(float) * (2 * kX3Rows * kX3Ldp + 2 * kStage);
};

// rows 0 .. 63 of a window's head columns (src at its token 0 and the head's
// column 0, row stride ld) into a tile at stride DH + 4, zeros past n
template <int DH>
__device__ __forceinline__ void x3_window_rows(const float* __restrict__ src, int n, long long ld,
                                               float* dst) {
  constexpr int kChunks = DH / 4, LD = X3CoreLayout<DH>::kLd;
#pragma unroll
  for (int idx = threadIdx.x; idx < kX3Rows * kChunks; idx += kX3Threads) {
    const int r = idx / kChunks, c = (idx - r * kChunks) * 4;
    const bool full = r < n;
    mma::cp_async16(dst + r * LD + c, full ? src + r * ld + c : src, full);
  }
}

// acc += A · Z for one 8-row k step of a tile Z (z at the lane's row 2t of
// the step, column g), over Z's DH columns in groups of G tiles
template <int DH, int G>
__device__ __forceinline__ void x3_rows_n(float (&acc)[DH / 8 / G][G][4],
                                          const gemm32::Split<4>& af, const float* z) {
#pragma unroll
  for (int jg = 0; jg < DH / 8 / G; ++jg)
    gemm32::mma_x3_bn<G, X3CoreLayout<DH>::kLd>(acc[jg], af, z + 8 * G * jg);
}

template <int DH>
__global__ void __launch_bounds__(kX3Threads, 2)
swin_attn_bwd_x3(const float* __restrict__ qkv, const float* __restrict__ dA,
                 const float* __restrict__ bias, float* __restrict__ att,
                 float* __restrict__ dqkv, float* __restrict__ dbias, Canvas cv, int nwin,
                 int wpb) {
  using L = X3CoreLayout<DH>;
  constexpr int LD = L::kLd, KC = DH / 8, NO = DH / 8, G = NO < 4 ? NO : 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ps = reinterpret_cast<float*>(smem_raw);  // [64][kX3Ldp] P
  float* dss = ps + kX3Rows * kX3Ldp;              // [64][kX3Ldp] dS
  float* ring = dss + kX3Rows * kX3Ldp;

  const int C = cv.C, C3 = 3 * C, win = cv.win, N = win * win, nW = cv.n_win();
  const int Hp = cv.nwh * win, Wp = cv.nww * win;
  const int hd = blockIdx.y, w0 = blockIdx.x * wpb, nw = min(wpb, nwin - w0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  const bool rows = r0 < N;  // warp-uniform: the warp's 16 rows hold a token

  auto issue = [&](int i) {  // window i of the block into stage i % 2
    if (i < nw) {
      float* qs = ring + (i & 1) * L::kStage;
      const long long tok0 = (long long)(w0 + i) * N;
      const float* src = qkv + tok0 * C3 + hd * DH;
      x3_window_rows<DH>(src, N, C3, qs);
      x3_window_rows<DH>(src + C, N, C3, qs + L::kTile);
      x3_window_rows<DH>(src + 2 * C, N, C3, qs + 2 * L::kTile);
      x3_window_rows<DH>(dA + tok0 * C + hd * DH, N, C, qs + 3 * L::kTile);
      // the labels: plain stores, published by the barrier before window i
      int* lab = reinterpret_cast<int*>(qs + 4 * L::kTile);
      if (tid < kX3Rows) {
        int l = 0;
        if (cv.shift > 0 && tid < N) {
          const int w = (w0 + i) % nW, wi = w / cv.nww, wj = w - wi * cv.nww;
          const int R = wi * win + tid / win, Cc = wj * win + tid % win;
          l = ((R >= Hp - win) + (R >= Hp - cv.shift)) * 3 + (Cc >= Wp - win) +
              (Cc >= Wp - cv.shift);
        }
        lab[tid] = l;
      }
    }
    mma::cp_async_commit();
  };
  issue(0);
  issue(1);
  // the lane's bias elements: rows r0 + g (+ 8), keys 8(4jg + j) + 2t (+ 1); 0 past N
  const float* bh = bias + (size_t)hd * N * N;
  float bz[2][4][4], dbacc[2][4][4];
#pragma unroll
  for (int jg = 0; jg < 2; ++jg)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + 8 * (e >> 1), key = 8 * (4 * jg + j) + 2 * t + (e & 1);
        bz[jg][j][e] = row < N && key < N ? bh[row * N + key] : 0.0f;
        dbacc[jg][j][e] = 0.0f;
      }

  for (int i = 0; i < nw; ++i) {
    mma::cp_async_wait<1>();
    __syncthreads();  // window i's tiles and labels are in place
    const float* qs = ring + (i & 1) * L::kStage;
    const float* ks = qs + L::kTile;
    const float* vs = ks + L::kTile;
    const float* das = vs + L::kTile;
    const int* lab = reinterpret_cast<const int*>(das + L::kTile);
    const long long tok0 = (long long)(w0 + i) * N;

    // ---- query rows r0 .. r0 + 15 ----
    if (rows) {
      float p[2][4][4];  // S, then P: key group 4jg + j
#pragma unroll
      for (int jg = 0; jg < 2; ++jg)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[jg][j][0] = p[jg][j][1] = p[jg][j][2] = p[jg][j][3] = 0.0f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const float* qr = qs + (r0 + g) * LD + 8 * kc + 2 * t;
        const gemm32::Split<4> af =
            gemm32::split_a(*reinterpret_cast<const float2*>(qr),
                            *reinterpret_cast<const float2*>(qr + 8 * LD));
#pragma unroll
        for (int jg = 0; jg < 2; ++jg)
          gemm32::mma_x3_bt<4, LD>(p[jg], af, ks + (32 * jg + g) * LD + 8 * kc + 2 * t);
      }
      // logits, then P = softmax over the keys below N (rows past N: P = 0)
      float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lt = lab[r0 + g + 8 * r];
#pragma unroll
        for (int jg = 0; jg < 2; ++jg)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = 8 * (4 * jg + j) + 2 * t + e;
              float v = -INFINITY;
              if (key < N) {
                v = p[jg][j][2 * r + e] + bz[jg][j][2 * r + e];
                if (lab[key] != lt) v -= 100.0f;
              }
              p[jg][j][2 * r + e] = v;
              mx[r] = fmaxf(mx[r], v);
            }
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
#pragma unroll
      for (int jg = 0; jg < 2; ++jg)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[jg][j][e] = mma::exp2_approx((p[jg][j][e] - mx[e >> 1]) * mma::kLog2e);
            l[e >> 1] += p[jg][j][e];
          }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = r0 + g + 8 * r < N ? 1.0f / l[r] : 0.0f;
      }
      // P to shared memory (the dV operand); O = P · v → att
      float o[NO / G][G][4];
#pragma unroll
      for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
        for (int j = 0; j < G; ++j) o[jg][j][0] = o[jg][j][1] = o[jg][j][2] = o[jg][j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        float* pk = p[kk >> 2][kk & 3];
#pragma unroll
        for (int e = 0; e < 4; ++e) pk[e] *= l[e >> 1];
        float* prow = ps + (r0 + g) * kX3Ldp + 8 * kk + 2 * t;
        *reinterpret_cast<float2*>(prow) = make_float2(pk[0], pk[1]);
        *reinterpret_cast<float2*>(prow + 8 * kX3Ldp) = make_float2(pk[2], pk[3]);
        if (8 * kk >= N) continue;
        x3_rows_n<DH, G>(o, gemm32::split_c(p[kk >> 2][kk & 3]), vs + (8 * kk + 2 * t) * LD + g);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + g + 8 * r;
        if (row >= N) continue;
        float* dst = att + (tok0 + row) * C + hd * DH + 2 * t;
#pragma unroll
        for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
          for (int j = 0; j < G; ++j)
            *reinterpret_cast<float2*>(dst + 8 * (G * jg + j)) =
                make_float2(o[jg][j][2 * r], o[jg][j][2 * r + 1]);
      }
      // dP = dA · vᵀ, then dS = P∘(dP − rowsum(P∘dP)) in place
      float dp[2][4][4];
#pragma unroll
      for (int jg = 0; jg < 2; ++jg)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[jg][j][0] = dp[jg][j][1] = dp[jg][j][2] = dp[jg][j][3] = 0.0f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const float* ar = das + (r0 + g) * LD + 8 * kc + 2 * t;
        const gemm32::Split<4> af =
            gemm32::split_a(*reinterpret_cast<const float2*>(ar),
                            *reinterpret_cast<const float2*>(ar + 8 * LD));
#pragma unroll
        for (int jg = 0; jg < 2; ++jg)
          gemm32::mma_x3_bt<4, LD>(dp[jg], af, vs + (32 * jg + g) * LD + 8 * kc + 2 * t);
      }
      float dsum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int jg = 0; jg < 2; ++jg)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dsum[e >> 1] += p[jg][j][e] * dp[jg][j][e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
        dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
      }
      // dS to shared memory (the dK operand); dQ = dS · k
      float dq[NO / G][G][4];
#pragma unroll
      for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
        for (int j = 0; j < G; ++j) dq[jg][j][0] = dq[jg][j][1] = dq[jg][j][2] = dq[jg][j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        float* dk = dp[kk >> 2][kk & 3];
        const float* pk = p[kk >> 2][kk & 3];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dk[e] = pk[e] * (dk[e] - dsum[e >> 1]);
          dbacc[kk >> 2][kk & 3][e] += dk[e];
        }
        float* drow = dss + (r0 + g) * kX3Ldp + 8 * kk + 2 * t;
        *reinterpret_cast<float2*>(drow) = make_float2(dk[0], dk[1]);
        *reinterpret_cast<float2*>(drow + 8 * kX3Ldp) = make_float2(dk[2], dk[3]);
        if (8 * kk >= N) continue;
        x3_rows_n<DH, G>(dq, gemm32::split_c(dp[kk >> 2][kk & 3]), ks + (8 * kk + 2 * t) * LD + g);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + g + 8 * r;
        if (row >= N) continue;
        float* dst = dqkv + (tok0 + row) * C3 + hd * DH + 2 * t;
#pragma unroll
        for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
          for (int j = 0; j < G; ++j)
            *reinterpret_cast<float2*>(dst + 8 * (G * jg + j)) =
                make_float2(dq[jg][j][2 * r], dq[jg][j][2 * r + 1]);
      }
    } else {
      // rows past every token: zero P and dS rows (the dK / dV products sum
      // over all 64 query rows)
      for (int idx = lane; idx < 16 * kX3Rows; idx += 32) {
        const int r = r0 + idx / kX3Rows, c = idx % kX3Rows;
        ps[r * kX3Ldp + c] = 0.0f;
        dss[r * kX3Ldp + c] = 0.0f;
      }
    }
    __syncthreads();  // P, dS of every query row

    // ---- key rows r0 .. r0 + 15: dV = Pᵀ · dA, dK = dSᵀ · q ----
    if (rows) {
      float dv[NO / G][G][4], dk[NO / G][G][4];
#pragma unroll
      for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
        for (int j = 0; j < G; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dv[jg][j][e] = dk[jg][j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (8 * kk >= N) break;
        // A (key r0 + g (+ 8), query 8kk + 2t (+ 1)) read from P and dS as they lie
        const float* pa = ps + (8 * kk + 2 * t) * kX3Ldp + r0 + g;
        const float* sa = dss + (8 * kk + 2 * t) * kX3Ldp + r0 + g;
        const gemm32::Split<4> pf = gemm32::split_a(make_float2(pa[0], pa[kX3Ldp]),
                                                    make_float2(pa[8], pa[kX3Ldp + 8]));
        const gemm32::Split<4> sf = gemm32::split_a(make_float2(sa[0], sa[kX3Ldp]),
                                                    make_float2(sa[8], sa[kX3Ldp + 8]));
        x3_rows_n<DH, G>(dv, pf, das + (8 * kk + 2 * t) * LD + g);
        x3_rows_n<DH, G>(dk, sf, qs + (8 * kk + 2 * t) * LD + g);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + g + 8 * r;
        if (row >= N) continue;
        float* dst = dqkv + (tok0 + row) * C3 + C + hd * DH + 2 * t;
#pragma unroll
        for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
          for (int j = 0; j < G; ++j) {
            const int col = 8 * (G * jg + j);
            *reinterpret_cast<float2*>(dst + col) = make_float2(dk[jg][j][2 * r], dk[jg][j][2 * r + 1]);
            *reinterpret_cast<float2*>(dst + C + col) =
                make_float2(dv[jg][j][2 * r], dv[jg][j][2 * r + 1]);
          }
      }
    }
    __syncthreads();  // every warp is done with stage i % 2 and the P, dS tiles
    issue(i + 2);
  }
  mma::cp_async_wait<0>();
  // dbias: the block's sum over its windows, one atomic an element
  if (rows) {
#pragma unroll
    for (int jg = 0; jg < 2; ++jg)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + g + 8 * (e >> 1), key = 8 * (4 * jg + j) + 2 * t + (e & 1);
          if (row < N && key < N)
            atomicAdd(dbias + (size_t)hd * N * N + row * N + key, dbacc[jg][j][e]);
        }
  }
}

// 5. LN backward + scatter to the canvas; warp per token (grid-stride), the
// block's dln_w / dln_b partials in shared memory; dhn in T, the math f32.
template <typename T>
__global__ void __launch_bounds__(256)
ln_bwd_scatter_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const T* __restrict__ dhn, const float* __restrict__ mean,
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
    const T* dr = dhn + m * C;
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float xh = (to_f(xr[c]) - mu) * rs, dy = to_f(dr[c]), dxh = dy * lnw[c];
      s1 += dxh;
      s2 += dxh * xh;
      atomicAdd(red + c, dy * xh);
      atomicAdd(red + C + c, dy);
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
    for (int c = lane; c < C; c += 32) {
      const float xh = (to_f(xr[c]) - mu) * rs, dxh = to_f(dr[c]) * lnw[c];
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
cudaError_t attn_core_x3(const float* qkv, const float* dA, const float* bias, float* att,
                         float* dqkv, float* dbias, Canvas cv, int B, int heads, cudaStream_t s) {
  constexpr size_t smem = X3CoreLayout<DH>::kBytes;
  LC2_TRY(allow_smem(swin_attn_bwd_x3<DH>, smem));
  const int nwin = B * cv.nwh * cv.nww;
  // about four waves of two blocks an SM: enough windows a block to share
  // its bias load and its dbias atomics
  const long long units = (long long)nwin * heads;
  const int wpb = (int)std::max(1LL, (units + 8 * 132 - 1) / (8 * 132));
  const dim3 grid((nwin + wpb - 1) / wpb, heads);
  swin_attn_bwd_x3<DH><<<grid, kX3Threads, smem, s>>>(qkv, dA, bias, att, dqkv, dbias, cv, nwin,
                                                       wpb);
  return cudaGetLastError();
}

// The workspace of the f32 body, carved in this order: LN(x), the gathered
// output gradient, qkv, dA (reused for dLN once the attention core has read
// it), the head outputs and dqkv, then the mean and rstd.
struct F32Ws {
  float *hn, *gw, *qkv, *dA, *att, *dqkv, *mean, *rstd;
  F32Ws(float* ws, long long M, int C) {
    const long long MC = M * C;
    hn = ws;             // [M][C]
    gw = hn + MC;        // [M][C]
    qkv = gw + MC;       // [M][3C]
    dA = qkv + 3 * MC;   // [M][C]  dA, then dLN
    att = dA + MC;       // [M][C]
    dqkv = att + MC;     // [M][3C]
    mean = dqkv + 3 * MC;  // [M]
    rstd = mean + M;     // [M]
  }
  static long long floats(long long M, int C) { return M * (10LL * C + 2); }
};

cudaError_t swin_bwd_f32(const float* x, const float* g, const float* lnw, const float* lnb,
                         const float* wqkv, const float* bqkv, const float* wo,
                         const float* bias, float* dx, float* dlnw, float* dlnb, float* dwqkv,
                         float* dbqkv, float* dwo, float* dbo, float* dbias, float* ws, int B,
                         int H, int W, int C, int heads, int win, int shift, int residual,
                         float eps, cudaStream_t s) {
  using gemm32::Epilogue;
  const Canvas cv{H, W, C, win, shift, (H + win - 1) / win, (W + win - 1) / win};
  const long long M = (long long)B * cv.nwh * cv.nww * win * win;
  const int mi = (int)M, C3 = 3 * C;
  const F32Ws w(ws, M, C);
  ln_gather_kernel<float><<<(unsigned)((M + 7) / 8), 256, 0, s>>>(x, g, lnw, lnb, w.hn, w.gw,
                                                                 w.mean, w.rstd, M, cv, eps);
  LC2_TRY(cudaGetLastError());
  // qkv = LN · Wqkvᵀ + bqkv; dA = g · Wo
  LC2_TRY(gemm32::gemm(mi, C3, C, w.hn, C, wqkv, C, Epilogue{bqkv, nullptr, w.qkv, C3}, s));
  LC2_TRY((gemm32::product<false, true>(mi, C, C, w.gw, C, wo, C,
                                        Epilogue{nullptr, nullptr, w.dA, C}, s)));
  switch (C / heads) {
    case 16: LC2_TRY(attn_core_x3<16>(w.qkv, w.dA, bias, w.att, w.dqkv, dbias, cv, B, heads, s)); break;
    case 32: LC2_TRY(attn_core_x3<32>(w.qkv, w.dA, bias, w.att, w.dqkv, dbias, cv, B, heads, s)); break;
    case 64: LC2_TRY(attn_core_x3<64>(w.qkv, w.dA, bias, w.att, w.dqkv, dbias, cv, B, heads, s)); break;
    default: return cudaErrorInvalidValue;
  }
  // dWo += gᵀ · att, dbo = Σ g; dWqkv += dqkvᵀ · LN, dbqkv = Σ dqkv (split-K
  // f32 atomics)
  LC2_TRY((gemm32::product<true, true>(C, C, mi, w.gw, C, w.att, C,
                                       Epilogue{nullptr, nullptr, dwo, C, true}, s)));
  LC2_TRY(gemm32::colsum(mi, C, w.gw, C, dbo, s));
  LC2_TRY((gemm32::product<true, true>(C3, C, mi, w.dqkv, C3, w.hn, C,
                                       Epilogue{nullptr, nullptr, dwqkv, C, true}, s)));
  LC2_TRY(gemm32::colsum(mi, C3, w.dqkv, C3, dbqkv, s));
  // dLN = dqkv · Wqkv, into dA's slot
  float* dhn = w.dA;
  LC2_TRY((gemm32::product<false, true>(mi, C, C3, w.dqkv, C3, wqkv, C,
                                        Epilogue{nullptr, nullptr, dhn, C}, s)));
  const long long want = (M + 7) / 8;
  const int blocks = (int)(want < 4 * 132 ? want : 4 * 132);
  ln_bwd_scatter_kernel<float><<<blocks, 256, sizeof(float) * 2 * C, s>>>(
      x, g, dhn, w.mean, w.rstd, lnw, dx, dlnw, dlnb, M, cv, residual);
  return cudaGetLastError();
}

// ===========================================================================
// bf16 body: tensor cores, bf16 intermediates where the reference rounds
// ===========================================================================

using bf16 = __nv_bfloat16;
constexpr int kCoreThreads = 128;  // 4 warps, 16 rows each of a window's 64-row tile
constexpr int kCoreRows = 64;      // win² <= 64 tokens, padded
constexpr int kLdp = kCoreRows + 8;  // the P and dS tiles' row stride (bf16)
constexpr int kLdb = 72;             // the bias tile's row stride (floats, ≡ 8 mod 32)

// Shared memory of the attention core: the head's bias (64 x 64 f32, zeros
// past win²), round(P) and round(dS) of the window (64 x 64 bf16 each), and a
// two-stage ring of the window's q, k, v and dA head tiles (64 rows of DH + 8
// bf16, zeros past win²) with its 64 region labels.
template <int DH>
struct CoreLayout {
  static constexpr int kLd = mma::row_stride<DH>();
  static constexpr int kTile = kCoreRows * kLd;
  static constexpr size_t kBias = sizeof(float) * kCoreRows * kLdb;
  static constexpr size_t kPd = sizeof(bf16) * 2 * kCoreRows * kLdp;
  static constexpr size_t kStage = sizeof(bf16) * 4 * kTile + sizeof(int) * kCoreRows;
  static constexpr size_t kBytes = kBias + kPd + 2 * kStage;
};

// 3. attention core on the tensor cores.  Block (group of windows, head):
// the windows' tokens are packed at win² rows a window (the workspace's
// window order), each window read as a 64-row tile whose rows past win² load
// as zeros.  Per window, warp w first owns query rows 16w .. 16w + 15:
// S = q·kᵀ (q carries 1/√dh) + bias − 100 across regions, keys past win²
// dropped; P = softmax (max subtracted, one reciprocal of the sum);
// O = round(P)·v → att; dP = dA·vᵀ; dS = P∘(dP − rowsum(P∘dP)), summed into
// the lane's dbias registers in f32; dQ = round(dS)·k; round(P) and
// round(dS) go to shared memory.  Then warp w owns key rows 16w .. 16w + 15:
// dV = round(P)ᵀ·dA and dK = round(dS)ᵀ·q, the transposed A fragments by
// ldmatrix.trans.  dq, dk, dv are rounded to bf16.  Every product is
// mma.sync m16n8k16 with f32 accumulators (mma_bf16.cuh).
template <int DH>
__global__ void __launch_bounds__(kCoreThreads, 2)
swin_attn_bwd_mma(const bf16* __restrict__ qkv, const bf16* __restrict__ dA,
                  const float* __restrict__ bias, bf16* __restrict__ att,
                  bf16* __restrict__ dqkv, float* __restrict__ dbias, Canvas cv, int nwin,
                  int wpb) {
  using L = CoreLayout<DH>;
  constexpr int LD = L::kLd, KC = DH / 16, NO = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* bs = reinterpret_cast<float*>(smem_raw);           // [64][kLdb]
  bf16* ps = reinterpret_cast<bf16*>(smem_raw + L::kBias);  // [64][kLdp] round(P)
  bf16* dss = ps + kCoreRows * kLdp;                         // [64][kLdp] round(dS)
  unsigned char* ring = smem_raw + L::kBias + L::kPd;

  const int C = cv.C, C3 = 3 * C, win = cv.win, N = win * win, nW = cv.n_win();
  const int Hp = cv.nwh * win, Wp = cv.nww * win;
  const int hd = blockIdx.y, w0 = blockIdx.x * wpb, nw = min(wpb, nwin - w0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int lr = lane & 7, l3 = (lane >> 3) & 1, l4 = lane >> 4;
  const int r0 = 16 * warp;
  const bool rows = r0 < N;  // warp-uniform: the warp's 16 rows hold a token

  auto issue = [&](int t) {  // window t of the block into stage t % 2
    if (t < nw) {
      bf16* qs = reinterpret_cast<bf16*>(ring + (t & 1) * L::kStage);
      const long long tok0 = (long long)(w0 + t) * N;
      const bf16* src = qkv + tok0 * C3 + hd * DH;
      mma::load_rows_ld<DH, kCoreRows, kCoreThreads>(src, 0, N, C3, qs);
      mma::load_rows_ld<DH, kCoreRows, kCoreThreads>(src + C, 0, N, C3, qs + L::kTile);
      mma::load_rows_ld<DH, kCoreRows, kCoreThreads>(src + 2 * C, 0, N, C3, qs + 2 * L::kTile);
      mma::load_rows_ld<DH, kCoreRows, kCoreThreads>(dA + tok0 * C + hd * DH, 0, N, C,
                                                     qs + 3 * L::kTile);
      // the labels: plain stores, published by the barrier before window t
      int* lab = reinterpret_cast<int*>(qs + 4 * L::kTile);
      if (tid < kCoreRows) {
        int l = 0;
        if (cv.shift > 0 && tid < N) {
          const int w = (w0 + t) % nW, wi = w / cv.nww, wj = w - wi * cv.nww;
          const int R = wi * win + tid / win, Cc = wj * win + tid % win;
          l = ((R >= Hp - win) + (R >= Hp - cv.shift)) * 3 + (Cc >= Wp - win) +
              (Cc >= Wp - cv.shift);
        }
        lab[tid] = l;
      }
    }
    mma::cp_async_commit();
  };
  issue(0);
  issue(1);
  const float* bh = bias + (size_t)hd * N * N;
  for (int idx = tid; idx < kCoreRows * kCoreRows; idx += kCoreThreads) {
    const int r = idx / kCoreRows, c = idx - r * kCoreRows;
    bs[r * kLdb + c] = r < N && c < N ? bh[r * N + c] : 0.0f;
  }
  float dbacc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) dbacc[j][0] = dbacc[j][1] = dbacc[j][2] = dbacc[j][3] = 0.0f;

  for (int t = 0; t < nw; ++t) {
    mma::cp_async_wait<1>();
    __syncthreads();  // window t's tiles, labels (and the bias) are in place
    const bf16* qs = reinterpret_cast<const bf16*>(ring + (t & 1) * L::kStage);
    const bf16* ks = qs + L::kTile;
    const bf16* vs = ks + L::kTile;
    const bf16* das = vs + L::kTile;
    const int* lab = reinterpret_cast<const int*>(das + L::kTile);
    const long long tok0 = (long long)(w0 + t) * N;

    // ---- query rows r0 .. r0 + 15 ----
    if (rows) {
      float p[8][4];
      {
        uint32_t qa[KC][4];
        mma::own_fragments<DH>(qs + r0 * LD, lane, qa);
#pragma unroll
        for (int j = 0; j < 8; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.0f;
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (16 * np >= N) break;
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) {
            uint32_t b[4];
            mma::ldsm_x4(b, ks + (16 * np + lr + 8 * l4) * LD + kc * 16 + 8 * l3);
            mma::mma_bf16(p[2 * np], qa[kc], b[0], b[1]);
            mma::mma_bf16(p[2 * np + 1], qa[kc], b[2], b[3]);
          }
        }
      }
      // logits, then P = softmax over the keys below N (rows past N: P = 0)
      float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + g + 8 * r, lt = lab[row];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int key = 8 * j + c2;
          const float2 b2 = *reinterpret_cast<const float2*>(bs + row * kLdb + key);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = -INFINITY;
            if (key + e < N) {
              v = p[j][2 * r + e] + (e ? b2.y : b2.x);
              if (lab[key + e] != lt) v -= 100.0f;
            }
            p[j][2 * r + e] = v;
            mx[r] = fmaxf(mx[r], v);
          }
        }
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[j][e] = mma::exp2_approx((p[j][e] - mx[e >> 1]) * mma::kLog2e);
          l[e >> 1] += p[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = r0 + g + 8 * r < N ? 1.0f / l[r] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] *= l[e >> 1];
      // round(P) to shared memory (the dV operand); O = round(P) · v → att
      float o[NO][4];
#pragma unroll
      for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4];
        mma::pack_a(pa, p[2 * kk], p[2 * kk + 1]);
        bf16* prow = ps + (r0 + g) * kLdp + 16 * kk + c2;
        *reinterpret_cast<uint32_t*>(prow) = pa[0];
        *reinterpret_cast<uint32_t*>(prow + 8 * kLdp) = pa[1];
        *reinterpret_cast<uint32_t*>(prow + 8) = pa[2];
        *reinterpret_cast<uint32_t*>(prow + 8 * kLdp + 8) = pa[3];
        if (16 * kk >= N) continue;
#pragma unroll
        for (int dn = 0; dn < KC; ++dn) {
          uint32_t b[4];
          mma::ldsm_x4_t(b, vs + (16 * kk + lr + 8 * l3) * LD + 16 * dn + 8 * l4);
          mma::mma_bf16(o[2 * dn], pa, b[0], b[1]);
          mma::mma_bf16(o[2 * dn + 1], pa, b[2], b[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + g + 8 * r;
        if (row >= N) continue;
        bf16* dst = att + (tok0 + row) * C + hd * DH + c2;
#pragma unroll
        for (int j = 0; j < NO; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) = mma::pack_bf16(o[j][2 * r], o[j][2 * r + 1]);
      }
      // dP = dA · vᵀ, then dS = P∘(dP − rowsum(P∘dP)) in place
      float dp[8][4];
      {
        uint32_t da[KC][4];
        mma::own_fragments<DH>(das + r0 * LD, lane, da);
#pragma unroll
        for (int j = 0; j < 8; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (16 * np >= N) break;
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) {
            uint32_t b[4];
            mma::ldsm_x4(b, vs + (16 * np + lr + 8 * l4) * LD + kc * 16 + 8 * l3);
            mma::mma_bf16(dp[2 * np], da[kc], b[0], b[1]);
            mma::mma_bf16(dp[2 * np + 1], da[kc], b[2], b[3]);
          }
        }
      }
      float dsum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dsum[e >> 1] += p[j][e] * dp[j][e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
        dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[j][e] = p[j][e] * (dp[j][e] - dsum[e >> 1]);
          dbacc[j][e] += dp[j][e];
        }
      // round(dS) to shared memory (the dK operand); dQ = round(dS) · k
      float dq[NO][4];
#pragma unroll
      for (int j = 0; j < NO; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t da[4];
        mma::pack_a(da, dp[2 * kk], dp[2 * kk + 1]);
        bf16* drow = dss + (r0 + g) * kLdp + 16 * kk + c2;
        *reinterpret_cast<uint32_t*>(drow) = da[0];
        *reinterpret_cast<uint32_t*>(drow + 8 * kLdp) = da[1];
        *reinterpret_cast<uint32_t*>(drow + 8) = da[2];
        *reinterpret_cast<uint32_t*>(drow + 8 * kLdp + 8) = da[3];
        if (16 * kk >= N) continue;
#pragma unroll
        for (int dn = 0; dn < KC; ++dn) {
          uint32_t b[4];
          mma::ldsm_x4_t(b, ks + (16 * kk + lr + 8 * l3) * LD + 16 * dn + 8 * l4);
          mma::mma_bf16(dq[2 * dn], da, b[0], b[1]);
          mma::mma_bf16(dq[2 * dn + 1], da, b[2], b[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + g + 8 * r;
        if (row >= N) continue;
        bf16* dst = dqkv + (tok0 + row) * C3 + hd * DH + c2;
#pragma unroll
        for (int j = 0; j < NO; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              mma::pack_bf16(dq[j][2 * r], dq[j][2 * r + 1]);
      }
    } else {
      // rows past every token: zero P and dS rows (the dK / dV products sum
      // over all 64 query rows)
      for (int idx = lane; idx < 16 * kCoreRows / 2; idx += 32) {
        const int r = r0 + idx / (kCoreRows / 2), c = 2 * (idx % (kCoreRows / 2));
        *reinterpret_cast<uint32_t*>(ps + r * kLdp + c) = 0u;
        *reinterpret_cast<uint32_t*>(dss + r * kLdp + c) = 0u;
      }
    }
    __syncthreads();  // round(P), round(dS) of every query row

    // ---- key rows r0 .. r0 + 15: dV = round(P)ᵀ · dA, dK = round(dS)ᵀ · q ----
    if (rows) {
      float dv[NO][4], dk[NO][4];
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dv[j][e] = dk[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (16 * kk >= N) break;
        uint32_t pa[4], sa[4];
        mma::ldsm_x4_t(pa, ps + (16 * kk + lr + 8 * l4) * kLdp + r0 + 8 * l3);
        mma::ldsm_x4_t(sa, dss + (16 * kk + lr + 8 * l4) * kLdp + r0 + 8 * l3);
#pragma unroll
        for (int dn = 0; dn < KC; ++dn) {
          uint32_t b[4], e[4];
          mma::ldsm_x4_t(b, das + (16 * kk + lr + 8 * l3) * LD + 16 * dn + 8 * l4);
          mma::ldsm_x4_t(e, qs + (16 * kk + lr + 8 * l3) * LD + 16 * dn + 8 * l4);
          mma::mma_bf16(dv[2 * dn], pa, b[0], b[1]);
          mma::mma_bf16(dv[2 * dn + 1], pa, b[2], b[3]);
          mma::mma_bf16(dk[2 * dn], sa, e[0], e[1]);
          mma::mma_bf16(dk[2 * dn + 1], sa, e[2], e[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + g + 8 * r;
        if (row >= N) continue;
        bf16* dst = dqkv + (tok0 + row) * C3 + C + hd * DH + c2;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              mma::pack_bf16(dk[j][2 * r], dk[j][2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dst + C + 8 * j) =
              mma::pack_bf16(dv[j][2 * r], dv[j][2 * r + 1]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage t % 2 and the P, dS tiles
    issue(t + 2);
  }
  mma::cp_async_wait<0>();
  // dbias: the block's sum over its windows, one atomic an element
  if (rows) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + 8 * (e >> 1), key = 8 * j + c2 + (e & 1);
        if (row < N && key < N) atomicAdd(dbias + (size_t)hd * N * N + row * N + key, dbacc[j][e]);
      }
  }
}

template <int DH>
cudaError_t attn_core_bf16(const bf16* qkv, const bf16* dA, const float* bias, bf16* att,
                           bf16* dqkv, float* dbias, Canvas cv, int B, int heads,
                           cudaStream_t s) {
  constexpr size_t smem = CoreLayout<DH>::kBytes;
  LC2_TRY(allow_smem(swin_attn_bwd_mma<DH>, smem));
  const int nwin = B * cv.nwh * cv.nww;
  // about four waves of two blocks an SM: enough windows a block to share
  // its bias load and its dbias atomics
  const long long units = (long long)nwin * heads;
  const int wpb = (int)std::max(1LL, (units + 8 * 132 - 1) / (8 * 132));
  const dim3 grid((nwin + wpb - 1) / wpb, heads);
  swin_attn_bwd_mma<DH><<<grid, kCoreThreads, smem, s>>>(qkv, dA, bias, att, dqkv, dbias, cv,
                                                          nwin, wpb);
  return cudaGetLastError();
}

// The workspace of the bf16 body, carved in this order: bf16 LN(x), the
// gathered output gradient, qkv, dA (reused for dLN once the attention core
// has read it), the head outputs and dqkv, then the f32 mean and rstd.
struct Bf16Ws {
  bf16 *hn, *gw, *qkv, *dA, *att, *dqkv;
  float *mean, *rstd;
  Bf16Ws(void* ws, long long M, int C) {
    const long long MC = M * C;
    hn = static_cast<bf16*>(ws);  // [M][C]
    gw = hn + MC;                 // [M][C]
    qkv = gw + MC;                // [M][3C]
    dA = qkv + 3 * MC;            // [M][C]  dA, then dLN
    att = dA + MC;                // [M][C]
    dqkv = att + MC;              // [M][3C]
    mean = reinterpret_cast<float*>(dqkv + 3 * MC);  // [M]
    rstd = mean + M;              // [M]
  }
  // in floats: 10·M·C bf16 (C is a multiple of 32, so every piece stays
  // 16-byte aligned) and 2·M f32
  static long long floats(long long M, int C) { return 5 * M * C + 2 * M; }
};

cudaError_t swin_bwd_bf16(const bf16* x, const bf16* g, const float* lnw, const float* lnb,
                          const bf16* wqkv, const float* bqkv, const bf16* wo, const float* bias,
                          bf16* dx, float* dlnw, float* dlnb, float* dwqkv, float* dbqkv,
                          float* dwo, float* dbo, float* dbias, void* ws, int B, int H, int W,
                          int C, int heads, int win, int shift, int residual, float eps,
                          cudaStream_t s) {
  using gemm16::Epilogue;
  const Canvas cv{H, W, C, win, shift, (H + win - 1) / win, (W + win - 1) / win};
  const long long M = (long long)B * cv.nwh * cv.nww * win * win;
  const int mi = (int)M, C3 = 3 * C;
  const Bf16Ws w(ws, M, C);
  ln_gather_kernel<bf16><<<(unsigned)((M + 7) / 8), 256, 0, s>>>(
      x, g, lnw, lnb, w.hn, w.gw, w.mean, w.rstd, M, cv, eps);
  LC2_TRY(cudaGetLastError());
  // qkv = round(LN · Wqkvᵀ + bqkv); dA = round(g · Wo)
  LC2_TRY((gemm16::gemm<false, false>(mi, C3, C, w.hn, C, wqkv, C,
                                      Epilogue{bqkv, nullptr, nullptr, nullptr, w.qkv, C3, false},
                                      s)));
  LC2_TRY((gemm16::gemm<false, true>(mi, C, C, w.gw, C, wo, C,
                                     Epilogue{nullptr, nullptr, nullptr, nullptr, w.dA, C, false},
                                     s)));
  switch (C / heads) {
    case 16: LC2_TRY(attn_core_bf16<16>(w.qkv, w.dA, bias, w.att, w.dqkv, dbias, cv, B, heads, s)); break;
    case 32: LC2_TRY(attn_core_bf16<32>(w.qkv, w.dA, bias, w.att, w.dqkv, dbias, cv, B, heads, s)); break;
    case 64: LC2_TRY(attn_core_bf16<64>(w.qkv, w.dA, bias, w.att, w.dqkv, dbias, cv, B, heads, s)); break;
    default: return cudaErrorInvalidValue;
  }
  // dWo += gᵀ · att, dbo = Σ g; dWqkv += dqkvᵀ · LN, dbqkv = Σ dqkv (split-K
  // f32 atomics)
  LC2_TRY((gemm16::gemm<true, true>(C, C, mi, w.gw, C, w.att, C,
                                    Epilogue{nullptr, nullptr, nullptr, dwo, nullptr, C, true},
                                    s)));
  LC2_TRY(gemm32::colsum(mi, C, w.gw, C, dbo, s));
  LC2_TRY((gemm16::gemm<true, true>(C3, C, mi, w.dqkv, C3, w.hn, C,
                                    Epilogue{nullptr, nullptr, nullptr, dwqkv, nullptr, C, true},
                                    s)));
  LC2_TRY(gemm32::colsum(mi, C3, w.dqkv, C3, dbqkv, s));
  // dLN = round(dqkv · Wqkv), into dA's slot
  bf16* dhn = w.dA;
  LC2_TRY((gemm16::gemm<false, true>(mi, C, C3, w.dqkv, C3, wqkv, C,
                                     Epilogue{nullptr, nullptr, nullptr, nullptr, dhn, C, false},
                                     s)));
  const long long want = (M + 7) / 8;
  const int blocks = (int)(want < 4 * 132 ? want : 4 * 132);
  ln_bwd_scatter_kernel<bf16><<<blocks, 256, sizeof(float) * 2 * C, s>>>(
      x, g, dhn, w.mean, w.rstd, lnw, dx, dlnw, dlnb, M, cv, residual);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lc2

// Workspace floats the f32 body needs (the wrapper allocates them).
extern "C" long long lc2_swin_window_bwd_workspace(int B, int H, int W, int C, int win) {
  const long long M = (long long)B * ((H + win - 1) / win) * ((W + win - 1) / win) * win * win;
  return lc2::F32Ws::floats(M, C);
}

// Workspace floats the bf16 body needs.
extern "C" long long lc2_swin_window_bwd_workspace_bf16(int B, int H, int W, int C, int win) {
  const long long M = (long long)B * ((H + win - 1) / win) * ((W + win - 1) / win) * win * win;
  return lc2::Bf16Ws::floats(M, C);
}

// x, g (gradient of out), dx (B, H, W, C) of the dtype; wqkv (3C, C) packed
// q|k|v with 1/sqrt(dh) folded into the q rows and wo (C, C), of the dtype;
// lnw, lnb (C,), bqkv (3C,), bias (heads, win², win²) f32: all holding the
// values the forward kernel used.  dlnw, dlnb, dwqkv, dbqkv, dwo, dbo, dbias
// f32 of the same shapes, ZEROED by the caller (the kernels accumulate into
// them).  ws: the dtype's workspace floats (lc2_swin_window_bwd_workspace,
// _bf16).  win <= 8, 0 <= shift < win, C / heads in {16, 32, 64}, C a
// multiple of 32, 16-byte aligned operands.  Both bodies run every product
// on the tensor cores: bf16 on mma.sync m16n8k16, f32 in 3xTF32.
extern "C" int lc2_swin_window_bwd(int dtype, const void* x, const void* g, const void* lnw,
                                   const void* lnb, const void* wqkv, const void* bqkv,
                                   const void* wo, const void* bias, void* dx, void* dlnw,
                                   void* dlnb, void* dwqkv, void* dbqkv, void* dwo, void* dbo,
                                   void* dbias, void* ws, int B, int H, int W, int C, int heads,
                                   int win, int shift, int residual, float eps, void* stream) {
  if (win < 1 || win * win > 64 || shift < 0 || shift >= win || heads < 1 || C % heads ||
      C % 32)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  if (dtype == lc2::kF32)
    return lc2::swin_bwd_f32(f(x), f(g), f(lnw), f(lnb), f(wqkv), f(bqkv), f(wo), f(bias),
                             o(dx), o(dlnw), o(dlnb), o(dwqkv), o(dbqkv), o(dwo), o(dbo),
                             o(dbias), o(ws), B, H, W, C, heads, win, shift, residual, eps, s);
  if (dtype == lc2::kBF16) {
    using bf = __nv_bfloat16;
    auto t = [](const void* p) { return static_cast<const bf*>(p); };
    return lc2::swin_bwd_bf16(t(x), t(g), f(lnw), f(lnb), t(wqkv), f(bqkv), t(wo), f(bias),
                              static_cast<bf*>(dx), o(dlnw), o(dlnb), o(dwqkv), o(dbqkv), o(dwo),
                              o(dbo), o(dbias), ws, B, H, W, C, heads, win, shift, residual, eps,
                              s);
  }
  return cudaErrorInvalidValue;
}
