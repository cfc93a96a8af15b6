// flash_attention_bwd: the gradients dq, dk, dv of flash attention for each
// (batch · head), from the forward's saved f32 row log-sum-exp (lse) and
// delta = Σ_d dO · O per query row (computed by the wrapper).
//
// Replaces the TPU kernels lc2is_tpu/ops/flash_attention.py::
// _flash_bwd_dq_kernel (:163, pallas_call :251) and _flash_bwd_dkv_kernel
// (:194, pallas_call :270), driven by _flash_backward (:230-300).  The math
// is theirs, per (query i, key j), all sums in f32:
//   p_ij  = exp(s_ij · scale − lse_i)        (0 at a masked or padded key)
//   ds_ij = p_ij · (dO_i · v_j − delta_i)
//   dq_i  = scale · Σ_j round_k(ds_ij) · k_j
//   dv_j  = Σ_i round_dO(p_ij) · dO_i
//   dk_j  = scale · Σ_i round_q(ds_ij) · q_i
// where round_T rounds to T's dtype (bf16 or identity for f32), as the TPU
// kernels cast before each product.
//
// What bounds it on the card: arithmetic.  Both kernels recompute s and
// dO · vᵀ, so the pair does 7 products of Lq · Lk · D multiply-adds per
// (b · h) (2 in the dq kernel's recompute plus 1 for dq, 2 + 2 in the dk/dv
// kernel) against about 8 · L · D elements of traffic: at the ViT-B/16 shape
// (L = 1025, D = 64, bf16) about 900 operations per byte, far above the
// H100's ~295 line.  So the (Lq, Lk) probabilities never reach device
// memory and the bf16 products go on the tensor cores.
//
// Design: the TPU's sequential grid axis becomes a loop inside the block, and
// each block writes whole rows of its output: no atomics, deterministic.
// - dq kernel: one block per (b · h, 64-query tile) loops over 64-key tiles;
//   each of its 4 warps owns 16 query rows.
// - dk/dv kernel: one block per (b · h, 64-key tile) loops over 64-query
//   tiles; each warp owns 16 keys and computes sᵀ = k · qᵀ and (dO · vᵀ)ᵀ
//   = v · dOᵀ for them, so the products onto its dk and dv rows need no
//   transpose of p or ds.
// - bf16: every product through WMMA (16x16x16 bf16, f32 accumulators); the
//   operands come from shared memory, the two score-sized products pass
//   through shared memory in f32, p and ds are rounded to bf16 there, and
//   the dq / dk / dv accumulators stay in registers across the loop.
// - f32: the products on the CUDA cores in full f32 (no TF32); a lane owns 4
//   rows x 8 columns of a score tile and 4 rows x DP/8 columns of each
//   accumulator, in registers.
// Head dims: any d from 1 to 128 (DP = d rounded up to 16, zero-filled
// columns; flash_common.cuh).  Ragged Lq and Lk and the key-padding mask are
// masked in the loaders and in p.
// A fully-masked query row (lse = −∞; the forward gives NaN there) is
// decided explicitly: its p is 0, so its dq row is 0 and it adds nothing to
// dk or dv, and the wrapper sets its delta to 0 (its O is NaN), so a NaN row
// never poisons its (b · h).  The TPU kernels would differentiate their
// mean-of-v row instead; no caller reaches such a row.
#include <math.h>
#include <mma.h>

#include "flash_common.cuh"

namespace lc2 {
namespace {

using flash::align128;
using flash::kept_keys;
using flash::load_tile;
constexpr int kB = flash::kRows;  // rows of every tile
constexpr int kThreads = flash::kThreads;

using bf16 = __nv_bfloat16;

// p and ds of one (query, key) pair; live: the key is kept and the query's
// row is not fully masked (lse > −∞) and lies inside Lq.
__device__ __forceinline__ void p_ds(float s, float dp, float lse, float delta, bool live,
                                     float scale, float& p, float& ds) {
  p = live ? expf(s * scale - lse) : 0.0f;
  ds = live ? p * (dp - delta) : 0.0f;
}

// The lse and delta of query row `row` (lse −∞, delta 0 past Lq).
__device__ __forceinline__ void row_stats(const float* __restrict__ lse,
                                          const float* __restrict__ delta, size_t base, int row,
                                          int lq, float& l, float& dl) {
  l = row < lq ? lse[base + row] : -INFINITY;
  dl = row < lq ? delta[base + row] : 0.0f;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (WMMA)
// ---------------------------------------------------------------------------

template <int DP>
struct TcLayout {
  static constexpr int kLd = DP + 8;   // bf16 tile rows (WMMA: multiple of 8)
  static constexpr int kLdS = kB + 4;  // f32 score-sized products
  static constexpr int kLdP = kB + 8;  // bf16 p / ds
  static constexpr int kLdO = DP + 4;  // f32 output staging
  static constexpr size_t kTile = align128(sizeof(bf16) * kB * kLd);
  static constexpr size_t kOffS = 4 * kTile;  // four bf16 tiles first
  static constexpr size_t kOffDP = kOffS + align128(sizeof(float) * kB * kLdS);
  static constexpr size_t kOffP = kOffDP + align128(sizeof(float) * kB * kLdS);
  static constexpr size_t kOffDS = kOffP + align128(sizeof(bf16) * kB * kLdP);
  static constexpr size_t kOffO = kOffDS + align128(sizeof(bf16) * kB * kLdP);
  static constexpr size_t kOffStats = kOffO + align128(sizeof(float) * kB * kLdO);
  static constexpr size_t kBytes = kOffStats + 2 * sizeof(float) * kB;
};

// acc (16 x DP, one warp's rows) times `scale` into rows r0 .. r0 + 15 of
// the (n, d) output, through the warp's f32 staging rows.
template <int DP, typename Acc>
__device__ __forceinline__ void store_rows_tc(Acc (&acc)[DP / 16], float scale, float* ow,
                                              bf16* __restrict__ dst, int r0, int n, int d,
                                              int lane) {
  using namespace nvcuda;
  using L = TcLayout<DP>;
#pragma unroll
  for (int ct = 0; ct < DP / 16; ++ct) {
#pragma unroll
    for (int e = 0; e < acc[ct].num_elements; ++e) acc[ct].x[e] *= scale;
    wmma::store_matrix_sync(ow + ct * 16, acc[ct], L::kLdO, wmma::mem_row_major);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * d; idx += 32) {
    const int r = idx / d, c = idx - r * d;
    if (r0 + r < n) dst[(size_t)(r0 + r) * d + c] = __float2bfloat16(ow[r * L::kLdO + c]);
  }
}

// C (16 x 64, row-major f32 at ldc) = A (16 rows of a tile, row-major) ·
// Bᵀ, B a 64-row tile (both at stride L::kLd, DP columns).
template <int DP>
__device__ __forceinline__ void abt_tc(const bf16* a, const bf16* b, float* c, int ldc) {
  using namespace nvcuda;
  using L = TcLayout<DP>;
#pragma unroll
  for (int nt = 0; nt < kB / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int dk = 0; dk < DP / 16; ++dk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf;
      wmma::load_matrix_sync(af, a + dk * 16, L::kLd);
      wmma::load_matrix_sync(bf, b + nt * 16 * L::kLd + dk * 16, L::kLd);
      wmma::mma_sync(acc, af, bf, acc);
    }
    wmma::store_matrix_sync(c + nt * 16, acc, ldc, wmma::mem_row_major);
  }
}

// acc (16 x DP) += P (16 x 64, bf16 at L::kLdP) · B (a 64-row tile).
template <int DP, typename Acc>
__device__ __forceinline__ void pb_tc(Acc (&acc)[DP / 16], const bf16* p, const bf16* b) {
  using namespace nvcuda;
  using L = TcLayout<DP>;
#pragma unroll
  for (int ct = 0; ct < DP / 16; ++ct) {
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
      wmma::load_matrix_sync(pf, p + kk * 16, L::kLdP);
      wmma::load_matrix_sync(bf, b + kk * 16 * L::kLd + ct * 16, L::kLd);
      wmma::mma_sync(acc[ct], pf, bf, acc[ct]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                const bf16* __restrict__ g, const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq, int heads, int lq,
                int lk, int d, float scale) {
  using namespace nvcuda;
  using L = TcLayout<DP>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = reinterpret_cast<bf16*>(smem_raw + L::kTile);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw + 2 * L::kTile);
  bf16* vs = reinterpret_cast<bf16*>(smem_raw + 3 * L::kTile);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, ly = lane >> 3, lx = lane & 7;
  float* sw = reinterpret_cast<float*>(smem_raw + L::kOffS) + warp * 16 * L::kLdS;
  float* dpw = reinterpret_cast<float*>(smem_raw + L::kOffDP) + warp * 16 * L::kLdS;
  bf16* dsw = reinterpret_cast<bf16*>(smem_raw + L::kOffDS) + warp * 16 * L::kLdP;
  float* ow = reinterpret_cast<float*>(smem_raw + L::kOffO) + warp * 16 * L::kLdO;

  int bh, q0;
  flash::block_tile((lq + kB - 1) / kB, bh, q0);
  const size_t rows = (size_t)bh * lq;
  const uint8_t* mrow = mask != nullptr ? mask + (size_t)(bh / heads) * lk : nullptr;
  load_tile<bf16, DP, L::kLd>(q + rows * d, q0, lq, d, qs);
  load_tile<bf16, DP, L::kLd>(g + rows * d, q0, lq, d, gs);
  float l_r[4], d_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    row_stats(lse, delta, rows, q0 + warp * 16 + 4 * ly + i, lq, l_r[i], d_r[i]);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DP / 16];
#pragma unroll
  for (int ct = 0; ct < DP / 16; ++ct) wmma::fill_fragment(acc[ct], 0.0f);
  const int n_tiles = (lk + kB - 1) / kB;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // q / dO written, every warp done with the previous k / v tile
    load_tile<bf16, DP, L::kLd>(k + (size_t)bh * lk * d, k0, lk, d, ks);
    load_tile<bf16, DP, L::kLd>(v + (size_t)bh * lk * d, k0, lk, d, vs);
    __syncthreads();
    abt_tc<DP>(qs + warp * 16 * L::kLd, ks, sw, L::kLdS);   // s = q · kᵀ
    abt_tc<DP>(gs + warp * 16 * L::kLd, vs, dpw, L::kLdS);  // dO · vᵀ
    __syncwarp();
    bool keep[8];
    kept_keys(mrow, k0, lk, lx, keep);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ly + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p, ds;
        p_ds(sw[r * L::kLdS + lx + 8 * j], dpw[r * L::kLdS + lx + 8 * j], l_r[i], d_r[i],
             keep[j] && l_r[i] != -INFINITY, scale, p, ds);
        dsw[r * L::kLdP + lx + 8 * j] = __float2bfloat16(ds);  // rounded to k's dtype
      }
    }
    __syncwarp();
    pb_tc<DP>(acc, dsw, ks);  // dq += ds · k
  }
  store_rows_tc<DP>(acc, scale, ow, dq + rows * d, q0 + warp * 16, lq, d, lane);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                 const bf16* __restrict__ g, const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 int heads, int lq, int lk, int d, float scale) {
  using namespace nvcuda;
  using L = TcLayout<DP>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = reinterpret_cast<bf16*>(smem_raw + L::kTile);
  bf16* qs = reinterpret_cast<bf16*>(smem_raw + 2 * L::kTile);
  bf16* gs = reinterpret_cast<bf16*>(smem_raw + 3 * L::kTile);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, ly = lane >> 3, lx = lane & 7;
  float* sw = reinterpret_cast<float*>(smem_raw + L::kOffS) + warp * 16 * L::kLdS;
  float* dpw = reinterpret_cast<float*>(smem_raw + L::kOffDP) + warp * 16 * L::kLdS;
  bf16* pw = reinterpret_cast<bf16*>(smem_raw + L::kOffP) + warp * 16 * L::kLdP;
  bf16* dsw = reinterpret_cast<bf16*>(smem_raw + L::kOffDS) + warp * 16 * L::kLdP;
  float* ow = reinterpret_cast<float*>(smem_raw + L::kOffO) + warp * 16 * L::kLdO;
  float* lse_s = reinterpret_cast<float*>(smem_raw + L::kOffStats);
  float* delta_s = lse_s + kB;

  int bh, k0;
  flash::block_tile((lk + kB - 1) / kB, bh, k0);
  const size_t rows = (size_t)bh * lq;
  const uint8_t* mrow = mask != nullptr ? mask + (size_t)(bh / heads) * lk : nullptr;
  load_tile<bf16, DP, L::kLd>(k + (size_t)bh * lk * d, k0, lk, d, ks);
  load_tile<bf16, DP, L::kLd>(v + (size_t)bh * lk * d, k0, lk, d, vs);
  bool keep[4];  // the lane's keys 4 · ly + i of the warp's 16
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + warp * 16 + 4 * ly + i;
    keep[i] = key < lk && !(mrow != nullptr && mrow[key] != 0);
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[DP / 16], dv_acc[DP / 16];
#pragma unroll
  for (int ct = 0; ct < DP / 16; ++ct) {
    wmma::fill_fragment(dk_acc[ct], 0.0f);
    wmma::fill_fragment(dv_acc[ct], 0.0f);
  }
  const int n_tiles = (lq + kB - 1) / kB;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kB;
    __syncthreads();  // k / v written, every warp done with the previous q / dO tile
    load_tile<bf16, DP, L::kLd>(q + rows * d, q0, lq, d, qs);
    load_tile<bf16, DP, L::kLd>(g + rows * d, q0, lq, d, gs);
    if (threadIdx.x < kB) row_stats(lse, delta, rows, q0 + threadIdx.x, lq,
                                    lse_s[threadIdx.x], delta_s[threadIdx.x]);
    __syncthreads();
    abt_tc<DP>(ks + warp * 16 * L::kLd, qs, sw, L::kLdS);   // sᵀ = k · qᵀ
    abt_tc<DP>(vs + warp * 16 * L::kLd, gs, dpw, L::kLdS);  // (dO · vᵀ)ᵀ
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ly + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = lx + 8 * j;
        const float l = lse_s[c];
        float p, ds;
        p_ds(sw[r * L::kLdS + c], dpw[r * L::kLdS + c], l, delta_s[c],
             keep[i] && l != -INFINITY, scale, p, ds);
        pw[r * L::kLdP + c] = __float2bfloat16(p);    // rounded to dO's dtype
        dsw[r * L::kLdP + c] = __float2bfloat16(ds);  // rounded to q's dtype
      }
    }
    __syncwarp();
    pb_tc<DP>(dv_acc, pw, gs);   // dv += pᵀ · dO
    pb_tc<DP>(dk_acc, dsw, qs);  // dk += dsᵀ · q
  }
  const size_t krows = (size_t)bh * lk;
  store_rows_tc<DP>(dk_acc, scale, ow, dk + krows * d, k0 + warp * 16, lk, d, lane);
  __syncwarp();
  store_rows_tc<DP>(dv_acc, 1.0f, ow, dv + krows * d, k0 + warp * 16, lk, d, lane);
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

template <int DP>
struct FmaLayout {
  static constexpr int kLd = DP + 1;   // odd strides: a lane's rows fall in distinct banks
  static constexpr int kLdP = kB + 1;
  static constexpr size_t kTile = align128(sizeof(float) * kB * kLd);
  static constexpr size_t kOffP = 4 * kTile;
  static constexpr size_t kOffDS = kOffP + align128(sizeof(float) * kB * kLdP);
  static constexpr size_t kOffStats = kOffDS + align128(sizeof(float) * kB * kLdP);
  static constexpr size_t kBytes = kOffStats + 2 * sizeof(float) * kB;
};

// s[i][j] = a_i · b_j and t[i][j] = c_i · e_j over DP columns, for the lane's
// rows i of a and c (at ar, cr: 4 consecutive rows) and columns j = lx + 8j
// of b and e (64-row tiles); all at stride L::kLd.
template <int DP>
__device__ __forceinline__ void two_products(const float* ar, const float* b, const float* cr,
                                             const float* e, int lx, float (&s)[4][8],
                                             float (&t)[4][8]) {
  constexpr int LD = FmaLayout<DP>::kLd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = t[i][j] = 0.0f;
#pragma unroll 2
  for (int dd = 0; dd < DP; ++dd) {
    float av[4], cv[4], bv[8], ev[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = ar[i * LD + dd];
      cv[i] = cr[i * LD + dd];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      bv[j] = b[(lx + 8 * j) * LD + dd];
      ev[j] = e[(lx + 8 * j) * LD + dd];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] += av[i] * bv[j];
        t[i][j] += cv[i] * ev[j];
      }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_fma(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ mask,
                 const float* __restrict__ g, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq, int heads, int lq,
                 int lk, int d, float scale) {
  using L = FmaLayout<DP>;
  constexpr int NC = DP / 8;  // accumulator columns a lane owns: lx + 8c
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* gs = reinterpret_cast<float*>(smem_raw + L::kTile);
  float* ks = reinterpret_cast<float*>(smem_raw + 2 * L::kTile);
  float* vs = reinterpret_cast<float*>(smem_raw + 3 * L::kTile);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, ly = lane >> 3, lx = lane & 7;
  float* dsw = reinterpret_cast<float*>(smem_raw + L::kOffDS) + warp * 16 * L::kLdP;
  const int wr = warp * 16 + 4 * ly;  // the lane's first row in the tile

  int bh, q0;
  flash::block_tile((lq + kB - 1) / kB, bh, q0);
  const size_t rows = (size_t)bh * lq;
  const uint8_t* mrow = mask != nullptr ? mask + (size_t)(bh / heads) * lk : nullptr;
  load_tile<float, DP, L::kLd>(q + rows * d, q0, lq, d, qs);
  load_tile<float, DP, L::kLd>(g + rows * d, q0, lq, d, gs);
  float l_r[4], d_r[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_stats(lse, delta, rows, q0 + wr + i, lq, l_r[i], d_r[i]);
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }
  const int n_tiles = (lk + kB - 1) / kB;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kB;
    __syncthreads();
    load_tile<float, DP, L::kLd>(k + (size_t)bh * lk * d, k0, lk, d, ks);
    load_tile<float, DP, L::kLd>(v + (size_t)bh * lk * d, k0, lk, d, vs);
    __syncthreads();
    float s[4][8], dp[4][8];
    two_products<DP>(qs + wr * L::kLd, ks, gs + wr * L::kLd, vs, lx, s, dp);
    bool keep[8];
    kept_keys(mrow, k0, lk, lx, keep);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p, ds;
        p_ds(s[i][j], dp[i][j], l_r[i], d_r[i], keep[j] && l_r[i] != -INFINITY, scale, p, ds);
        dsw[(4 * ly + i) * L::kLdP + lx + 8 * j] = ds;
      }
    __syncwarp();
    const int n_keys = min(kB, lk - k0);  // ds = 0 past Lk
    for (int kk = 0; kk < n_keys; ++kk) {
      float dsv[4], kv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dsw[(4 * ly + i) * L::kLdP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = ks[kk * L::kLd + lx + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] += dsv[i] * kv[c];
    }
    __syncwarp();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + wr + i;
    if (row >= lq) continue;
    float* out = dq + (rows + row) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (lx + 8 * c < d) out[lx + 8 * c] = acc[i][c] * scale;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_fma(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const uint8_t* __restrict__ mask,
                  const float* __restrict__ g, const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int heads, int lq, int lk, int d, float scale) {
  using L = FmaLayout<DP>;
  constexpr int NC = DP / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = reinterpret_cast<float*>(smem_raw + L::kTile);
  float* qs = reinterpret_cast<float*>(smem_raw + 2 * L::kTile);
  float* gs = reinterpret_cast<float*>(smem_raw + 3 * L::kTile);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, ly = lane >> 3, lx = lane & 7;
  float* pw = reinterpret_cast<float*>(smem_raw + L::kOffP) + warp * 16 * L::kLdP;
  float* dsw = reinterpret_cast<float*>(smem_raw + L::kOffDS) + warp * 16 * L::kLdP;
  float* lse_s = reinterpret_cast<float*>(smem_raw + L::kOffStats);
  float* delta_s = lse_s + kB;
  const int wr = warp * 16 + 4 * ly;

  int bh, k0;
  flash::block_tile((lk + kB - 1) / kB, bh, k0);
  const size_t rows = (size_t)bh * lq;
  const uint8_t* mrow = mask != nullptr ? mask + (size_t)(bh / heads) * lk : nullptr;
  load_tile<float, DP, L::kLd>(k + (size_t)bh * lk * d, k0, lk, d, ks);
  load_tile<float, DP, L::kLd>(v + (size_t)bh * lk * d, k0, lk, d, vs);
  bool keep[4];
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + wr + i;
    keep[i] = key < lk && !(mrow != nullptr && mrow[key] != 0);
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;
  }
  const int n_tiles = (lq + kB - 1) / kB;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kB;
    __syncthreads();
    load_tile<float, DP, L::kLd>(q + rows * d, q0, lq, d, qs);
    load_tile<float, DP, L::kLd>(g + rows * d, q0, lq, d, gs);
    if (threadIdx.x < kB) row_stats(lse, delta, rows, q0 + threadIdx.x, lq,
                                    lse_s[threadIdx.x], delta_s[threadIdx.x]);
    __syncthreads();
    float s[4][8], dp[4][8];  // sᵀ (keys x queries) and (dO · vᵀ)ᵀ
    two_products<DP>(ks + wr * L::kLd, qs, vs + wr * L::kLd, gs, lx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = lx + 8 * j;
        const float l = lse_s[c];
        float p, ds;
        p_ds(s[i][j], dp[i][j], l, delta_s[c], keep[i] && l != -INFINITY, scale, p, ds);
        pw[(4 * ly + i) * L::kLdP + c] = p;
        dsw[(4 * ly + i) * L::kLdP + c] = ds;
      }
    __syncwarp();
    const int n_q = min(kB, lq - q0);  // p = ds = 0 past Lq
    for (int qq = 0; qq < n_q; ++qq) {
      float pv[4], dsv[4], gv[NC], qv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pw[(4 * ly + i) * L::kLdP + qq];
        dsv[i] = dsw[(4 * ly + i) * L::kLdP + qq];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        gv[c] = gs[qq * L::kLd + lx + 8 * c];
        qv[c] = qs[qq * L::kLd + lx + 8 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv_acc[i][c] += pv[i] * gv[c];
          dk_acc[i][c] += dsv[i] * qv[c];
        }
    }
    __syncwarp();
  }
  const size_t krows = (size_t)bh * lk;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + wr + i;
    if (key >= lk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (lx + 8 * c >= d) continue;
      dk[(krows + key) * d + lx + 8 * c] = dk_acc[i][c] * scale;
      dv[(krows + key) * d + lx + 8 * c] = dv_acc[i][c];
    }
  }
}

template <typename T, typename KQ, typename KKV>
cudaError_t launch_pair(KQ kq, KKV kkv, size_t smem, const void* q, const void* k,
                        const void* v, const void* mask, const void* g, const float* lse,
                        const float* delta, void* dq, void* dk, void* dv, int bh, int heads,
                        int lq, int lk, int d, float scale, cudaStream_t stream) {
  cudaError_t err = allow_smem(kq, smem);
  if (err == cudaSuccess) err = allow_smem(kkv, smem);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  kq<<<((lq + kB - 1) / kB) * bh, kThreads, smem, stream>>>(
      qt, kt, vt, m, gt, lse, delta, static_cast<T*>(dq), heads, lq, lk, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kkv<<<((lk + kB - 1) / kB) * bh, kThreads, smem, stream>>>(
      qt, kt, vt, m, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), heads, lq, lk, d,
      scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_d(int dtype, const void* q, const void* k, const void* v, const void* mask,
                     const void* g, const float* lse, const float* delta, void* dq, void* dk,
                     void* dv, int bh, int heads, int lq, int lk, int d, float scale,
                     cudaStream_t stream) {
  if (dtype == kBF16)
    return launch_pair<bf16>(flash_bwd_dq_tc<DP>, flash_bwd_dkv_tc<DP>, TcLayout<DP>::kBytes,
                                 q, k, v, mask, g, lse, delta, dq, dk, dv, bh, heads, lq, lk, d,
                                 scale, stream);
  if (dtype == kF32)
    return launch_pair<float>(flash_bwd_dq_fma<DP>, flash_bwd_dkv_fma<DP>,
                                  FmaLayout<DP>::kBytes, q, k, v, mask, g, lse, delta, dq, dk, dv,
                                  bh, heads, lq, lk, d, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace lc2

// q, g, dq (bh, lq, d); k, v, dk, dv (bh, lk, d); all contiguous, one dtype,
// 16-byte aligned; 1 <= d <= 128.  mask: null or (bh / heads, lk) bytes,
// nonzero = ignore the key.  lse, delta: (bh, lq) f32 (delta 0 where lse is
// −∞).  scale = 1 / √d.  Launches the dq kernel, then the dk/dv kernel.
extern "C" int lc2_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                       const void* mask, const void* g, const void* lse,
                                       const void* delta, void* dq, void* dk, void* dv, int bh,
                                       int heads, int lq, int lk, int d, float scale,
                                       void* stream) {
  if (bh <= 0 || heads <= 0 || lq <= 0 || lk <= 0 || d <= 0 || d > lc2::flash::kMaxD ||
      !lc2::flash::grid_fits(bh, lq) || !lc2::flash::grid_fits(bh, lk))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  return lc2::flash::with_dp(d, [&](auto dp) {
    return lc2::launch_d<decltype(dp)::value>(dtype, q, k, v, mask, g, l, dl, dq, dk, dv, bh,
                                              heads, lq, lk, d, scale, s);
  });
}
