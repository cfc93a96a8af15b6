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
// - dq kernel: one block per (b · h, query tile) loops over key tiles; each
//   warp owns 16 query rows.
// - dk/dv kernel: one block per (b · h, key tile) loops over query tiles;
//   each warp owns 16 keys and computes sᵀ = k · qᵀ and (dO · vᵀ)ᵀ
//   = v · dOᵀ for them, so the products onto its dk and dv rows need no
//   transpose of p or ds.
// - bf16 (flash_bwd_dq_mma, flash_bwd_dkv_mma): 128 own rows and 8 warps a
//   block; every product is mma.sync m16n8k16 with f32 accumulators in
//   registers (mma_bf16.cuh).  The warp's own pair (q and dO, or k and v)
//   sits in registers as A fragments, loaded once by ldmatrix (above DP 64
//   the dk/dv kernel reads v's from shared memory at each product, which
//   keeps its 2 · DP accumulator registers unspilled); the other pair
//   streams in 64-row tiles through a two-stage cp.async ring (with the lse
//   and delta of the streamed query rows in the dk/dv kernel), tile t + 1
//   issued before tile t is computed, one barrier a tile.  s and dO · vᵀ
//   stay in registers, 16 columns at a time; p and ds are computed there
//   (exp2 with scale · log2 e folded into one FMA), rounded to bf16 straight
//   into the A fragments of the next products, and the streamed tile enters
//   those as B through ldmatrix.trans.  Shared memory holds only the tiles.
//   A tile whose streamed rows are all live runs a body without branches;
//   in the others an 8-column group with no live key (dq) or query (dk/dv)
//   takes no product.  A dq warp whose rows lie past Lq, or a dk/dv warp
//   whose 16 keys are all past Lk or masked, runs no product (its dk and dv
//   are 0).
// - f32: the products on the CUDA cores in full f32 (no TF32); a lane owns 4
//   rows x 8 columns of a score tile and 4 rows x DP/8 columns of each
//   accumulator, in registers.
// Head dims: any d from 1 to 128 (DP = d rounded up to 16, zero-filled
// columns; flash_common.cuh, mma_bf16.cuh).  Ragged Lq and Lk and the
// key-padding mask are masked in the loaders and in p.
// A fully-masked query row (lse = −∞; the forward gives NaN there) is
// decided explicitly: its p is 0, so its dq row is 0 and it adds nothing to
// dk or dv, and the wrapper sets its delta to 0 (its O is NaN), so a NaN row
// never poisons its (b · h).  The TPU kernels would differentiate their
// mean-of-v row instead; no caller reaches such a row.
#include <math.h>

#include "flash_common.cuh"
#include "mma_bf16.cuh"

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
// bf16: tensor cores (mma.sync m16n8k16, fragments in registers)
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 128;  // rows a block owns: 8 warps x 16
constexpr int kMmaThreads = 256;
constexpr int kMmaCols = 64;   // rows of a streamed tile
constexpr int kMmaStages = 2;  // stages of the cp.async ring

// Shared memory: the block's two own tiles (q and dO, or k and v; 128
// rows), then the ring's stages of two streamed 64-row tiles and, for the
// dk/dv kernel, the lse and delta of the streamed query rows.  bf16 tiles at
// stride DP + 8.
template <int DP>
struct MmaLayout {
  static constexpr int kLd = mma::row_stride<DP>();
  static constexpr int kOwn = kMmaRows * kLd;   // elements of an own tile
  static constexpr int kTile = kMmaCols * kLd;  // elements of a streamed tile
  static constexpr size_t kStage = sizeof(bf16) * 2 * kTile + 2 * sizeof(float) * kMmaCols;
  static constexpr size_t kOwnBytes = sizeof(bf16) * 2 * kOwn;
  static constexpr size_t kBytes = kOwnBytes + kMmaStages * kStage;
};

// One stage of the ring: two streamed tiles and (dk/dv kernel) the stats.
template <int DP>
struct Stage {
  bf16* a;
  bf16* b;
  float* lse;
  float* delta;
  __device__ __forceinline__ Stage(unsigned char* smem, int s) {
    using L = MmaLayout<DP>;
    unsigned char* base = smem + L::kOwnBytes + s * L::kStage;
    a = reinterpret_cast<bf16*>(base);
    b = a + L::kTile;
    lse = reinterpret_cast<float*>(b + L::kTile);
    delta = lse + kMmaCols;
  }
};

// S (16 x 16) = A · Bᵀ for the 16 streamed rows 16c .. 16c + 15 of tile bs,
// and T = C · Eᵀ likewise from tile es, with A, C the warp's 16 own rows as
// A fragments: s[j], t[j] hold columns 8j .. 8j + 7.  kCShared: C's
// fragments are read from shared memory (this lane's ldmatrix row at cs)
// instead of registers.  Unless kFull (every row of the tile live: no
// branch, so ptxas can interleave the loads and products), an 8-row group
// whose 4 bits in `groups` are clear is skipped and left 0.
template <int DP, bool kFull, bool kCShared = false>
__device__ __forceinline__ void two_products_mma(const uint32_t (&a)[DP / 16][4],
                                                 const uint32_t (&c)[kCShared ? 1 : DP / 16][4],
                                                 const bf16* cs, const bf16* bs, const bf16* es,
                                                 int c16, uint32_t groups, int lane,
                                                 float (&s)[2][4], float (&t)[2][4]) {
  constexpr int LD = mma::row_stride<DP>();
  const int lr = lane & 7, lsel1 = (lane >> 3) & 1, lsel2 = lane >> 4;
  const bool g0 = kFull || (groups & 0xfu), g1 = kFull || ((groups >> 4) & 0xfu);
#pragma unroll
  for (int e = 0; e < 4; ++e) s[0][e] = s[1][e] = t[0][e] = t[1][e] = 0.0f;
  const int row = (16 * c16 + lr + 8 * lsel2) * LD + 8 * lsel1;
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    uint32_t b[4], e[4];
    mma::ldsm_x4(b, bs + row + kc * 16);
    mma::ldsm_x4(e, es + row + kc * 16);
    auto products = [&](const uint32_t(&ck)[4]) {
      if (g0) {
        mma::mma_bf16(s[0], a[kc], b[0], b[1]);
        mma::mma_bf16(t[0], ck, e[0], e[1]);
      }
      if (g1) {
        mma::mma_bf16(s[1], a[kc], b[2], b[3]);
        mma::mma_bf16(t[1], ck, e[2], e[3]);
      }
    };
    if constexpr (kCShared) {
      uint32_t cf[4];
      mma::ldsm_x4(cf, cs + kc * 16);
      products(cf);
    } else {
      products(c[kc]);
    }
  }
}

// acc (16 x DP) += P · B, P the rounded A fragment of the 16 x 16 tile p
// (columns = streamed rows 16c .. 16c + 15 of tile bs), B through
// ldmatrix.trans.
template <int DP>
__device__ __forceinline__ void pb_mma(float (&acc)[DP / 8][4], const float (&p)[2][4],
                                       const bf16* bs, int c16, int lane) {
  constexpr int LD = mma::row_stride<DP>();
  uint32_t pa[4];
  mma::pack_a(pa, p[0], p[1]);
  const bf16* row = bs + (16 * c16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
#pragma unroll
  for (int dn = 0; dn < DP / 16; ++dn) {
    uint32_t b[4];
    mma::ldsm_x4_t(b, row + 16 * dn);
    mma::mma_bf16(acc[2 * dn], pa, b[0], b[1]);
    mma::mma_bf16(acc[2 * dn + 1], pa, b[2], b[3]);
  }
}

// This lane's ldmatrix row of the A fragments of 16 rows at own.
template <int DP>
__device__ __forceinline__ const bf16* own_row(const bf16* own, int lane) {
  return own + ((lane & 7) + 8 * ((lane >> 3) & 1)) * mma::row_stride<DP>() + 8 * (lane >> 4);
}

// The A fragments of 16 own rows at own.
template <int DP, int N>
__device__ __forceinline__ void own_fragments(const bf16* own, int lane, uint32_t (&a)[N][4]) {
  const bf16* row = own_row<DP>(own, lane);
#pragma unroll
  for (int kc = 0; kc < N; ++kc) mma::ldsm_x4(a[kc], row + kc * 16);
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                 const bf16* __restrict__ g, const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq, int heads, int lq,
                 int lk, int d, float scale) {
  using L = MmaLayout<DP>;
  constexpr int KC = DP / 16, NO = DP / 8, LD = L::kLd;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + L::kOwn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t4 = lane & 3;

  int bh, q0;
  flash::block_tile<kMmaRows>((lq + kMmaRows - 1) / kMmaRows, bh, q0);
  const size_t rows = (size_t)bh * lq;
  const bf16* kb = k + (size_t)bh * lk * d;
  const bf16* vb = v + (size_t)bh * lk * d;
  const uint8_t* mrow = mask != nullptr ? mask + (size_t)(bh / heads) * lk : nullptr;
  const int n_tiles = (lk + kMmaCols - 1) / kMmaCols;

  auto issue_tile = [&](int t) {  // k_t and v_t into stage t % kMmaStages, one group
    if (t < n_tiles) {
      const Stage<DP> st(smem_raw, t % kMmaStages);
      mma::load_rows<DP, kMmaCols, kMmaThreads>(kb, t * kMmaCols, lk, d, st.a);
      mma::load_rows<DP, kMmaCols, kMmaThreads>(vb, t * kMmaCols, lk, d, st.b);
    }
    mma::cp_async_commit();
  };
  // groups in flight: q and dO, then tiles 0 .. kMmaStages - 2
  mma::load_rows<DP, kMmaRows, kMmaThreads>(q + rows * d, q0, lq, d, qs);
  mma::load_rows<DP, kMmaRows, kMmaThreads>(g + rows * d, q0, lq, d, gs);
  mma::cp_async_commit();
#pragma unroll
  for (int t = 0; t < kMmaStages - 1; ++t) issue_tile(t);
  mma::cp_async_wait<kMmaStages - 1>();
  __syncthreads();

  const bool live = q0 + warp * 16 < lq;
  uint32_t qa[KC][4], ga[KC][4];
  own_fragments<DP>(qs + warp * 16 * LD, lane, qa);
  own_fragments<DP>(gs + warp * 16 * LD, lane, ga);
  // the lane's rows g and g + 8: lse in log2 units (−∞ past Lq or on a
  // fully-masked row, which then takes p = 0) and delta
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
    lse2[r] = row < lq ? lse[rows + row] * mma::kLog2e : -INFINITY;
    dl[r] = row < lq ? delta[rows + row] : 0.0f;
  }
  const float sl2 = scale * mma::kLog2e;
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    mma::cp_async_wait<kMmaStages - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();  // ... every thread's; and every warp is done with tile t - 1
    issue_tile(t + kMmaStages - 1);  // into tile t - 1's stage
    const Stage<DP> cur(smem_raw, t % kMmaStages);
    const mma::KeyBits kept = mma::key_bits(mrow, t * kMmaCols, lk, lane);
    if (!live || !kept.any()) continue;
    // kFull: every key of the tile kept, no branch on the 8-key groups
    auto tile = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
#pragma unroll
      for (int c16 = 0; c16 < kMmaCols / 16; ++c16) {
        const uint32_t groups = (kept.any() >> (8 * c16)) & 0xffu;
        if (!kFull && !groups) continue;
        float s[2][4], dp[2][4];  // s = q · kᵀ and dO · vᵀ over keys 16c .. 16c + 15
        two_products_mma<DP, kFull>(qa, ga, nullptr, cur.a, cur.b, c16, groups, lane, s, dp);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const bool keep = kFull || ((kept.b[e & 1] >> (8 * c16 + 4 * j + t4)) & 1u);
            const bool on = keep && lse2[r] != -INFINITY;
            const float p = on ? mma::exp2_approx(fmaf(s[j][e], sl2, -lse2[r])) : 0.0f;
            dp[j][e] = on ? p * (dp[j][e] - dl[r]) : 0.0f;  // ds, rounded to bf16 in pb_mma
          }
        pb_mma<DP>(acc, dp, cur.a, c16, lane);  // dq += ds · k
      }
    };
    if (kept.all())
      tile(std::true_type{});
    else
      tile(std::false_type{});
  }
  if (!live) return;
  bf16* st = qs + warp * 16 * LD;  // the warp's own q rows stage its dq rows
  mma::stage_rows<DP, NO>(acc, scale, scale, st, lane);
  mma::store_rows<DP>(st, dq + rows * d, q0 + warp * 16, lq, d, lane);
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                  const bf16* __restrict__ g, const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
                  int heads, int lq, int lk, int d, float scale) {
  using L = MmaLayout<DP>;
  constexpr int KC = DP / 16, NO = DP / 8, LD = L::kLd;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + L::kOwn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t4 = lane & 3;

  int bh, k0;
  flash::block_tile<kMmaRows>((lk + kMmaRows - 1) / kMmaRows, bh, k0);
  const size_t rows = (size_t)bh * lq, krows = (size_t)bh * lk;
  const bf16* qb = q + rows * d;
  const bf16* gb = g + rows * d;
  const uint8_t* mrow = mask != nullptr ? mask + (size_t)(bh / heads) * lk : nullptr;
  const int n_tiles = (lq + kMmaCols - 1) / kMmaCols;

  // Tile t: q and dO rows, and the lse and delta of those rows (zeros past
  // Lq, where the query bits below keep p = 0), into stage t % kMmaStages.
  auto issue_tile = [&](int t) {
    if (t < n_tiles) {
      const Stage<DP> st(smem_raw, t % kMmaStages);
      const int r0 = t * kMmaCols;
      mma::load_rows<DP, kMmaCols, kMmaThreads>(qb, r0, lq, d, st.a);
      mma::load_rows<DP, kMmaCols, kMmaThreads>(gb, r0, lq, d, st.b);
      const int i = threadIdx.x & (kMmaCols - 1);
      const bool in = r0 + i < lq;
      if (threadIdx.x < kMmaCols)
        mma::cp_async4(st.lse + i, in ? lse + rows + r0 + i : lse, in);
      else if (threadIdx.x < 2 * kMmaCols)
        mma::cp_async4(st.delta + i, in ? delta + rows + r0 + i : delta, in);
    }
    mma::cp_async_commit();
  };
  // groups in flight: k and v, then tiles 0 .. kMmaStages - 2
  mma::load_rows<DP, kMmaRows, kMmaThreads>(k + krows * d, k0, lk, d, ks);
  mma::load_rows<DP, kMmaRows, kMmaThreads>(v + krows * d, k0, lk, d, vs);
  mma::cp_async_commit();
#pragma unroll
  for (int t = 0; t < kMmaStages - 1; ++t) issue_tile(t);
  mma::cp_async_wait<kMmaStages - 1>();
  __syncthreads();

  // the lane's keys g and g + 8 of the warp's 16; a warp with no kept key
  // (past Lk, or masked) runs no product and writes zeros
  bool keep[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + (lane >> 2) + 8 * r;
    keep[r] = key < lk && !(mrow != nullptr && mrow[key] != 0);
  }
  const bool live = __any_sync(0xffffffffu, keep[0] || keep[1]);
  // k's fragments in registers; v's too where the registers allow (DP <=
  // 64), else read from shared memory at each product
  constexpr bool kVShared = DP > 64;
  uint32_t ka[KC][4], va[kVShared ? 1 : KC][4];
  own_fragments<DP>(ks + warp * 16 * LD, lane, ka);
  if constexpr (!kVShared) own_fragments<DP>(vs + warp * 16 * LD, lane, va);
  const bf16* vrow = own_row<DP>(vs + warp * 16 * LD, lane);
  const float sl2 = scale * mma::kLog2e;
  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    mma::cp_async_wait<kMmaStages - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();  // ... every thread's; and every warp is done with tile t - 1
    issue_tile(t + kMmaStages - 1);  // into tile t - 1's stage
    const Stage<DP> cur(smem_raw, t % kMmaStages);
    const mma::KeyBits inq = mma::key_bits(nullptr, t * kMmaCols, lq, lane);  // query < Lq
    if (!live) continue;
    // kFull: every query of the tile inside Lq, no branch on the 8-query groups
    auto tile = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
#pragma unroll
      for (int c16 = 0; c16 < kMmaCols / 16; ++c16) {
        const uint32_t groups = (inq.any() >> (8 * c16)) & 0xffu;
        if (!kFull && !groups) continue;
        float s[2][4], dp[2][4];  // sᵀ = k · qᵀ, (dO · vᵀ)ᵀ; queries 16c .. 16c + 15
        two_products_mma<DP, kFull, kVShared>(ka, va, vrow, cur.a, cur.b, c16, groups, lane, s,
                                              dp);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 16 * c16 + 8 * j + 2 * t4 + (e & 1);
            const float l = cur.lse[col];
            const bool in = kFull || ((inq.b[e & 1] >> (8 * c16 + 4 * j + t4)) & 1u);
            const bool on = keep[e >> 1] && l != -INFINITY && in;
            const float p =
                on ? mma::exp2_approx(fmaf(s[j][e], sl2, -l * mma::kLog2e)) : 0.0f;
            dp[j][e] = on ? p * (dp[j][e] - cur.delta[col]) : 0.0f;  // dsᵀ
            s[j][e] = p;                                              // pᵀ
          }
        pb_mma<DP>(dv_acc, s, cur.b, c16, lane);   // dv += pᵀ · dO
        pb_mma<DP>(dk_acc, dp, cur.a, c16, lane);  // dk += dsᵀ · q
      }
    };
    if (inq.all())
      tile(std::true_type{});
    else
      tile(std::false_type{});
  }
  // the warp's own k and v rows stage its dk and dv rows
  bf16* kst = ks + warp * 16 * LD;
  bf16* vst = vs + warp * 16 * LD;
  mma::stage_rows<DP, NO>(dk_acc, scale, scale, kst, lane);
  mma::stage_rows<DP, NO>(dv_acc, 1.0f, 1.0f, vst, lane);
  mma::store_rows<DP>(kst, dk + krows * d, k0 + warp * 16, lk, d, lane);
  mma::store_rows<DP>(vst, dv + krows * d, k0 + warp * 16, lk, d, lane);
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
cudaError_t launch_mma_pair(const void* q, const void* k, const void* v, const void* mask,
                            const void* g, const float* lse, const float* delta, void* dq,
                            void* dk, void* dv, int bh, int heads, int lq, int lk, int d,
                            float scale, cudaStream_t stream) {
  constexpr size_t smem = MmaLayout<DP>::kBytes;
  cudaError_t err = allow_smem(flash_bwd_dq_mma<DP>, smem);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dkv_mma<DP>, smem);
  if (err != cudaSuccess) return err;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(g);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  flash_bwd_dq_mma<DP><<<((lq + kMmaRows - 1) / kMmaRows) * bh, kMmaThreads, smem, stream>>>(
      qt, kt, vt, m, gt, lse, delta, static_cast<bf16*>(dq), heads, lq, lk, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_mma<DP><<<((lk + kMmaRows - 1) / kMmaRows) * bh, kMmaThreads, smem, stream>>>(
      qt, kt, vt, m, gt, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads, lq,
      lk, d, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_d(int dtype, const void* q, const void* k, const void* v, const void* mask,
                     const void* g, const float* lse, const float* delta, void* dq, void* dk,
                     void* dv, int bh, int heads, int lq, int lk, int d, float scale,
                     cudaStream_t stream) {
  if (dtype == kBF16)
    return launch_mma_pair<DP>(q, k, v, mask, g, lse, delta, dq, dk, dv, bh, heads, lq, lk, d,
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
