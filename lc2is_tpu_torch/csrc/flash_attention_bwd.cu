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
// - f32 (flash_bwd_dq_x3, flash_bwd_dkv_x3): every product on the tensor
//   cores in 3xTF32 (gemm_f32x3.cuh: each operand split into TF32 halves hi
//   + lo, each product lo·hi' + hi·lo' + hi·hi', three mma.sync m16n8k8),
//   f32-accurate, on the plan of the decoder attention backward's f32 core
//   (attention_block_bwd.cu's attn_dq_x3, attn_dkdv_x3): 64 own rows and 4
//   warps a block, two blocks an SM up to DP 64; the warp's own pair sits in
//   registers as unsplit A fragments, split at each use (above DP 64 dO's,
//   or v's, rows are read from shared memory instead, and the streamed
//   tiles hold 32 rows, so that registers and shared memory hold out); the
//   other pair streams through a two-stage cp.async ring, zeros past the
//   sequence and past D.  p and ds are C fragments in registers, split into
//   the A fragments of the next products (their k order permuted); the
//   streamed tile enters every product as B straight from shared memory.
//   Each streamed tile's products onto dq (or dk and dv) are summed into
//   fresh accumulators and added to the running sums in f32, so that the
//   tensor cores' truncating adds do not drift over 1025 rows; the dk/dv
//   kernel keeps its running sums in shared memory.
// Head dims: any d from 1 to 128 (DP = d rounded up to 16, zero-filled
// columns; flash_common.cuh, mma_bf16.cuh).  Ragged Lq and Lk and the
// key-padding mask are masked in the loaders and in p.
// A fully-masked query row (lse = −∞; the forward gives NaN there) is
// decided explicitly: its p is 0, so its dq row is 0 and it adds nothing to
// dk or dv, and the wrapper sets its delta to 0 (its O is NaN), so a NaN row
// never poisons its (b · h).  The TPU kernels would differentiate their
// mean-of-v row instead; no caller reaches such a row.
#include <math.h>

#include "attn_tiles.cuh"
#include "flash_common.cuh"
#include "gemm_f32x3.cuh"

namespace lc2 {
namespace {

using mma::own_fragments;
using mma::own_row;
using mma::pb_mma;
using mma::two_products_mma;

using bf16 = __nv_bfloat16;

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
// f32: 3xTF32 on the tensor cores (mma.sync m16n8k8, gemm_f32x3.cuh)
// ---------------------------------------------------------------------------

constexpr int kX3Rows = 64;  // own rows a block: 4 warps x 16
constexpr int kX3Threads = 128;

// Shared memory of the two f32 kernels: a two-stage ring, each stage two
// streamed tiles of kCols rows at row stride DP + 4 floats (a lane's 4-byte
// loads of rows 2t and 2t + 1, column g, fall in distinct banks) and the
// streamed rows' lse and delta (dk/dv kernel); above DP 64, the block's
// second own operand (dO or v: 64 rows at stride DP + 8, whose 8-byte
// fragment loads fall in distinct banks), which the registers no longer
// hold; then the dk/dv kernel's running sums (DP floats a thread,
// thread-major so that a warp's accesses are conflict-free).  Above DP 64 a
// streamed tile holds 32 rows, so that the dk/dv kernel fits (168 KB at DP
// 128; 103 KB at DP 64, two blocks an SM).
template <int DP>
struct X3Layout {
  static constexpr bool kShared = DP > 64;
  static constexpr int kCols = kShared ? 32 : 64;
  static constexpr int kLd = DP + 4, kLdOwn = DP + 8;
  static constexpr int kTile = kCols * kLd;
  static constexpr int kStage = 2 * kTile + 2 * kCols;
  static constexpr int kOwn = kShared ? kX3Rows * kLdOwn : 0;
  static constexpr size_t kDqBytes = sizeof(float) * (2 * kStage + kOwn);
  static constexpr size_t kKvBytes = sizeof(float) * (2 * kStage + kOwn + kX3Threads * DP);
};

// A warp's own 16 rows r0 .. r0 + 15 of a (n, d) matrix (zeros past row n
// and column d) as the raw A fragments of a product over DP: f[kc][0] row
// r0 + g, f[kc][1] row r0 + g + 8, columns 8kc + 2t and 2t + 1 (the GEMM's k
// order); split where they are used.
template <int DP>
__device__ __forceinline__ void x3_own_rows(const float* __restrict__ src, int r0, int n, int d,
                                            int lane, float2 (&f)[DP / 8][2]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    const float* p = src + (size_t)row * d;
#pragma unroll
    for (int kc = 0; kc < DP / 8; ++kc)
      f[kc][r] = row < n ? flash::load_pair(p, 8 * kc + 2 * t, d) : make_float2(0.0f, 0.0f);
  }
}

// The block's own 64 rows r0 .. r0 + 63 of a (n, d) matrix into shared
// memory at row stride DP + 8, zeros past row n and column d (published by
// the caller's barrier).
template <int DP>
__device__ __forceinline__ void x3_own_tile(const float* __restrict__ src, int r0, int n, int d,
                                            float* dst) {
  constexpr int LD = X3Layout<DP>::kLdOwn;
  for (int idx = threadIdx.x; idx < kX3Rows * DP; idx += kX3Threads) {
    const int r = idx / DP, c = idx - r * DP;
    dst[r * LD + c] = r0 + r < n && c < d ? src[(size_t)(r0 + r) * d + c] : 0.0f;
  }
}

// s[j] = A(16 own rows) · X[row0 + 8j + g]ᵀ and dp[j] = B(16 own rows) ·
// Y[...]ᵀ over DP, j = 0, 1: the scores of 16 streamed rows (X, Y tiles)
// against the warp's own operands, in 3xTF32.  A from registers; B from
// registers, or above DP 64 from the warp's 16 rows bw of the own tile.
template <int DP>
__device__ __forceinline__ void x3_scores(const float2 (&a)[DP / 8][2],
                                          const float2 (&b)[X3Layout<DP>::kShared ? 1 : DP / 8][2],
                                          const float* bw, const float* xs, const float* ys,
                                          int row0, int lane, float (&s)[2][4], float (&dp)[2][4]) {
  using Lay = X3Layout<DP>;
  constexpr int LD = Lay::kLd;
  const int g = lane >> 2, t = lane & 3;
  const int o = (row0 + g) * LD + 2 * t;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
  for (int kc = 0; kc < DP / 8; ++kc) {
    gemm32::mma_x3_bt<2, LD>(s, gemm32::split_a(a[kc][0], a[kc][1]), xs + o + 8 * kc);
    gemm32::Split<4> bf;
    if constexpr (Lay::kShared) {
      const float* p = bw + g * Lay::kLdOwn + 8 * kc + 2 * t;
      bf = gemm32::split_a(*reinterpret_cast<const float2*>(p),
                           *reinterpret_cast<const float2*>(p + 8 * Lay::kLdOwn));
    } else {
      bf = gemm32::split_a(b[kc][0], b[kc][1]);
    }
    gemm32::mma_x3_bt<2, LD>(dp, bf, ys + o + 8 * kc);
  }
}

// dq = scale · Σ_keys ds · k with p = 2^(q·kᵀ·scale·log2 e − lse·log2 e) and
// ds = p ∘ (dO · vᵀ − delta), every product in 3xTF32.  One block a (b · h,
// 64-query tile); warp w owns query rows 16w .. 16w + 15 (their q and dO
// fragments in registers; dO's in shared memory above DP 64); K and V tiles
// stream through a two-stage cp.async ring, 16 keys at a time.  Each key
// tile's dq sums into fresh accumulators, added to the running sums in f32.
// 16 keys with no kept key take no product, a tile with none nothing.
template <int DP>
__global__ void __launch_bounds__(kX3Threads, 2)
flash_bwd_dq_x3(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const uint8_t* __restrict__ mask,
                const float* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq, int heads, int lq,
                int lk, int d, float scale) {
  using Lay = X3Layout<DP>;
  constexpr int KC = DP / 8, NO = DP / 8, G = NO % 4 == 0 ? 4 : 2, CL = Lay::kCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  float* own = ring + 2 * Lay::kStage;  // dO's 64 rows above DP 64
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int bh, q0;
  flash::block_tile<kX3Rows>((lq + kX3Rows - 1) / kX3Rows, bh, q0);
  const size_t rows = (size_t)bh * lq;
  const float* kb = k + (size_t)bh * lk * d;
  const float* vb = v + (size_t)bh * lk * d;
  const uint8_t* mrow = mask != nullptr ? mask + (size_t)(bh / heads) * lk : nullptr;
  const int n_tiles = (lk + CL - 1) / CL;
  auto issue = [&](int i) {  // K and V tile i into stage i % 2, one group
    if (i < n_tiles) {
      float* ks = ring + (i & 1) * Lay::kStage;
      flash::load_rows_f32<DP, Lay::kLd>(kb, i * CL, CL, lk, d, ks, kX3Threads);
      flash::load_rows_f32<DP, Lay::kLd>(vb, i * CL, CL, lk, d, ks + Lay::kTile, kX3Threads);
    }
    mma::cp_async_commit();
  };
  issue(0);

  const int r0 = q0 + 16 * warp;
  const bool live = r0 < lq;
  float2 qa[KC][2], ga[Lay::kShared ? 1 : KC][2];
  x3_own_rows<DP>(q + rows * d, r0, lq, d, lane, qa);
  if constexpr (Lay::kShared)
    x3_own_tile<DP>(dout + rows * d, q0, lq, d, own);
  else
    x3_own_rows<DP>(dout + rows * d, r0, lq, d, lane, ga);
  const float* gw = own + 16 * warp * Lay::kLdOwn;
  // rows g and g + 8: lse in log2 units (−∞ past Lq or on a fully-masked
  // row, which then takes p = 0) and delta
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    lse2[r] = row < lq ? lse[rows + row] * mma::kLog2e : -INFINITY;
    dl[r] = row < lq ? delta[rows + row] : 0.0f;
  }
  const float sl2 = scale * mma::kLog2e;
  float acc[NO / G][G][4];
#pragma unroll
  for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
    for (int j = 0; j < G; ++j) acc[jg][j][0] = acc[jg][j][1] = acc[jg][j][2] = acc[jg][j][3] = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    mma::cp_async_wait<0>();
    __syncthreads();  // tile i (and the own tile) in place; every warp is done with tile i - 1
    issue(i + 1);     // into tile i - 1's stage
    const mma::KeyBits kept = mma::key_bits(mrow, i * CL, lk, lane);  // bits past CL unused
    const uint32_t any = kept.any() & (CL == 64 ? 0xffffffffu : 0xffffu);
    if (!live || !any) continue;
    const float* ks = ring + (i & 1) * Lay::kStage;
    const float* vs = ks + Lay::kTile;
    float part[NO / G][G][4];  // this tile's dq
#pragma unroll
    for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
      for (int j = 0; j < G; ++j)
        part[jg][j][0] = part[jg][j][1] = part[jg][j][2] = part[jg][j][3] = 0.0f;
#pragma unroll
    for (int c16 = 0; c16 < CL / 16; ++c16) {
      if (!((any >> (8 * c16)) & 0xffu)) continue;  // warp-uniform
      float s[2][4], dp[2][4];  // q · kᵀ and dO · vᵀ over keys 16c .. 16c + 15
      x3_scores<DP>(qa, ga, gw, ks, vs, 16 * c16, lane, s, dp);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool on = ((kept.b[e & 1] >> (8 * c16 + 4 * j + t)) & 1u) && lse2[r] != -INFINITY;
          const float p = on ? mma::exp2_approx(fmaf(s[j][e], sl2, -lse2[r])) : 0.0f;
          dp[j][e] = on ? p * (dp[j][e] - dl[r]) : 0.0f;  // ds
        }
#pragma unroll
      for (int j = 0; j < 2; ++j)  // dq += ds · k
        gemm32::mma_x3_rows<DP, G, Lay::kLd>(part, dp[j], ks + (16 * c16 + 8 * j) * Lay::kLd,
                                             lane);
    }
#pragma unroll
    for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jg][j][e] += part[jg][j][e];
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= lq) continue;
    float* dst = dq + (rows + row) * d;
#pragma unroll
    for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
      for (int j = 0; j < G; ++j)
        flash::store_pair(dst, 8 * (G * jg + j) + 2 * t, d, acc[jg][j][2 * r] * scale,
                          acc[jg][j][2 * r + 1] * scale);
  }
}

// dk = scale · Σ_queries dsᵀ · q and dv = Σ_queries pᵀ · dO, every product in
// 3xTF32.  One block a (b · h, 64-key tile); warp w owns keys 16w .. 16w + 15
// (their k and v fragments in registers; v's in shared memory above DP 64)
// and computes sᵀ = k · qᵀ and (dO · vᵀ)ᵀ = v · dOᵀ for them over streamed
// query tiles of q and dO (with their lse and delta), 16 queries at a time,
// so that the products onto its dk and dv rows need no transpose of p or ds.
// Each query tile sums into fresh accumulators, added in f32 to running sums
// a thread keeps in shared memory.  Each block owns its keys' sums: no
// atomics.  A warp with no kept key (past Lk, or masked) runs no product and
// writes zeros.
template <int DP>
__global__ void __launch_bounds__(kX3Threads, 2)
flash_bwd_dkv_x3(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ mask,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                 int heads, int lq, int lk, int d, float scale) {
  using Lay = X3Layout<DP>;
  constexpr int KC = DP / 8, NO = DP / 8, G = NO % 4 == 0 ? 4 : 2, CL = Lay::kCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  float* own = ring + 2 * Lay::kStage;  // v's 64 rows above DP 64
  // this thread's DP running sums, element e at sums[e · 128]: dv's DP / 2, then dk's
  float* sums = own + Lay::kOwn + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int bh, k0;
  flash::block_tile<kX3Rows>((lk + kX3Rows - 1) / kX3Rows, bh, k0);
  const size_t rows = (size_t)bh * lq, krows = (size_t)bh * lk;
  const float* qb = q + rows * d;
  const float* gb = dout + rows * d;
  const uint8_t* mrow = mask != nullptr ? mask + (size_t)(bh / heads) * lk : nullptr;
  const int n_tiles = (lq + CL - 1) / CL;
  // query tile i, its lse and delta (zeros past Lq, where the query test
  // below keeps p = 0), into stage i % 2, one group
  auto issue = [&](int i) {
    if (i < n_tiles) {
      float* qs = ring + (i & 1) * Lay::kStage;
      const int qr0 = i * CL;
      flash::load_rows_f32<DP, Lay::kLd>(qb, qr0, CL, lq, d, qs, kX3Threads);
      flash::load_rows_f32<DP, Lay::kLd>(gb, qr0, CL, lq, d, qs + Lay::kTile, kX3Threads);
      if (threadIdx.x < 2 * CL) {
        const int c = threadIdx.x & (CL - 1);
        const bool in = qr0 + c < lq;
        const float* src = threadIdx.x < CL ? lse : delta;
        mma::cp_async4(qs + 2 * Lay::kTile + threadIdx.x, in ? src + rows + qr0 + c : src, in);
      }
    }
    mma::cp_async_commit();
  };
  issue(0);

  const int r0 = k0 + 16 * warp;
  // the lane's keys g and g + 8 of the warp's 16: inside Lk and not masked
  bool keep[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r0 + g + 8 * r;
    keep[r] = key < lk && !(mrow != nullptr && mrow[key] != 0);
  }
  const bool live = __any_sync(0xffffffffu, keep[0] || keep[1]);
  float2 ka[KC][2], va[Lay::kShared ? 1 : KC][2];
  x3_own_rows<DP>(k + krows * d, r0, lk, d, lane, ka);
  if constexpr (Lay::kShared)
    x3_own_tile<DP>(v + krows * d, k0, lk, d, own);
  else
    x3_own_rows<DP>(v + krows * d, r0, lk, d, lane, va);
  const float* vw = own + 16 * warp * Lay::kLdOwn;
#pragma unroll
  for (int e = 0; e < DP; ++e) sums[e * kX3Threads] = 0.0f;
  const float sl2 = scale * mma::kLog2e;

  for (int i = 0; i < n_tiles; ++i) {
    mma::cp_async_wait<0>();
    __syncthreads();  // tile i (and the own tile) in place; every warp is done with tile i - 1
    issue(i + 1);
    if (!live) continue;
    const float* qs = ring + (i & 1) * Lay::kStage;
    const float* gs = qs + Lay::kTile;
    const float* st = gs + Lay::kTile;  // lse [CL], then delta [CL]
    const int qr0 = i * CL;
    float pdv[NO / G][G][4], pdk[NO / G][G][4];  // this tile's sums
#pragma unroll
    for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pdv[jg][j][e] = pdk[jg][j][e] = 0.0f;
#pragma unroll
    for (int c16 = 0; c16 < CL / 16; ++c16) {
      if (qr0 + 16 * c16 >= lq) break;  // warp-uniform
      float s[2][4], dp[2][4];  // sᵀ = k · qᵀ, (dO · vᵀ)ᵀ; queries 16c .. 16c + 15
      x3_scores<DP>(ka, va, vw, qs, gs, 16 * c16, lane, s, dp);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 16 * c16 + 8 * j + 2 * t + (e & 1);
          const float l = st[col];
          const bool on = keep[e >> 1] && qr0 + col < lq && l != -INFINITY;
          const float p = on ? mma::exp2_approx(fmaf(s[j][e], sl2, -l * mma::kLog2e)) : 0.0f;
          dp[j][e] = on ? p * (dp[j][e] - st[CL + col]) : 0.0f;  // dsᵀ
          s[j][e] = p;                                          // pᵀ
        }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = (16 * c16 + 8 * j) * Lay::kLd;
        gemm32::mma_x3_rows<DP, G, Lay::kLd>(pdv, s[j], gs + row, lane);   // dv += pᵀ · dO
        gemm32::mma_x3_rows<DP, G, Lay::kLd>(pdk, dp[j], qs + row, lane);  // dk += dsᵀ · q
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
          sums[(DP / 2 + x) * kX3Threads] += pdk[jg][j][e];
        }
  }
  // every key below Lk: a masked key's rows are 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r0 + g + 8 * r;
    if (key >= lk) continue;
    float* dvr = dv + (krows + key) * d;
    float* dkr = dk + (krows + key) * d;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int x = 4 * n + 2 * r;
      flash::store_pair(dvr, 8 * n + 2 * t, d, sums[x * kX3Threads], sums[(x + 1) * kX3Threads]);
      flash::store_pair(dkr, 8 * n + 2 * t, d, sums[(DP / 2 + x) * kX3Threads] * scale,
                        sums[(DP / 2 + x + 1) * kX3Threads] * scale);
    }
  }
}

template <int DP>
cudaError_t launch_x3_pair(const void* q, const void* k, const void* v, const void* mask,
                           const void* g, const float* lse, const float* delta, void* dq,
                           void* dk, void* dv, int bh, int heads, int lq, int lk, int d,
                           float scale, cudaStream_t stream) {
  using Lay = X3Layout<DP>;
  LC2_TRY(allow_smem(flash_bwd_dq_x3<DP>, Lay::kDqBytes));
  LC2_TRY(allow_smem(flash_bwd_dkv_x3<DP>, Lay::kKvBytes));
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* gt = static_cast<const float*>(g);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  flash_bwd_dq_x3<DP><<<((lq + kX3Rows - 1) / kX3Rows) * bh, kX3Threads, Lay::kDqBytes, stream>>>(
      qt, kt, vt, m, gt, lse, delta, static_cast<float*>(dq), heads, lq, lk, d, scale);
  LC2_TRY(cudaGetLastError());
  flash_bwd_dkv_x3<DP><<<((lk + kX3Rows - 1) / kX3Rows) * bh, kX3Threads, Lay::kKvBytes, stream>>>(
      qt, kt, vt, m, gt, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), heads, lq,
      lk, d, scale);
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
    return launch_x3_pair<DP>(q, k, v, mask, g, lse, delta, dq, dk, dv, bh, heads, lq, lk, d,
                              scale, stream);
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
