// Warp-level attention tiles on the tensor cores (mma_bf16.cuh), shared by
// the bf16 flash-attention kernels (flash_attention.cu, flash_attention_bwd.cu)
// and the decoder attention block's backward (attention_block_bwd.cu).  A warp
// owns 16 rows; the tiles it streams sit in shared memory at row stride
// DP + 8 (mma_bf16.cuh); the key bits say which streamed rows count.
#pragma once

#include <math.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace lc2 {
namespace mma {

using bf16 = __nv_bfloat16;

// One tile of a warp's online softmax: S = Q · Kᵀ from the k tile, the
// running max and sum of its rows, O rescaled and O += P · V from the v
// tile.  kFull: every key of the tile is kept, so the body has no branch
// and ptxas can interleave its loads and products;
// otherwise 8-key groups with no kept key (past Lk, or masked) take no S
// product and 16-key chunks with none no P · V.
template <int DP, bool kFull>
__device__ __forceinline__ void fwd_tile(const uint32_t (&qa)[DP / 16][4], const bf16* ks,
                                         const bf16* vs, const mma::KeyBits& kept, float sl2,
                                         int lane, float (&o)[DP / 8][4], float (&m)[2],
                                         float (&l)[2]) {
  constexpr int KC = DP / 16, NO = DP / 8, LD = mma::row_stride<DP>();
  const int t4 = lane & 3, lr = lane & 7, lsel1 = (lane >> 3) & 1, lsel2 = lane >> 4;
  // 8-key group j of the tile has a kept key
  auto group = [&](int j) { return kFull || ((kept.any() >> (4 * j)) & 0xfu); };
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
  // S = Q · Kᵀ: k rows through ldmatrix are the B fragments
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    const bool g0 = group(2 * np), g1 = group(2 * np + 1);
    if (!(g0 || g1)) continue;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t b[4];
      mma::ldsm_x4(b, ks + (16 * np + lr + 8 * lsel2) * LD + kc * 16 + 8 * lsel1);
      if (g0) mma::mma_bf16(s[2 * np], qa[kc], b[0], b[1]);
      if (g1) mma::mma_bf16(s[2 * np + 1], qa[kc], b[2], b[3]);
    }
  }
  // online softmax on the registers: a row lives in 4 lanes
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (!kFull && !((kept.b[e] >> (4 * j + t4)) & 1u)) s[j][e] = s[j][2 + e] = -INFINITY;
      mx[0] = fmaxf(mx[0], s[j][e]);
      mx[1] = fmaxf(mx[1], s[j][2 + e]);
    }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * sl2);
    // while a row has no kept key m stays −∞: p = 0 and alpha = 0, not
    // exp2(−∞ − (−∞)) = NaN
    base[r] = m_new == -INFINITY ? 0.0f : m_new;
    const float alpha = mma::exp2_approx(m[r] - base[r]);
    m[r] = m_new;
    l[r] *= alpha;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][2 * r] *= alpha;
      o[j][2 * r + 1] *= alpha;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // one FMA with scale · log2 e folded in, then exp2; −∞ gives p = 0
      s[j][e] = mma::exp2_approx(fmaf(s[j][e], sl2, -base[e >> 1]));
      l[e >> 1] += s[j][e];  // l sums the unrounded p
    }
  // O += P · V: p rounded to bf16 in the A fragment, v through ldmatrix.trans
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (!(group(2 * kk) || group(2 * kk + 1))) continue;
    uint32_t pa[4];
    mma::pack_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
    for (int dn = 0; dn < DP / 16; ++dn) {
      uint32_t b[4];
      mma::ldsm_x4_t(b, vs + (16 * kk + lr + 8 * lsel1) * LD + 16 * dn + 8 * lsel2);
      mma::mma_bf16(o[2 * dn], pa, b[0], b[1]);
      mma::mma_bf16(o[2 * dn + 1], pa, b[2], b[3]);
    }
  }
}

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

}  // namespace mma
}  // namespace lc2
