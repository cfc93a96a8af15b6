// The attention core of the decoder attention block's f32 body, shared by
// the forward (csrc/attention_block.cu, TPU row 2) and the backward's
// recompute (csrc/attention_block_bwd.cu, row 3), so that the two run one
// code: O = softmax(Q · Kᵀ) · V per (image, head) over pre-projected (B, L,
// C) keys and values, every product in 3xTF32 on the tensor cores
// (gemm_f32x3.cuh), f32-accurate; the backward also takes each row's
// log-sum-exp (lse, log2 units).  The design, described at attn_core_f32
// below: a block owns one (image, head, key range) and up to
// 160 query rows, K/V tiles split once a block in shared memory, the key
// ranges merged by attn_merge_f32.  Its stage layout and split (CoreLayout,
// split_stage) also serve flash attention's f32 forward
// (csrc/flash_attention.cu).
#pragma once

#include <math.h>

#include "gemm_f32x3.cuh"

namespace lc2 {
namespace {

constexpr int kF32Keys = 64;      // keys of a streamed K/V tile
constexpr int kF32Stages = 4;     // K/V tiles in the ring
constexpr int kF32MaxWarps = 10;  // P <= 160: one block holds every query row of a head
constexpr int kF32TileWarps = 8;  // P > 160: query tiles of 128 rows
constexpr int kSMs = 132;

// Shared memory of the core: the ring's stages of a K tile at row stride DH
// + 8 (a half-warp's 8-byte loads of rows g, columns 2t, 2t + 1 fall in
// distinct banks) and a V tile at DH + 4 (the 4-byte loads of rows 2t and
// 2t + 1, column g, do), then two stages for the lo halves of the tiles
// being split and computed (their hi halves overwrite the tiles in the
// ring): 210 KB at dh 64.
template <int DH>
struct CoreLayout {
  static constexpr int kLdK = DH + 8, kLdV = DH + 4;
  static constexpr int kStage = kF32Keys * (kLdK + kLdV);
  static constexpr size_t kBytes = sizeof(float) * (kF32Stages + 2) * kStage;
};

// Split a landed K/V stage in place: each value's TF32 hi half over it, its
// lo half into the same place of `lo`; by all nthreads threads, 16 bytes at
// a time.  Once a block, so that no warp splits a K/V value again.
template <int DH>
__device__ __forceinline__ void split_stage(float* st, float* lo, int nthreads) {
  using Lay = CoreLayout<DH>;
  constexpr int kChunks = DH / 4;
  for (int idx = threadIdx.x; idx < 2 * kF32Keys * kChunks; idx += nthreads) {
    const int r = idx / kChunks, c = (idx - r * kChunks) * 4;  // rows 64.. are V's
    const int o = r < kF32Keys ? r * Lay::kLdK + c
                               : kF32Keys * Lay::kLdK + (r - kF32Keys) * Lay::kLdV + c;
    float4 v = *reinterpret_cast<const float4*>(st + o);
    uint4 h, l;
    gemm32::split(v.x, h.x, l.x);
    gemm32::split(v.y, h.y, l.y);
    gemm32::split(v.z, h.z, l.z);
    gemm32::split(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(st + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

// How a call is cut: warps a block (16 query rows each), query tiles, key
// ranges and 64-key tiles a range.  Enough ranges that the blocks fill two
// waves of the SMs (one block an SM: 210 KB of shared memory at dh 64), at
// most one range a key tile.  Query tiles above 160 rows hold 128 rows, so
// that each split tile serves 8 warps.
struct CorePlan {
  int warps, q_tiles, splits, tiles_per_split;
  CorePlan(int B, int P, int L, int heads) {
    warps = P <= 16 * kF32MaxWarps ? (P + 15) / 16 : kF32TileWarps;
    q_tiles = (P + 16 * warps - 1) / (16 * warps);
    const int n_tiles = (L + kF32Keys - 1) / kF32Keys;
    const long long base = (long long)B * heads * q_tiles;
    const long long s = (2LL * kSMs + base - 1) / base;
    tiles_per_split = (n_tiles + (int)(s < n_tiles ? s : n_tiles) - 1) /
                      (int)(s < n_tiles ? s : n_tiles);
    splits = (n_tiles + tiles_per_split - 1) / tiles_per_split;
  }
  // floats of the ranges' partials: O (DH) and (m, l) a row, head and range
  long long partial_floats(int B, int P, int C, int heads) const {
    return splits > 1 ? (long long)splits * B * heads * P * (C / heads + 2) : 0;
  }
};

// The attention core of the f32 body: grid (query tiles x key ranges,
// heads, B), 32 · warps threads.  Warp w owns query rows p0 + 16w .. + 15 of
// head h of image b as split A fragments in registers and walks the 64-key
// tiles of its range: each tile split once in shared memory (split_stage,
// by every thread while the warps compute the tile before it, one barrier a
// tile; cp.async runs two tiles ahead), S = Q · Kᵀ (3xTF32), the online
// softmax in f32 in log2 units with the row max subtracted, O += P · V
// (3xTF32).  S's C fragment is
// P · V's A fragment with the mma's k order permuted (k t <- key 2t, k t + 4
// <- key 2t + 1 of each 8-key group), and V's B fragment is read in that
// order.  One range: O / l into att (which may be q: a block reads its q
// rows before it writes them, and no other block reads them) and, where lse
// is not null, m + log2 l into lse[(b · heads + h) · P + p]; several: the
// unnormalised O and (m, l) into the partials, range-major.  kFresh: each
// 8-key group's P · V sums into fresh accumulators, added to O in f32 (round
// to nearest), for the backward's recompute; otherwise the products add
// into O on the tensor cores, whose truncating adds drift over a long key
// range (~8e-6 of max |O| over 1024 keys, ~2e-6 of the backward's
// gradients), ~15 % faster.  kNearest (the forward): every mma's products
// are added in f32, round to nearest (gemm_f32x3.cuh), so neither drifts.
template <int DH, bool kFresh, bool kNearest>
__global__ void __launch_bounds__(32 * kF32MaxWarps, 1)
attn_core_f32(const float* q, const float* __restrict__ k, const float* __restrict__ v,
              float* att, float* __restrict__ lse, float* __restrict__ part_o,
              float2* __restrict__ part_ml, int P, int L, int C, int splits,
              int tiles_per_split) {
  using Lay = CoreLayout<DH>;
  constexpr int KC = DH / 8, NO = DH / 8, G = NO < 4 ? NO : 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const int nthreads = blockDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x % splits, qt = blockIdx.x / splits;
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y, B = gridDim.z;
  const int p0 = qt * 16 * (nthreads >> 5) + 16 * warp;
  const int n_tiles = (L + kF32Keys - 1) / kF32Keys;
  const int t0 = split * tiles_per_split, n_mine = min(n_tiles, t0 + tiles_per_split) - t0;
  const float* kb = k + (size_t)b * L * C + h * DH;
  const float* vb = v + (size_t)b * L * C + h * DH;

  auto issue = [&](int i) {  // tile t0 + i into stage i % kF32Stages, one group
    if (i < n_mine) {
      float* ks = ring + (i % kF32Stages) * Lay::kStage;
      float* vs = ks + kF32Keys * Lay::kLdK;
      const int key0 = (t0 + i) * kF32Keys;
      constexpr int kChunks = DH / 4;
      for (int idx = threadIdx.x; idx < kF32Keys * kChunks; idx += nthreads) {
        const int r = idx / kChunks, c = (idx - r * kChunks) * 4;
        const bool full = key0 + r < L;
        const size_t off = (size_t)(key0 + r) * C + c;
        mma::cp_async16(ks + r * Lay::kLdK + c, full ? kb + off : kb, full);
        mma::cp_async16(vs + r * Lay::kLdV + c, full ? vb + off : vb, full);
      }
    }
    mma::cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kF32Stages - 1; ++i) issue(i);

  // the warp's q rows g and g + 8, columns 2t, 2t + 1 of each 8-wide step
  const bool live = p0 < P;
  gemm32::Split<4> qf[KC];
  {
    const float* qrow = q + ((size_t)b * P + p0 + g) * C + h * DH + 2 * t;
    const bool in0 = p0 + g < P, in8 = p0 + g + 8 < P;
    const float2 zero = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      qf[kc] = gemm32::split_a(in0 ? *reinterpret_cast<const float2*>(qrow + 8 * kc) : zero,
                               in8 ? *reinterpret_cast<const float2*>(qrow + 8 * C + 8 * kc)
                                   : zero);
  }
  float o[NO / G][G][4];  // head columns 8(G·jg + j) .. + 7
#pragma unroll
  for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
    for (int j = 0; j < G; ++j) o[jg][j][0] = o[jg][j][1] = o[jg][j][2] = o[jg][j][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  // the lo halves of tile i in lo_of(i)
  auto lo_of = [&](int i) { return ring + (kF32Stages + (i & 1)) * Lay::kStage; };
  mma::cp_async_wait<kF32Stages - 2>();  // tile 0 has landed (this thread's copies)
  __syncthreads();  // ... every thread's
  split_stage<DH>(ring, lo_of(0), nthreads);
  for (int i = 0; i < n_mine; ++i) {
    mma::cp_async_wait<kF32Stages - 3>();  // tile i + 1 has landed (this thread's copies)
    // ... every thread's; tile i is split; every warp is done with tile i - 1
    __syncthreads();
    issue(i + kF32Stages - 1);  // into tile i - 1's stage
    if (i + 1 < n_mine)  // tile i + 1 into the lo stage tile i - 1 used
      split_stage<DH>(ring + ((i + 1) % kF32Stages) * Lay::kStage, lo_of(i + 1), nthreads);
    if (!live) continue;
    const float* lo = lo_of(i);
    const int kofs = g * Lay::kLdK + 2 * t;
    const int vofs = kF32Keys * Lay::kLdK + 2 * t * Lay::kLdV + g;
    const float* ks = ring + (i % kF32Stages) * Lay::kStage + kofs;
    const float* vs = ring + (i % kF32Stages) * Lay::kStage + vofs;
    // S = Q · Kᵀ: 8 groups of 8 keys (key group 4jg + j in s[jg][j]), 4 at a time
    float s[2][4][4];
#pragma unroll
    for (int jg = 0; jg < 2; ++jg)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[jg][j][0] = s[jg][j][1] = s[jg][j][2] = s[jg][j][3] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int jg = 0; jg < 2; ++jg) {
        gemm32::Split<2> kf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = 8 * (4 * jg + j) * Lay::kLdK + 8 * kc;
          const uint2 h = *reinterpret_cast<const uint2*>(ks + o);
          const uint2 l = *reinterpret_cast<const uint2*>(lo + kofs + o);
          kf[j] = gemm32::Split<2>{{h.x, h.y}, {l.x, l.y}};
        }
        gemm32::mma_x3_row<4, kNearest>(s[jg], qf[kc], kf);
      }
    // the online softmax: a row lives in the 4 lanes of a quad
    const int key0 = (t0 + i) * kF32Keys;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jg = 0; jg < 2; ++jg)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float* sj = s[jg][j];
          if (key0 + 8 * (4 * jg + j) + 2 * t + e >= L) sj[e] = sj[2 + e] = -INFINITY;
          mx[0] = fmaxf(mx[0], sj[e]);
          mx[1] = fmaxf(mx[1], sj[2 + e]);
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // every tile holds a key below L: m_new is finite, alpha 0 on the first
      const float m_new = fmaxf(m[r], mx[r] * mma::kLog2e);
      const float alpha = mma::exp2_approx(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
        for (int j = 0; j < G; ++j) {
          o[jg][j][2 * r] *= alpha;
          o[jg][j][2 * r + 1] *= alpha;
        }
    }
#pragma unroll
    for (int jg = 0; jg < 2; ++jg)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& p = s[jg][j][e];
          p = mma::exp2_approx(fmaf(p, mma::kLog2e, -m[e >> 1]));  // −∞ gives 0
          l[e >> 1] += p;
        }
    // O += P · V: key group kk of S is the A fragment (k t <- key 2t, k t + 4 <- key 2t + 1)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const float* sk = s[kk >> 2][kk & 3];
      const gemm32::Split<4> pf =
          gemm32::split_a(make_float2(sk[0], sk[1]), make_float2(sk[2], sk[3]));
      const float* vr = vs + 8 * kk * Lay::kLdV;
      const float* vl = lo + vofs + 8 * kk * Lay::kLdV;
#pragma unroll
      for (int jg = 0; jg < NO / G; ++jg) {
        gemm32::Split<2> vf[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int col = 8 * (G * jg + j);
          vf[j] = gemm32::Split<2>{{__float_as_uint(vr[col]), __float_as_uint(vr[Lay::kLdV + col])},
                                   {__float_as_uint(vl[col]), __float_as_uint(vl[Lay::kLdV + col])}};
        }
        if constexpr (kFresh) {
          // these 8 keys' products into fresh accumulators, added to O in f32
          // (round to nearest)
          float part[G][4];
#pragma unroll
          for (int j = 0; j < G; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.0f;
          gemm32::mma_x3_row<G, kNearest>(part, pf, vf);
#pragma unroll
          for (int j = 0; j < G; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[jg][j][e] += part[j][e];
        } else {
          gemm32::mma_x3_row<G, kNearest>(o[jg], pf, vf);
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const size_t rows = splits == 1 ? 0 : (((size_t)split * B + b) * heads + h) * P;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = p0 + g + 8 * r;
    if (row >= P) continue;
    if (splits == 1) {
      const float inv = 1.0f / l[r];
      float* dst = att + ((size_t)b * P + row) * C + h * DH + 2 * t;
#pragma unroll
      for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
        for (int j = 0; j < G; ++j)
          *reinterpret_cast<float2*>(dst + 8 * (G * jg + j)) =
              make_float2(o[jg][j][2 * r] * inv, o[jg][j][2 * r + 1] * inv);
      if (lse && t == 0) lse[((size_t)b * heads + h) * P + row] = m[r] + log2f(l[r]);
    } else {
      float* dst = part_o + (rows + row) * DH + 2 * t;
#pragma unroll
      for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
        for (int j = 0; j < G; ++j)
          *reinterpret_cast<float2*>(dst + 8 * (G * jg + j)) =
              make_float2(o[jg][j][2 * r], o[jg][j][2 * r + 1]);
      if (t == 0) part_ml[rows + row] = make_float2(m[r], l[r]);
    }
  }
}

// att[b, p, h · DH + d] = Σ_s O_s · 2^(m_s − M) / Σ_s l_s · 2^(m_s − M), M
// the largest m_s, the ranges s summed in order, and (lse not null) the
// row's M + log2 Σ l_s 2^(m_s − M) into lse; one block a (b, p) row, C
// threads.
template <int DH>
__global__ void __launch_bounds__(512)
attn_merge_f32(const float* __restrict__ part_o, const float2* __restrict__ part_ml,
               float* __restrict__ att, float* __restrict__ lse, int B, int P, int C,
               int heads, int splits) {
  const int row = blockIdx.x, b = row / P, p = row - b * P;
  const int c = threadIdx.x, h = c / DH, d = c - h * DH;
  const size_t range = (size_t)B * heads * P, r0 = ((size_t)b * heads + h) * P + p;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_ml[s * range + r0].x);
  float l = 0.0f, o = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const float2 ml = part_ml[s * range + r0];
    const float w = mma::exp2_approx(ml.x - mx);
    l += ml.y * w;
    o += part_o[(s * range + r0) * DH + d] * w;
  }
  att[(size_t)row * C + c] = o * (1.0f / l);
  if (lse && d == 0) lse[((size_t)b * heads + h) * P + p] = mx + log2f(l);
}

// The head outputs over q (att may be q), and each row's log-sum-exp in
// log2 units where lse is not null; part: CorePlan's partial_floats.
template <int DH, bool kFresh = false, bool kNearest = false>
cudaError_t attn_core_launch(const float* q, const float* k, const float* v, float* att,
                             float* lse, float* part, int B, int P, int L, int C, int heads,
                             cudaStream_t st) {
  const CorePlan plan(B, P, L, heads);
  constexpr size_t smem = CoreLayout<DH>::kBytes;
  LC2_TRY(allow_smem(attn_core_f32<DH, kFresh, kNearest>, smem));
  float2* part_ml = reinterpret_cast<float2*>(part + (size_t)plan.splits * B * heads * P * DH);
  attn_core_f32<DH, kFresh, kNearest><<<dim3(plan.q_tiles * plan.splits, heads, B), 32 * plan.warps,
                                        smem, st>>>(
      q, k, v, att, lse, part, part_ml, P, L, C, plan.splits, plan.tiles_per_split);
  LC2_TRY(cudaGetLastError());
  if (plan.splits == 1) return cudaSuccess;
  attn_merge_f32<DH><<<B * P, C, 0, st>>>(part, part_ml, att, lse, B, P, C, heads,
                                          plan.splits);
  return cudaGetLastError();
}
}  // namespace
}  // namespace lc2
