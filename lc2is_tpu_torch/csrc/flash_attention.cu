// flash_attention: out = softmax(q · kᵀ / √D + key-padding bias) · v for each
// (batch · head), with the row log-sum-exp lse = m + log l in f32.
//
// Replaces the TPU kernel lc2is_tpu/ops/flash_attention.py::_flash_kernel
// (:42, entry flash_attention :340, pallas_call :132).
//
// What bounds it on the card: arithmetic.  Per (b · h) it does 2 · Lq · Lk · D
// multiply-adds against (2 · Lq + 2 · Lk) · D elements of traffic; at the
// served shapes (Lq = Lk = 1025, D = 64 or 96, bf16) that is about 500
// operations per byte, above the H100's ~295 line, so the (Lq, Lk) logits
// must never reach device memory and the products belong on the tensor cores.
//
// In f32 the products run in 3xTF32 (three TF32 products each, ~165 TFLOP/s
// of f32-accurate products at most on the H100), so the same holds.
//
// Design: the TPU's sequential KV grid axis becomes a loop inside the block.
// One block owns one (b · h, query tile), from a one-dimensional grid (so
// B·H is not capped at gridDim.y's 65535); each warp owns 16 of the query
// rows, so the online softmax of a row never leaves its warp.  The block
// streams 64-key tiles of k and v through shared memory; per tile a warp
// computes its 16 x 64 scores, updates the running max m and sum l of its
// rows, rescales its accumulator and adds P · V.  At the end it writes
// o = acc · (1 / l) (a per-row reciprocal, as the TPU kernel does) and lse.
// Ragged Lq and Lk are masked here: nothing is padded in device memory.
// Head dims: any D from 1 to 128, instantiated per DP = D rounded up to a
// multiple of 16; the loaders zero columns D .. DP - 1, so q · k over DP
// columns is q · k over D, and only D output columns are written.  D > 128
// is refused (the wrapper raises).
// - bf16 (flash_mma_kernel): 64 query rows and 4 warps a block, and up to 3
//   blocks an SM (2 above DP 96), so that blocks in different phases of a
//   tile keep the tensor cores busy while others run their softmax.  At
//   (16, 12, 1025, 64) on the H100 no other layout tried (128 or 256 rows a
//   block, two 16-row m-tiles a warp, 128-key tiles, a deeper ring) was
//   quicker without spilling (PERF.md §6).  Both products are mma.sync
//   m16n8k16 with f32 accumulators held in registers (mma_bf16.cuh): a
//   warp's q fragments are loaded once by ldmatrix; k and v arrive through
//   a two-stage cp.async ring, tile t + 1 issued before tile t is computed,
//   one barrier a tile;
//   S = Q · Kᵀ stays in registers, the softmax runs there (a row spans 4
//   lanes: two shuffles for the max; the sum is reduced once at the end)
//   with the scale and log2 e folded into one FMA before exp2; p is rounded
//   to bf16 straight into the A fragment of P · V (as the TPU kernel rounds
//   p to v's dtype), while l sums the unrounded p; v comes in through
//   ldmatrix.trans.  Shared memory holds only the q tile and the ring.
//   A tile whose keys are all kept runs a body without branches; in the
//   others dead work is skipped: an 8-key group with no kept key (past Lk,
//   or masked) takes no S product and a 16-key chunk with none no P · V (at
//   1025 tokens the last tile does 1 group, not 8), a tile with none
//   nothing, and a warp whose rows lie past Lq no product at all.  The
//   output is staged through the warp's own q rows and written in 16-byte
//   stores.  The running max is kept in log2 units; lse = m · ln 2 + log l.
// - f32 (flash_x3_kernel): both products on the tensor cores in 3xTF32
//   (gemm_f32x3.cuh: each operand split into TF32 halves hi + lo, each
//   product lo·hi' + hi·lo' + hi·hi', three mma.sync m16n8k8), f32-accurate,
//   on the plan of the decoder attention's f32 core (attn_core_f32.cuh,
//   whose stage layout and split it shares): up to 128 query rows and 8
//   warps a block, one block an SM; each warp keeps its own q rows in
//   registers (their split halves up to DP 64, above that their values,
//   split at each use); 64-key K and V tiles arrive through a two-stage
//   cp.async ring (zeros past Lk and past D), and each landed tile is split
//   once a block in shared memory (hi over the tile, lo into one lo stage;
//   two barriers a tile), so that no warp splits a K or V value again.
//   S = Q · Kᵀ stays in registers; the online softmax runs there in f32 in
//   log2 units, the scale and log2 e folded into one FMA before exp2; S's C
//   fragment is P · V's A fragment with the mma's k order permuted, split
//   in registers, and V's B fragment is read in that order.  Every mma's
//   products are summed into zero accumulators and added in f32, round to
//   nearest: the tensor cores' own adds truncate, and a chain over 1025
//   keys drifts.  The hi·hi term of each product runs as two m16n8k4 mmas
//   (gemm32::mma_x3_row_k4hi), so that each of the tensor cores' internal
//   sums, which drop the low bits of its smaller products, holds 4
//   products, not 8: on an H100 that cuts the outputs' mean drift toward
//   zero by a quarter (3.6e-9 to 2.8e-9 of max |out| at (16, 12, 1025, 64))
//   for ~10 % of the time.  With 8-product sums one relu unit of
//   PromptFTNv2's prompt decoder, fed through FTNDecoderV2's flash calls and
//   lying within f32 noise of zero, fell on the other side from the CPU's
//   in chip_smoke.py's phase 13a; with 4 it did not, a fact of that seed
//   and not a margin (PERF.md §6).  32 keys with no kept key take no S
//   product, 8 with none no P · V, a tile with none nothing.
// Masked keys take a bias of −∞ in effect.  A row with no kept key keeps
// m = −∞ and l = 0 (no exp(−∞ − (−∞))), so its output is 0 · (1/0) = NaN and
// its lse −∞, as torch's softmax gives; the TPU kernel's −1e30 bias would
// instead return the mean of v over the block-padded keys.
#include <math.h>

#include "attn_core_f32.cuh"
#include "attn_tiles.cuh"
#include "flash_common.cuh"

namespace lc2 {
namespace {

using mma::fwd_tile;

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, fragments in registers)
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows a block owns
constexpr int kMmaKeys = 64;              // keys a tile of the cp.async ring
constexpr int kMmaStages = 2;

// Blocks an SM that the register budget must allow: 3 (170 registers a
// thread) up to DP 96, where ptxas needs 154-168 without spilling; 2 above.
template <int DP>
constexpr int mma_min_blocks() { return DP <= 96 ? 3 : 2; }

// Shared memory: the block's q rows, then the ring's stages of (k tile, v
// tile), all bf16 at stride DP + 8 (mma_bf16.cuh).  No score, p or
// accumulator buffer.
template <int DP>
struct MmaLayout {
  static constexpr int kLd = mma::row_stride<DP>();
  static constexpr int kTile = kMmaKeys * kLd;  // elements of a k or v tile
  static constexpr size_t kBytes = sizeof(bf16) * (kMmaRows * kLd + 2 * kMmaStages * kTile);
};

template <int DP>
__global__ void __launch_bounds__(kMmaThreads, mma_min_blocks<DP>())
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                 bf16* __restrict__ out, float* __restrict__ lse, int heads, int lq, int lk,
                 int d, float scale) {
  using L = MmaLayout<DP>;
  constexpr int KC = DP / 16;  // 16-wide chunks of the head dim
  constexpr int NO = DP / 8;   // 8-wide output tiles
  constexpr int LD = L::kLd, ST = kMmaStages;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = qs + kMmaRows * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  int bh, q0;
  flash::block_tile<kMmaRows>((lq + kMmaRows - 1) / kMmaRows, bh, q0);
  const bf16* kb = k + (size_t)bh * lk * d;
  const bf16* vb = v + (size_t)bh * lk * d;
  const uint8_t* mrow = mask != nullptr ? mask + (size_t)(bh / heads) * lk : nullptr;
  const int n_tiles = (lk + kMmaKeys - 1) / kMmaKeys;
  auto issue_tile = [&](int t) {  // k_t and v_t into stage t % ST, one group
    if (t < n_tiles) {
      bf16* ks = ring + (t % ST) * 2 * L::kTile;
      mma::load_rows<DP, kMmaKeys, kMmaThreads>(kb, t * kMmaKeys, lk, d, ks);
      mma::load_rows<DP, kMmaKeys, kMmaThreads>(vb, t * kMmaKeys, lk, d, ks + L::kTile);
    }
    mma::cp_async_commit();
  };

  // groups in flight: q, then tiles 0 .. ST - 2
  mma::load_rows<DP, kMmaRows, kMmaThreads>(q + (size_t)bh * lq * d, q0, lq, d, qs);
  mma::cp_async_commit();
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) issue_tile(t);
  mma::cp_async_wait<ST - 1>();
  __syncthreads();

  // A warp whose 16 rows all lie past Lq runs no product, only the loads
  // and barriers it shares with the block.
  const bool live = q0 + warp * 16 < lq;
  bf16* qw = qs + warp * 16 * LD;  // the warp's q rows, later its output staging
  uint32_t qa[KC][4];
  {
    const bf16* row = qw + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) mma::ldsm_x4(qa[kc], row + kc * 16);
  }
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  // rows g and g + 8 of the warp: running max (log2 units, scale folded in)
  // and this lane's share of the running sum (its 4 lanes add up at the end)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const float sl2 = scale * mma::kLog2e;

  for (int t = 0; t < n_tiles; ++t) {
    mma::cp_async_wait<ST - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();  // ... every thread's; and every warp is done with tile t - 1
    issue_tile(t + ST - 1);  // into tile t - 1's stage
    const bf16* ks = ring + (t % ST) * 2 * L::kTile;
    const mma::KeyBits kept = mma::key_bits(mrow, t * kMmaKeys, lk, lane);
    if (!live || !kept.any()) continue;  // nothing to add (m and l unchanged)
    if (kept.all())
      fwd_tile<DP, true>(qa, ks, ks + L::kTile, kept, sl2, lane, o, m, l);
    else
      fwd_tile<DP, false>(qa, ks, ks + L::kTile, kept, sl2, lane, o, m, l);
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // o = acc · (1 / l), staged through the warp's own q rows; l = 0 (no kept
  // key): 0 · ∞ = NaN
  mma::stage_rows<DP, NO>(o, 1.0f / l[0], 1.0f / l[1], qw, lane);
  mma::store_rows<DP>(qw, out + (size_t)bh * lq * d, q0 + warp * 16, lq, d, lane);
  if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
      if (row < lq) lse[(size_t)bh * lq + row] = m[r] * mma::kLn2 + logf(l[r]);
    }
  }
}

template <int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* mask, void* out,
                       void* lse, int bh, int heads, int lq, int lk, int d, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = MmaLayout<DP>::kBytes;
  cudaError_t err = allow_smem(flash_mma_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  flash_mma_kernel<DP><<<((lq + kMmaRows - 1) / kMmaRows) * bh, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), static_cast<float*>(lse),
      heads, lq, lk, d, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 on the tensor cores (mma.sync m16n8k8, gemm_f32x3.cuh)
// ---------------------------------------------------------------------------

constexpr int kX3Warps = 8;  // query rows a block: at most 8 warps x 16

// Shared memory: two ring stages of a 64-key K and V tile (attn_core_f32.cuh's
// CoreLayout: K at row stride DP + 8, V at DP + 4) and one stage of the lo
// halves of the tile being computed: 206 KB at DP 128, 107 KB at DP 64.
template <int DP>
constexpr size_t x3_smem() { return sizeof(float) * 3 * CoreLayout<DP>::kStage; }

template <int DP>
__global__ void __launch_bounds__(32 * kX3Warps, 1)
flash_x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const uint8_t* __restrict__ mask,
                float* __restrict__ out, float* __restrict__ lse, int heads, int lq, int lk,
                int d, float scale) {
  using Lay = CoreLayout<DP>;
  constexpr int KC = DP / 8, NO = DP / 8, G = NO % 4 == 0 ? 4 : 2;
  // q's split halves in registers up to DP 64; above, its values, split at each use
  constexpr bool kQSplit = DP <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  float* lo = ring + 2 * Lay::kStage;
  const int nthreads = blockDim.x, rows = nthreads / 2;  // 16 query rows a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n_qt = (lq + rows - 1) / rows;
  const int bh = blockIdx.x / n_qt, p0 = (blockIdx.x - bh * n_qt) * rows + 16 * warp;
  const float* kb = k + (size_t)bh * lk * d;
  const float* vb = v + (size_t)bh * lk * d;
  const uint8_t* mrow = mask != nullptr ? mask + (size_t)(bh / heads) * lk : nullptr;
  const int n_tiles = (lk + kF32Keys - 1) / kF32Keys;
  auto issue = [&](int i) {  // K and V tile i into ring stage i % 2, one group
    if (i < n_tiles) {
      float* st = ring + (i & 1) * Lay::kStage;
      flash::load_rows_f32<DP, Lay::kLdK>(kb, i * kF32Keys, kF32Keys, lk, d, st, nthreads);
      flash::load_rows_f32<DP, Lay::kLdV>(vb, i * kF32Keys, kF32Keys, lk, d,
                                          st + kF32Keys * Lay::kLdK, nthreads);
    }
    mma::cp_async_commit();
  };
  issue(0);

  // the warp's q rows g and g + 8, columns 2t, 2t + 1 of each 8-wide step
  const bool live = p0 < lq;
  gemm32::Split<4> qf[kQSplit ? KC : 1];
  float2 qv[kQSplit ? 1 : KC][2];
  {
    const float* qr = q + ((size_t)bh * lq + p0 + g) * d;
    const bool in0 = p0 + g < lq, in8 = p0 + g + 8 < lq;
    const float2 zero = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const float2 a = in0 ? flash::load_pair(qr, 8 * kc + 2 * t, d) : zero;
      const float2 b = in8 ? flash::load_pair(qr + 8 * (size_t)d, 8 * kc + 2 * t, d) : zero;
      if constexpr (kQSplit) {
        qf[kc] = gemm32::split_a(a, b);
      } else {
        qv[kc][0] = a;
        qv[kc][1] = b;
      }
    }
  }
  auto q_of = [&](int kc) -> gemm32::Split<4> {
    if constexpr (kQSplit) return qf[kc];
    else return gemm32::split_a(qv[kc][0], qv[kc][1]);
  };
  float o[NO / G][G][4];  // head columns 8(G·jg + j) .. + 7
#pragma unroll
  for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
    for (int j = 0; j < G; ++j) o[jg][j][0] = o[jg][j][1] = o[jg][j][2] = o[jg][j][3] = 0.0f;
  // rows g and g + 8: running max (log2 units, scale folded in) and this
  // lane's share of the running sum (its quad adds up at the end)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const float sl2 = scale * mma::kLog2e;
  const int kofs = g * Lay::kLdK + 2 * t;
  const int vofs = kF32Keys * Lay::kLdK + 2 * t * Lay::kLdV + g;

  for (int i = 0; i < n_tiles; ++i) {
    mma::cp_async_wait<0>();  // tile i has landed (this thread's copies)
    // ... every thread's; every warp is done with tile i - 1 and the lo stage
    __syncthreads();
    issue(i + 1);  // into tile i - 1's stage
    float* st = ring + (i & 1) * Lay::kStage;
    // the mask row is the block's: every warp has the same bits
    const mma::KeyBits kept = mma::key_bits(mrow, i * kF32Keys, lk, lane);
    const uint32_t any = kept.any();
    if (any) split_stage<DP>(st, lo, nthreads);  // hi over the tile, lo into the lo stage
    __syncthreads();
    if (!live || !any) continue;  // no kept key: m and l unchanged
    // S = Q · Kᵀ: 8 groups of 8 keys (key group 4jg + j in s[jg][j]), 4 at a
    // time; 32 keys with no kept key take no product
    float s[2][4][4];
#pragma unroll
    for (int jg = 0; jg < 2; ++jg)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[jg][j][0] = s[jg][j][1] = s[jg][j][2] = s[jg][j][3] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const gemm32::Split<4> a = q_of(kc);
#pragma unroll
      for (int jg = 0; jg < 2; ++jg) {
        if (!((any >> (16 * jg)) & 0xffffu)) continue;
        gemm32::Split<2> kf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int off = kofs + 8 * (4 * jg + j) * Lay::kLdK + 8 * kc;
          const uint2 h = *reinterpret_cast<const uint2*>(st + off);
          const uint2 w = *reinterpret_cast<const uint2*>(lo + off);
          kf[j] = gemm32::Split<2>{{h.x, h.y}, {w.x, w.y}};
        }
        gemm32::mma_x3_row_k4hi<4>(s[jg], a, kf);
      }
    }
    // the online softmax: a row lives in the 4 lanes of a quad; a dropped
    // key (masked, or past Lk) takes −∞
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jg = 0; jg < 2; ++jg)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float* sj = s[jg][j];
          if (!((kept.b[e] >> (4 * (4 * jg + j) + t)) & 1u)) sj[e] = sj[2 + e] = -INFINITY;
          mx[0] = fmaxf(mx[0], sj[e]);
          mx[1] = fmaxf(mx[1], sj[2 + e]);
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // the tile holds a kept key: m_new is finite, alpha 0 on a row's first
      const float m_new = fmaxf(m[r], mx[r] * sl2);
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
          // one FMA with scale · log2 e folded in, then exp2; −∞ gives p = 0
          float& p = s[jg][j][e];
          p = mma::exp2_approx(fmaf(p, sl2, -m[e >> 1]));
          l[e >> 1] += p;
        }
    // O += P · V: key group kk of S is the A fragment (k t <- key 2t, k t + 4
    // <- key 2t + 1); 8 keys with no kept key (p = 0) take no product
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (!((any >> (4 * kk)) & 0xfu)) continue;
      const float* sk = s[kk >> 2][kk & 3];
      const gemm32::Split<4> pf =
          gemm32::split_a(make_float2(sk[0], sk[1]), make_float2(sk[2], sk[3]));
      const float* vr = st + vofs + 8 * kk * Lay::kLdV;
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
        gemm32::mma_x3_row_k4hi<G>(o[jg], pf, vf);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = p0 + g + 8 * r;
    if (row >= lq) continue;
    const float inv = 1.0f / l[r];  // l = 0 (no kept key): 0 · ∞ = NaN
    float* dst = out + ((size_t)bh * lq + row) * d;
#pragma unroll
    for (int jg = 0; jg < NO / G; ++jg)
#pragma unroll
      for (int j = 0; j < G; ++j)
        flash::store_pair(dst, 8 * (G * jg + j) + 2 * t, d, o[jg][j][2 * r] * inv,
                          o[jg][j][2 * r + 1] * inv);
    if (lse != nullptr && t == 0) lse[(size_t)bh * lq + row] = m[r] * mma::kLn2 + logf(l[r]);
  }
}

template <int DP>
cudaError_t launch_x3(const void* q, const void* k, const void* v, const void* mask, void* out,
                      void* lse, int bh, int heads, int lq, int lk, int d, float scale,
                      cudaStream_t stream) {
  constexpr size_t smem = x3_smem<DP>();
  LC2_TRY(allow_smem(flash_x3_kernel<DP>, smem));
  const int groups = (lq + 15) / 16, warps = groups < kX3Warps ? groups : kX3Warps;
  flash_x3_kernel<DP><<<((lq + 16 * warps - 1) / (16 * warps)) * bh, 32 * warps, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), static_cast<float*>(lse),
      heads, lq, lk, d, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_d(int dtype, const void* q, const void* k, const void* v, const void* mask,
                     void* out, void* lse, int bh, int heads, int lq, int lk, int d, float scale,
                     cudaStream_t stream) {
  if (dtype == kBF16)
    return launch_mma<DP>(q, k, v, mask, out, lse, bh, heads, lq, lk, d, scale, stream);
  if (dtype == kF32)
    return launch_x3<DP>(q, k, v, mask, out, lse, bh, heads, lq, lk, d, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace lc2

// q (bh, lq, d), k and v (bh, lk, d), out like q, all contiguous, one dtype,
// 16-byte aligned; 1 <= d <= 128.  mask: null or (bh / heads, lk) bytes,
// nonzero = ignore the key.  lse: null or (bh, lq) f32.  scale = 1 / √d.
extern "C" int lc2_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                   const void* mask, void* out, void* lse, int bh, int heads,
                                   int lq, int lk, int d, float scale, void* stream) {
  if (bh <= 0 || heads <= 0 || lq <= 0 || lk <= 0 || d <= 0 || d > lc2::flash::kMaxD ||
      !lc2::flash::grid_fits(bh, lq))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return lc2::flash::with_dp(d, [&](auto dp) {
    return lc2::launch_d<decltype(dp)::value>(dtype, q, k, v, mask, out, lse, bh, heads, lq, lk,
                                              d, scale, s);
  });
}
