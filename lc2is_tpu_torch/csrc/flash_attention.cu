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
// - f32: both products on the CUDA cores in full f32 (no TF32); a lane owns
//   4 query rows x 8 key columns of a score tile and 4 rows x D/8 columns of
//   the accumulator, held in registers.
// Masked keys take a bias of −∞ in effect.  A row with no kept key keeps
// m = −∞ and l = 0 (no exp(−∞ − (−∞))), so its output is 0 · (1/0) = NaN and
// its lse −∞, as torch's softmax gives; the TPU kernel's −1e30 bias would
// instead return the mean of v over the block-padded keys.
#include <math.h>

#include "flash_common.cuh"
#include "mma_bf16.cuh"

namespace lc2 {
namespace {

using flash::align128;
using flash::kept_keys;
using flash::load_tile;
constexpr int kBQ = flash::kRows;  // f32: query rows per block, 4 warps x 16
constexpr int kBK = flash::kRows;  // keys per tile
constexpr int kThreads = flash::kThreads;

using bf16 = __nv_bfloat16;

// One key tile's online-softmax update of a lane's 4 rows.  s holds the raw
// q · k products of its keys lx + 8j; on return s holds p = exp(s · scale −
// m_new) (0 at dropped keys), (m, l) are updated and alpha = exp(m_old −
// m_new) is what the row's accumulator must be scaled by.  The 8 lanes of a
// row (same lane / 8) reduce with shuffles.  While a row has no kept key,
// m_new = −∞: p = 0 and alpha = 0 (l and the accumulator stay 0) instead of
// exp(−∞ − (−∞)) = NaN.
__device__ __forceinline__ void online_softmax(float (&s)[4][8], const bool (&keep)[8],
                                               float scale, float (&m)[4], float (&l)[4],
                                               float (&alpha)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[i][j] = keep[j] ? s[i][j] * scale : -INFINITY;
      mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m[i], mx);
    const float base = m_new == -INFINITY ? 0.0f : m_new;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[i][j] = expf(s[i][j] - base);
      sum += s[i][j];
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    alpha[i] = expf(m[i] - base);
    l[i] = l[i] * alpha[i] + sum;
    m[i] = m_new;
  }
}

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
// f32: CUDA cores
// ---------------------------------------------------------------------------

template <int DP>
struct FmaLayout {
  static constexpr int kLdQ = DP + 1;   // odd strides: a lane's rows fall in distinct banks
  static constexpr int kLdV = DP;
  static constexpr int kLdP = kBK + 1;
  static constexpr size_t kOffK = align128(sizeof(float) * kBQ * kLdQ);
  static constexpr size_t kOffV = kOffK + align128(sizeof(float) * kBK * kLdQ);
  static constexpr size_t kOffP = kOffV + align128(sizeof(float) * kBK * kLdV);
  static constexpr size_t kBytes = kOffP + sizeof(float) * kBQ * kLdP;
};

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ lse, int heads, int lq, int lk,
                 int d, float scale) {
  using L = FmaLayout<DP>;
  constexpr int NC = DP / 8;  // accumulator columns a lane owns: lx + 8c
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = reinterpret_cast<float*>(smem_raw + L::kOffK);
  float* vs = reinterpret_cast<float*>(smem_raw + L::kOffV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, ly = lane >> 3, lx = lane & 7;
  float* pw = reinterpret_cast<float*>(smem_raw + L::kOffP) + warp * 16 * L::kLdP;
  const float* qw = qs + (warp * 16 + 4 * ly) * L::kLdQ;

  int bh, q0;
  flash::block_tile((lq + kBQ - 1) / kBQ, bh, q0);
  const float* kb = k + (size_t)bh * lk * d;
  const float* vb = v + (size_t)bh * lk * d;
  const uint8_t* mrow = mask != nullptr ? mask + (size_t)(bh / heads) * lk : nullptr;

  load_tile<float, DP, L::kLdQ>(q + (size_t)bh * lq * d, q0, lq, d, qs);
  float acc[4][NC], m[4], l[4], alpha[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }
  const int n_tiles = (lk + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // q written / every warp done with the previous k / v tile
    load_tile<float, DP, L::kLdQ>(kb, k0, lk, d, ks);
    load_tile<float, DP, L::kLdV>(vb, k0, lk, d, vs);
    __syncthreads();
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int dd = 0; dd < DP; ++dd) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qw[i * L::kLdQ + dd];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = ks[(lx + 8 * j) * L::kLdQ + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] += qv[i] * kv[j];
    }
    bool keep[8];
    kept_keys(mrow, k0, lk, lx, keep);
    online_softmax(s, keep, scale, m, l, alpha);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) pw[(4 * ly + i) * L::kLdP + lx + 8 * j] = s[i][j];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha[i];
    }
    __syncwarp();
    const int n_keys = min(kBK, lk - k0);  // p = 0 past Lk
    for (int kk = 0; kk < n_keys; ++kk) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = pw[(4 * ly + i) * L::kLdP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[kk * L::kLdV + lx + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] += pv[i] * vv[c];
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + warp * 16 + 4 * ly + i;
    if (row >= lq) continue;
    const float inv = 1.0f / l[i];  // l = 0 (no kept key): 0 · ∞ = NaN
    float* orow = out + ((size_t)bh * lq + row) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (lx + 8 * c < d) orow[lx + 8 * c] = acc[i][c] * inv;
    if (lse != nullptr && lx == 0) lse[(size_t)bh * lq + row] = m[i] + logf(l[i]);
  }
}

template <typename T, typename K>
cudaError_t launch_kernel(K kernel, size_t smem, const void* q, const void* k, const void* v,
                          const void* mask, void* out, void* lse, int bh, int heads, int lq,
                          int lk, int d, float scale, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((lq + kBQ - 1) / kBQ) * bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), static_cast<float*>(lse), heads,
      lq, lk, d, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_d(int dtype, const void* q, const void* k, const void* v, const void* mask,
                     void* out, void* lse, int bh, int heads, int lq, int lk, int d, float scale,
                     cudaStream_t stream) {
  if (dtype == kBF16)
    return launch_mma<DP>(q, k, v, mask, out, lse, bh, heads, lq, lk, d, scale, stream);
  if (dtype == kF32)
    return launch_kernel<float>(flash_fma_kernel<DP>, FmaLayout<DP>::kBytes, q, k, v, mask, out,
                                lse, bh, heads, lq, lk, d, scale, stream);
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
