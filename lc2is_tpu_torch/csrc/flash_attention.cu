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
// One block owns one (b · h, 64-query tile), from a one-dimensional grid
// (so B·H is not capped at gridDim.y's 65535); each of its 4 warps owns 16 of
// the query rows, so the online softmax of a row never leaves its warp.  The
// block streams 64-key tiles of k and v through shared memory; per tile a
// warp computes its 16 x 64 scores, updates the running max m and sum l of
// its rows, rescales its accumulator and adds P · V.  At the end it writes
// o = acc · (1 / l) (a per-row reciprocal, as the TPU kernel does) and lse.
// Ragged Lq and Lk are masked here: nothing is padded in device memory.
// Head dims: any D from 1 to 128, instantiated per DP = D rounded up to a
// multiple of 16; the loaders zero columns D .. DP - 1 (flash_common.cuh), so
// q · k over DP columns is q · k over D, and only D output columns are
// written.  D > 128 is refused (the wrapper raises).
// - bf16: both products on the tensor cores through WMMA (16x16x16 bf16,
//   f32 accumulators); the q fragments stay in registers, the scores pass
//   through shared memory in f32, p is rounded to bf16 before P · V (as the
//   TPU kernel rounds p to v's dtype) while l sums the unrounded p, and the
//   f32 accumulator lives in shared memory, rescaled in place before each
//   P · V accumulates onto it.
// - f32: both products on the CUDA cores in full f32 (no TF32); a lane owns
//   4 query rows x 8 key columns of a score tile and 4 rows x D/8 columns of
//   the accumulator, held in registers.
// Masked keys take a bias of −∞ in effect.  A row with no kept key keeps
// m = −∞ and l = 0 (no exp(−∞ − (−∞))), so its output is 0 · (1/0) = NaN and
// its lse −∞, as torch's softmax gives; the TPU kernel's −1e30 bias would
// instead return the mean of v over the block-padded keys.
#include <math.h>
#include <mma.h>

#include "flash_common.cuh"

namespace lc2 {
namespace {

using flash::align128;
using flash::kept_keys;
using flash::load_tile;
constexpr int kBQ = flash::kRows;  // query rows per block: 4 warps x 16
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
// bf16: tensor cores (WMMA)
// ---------------------------------------------------------------------------

template <int DP>
struct TcLayout {
  static constexpr int kLdQ = DP + 8;   // bf16 q / k / v rows (WMMA: multiple of 8)
  static constexpr int kLdS = kBK + 4;  // f32 scores
  static constexpr int kLdP = kBK + 8;  // bf16 probabilities
  static constexpr int kLdO = DP + 4;   // f32 accumulator
  static constexpr size_t kOffK = align128(sizeof(bf16) * kBQ * kLdQ);
  static constexpr size_t kOffV = kOffK + align128(sizeof(bf16) * kBK * kLdQ);
  static constexpr size_t kOffS = kOffV + align128(sizeof(bf16) * kBK * kLdQ);
  static constexpr size_t kOffP = kOffS + align128(sizeof(float) * kBQ * kLdS);
  static constexpr size_t kOffO = kOffP + align128(sizeof(bf16) * kBQ * kLdP);
  static constexpr size_t kBytes = kOffO + sizeof(float) * kBQ * kLdO;
};

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                bf16* __restrict__ out, float* __restrict__ lse, int heads, int lq, int lk,
                int d, float scale) {
  using namespace nvcuda;
  using L = TcLayout<DP>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw + L::kOffK);
  bf16* vs = reinterpret_cast<bf16*>(smem_raw + L::kOffV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, ly = lane >> 3, lx = lane & 7;
  float* sw = reinterpret_cast<float*>(smem_raw + L::kOffS) + warp * 16 * L::kLdS;
  bf16* pw = reinterpret_cast<bf16*>(smem_raw + L::kOffP) + warp * 16 * L::kLdP;
  float* ow = reinterpret_cast<float*>(smem_raw + L::kOffO) + warp * 16 * L::kLdO;

  int bh, q0;
  flash::block_tile((lq + kBQ - 1) / kBQ, bh, q0);
  const bf16* kb = k + (size_t)bh * lk * d;
  const bf16* vb = v + (size_t)bh * lk * d;
  const uint8_t* mrow = mask != nullptr ? mask + (size_t)(bh / heads) * lk : nullptr;

  load_tile<bf16, DP, L::kLdQ>(q + (size_t)bh * lq * d, q0, lq, d, qs);
  for (int idx = lane; idx < 16 * L::kLdO; idx += 32) ow[idx] = 0.0f;
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[DP / 16];
#pragma unroll
  for (int dk = 0; dk < DP / 16; ++dk)
    wmma::load_matrix_sync(qa[dk], qs + warp * 16 * L::kLdQ + dk * 16, L::kLdQ);

  float m[4], l[4], alpha[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }
  const int n_tiles = (lk + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // every warp is done with the previous k / v tile
    load_tile<bf16, DP, L::kLdQ>(kb, k0, lk, d, ks);
    load_tile<bf16, DP, L::kLdQ>(vb, k0, lk, d, vs);
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < kBK / 16; ++nt) {  // S = Q · Kᵀ: B[d][n] = K[n][d]
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sa;
      wmma::fill_fragment(sa, 0.0f);
#pragma unroll
      for (int dk = 0; dk < DP / 16; ++dk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, ks + nt * 16 * L::kLdQ + dk * 16, L::kLdQ);
        wmma::mma_sync(sa, qa[dk], kf, sa);
      }
      wmma::store_matrix_sync(sw + nt * 16, sa, L::kLdS, wmma::mem_row_major);
    }
    __syncwarp();
    float s[4][8];
    bool keep[8];
    kept_keys(mrow, k0, lk, lx, keep);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = sw[(4 * ly + i) * L::kLdS + lx + 8 * j];
    online_softmax(s, keep, scale, m, l, alpha);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        pw[(4 * ly + i) * L::kLdP + lx + 8 * j] = __float2bfloat16(s[i][j]);
      for (int c = lx; c < DP; c += 8) ow[(4 * ly + i) * L::kLdO + c] *= alpha[i];
    }
    __syncwarp();
#pragma unroll
    for (int ct = 0; ct < DP / 16; ++ct) {  // acc += P · V
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oa;
      wmma::load_matrix_sync(oa, ow + ct * 16, L::kLdO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, pw + kk * 16, L::kLdP);
        wmma::load_matrix_sync(vf, vs + kk * 16 * L::kLdQ + ct * 16, L::kLdQ);
        wmma::mma_sync(oa, pf, vf, oa);
      }
      wmma::store_matrix_sync(ow + ct * 16, oa, L::kLdO, wmma::mem_row_major);
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + warp * 16 + 4 * ly + i;
    if (row >= lq) continue;
    const float inv = 1.0f / l[i];  // l = 0 (no kept key): 0 · ∞ = NaN
    bf16* orow = out + ((size_t)bh * lq + row) * d;
    for (int c = lx; c < d; c += 8)
      orow[c] = __float2bfloat16(ow[(4 * ly + i) * L::kLdO + c] * inv);
    if (lse != nullptr && lx == 0) lse[(size_t)bh * lq + row] = m[i] + logf(l[i]);
  }
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
    return launch_kernel<bf16>(flash_tc_kernel<DP>, TcLayout<DP>::kBytes, q, k, v, mask, out,
                               lse, bh, heads, lq, lk, d, scale, stream);
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
