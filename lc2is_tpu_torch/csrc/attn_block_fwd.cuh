// The forward of the decoder attention block's bf16 body, shared by the
// forward (csrc/attention_block.cu, TPU row 2: lc2is_tpu/ops/attention_block.py
// ::_kernel :37) and the backward's recompute (csrc/attention_block_bwd.cu,
// row 3), so that the two run one code:
//
//   1. q = round(x · Wqᵀ + bq) on the tensor-core GEMM (gemm_bf16.cuh), bq
//      an f32 holding a bf16 value (the TPU kernel adds the bf16 bias in f32);
//   2. the attention core attn_fwd_mma at dh 16, 32 or 64, FlashAttention-2
//      style: 4 warps own 64 query rows, each its 16 rows as A fragments in
//      registers; 64-key tiles of K and V stream through a two-stage cp.async
//      ring straight from the strided (B, L, C) matrices (row stride C, head
//      offset h · dh); the online softmax in log2 units (1/√dh is folded into
//      Wq and bq); p rounded to bf16 per key tile into P · V's A fragment; O
//      scaled by 1 / l and rounded at the end; one barrier a tile;
//   3. s = att · Woᵀ + bo + x in f32 on the same GEMM (bf16 x addend).
//
// The TPU kernel normalises p before rounding it; the flash order here
// rounds the unnormalised p: the two differ by bf16 rounding
// (tests/test_torch_block_tiles.py holds both against the Pallas kernel).
// What bounds it: the products, 4·P·C² + 4·P·L·C operations an image.
#pragma once

#include <math.h>

#include "attn_tiles.cuh"
#include "gemm_bf16.cuh"

namespace lc2 {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kAttnRows = 64;  // query or key rows a block owns: 4 warps x 16
constexpr int kAttnThreads = 128;
constexpr int kAttnCols = 64;  // rows of a streamed tile
constexpr int kAttnStages = 2;

// Shared memory of the three attention kernels: NOWN own tiles of 64 rows,
// then the ring's stages of two streamed 64-row tiles (bf16 at stride DH + 8)
// and, with kStats, the lse and delta of the streamed rows; then 4 · DH
// floats (the dq kernel's column sums).
template <int DH, int NOWN, bool kStats>
struct AttnLayout {
  static constexpr int kLd = mma::row_stride<DH>();
  static constexpr int kTile = kAttnRows * kLd;
  static constexpr size_t kStage =
      sizeof(bf16) * 2 * kTile + (kStats ? 2 * sizeof(float) * kAttnCols : 0);
  static constexpr size_t kOwnBytes = sizeof(bf16) * NOWN * kTile;
  static constexpr size_t kRed = kOwnBytes + kAttnStages * kStage;
  static constexpr size_t kBytes = kRed + sizeof(float) * 4 * DH;
  __device__ static bf16* a(unsigned char* smem, int s) {
    return reinterpret_cast<bf16*>(smem + kOwnBytes + s * kStage);
  }
  __device__ static float* stats(unsigned char* smem, int s) {
    return reinterpret_cast<float*>(a(smem, s) + 2 * kTile);
  }
};

// Rows [r0, r0 + 64) of head h of a (B, n, C) bf16 matrix, image b.
template <int DH>
__device__ __forceinline__ void load_head_rows(const bf16* base, int b, int n, int C, int h,
                                               int r0, bf16* dst) {
  mma::load_rows_ld<DH, kAttnRows, kAttnThreads>(base + (size_t)b * n * C + h * DH, r0, n, C,
                                                 dst);
}

// O = softmax(q · kᵀ) · v rounded to bf16 into att and, when lse is not
// null, the row log-sum-exp; grid (P tiles, heads, B).  p is rounded per tile
// into P · V's A fragment and O scaled by 1 / l at the end (mma::fwd_tile).
// att may be q: a block overwrites only the rows and head columns it read,
// after they are in shared memory.
template <int DH>
__global__ void __launch_bounds__(kAttnThreads, 3)
attn_fwd_mma(const bf16* q, const bf16* __restrict__ k, const bf16* __restrict__ v, bf16* att,
             float* __restrict__ lse, int P, int L, int C) {
  using Lay = AttnLayout<DH, 1, false>;
  constexpr int KC = DH / 16, NO = DH / 8, LD = Lay::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y, p0 = blockIdx.x * kAttnRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (L + kAttnCols - 1) / kAttnCols;
  auto issue = [&](int t) {  // k_t and v_t into stage t % 2, one group
    if (t < n_tiles) {
      bf16* ks = Lay::a(smem_raw, t % kAttnStages);
      load_head_rows<DH>(k, b, L, C, h, t * kAttnCols, ks);
      load_head_rows<DH>(v, b, L, C, h, t * kAttnCols, ks + Lay::kTile);
    }
    mma::cp_async_commit();
  };
  load_head_rows<DH>(q, b, P, C, h, p0, qs);
  mma::cp_async_commit();
  issue(0);
  mma::cp_async_wait<1>();
  __syncthreads();

  const bool live = p0 + warp * 16 < P;
  bf16* qw = qs + warp * 16 * LD;  // the warp's q rows, later its output staging
  uint32_t qa[KC][4];
  mma::own_fragments<DH>(qw, lane, qa);
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  for (int t = 0; t < n_tiles; ++t) {
    mma::cp_async_wait<0>();
    __syncthreads();
    issue(t + 1);
    const bf16* ks = Lay::a(smem_raw, t % kAttnStages);
    const mma::KeyBits kept = mma::key_bits(nullptr, t * kAttnCols, L, lane);
    if (!live) continue;
    if (kept.all())  // 1/√dh is folded into q: the scale is 1
      mma::fwd_tile<DH, true>(qa, ks, ks + Lay::kTile, kept, mma::kLog2e, lane, o, m, l);
    else
      mma::fwd_tile<DH, false>(qa, ks, ks + Lay::kTile, kept, mma::kLog2e, lane, o, m, l);
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  mma::stage_rows<DH, NO>(o, 1.0f / l[0], 1.0f / l[1], qw, lane);
  mma::store_rows_ld<DH>(qw, att + (size_t)b * P * C + h * DH, p0 + warp * 16, P, C, lane);
  if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = p0 + warp * 16 + (lane >> 2) + 8 * r;
      if (row < P) lse[((size_t)b * heads + h) * P + row] = m[r] * mma::kLn2 + logf(l[r]);
    }
  }
}


template <int DH>
cudaError_t attn_fwd_launch(const bf16* q, const bf16* k, const bf16* v, bf16* att, float* lse,
                            int B, int P, int L, int C, int heads, cudaStream_t s) {
  constexpr size_t smem = AttnLayout<DH, 1, false>::kBytes;
  LC2_TRY(allow_smem(attn_fwd_mma<DH>, smem));
  attn_fwd_mma<DH><<<dim3((P + kAttnRows - 1) / kAttnRows, heads, B), kAttnThreads, smem, s>>>(
      q, k, v, att, lse, P, L, C);
  return cudaGetLastError();
}

// Steps 1-3 above on (B, P, C) queries x and (B, L, C) keys and values k, v:
// q (B·P, C) and att (may be q) bf16, lse (B, heads, P) f32 or null, s
// (B·P, C) f32.  C / heads in {16, 32, 64}, C a multiple of 8.
cudaError_t attn_block_fwd_bf16(const bf16* x, const bf16* k, const bf16* v, const bf16* wq,
                                const float* bq, const bf16* wo, const float* bo, bf16* q,
                                bf16* att, float* lse, float* s, int B, int P, int L, int C,
                                int heads, cudaStream_t st) {
  using gemm16::Epilogue;
  const int bp = B * P;
  LC2_TRY((gemm16::gemm<false, false>(bp, C, C, x, C, wq, C,
                                      Epilogue{bq, nullptr, nullptr, nullptr, q, C, false}, st)));
  switch (C / heads) {
    case 16: LC2_TRY(attn_fwd_launch<16>(q, k, v, att, lse, B, P, L, C, heads, st)); break;
    case 32: LC2_TRY(attn_fwd_launch<32>(q, k, v, att, lse, B, P, L, C, heads, st)); break;
    case 64: LC2_TRY(attn_fwd_launch<64>(q, k, v, att, lse, B, P, L, C, heads, st)); break;
    default: return cudaErrorInvalidValue;
  }
  return gemm16::gemm<false, false>(bp, C, C, att, C, wo, C,
                                    Epilogue{bo, nullptr, x, s, nullptr, C, false}, st);
}

}  // namespace
}  // namespace lc2
