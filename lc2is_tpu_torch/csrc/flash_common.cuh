// What the flash-attention forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu) kernels share: the instantiated head widths, the
// one-dimensional grid, and the f32 bodies' loaders (the bf16 kernels'
// tiles and loaders are in mma_bf16.cuh).
//
// The head dimension d is any value from 1 to 128: the kernels are
// instantiated per DP, d rounded up to a multiple of 16 (so of 8, the depth
// of the f32 bodies' m16n8k8 steps), and the loaders fill columns d .. DP - 1
// (and rows past the sequence) with zeros, so a product over DP columns
// equals the product over d.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace lc2 {
namespace flash {

constexpr int kRows = 64;  // the smallest query or key tile of a block
constexpr int kMaxD = 128;

// Rows r0 .. r0 + rows - 1 of a row-major (n, d) f32 matrix into a tile at
// row stride LD, DP columns, zeros past row n and past column d, by nthreads
// threads: cp.async when a row is a whole number of 16-byte chunks (d a
// multiple of 4; the wrapper checks that the base is 16-byte aligned; the
// caller commits and waits), otherwise element loads and stores, which the
// caller's barrier publishes.
template <int DP, int LD>
__device__ __forceinline__ void load_rows_f32(const float* __restrict__ src, int r0, int rows,
                                              int n, int d, float* dst, int nthreads) {
  if (d % 4 == 0) {
    constexpr int kChunks = DP / 4;
    for (int idx = threadIdx.x; idx < rows * kChunks; idx += nthreads) {
      const int r = idx / kChunks, c = (idx - r * kChunks) * 4;
      const bool full = r0 + r < n && c < d;
      mma::cp_async16(dst + r * LD + c, full ? src + (size_t)(r0 + r) * d + c : src, full);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * DP; idx += nthreads) {
      const int r = idx / DP, c = idx - r * DP;
      dst[r * LD + c] = r0 + r < n && c < d ? src[(size_t)(r0 + r) * d + c] : 0.0f;
    }
  }
}

// Columns c and c + 1 (c even) of a row of d floats, zeros past d: one 8-byte
// load where d is even.
__device__ __forceinline__ float2 load_pair(const float* __restrict__ row, int c, int d) {
  if (d % 2 == 0) return c < d ? *reinterpret_cast<const float2*>(row + c) : make_float2(0.0f, 0.0f);
  return make_float2(c < d ? row[c] : 0.0f, c + 1 < d ? row[c + 1] : 0.0f);
}

// Columns c and c + 1 (c even) of a row of d floats, those below d.
__device__ __forceinline__ void store_pair(float* __restrict__ row, int c, int d, float a, float b) {
  if (d % 2 == 0) {
    if (c < d) *reinterpret_cast<float2*>(row + c) = make_float2(a, b);
  } else {
    if (c < d) row[c] = a;
    if (c + 1 < d) row[c + 1] = b;
  }
}

// The block's (b · h, ROWS-row tile) from a one-dimensional grid of
// n_tiles · B·H blocks (gridDim.x takes up to 2^31 - 1, gridDim.y 65535).
template <int ROWS>
__device__ __forceinline__ void block_tile(int n_tiles, int& bh, int& r0) {
  bh = blockIdx.x / n_tiles;
  r0 = (blockIdx.x - bh * n_tiles) * ROWS;
}

// (Every kernel's tiles hold 64 rows or more: as many blocks or fewer.)
inline bool grid_fits(int bh, int n) {
  return (long long)bh * ((n + kRows - 1) / kRows) <= 2147483647LL;
}

// f(std::integral_constant<int, DP>{}) for DP = d rounded up to a multiple of
// 16 (1 <= d <= kMaxD): the one place the instantiated widths are listed.
template <typename F>
inline cudaError_t with_dp(int d, F&& f) {
  switch ((d + 15) / 16) {
    case 1: return f(std::integral_constant<int, 16>{});
    case 2: return f(std::integral_constant<int, 32>{});
    case 3: return f(std::integral_constant<int, 48>{});
    case 4: return f(std::integral_constant<int, 64>{});
    case 5: return f(std::integral_constant<int, 80>{});
    case 6: return f(std::integral_constant<int, 96>{});
    case 7: return f(std::integral_constant<int, 112>{});
    case 8: return f(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace flash
}  // namespace lc2
