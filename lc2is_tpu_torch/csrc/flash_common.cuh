// Tiles and loaders shared by the flash-attention forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu) kernels.
//
// An f32 block works on 64-row tiles of (rows, d) matrices with 4 warps of
// 32 lanes (the bf16 kernels' tiles and loaders are in mma_bf16.cuh).  The
// head dimension d is any value from 1 to 128: the kernels are
// instantiated per DP, d rounded up to a multiple of 16, and the loaders
// fill columns d .. DP - 1 (and rows past the sequence) with zeros, so a
// product over DP columns equals the product over d.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace lc2 {
namespace flash {

constexpr int kRows = 64;  // query or key rows per tile
constexpr int kThreads = 128;
constexpr int kMaxD = 128;

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Rows r0 .. r0 + 63 of a row-major (n, d) matrix into shared memory at row
// stride LD, DP columns, zeros past row n and past column d.  16-byte loads
// when a row is a whole number of 16-byte chunks (d a multiple of 16 /
// sizeof(T); the wrapper checks that the base is 16-byte aligned), element
// loads otherwise.
template <typename T, int DP, int LD>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int r0, int n, int d,
                                          T* __restrict__ dst) {
  constexpr int kVec = 16 / sizeof(T);
  if (d % kVec == 0) {
    constexpr int kPerRow = DP / kVec;
    for (int idx = threadIdx.x; idx < kRows * kPerRow; idx += kThreads) {
      const int r = idx / kPerRow, c = (idx - r * kPerRow) * kVec;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < n && c < d)
        val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * d + c));
      if constexpr ((LD * sizeof(T)) % 16 == 0) {
        *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
      } else {
        const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
        for (int i = 0; i < kVec; ++i) dst[r * LD + c + i] = e[i];
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < kRows * DP; idx += kThreads) {
      const int r = idx / DP, c = idx - r * DP;
      T val = from_f<T>(0.0f);
      if (r0 + r < n && c < d) val = src[(size_t)(r0 + r) * d + c];
      dst[r * LD + c] = val;
    }
  }
}

// Which of the lane's 8 keys k0 + lx + 8j of this tile count: inside Lk and
// not masked (mask row: nonzero = ignore).
__device__ __forceinline__ void kept_keys(const uint8_t* __restrict__ mrow, int k0, int lk,
                                          int lx, bool (&keep)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int key = k0 + lx + 8 * j;
    keep[j] = key < lk && !(mrow != nullptr && mrow[key] != 0);
  }
}

// The block's (b · h, ROWS-row tile) from a one-dimensional grid of
// n_tiles · B·H blocks (gridDim.x takes up to 2^31 - 1, gridDim.y 65535).
template <int ROWS = kRows>
__device__ __forceinline__ void block_tile(int n_tiles, int& bh, int& r0) {
  bh = blockIdx.x / n_tiles;
  r0 = (blockIdx.x - bh * n_tiles) * ROWS;
}

// (The bf16 kernels' 64- and 128-row tiles give as many blocks or fewer.)
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
