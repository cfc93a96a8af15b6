// Warp-level bf16 tensor-core helpers of the flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu), in inline PTX for sm_90a:
// mma.sync m16n8k16 with f32 accumulators, ldmatrix (plain and .trans),
// cp.async with zero-fill, and the bf16 row tiles they read.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, c = 2 · (lane % 4)):
// - A (16 x 16, row-major), 4 registers of two bf16: (g, c..c+1),
//   (g + 8, c..c+1), (g, c+8..c+9), (g + 8, c+8..c+9);
// - B (16 x 8, k x n), 2 registers: (k c..c+1, n g), (k c+8..c+9, n g);
// - C (16 x 8, f32), 4 floats: (g, c), (g, c+1), (g + 8, c), (g + 8, c+1).
// So two neighbouring C tiles (n 0..7 and 8..15) are, rounded to bf16 and
// packed in pairs, the A fragment of a product over those 16 columns: a
// score tile feeds P · V without leaving the registers.
//
// Tiles in shared memory are row-major bf16 at a row stride of DP + 8
// elements (DP a multiple of 16): 2 · DP + 16 bytes, an odd number of
// 16-byte units, so the 8 rows one ldmatrix reads fall in 8 distinct
// 16-byte bank groups, and every row starts 16-byte aligned (cp.async).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace lc2 {
namespace mma {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DP>
__host__ __device__ constexpr int row_stride() { return DP + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// r[j] = this lane's two elements of 8x8 matrix j, whose row (lane % 8) lane
// 8j + lane % 8 addresses: (row lane / 4, columns 2 · (lane % 4) + 0, 1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// The same, transposed: (rows 2 · (lane % 4) + 0, 1, column lane / 4).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// c += a · b (16x16 bf16 times 16x8 bf16, f32 accumulate).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of a product over 16 columns from the two C tiles that
// hold them (columns 0..7 in lo, 8..15 in hi), rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// 2^x (MUFU.EX2; −∞ gives +0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared, asynchronously; zeros instead when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; zeros instead when !full.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows r0 .. r0 + ROWS - 1 of a row-major (n, d) bf16 matrix into a tile at
// row stride DP + 8, zeros past row n and past column d, by NT threads.
// When a row is a whole number of 16-byte chunks (d a multiple of 8; the
// wrapper checks that the base is 16-byte aligned) the copies are cp.async
// (the caller commits and waits); otherwise plain element loads and stores,
// which the caller's barrier publishes.
template <int DP, int ROWS, int NT>
__device__ __forceinline__ void load_rows(const __nv_bfloat16* __restrict__ src, int r0, int n,
                                          int d, __nv_bfloat16* dst) {
  constexpr int LD = row_stride<DP>();
  if (d % 8 == 0) {
    constexpr int kChunks = DP / 8;
#pragma unroll
    for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += NT) {
      const int r = idx / kChunks, c = (idx - r * kChunks) * 8;
      const bool full = r0 + r < n && c < d;
      cp_async16(dst + r * LD + c, full ? src + (size_t)(r0 + r) * d + c : src, full);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * DP; idx += NT) {
      const int r = idx / DP, c = idx - r * DP;
      dst[r * LD + c] = r0 + r < n && c < d ? src[(size_t)(r0 + r) * d + c]
                                            : __float2bfloat16(0.0f);
    }
  }
}

// Which of 64 consecutive keys k0 .. k0 + 63 count (inside n and, with a
// mask row, not masked: nonzero = ignore), as two warp-uniform words: bit i
// of b[e] is key k0 + 2i + e.  So the keys of 8-column group j are bits
// 4j .. 4j + 3 of b[0] | b[1], and a lane's columns 8j + c, 8j + c + 1 of a
// C tile are bit 4j + lane % 4 of b[0] and of b[1].  Warp-collective.
struct KeyBits {
  uint32_t b[2];
  __device__ __forceinline__ uint32_t any() const { return b[0] | b[1]; }
  __device__ __forceinline__ bool all() const { return (b[0] & b[1]) == 0xffffffffu; }
};

__device__ __forceinline__ KeyBits key_bits(const uint8_t* __restrict__ mrow, int k0, int n,
                                            int lane) {
  const int key = k0 + 2 * lane;
  const bool e0 = key < n && !(mrow != nullptr && mrow[key] != 0);
  const bool e1 = key + 1 < n && !(mrow != nullptr && mrow[key + 1] != 0);
  return KeyBits{{__ballot_sync(0xffffffffu, e0), __ballot_sync(0xffffffffu, e1)}};
}

// Rows of a warp's 16-row bf16 staging tile (stride DP + 8) to rows r0 ..
// r0 + 15 of the row-major (n, d) output, 16-byte stores where d allows.
template <int DP>
__device__ __forceinline__ void store_rows(const __nv_bfloat16* st, __nv_bfloat16* __restrict__ dst,
                                           int r0, int n, int d, int lane) {
  constexpr int LD = row_stride<DP>();
  __syncwarp();
  if (d % 8 == 0) {
    const int chunks = d / 8;
    for (int idx = lane; idx < 16 * chunks; idx += 32) {
      const int r = idx / chunks, c = (idx - r * chunks) * 8;
      if (r0 + r < n)
        *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * d + c) =
            *reinterpret_cast<const uint4*>(st + r * LD + c);
    }
  } else {
    for (int idx = lane; idx < 16 * d; idx += 32) {
      const int r = idx / d, c = idx - r * d;
      if (r0 + r < n) dst[(size_t)(r0 + r) * d + c] = st[r * LD + c];
    }
  }
}

// A C tile pair's rows g and g + 8 (times s, rounded to bf16) into a warp's
// staging tile: NO tiles of 8 columns.
template <int DP, int NO>
__device__ __forceinline__ void stage_rows(const float (&acc)[NO][4], float s0, float s1,
                                           __nv_bfloat16* st, int lane) {
  constexpr int LD = row_stride<DP>();
  const int g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    *reinterpret_cast<uint32_t*>(st + g * LD + 8 * j + c) =
        pack_bf16(acc[j][0] * s0, acc[j][1] * s0);
    *reinterpret_cast<uint32_t*>(st + (g + 8) * LD + 8 * j + c) =
        pack_bf16(acc[j][2] * s1, acc[j][3] * s1);
  }
}

}  // namespace mma
}  // namespace lc2
