// The served mask head: per output pixel, the argmax over K classes of a
// torch-bilinear ×r upsample of a class-score map, without ever writing the
// (B, K, r·h, r·w) upsampled map.  Two entry points:
//
//   lc2_score_upsample_argmax: the scores are computed in the kernel, from
//     the decoder tokens v (B, h·w, C), L2-normalised per token in T, and the
//     normalised class embeddings t (B, K, C): s = round_T(v̂ · t), summed in
//     f32.  Replaces lc2is_tpu/ops/upsample_argmax.py::_score_kernel (:117,
//     entry score_upsample_argmax :197).
//   lc2_upsample_argmax: the scores are read from a (B, K, h, w) map in T.
//     Replaces lc2is_tpu/ops/upsample_argmax.py::_kernel (:33, entry
//     upsample_argmax :72).
//
// The upsample is the TPU kernels' arithmetic, bit for bit: H blend first,
// then W blend, each w_other·other + w_cur·cur in f32 with the phase weights
// of lc2is_tpu/ops/upsample.py:30-39 (explicit _rn intrinsics, so no fused
// multiply-add changes a rounding); edge rows and columns clamp; ties go to
// the lowest class.  K needs no padding for the argmax (the TPU's k_pad and
// NEG rows are layout scaffolding).
//
// What bounds it on the card: at the served shape (16, 128², 512) tokens,
// 151 classes, the bytes (268 MB of tokens read once, 16.8 MB of masks
// written): 0.086 ms at 3.35 TB/s, against 0.041 ms for the 40.5 GFLOP
// score product at the bf16 tensor-core rate; the f32 blends and compares
// of the argmax (0.63 G (pixel, class) pairs) come close to both.
//
// Two bodies.
//
// bf16 tokens (the served row), head_kernel: a block of 17 warps owns a
// 16 x 16 tile of low-res pixels (64 x 64 output pixels at r 4) and needs
// the scores of the tile and a one-pixel halo, 18 x 18 = 324 tokens (1.27x
// the tile's own), which it keeps in shared memory as bf16 [classes][324].
//   1. scores, on the tensor cores: the halo tokens in chunks of 64 rows,
//      each row read from device memory once (cp.async into shared memory),
//      its f32 norm taken and the row divided by max(‖v‖, eps) rounded to
//      bf16 (a multiply by its reciprocal, equal for bf16 operands), in
//      place, by one warp; then 16 warps (4 m-tiles x 4 groups of 5
//      n-tiles) run the chunk against up to 160 class embeddings with
//      mma.sync m16n8k16 (f32 accumulation), the embeddings streamed in
//      32-channel slices through a 3-stage cp.async ring; each score is
//      rounded to bf16 after its f32 sum.  The map entry copies the halo's
//      scores instead (in the map's type).
//   2. argmax: a thread owns the output pixels of one row that share a tap
//      column pair (r of them, up to 16 a unit), so each class's four taps
//      and two H blends serve all of them.
//   K > 160 takes passes of 160 classes; between passes each pixel's best
//   value and class wait in a workspace and the output.
//
// f32 tokens (the control), and bf16 tokens wider than the tensor-core
// body's shared memory takes (C > 672), tile_kernel (the first body): one block
// per 8 x 16 tile of low-res pixels with its 10 x 18 halo, scores as f32
// [K][180] in shared memory, the product on the CUDA cores in f32 (a 192 x
// 160 tile over 32-channel chunks, 12 tokens x 10 classes a thread), then a
// thread per output pixel walks the K classes.
#include "common.cuh"
#include "mma_bf16.cuh"

namespace lc2 {
namespace {

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

struct Phase {
  int prev;   // blend with the previous (1) or the next (0) row / column
  float wo, wc;
};

// lc2is_tpu/ops/upsample.py::_phase_weights, in double then rounded, as
// Python's float weights meet an f32 array
__device__ __forceinline__ Phase phase(int m, int r) {
  const double off = (m + 0.5) / r - 0.5;
  Phase p;
  p.prev = off < 0.0;
  p.wo = static_cast<float>(p.prev ? -off : off);
  p.wc = static_cast<float>(p.prev ? 1.0 + off : 1.0 - off);
  return p;
}

__device__ __forceinline__ float blend(float wo, float other, float wc, float cur) {
  return __fadd_rn(__fmul_rn(wo, other), __fmul_rn(wc, cur));
}

// ---------------------------------------------------------------------------
// tile_kernel: the f32 body (the first one), kept as the control
// ---------------------------------------------------------------------------
namespace tile {

constexpr int kTH = 8, kTW = 16;       // low-res pixels of a tile
constexpr int kHW = kTW + 2;           // halo columns
constexpr int kNT = (kTH + 2) * kHW;   // halo tokens (180)
constexpr int kThreads = 256;
constexpr int kNI = 12;                // tokens per thread: 16 x 12 = 192 >= kNT
constexpr int kNJ = 10;                // classes per thread and pass: 16 x 10 = 160
constexpr int kKC = 16 * kNJ;
constexpr int kCT = 32;                // channel chunk of the product
constexpr int kLdv = 16 * kNI + 1;     // staged tokens [kCT][kLdv]
constexpr int kLdt = kKC + 1;          // staged classes [kCT][kLdt]

// pixel (y·W + x) of halo token n of the tile at (i0, j0), clamped to the image
__device__ __forceinline__ int halo_pixel(int n, int i0, int j0, int H, int W) {
  const int hr = n / kHW, hc = n - hr * kHW;
  const int y = min(max(i0 - 1 + hr, 0), H - 1), x = min(max(j0 - 1 + hc, 0), W - 1);
  return y * W + x;
}

template <typename T>
__device__ void tile_scores(const T* __restrict__ v, const T* __restrict__ tn, float* S,
                            int b, int i0, int j0, int H, int W, int C, int K, float eps) {
  float* vt = S + (size_t)K * kNT;  // [kCT][kLdv]
  float* tt = vt + kCT * kLdv;      // [kCT][kLdt]
  float* dn = tt + kCT * kLdt;      // [kNT] per-token divisor max(‖v‖, eps), rounded to T
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const T* vb = v + (size_t)b * H * W * C;
  const T* tb = tn + (size_t)b * K * C;

  for (int n = warp; n < kNT; n += kThreads / 32) {
    const T* row = vb + (size_t)halo_pixel(n, i0, j0, H, W) * C;
    float ss = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float x = to_f(row[c]);
      ss += x * x;
    }
    ss = warp_sum(ss);
    if (lane == 0) dn[n] = round_t<T>(fmaxf(sqrtf(ss), eps));
  }

  for (int kc0 = 0; kc0 < K; kc0 += kKC) {
    float acc[kNI][kNJ];
#pragma unroll
    for (int i = 0; i < kNI; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.0f;
    for (int c0 = 0; c0 < C; c0 += kCT) {
      __syncthreads();  // dn written / previous chunk consumed
      for (int idx = tid; idx < 16 * kNI * kCT; idx += kThreads) {
        const int n = idx / kCT, kk = idx - n * kCT, c = c0 + kk;
        float x = 0.0f;
        if (n < kNT && c < C)
          x = round_t<T>(to_f(vb[(size_t)halo_pixel(n, i0, j0, H, W) * C + c]) / dn[n]);
        vt[kk * kLdv + n] = x;
      }
      for (int idx = tid; idx < kKC * kCT; idx += kThreads) {
        const int k = idx / kCT, kk = idx - k * kCT, c = c0 + kk;
        tt[kk * kLdt + k] = (kc0 + k < K && c < C) ? to_f(tb[(size_t)(kc0 + k) * C + c]) : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kCT; ++kk) {
        float a[kNI], w[kNJ];
#pragma unroll
        for (int i = 0; i < kNI; ++i) a[i] = vt[kk * kLdv + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kNJ; ++j) w[j] = tt[kk * kLdt + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kNI; ++i)
#pragma unroll
          for (int j = 0; j < kNJ; ++j) acc[i][j] += a[i] * w[j];
      }
    }
#pragma unroll
    for (int i = 0; i < kNI; ++i) {
      const int n = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int k = kc0 + tx + 16 * j;
        if (n < kNT && k < K) S[(size_t)k * kNT + n] = round_t<T>(acc[i][j]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const T* __restrict__ src, const T* __restrict__ tn, int* __restrict__ out,
            int H, int W, int C, int K, int r, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* S = reinterpret_cast<float*>(smem_raw);  // [K][kNT] scores of the tile and its halo
  const int tid = threadIdx.x;
  const int b = blockIdx.z, i0 = blockIdx.y * kTH, j0 = blockIdx.x * kTW;

  tile_scores<T>(src, tn, S, b, i0, j0, H, W, C, K, eps);
  __syncthreads();

  const int tw = r * kTW, th = r * kTH;
  for (int idx = tid; idx < th * tw; idx += kThreads) {
    const int oyl = idx / tw, oxl = idx - oyl * tw;
    const int oy = r * i0 + oyl, ox = r * j0 + oxl;
    if (oy >= r * H || ox >= r * W) continue;
    const int li = oyl / r, lj = oxl / r;
    const Phase ph = phase(oyl - li * r, r), pw = phase(oxl - lj * r, r);
    const int rc = (li + 1) * kHW, ro = (ph.prev ? li : li + 2) * kHW;  // halo rows
    const int cc = lj + 1, co = pw.prev ? lj : lj + 2;                  // halo columns
    float best = 0.0f;
    int arg = 0;
    for (int k = 0; k < K; ++k) {
      const float* s = S + (size_t)k * kNT;
      const float hcur = blend(ph.wo, s[ro + cc], ph.wc, s[rc + cc]);
      const float hoth = blend(ph.wo, s[ro + co], ph.wc, s[rc + co]);
      const float val = blend(pw.wo, hoth, pw.wc, hcur);
      if (k == 0 || val > best) {  // strict: a tie keeps the lower class
        best = val;
        arg = k;
      }
    }
    out[((size_t)b * r * H + oy) * (size_t)(r * W) + ox] = arg;
  }
}

template <typename T>
cudaError_t launch(const void* v, const void* tn, void* out, int B, int H, int W, int C, int K,
                   int r, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)K * kNT + kCT * kLdv + kCT * kLdt + kNT);
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = tile_kernel<T>;
  LC2_TRY(allow_smem(kernel, smem));
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(v), static_cast<const T*>(tn),
                                           static_cast<int*>(out), H, W, C, K, r, eps);
  return cudaGetLastError();
}

}  // namespace tile

// ---------------------------------------------------------------------------
// head_kernel: the bf16 body on the tensor cores, and the map entry
// ---------------------------------------------------------------------------
namespace head {

constexpr int kT = 16;                // low-res pixels a tile side
constexpr int kH = kT + 2;            // halo side
constexpr int kN = kH * kH;           // halo tokens (324)
constexpr int kNS = 328;              // score row stride (halo tokens, 16-byte multiple in bf16)
constexpr int kKP = 160;              // classes a pass: 4 groups of 5 n-tiles of 8
constexpr int kMC = 64;               // tokens a product chunk: 4 m-tiles of 16
constexpr int kChunks = (kN + kMC - 1) / kMC;
constexpr int kBK = 32;               // channels a class-embedding slice
constexpr int kLdb = kBK + 8;         // its row stride: 80 bytes, 5 (odd) 16-byte units
constexpr int kStages = 3;
constexpr int kMmaWarps = 16;         // 4 m-tiles x 4 groups of 40 classes
constexpr int kWarps = 17;            // + 1: 17 · 64 = 1088 argmax units at r 4, 2 a thread
constexpr int kThreads = 32 * kWarps;
constexpr size_t kSmemMax = 232448;

__host__ __device__ constexpr int padded_c(int C) { return (C + kBK - 1) / kBK * kBK; }

// shared memory of a block: the scores, and for the product the token
// chunk, the class-embedding ring
__host__ __device__ constexpr size_t smem_bytes(bool gemm, int esize, int C) {
  return (size_t)kKP * kNS * esize +
         (gemm ? (size_t)kMC * (padded_c(C) + 8) * 2 + (size_t)kStages * kKP * kLdb * 2 : 0);
}

// pixel (y·W + x) of halo token n of the tile at (i0, j0), clamped to the image
__device__ __forceinline__ int halo_px(int n, int i0, int j0, int H, int W) {
  const int hr = n / kH, hc = n - hr * kH;
  const int y = imin(imax(i0 - 1 + hr, 0), H - 1), x = imin(imax(j0 - 1 + hc, 0), W - 1);
  return y * W + x;
}

// Scores of the tile's halo tokens against classes k0 .. k0 + nk − 1 into
// S [kk][n] (bf16, rounded after the f32 sum).  work: the token chunk A
// [kMC][CP + 8] and the class-embedding ring [kStages][kKP][kLdb].
__device__ void scores_mma(const bf16* __restrict__ v, const bf16* __restrict__ tn, bf16* S,
                           unsigned char* work, int b, int i0, int j0, int H, int W, int C,
                           int K, int k0, int nk, float eps) {
  const int CP = padded_c(C), lda = CP + 8, nsl = CP / kBK;
  bf16* A = reinterpret_cast<bf16*>(work);
  bf16* ring = A + kMC * lda;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* vb = v + (size_t)b * H * W * C;
  const bf16* tb = tn + ((size_t)b * K + k0) * C;
  const bool vec = C % 8 == 0;  // 16-byte rows (the wrapper aligns the bases)
  const int total = kChunks * nsl;

  // slice t (a running count over the chunks) of the embeddings: classes
  // k0 .. k0 + kKP − 1, channels (t mod nsl) · 32 .. + 31, zeros past nk and C
  auto issue = [&](int t) {
    if (t < total) {
      bf16* st = ring + (t % kStages) * (kKP * kLdb);
      const int c0 = (t % nsl) * kBK;
      if (vec) {
        for (int idx = tid; idx < kKP * (kBK / 8); idx += kThreads) {
          const int kk = idx >> 2, c = (idx & 3) * 8;
          const bool full = kk < nk && c0 + c < C;
          mma::cp_async16(st + kk * kLdb + c, full ? tb + (size_t)kk * C + c0 + c : tb, full);
        }
      } else {  // element copies, published by the barrier before their slice is read
        for (int idx = tid; idx < kKP * kBK; idx += kThreads) {
          const int kk = idx / kBK, c = idx - kk * kBK;
          st[kk * kLdb + c] =
              kk < nk && c0 + c < C ? tb[(size_t)kk * C + c0 + c] : __float2bfloat16(0.0f);
        }
      }
    }
    mma::cp_async_commit();
  };
  issue(0);
  issue(1);

  const int lr = lane & 7, l3 = (lane >> 3) & 1, l4 = lane >> 4;
  const int mt = warp & 3, ng = warp >> 2;  // product warps: m-tile, group of 5 n-tiles
  for (int ch = 0; ch < kChunks; ++ch) {
    const int n0 = ch * kMC;
    __syncthreads();  // every warp is done with the previous chunk's A
    if (vec) {
      const int per = CP / 8;
      for (int idx = tid; idx < kMC * per; idx += kThreads) {
        const int m = idx / per, c = (idx - m * per) * 8, n = n0 + m;
        const bool full = n < kN && c < C;
        mma::cp_async16(A + m * lda + c,
                        full ? vb + (size_t)halo_px(n, i0, j0, H, W) * C + c : vb, full);
      }
    } else {
      for (int idx = tid; idx < kMC * CP; idx += kThreads) {
        const int m = idx / CP, c = idx - m * CP, n = n0 + m;
        A[m * lda + c] = n < kN && c < C ? vb[(size_t)halo_px(n, i0, j0, H, W) * C + c]
                                         : __float2bfloat16(0.0f);
      }
    }
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
    // a warp a row: the f32 norm (each lane over 8 channels of every 256,
    // in order, then the xor tree), the divisor max(‖v‖, eps) rounded to
    // bf16, each element divided and rounded to bf16, in place.  The
    // division is a multiply by the correctly rounded reciprocal: for a bf16
    // dividend and divisor the quotient is never within 2^-17 (relative) of
    // a bf16 rounding midpoint, so both round to the same bf16.
    for (int m = warp; m < kMC; m += kWarps) {
      bf16* row = A + m * lda;
      float ss = 0.0f;
      if (vec) {
        for (int c = 8 * lane; c < C; c += 256) {
          const uint4 q = *reinterpret_cast<const uint4*>(row + c);
          const bf16* e = reinterpret_cast<const bf16*>(&q);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float x = __bfloat162float(e[i]);
            ss = __fmaf_rn(x, x, ss);
          }
        }
      } else {
        for (int c = lane; c < C; c += 32) {
          const float x = __bfloat162float(row[c]);
          ss = __fmaf_rn(x, x, ss);
        }
      }
      ss = warp_sum(ss);
      const float inv = __frcp_rn(round_t<bf16>(fmaxf(sqrtf(ss), eps)));
      if (vec) {
        for (int c = 8 * lane; c < C; c += 256) {
          uint4 q = *reinterpret_cast<const uint4*>(row + c);
          bf16* e = reinterpret_cast<bf16*>(&q);
#pragma unroll
          for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(__bfloat162float(e[i]) * inv);
          *reinterpret_cast<uint4*>(row + c) = q;
        }
      } else {
        for (int c = lane; c < C; c += 32) row[c] = __float2bfloat16(__bfloat162float(row[c]) * inv);
      }
    }
    float acc[5][4];
#pragma unroll
    for (int j = 0; j < 5; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    for (int s = 0; s < nsl; ++s) {
      const int t = ch * nsl + s;
      mma::cp_async_wait<1>();  // slice t has landed (this thread's copies)
      __syncthreads();          // ... every thread's; the normalised rows are visible
      issue(t + 2);             // into slice t − 1's stage
      if (warp < kMmaWarps) {
        const bf16* bs = ring + (t % kStages) * (kKP * kLdb) + ng * 40 * kLdb;
        const bf16* as = A + mt * 16 * lda + s * kBK;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          uint32_t af[4], bq[2][4], b4[2];
          mma::ldsm_x4(af, as + (lr + 8 * l3) * lda + kk + 8 * l4);
          mma::ldsm_x4(bq[0], bs + (lr + 8 * l4) * kLdb + kk + 8 * l3);
          mma::ldsm_x4(bq[1], bs + (16 + lr + 8 * l4) * kLdb + kk + 8 * l3);
          mma::ldsm_x2(b4, bs + (32 + lr) * kLdb + kk + 8 * l3);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma::mma_bf16(acc[j], af, bq[j >> 1][2 * (j & 1)], bq[j >> 1][2 * (j & 1) + 1]);
          mma::mma_bf16(acc[4], af, b4[0], b4[1]);
        }
      }
    }
    if (warp < kMmaWarps) {  // rows g, g + 8 of the m-tile, classes c, c + 1 of each n-tile
      const int g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const int kk = ng * 40 + 8 * j + c;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int n = n0 + mt * 16 + g + 8 * hh;
          if (n >= kN) continue;
          if (kk < nk) S[kk * kNS + n] = __float2bfloat16(acc[j][2 * hh]);
          if (kk + 1 < nk) S[(kk + 1) * kNS + n] = __float2bfloat16(acc[j][2 * hh + 1]);
        }
      }
    }
  }
  mma::cp_async_wait<0>();
}

// The halo's scores of classes k0 .. k0 + nk − 1 from a (B, K, H, W) map.
template <typename ST>
__device__ void scores_map(const ST* __restrict__ map, ST* S, int b, int i0, int j0, int H, int W,
                           int K, int k0, int nk) {
  const ST* mb = map + ((size_t)b * K + k0) * H * W;
  for (int idx = threadIdx.x; idx < nk * kN; idx += kThreads) {
    const int kk = idx / kN, n = idx - kk * kN;
    S[kk * kNS + n] = mb[(size_t)kk * H * W + halo_px(n, i0, j0, H, W)];
  }
}

// The argmax over classes k0 .. k0 + nk − 1 of the tile's output pixels.  A
// unit is up to GP pixels of one output row that read halo columns g and g +
// 1: the pixels of cell g that blend with the previous column and those of
// cell g − 1 that blend with the next (r of them; r/2 at the tile's edges).
// first: class k0 = 0 seeds each pixel; otherwise the best value and class
// so far come from best_ws and out; last: only out is written.
template <typename ST, int GP>
__device__ void argmax_tile(const ST* S, int* __restrict__ out, float* __restrict__ best_ws,
                            int b, int i0, int j0, int H, int W, int r, int k0, int nk,
                            bool first, bool last) {
  const int subs = (r + GP - 1) / GP, per_row = (kT + 1) * subs, units = kT * r * per_row;
  const int rh = r * H, rw = r * W;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int oyl = u / per_row, rem = u - oyl * per_row;
    const int g = rem / subs, sub = rem - g * subs;
    const int oy = r * i0 + oyl;
    const int px0 = imax((g - 1) * r + r / 2, 0) + sub * GP;
    const int np = imin(GP, imin(g * r + r / 2, kT * r) - px0);
    if (np <= 0 || oy >= rh) continue;
    const int li = oyl / r;
    const Phase ph = phase(oyl - li * r, r);
    const int rc = (li + 1) * kH + g, ro = (ph.prev ? li : li + 2) * kH + g;
    // val = w_other · h(other) + w_cur · h(cur) = w0 · h(g) + w1 · h(g + 1)
    // (the sum of the two products is the same in either order)
    float w0[GP], w1[GP], best[GP];
    int arg[GP];
    const size_t orow = ((size_t)b * rh + oy) * rw + (size_t)r * j0 + px0;
#pragma unroll
    for (int q = 0; q < GP; ++q) {
      const int oxl = px0 + imin(q, np - 1), lj = oxl / r;
      const Phase pw = phase(oxl - lj * r, r);
      w0[q] = pw.prev ? pw.wo : pw.wc;  // a pixel of cell g: column g is its previous
      w1[q] = pw.prev ? pw.wc : pw.wo;
      const bool in = q < np && r * j0 + px0 + q < rw;
      best[q] = !first && in ? best_ws[orow + q] : 0.0f;
      arg[q] = !first && in ? out[orow + q] : 0;
    }
    for (int kk = 0; kk < nk; ++kk) {
      const ST* s = S + kk * kNS;
      const float h0 = blend(ph.wo, to_f<ST>(s[ro]), ph.wc, to_f<ST>(s[rc]));
      const float h1 = blend(ph.wo, to_f<ST>(s[ro + 1]), ph.wc, to_f<ST>(s[rc + 1]));
      const bool seed = first && kk == 0;
#pragma unroll
      for (int q = 0; q < GP; ++q) {
        const float val = __fadd_rn(__fmul_rn(w0[q], h0), __fmul_rn(w1[q], h1));
        if (seed || val > best[q]) {  // strict: a tie keeps the lower class
          best[q] = val;
          arg[q] = k0 + kk;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < GP; ++q) {
      if (q < np && r * j0 + px0 + q < rw) {
        out[orow + q] = arg[q];
        if (!last) best_ws[orow + q] = best[q];
      }
    }
  }
}

template <typename ST, int GP, bool kGemm>
__global__ void __launch_bounds__(kThreads, 1)
head_kernel(const void* __restrict__ src, const bf16* __restrict__ tn, int* __restrict__ out,
            float* __restrict__ best_ws, int H, int W, int C, int K, int r, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ST* S = reinterpret_cast<ST*>(smem_raw);  // [kKP][kNS] scores of the halo tokens
  const int b = blockIdx.z, i0 = blockIdx.y * kT, j0 = blockIdx.x * kT;
  const int npass = (K + kKP - 1) / kKP;
  for (int pass = 0; pass < npass; ++pass) {
    const int k0 = pass * kKP, nk = imin(kKP, K - k0);
    __syncthreads();  // the previous pass's argmax is done with S
    if constexpr (kGemm)
      scores_mma(static_cast<const bf16*>(src), tn, S, smem_raw + sizeof(ST) * kKP * kNS, b, i0,
                 j0, H, W, C, K, k0, nk, eps);
    else
      scores_map<ST>(static_cast<const ST*>(src), S, b, i0, j0, H, W, K, k0, nk);
    __syncthreads();
    argmax_tile<ST, GP>(S, out, best_ws, b, i0, j0, H, W, r, k0, nk, pass == 0,
                        pass == npass - 1);
  }
}

template <typename ST, bool kGemm, int GP>
cudaError_t launch_gp(const void* src, const bf16* tn, int* out, float* ws, int B, int H, int W,
                      int C, int K, int r, float eps, cudaStream_t stream) {
  const size_t smem = smem_bytes(kGemm, sizeof(ST), C);
  auto kernel = head_kernel<ST, GP, kGemm>;
  LC2_TRY(allow_smem(kernel, smem));
  const dim3 grid((W + kT - 1) / kT, (H + kT - 1) / kT, B);
  kernel<<<grid, kThreads, smem, stream>>>(src, tn, out, ws, H, W, C, K, r, eps);
  return cudaGetLastError();
}

template <typename ST, bool kGemm>
cudaError_t launch(const void* src, const void* tn, void* out, void* ws, int B, int H, int W,
                   int C, int K, int r, float eps, cudaStream_t stream) {
  if (K > kKP && ws == nullptr) return cudaErrorInvalidValue;  // passes need the workspace
  const bf16* t = static_cast<const bf16*>(tn);
  int* o = static_cast<int*>(out);
  float* w = static_cast<float*>(ws);
  if (r <= 4) return launch_gp<ST, kGemm, 4>(src, t, o, w, B, H, W, C, K, r, eps, stream);
  if (r <= 8) return launch_gp<ST, kGemm, 8>(src, t, o, w, B, H, W, C, K, r, eps, stream);
  return launch_gp<ST, kGemm, 16>(src, t, o, w, B, H, W, C, K, r, eps, stream);
}

}  // namespace head

bool valid_shape(int B, int H, int W, int K, int r) {
  return B >= 1 && H >= 1 && W >= 1 && K >= 1 && K <= 256 && r >= 1;
}

}  // namespace
}  // namespace lc2

// Pixels (B, r·H, r·W) of f32 best values the head's class passes need
// between them (0: one pass, no workspace).
extern "C" long long lc2_upsample_argmax_workspace(int B, int H, int W, int K, int r) {
  return K > lc2::head::kKP ? (long long)B * r * H * r * W : 0;
}

// v (B, H·W, C) tokens, tn (B, K, C) normalised class embeddings, both of
// one dtype, contiguous (bf16: 16-byte aligned) -> out (B, r·H, r·W) int32;
// ws: lc2_upsample_argmax_workspace floats (bf16 body, K > 160), else null.
extern "C" int lc2_score_upsample_argmax(int dtype, const void* v, const void* tn, void* out,
                                         void* ws, int B, int H, int W, int C, int K, int r,
                                         float eps, void* stream) {
  if (C < 1 || !lc2::valid_shape(B, H, W, K, r)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lc2::kF32) return lc2::tile::launch<float>(v, tn, out, B, H, W, C, K, r, eps, s);
  if (dtype != lc2::kBF16) return cudaErrorInvalidValue;
  if (lc2::head::smem_bytes(true, 2, C) > lc2::head::kSmemMax)
    return lc2::tile::launch<__nv_bfloat16>(v, tn, out, B, H, W, C, K, r, eps, s);
  return lc2::head::launch<__nv_bfloat16, true>(v, tn, out, ws, B, H, W, C, K, r, eps, s);
}

// map (B, K, H, W) contiguous -> out (B, r·H, r·W) int32; ws as above.
extern "C" int lc2_upsample_argmax(int dtype, const void* map, void* out, void* ws, int B, int K,
                                   int H, int W, int r, void* stream) {
  if (!lc2::valid_shape(B, H, W, K, r)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lc2::kF32)
    return lc2::head::launch<float, false>(map, nullptr, out, ws, B, H, W, 0, K, r, 0.0f, s);
  if (dtype == lc2::kBF16)
    return lc2::head::launch<__nv_bfloat16, false>(map, nullptr, out, ws, B, H, W, 0, K, r, 0.0f,
                                                   s);
  return cudaErrorInvalidValue;
}
