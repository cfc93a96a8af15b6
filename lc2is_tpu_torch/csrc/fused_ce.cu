// fused_ce: softmax cross-entropy of the bilinear ×r upsample of a low-res
// score map, and its gradient with respect to the LOW-res map, in one pass
// that never materialises the (B, K, rH, rW) upsampled map:
//
//   loss = Σ_valid nll(up_r(score)[b, :, y, x], label[b, y, x]) / max(#valid, 1)
//
// Replaces both TPU kernels of lc2is_tpu/ops/fused_ce.py: _fwd_kernel (:89,
// the Σ nll and Σ valid) and _bwd_kernel (:117, d loss / d low-res map).  The
// backward there only differs from the forward by its output; here one pass
// emits Σ nll, Σ valid and the unscaled gradient G = Σ w·(softmax − onehot)
// in the map's (B, K, h, w) layout, and the wrapper's backward scales G by
// g / max(#valid, 1).
//
// What bounds it on the card: the exponentials (two per hi-res pixel and
// class, on the SFU's 16 a clock an SM) and the blends; the bytes (the map
// and labels read, the f32 gradient written) take a fraction of that.
//
// Design: a block owns a TH x TW tile of low-res cells of one image.
//   0. It stages the tile and a one-cell halo, all K classes, in shared
//      memory with cp.async, in the caller's (B, K, h, w) layout, and reads
//      the labels in the caller's integer type (int32 or int64).
//   1. Hi-res pixels are grouped by the pair of cells their taps read along
//      each axis: pair a holds the pixels whose torch half-pixel source
//      floor is a, so each reads cells a and a + 1 with weight t on a + 1;
//      the pixels whose floor falls off the image join the edge pair with t
//      = 0 or 1 (a clamped tap is the same cell with the whole weight).  A
//      unit is up to PU horizontally adjacent pixels of one hi-res row that
//      share a column pair, so a class's four taps are loaded once for them.
//      The block computes every pixel whose taps reach its cells: its own
//      and a ring about r/2 wide, as the TPU kernel recomputes a one-row
//      halo (1.2x the own pixels at r 4 with 8 x 16 cells, 1.5x at r 16
//      with 3 x 8).
//   2. A thread walks its units; for each, the K loop runs inside the
//      thread: the max of the blended logits, then Σ exp, lse and the picked
//      logit, in log2 units (a class's two column values are scaled by
//      log2 e once for the unit's pixels, whose logits are then one fma
//      each, and exp is the SFU's ex2).  Each pixel's softmax is computed
//      once per block; no warp reductions.  nll and validity count for the
//      block's own pixels only.
//   3. Classes in chunks of KC: each unit recomputes exp(v − lse), weighs it
//      by its column taps and writes its two column sums (minus its pixels'
//      one-hot terms) to shared memory; then the threads of an own cell
//      gather, one class each, in a fixed order, the row-weighted sums of
//      the units whose taps reach it and write its gradient once.  No atomics:
//      the result is the same bit for bit from run to run.
// Per-block loss partials go to a buffer that a second small kernel reduces
// in a fixed order.
#include <math_constants.h>

#include <initializer_list>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace lc2 {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 8;          // classes a gradient chunk
// own cells of a tile, at most (every plan's tiles): a cell's two groups of
// 4 classes have a thread each, or more
constexpr int kMaxCells = kThreads / 2;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;
// shared memory a block may use, and the most two resident blocks can each
constexpr size_t kSmemMax = 232448, kSmemTwo = 115712;

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Along one axis of n cells at factor r: the pair of hi-res coordinate y,
// the floor of its source (y + 0.5) / r − 0.5 clamped to [0, max(n − 2, 0)].
__host__ __device__ inline int pair_of(int y, int n, int r) {
  const int num = 2 * y + 1 - r;  // 2r · source
  const int f = num >= 0 ? num / (2 * r) : -((2 * r - 1 - num) / (2 * r));
  return imin(imax(f, 0), imax(n - 2, 0));
}

// The hi-res coordinates [pair_lo, pair_hi) of pair a.
__host__ __device__ inline int pair_lo(int a, int r) { return a == 0 ? 0 : r * a + r / 2; }
__host__ __device__ inline int pair_hi(int a, int n, int r) {
  return a >= imax(n - 1, 1) - 1 ? r * n : r * (a + 1) + r / 2;
}

// Weight of the pair's second cell at hi-res coordinate y (0 or 1 where
// the source lies past an edge; 0 when n is 1: the pair reads cell 0 twice).
__device__ inline float frac_of(int y, int a, int n, int r) {
  if (n == 1) return 0.0f;
  const float t = static_cast<float>(2 * (y - r * a) + 1 - r) / static_cast<float>(2 * r);
  return fminf(fmaxf(t, 0.0f), 1.0f);
}

// Explicit roundings, so that every pass computes a logit bit for bit alike.
__device__ __forceinline__ float lerp2(float w0, float a, float w1, float b) {
  return __fmaf_rn(w1, b, __fmul_rn(w0, a));
}



// A launch's tile and the maxima over its tiles that size shared memory.
struct Plan {
  int th, tw;       // low-res cells of a tile
  int pu;           // pixels a unit (template PU)
  int sr, sc;       // staged rows and columns (the tile, a halo, bf16 pair alignment)
  int rows;         // hi-res rows of a tile, at most
  int segs;         // units a hi-res row, at most
  int gsegs;        // units of one column pair, at most
  int xs;           // hi-res columns of a tile, at most
  int units;        // rows · segs
  int gx, gy;       // tiles across, down
  size_t smem;
};

// Byte offsets of the shared-memory regions (16-byte aligned).
struct Layout {
  size_t s, t, lse, rowfy, rowpair, colfx, seg, gfirst, xmap, lab, red, total;
};

__host__ __device__ inline size_t up16(size_t n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline Layout layout_of(const Plan& p, int K, int esize) {
  Layout l;
  size_t o = 0;
  l.s = o;       o += up16((size_t)K * p.sr * p.sc * esize);
  l.t = o;       o += up16((size_t)2 * (p.units + 1) * kKC * 4);
  l.lse = o;     o += up16((size_t)p.pu * p.units * 4);
  l.rowfy = o;   o += up16((size_t)p.rows * 4);
  l.rowpair = o; o += up16((size_t)p.rows * 4);
  l.colfx = o;   o += up16((size_t)p.xs * 4);
  l.seg = o;     o += up16((size_t)p.segs * 3 * 4);
  l.gfirst = o;  o += up16((size_t)(p.tw + 2) * 4);
  l.xmap = o;    o += up16((size_t)p.xs * 4);
  l.lab = o;     o += up16((size_t)p.pu * p.units);
  l.red = o;     o += up16((2 * kWarps + 1) * 4);
  l.total = o;
  return l;
}

// Rows (or columns) and units a row (or column) of the tiles of one axis of
// n cells, t cells a tile, and units of one pair: the maxima over the tiles.
void axis_max(int n, int t, int r, int pu, int& lines, int& segs, int& pair_segs) {
  lines = segs = pair_segs = 0;
  const int pairs = imax(n - 1, 1);
  for (int i0 = 0; i0 < n; i0 += t) {
    const int lo = imax(i0 - 1, 0), hi = imin(i0 + t - 1, pairs - 1);
    lines = imax(lines, pair_hi(hi, n, r) - pair_lo(lo, r));
    int s = 0;
    for (int a = lo; a <= hi; ++a) {
      const int n_a = (pair_hi(a, n, r) - pair_lo(a, r) + pu - 1) / pu;
      s += n_a;
      pair_segs = imax(pair_segs, n_a);
    }
    segs = imax(segs, s);
  }
}

// The first tile (in order of preference) whose shared memory fits two
// resident blocks, else one.
bool make_plan(int esize, int h, int w, int K, int r, Plan& p) {
  p.pu = r <= 3 ? 2 : r <= 7 ? 4 : r <= 15 ? 8 : 16;
  static const int small_tiles[][2] = {{8, 16}, {8, 8}, {4, 8}, {4, 4}, {2, 4}, {2, 2}, {1, 2}};
  static const int big_tiles[][2] = {{3, 8}, {2, 8}, {2, 4}, {1, 4}, {1, 2}};
  const int(*tiles)[2] = r <= 8 ? small_tiles : big_tiles;
  const int n_tiles = r <= 8 ? 7 : 5;
  for (size_t budget : {kSmemTwo, kSmemMax}) {
    for (int i = 0; i < n_tiles; ++i) {
      p.th = tiles[i][0];
      p.tw = tiles[i][1];
      if (p.th * p.tw > kMaxCells) continue;
      p.sr = p.th + 2;
      p.sc = p.tw + (esize == 2 ? 4 : 2);
      int row_segs, row_pair_segs;
      axis_max(h, p.th, r, p.pu, p.rows, row_segs, row_pair_segs);
      axis_max(w, p.tw, r, p.pu, p.xs, p.segs, p.gsegs);
      p.units = p.rows * p.segs;
      p.gx = (w + p.tw - 1) / p.tw;
      p.gy = (h + p.th - 1) / p.th;
      p.smem = layout_of(p, K, esize).total;
      if (p.smem <= budget) return true;
    }
  }
  return false;
}

template <typename T, int PU>
__global__ void __launch_bounds__(kThreads, 2)
fused_ce_kernel(const T* __restrict__ score, const void* __restrict__ labels, int lab64,
                float* __restrict__ grad, float* __restrict__ part, int h, int w, int K, int r,
                int has_ignore, long long ignore_index, int aligned, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout_of(p, K, sizeof(T));
  T* S = reinterpret_cast<T*>(smem + L.s);                    // [K][sr][sc]
  float* Tb = reinterpret_cast<float*>(smem + L.t);           // [2][units + 1][kKC]
  float* lse = reinterpret_cast<float*>(smem + L.lse);        // [pu][units]
  float* rowfy = reinterpret_cast<float*>(smem + L.rowfy);    // [rows]
  int* rowpair = reinterpret_cast<int*>(smem + L.rowpair);    // [rows]
  float* colfx = reinterpret_cast<float*>(smem + L.colfx);    // [xs]
  int* seg_x = reinterpret_cast<int*>(smem + L.seg);          // [segs] first pixel
  int* seg_n = seg_x + p.segs;                                // [segs] pixels
  int* seg_g = seg_n + p.segs;                                // [segs] column pair
  int* gfirst = reinterpret_cast<int*>(smem + L.gfirst);      // [pairs + 1] first segment
  int* xmap = reinterpret_cast<int*>(smem + L.xmap);          // [xs] segment · PU + pixel
  uint8_t* lab = smem + L.lab;                                // [pu][units] clipped class
  float* red = reinterpret_cast<float*>(smem + L.red);          // [2][warps] partials
  int* nseg_sh = reinterpret_cast<int*>(red + 2 * kWarps);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, i0 = blockIdx.y * p.th, j0 = blockIdx.x * p.tw;
  const int U = p.units;
  const int pa_lo = imax(i0 - 1, 0), pa_hi = imin(i0 + p.th - 1, imax(h - 1, 1) - 1);
  const int ga_lo = imax(j0 - 1, 0), ga_hi = imin(j0 + p.tw - 1, imax(w - 1, 1) - 1);
  const int y_lo = pair_lo(pa_lo, r), rows = pair_hi(pa_hi, h, r) - y_lo;
  const int x_lo = pair_lo(ga_lo, r), xs = pair_hi(ga_hi, w, r) - x_lo;
  const int sr0 = i0 - 1, sc0 = j0 - (sizeof(T) == 2 ? 2 : 1);  // staged origin
  const int plane = p.sr * p.sc;

  // 0. the map's tile and halo -> S, clamped to the image (taps read image
  // coordinates, so a clamped tap needs no copy)
  {
    const int r_beg = imax(sr0, 0), r_end = imin(sr0 + p.sr, h);
    const int c_beg = imax(sc0, 0), c_end = imin(sc0 + p.sc, w);
    const int nr = r_end - r_beg;
    const T* mb = score + (size_t)b * K * h * w;
    if (sizeof(T) == 4 || (aligned && w % 2 == 0)) {  // 4-byte copies: an f32, a bf16 pair
      const int per = 4 / sizeof(T), nc = (c_end - c_beg) / per;
      for (int idx = tid; idx < K * nr * nc; idx += kThreads) {
        const int k = idx / (nr * nc), rem = idx - k * nr * nc, rr = rem / nc;
        const int c = c_beg + per * (rem - rr * nc);
        mma::cp_async4(S + ((size_t)k * p.sr + r_beg + rr - sr0) * p.sc + c - sc0,
                       mb + ((size_t)k * h + r_beg + rr) * w + c, true);
      }
    } else {
      const int nc = c_end - c_beg;
      for (int idx = tid; idx < K * nr * nc; idx += kThreads) {
        const int k = idx / (nr * nc), rem = idx - k * nr * nc, rr = rem / nc;
        const int c = c_beg + rem - rr * nc;
        S[((size_t)k * p.sr + r_beg + rr - sr0) * p.sc + c - sc0] =
            mb[((size_t)k * h + r_beg + rr) * w + c];
      }
    }
    mma::cp_async_commit();
  }
  for (int ry = tid; ry < rows; ry += kThreads) {
    const int y = y_lo + ry, a = pair_of(y, h, r);
    rowpair[ry] = a;
    rowfy[ry] = frac_of(y, a, h, r);
  }
  for (int xo = tid; xo < xs; xo += kThreads) {
    const int x = x_lo + xo;
    colfx[xo] = frac_of(x, pair_of(x, w, r), w, r);
  }
  if (tid == 0) {  // the units of a row: each column pair's pixels in runs of PU
    int s = 0;
    for (int g = ga_lo; g <= ga_hi; ++g) {
      gfirst[g - ga_lo] = s;
      const int hi = pair_hi(g, w, r);
      for (int x0 = pair_lo(g, r); x0 < hi; x0 += PU, ++s) {
        seg_x[s] = x0;
        seg_n[s] = imin(PU, hi - x0);
        seg_g[s] = g;
        for (int q = 0; q < seg_n[s]; ++q) xmap[x0 + q - x_lo] = s * PU + q;
      }
    }
    gfirst[ga_hi - ga_lo + 1] = s;
    *nseg_sh = s;
  }
  __syncthreads();
  const int nseg = *nseg_sh, units = rows * nseg;

  // labels, row by row (coalesced): the clipped class, and lse = 0 (valid)
  // or +inf (ignored) as the validity flag until pass 2 writes lse
  for (int idx = tid; idx < rows * xs; idx += kThreads) {
    const int ry = idx / xs, xo = idx - ry * xs;
    const size_t off = ((size_t)b * r * h + y_lo + ry) * (size_t)(r * w) + x_lo + xo;
    const long long v = lab64 ? static_cast<const long long*>(labels)[off]
                              : static_cast<const int*>(labels)[off];
    const int sp = xmap[xo], s = sp / PU, q = sp - s * PU, u = ry * nseg + s;
    lab[q * U + u] = static_cast<uint8_t>(v < 0 ? 0 : v >= K ? K - 1 : v);
    lse[q * U + u] = has_ignore && v == ignore_index ? CUDART_INF_F : 0.0f;
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  // A unit's taps: offsets of its two rows (o0, o1) and columns (q0, q1)
  // in a class plane of S, its row weight, and its pixels' column weights.
  struct Unit {
    int o0, o1, q0, q1, n, x0, ry;
    float gy, fy;
  };
  auto unit_of = [&](int u) {
    Unit t;
    t.ry = u / nseg;
    const int s = u - t.ry * nseg, a = rowpair[t.ry], g = seg_g[s];
    t.fy = rowfy[t.ry];
    t.gy = 1.0f - t.fy;
    t.o0 = (a - sr0) * p.sc;
    t.o1 = (imin(a + 1, h - 1) - sr0) * p.sc;
    t.q0 = g - sc0;
    t.q1 = imin(g + 1, w - 1) - sc0;
    t.n = seg_n[s];
    t.x0 = seg_x[s];
    return t;
  };
  // class k's logits in log2 units at the unit's two columns, blended
  // across its rows: c0 and d = c1 − c0, so a pixel's is c0 + fx · d
  auto columns = [&](const Unit& t, int k, float& c0, float& d) {
    const T* sk = S + (size_t)k * plane;
    c0 = __fmul_rn(lerp2(t.gy, to_f<T>(sk[t.o0 + t.q0]), t.fy, to_f<T>(sk[t.o1 + t.q0])), kLog2e);
    d = __fsub_rn(
        __fmul_rn(lerp2(t.gy, to_f<T>(sk[t.o0 + t.q1]), t.fy, to_f<T>(sk[t.o1 + t.q1])), kLog2e),
        c0);
  };

  // 1-2. per unit: the max, Σ exp, lse and the picked logit of each pixel
  // (log2 units: exp(v − m) = 2^(v2 − m2), exactly 1 where v is the max)
  float nll_sum = 0.0f, n_valid = 0.0f;
  const int own_y0 = r * i0, own_y1 = r * imin(i0 + p.th, h);
  const int own_x0 = r * j0, own_x1 = r * imin(j0 + p.tw, w);
  for (int u = tid; u < units; u += kThreads) {
    const Unit t = unit_of(u);
    float fx[PU], m[PU], se[PU];
#pragma unroll
    for (int q = 0; q < PU; ++q) {
      fx[q] = q < t.n ? colfx[t.x0 + q - x_lo] : 0.0f;
      m[q] = -CUDART_INF_F;
      se[q] = 0.0f;
    }
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      float c0, d;
      columns(t, k, c0, d);
#pragma unroll
      for (int q = 0; q < PU; ++q) m[q] = fmaxf(m[q], __fmaf_rn(fx[q], d, c0));
    }
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      float c0, d;
      columns(t, k, c0, d);
#pragma unroll
      for (int q = 0; q < PU; ++q)
        se[q] = __fadd_rn(se[q], mma::exp2_approx(__fsub_rn(__fmaf_rn(fx[q], d, c0), m[q])));
    }
#pragma unroll
    for (int q = 0; q < PU; ++q) {
      float out = CUDART_INF_F;
      if (q < t.n && lse[q * U + u] == 0.0f) {  // a valid pixel
        const float l2 = __fadd_rn(m[q], __log2f(se[q]));
        float c0, d;
        columns(t, lab[q * U + u], c0, d);
        const int y = y_lo + t.ry, x = t.x0 + q;
        if (y >= own_y0 && y < own_y1 && x >= own_x0 && x < own_x1) {
          nll_sum += __fmul_rn(__fsub_rn(l2, __fmaf_rn(fx[q], d, c0)), kLn2);
          n_valid += 1.0f;
        }
        out = l2;
      }
      lse[q * U + u] = out;
    }
  }

  // The gather, set once.  A cell's classes go in two groups of 4, and
  // each (cell, group) has Z (a power of 2) adjacent threads that split its
  // rows (z, z + Z, ...) and add their sums in an xor tree.  A cell sums
  // rows [ry0, ry1) of the units' column sums, the rows of pair a − 1
  // (before rys) weighted fy toward it, those of pair a 1 − fy, and in each
  // row the units of column pair bb − 1 (their right sums) then of bb
  // (their left sums); up to two of each, the rest read the zero unit U.
  // A pair of one cell (n = 1) reads it twice with the second weight 0, so
  // its other term is exactly zero and left out.
  const int own_h = imin(i0 + p.th, h) - i0, own_w = imin(j0 + p.tw, w) - j0;
  const int cells = own_h * own_w;
  int Z = 1;  // the most that fit, up to a warp
  while (Z < 32 && 2 * Z * 2 * cells <= kThreads) Z *= 2;
  const int z = tid & (Z - 1), item = tid / Z, cell = item >> 1, kq = 4 * (item & 1);
  const bool gathers = cell < cells;
  const int ga = i0 + (gathers ? cell / own_w : 0), gb = j0 + (gathers ? cell % own_w : 0);
  const bool above = ga - 1 >= pa_lo, below = ga <= pa_hi;
  const int ry0 = (above ? pair_lo(ga - 1, r) : pair_lo(ga, r)) - y_lo;
  const int rys = above ? pair_hi(ga - 1, h, r) - y_lo : ry0;
  const int ry1 = below ? pair_hi(ga, h, r) - y_lo : rys;
  const int s1a = gb - 1 >= ga_lo ? gfirst[gb - 1 - ga_lo] : 0;
  const int s1b = gb - 1 >= ga_lo ? gfirst[gb - ga_lo] : 0;
  const int s0a = gb <= ga_hi ? gfirst[gb - ga_lo] : 0;
  const int s0b = gb <= ga_hi ? gfirst[gb - ga_lo + 1] : 0;
  const int U1 = U + 1;  // units and the zero unit
  const float4* T1 = reinterpret_cast<const float4*>(Tb + (size_t)U1 * kKC);  // right sums
  const float4* T0 = reinterpret_cast<const float4*>(Tb);                     // left sums
  const int q1a = s1b > s1a ? s1a : U, q1b = s1b > s1a + 1 ? s1a + 1 : U;
  const int q0a = s0b > s0a ? s0a : U, q0b = s0b > s0a + 1 ? s0a + 1 : U;
  for (int i = tid; i < 2 * kKC; i += kThreads) Tb[(size_t)(i / kKC) * U1 * kKC + U * kKC + i % kKC] = 0.0f;

  // 3. the gradient, kKC classes at a time
  for (int k0 = 0; k0 < K; k0 += kKC) {
    const int nk = imin(kKC, K - k0);
    __syncthreads();  // lse written (first chunk) / the previous gather done with Tb
    for (int u = tid; u < units; u += kThreads) {
      const Unit t = unit_of(u);
      float fx[PU], gx[PU], l2[PU];
#pragma unroll
      for (int q = 0; q < PU; ++q) {
        fx[q] = q < t.n ? colfx[t.x0 + q - x_lo] : 0.0f;
        gx[q] = 1.0f - fx[q];
        l2[q] = lse[q * U + u];  // +inf: no gradient
      }
      float d0[kKC], d1[kKC];
#pragma unroll
      for (int kc = 0; kc < kKC; ++kc) {
        d0[kc] = d1[kc] = 0.0f;
        if (kc < nk) {
          float c0, d;
          columns(t, k0 + kc, c0, d);
#pragma unroll
          for (int q = 0; q < PU; ++q) {
            const float e = mma::exp2_approx(__fsub_rn(__fmaf_rn(fx[q], d, c0), l2[q]));
            d0[kc] = __fmaf_rn(gx[q], e, d0[kc]);
            d1[kc] = __fmaf_rn(fx[q], e, d1[kc]);
          }
        }
      }
      float4* o0 = reinterpret_cast<float4*>(Tb + (size_t)u * kKC);
      float4* o1 = reinterpret_cast<float4*>(Tb + (size_t)(U1 + u) * kKC);
      o0[0] = make_float4(d0[0], d0[1], d0[2], d0[3]);
      o0[1] = make_float4(d0[4], d0[5], d0[6], d0[7]);
      o1[0] = make_float4(d1[0], d1[1], d1[2], d1[3]);
      o1[1] = make_float4(d1[4], d1[5], d1[6], d1[7]);
#pragma unroll
      for (int q = 0; q < PU; ++q) {  // − onehot
        const int c = lab[q * U + u] - k0;
        if (l2[q] != CUDART_INF_F && c >= 0 && c < nk) {
          Tb[(size_t)u * kKC + c] -= gx[q];
          Tb[(size_t)(U1 + u) * kKC + c] -= fx[q];
        }
      }
    }
    __syncthreads();
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gathers) {
      for (int ry = ry0 + z; ry < ry1; ry += Z) {
        const int base = ry * nseg;
        float4 row;
        if (p.gsegs <= 2) {
          const float4 a = T1[(size_t)(q1a == U ? U : base + q1a) * 2 + (kq >> 2)];
          const float4 b2 = T1[(size_t)(q1b == U ? U : base + q1b) * 2 + (kq >> 2)];
          const float4 c = T0[(size_t)(q0a == U ? U : base + q0a) * 2 + (kq >> 2)];
          const float4 e = T0[(size_t)(q0b == U ? U : base + q0b) * 2 + (kq >> 2)];
          row = make_float4(a.x + b2.x + c.x + e.x, a.y + b2.y + c.y + e.y,
                            a.z + b2.z + c.z + e.z, a.w + b2.w + c.w + e.w);
        } else {  // r where a column pair has more than two units
          row = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          for (int s2 = s1a; s2 < s1b; ++s2) {
            const float4 v = T1[(size_t)(base + s2) * 2 + (kq >> 2)];
            row = make_float4(row.x + v.x, row.y + v.y, row.z + v.z, row.w + v.w);
          }
          for (int s2 = s0a; s2 < s0b; ++s2) {
            const float4 v = T0[(size_t)(base + s2) * 2 + (kq >> 2)];
            row = make_float4(row.x + v.x, row.y + v.y, row.z + v.z, row.w + v.w);
          }
        }
        const float wy = ry < rys ? rowfy[ry] : 1.0f - rowfy[ry];
        acc.x = __fmaf_rn(wy, row.x, acc.x);
        acc.y = __fmaf_rn(wy, row.y, acc.y);
        acc.z = __fmaf_rn(wy, row.z, acc.z);
        acc.w = __fmaf_rn(wy, row.w, acc.w);
      }
    }
    // the row splits' sums, in a fixed tree (a split group is Z aligned
    // lanes; threads that gather nothing add zeros among themselves)
    for (int o = 1; o < Z; o <<= 1) {
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, o);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, o);
      acc.z += __shfl_xor_sync(0xffffffffu, acc.z, o);
      acc.w += __shfl_xor_sync(0xffffffffu, acc.w, o);
    }
    if (gathers && z == 0) {
      const float v4[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kq + j < nk) grad[(((size_t)b * K + k0 + kq + j) * h + ga) * w + gb] = v4[j];
    }
  }

  nll_sum = warp_sum(nll_sum);
  n_valid = warp_sum(n_valid);
  if (lane == 0) {
    red[warp] = nll_sum;
    red[kWarps + warp] = n_valid;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f, c = 0.0f;
    for (int q = 0; q < kWarps; ++q) {
      s += red[q];
      c += red[kWarps + q];
    }
    const size_t blk = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    part[2 * blk] = s;
    part[2 * blk + 1] = c;
  }
}

// out[0] = Σ nll, out[1] = Σ valid over the per-block partials, in a fixed
// order (one block; doubles: up to 2M pixels a step)
__global__ void __launch_bounds__(256) ce_reduce_kernel(const float* __restrict__ part, int n,
                                                        float* __restrict__ out) {
  __shared__ double red[2][256];
  double a = 0.0, c = 0.0;
  for (int q = threadIdx.x; q < n; q += 256) {
    a += part[2 * q];
    c += part[2 * q + 1];
  }
  red[0][threadIdx.x] = a;
  red[1][threadIdx.x] = c;
  __syncthreads();
  for (int s = 128; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      red[0][threadIdx.x] += red[0][threadIdx.x + s];
      red[1][threadIdx.x] += red[1][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = (float)red[0][0];
    out[1] = (float)red[1][0];
  }
}

template <typename T, int PU>
cudaError_t launch_pu(const Plan& p, const void* score, const void* labels, int lab64,
                      float* grad, float* part, float* out, int B, int h, int w, int K, int r,
                      int has_ignore, int ignore_index, cudaStream_t s) {
  auto kernel = fused_ce_kernel<T, PU>;
  LC2_TRY(allow_smem(kernel, p.smem));
  const int aligned = reinterpret_cast<uintptr_t>(score) % 4 == 0;
  kernel<<<dim3(p.gx, p.gy, B), kThreads, p.smem, s>>>(
      static_cast<const T*>(score), labels, lab64, grad, part, h, w, K, r, has_ignore,
      ignore_index, aligned, p);
  LC2_TRY(cudaGetLastError());
  ce_reduce_kernel<<<1, 256, 0, s>>>(part, p.gx * p.gy * B, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Plan& p, const void* score, const void* labels, int lab64, float* grad,
                   float* part, float* out, int B, int h, int w, int K, int r, int has_ignore,
                   int ignore_index, cudaStream_t s) {
  switch (p.pu) {
    case 2: return launch_pu<T, 2>(p, score, labels, lab64, grad, part, out, B, h, w, K, r,
                                   has_ignore, ignore_index, s);
    case 4: return launch_pu<T, 4>(p, score, labels, lab64, grad, part, out, B, h, w, K, r,
                                   has_ignore, ignore_index, s);
    case 8: return launch_pu<T, 8>(p, score, labels, lab64, grad, part, out, B, h, w, K, r,
                                   has_ignore, ignore_index, s);
    default: return launch_pu<T, 16>(p, score, labels, lab64, grad, part, out, B, h, w, K, r,
                                     has_ignore, ignore_index, s);
  }
}

bool plan_for(int dtype, int h, int w, int K, int r, Plan& p) {
  if (K < 1 || K > 256 || r < 2 || h < 1 || w < 1) return false;
  if (dtype != kF32 && dtype != kBF16) return false;
  return make_plan(dtype == kF32 ? 4 : 2, h, w, K, r, p);
}

}  // namespace
}  // namespace lc2

// Partial-sum floats a launch needs (the wrapper allocates them); 0 for a
// shape the kernel does not take.
extern "C" long long lc2_fused_ce_partials(int dtype, int B, int h, int w, int K, int r) {
  lc2::Plan p;
  if (!lc2::plan_for(dtype, h, w, K, r, p)) return 0;
  return 2LL * p.gx * p.gy * B;
}

// score (B, K, h, w) contiguous of the dtype; labels (B, r·h, r·w) int32
// (label_bytes 4) or int64 (8), contiguous; grad (B, K, h, w) f32: Σ over
// hi-res pixels of tap weight · (softmax − onehot), unscaled; part:
// lc2_fused_ce_partials floats; out[2] f32 = (Σ nll, Σ valid).  Labels are
// clipped to [0, K); with has_ignore, pixels labelled ignore_index are left
// out.  1 <= K <= 256, r >= 2.
extern "C" int lc2_fused_ce(int dtype, const void* score, const void* labels, int label_bytes,
                            void* grad, void* part, void* out, int B, int h, int w, int K, int r,
                            int has_ignore, int ignore_index, void* stream) {
  lc2::Plan p;
  if (B < 1 || (label_bytes != 4 && label_bytes != 8) || !lc2::plan_for(dtype, h, w, K, r, p))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* g = static_cast<float*>(grad);
  float* pt = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  const int lab64 = label_bytes == 8;
  if (dtype == lc2::kF32)
    return lc2::launch<float>(p, score, labels, lab64, g, pt, o, B, h, w, K, r, has_ignore,
                              ignore_index, s);
  return lc2::launch<__nv_bfloat16>(p, score, labels, lab64, g, pt, o, B, h, w, K, r, has_ignore,
                                    ignore_index, s);
}
