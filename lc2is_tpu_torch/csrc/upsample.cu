// upsample_tokens: channels-last integer-factor bilinear upsample
//   (B, H·W, C) -> (B, rH·rW, C), torch half-pixel centres, clamped edges,
// and its adjoint upsample_tokens_adjoint (B, rH·rW, C) -> (B, H·W, C), the
// backward.
//
// Replaces the TPU kernels lc2is_tpu/ops/upsample.py::_kernel (:42, entry
// upsample_tokens :167) and ::_adj_kernel (:186, launched by _adjoint_impl
// :232).  Output (y, x) reads input rows y0, y0+1 and columns x0, x0+1 at
// src = (o + 0.5)/r - 0.5 (clamped), which for r = 2 is the fixed 0.25/0.75
// phase blend of upsample.py:30-39.  The forward blends along W, rounds the
// widened rows to the element type, then blends along H, as _kernel does
// (:50-78).  The adjoint undoes that in the reference's order (_adj_kernel
// :195-229): the W-adjoint of each output-gradient row summed in f32 and
// rounded to the element type, then the H-adjoint of those rows in f32
// (a clamped edge tap folded onto the edge row or column), rounded once.
// Every product and sum is a separate round-to-nearest operation, left to
// right, as the plain versions in ops/upsample.py compute them (no fused
// multiply-add), so f32 and bf16 results repeat those bit for bit.
//
// What bounds it on the card: device memory alone.  No products to
// amortise: at r = 2 the forward reads each input element once and writes
// four, the adjoint reads four and writes one, so a batch-16 forward of the
// decoder's six upsamples moves 619 MB (0.185 ms at 3.35 TB/s).  The design:
// - index math: blockIdx fixes (batch, channel slice of a row) and the band
//   of input rows, threadIdx (input column j, channel lane); one 32-bit
//   division a thread, offsets widened to 64 bits only where formed;
// - lanes: a thread owns one lane of a token's channels, 16 bytes (8 bf16 or
//   4 f32) where C and the pointers' alignment allow, else 8, 4 or 2 bytes,
//   a compile-time instantiation chosen at launch; neighbouring threads take
//   neighbouring lanes of a token, then the next column, so a warp's loads
//   and stores cover whole sectors;
// - forward, r = 2: a thread walks down its band keeping three widened rows
//   (above, current, below: output columns 2j and 2j+1, rounded to the
//   element type) in registers; each input row is widened once, the band
//   reads one halo row above and below; every input row gives four output
//   lanes (2i+m, 2j+n); the neighbours' columns j-1 and j+1 come from L1;
// - adjoint, r = 2: a thread walks down the output-gradient rows that reach
//   its band (2·hb + 2), narrowing each (the four columns 2j-1 .. 2j+2, taps
//   0.25, 0.75, 0.75, 0.25, the clamped tap folded onto column 0 and W-1) and
//   keeping the last four narrowed rows in registers; dx row i is their
//   H-adjoint.  No atomics: every sum in a fixed order, the same bits on
//   every run;
// - other r (the models use r = 2 only): the same band walk and lanes, the
//   taps computed per output coordinate from src (tap_weight), each output
//   lane blended from its four input lanes, each dx lane from its 2r x 2r
//   output-gradient lanes; right, not tuned;
// - the band height: the largest of 16, 8, 4, 2, 1 rows that still gives
//   kMinBlocks blocks (forward: two waves of four 256-thread blocks an SM,
//   so the smallest main-path launch fills the card) or kMinBlocksAdjoint
//   (one wave: the adjoint's halo is two output-gradient rows a band, read
//   again from L2, and the gradient is four fifths of its bytes);
// - no shared memory, no TMA, no tensor cores: loads through L1 (__ldg),
//   plain 16-byte stores (times in PERF.md, rows 4 and 5).  Evict-first
//   stores (st.global.cs) timed a little faster on the forward alone in a
//   development build and are not used: the next decoder layer reads the
//   smaller launches' outputs, which they would push out of L2.
#include "common.cuh"

namespace lc2 {
namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2 * 4 * 132;
constexpr int kMinBlocksAdjoint = 4 * 132;

template <int NB> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

// one lane: NB bytes of a token's channels, N = NB / sizeof(T) elements
template <typename T, int NB>
struct Lane {
  static constexpr int N = NB / static_cast<int>(sizeof(T));
  using R = typename Raw<NB>::type;
  R raw;

  static __device__ __forceinline__ Lane load(const T* p) {
    Lane l;
    l.raw = __ldg(reinterpret_cast<const R*>(p));
    return l;
  }
  __device__ __forceinline__ void store(T* p) const { *reinterpret_cast<R*>(p) = raw; }
  __device__ __forceinline__ float at(int e) const {
    return to_f<T>(reinterpret_cast<const T*>(&raw)[e]);
  }
  __device__ __forceinline__ void set(int e, float v) {
    reinterpret_cast<T*>(&raw)[e] = from_f<T>(v);
  }
};

// wa·a + wb·b, each product and the sum rounded once (no fused multiply-add)
__device__ __forceinline__ float blend(float wa, float a, float wb, float b) {
  return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));
}

// (wa·a + wb·b) per element, rounded to T
template <typename T, int NB>
__device__ __forceinline__ Lane<T, NB> blend(float wa, const Lane<T, NB>& a, float wb,
                                             const Lane<T, NB>& b) {
  Lane<T, NB> o;
#pragma unroll
  for (int e = 0; e < Lane<T, NB>::N; ++e) o.set(e, blend(wa, a.at(e), wb, b.at(e)));
  return o;
}

// weight of input index i in the blend of output coordinate o (n inputs):
// the torch taps of ops/upsample.py::_taps, src in double as there; a
// clamped tap that lands on i twice adds its two weights
__device__ __forceinline__ float tap_weight(int o, int i, int n, int r) {
  const double src = (o + 0.5) / r - 0.5;
  const double fl = floor(src);
  const float f = static_cast<float>(src - fl);
  const int i0 = static_cast<int>(fl);
  const int a = min(max(i0, 0), n - 1), b = min(max(i0 + 1, 0), n - 1);
  return __fadd_rn(a == i ? 1.0f - f : 0.0f, b == i ? f : 0.0f);
}

// the thread's coordinates: batch b, input column j, first channel c; false
// past the row's last lane
struct Coord {
  int b, j, c;
};

template <int N>
__device__ __forceinline__ bool coord(int W, int C, int chunks, Coord& k) {
  k.b = blockIdx.x / chunks;
  const int t = (blockIdx.x - k.b * chunks) * kThreads + threadIdx.x;
  const int lanes = C / N;
  if (t >= W * lanes) return false;
  k.j = t / lanes;
  k.c = (t - k.j * lanes) * N;
  return true;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
upsample2_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W, int C, int chunks,
                 int hb) {
  using L = Lane<T, NB>;
  Coord k;
  if (!coord<L::N>(W, C, chunks, k)) return;
  const int jl = max(k.j - 1, 0), jr = min(k.j + 1, W - 1);
  const int i0 = blockIdx.y * hb, i1 = min(i0 + hb, H);
  const T* xb = x + (long long)k.b * H * W * C + k.c;
  const long long ow = 2LL * W * C;  // elements of an output row
  T* ob = out + (long long)k.b * 4 * H * W * C + 2LL * k.j * C + k.c;

  // input row i widened into output columns 2j (0.25·x[j-1] + 0.75·x[j])
  // and 2j+1 (0.75·x[j] + 0.25·x[j+1]), rounded to T
  auto widen = [&](int i, L& w0, L& w1) {
    const T* row = xb + (long long)i * W * C;
    const L l = L::load(row + (long long)jl * C), m = L::load(row + (long long)k.j * C),
            r = L::load(row + (long long)jr * C);
    w0 = blend(0.25f, l, 0.75f, m);
    w1 = blend(0.75f, m, 0.25f, r);
  };
  L p0, p1, c0, c1, n0, n1;  // widened rows i-1, i, i+1
  widen(max(i0 - 1, 0), p0, p1);
  widen(i0, c0, c1);
  for (int i = i0; i < i1; ++i) {
    widen(min(i + 1, H - 1), n0, n1);
    T* o = ob + 2LL * i * ow;  // output row 2i: 0.25·wide[i-1] + 0.75·wide[i]
    blend(0.25f, p0, 0.75f, c0).store(o);
    blend(0.25f, p1, 0.75f, c1).store(o + C);
    o += ow;  // output row 2i+1: 0.75·wide[i] + 0.25·wide[i+1]
    blend(0.75f, c0, 0.25f, n0).store(o);
    blend(0.75f, c1, 0.25f, n1).store(o + C);
    p0 = c0;
    p1 = c1;
    c0 = n0;
    c1 = n1;
  }
}

template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
upsample_any_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W, int C, int r,
                    int chunks, int hb) {
  using L = Lane<T, NB>;
  Coord k;
  if (!coord<L::N>(W, C, chunks, k)) return;
  const int i0 = blockIdx.y * hb, i1 = min(i0 + hb, H);
  const T* xb = x + (long long)k.b * H * W * C + k.c;
  T* ob = out + (long long)k.b * r * H * r * W * C + k.c;
  for (int i = i0; i < i1; ++i) {
    for (int my = 0; my < r; ++my) {
      const int oy = r * i + my;
      const double sy = (oy + 0.5) / r - 0.5;
      const float fy = static_cast<float>(sy - floor(sy));
      const int y0 = static_cast<int>(floor(sy));
      const T* ra = xb + (long long)min(max(y0, 0), H - 1) * W * C;
      const T* rb = xb + (long long)min(max(y0 + 1, 0), H - 1) * W * C;
      for (int mx = 0; mx < r; ++mx) {
        const int ox = r * k.j + mx;
        const double sx = (ox + 0.5) / r - 0.5;
        const float fx = static_cast<float>(sx - floor(sx));
        const int x0 = static_cast<int>(floor(sx));
        const long long xa = (long long)min(max(x0, 0), W - 1) * C;
        const long long xbb = (long long)min(max(x0 + 1, 0), W - 1) * C;
        const L wa = blend(1.0f - fx, L::load(ra + xa), fx, L::load(ra + xbb));
        const L wb = blend(1.0f - fx, L::load(rb + xa), fx, L::load(rb + xbb));
        blend(1.0f - fy, wa, fy, wb).store(ob + ((long long)oy * r * W + ox) * C);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// adjoint
// ---------------------------------------------------------------------------

template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
upsample2_adjoint_kernel(const T* __restrict__ g, T* __restrict__ dx, int H, int W, int C,
                         int chunks, int hb) {
  using L = Lane<T, NB>;
  constexpr int N = L::N;
  Coord k;
  if (!coord<N>(W, C, chunks, k)) return;
  const int i0 = blockIdx.y * hb, i1 = min(i0 + hb, H);
  // the output-gradient columns 2j-1 .. 2j+2 and their W-adjoint weights,
  // the clamped tap folded onto column 0 and W-1 (a slot of weight 0 skipped)
  const bool left = k.j == 0, right = k.j == W - 1;
  const float wl = left ? 0.0f : 0.25f, wr = right ? 0.0f : 0.25f;
  const float w1 = left ? 1.0f : 0.75f, w2 = right ? 1.0f : 0.75f;
  const long long xl = (long long)max(2 * k.j - 1, 0) * C, x1 = 2LL * k.j * C;
  const long long xr = (long long)min(2 * k.j + 2, 2 * W - 1) * C;
  const long long gw = 2LL * W * C;  // elements of an output-gradient row
  const T* gb = g + (long long)k.b * 4 * H * W * C + k.c;
  T* db = dx + (long long)k.b * H * W * C + (long long)k.j * C + k.c;

  // output-gradient row y narrowed to column j, rounded to T
  auto narrow = [&](int y) {
    const T* row = gb + (long long)y * gw;
    const L a = L::load(row + xl), b = L::load(row + x1), c = L::load(row + x1 + C),
            d = L::load(row + xr);
    L o;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      float s = __fmul_rn(w1, b.at(e));
      if (!left) s = __fadd_rn(__fmul_rn(wl, a.at(e)), s);
      s = __fadd_rn(s, __fmul_rn(w2, c.at(e)));
      if (!right) s = __fadd_rn(s, __fmul_rn(wr, d.at(e)));
      o.set(e, s);
    }
    return o;
  };
  // narrowed rows 2i-1, 2i (and, in the loop, 2i+1, 2i+2)
  L na = i0 > 0 ? narrow(2 * i0 - 1) : L{}, nb = narrow(2 * i0), nc, nd;
  for (int i = i0; i < i1; ++i) {
    const bool top = i == 0, bottom = i == H - 1;
    nc = narrow(2 * i + 1);
    if (!bottom) nd = narrow(2 * i + 2);
    const float v1 = top ? 1.0f : 0.75f, v2 = bottom ? 1.0f : 0.75f;
    L o;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      float s = __fmul_rn(v1, nb.at(e));
      if (!top) s = __fadd_rn(__fmul_rn(0.25f, na.at(e)), s);
      s = __fadd_rn(s, __fmul_rn(v2, nc.at(e)));
      if (!bottom) s = __fadd_rn(s, __fmul_rn(0.25f, nd.at(e)));
      o.set(e, s);
    }
    o.store(db + (long long)i * W * C);
    na = nc;
    nb = nd;
  }
}

template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
upsample_any_adjoint_kernel(const T* __restrict__ g, T* __restrict__ dx, int H, int W, int C,
                            int r, int chunks, int hb) {
  using L = Lane<T, NB>;
  constexpr int N = L::N;
  Coord k;
  if (!coord<N>(W, C, chunks, k)) return;
  const int i0 = blockIdx.y * hb, i1 = min(i0 + hb, H);
  const int oh = r * H, ow = r * W;
  const T* gb = g + (long long)k.b * oh * ow * C + k.c;
  T* db = dx + (long long)k.b * H * W * C + (long long)k.j * C + k.c;
  const int xlo = max(r * k.j - r / 2, 0), xhi = min(r * k.j - r / 2 + 2 * r, ow);
  for (int i = i0; i < i1; ++i) {
    float acc[N];
    bool first = true;
    for (int y = max(r * i - r / 2, 0); y < min(r * i - r / 2 + 2 * r, oh); ++y) {
      const float wy = tap_weight(y, i, H, r);
      if (wy == 0.0f) continue;
      // output-gradient row y narrowed to column j, rounded to T
      float nrw[N];
      bool fx = true;
      for (int xo = xlo; xo < xhi; ++xo) {
        const float wx = tap_weight(xo, k.j, W, r);
        if (wx == 0.0f) continue;
        const L v = L::load(gb + ((long long)y * ow + xo) * C);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float t = __fmul_rn(wx, v.at(e));
          nrw[e] = fx ? t : __fadd_rn(nrw[e], t);
        }
        fx = false;
      }
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float t = __fmul_rn(wy, round_t<T>(nrw[e]));
        acc[e] = first ? t : __fadd_rn(acc[e], t);
      }
      first = false;
    }
    L o;
#pragma unroll
    for (int e = 0; e < N; ++e) o.set(e, acc[e]);
    o.store(db + (long long)i * W * C);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// the widest lane (16, 8, 4 or 2 bytes, at least one element) that divides a
// token's channels and the alignment of both pointers
template <typename T>
int lane_bytes(const void* a, const void* b, int C) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  const int row = C * static_cast<int>(sizeof(T));
  for (int nb = 16; nb > static_cast<int>(sizeof(T)); nb /= 2)
    if (row % nb == 0 && p % nb == 0) return nb;
  return static_cast<int>(sizeof(T));
}

// rows a block walks: the largest of 16, 8, 4, 2, 1 that leaves at least
// min_blocks blocks (1 when none does)
int band_rows(long long row_blocks, int H, int min_blocks) {
  int hb = 16;
  while (hb > 1 && row_blocks * ((H + hb - 1) / hb) < min_blocks) hb /= 2;
  return hb;
}

template <typename T, int NB>
cudaError_t launch_nb(bool adjoint, const void* src, void* dst, int B, int H, int W, int C,
                      int r, cudaStream_t stream) {
  constexpr int N = Lane<T, NB>::N;
  const int chunks = (W * (C / N) + kThreads - 1) / kThreads;
  const int hb = band_rows((long long)B * chunks, H, adjoint ? kMinBlocksAdjoint : kMinBlocks);
  const dim3 grid(B * chunks, (H + hb - 1) / hb);
  const T* s = static_cast<const T*>(src);
  T* d = static_cast<T*>(dst);
  if (!adjoint && r == 2)
    upsample2_kernel<T, NB><<<grid, kThreads, 0, stream>>>(s, d, H, W, C, chunks, hb);
  else if (!adjoint)
    upsample_any_kernel<T, NB><<<grid, kThreads, 0, stream>>>(s, d, H, W, C, r, chunks, hb);
  else if (r == 2)
    upsample2_adjoint_kernel<T, NB><<<grid, kThreads, 0, stream>>>(s, d, H, W, C, chunks, hb);
  else
    upsample_any_adjoint_kernel<T, NB><<<grid, kThreads, 0, stream>>>(s, d, H, W, C, r, chunks,
                                                                      hb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(bool adjoint, const void* src, void* dst, int B, int H, int W, int C, int r,
                   cudaStream_t stream) {
  if (B == 0 || C == 0) return cudaSuccess;
  switch (lane_bytes<T>(src, dst, C)) {
    case 16: return launch_nb<T, 16>(adjoint, src, dst, B, H, W, C, r, stream);
    case 8: return launch_nb<T, 8>(adjoint, src, dst, B, H, W, C, r, stream);
    case 4: return launch_nb<T, 4>(adjoint, src, dst, B, H, W, C, r, stream);
    default:
      if constexpr (sizeof(T) == 2) return launch_nb<T, 2>(adjoint, src, dst, B, H, W, C, r, stream);
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace lc2

// g (B, rH·rW, C) contiguous (gradient of the upsample's output) -> dx
// (B, H·W, C); H, W are the INPUT grid; r >= 1.
extern "C" int lc2_upsample_adjoint(int dtype, const void* g, void* dx, int B, int H, int W,
                                    int C, int r, void* stream) {
  if (r < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lc2::kF32) return lc2::launch<float>(true, g, dx, B, H, W, C, r, s);
  if (dtype == lc2::kBF16) return lc2::launch<__nv_bfloat16>(true, g, dx, B, H, W, C, r, s);
  return cudaErrorInvalidValue;
}

// x (B, H·W, C) contiguous -> out (B, rH·rW, C); r >= 1.
extern "C" int lc2_upsample(int dtype, const void* x, void* out, int B, int H, int W, int C,
                            int r, void* stream) {
  if (r < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lc2::kF32) return lc2::launch<float>(false, x, out, B, H, W, C, r, s);
  if (dtype == lc2::kBF16) return lc2::launch<__nv_bfloat16>(false, x, out, B, H, W, C, r, s);
  return cudaErrorInvalidValue;
}
