// window_attention: swin window attention on (N, p, C) windows with the heads
// packed in C, a (heads, p, p) f32 relative-position bias and optional
// (N, p) int32 shift-region labels:
//
//   out[n, :, h] = softmax(q_h·k_hᵀ / √dh + bias[h] [−1e30 where regions
//                  differ]) · v_h
//
// Replaces lc2is_tpu/ops/window_attention.py::_kernel (:164, entry
// window_attention :216) with its semantics: logits accumulated in f32 and
// scaled, the bias added, a cross-region pair set to −1e30, the row max
// subtracted, the row normalised by one reciprocal of its sum, the
// probabilities rounded to T before the P·V product, which accumulates in f32
// and is rounded to T.  The TPU kernel's padding of N to a block multiple
// (:279-289) is not needed: every window is independent.
//
// What bounds it on the card: bytes.  Per window and head it reads 3·p·dh
// values and writes p·dh, against 4·p²·dh operations, about 49 operations a
// byte in bf16 at p = 49: well below the tensor cores' ridge (~295), so the
// aim is coalesced 16-byte traffic and enough windows in flight.
//
// f32 body (window_attention_kernel): one block of 4 warps per (window,
// head), on the CUDA cores.  The head's q, k and v tiles (p x dh, f32) sit in
// shared memory with an odd row stride, so the 32 keys a warp reads at one d
// fall in 32 banks.  A warp owns a query row at a time: each lane forms the
// logits of keys lane, lane + 32, ... (p <= 144: at most 5 a lane), the row
// max and the sum of the exponentials are warp reductions, the probabilities
// (rounded to T) go to the warp's row of shared memory, and each lane then
// sums P·V for columns lane, lane + 32, ... (dh <= 128: at most 4).  Shared
// memory: 3·p·(dh + 1) + 4·160 floats, 223 KB at p = 144, dh = 128.
//
// bf16 body (window_attention_mma): the products on the tensor cores
// (mma.sync m16n8k16, f32 accumulators, mma_bf16.cuh), so that they leave
// the critical path and the kernel can run at the rate of its bytes.  The
// grid runs over (group of windows, head); a block of 4 warps loads its
// head's bias (p x p f32) into shared memory once and walks its windows,
// whose q, k and v head slices come in through a two-stage cp.async ring
// (window t + 1 loads while window t computes; one stage where two do not
// fit: p 144 with dh above 64): 16-byte copies where dh is a multiple of 8,
// 4-byte ones where it is even, element copies otherwise; columns dh .. DP - 1
// (DP: dh rounded up to 16) and rows p .. PK - 1 (PK: p rounded up to 16)
// load as zeros, so a padded key's v row is 0 and a dropped key's p = 0
// never meets a NaN.  A warp owns 16 query rows of a window and holds S for
// the whole row in registers (PK <= 144 keys: at most 18 n8 tiles, so one
// pass with no online softmax): the raw q·k in f32, times 1/√dh in f32 (the
// reference does not fold the scale into q), + the bias, −1e30 where the
// two tokens' labels differ, keys past p dropped; the row max and sum each
// take two shuffles over the row's 4 lanes; the row is multiplied by one
// reciprocal of its sum and the normalised probabilities are rounded to
// bf16 straight into the A fragments of P·V (v through ldmatrix.trans).
// The output goes through the warp's own q rows to 16-byte stores.
// Instantiated per DP (16 .. 128) and per key bound (64 or 144 keys).
#include <math_constants.h>

#include <algorithm>

#include "attn_tiles.cuh"
#include "common.cuh"

namespace lc2 {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 144;             // window of 12
constexpr int kMaxDh = 128;
constexpr int kKeySlots = 5;           // ceil(kMaxP / 32)
constexpr int kColSlots = kMaxDh / 32;  // 4
constexpr float kNeg = -1e30f;          // window_attention.py:30

__host__ __device__ inline int row_stride(int dh) { return dh % 2 == 0 ? dh + 1 : dh; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        const int* __restrict__ regions, T* __restrict__ out, int P, int C,
                        int heads, float scale) {
  const int dh = C / heads, ld = row_stride(dh);
  const int n = blockIdx.x / heads, h = blockIdx.x - n * heads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [P][ld]
  float* ks = qs + P * ld;
  float* vs = ks + P * ld;
  float* ps = vs + P * ld;                          // [kWarps][kKeySlots * 32]
  int* lab = reinterpret_cast<int*>(ps + kWarps * kKeySlots * 32);  // [P]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)n * P * C + (size_t)h * dh;
  for (int idx = tid; idx < P * dh; idx += kThreads) {
    const int t = idx / dh, d = idx - t * dh;
    const size_t g = base + (size_t)t * C + d;
    qs[t * ld + d] = to_f(q[g]);
    ks[t * ld + d] = to_f(k[g]);
    vs[t * ld + d] = to_f(v[g]);
  }
  if (regions != nullptr)
    for (int t = tid; t < P; t += kThreads) lab[t] = regions[(size_t)n * P + t];
  __syncthreads();

  const float* bh = bias + (size_t)h * P * P;
  float* pw = ps + warp * kKeySlots * 32;
  for (int t = warp; t < P; t += kWarps) {
    const float* qr = qs + t * ld;
    const int lt = regions != nullptr ? lab[t] : 0;
    float s[kKeySlots];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int u = 0; u < kKeySlots; ++u) {
      const int j = lane + 32 * u;
      float a = -CUDART_INF_F;  // a key slot past the window: exp gives 0
      if (j < P) {
        const float* kr = ks + j * ld;
        a = 0.0f;
#pragma unroll 8
        for (int d = 0; d < dh; ++d) a = fmaf(qr[d], kr[d], a);
        a = __fadd_rn(__fmul_rn(a, scale), bh[t * P + j]);
        if (regions != nullptr && lab[j] != lt) a = kNeg;
      }
      s[u] = a;
      mx = fmaxf(mx, a);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int u = 0; u < kKeySlots; ++u) {
      s[u] = expf(s[u] - mx);
      sum += s[u];
    }
    const float inv = 1.0f / warp_sum(sum);
#pragma unroll
    for (int u = 0; u < kKeySlots; ++u) pw[lane + 32 * u] = round_t<T>(s[u] * inv);
    __syncwarp();
    float o[kColSlots];
#pragma unroll
    for (int i = 0; i < kColSlots; ++i) o[i] = 0.0f;
    for (int j = 0; j < P; ++j) {
      const float pj = pw[j];
      const float* vr = vs + j * ld;
#pragma unroll
      for (int i = 0; i < kColSlots; ++i) {
        const int d = lane + 32 * i;
        if (d < dh) o[i] = fmaf(pj, vr[d], o[i]);
      }
    }
    T* orow = out + base + (size_t)t * C;
#pragma unroll
    for (int i = 0; i < kColSlots; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) orow[d] = from_f<T>(o[i]);
    }
    __syncwarp();  // pw is rewritten by the warp's next row
  }
}

size_t smem_bytes(int P, int dh) {
  return sizeof(float) * ((size_t)3 * P * row_stride(dh) + kWarps * kKeySlots * 32) +
         sizeof(int) * P;
}

cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* bias,
                       const int* regions, float* out, int N, int P, int C, int heads,
                       cudaStream_t stream) {
  const int dh = C / heads;
  const size_t smem = smem_bytes(P, dh);
  auto kernel = window_attention_kernel<float>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)N * heads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      q, k, v, bias, regions, out, P, C, heads, static_cast<float>(1.0 / sqrt((double)dh)));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 body: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// How a window's head slice moves between device and shared memory: 16-byte
// chunks of 8 elements, 4-byte pairs, or single elements.
enum Copy { kCopy16 = 8, kCopy4 = 2, kCopy2 = 1 };

// Shared memory of one launch: the head's bias (PK rows at a stride of LDB
// floats, LDB ≡ 8 mod 32, so the float2 a lane reads of its two rows and
// keys fall in distinct banks), then `stages` stages of the q, k and v tiles
// (PK rows of DP + 8 bf16) and the PK region labels of one window.
struct MmaLayout {
  int pk, ld, ldb;
  size_t stage, bytes;
  __host__ __device__ MmaLayout(int P, int DP, int stages) {
    pk = (P + 15) / 16 * 16;
    ld = DP + 8;  // mma::row_stride<DP>()
    ldb = pk + (8 - pk % 32 + 32) % 32;
    stage = sizeof(bf16) * 3 * (size_t)pk * ld + sizeof(int) * (size_t)pk;
    bytes = sizeof(float) * (size_t)pk * ldb + stages * stage;
  }
};

// Rows [0, P) of one window's head slice (row stride C elements, `dh`
// columns from src) into a PK x DP tile at row stride LD, zeros past row P and
// column dh, by the block's threads; `copy` elements at a time (cp.async for
// 8 and 2, which the caller commits and waits for; plain loads for 1, which
// the caller's barrier publishes).
template <int DP>
__device__ __forceinline__ void load_head(const bf16* __restrict__ src, int P, int PK, int C,
                                          int dh, int copy, bf16* dst, int LD) {
  if (copy == kCopy16) {
    constexpr int kChunks = DP / 8;
    for (int idx = threadIdx.x; idx < PK * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = (idx - r * kChunks) * 8;
      const bool full = r < P && c < dh;
      mma::cp_async16(dst + r * LD + c, full ? src + (size_t)r * C + c : src, full);
    }
  } else if (copy == kCopy4) {
    constexpr int kPairs = DP / 2;
    for (int idx = threadIdx.x; idx < PK * kPairs; idx += kThreads) {
      const int r = idx / kPairs, c = (idx - r * kPairs) * 2;
      const bool full = r < P && c < dh;
      mma::cp_async4(dst + r * LD + c, full ? src + (size_t)r * C + c : src, full);
    }
  } else {
    for (int idx = threadIdx.x; idx < PK * DP; idx += kThreads) {
      const int r = idx / DP, c = idx - r * DP;
      dst[r * LD + c] = r < P && c < dh ? src[(size_t)r * C + c] : __float2bfloat16(0.0f);
    }
  }
}

// DP: dh rounded up to 16; NKC: 16-key chunks the registers hold (4: p <= 64,
// 9: p <= 144).  Block (group of windows, head); a warp per 16 query rows.
template <int DP, int NKC>
__global__ void __launch_bounds__(kThreads)
window_attention_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     const int* __restrict__ regions, bf16* __restrict__ out, int N, int P, int C,
                     int heads, int wpb, int stages, int copy, float scale) {
  constexpr int KC = DP / 16, NO = DP / 8;
  const MmaLayout lay(P, DP, stages);
  const int PK = lay.pk, LD = lay.ld, LDB = lay.ldb;
  const int h = blockIdx.y, dh = C / heads;
  const int w0 = blockIdx.x * wpb, nw = min(wpb, N - w0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int lr = lane & 7, l3 = (lane >> 3) & 1, l4 = lane >> 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* bs = reinterpret_cast<float*>(smem_raw);  // [PK][LDB]
  unsigned char* ring = smem_raw + sizeof(float) * PK * LDB;

  // window t of the block into stage t % stages: one cp.async group each,
  // empty past the block's windows
  auto issue = [&](int t) {
    if (t < nw) {
      bf16* qs = reinterpret_cast<bf16*>(ring + (t % stages) * lay.stage);
      const size_t base = (size_t)(w0 + t) * P * C + (size_t)h * dh;
      load_head<DP>(q + base, P, PK, C, dh, copy, qs, LD);
      load_head<DP>(k + base, P, PK, C, dh, copy, qs + PK * LD, LD);
      load_head<DP>(v + base, P, PK, C, dh, copy, qs + 2 * PK * LD, LD);
      if (regions != nullptr) {
        int* lab = reinterpret_cast<int*>(qs + 3 * PK * LD);
        for (int r = tid; r < PK; r += kThreads)
          mma::cp_async4(lab + r, r < P ? regions + (size_t)(w0 + t) * P + r : regions, r < P);
      }
    }
    mma::cp_async_commit();
  };
  issue(0);
  if (stages == 2) issue(1);
  // the head's bias, zeros past p (rows and keys that are dropped)
  const float* bh = bias + (size_t)h * P * P;
  for (int idx = tid; idx < PK * PK; idx += kThreads) {
    const int r = idx / PK, c = idx - r * PK;
    bs[r * LDB + c] = r < P && c < P ? bh[r * P + c] : 0.0f;
  }

  for (int t = 0; t < nw; ++t) {
    if (stages == 2)
      mma::cp_async_wait<1>();
    else
      mma::cp_async_wait<0>();
    __syncthreads();  // window t's tiles (and the bias) are in shared memory
    bf16* qs = reinterpret_cast<bf16*>(ring + (t % stages) * lay.stage);
    const bf16* ks = qs + PK * LD;
    const bf16* vs = ks + PK * LD;
    const int* lab = reinterpret_cast<const int*>(vs + PK * LD);
    for (int r0 = 16 * warp; r0 < PK; r0 += 64) {
      uint32_t qa[KC][4];
      mma::own_fragments<DP>(qs + r0 * LD, lane, qa);
      // S = q · kᵀ over the 16-key chunks that hold keys below p
      float s[2 * NKC][4];
#pragma unroll
      for (int j = 0; j < 2 * NKC; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int np = 0; np < NKC; ++np) {
        if (16 * np >= PK) break;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t b[4];
          mma::ldsm_x4(b, ks + (16 * np + lr + 8 * l4) * LD + kc * 16 + 8 * l3);
          mma::mma_bf16(s[2 * np], qa[kc], b[0], b[1]);
          mma::mma_bf16(s[2 * np + 1], qa[kc], b[2], b[3]);
        }
      }
      // logits: f32 scale, + bias, −1e30 across regions, keys past p dropped
      int lt[2] = {0, 0};
      if (regions != nullptr) {
        lt[0] = lab[r0 + g];
        lt[1] = lab[r0 + g + 8];
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 2 * NKC; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = 8 * j + c2;
          float2 b2 = make_float2(0.0f, 0.0f);
          if (key < PK) b2 = *reinterpret_cast<const float2*>(bs + (r0 + g + 8 * r) * LDB + key);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float a = -INFINITY;
            if (key + e < P) {
              a = __fadd_rn(__fmul_rn(s[j][2 * r + e], scale), e ? b2.y : b2.x);
              if (regions != nullptr && lab[key + e] != lt[r]) a = kNeg;
            }
            s[j][2 * r + e] = a;
            mx[r] = fmaxf(mx[r], a);
          }
        }
      float l[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        l[r] = 0.0f;
      }
      // e = exp(logit − max): −∞ (a dropped key) gives 0
#pragma unroll
      for (int j = 0; j < 2 * NKC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = mma::exp2_approx((s[j][e] - mx[e >> 1]) * mma::kLog2e);
          l[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = 1.0f / l[r];
      }
      // P = e · (1 / Σ e), rounded to bf16 in the A fragments; O = P · V
      float o[NO][4];
#pragma unroll
      for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < NKC; ++kk) {
        if (16 * kk >= PK) break;
        float lo[4], hi[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          lo[e] = s[2 * kk][e] * l[e >> 1];
          hi[e] = s[2 * kk + 1][e] * l[e >> 1];
        }
        uint32_t pa[4];
        mma::pack_a(pa, lo, hi);
#pragma unroll
        for (int dn = 0; dn < KC; ++dn) {
          uint32_t b[4];
          mma::ldsm_x4_t(b, vs + (16 * kk + lr + 8 * l3) * LD + 16 * dn + 8 * l4);
          mma::mma_bf16(o[2 * dn], pa, b[0], b[1]);
          mma::mma_bf16(o[2 * dn + 1], pa, b[2], b[3]);
        }
      }
      // through the warp's own q rows (read above, by this warp only) to
      // rows r0 .. r0 + 15 below p
      bf16* st = qs + r0 * LD;
      __syncwarp();
      mma::stage_rows<DP, NO>(o, 1.0f, 1.0f, st, lane);
      __syncwarp();
      bf16* dst = out + (size_t)(w0 + t) * P * C + (size_t)h * dh;
      if (copy == kCopy16) {
        const int chunks = dh / 8;
        for (int idx = lane; idx < 16 * chunks; idx += 32) {
          const int r = idx / chunks, c = (idx - r * chunks) * 8;
          if (r0 + r < P)
            *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * C + c) =
                *reinterpret_cast<const uint4*>(st + r * LD + c);
        }
      } else if (copy == kCopy4) {
        const int pairs = dh / 2;
        for (int idx = lane; idx < 16 * pairs; idx += 32) {
          const int r = idx / pairs, c = (idx - r * pairs) * 2;
          if (r0 + r < P)
            *reinterpret_cast<uint32_t*>(dst + (size_t)(r0 + r) * C + c) =
                *reinterpret_cast<const uint32_t*>(st + r * LD + c);
        }
      } else {
        for (int idx = lane; idx < 16 * dh; idx += 32) {
          const int r = idx / dh, c = idx - r * dh;
          if (r0 + r < P) dst[(size_t)(r0 + r) * C + c] = st[r * LD + c];
        }
      }
    }
    __syncthreads();  // every warp is done with stage t % stages
    issue(t + stages);
  }
  mma::cp_async_wait<0>();
}

template <int DP, int NKC>
cudaError_t launch_mma_dp(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                          const int* regions, bf16* out, int N, int P, int C, int heads, int copy,
                          cudaStream_t stream) {
  constexpr size_t kMaxSmem = 232448;
  int stages = 2;
  if (MmaLayout(P, DP, 2).bytes > kMaxSmem) stages = 1;
  const size_t smem = MmaLayout(P, DP, stages).bytes;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = window_attention_mma<DP, NKC>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // about 8 blocks an SM in all: enough windows a block to share its bias
  // load, enough blocks to fill the card
  const long long units = (long long)N * heads;
  const int wpb = (int)std::max(1LL, (units + 8 * 132 - 1) / (8 * 132));
  const int groups = (N + wpb - 1) / wpb;
  if (heads > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(groups, heads), kThreads, smem, stream>>>(
      q, k, v, bias, regions, out, N, P, C, heads, wpb, stages, copy,
      static_cast<float>(1.0 / sqrt((double)(C / heads))));
  return cudaGetLastError();
}

template <int NKC>
cudaError_t launch_mma_nkc(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                           const int* regions, bf16* out, int N, int P, int C, int heads, int copy,
                           cudaStream_t s) {
  switch ((C / heads + 15) / 16) {
    case 1: return launch_mma_dp<16, NKC>(q, k, v, bias, regions, out, N, P, C, heads, copy, s);
    case 2: return launch_mma_dp<32, NKC>(q, k, v, bias, regions, out, N, P, C, heads, copy, s);
    case 3: return launch_mma_dp<48, NKC>(q, k, v, bias, regions, out, N, P, C, heads, copy, s);
    case 4: return launch_mma_dp<64, NKC>(q, k, v, bias, regions, out, N, P, C, heads, copy, s);
    case 5: return launch_mma_dp<80, NKC>(q, k, v, bias, regions, out, N, P, C, heads, copy, s);
    case 6: return launch_mma_dp<96, NKC>(q, k, v, bias, regions, out, N, P, C, heads, copy, s);
    case 7: return launch_mma_dp<112, NKC>(q, k, v, bias, regions, out, N, P, C, heads, copy, s);
    case 8: return launch_mma_dp<128, NKC>(q, k, v, bias, regions, out, N, P, C, heads, copy, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_mma(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                       const int* regions, bf16* out, int N, int P, int C, int heads,
                       cudaStream_t s) {
  const int dh = C / heads;
  // the widest copy every head slice's rows allow (each row starts at an
  // element offset of a multiple of dh, and every row is C elements long)
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  const int copy = dh % 8 == 0 && addr % 16 == 0 ? kCopy16
                   : dh % 2 == 0 && addr % 4 == 0 ? kCopy4 : kCopy2;
  if (P <= 64) return launch_mma_nkc<4>(q, k, v, bias, regions, out, N, P, C, heads, copy, s);
  return launch_mma_nkc<9>(q, k, v, bias, regions, out, N, P, C, heads, copy, s);
}

}  // namespace
}  // namespace lc2

// q, k, v, out (N, P, C) contiguous, heads packed in C; bias (heads, P, P)
// f32; regions (N, P) int32 or null (no region masking).  1 <= P <= 144,
// 1 <= C / heads <= 128.  f32 runs the CUDA-core body, bf16 the tensor-core
// one.
extern "C" int lc2_window_attention(int dtype, const void* q, const void* k, const void* v,
                                    const void* bias, const void* regions, void* out, int N,
                                    int P, int C, int heads, void* stream) {
  if (N == 0) return cudaSuccess;
  if (N < 0 || P < 1 || P > lc2::kMaxP || heads < 1 || C % heads != 0 || C / heads < 1 ||
      C / heads > lc2::kMaxDh)
    return cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  const int* r = static_cast<const int*>(regions);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lc2::kF32)
    return lc2::launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), b, r, static_cast<float*>(out), N, P, C,
                           heads, s);
  if (dtype == lc2::kBF16) {
    using bf = __nv_bfloat16;
    return lc2::launch_mma(static_cast<const bf*>(q), static_cast<const bf*>(k),
                           static_cast<const bf*>(v), b, r, static_cast<bf*>(out), N, P, C, heads,
                           s);
  }
  return cudaErrorInvalidValue;
}
