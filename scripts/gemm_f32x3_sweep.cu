// The 3xTF32 GEMM of lc2is_tpu_torch/csrc/gemm_f32x3.cuh against the
// variants its design was chosen over, on one NVIDIA GPU (sm_90a): the two
// tile shapes the header launches (gemm32::launch), then a copy of its main
// loop with knobs: each 32-wide k-slice summed into fresh accumulators and
// added in f32 ("promote", the header's choice) or every product chained into
// one accumulator; hi by the header's two integer operations or by
// cvt.rna.tf32.f32; and no split at all (the raw f32 bits as one TF32
// operand, three products still issued: the rate of the loop's structure,
// not an f32 result).  Prints ms, TFLOP/s of f32-accurate products, the TF32
// rate (three products each) and max |Δ| / max |ref| against a double
// reference on 16 rows.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//     -o build/gemm_f32x3_sweep scripts/gemm_f32x3_sweep.cu && build/gemm_f32x3_sweep
#include <cmath>
#include <cstdio>
#include <tuple>
#include <vector>

#include "../lc2is_tpu_torch/csrc/gemm_f32x3.cuh"

using namespace lc2;
using namespace lc2::gemm32;

enum SplitMode { kHeader = 0, kCvt = 1, kNone = 2 };

template <int MODE>
__device__ __forceinline__ void split_as(float a, uint32_t& hi, uint32_t& lo) {
  if constexpr (MODE == kHeader) {
    split(a, hi, lo);
  } else if constexpr (MODE == kCvt) {
    hi = tf32_rna(a);
    lo = tf32_rna(a - __uint_as_float(hi));
  } else {
    hi = lo = __float_as_uint(a);
  }
}

// The header's kernel loop (128 x 64 or 64 x 64 tiles, 2 x 2 warps) with the
// split and the promotion as template knobs; no epilogue terms.
template <int BM, int BN, int MODE, bool kPromote>
__global__ void __launch_bounds__(128)
variant(int M, int N, int K, const float* __restrict__ a, const float* __restrict__ b,
        float* __restrict__ out) {
  constexpr int TM = BM / 2, TN = BN / 2, MI = TM / 16, NI = TN / 8;
  constexpr int kStage = (BM + BN) * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * TM, wn = (warp & 1) * TN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_slices = (K + kBK - 1) / kBK;
  auto issue = [&](int s) {
    if (s < n_slices) {
      float* st = ring + (s % kStages) * kStage;
      load_slice<BM, 128>(a, K, m0, M, s * kBK, K, st);
      load_slice<BN, 128>(b, K, n0, N, s * kBK, K, st + BM * kLd);
    }
    mma::cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  float acc[MI][NI][4] = {};
  const int g = lane >> 2, t = lane & 3;
  for (int s = 0; s < n_slices; ++s) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(s + kStages - 1);
    const float* as = ring + (s % kStages) * kStage + (wm + g) * kLd + 2 * t;
    const float* bs = ring + (s % kStages) * kStage + (BM + wn + g) * kLd + 2 * t;
    float part[MI][NI][4] = {};
    float (&c)[MI][NI][4] = kPromote ? part : acc;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      Split<4> af[MI];
      Split<2> bf[NI];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const float2 w = *reinterpret_cast<const float2*>(bs + 8 * j * kLd + kk);
        split_as<MODE>(w.x, bf[j].hi[0], bf[j].lo[0]);
        split_as<MODE>(w.y, bf[j].hi[1], bf[j].lo[1]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float2 r = *reinterpret_cast<const float2*>(as + 16 * i * kLd + kk);
        const float2 r8 = *reinterpret_cast<const float2*>(as + (16 * i + 8) * kLd + kk);
        split_as<MODE>(r.x, af[i].hi[0], af[i].lo[0]);
        split_as<MODE>(r8.x, af[i].hi[1], af[i].lo[1]);
        split_as<MODE>(r.y, af[i].hi[2], af[i].lo[2]);
        split_as<MODE>(r8.y, af[i].hi[3], af[i].lo[3]);
      }
      mma_x3(c, af, bf);
    }
    if (kPromote) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    }
  }
  mma::cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + wm + 16 * i + g + 8 * r;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = n0 + wn + 8 * j + 2 * t;
        if (n < N)
          *reinterpret_cast<float2*>(out + (long long)m * N + n) =
              make_float2(acc[i][j][2 * r], acc[i][j][2 * r + 1]);
      }
    }
}

struct Problem {
  int M, N, K;
  const float *a, *b;
  float* out;
  const std::vector<double>* ref;
};

template <typename F>
void report(const char* name, const Problem& p, F launch_once) {
  for (int i = 0; i < 3; ++i) launch_once();
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  const int reps = 20;
  for (int i = 0; i < reps; ++i) launch_once();
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  ms /= reps;
  const cudaError_t err = cudaGetLastError();
  std::vector<float> h(p.ref->size());
  cudaMemcpy(h.data(), p.out, h.size() * 4, cudaMemcpyDeviceToHost);
  double d = 0, r = 0;
  for (size_t i = 0; i < h.size(); ++i) {
    d = fmax(d, fabs(h[i] - (*p.ref)[i]));
    r = fmax(r, fabs((*p.ref)[i]));
  }
  const double flops = 2.0 * p.M * p.N * (double)p.K;
  printf("%-34s M %6d N %5d K %5d: %7.3f ms %5.1f TFLOP/s (TF32 %6.1f) max|d|/max|ref| %.2e %s\n",
         name, p.M, p.N, p.K, ms, flops / ms / 1e9, 3 * flops / ms / 1e9, d / r,
         err == cudaSuccess ? "" : cudaGetErrorString(err));
}

template <int BM, int BN, int MODE, bool kPromote>
void run_variant(const char* name, const Problem& p) {
  constexpr size_t smem = sizeof(float) * kStages * (BM + BN) * kLd;
  auto kern = variant<BM, BN, MODE, kPromote>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  report(name, p, [&] { kern<<<grid, 128, smem>>>(p.M, p.N, p.K, p.a, p.b, p.out); });
}

template <int BM, int BN>
void run_header(const char* name, const Problem& p) {
  const Epilogue ep{nullptr, nullptr, p.out, p.N};
  report(name, p, [&] { launch<BM, BN, false>(p.M, p.N, p.K, p.a, p.K, p.b, p.K, ep, 0); });
}

int main() {
  const std::vector<std::tuple<int, int, int>> shapes = {
      {65536, 512, 2048}, {65536, 2048, 512}, {4096, 512, 2048}, {2416, 512, 2048},
      {2416, 2048, 512}};
  for (auto [M, N, K] : shapes) {
    std::vector<float> ha((size_t)M * K), hb((size_t)N * K);
    unsigned s = 1;
    auto uni = [&] {
      s = s * 1664525u + 1013904223u;
      return ((s >> 8) / 16777216.0f) * 2.f - 1.f;
    };
    for (auto& x : ha) x = uni();
    for (auto& x : hb) x = uni() / sqrtf((float)K);
    const int rows = 16;
    std::vector<double> ref((size_t)rows * N);
    for (int m = 0; m < rows; ++m)
      for (int n = 0; n < N; ++n) {
        double acc = 0;
        for (int k = 0; k < K; ++k) acc += (double)ha[(size_t)m * K + k] * hb[(size_t)n * K + k];
        ref[(size_t)m * N + n] = acc;
      }
    float *a, *b, *o;
    cudaMalloc(&a, ha.size() * 4);
    cudaMalloc(&b, hb.size() * 4);
    cudaMalloc(&o, (size_t)M * N * 4);
    cudaMemcpy(a, ha.data(), ha.size() * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(b, hb.data(), hb.size() * 4, cudaMemcpyHostToDevice);
    const Problem p{M, N, K, a, b, o, &ref};
    run_header<128, 64>("header 128x64", p);
    run_header<64, 64>("header 64x64", p);
    run_variant<128, 64, kHeader, false>("128x64, one accumulator chain", p);
    run_variant<128, 64, kCvt, true>("128x64, hi by cvt.rna", p);
    run_variant<128, 64, kNone, true>("128x64, no split (TF32 rate)", p);
    run_variant<64, 64, kNone, true>("64x64, no split (TF32 rate)", p);
    cudaFree(a);
    cudaFree(b);
    cudaFree(o);
  }
  return 0;
}
