// FP32 peak calibration chains for Hopper (sm_90a), and the census probe.
//
// peak_chain<Mode, K> replaces the TPU kernel of the JAX package's
// uob_raytracer_tpu/flops.py:measure_vpu_peak (make_kernel): per element
// of a float32 input, K independent accumulators, initialised to
// x * (1 + 1e-7 k), run kInner = 500 iterations of the mode's body, and the
// output is their sum, so that no accumulator is dead code. x comes from
// memory, so nothing folds to a constant. Modes:
//   0 fma     a * x + 1e-7 as one fused multiply-add (__fmaf_rn; the build
//             is --fmad=false, so a written-out a * x + c would be a
//             multiply and an add)
//   1 add     a + x
//   2 mix     the 17-op body of flops.py:503-523
//   3 bwdmix  the 17-op body of flops.py:_bwdmix_iter (412-450), with its
//             slow-op slot by accumulator: a divide where k % 16 is 0, 3, 6,
//             9 or 12, abs + sqrt where it is 15, a subtract elsewhere
// One thread per element, 128 threads a block (a 512x512 input is 2,048
// blocks), so the K accumulators are the only instruction-level
// parallelism a thread has; the card's warps hide the rest. Each trip of
// the loop runs kUnroll<K> iterations (20, 20, 10, 4, 2, 1 for K = 1 ..
// 32; each divides 500), so that the loop's counter, compare and branch
// cost under a tenth of a trip; flops.sass_census counts the instructions
// of that trip, and kernels/peak.py:UNROLL divides them by these numbers.
//
// What bounds it: FP32 issue, by design (operations). The division and
// the square root are IEEE (no fast math), so each is a short sequence of
// instructions, not one.
//
// census_probe_kernel is the counterpart of the JAX test fixture
// tests/test_flops.py:_tiny_pallas with the body of
// test_census_counts_known_kernel: y = x, then five y = y * x and three
// y = y + x. Its SASS must hold 5 FMUL and 3 FADD: the 8 operations per
// element that the JAX package's jaxpr census counts for the same body.
//
// floor_kernel<Copy> is the launch floor the probe's time is held
// against, on the probe's grid: with Copy false it does nothing, with Copy
// true it only copies x to out (the probe's load and store without its 8
// operations).

#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kPeakThreads = 128;
constexpr int kInner = 500;

__device__ __forceinline__ float mix_iter(float a, float x) {
  const float h = 0.5f;
  const float t1 = a * x;
  const float t2 = t1 * x;
  const float t3 = a * h;
  const float s1 = t1 + t2;
  const bool m1 = s1 >= t3;
  const bool m2 = t2 < a;
  const bool m3 = m1 & m2;
  const float d = t3 - t1;
  const float n1 = -d;
  const float w = m3 ? n1 : t2;
  const float t4 = w * x;
  const float t5 = t4 * h;
  const float s2 = w + t5;
  const bool m4 = s2 != x;
  const float t6 = fmaxf(s2, t4);  // jnp.maximum; no operand is ever NaN
  return (m4 ? t6 : a) * 0.999f;
}

// The bwdmix body for accumulator k (its slow-op slot is fixed by k).
__device__ __forceinline__ float bwdmix_iter(float a, float x, int k) {
  const float h = 0.5f;
  const float t1 = a * x;
  const bool m1 = t1 < x;
  const float w1 = m1 ? t1 : a;
  const float t2 = w1 * h;
  const float s1 = t2 + x;
  const float w2 = m1 ? s1 : t2;
  const float n1 = -w2;
  const float w3 = m1 ? n1 : s1;
  const float s2 = w3 + t1;
  const float w4 = m1 ? s2 : w3;
  const float t3 = w4 * x;
  const float w5 = m1 ? t3 : w4;
  const float s3 = w5 + t2;
  const float w6 = m1 ? s3 : w5;
  const float t4 = w6 * h;
  const int slot = k % 16;
  float sl;
  if (slot == 0 || slot == 3 || slot == 6 || slot == 9 || slot == 12)
    sl = s3 / (t4 + 1.125f);
  else if (slot == 15)
    sl = sqrtf(fabsf(t4));
  else
    sl = s3 - t4;
  return m1 ? sl : a;
}

template <int Mode>
__device__ __forceinline__ float chain_step(float a, float x, int k) {
  if (Mode == 0) return __fmaf_rn(a, x, 1e-7f);
  if (Mode == 1) return a + x;
  if (Mode == 2) return mix_iter(a, x);
  return bwdmix_iter(a, x, k);
}

// Iterations a trip of the loop (kernels/peak.py:UNROLL holds the same).
template <int K>
constexpr int kUnroll = K == 1 ? 20 : K == 2 ? 20 : K == 4 ? 10 : K == 8 ? 4 : K == 16 ? 2 : 1;

template <int Mode, int K>
__global__ void __launch_bounds__(kPeakThreads)
    peak_chain(const float* __restrict__ x_in, float* __restrict__ out, int n) {
  static_assert(kInner % kUnroll<K> == 0, "a trip's iterations divide kInner");
  const int i = blockIdx.x * kPeakThreads + threadIdx.x;
  if (i >= n) return;
  const float x = x_in[i];
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = x * (float)(1.0 + 1e-7 * k);
#pragma unroll 1
  for (int trip = 0; trip < kInner / kUnroll<K>; ++trip) {
#pragma unroll
    for (int u = 0; u < kUnroll<K>; ++u) {
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = chain_step<Mode>(acc[k], x, k);
    }
  }
  float s = acc[0];
#pragma unroll
  for (int k = 1; k < K; ++k) s = s + acc[k];
  out[i] = s;
}

__global__ void __launch_bounds__(kPeakThreads)
    census_probe_kernel(const float* __restrict__ x_in, float* __restrict__ out, int n) {
  const int i = blockIdx.x * kPeakThreads + threadIdx.x;
  if (i >= n) return;
  const float x = x_in[i];
  float y = x;
#pragma unroll
  for (int j = 0; j < 5; ++j) y = y * x;
#pragma unroll
  for (int j = 0; j < 3; ++j) y = y + x;
  out[i] = y;
}

// A launch that does no work (Copy false) or only the probe's load and
// store (Copy true), on the census probe's grid.
template <bool Copy>
__global__ void __launch_bounds__(kPeakThreads)
    floor_kernel(const float* __restrict__ x_in, float* __restrict__ out, int n) {
  if constexpr (Copy) {
    const int i = blockIdx.x * kPeakThreads + threadIdx.x;
    if (i < n) out[i] = x_in[i];
  }
}

using PeakFn = void (*)(const float*, float*, int);

template <int Mode>
PeakFn pick(int k) {
  switch (k) {
    case 1: return peak_chain<Mode, 1>;
    case 2: return peak_chain<Mode, 2>;
    case 4: return peak_chain<Mode, 4>;
    case 8: return peak_chain<Mode, 8>;
    case 16: return peak_chain<Mode, 16>;
    case 32: return peak_chain<Mode, 32>;
    default: return nullptr;
  }
}

}  // namespace

// One launch of peak_chain<mode, k> over x[n] into out[n] on `stream`.
// mode 0..3 (fma, add, mix, bwdmix), k in {1, 2, 4, 8, 16, 32}. Returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for a mode or
// k without an instance.
extern "C" int peak_chain_launch(int mode, int k, const float* x, float* out, int n,
                                 void* stream) {
  PeakFn fn = mode == 0   ? pick<0>(k)
              : mode == 1 ? pick<1>(k)
              : mode == 2 ? pick<2>(k)
              : mode == 3 ? pick<3>(k)
                          : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kPeakThreads - 1) / kPeakThreads);
  fn<<<blocks, kPeakThreads, 0, (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

// One launch of census_probe_kernel over x[n] into out[n] on `stream`.
extern "C" int census_probe_launch(const float* x, float* out, int n, void* stream) {
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kPeakThreads - 1) / kPeakThreads);
  census_probe_kernel<<<blocks, kPeakThreads, 0, (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

// One launch of floor_kernel<copy> over x[n] (into out[n] when copy) on
// the grid census_probe_launch takes for n elements, on `stream`.
extern "C" int floor_launch(int copy, const float* x, float* out, int n, void* stream) {
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kPeakThreads - 1) / kPeakThreads);
  if (copy)
    floor_kernel<true><<<blocks, kPeakThreads, 0, (cudaStream_t)stream>>>(x, out, n);
  else
    floor_kernel<false><<<blocks, kPeakThreads, 0, (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}
