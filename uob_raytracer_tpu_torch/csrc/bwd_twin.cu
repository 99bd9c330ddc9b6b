// The structure twin of the path-replay backward kernel, for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package's
// uob_raytracer_tpu/flops.py:build_bwd_structure_twin (make_kernel): a
// ceiling instrument that has the loop and memory structure of the
// backward kernel, driven by the same decision record, with the adjoint
// arithmetic replaced by calibration chains of a known length and blend.
// Its time is what the card needs for that structure at the backward's own
// operation count and dependency depth; the backward's time over it says
// how much of the backward's gap to its bound is its arithmetic.
//
// It mirrors the port's K2 as built (render_bwd.cu, bwd_body.cuh), not the
// TPU twin's presence-bit tile walk:
// - 128 threads a block, one thread per pixel, looping over its A rays;
//   threads past the ragged edge stay for the warp's shuffles;
// - the unified n_obj x 17 object table staged in shared memory, a row
//   gathered by id (-1: the miss row, zeros with mat 1); column 15 is the
//   object's material code and decides, as in K2, whether a ray's chain
//   goes on (mat <= 0); the other columns are calibration values;
// - the forward sweep over the bounce steps the record says the ray ran,
//   storing 12 floats a step into a per-thread array of kRegBounces;
// - the reverse sweep to the warp's deepest chain, reading them back;
// - the warp's 16-column shuffle butterfly per object it hit, into per-warp
//   accumulators in shared memory (warp_scatter of bwd_common.cuh, K2's
//   own);
// - the 21 camera columns, per-thread sums added by a butterfly at the end;
// - one partial row per block, [blocks, n_obj * 16 + 21], summed by the
//   wrapper's torch.sum; the 3-float replayed image.
// Column 15 of every scattered row is 1, so the partial sums count each
// object's visits exactly.
//
// The arithmetic is the bwdmix body of flops.py:_iter_ops (716-741): 17
// dependent operations, the last a divide where the schedule says so and a
// subtract elsewhere. It runs as the main chain, split around the sweeps
// (n_half iterations before, n_main - n_half after) with slots[it]
// independent accumulators an iteration and the divides of divs[it]; and as
// a chain of kStepAccs accumulators, n_step iterations, in each reverse
// step. The sizes come from flops.build_bwd_structure_twin at run time.
// Both halves are unrolled to their caps, so every accumulator lives in a
// register and no index is dynamic; an iteration jumps into a chain of slot
// bodies (run_slots, a jump table), so that a ray does not step through the
// guards of the slots the sizing leaves out: with a guard per slot, every
// ray walked all 144 bodies' code and the twin took 2.8 times as long at
// full_1024 (PERF.md).
//
// The working set: NPool snapshots of the first half's accumulators (each
// slot-iteration's result and its middle value s2) stay live until the end
// of the ray, where a tree of adds folds them into the
// image. The pool size is a template parameter (a runtime-sized pool would
// live in local memory): flops.build_bwd_structure_twin picks the smallest
// instance whose ptxas registers reach the backward kernel's.
//
// What bounds it: what bounds K2 — FP32 issue, the shuffle reductions and
// the per-thread chain storage; the record it reads and the partials it
// writes are small beside that.

#include "bwd_common.cuh"

namespace {

constexpr int kTwinHalf = 6;    // iterations of each half, at most
constexpr int kTwinSlots = 12;  // accumulators of one main iteration, at most
constexpr int kStepAccs = 4;    // the step chain's accumulators

// The twin's sizing, from flops.build_bwd_structure_twin. slots[i] and
// divs[i] (bit s: slot s divides) are iteration i of the first half for
// i < kTwinHalf, iteration i - kTwinHalf of the second half above.
struct TwinSizing {
  int n_half, n_second, n_step, pad;
  int slots[2 * kTwinHalf];
  unsigned divs[2 * kTwinHalf];
};

struct TwinDims {
  int rows, width, aa, bounces, n_obj;
};

// One bwdmix body (flops.py:_iter_ops): 17 dependent operations, the last
// a divide or a subtract; mid gets s2, a value the pool may keep.
__device__ __forceinline__ float twin_iter(float a, float x, bool use_div, float& mid) {
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
  float sl;
  if (use_div)
    sl = s3 / (t4 + 1.125f);
  else
    sl = s3 - t4;
  mid = s2;
  return m1 ? sl : a;
}

// Slots ns-1 .. 0 of one main iteration (each its own accumulator, so the
// order changes no value): a jump into a chain of bodies, so that no
// inactive slot costs an instruction.
#define TWIN_SLOT(S) \
  case (S) + 1:      \
    accs[S] = twin_iter(accs[S], x, (dm >> (S)) & 1u, mids[S]);
__device__ __forceinline__ void run_slots(float (&accs)[kTwinSlots], float (&mids)[kTwinSlots],
                                          float x, unsigned dm, int ns) {
  static_assert(kTwinSlots == 12, "one case per slot");
  switch (ns) {
    TWIN_SLOT(11) [[fallthrough]];
    TWIN_SLOT(10) [[fallthrough]];
    TWIN_SLOT(9) [[fallthrough]];
    TWIN_SLOT(8) [[fallthrough]];
    TWIN_SLOT(7) [[fallthrough]];
    TWIN_SLOT(6) [[fallthrough]];
    TWIN_SLOT(5) [[fallthrough]];
    TWIN_SLOT(4) [[fallthrough]];
    TWIN_SLOT(3) [[fallthrough]];
    TWIN_SLOT(2) [[fallthrough]];
    TWIN_SLOT(1) [[fallthrough]];
    TWIN_SLOT(0) [[fallthrough]];
    default:
      break;
  }
}
#undef TWIN_SLOT

// Object id's row of the staged table (-1: zeros, material code 1).
__device__ __forceinline__ void twin_row(const float* obj, int id, float (&r)[kObjCols]) {
  if (id < 0) {
#pragma unroll
    for (int c = 0; c < kObjCols; ++c) r[c] = c == 15 ? 1.0f : 0.0f;
    return;
  }
#pragma unroll
  for (int c = 0; c < kObjCols; ++c) r[c] = obj[id * kObjCols + c];
}

// A row of 16 cotangent columns as warp_scatter (bwd_common.cuh) takes it,
// in its column order: the twin scatters with K2's own code.
__device__ __forceinline__ RowGrad as_grad(const float (&v)[kGradCols]) {
  RowGrad g;
  g.v0 = make(v[0], v[1], v[2]);
  g.e1 = make(v[3], v[4], v[5]);
  g.e2 = make(v[6], v[7], v[8]);
  g.n = make(v[9], v[10], v[11]);
  g.rgb = make(v[12], v[13], v[14]);
  g.r2 = v[15];
  return g;
}

// Adds v[0..W) as a balanced tree, in place: pairs (0,1), (2,3), ... level
// by level, an odd last element carried up; the sum ends in v[0] (the
// plain version adds in the same order).
template <int W>
struct TreeSum {
  static __device__ __forceinline__ void fold(float* v) {
#pragma unroll
    for (int i = 0; i < W / 2; ++i) v[i] = v[2 * i] + v[2 * i + 1];
    if (W & 1) v[W / 2] = v[W - 1];
    TreeSum<(W + 1) / 2>::fold(v);
  }
};
template <>
struct TreeSum<1> {
  static __device__ __forceinline__ void fold(float*) {}
};

template <int NPool>
__global__ void __launch_bounds__(kThreads)
    bwd_twin_kernel(const float* __restrict__ table, const float* __restrict__ g_img,
                    const int* __restrict__ pid, const float* __restrict__ lit_in,
                    const int* __restrict__ bid, float* __restrict__ partial,
                    float* __restrict__ img, TwinDims D, TwinSizing T) {
  extern __shared__ float smem[];
  const int acc_cols = D.n_obj * kGradCols + kCamCols;
  float* obj = smem;
  float* acc = obj + D.n_obj * kObjCols;  // [kWarps][acc_cols]
  for (int i = threadIdx.x; i < D.n_obj * kObjCols; i += blockDim.x) obj[i] = table[i];
  for (int i = threadIdx.x; i < kWarps * acc_cols; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  float* wacc = acc + (threadIdx.x >> 5) * acc_cols;

  const int lane = threadIdx.x & 31;
  const size_t n_pix = (size_t)D.rows * D.width;
  const size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_img = p < n_pix;
  const float gx = in_img ? g_img[p * 3] : 0.0f;
  const int A = D.aa;

  float dcam[kCamCols];
#pragma unroll
  for (int i = 0; i < kCamCols; ++i) dcam[i] = 0.0f;
  float img_acc[3] = {0.0f, 0.0f, 0.0f};
  float saved[kRegBounces][12];
  int saved_id[kRegBounces];

  for (int a = 0; a < A; ++a) {
    const int id0 = in_img ? pid[a * n_pix + p] : -1;
    const float lit = in_img ? lit_in[a * n_pix + p] : 0.0f;
    float xs[kObjCols];
    twin_row(obj, id0, xs);
    const bool chain = id0 >= 0 && xs[15] <= 0.0f;
    xs[0] = (xs[0] + lit * 1e-6f) + gx * 1e-3f;

    float accs[kTwinSlots];
    accs[0] = xs[0];
#pragma unroll
    for (int s = 1; s < kTwinSlots; ++s) accs[s] = xs[0] * (float)(1.0 + 1e-6 * s);

    // --- first half of the main chain; the pool keeps its snapshots ---
    float pool[NPool > 0 ? NPool : 1];
#pragma unroll
    for (int it = 0; it < kTwinHalf; ++it) {
      const float x = xs[it % kObjCols];
      float mids[kTwinSlots];
#pragma unroll
      for (int s = 0; s < kTwinSlots; ++s) mids[s] = accs[s];
      if (it < T.n_half) run_slots(accs, mids, x, T.divs[it], T.slots[it]);
#pragma unroll
      for (int s = 0; s < kTwinSlots; ++s) {
        const int j = 2 * (it * kTwinSlots + s);
        if (j < NPool) pool[j] = accs[s];
        if (j + 1 < NPool) pool[j + 1] = mids[s];
      }
    }
    const float a_mid = accs[0];

    // --- forward sweep: the steps the record says this ray ran ---
    float carr = a_mid;
    int n_exec = 0;
    bool active = chain;
    while (active && n_exec < D.bounces) {
      const int idk = bid[((size_t)n_exec * A + a) * n_pix + p];
      float row[kObjCols];
      twin_row(obj, idk, row);
      float* sv = saved[n_exec];
#pragma unroll
      for (int c = 0; c < 11; ++c) sv[c] = row[c];
      sv[11] = carr;
      saved_id[n_exec] = idk;
      ++n_exec;
      carr = carr + row[0];
      active = idk >= 0 && row[15] <= 0.0f;
    }

    // --- reverse sweep, to the warp's deepest chain ---
    float dcarr = carr;
    int k_max = n_exec;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) k_max = max(k_max, __shfl_xor_sync(kFull, k_max, off));
    for (int k = k_max - 1; k >= 0; --k) {
      float gr[kGradCols];
#pragma unroll
      for (int c = 0; c < kGradCols; ++c) gr[c] = 0.0f;
      int sid = -1;
      if (k < n_exec) {
        const float* sv = saved[k];
        const int id = saved_id[k];
        float row[kObjCols];
        twin_row(obj, id, row);
        const float x = row[0];
        const float y = dcarr + sv[11];
        float sa[kStepAccs];
#pragma unroll
        for (int s = 0; s < kStepAccs; ++s) sa[s] = y * (float)(1.0 + 1e-7 * s);
#pragma unroll 1
        for (int t = 0; t < T.n_step; ++t) {
#pragma unroll
          for (int s = 0; s < kStepAccs; ++s) {
            float mid;
            sa[s] = twin_iter(sa[s], x, s == 0 || s == 3, mid);
          }
        }
#pragma unroll
        for (int c = 0; c < 12; ++c) gr[c] = sa[c & 3] * sv[c];
#pragma unroll
        for (int c = 12; c < 15; ++c) gr[c] = sa[c & 3];
        gr[15] = 1.0f;
        dcarr = sa[0];
        sid = id;
      }
      warp_scatter(wacc, sid, as_grad(gr));
    }

    // --- second half of the main chain ---
    accs[0] = dcarr + a_mid;
#pragma unroll
    for (int i2 = 0; i2 < kTwinHalf; ++i2) {
      const float x = xs[(kTwinHalf + i2) % kObjCols];
      float mids[kTwinSlots];
      if (i2 < T.n_second)
        run_slots(accs, mids, x, T.divs[kTwinHalf + i2], T.slots[kTwinHalf + i2]);
    }

    // --- the primary site's scatter, the camera, the image ---
    {
      float gr[kGradCols];
#pragma unroll
      for (int c = 0; c < 15; ++c) gr[c] = accs[c % kTwinSlots];
      gr[15] = 1.0f;
      warp_scatter(wacc, id0, as_grad(gr));
    }
#pragma unroll
    for (int c = 0; c < kCamCols; ++c) dcam[c] = dcam[c] + (accs[c % kTwinSlots] + a_mid);
    float pacc = accs[0];
    if constexpr (NPool > 0) {
      TreeSum<NPool>::fold(pool);
      pacc = pacc + pool[0];
    }
    const float pe = pacc * 1e-6f;
#pragma unroll
    for (int c = 0; c < 3; ++c) img_acc[c] = img_acc[c] + (accs[c] + pe);
  }

  if (in_img) {
    const float fA = (float)A;
    img[p * 3 + 0] = img_acc[0] / fA;
    img[p * 3 + 1] = img_acc[1] / fA;
    img[p * 3 + 2] = img_acc[2] / fA;
  }

  // --- camera columns: warp butterfly into the warp's 21 sums ---
#pragma unroll
  for (int i = 0; i < kCamCols; ++i) {
    float s = dcam[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    if (lane == 0) wacc[D.n_obj * kGradCols + i] = s;
  }

  // --- the block's partial row: its warps' accumulators added in order ---
  __syncthreads();
  float* out = partial + (size_t)blockIdx.x * acc_cols;
  for (int i = threadIdx.x; i < acc_cols; i += blockDim.x) {
    float s = acc[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += acc[w * acc_cols + i];
    out[i] = s;
  }
}

using TwinFn = void (*)(const float*, const float*, const int*, const float*, const int*, float*,
                        float*, TwinDims, TwinSizing);

TwinFn pick_twin(int n_pool) {
  switch (n_pool) {
    case 0: return bwd_twin_kernel<0>;
    case 32: return bwd_twin_kernel<32>;
    case 64: return bwd_twin_kernel<64>;
    case 96: return bwd_twin_kernel<96>;
    case 128: return bwd_twin_kernel<128>;
    default: return nullptr;
  }
}

}  // namespace

// One launch of bwd_twin_kernel<n_pool> on `stream`. dims = {rows, width,
// aa, bounces, n_obj}; sizing = {n_half, n_second, n_step, slots[12],
// divs[12]} (HOST arrays, laid out as TwinSizing). table [n_obj, 17];
// g [rows, W, 3]; pid, lit [A, rows, W]; bid [bounces, A, rows, W] (may be
// null when bounces == 0); partial [ceil(rows*W / 128), n_obj*16 + 21] and
// img [rows, W, 3] are overwritten. Returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for a pool without an instance, a
// sizing past the caps, or more bounces than the chain storage holds.
extern "C" int bwd_twin_launch(int n_pool, const float* table, const float* g, const int* pid,
                               const float* lit, const int* bid, float* partial, float* img,
                               const int* dims, const int* sizing, void* stream) {
  const TwinFn fn = pick_twin(n_pool);
  TwinDims D;
  D.rows = dims[0];
  D.width = dims[1];
  D.aa = dims[2];
  D.bounces = dims[3];
  D.n_obj = dims[4];
  TwinSizing T;
  T.n_half = sizing[0];
  T.n_second = sizing[1];
  T.n_step = sizing[2];
  T.pad = 0;
  for (int i = 0; i < 2 * kTwinHalf; ++i) {
    T.slots[i] = sizing[3 + i];
    T.divs[i] = (unsigned)sizing[3 + 2 * kTwinHalf + i];
    if (T.slots[i] < 0 || T.slots[i] > kTwinSlots) return (int)cudaErrorInvalidValue;
  }
  if (fn == nullptr || D.bounces > kRegBounces || T.n_half > kTwinHalf ||
      T.n_second > kTwinHalf || T.n_half < 0 || T.n_second < 0 || T.n_step < 0)
    return (int)cudaErrorInvalidValue;
  const long long n_pix = (long long)D.rows * D.width;
  if (n_pix == 0) return 0;
  const size_t smem =
      sizeof(float) * ((size_t)D.n_obj * kObjCols + kWarps * ((size_t)D.n_obj * kGradCols + kCamCols));
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((n_pix + kThreads - 1) / kThreads);
  fn<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(table, g, pid, lit, bid, partial, img, D, T);
  return (int)cudaGetLastError();
}
