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
// It mirrors one launch of the port's K2 chain kernel over every pixel
// (render_bwd.cu, bwd_body.cuh: the design before PR 7 split K2 by the
// record into a chain-free launch and a chain launch, and the one K2 keeps
// past 32 objects), with K2's scatter and camera sums; not the TPU twin's
// presence-bit tile walk. So twin / K2 is now the one-launch
// structure against the split K2:
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
// - the 21 camera columns, per-thread sums added by a butterfly at the end
//   (warp_camera, K2's own);
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
// The split instances (bwd_twin_split_kernel<Var, MinBlocks>, pool 64:
// the pool K7 takes at full_1024) change one piece of that structure at a
// time: no shuffles in the scatter and the camera sums, no chain storage
// and no bounce sweeps, ptxas held to 4 or 5 blocks an SM. Their times
// beside K7's (chip_timing.py --split) said where K2's time went and set
// K2's redesign (PERF.md). The body is shared as text (twin_body.cuh) so
// that K7 compiles as before.
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

// The split instances (bwd_twin_split_kernel<Var, MinBlocks>): the
// pieces of K2's structure, one at a time, on K7's pool of kSplitPool.
constexpr int kTwinAsK2 = 0;     // K2's structure
constexpr int kTwinNoShfl = 1;   // no shuffles: lane 0 adds its own rows
constexpr int kTwinNoChain = 2;  // no chain storage, no bounce sweeps
constexpr int kSplitPool = 64;   // the pool K7 takes at full_1024

// A row's scatter in instance Var: K2's warp_scatter, or, with no
// shuffles, lane 0 adding its own row (the other lanes' rows are dropped).
template <int Var>
__device__ __forceinline__ void twin_scatter(float* wacc, int id, const RowGrad& g) {
  if constexpr (Var == kTwinNoShfl) {
    if ((threadIdx.x & 31) == 0 && id >= 0) {
      const float v[kGradCols] = {g.v0.x, g.v0.y, g.v0.z, g.e1.x,  g.e1.y,  g.e1.z,
                                  g.e2.x, g.e2.y, g.e2.z, g.n.x,   g.n.y,   g.n.z,
                                  g.rgb.x, g.rgb.y, g.rgb.z, g.r2};
#pragma unroll
      for (int c = 0; c < kGradCols; ++c) wacc[id * kGradCols + c] += v[c];
    }
  } else {
    warp_scatter(wacc, id, g);
  }
}

template <int NPool>
__global__ void __launch_bounds__(kThreads)
    bwd_twin_kernel(const float* __restrict__ table, const float* __restrict__ g_img,
                    const int* __restrict__ pid, const float* __restrict__ lit_in,
                    const int* __restrict__ bid, float* __restrict__ partial,
                    float* __restrict__ img, TwinDims D, TwinSizing T) {
  constexpr int Var = kTwinAsK2;
#include "twin_body.cuh"
}

// Instruments of the split only: K7's body with one piece of K2's
// structure removed (Var) or with ptxas held to MinBlocks blocks an SM.
template <int Var, int MinBlocks>
__global__ void __launch_bounds__(kThreads, MinBlocks)
    bwd_twin_split_kernel(const float* __restrict__ table, const float* __restrict__ g_img,
                          const int* __restrict__ pid, const float* __restrict__ lit_in,
                          const int* __restrict__ bid, float* __restrict__ partial,
                          float* __restrict__ img, TwinDims D, TwinSizing T) {
  constexpr int NPool = kSplitPool;
#include "twin_body.cuh"
}

using TwinFn = void (*)(const float*, const float*, const int*, const float*, const int*, float*,
                        float*, TwinDims, TwinSizing);

// K7 of pool n_pool (split 0), or split instance 1 (no shuffles), 2 (no
// chain), 3 (at least 4 blocks an SM) or 4 (5 blocks) of pool kSplitPool.
TwinFn pick_twin(int n_pool, int split) {
  if (split != 0) {
    if (n_pool != kSplitPool) return nullptr;
    switch (split) {
      case 1: return bwd_twin_split_kernel<kTwinNoShfl, 1>;
      case 2: return bwd_twin_split_kernel<kTwinNoChain, 1>;
      case 3: return bwd_twin_split_kernel<kTwinAsK2, 4>;
      case 4: return bwd_twin_split_kernel<kTwinAsK2, 5>;
      default: return nullptr;
    }
  }
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

// One launch of bwd_twin_kernel<n_pool> (split 0) or of split instance
// `split` (pick_twin) on `stream`. dims = {rows, width,
// aa, bounces, n_obj}; sizing = {n_half, n_second, n_step, slots[12],
// divs[12]} (HOST arrays, laid out as TwinSizing). table [n_obj, 17];
// g [rows, W, 3]; pid, lit [A, rows, W]; bid [bounces, A, rows, W] (may be
// null when bounces == 0); partial [ceil(rows*W / 128), n_obj*16 + 21] and
// img [rows, W, 3] are overwritten. Returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for a pool or split without an instance, a
// sizing past the caps, or more bounces than the chain storage holds.
extern "C" int bwd_twin_launch(int n_pool, int split, const float* table, const float* g,
                               const int* pid, const float* lit, const int* bid, float* partial,
                               float* img, const int* dims, const int* sizing, void* stream) {
  const TwinFn fn = pick_twin(n_pool, split);
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
