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
// It mirrors the port's K2 (render_bwd.cu) launch for launch, by the same
// rule (kernels/render_bwd.py:splits), not the TPU twin's presence-bit
// tile walk:
// - bwd_twin_free_kernel<NPool>, the twin of render_bwd_free_kernel: one
//   thread per pixel looping over its A rays, 4 blocks an SM (ptxas held
//   to 128 registers, as K2f); no chain storage and no step code. It runs
//   on K2f's grid of tile ranges (kernels/render_bwd.py:free_grid, the
//   same blocks and tiles a block as K2f on the same frame): block b takes
//   the contiguous 128-pixel tiles b * T ..., stages its table and zeroes
//   its accumulators once, flags the pixels of all its tiles in one
//   pre-pass (those with a ray whose primary object is specular, when the
//   config bounces; the ballots kept per tile in shared memory) and writes
//   each tile's list and count exactly as K2f writes them. A lane's pixel
//   in the next tile lies 128 pixels on; the lane carries its primary
//   site's row from ray to ray and from tile to tile while its object
//   repeats, the warp scattering when some lane's object changes and once
//   after the block's last tile (K2f's carry); a warp with no pixel in a
//   tile skips it; the camera terms add up over all the block's pixels,
//   then one warp_camera and one partial row a block (zeros for a block
//   with no pixel to run).
// - bwd_twin_chain_kernel<NPool>, the twin of render_bwd_kernel<false>:
//   one thread per AA ray, 3 blocks an SM (168 registers, as K2c). The
//   grid walks chunks of twin_ppb(A) pixels, block b taking chunks b, b +
//   grid, ...; in a chunk ray a of pixel l is item a * ppb + l, and thread
//   t takes items t, t + 128, ..., so a warp holds one AA index of 32
//   pixels. With the free twin's list (and off, the inclusive sums of its
//   counts, from the wrapper's cumsum on the device) each ray finds its
//   pixel by K2c's binary search; without it (below a million rays, past
//   32 objects, at 0 bounces) every pixel is walked, one block a chunk.
//   The camera row is read from shared memory for each ray; the bounce
//   chain (12 floats a step) lives in a per-thread array of kRegBounces
//   steps; the rays' image terms meet in shared memory and one thread per
//   pixel adds them in ray order.
// Both: the unified n_obj x 17 object table staged in shared memory, a row
// gathered by id (-1: the miss row, zeros with mat 1); column 15 is the
// object's material code and decides, as in K2, whether a ray's chain goes
// on (mat <= 0); the other columns are calibration values, and the camera
// row is the table's first 21 values (staged apart, as K2 stages its
// camera row). K2's warp_scatter and warp_camera (bwd_common.cuh) do the
// sums; one partial row per block, [blocks, n_obj * 16 + 21], summed by the
// wrapper's torch.sum over both launches; the 3-float replayed image.
// Column 15 of every scattered row is 1, so the partial sums count each
// object's visits exactly.
//
// What one ray computes is twin_ray.cuh: the bwdmix body of
// flops.py:_iter_ops (716-741), 17 dependent operations, the last a divide
// where the schedule says so and a subtract elsewhere. It runs as the main
// chain, split around the sweeps (n_half iterations before, n_main -
// n_half after) with slots[it] independent accumulators an iteration and
// the divides of divs[it]; and as a chain of kStepAccs accumulators, n_step
// iterations, in each reverse step. The sizes come from
// flops.build_bwd_structure_twin at run time, one sizing a launch. Both
// halves are unrolled to their caps, so every accumulator lives in a
// register and no index is dynamic; an iteration jumps into a chain of
// slot bodies (run_slots, a jump table), so that a ray does not step
// through the guards of the slots the sizing leaves out: with a guard per
// slot, every ray walked all 144 bodies' code and the twin took 2.8 times
// as long at full_1024 (PERF.md).
//
// The working set: NPool snapshots of the first half's accumulators (each
// slot-iteration's result and its middle value s2) stay live until the end
// of the ray, where a tree of adds folds them into the image. The pool
// size is a template parameter (a runtime-sized pool would live in local
// memory): flops.build_bwd_structure_twin picks, for each launch, the
// smallest instance whose ptxas registers reach that K2 launch's.
//
// The split instances (bwd_twin_split_kernel<Var, MinBlocks>, pool
// kSplitPool: the pool the chain twin takes at full_1024) change one piece
// of the chain twin at a time: no shuffles in the scatter and the camera
// sums; no chain storage (every step kept in one slot of registers, the
// sweeps run as before); no binary search (each chunk's pixels read from an
// array the wrapper compacts from the list); ptxas held to 4 blocks an SM.
// Their times beside the chain twin's and K2c's (chip_timing.py --split
// k2k5) say how much of K2c's time each piece holds (PERF.md).
//
// What bounds it: what bounds K2 — FP32 issue, the shuffle reductions and
// the per-thread chain storage; the record it reads and the partials it
// writes are small beside that.

#include "bwd_common.cuh"

namespace {

constexpr int kTwinHalf = 6;    // iterations of each half, at most
constexpr int kTwinSlots = 12;  // accumulators of one main iteration, at most
constexpr int kStepAccs = 4;    // the step chain's accumulators
// Blocks an SM the launches are held to: K2's own (render_bwd.cu:
// kFreeBlocks, kChainBlocks), so ptxas caps the twins' registers as K2's.
constexpr int kTwinFreeBlocks = 4;
constexpr int kTwinChainBlocks = 3;
// The most tiles a block of the free twin takes (render_bwd.cu:
// kFreeMaxTiles).
constexpr int kTwinFreeMaxTiles = 1024;

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

// Pixels of one chunk of the chain twin: 32 * 4 / gcd(A, 4), the fewest
// whole warps of pixels whose A rays fill whole rounds of kThreads threads
// (K2c's pixels_per_block).
__host__ __device__ inline int twin_ppb(int A) {
  return A % 4 == 0 ? 32 : (A % 2 == 0 ? 64 : 128);
}

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

// The chain twin's instances: K7c itself and the split instances, each
// with one piece of K2c's structure changed, on the pool kSplitPool.
constexpr int kTwinAsK2 = 0;       // K2c's structure
constexpr int kTwinNoShfl = 1;     // no shuffles: lane 0 adds its own rows
constexpr int kTwinNoChain = 2;    // no chain storage: every step in slot 0
constexpr int kTwinNoSearch = 3;   // no binary search: the pixels precomputed
constexpr int kSplitPool = 64;     // the pool the chain twin takes at full_1024

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

// The primary site's scatter in the free twin (K2f's carry): a lane holds
// its row back while its object repeats from ray to ray, and the warp
// scatters only when some lane's object changes. All 32 lanes call it.
__device__ __forceinline__ void carry_scatter(float* wacc, RowGrad& carry, int& carry_id, int id,
                                              const RowGrad& g) {
  const bool change = carry_id >= 0 && id >= 0 && id != carry_id;
  if (__any_sync(kFull, change)) warp_scatter(wacc, change ? carry_id : -1, carry);
  if (id >= 0) {
    carry = id == carry_id ? add_grad(carry, g) : g;
    carry_id = id;
  }
}

// The block's partial row as zeros, for a block with no pixel to run.
__device__ __forceinline__ void twin_zero_partial_row(float* partial, const TwinDims& D) {
  const int cols = D.n_obj * kGradCols + kCamCols;
  for (int i = threadIdx.x; i < cols; i += blockDim.x) partial[(size_t)blockIdx.x * cols + i] = 0.0f;
}

// Stages the object table and the camera row (the table's first 21
// values) and zeroes the warps' accumulators; declares acc_cols, obj, cam,
// acc and this warp's accumulator wacc.
#define TWIN_STAGE()                                                                    \
  extern __shared__ float smem[];                                                       \
  const int acc_cols = D.n_obj * kGradCols + kCamCols;                                  \
  float* obj = smem;                                                                    \
  float* cam = obj + D.n_obj * kObjCols;                                                \
  float* acc = cam + kCamCols; /* [kWarps][acc_cols] */                                 \
  for (int i = threadIdx.x; i < D.n_obj * kObjCols; i += blockDim.x) obj[i] = table[i]; \
  for (int i = threadIdx.x; i < kCamCols; i += blockDim.x)                              \
    cam[i] = table[i % (D.n_obj * kObjCols)];                                           \
  for (int i = threadIdx.x; i < kWarps * acc_cols; i += blockDim.x) acc[i] = 0.0f;      \
  __syncthreads();                                                                      \
  float* wacc = acc + (threadIdx.x >> 5) * acc_cols

// The block's partial row: its warps' accumulators added in order.
#define TWIN_WRITE_PARTIAL_ROW()                                                   \
  __syncthreads();                                                                 \
  float* out = partial + (size_t)blockIdx.x * acc_cols;                            \
  for (int i = threadIdx.x; i < acc_cols; i += blockDim.x) {                       \
    float s = acc[i];                                                              \
    _Pragma("unroll") for (int w = 1; w < kWarps; ++w) s += acc[w * acc_cols + i]; \
    out[i] = s;                                                                    \
  }

// K2f's twin: the pixels none of whose rays has a chain, block b over the
// tiles b * T ... (b + 1) * T - 1 (T = tiles_per_block), as
// render_bwd_free_kernel takes them. Tile t's pixels left out go, in order,
// to list[t * 128 ...] and their number to count[t], as K2f writes them.
template <int NPool>
__global__ void __launch_bounds__(kThreads, kTwinFreeBlocks)
    bwd_twin_free_kernel(const float* __restrict__ table, const float* __restrict__ g_img,
                         const int* __restrict__ pid, const float* __restrict__ lit_in,
                         float* __restrict__ partial, float* __restrict__ img,
                         int* __restrict__ list, int* __restrict__ count, int tiles_per_block,
                         TwinDims D, TwinSizing T) {
  constexpr bool Chain = false;
  constexpr int Var = kTwinAsK2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t n_pix = (size_t)D.rows * D.width;
  const int n_tiles = (int)((n_pix + kThreads - 1) / kThreads);
  const int t0 = blockIdx.x * tiles_per_block;
  const int n_mine = min(tiles_per_block, n_tiles - t0);
  const int A = D.aa;

  TWIN_STAGE();
  // per tile of the block and warp: the ballot of the pixels left out
  unsigned* left = reinterpret_cast<unsigned*>(acc + kWarps * acc_cols);
  // a ray has a chain when its primary object is specular; material codes
  // from column 15 of the staged table
  for (int i = 0; i < n_mine; ++i) {
    const size_t p = (size_t)(t0 + i) * kThreads + threadIdx.x;
    bool has_chain = false;
    if (p < n_pix && D.bounces > 0) {
      for (int a = 0; a < A; ++a) {
        const int id = pid[a * n_pix + p];
        if (id >= 0) has_chain = has_chain || obj[id * kObjCols + 15] <= 0.0f;
      }
    }
    const unsigned bal = __ballot_sync(kFull, has_chain);
    if (lane == 0) left[i * kWarps + warp] = bal;
  }
  __syncthreads();
  for (int i = 0; i < n_mine; ++i) {
    const unsigned* bits = left + i * kWarps;
    int rank = __popc(bits[warp] & ((1u << lane) - 1u)), total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = __popc(bits[w]);
      rank += w < warp ? c : 0;
      total += c;
    }
    const size_t tile = (size_t)(t0 + i);
    if ((bits[warp] >> lane) & 1u) list[tile * kThreads + rank] = (int)(tile * kThreads + threadIdx.x);
    if (threadIdx.x == 0) count[tile] = total;
  }

  // the thread's camera terms and its carried primary row, over all its
  // pixels
  float dcam[kCamCols];
#pragma unroll
  for (int i = 0; i < kCamCols; ++i) dcam[i] = 0.0f;
  RowGrad carry = zero_grad();
  int carry_id = -1;
  // the chain's names, for the ray's discarded chain code only
  const int* bid = nullptr;
  float saved[kRegBounces][12];
  int saved_id[kRegBounces];
  for (int i = 0; i < n_mine; ++i) {
    const size_t p = (size_t)(t0 + i) * kThreads + threadIdx.x;
    // a pixel left out carries no ray here, as a thread past the ragged edge
    const bool in_img = p < n_pix && !((left[i * kWarps + warp] >> lane) & 1u);
    if (__any_sync(kFull, in_img)) {
      const float gx = in_img ? g_img[p * 3] : 0.0f;
      float camr[kCamCols];
#pragma unroll
      for (int c = 0; c < kCamCols; ++c) camr[c] = cam[c];
      float img_acc[3] = {0.0f, 0.0f, 0.0f};
      for (int a = 0; a < A; ++a) {
#define TWIN_CAM(i) camr[i]
#define TWIN_SCATTER_PRIMARY(id, g) carry_scatter(wacc, carry, carry_id, id, g)
#include "twin_ray.cuh"
#undef TWIN_CAM
#undef TWIN_SCATTER_PRIMARY
#pragma unroll
        for (int c = 0; c < 3; ++c) img_acc[c] = img_acc[c] + ray_img[c];
      }
      if (in_img) {
        const float fA = (float)A;
        img[p * 3 + 0] = img_acc[0] / fA;
        img[p * 3 + 1] = img_acc[1] / fA;
        img[p * 3 + 2] = img_acc[2] / fA;
      }
    }
  }
  // the carry's flush after the block's last tile
  warp_scatter(wacc, carry_id, carry);

  // --- camera columns: the warp's 21 sums ---
  warp_camera(wacc + D.n_obj * kGradCols, dcam);
  TWIN_WRITE_PARTIAL_ROW();
}

// K2c's twin, one thread per AA ray (the walk: twin_body.cuh).
template <int NPool>
__global__ void __launch_bounds__(kThreads, kTwinChainBlocks)
    bwd_twin_chain_kernel(const float* __restrict__ table, const float* __restrict__ g_img,
                          const int* __restrict__ pid, const float* __restrict__ lit_in,
                          const int* __restrict__ bid, float* __restrict__ partial,
                          float* __restrict__ img, const int* __restrict__ list,
                          const int* __restrict__ off, const int* __restrict__ pixels,
                          TwinDims D, TwinSizing T) {
  constexpr int Var = kTwinAsK2;
#include "twin_body.cuh"
}

// Instruments of the split only: the chain twin with one piece of K2c's
// structure removed (Var) or with ptxas held to MinBlocks blocks an SM.
template <int Var, int MinBlocks>
__global__ void __launch_bounds__(kThreads, MinBlocks)
    bwd_twin_split_kernel(const float* __restrict__ table, const float* __restrict__ g_img,
                          const int* __restrict__ pid, const float* __restrict__ lit_in,
                          const int* __restrict__ bid, float* __restrict__ partial,
                          float* __restrict__ img, const int* __restrict__ list,
                          const int* __restrict__ off, const int* __restrict__ pixels,
                          TwinDims D, TwinSizing T) {
  constexpr int NPool = kSplitPool;
#include "twin_body.cuh"
}

#undef TWIN_STAGE
#undef TWIN_WRITE_PARTIAL_ROW

using FreeFn = void (*)(const float*, const float*, const int*, const float*, float*, float*,
                        int*, int*, int, TwinDims, TwinSizing);
using ChainFn = void (*)(const float*, const float*, const int*, const float*, const int*,
                         float*, float*, const int*, const int*, const int*, TwinDims,
                         TwinSizing);

// The free twin of pool n_pool (kernels/bwd_twin.py: FREE_POOLS).
FreeFn pick_free(int n_pool) {
  switch (n_pool) {
    case 0: return bwd_twin_free_kernel<0>;
    case 16: return bwd_twin_free_kernel<16>;
    case 32: return bwd_twin_free_kernel<32>;
    case 48: return bwd_twin_free_kernel<48>;
    case 64: return bwd_twin_free_kernel<64>;
    default: return nullptr;
  }
}

// The chain twin of pool n_pool (split 0; kernels/bwd_twin.py: POOLS), or
// split instance 1 (no shuffles), 2 (no chain storage), 3 (no binary
// search) or 4 (at least 4 blocks an SM) of pool kSplitPool.
ChainFn pick_chain(int n_pool, int split) {
  if (split != 0) {
    if (n_pool != kSplitPool) return nullptr;
    switch (split) {
      case 1: return bwd_twin_split_kernel<kTwinNoShfl, kTwinChainBlocks>;
      case 2: return bwd_twin_split_kernel<kTwinNoChain, kTwinChainBlocks>;
      case 3: return bwd_twin_split_kernel<kTwinNoSearch, kTwinChainBlocks>;
      case 4: return bwd_twin_split_kernel<kTwinAsK2, 4>;
      default: return nullptr;
    }
  }
  switch (n_pool) {
    case 0: return bwd_twin_chain_kernel<0>;
    case 32: return bwd_twin_chain_kernel<32>;
    case 64: return bwd_twin_chain_kernel<64>;
    case 96: return bwd_twin_chain_kernel<96>;
    case 128: return bwd_twin_chain_kernel<128>;
    default: return nullptr;
  }
}

// The host arrays as the kernels take them; false for a sizing past the
// caps or more bounces than the chain storage holds.
bool parse(const int* dims, const int* sizing, TwinDims& D, TwinSizing& T) {
  D.rows = dims[0];
  D.width = dims[1];
  D.aa = dims[2];
  D.bounces = dims[3];
  D.n_obj = dims[4];
  T.n_half = sizing[0];
  T.n_second = sizing[1];
  T.n_step = sizing[2];
  T.pad = 0;
  for (int i = 0; i < 2 * kTwinHalf; ++i) {
    T.slots[i] = sizing[3 + i];
    T.divs[i] = (unsigned)sizing[3 + 2 * kTwinHalf + i];
    if (T.slots[i] < 0 || T.slots[i] > kTwinSlots) return false;
  }
  return D.bounces <= kRegBounces && T.n_half <= kTwinHalf && T.n_second <= kTwinHalf &&
         T.n_half >= 0 && T.n_second >= 0 && T.n_step >= 0 && D.aa > 0 && D.n_obj > 0;
}

// The twins' shared memory: the table, the camera row and the warps'
// accumulators; the free twin's adds, for each tile a block takes, its
// warps' ballots (as K2f's: render_bwd.py:free_shared_bytes), the chain
// twin's a chunk's image terms and pixels.
size_t table_smem(const TwinDims& D) {
  const size_t n_obj = (size_t)D.n_obj;
  return sizeof(float) * (n_obj * kObjCols + kCamCols + kWarps * (n_obj * kGradCols + kCamCols));
}
size_t free_smem(const TwinDims& D, int tiles_per_block) {
  return table_smem(D) + sizeof(unsigned) * (size_t)tiles_per_block * kWarps;
}
size_t chain_smem(const TwinDims& D) {
  return table_smem(D) + sizeof(float) * (size_t)twin_ppb(D.aa) * (D.aa * 3 + 1);
}

template <class F>
cudaError_t allow_smem(F kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Both launchers: dims = {rows, width, aa, bounces, n_obj}; sizing =
// {n_half, n_second, n_step, slots[12], divs[12]} (HOST arrays, laid out as
// TwinSizing). table [n_obj, 17]; g [rows, W, 3]; pid, lit [A, rows, W];
// img [rows, W, 3] receives the replayed image. Each returns
// cudaGetLastError() of its launch, or cudaErrorInvalidValue for a pool or
// split without an instance, a sizing past the caps, or more bounces than
// the chain storage holds.

// The free twin of pool n_pool on a grid of `blocks` blocks of
// `tiles_per_block` tiles of 128 pixels each (K2f's: render_bwd.py:
// free_grid; blocks * tiles_per_block must cover ceil(rows*W / 128) tiles,
// and tiles_per_block be at most kTwinFreeMaxTiles): partial [blocks,
// n_obj*16 + 21] is overwritten, list [ceil(rows*W / 128) * 128] and
// count [ceil(rows*W / 128)] receive the pixels left for the chain twin; a
// grid that does not cover the frame is refused.
extern "C" int bwd_twin_free_launch(int n_pool, const float* table, const float* g,
                                    const int* pid, const float* lit, float* partial, float* img,
                                    int* list, int* count, const int* dims, const int* sizing,
                                    int blocks, int tiles_per_block, void* stream) {
  const FreeFn fn = pick_free(n_pool);
  TwinDims D;
  TwinSizing T;
  if (fn == nullptr || !parse(dims, sizing, D, T)) return (int)cudaErrorInvalidValue;
  const long long n_pix = (long long)D.rows * D.width;
  if (n_pix == 0) return 0;
  const long long n_tiles = (n_pix + kThreads - 1) / kThreads;
  if (blocks <= 0 || tiles_per_block <= 0 || tiles_per_block > kTwinFreeMaxTiles ||
      (long long)blocks * tiles_per_block < n_tiles)
    return (int)cudaErrorInvalidValue;
  const size_t smem = free_smem(D, tiles_per_block);
  const cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      table, g, pid, lit, partial, img, list, count, tiles_per_block, D, T);
  return (int)cudaGetLastError();
}

// The chain twin of pool n_pool (split 0) or split instance `split`: with
// list and off (the free twin's list and the inclusive sums of its counts,
// on the device) over the listed pixels, on the free twin's grid; without
// (list null) over every pixel, one block a chunk. pixels: the listed
// pixels compacted, for the split instance without the search (else
// null). bid [bounces, A, rows, W] (may be null when bounces == 0).
// partial [blocks, n_obj*16 + 21] is overwritten, blocks as
// render_bwd.chain_blocks says.
extern "C" int bwd_twin_chain_launch(int n_pool, int split, const float* table, const float* g,
                                     const int* pid, const float* lit, const int* bid,
                                     float* partial, float* img, const int* list, const int* off,
                                     const int* pixels, const int* dims, const int* sizing,
                                     void* stream) {
  const ChainFn fn = pick_chain(n_pool, split);
  TwinDims D;
  TwinSizing T;
  if (fn == nullptr || !parse(dims, sizing, D, T) || (split == 3) != (pixels != nullptr) ||
      (split == 3 && list == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long n_pix = (long long)D.rows * D.width;
  if (n_pix == 0) return 0;
  const size_t smem = chain_smem(D);
  const cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  const long long ppb = list != nullptr ? kThreads : twin_ppb(D.aa);
  const unsigned blocks = (unsigned)((n_pix + ppb - 1) / ppb);
  fn<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(table, g, pid, lit, bid, partial, img, list,
                                                      off, pixels, D, T);
  return (int)cudaGetLastError();
}

// How many blocks of the free twin (kind 0, at kTwinFreeMaxTiles tiles a
// block, the most shared memory it takes, as K2f's count) or the chain
// twin (kind 1) of pool n_pool one SM holds at these dims (the runtime's
// occupancy count), into *blocks.
extern "C" int bwd_twin_blocks_per_sm(int kind, int n_pool, const int* dims, int* blocks) {
  TwinDims D;
  D.rows = dims[0];
  D.width = dims[1];
  D.aa = dims[2];
  D.bounces = dims[3];
  D.n_obj = dims[4];
  if (kind == 0) {
    const FreeFn fn = pick_free(n_pool);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    const size_t smem = free_smem(D, kTwinFreeMaxTiles);
    const cudaError_t e = allow_smem(fn, smem);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, smem);
  }
  const ChainFn fn = pick_chain(n_pool, 0);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(fn, chain_smem(D));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, chain_smem(D));
}
