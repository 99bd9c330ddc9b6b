// Path-replay backward kernels for Hopper (sm_90a): two launches per
// gradient on frames of a million rays or more that bounce, in scenes of up
// to 32 objects; one launch otherwise.
//
// Replaces the TPU kernel kernels/render_bwd.py:_bwd_kernel of the JAX
// package (whole-table mode). From the packed scene tables, the image
// cotangent g and the forward kernel's decision record (pid, lit, bid) it
// computes the cotangents of the tables: per ray it gathers the objects the
// ray hit, replays the lean reconstruction of the ray's radiance
// (ops/replay.py: ray generation + primary hit, the bounce chain, the
// shading tail) and runs the adjoint of that replay in reverse.
//
// The TPU kernel calls jax.vjp inside its body; CUDA has no autodiff, so
// every adjoint here is derived by hand. The rules that make the gradient
// the framework's (PARITY.md "Gradient semantics"): a select passes its
// cotangent to the chosen branch only; mat, is_sph, valid, medium, lit and
// the tir / use_refl / dead decisions are frozen; max(x, 0) passes where
// x > 0; the guards disc == 0, k == 0, detA == 0, q == 0, a_q == 0,
// pl2 == 0 and radius_sq == 0 give a zero derivative; a triangle's normal
// is the packed table's column 9..11 and its cotangent goes there (the
// wrapper pulls it back onto the vertices through pack_scene). Division
// and sqrt are IEEE with their plain derivatives.
//
// Design:
// - Per ray: a forward sweep over the bounce steps the ray really ran (the
//   record's depth, not the budget) that keeps the 12 floats a step's
//   adjoint needs (cur_d, cur_pos, cur_nrm, cur_mat, medium, weight) in
//   per-thread storage, the shading adjoint, the reverse sweep, and the
//   adjoint of the primary hit and the ray generation (bwd_ray.cuh).
// - Split by the record. Only a ray whose primary object is specular has a
//   bounce chain: 6.4% of the rays at full_1024. The chain's storage
//   (float[16][12] a thread, indexed at run time) held every thread to 168
//   registers, an 848 B stack and 3 blocks an SM. So a gradient is two
//   launches when the wrapper's rule says so (render_bwd.py:splits).
//   render_bwd_free_kernel, one thread per pixel looping over its A rays
//   (bwd_body.cuh), runs every pixel none of whose rays has a chain: the
//   body without chain storage, step code or reverse sweep, at 4 blocks an
//   SM (128 registers). It also writes, in order, the pixels it leaves out
//   (a pixel with any chain ray goes whole, so that its rays stay in one
//   block and its radiance is summed in ray order): per 128-pixel tile a
//   list and a count, which the wrapper turns into offsets with one cumsum
//   on the device (no wait for the host). A block takes a contiguous range
//   of tiles (8 at full_1024: 1,024 blocks in two waves on the H100's 528
//   slots, where one block a tile made 8,192 blocks in 15.5 waves), so it
//   stages the tables, zeroes its accumulators, sums its camera
//   cotangents and writes its partial row once for all of them, a lane
//   carries its primary row from tile to tile while the object repeats,
//   and a warp with no pixel in a tile skips it. Two waves and not one:
//   the card's scheduler then balances the blocks' uneven work (6% at
//   full_1024, PERF.md).
//   render_bwd_kernel then runs the listed pixels, compacted, one thread
//   per AA ray, on a grid of one block a tile: block b takes chunks b, b +
//   grid, ... of pixels_per_block(A) listed pixels (32 at 2x2 AA), each
//   ray finding its pixel by a binary search over the offsets; a block
//   with no chunk writes zeros and stops. Otherwise render_bwd_kernel alone
//   runs every pixel, one block a chunk: past 32 objects (the staged table
//   and the accumulators grow to hundreds of KB a block, which a second
//   launch would stage and zero again), without bounces, and below a
//   million rays (where the chain launch's floor costs more than the
//   chain-free launch saves). In a chunk ray a of pixel l is item a * ppb
//   + l and thread t takes items t, t + 128, ..., so a warp holds one AA
//   index of 32 adjacent pixels (as K1 and the streamed kernel); the rays'
//   radiance meets in shared memory and one thread per pixel adds it in
//   ray order, so the image is the one-thread-per-pixel loop's bit for
//   bit. One thread per pixel ran a pixel's rays in series on too few
//   blocks: full_1024's 68k listed pixels were 533 blocks for 396 slots,
//   the headline's 134, dense_scene(256) at 128x128 aa4 (258 objects, 2
//   blocks an SM by shared memory) 128 for 264 (PERF.md §6). The chain
//   kernel is held to 3 blocks an SM (168 registers; left free, ptxas took
//   197 and the launch ran slower). The register instance (Deep = false)
//   keeps the chain in the per-thread array of kRegBounces steps (cutting
//   its stores and loads saved at most 4%); a deeper config launches the
//   deep instance (Deep = true), whose chain lives in a device buffer the
//   wrapper allocates (bwd_common.cuh: DeepSteps), a slot per thread of
//   the grid reused by its items, so any bounce count runs.
// - The object rows (28 x 17 floats on the Cornell box) are staged into
//   shared memory as one unified table, so a gather is one indexed read:
//   the TPU kernel's presence-bit gather loop and its de Bruijn LUT are not
//   needed for gathering.
// - The TPU kernel accumulates into tables that persist across its
//   sequential grid. Blocks run concurrently here, so each block reduces
//   its own rays' cotangents and writes one row of partial sums
//   [n_obj*16 + 21]; the wrapper adds the rows of both launches with
//   torch.sum, in a fixed order. No float atomics anywhere: within a warp,
//   the lanes that hit the same object at the same site are summed by a
//   shuffle butterfly (bwd_common.cuh; the warp visits only the objects its
//   rays hit, which is the presence word's second job), lane 0 adds the
//   result to the warp's accumulator in shared memory, and the block adds
//   its four warps in order. In the chain-free launch a thread first
//   carries its primary site's row across its AA rays while the object
//   repeats (it almost always does), so the warp scatters when a lane's
//   object changes and once at the pixel's end, not once a ray. Two runs
//   on the same inputs give bit-equal gradients; the replayed image is the
//   one-launch design's bit for bit (the per-ray arithmetic is unchanged;
//   only the order of the sums over rays is).
// - The reverse sweep runs to the deepest chain of the warp, with shallower
//   lanes idle, so that all 32 lanes meet at every shuffle.
//
// What bounds it on this card: FP32 issue and latency. The split that
// decided the chain-free launch (chip_timing.py --split k2k5: K7, the
// structure twin, with the shuffles, the chain storage and the register
// cap changed one at a time) found the shuffles and the chain's storage
// each worth 18% of the twin's time, and a register cap a loss wherever it
// spilled; the chain kernel's own split (--split k2c) found its chain
// storage worth at most 2% (12% in the deep instance) and its grid the
// gap; the chain-free kernel's own split (--split k2f) found its camera
// sums worth 10% and its scatter 19-25%, its partial rows and pre-pass
// 3-4% and its staging nothing, which set its grid of tile ranges. At
// full_1024 the chain-free launch takes 0.19 ms for 93.5% of the pixels
// (0.22 with one block a tile), the chain launch 0.12 ms for the rest and
// their bounce steps; the record (4 + 4 + 4*bounces bytes per ray) and the
// partial sums are small beside that. PERF.md has the runs.
//
// The per-ray replay and its adjoint live in bwd_common.cuh and
// bwd_ray.cuh (which bwd_body.cuh loops over a pixel's rays), shared with
// the streamed kernel (render_bwd_streamed.cu) for scenes whose
// accumulators do not fit shared memory.
//
// Built with --fmad=false like the forward kernel, and with the replay's
// forward arithmetic in the order of ops/replay.py, so that the recomputed
// decisions (tir, the root chosen, the side of the normal) are those of the
// plain version bit for bit.

#include "bwd_common.cuh"

namespace {

// The row of object `id` from the staged table; -1 reads the miss row.
__device__ __forceinline__ Row load_row(const float* obj, int n_tri, int id) {
  if (id < 0) return miss_row();
  Row r;
  r.valid = true;
  r.is_sph = id >= n_tri;
  const float* R = obj + id * kObjCols;
  r.v0 = load3(R);
  r.e1 = load3(R + 3);
  r.e2 = load3(R + 6);
  r.n = load3(R + 9);
  r.rgb = load3(R + 12);
  r.mat = R[15];
  r.r2 = R[16];
  return r;
}

// Pixels of one chunk of the chain kernel: 32 * 4 / gcd(A, 4), the
// fewest whole warps of pixels whose A rays fill whole rounds of kThreads
// threads (as pixels_per_block in render_fwd.cu).
__host__ __device__ inline int pixels_per_block(int A) {
  return A % 4 == 0 ? 32 : (A % 2 == 0 ? 64 : 128);
}

// The chain-free launch's blocks an SM: ptxas holds it to 128 registers
// (PERF.md: 4 blocks beat 3, 5 and 6).
constexpr int kFreeBlocks = 4;
// The most tiles a block of the chain-free launch takes, so that their
// ballots (16 KB at 1,024 tiles) fit beside the tables; a larger frame
// gets more blocks.
constexpr int kFreeMaxTiles = 1024;
// The chain launch's: 3, so ptxas keeps it at 168 registers (PERF.md: left
// free it took 197, 2 blocks an SM, and ran 1-20% slower).
constexpr int kChainBlocks = 3;

// The whole-table kernels' tables: rows from the staged unified table,
// cotangents into the warp's accumulator in shared memory. With Carry (the
// chain-free launch; in the chain launch the carry's registers cost more
// than it saves, PERF.md), a lane holds its primary site's row back while
// its object repeats from ray to ray and from pixel to pixel, and the warp
// scatters only when some lane's object changes (flush: after the block's
// last tile).
template <bool Carry>
struct WholeTables {
  const float* obj;
  float* wacc;
  int n_tri;
  RowGrad carry;
  int carry_id;
  __device__ __forceinline__ Row load(int id) const { return load_row(obj, n_tri, id); }
  __device__ __forceinline__ void scatter(int site, int, int id, const RowGrad& g) {
    if (Carry && site == 0) {
      const bool change = carry_id >= 0 && id >= 0 && id != carry_id;
      if (__any_sync(kFull, change)) warp_scatter(wacc, change ? carry_id : -1, carry);
      if (id >= 0) {
        carry = id == carry_id ? add_grad(carry, g) : g;
        carry_id = id;
      }
    } else {
      warp_scatter(wacc, id, g);
    }
  }
  __device__ __forceinline__ void flush() {
    if (Carry) {
      warp_scatter(wacc, carry_id, carry);
      carry_id = -1;
    }
  }
};

// Stages the unified object table and the camera row and zeroes the
// warps' accumulators; declares n_obj, acc_cols, obj, cam, acc and this
// warp's accumulator wacc.
#define STAGE_TABLES()                                                                     \
  extern __shared__ float smem[];                                                          \
  const int n_obj = P.n_tri + P.n_sph;                                                     \
  const int acc_cols = n_obj * kGradCols + kCamCols;                                       \
  float* obj = smem;                                                                       \
  float* cam = obj + n_obj * kObjCols;                                                     \
  float* acc = cam + kCamCols; /* [kWarps][acc_cols] */                                    \
  for (int i = threadIdx.x; i < n_obj * kObjCols; i += blockDim.x) {                       \
    const int o = i / kObjCols, c = i - o * kObjCols;                                      \
    float v;                                                                               \
    if (o < P.n_tri) {                                                                     \
      v = c < 16 ? g_tri[o * kTriCols + c] : 0.0f; /* v0 e1 e2 n rgb mat | r2 = 0 */       \
    } else {                                                                               \
      const float* S = g_sph + (o - P.n_tri) * kSphCols;                                   \
      v = c < 3 ? S[c] : c < 12 ? 0.0f : c < 15 ? S[4 + (c - 12)] : c == 15 ? S[7] : S[3]; \
    }                                                                                      \
    obj[i] = v;                                                                            \
  }                                                                                        \
  for (int i = threadIdx.x; i < kCamCols; i += blockDim.x) cam[i] = g_cam[i];              \
  for (int i = threadIdx.x; i < kWarps * acc_cols; i += blockDim.x) acc[i] = 0.0f;         \
  __syncthreads();                                                                         \
  float* wacc = acc + (threadIdx.x >> 5) * acc_cols

// The block's partial row: its warps' accumulators added in order.
#define WRITE_PARTIAL_ROW()                                              \
  __syncthreads();                                                       \
  float* out = partial + (size_t)blockIdx.x * acc_cols;                  \
  for (int i = threadIdx.x; i < acc_cols; i += blockDim.x) {             \
    float s = acc[i];                                                    \
    _Pragma("unroll") for (int w = 1; w < kWarps; ++w) s += acc[w * acc_cols + i]; \
    out[i] = s;                                                          \
  }

// The block's partial row as zeros, for a block with no pixel to run.
__device__ __forceinline__ void zero_partial_row(float* partial, const Params& P) {
  const int cols = (P.n_tri + P.n_sph) * kGradCols + kCamCols;
  for (int i = threadIdx.x; i < cols; i += blockDim.x) partial[(size_t)blockIdx.x * cols + i] = 0.0f;
}

// The pixels without a bounce chain: block b takes the contiguous tiles
// b * T ... (b + 1) * T - 1 of kThreads pixels (T = tiles_per_block, the
// fewest that put the grid on the card in two waves:
// kernels/render_bwd.py:free_grid). It does its fixed work once: stages
// the tables and zeroes its accumulators, flags the pixels of all its
// tiles in one pre-pass over the record (a pixel with a chain ray is left
// for the chain launch, whole), writes each tile's list, runs its tiles,
// sums its warps' camera cotangents and writes one partial row. Tile t's
// list is the pixels it leaves out, in order, at list[t * 128 ...], and
// their number count[t], as one block a tile wrote them (the chain launch
// searches them so). A lane's pixel in the next tile lies 128 pixels on,
// on the same row or the next, so a lane carries its primary row across
// its tiles while the object repeats, and a warp with no pixel in a tile
// skips it.
__global__ void __launch_bounds__(kThreads, kFreeBlocks)
    render_bwd_free_kernel(const float* __restrict__ g_tri, const float* __restrict__ g_sph,
                           const float* __restrict__ g_cam, const float* __restrict__ g_img,
                           const int* __restrict__ pid, const float* __restrict__ lit_in,
                           float* __restrict__ partial, float* __restrict__ img,
                           int* __restrict__ list, int* __restrict__ count,
                           int tiles_per_block, Params P) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t n_pix = (size_t)P.rows * P.width;
  const int n_tiles = (int)((n_pix + kThreads - 1) / kThreads);
  const int t0 = blockIdx.x * tiles_per_block;
  const int n_mine = min(tiles_per_block, n_tiles - t0);

  STAGE_TABLES();
  // per tile of the block and warp: the ballot of the pixels left out
  unsigned* left = reinterpret_cast<unsigned*>(acc + kWarps * acc_cols);
  // a ray has a chain when its primary object is specular (bwd_ray.cuh:
  // the forward sweep's first test); the material from the staged table
  const int n_aa = P.aa_x * P.aa_y;
  for (int i = 0; i < n_mine; ++i) {
    const size_t p = (size_t)(t0 + i) * kThreads + threadIdx.x;
    bool has_chain = false;
    if (p < n_pix && P.bounces > 0) {
      for (int a = 0; a < n_aa; ++a) {
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

  constexpr bool Chain = false, Deep = false;
  const size_t chain_stride = 0;
  float* chain = nullptr;
  const int* bid = nullptr;
  WholeTables<true> tb;
  tb.obj = obj;
  tb.wacc = wacc;
  tb.n_tri = P.n_tri;
  tb.carry_id = -1;
  // the thread's camera cotangents, over all its pixels
  float dcam[kCamCols];
#pragma unroll
  for (int i = 0; i < kCamCols; ++i) dcam[i] = 0.0f;
  for (int i = 0; i < n_mine; ++i) {
    const size_t p = (size_t)(t0 + i) * kThreads + threadIdx.x;
    // a pixel left out carries no ray here, as a thread past the ragged edge
    const bool in_img = p < n_pix && !((left[i * kWarps + warp] >> lane) & 1u);
    if (__any_sync(kFull, in_img)) {
#define REPLAY_LOAD_ROW(id) tb.load(id)
#define REPLAY_SCATTER(site, a, id, g) tb.scatter(site, a, id, g)
#include "bwd_body.cuh"
#undef REPLAY_LOAD_ROW
#undef REPLAY_SCATTER
    }
  }
  tb.flush();

  // --- camera cotangents: the warp's 21 sums ---
  warp_camera(wacc + n_obj * kGradCols, dcam);
  WRITE_PARTIAL_ROW();
}

// The pixels with a bounce chain, one thread per AA ray. The grid walks
// chunks of ppb pixels (pixels_per_block(A): 32 at 2x2 AA, 128 at one ray),
// block b taking chunks b, b + gridDim.x, ...; in a chunk ray a of pixel l
// is item a * ppb + l and thread t takes items t, t + 128, ..., so a warp
// holds one AA index of 32 pixels. With a list (the free kernel's, and off
// [n_src], the inclusive sums of its counts) chunk c holds listed pixels
// c * ppb ..., each item finding its pixel by a binary search over off; a
// block with no chunk writes zeros and stops. Without (more than 32
// objects, or below SPLIT_RAYS) chunk c holds pixels c * ppb ...
template <bool Deep>
__global__ void __launch_bounds__(kThreads, kChainBlocks)
    render_bwd_kernel(const float* __restrict__ g_tri, const float* __restrict__ g_sph,
                      const float* __restrict__ g_cam, const float* __restrict__ g_img,
                      const int* __restrict__ pid, const float* __restrict__ lit_in,
                      const int* __restrict__ bid, float* __restrict__ partial,
                      float* __restrict__ img, float* __restrict__ chain,
                      const int* __restrict__ list, const int* __restrict__ off, Params P) {
  const size_t n_pix = (size_t)P.rows * P.width;
  const int n_src = (int)((n_pix + kThreads - 1) / kThreads);
  const size_t n_work = list != nullptr ? (size_t)off[n_src - 1] : n_pix;
  const int A = P.aa_x * P.aa_y;
  const int ppb = pixels_per_block(A);
  const size_t n_chunks = (n_work + ppb - 1) / ppb;
  if (blockIdx.x >= n_chunks) {
    zero_partial_row(partial, P);
    return;
  }
  STAGE_TABLES();
  float* col = acc + kWarps * acc_cols;        // [A][3][ppb]: the rays' radiance
  int* pix = reinterpret_cast<int*>(col + A * 3 * ppb);  // [ppb]: the chunk's pixels

  // the deep chain's slot is the thread's, reused by its items in turn
  const size_t chain_stride = (size_t)gridDim.x * kThreads;
  ChainSteps<Deep> saved;
  ChainIds<Deep> saved_id;
  deep_chain<Deep>(saved, saved_id, chain, (size_t)blockIdx.x * kThreads + threadIdx.x,
                   chain_stride);
  const float fA = (float)A;
  float dcam[kCamCols];
#pragma unroll
  for (int i = 0; i < kCamCols; ++i) dcam[i] = 0.0f;
  constexpr bool Chain = true;
  WholeTables<false> tb;
  tb.obj = obj;
  tb.wacc = wacc;
  tb.n_tri = P.n_tri;

  for (size_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    for (int item = threadIdx.x; item < ppb * A; item += kThreads) {
      const int a = item / ppb, lp = item - a * ppb;
      const size_t j = c * ppb + lp;
      // a lane past the last pixel stays: it carries no ray but takes part
      // in the warp's shuffles
      const bool in_img = j < n_work;
      size_t p = j;
      if (list != nullptr && in_img) {
        int lo = 0, hi = n_src - 1;  // the first source block past j
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if ((size_t)off[mid] > j)
            hi = mid;
          else
            lo = mid + 1;
        }
        p = (size_t)list[(size_t)lo * kThreads + (j - (lo ? (size_t)off[lo - 1] : 0))];
      }
      if (a == 0) pix[lp] = in_img ? (int)p : -1;
      const int py = in_img ? (int)(p / P.width) : 0;
      const int px = in_img ? (int)(p - (size_t)py * P.width) : 0;
      const float bx0 = (float)px * (float)P.aa_x - P.half_w;
      const float by0 = (float)(P.row0 + py) * (float)P.aa_y - P.half_h;
      V3 gpix = zero3();
      if (in_img) gpix = load3(g_img + p * 3);
      // cotangent of one ray's color: the AA mean is sum / A
      const V3 dcolor = make(gpix.x / fA, gpix.y / fA, gpix.z / fA);
      V3 img_acc = zero3();
      // the camera row from shared memory for each ray, so that it is not
      // held in registers across the walk (PERF.md §6)
      const V3 r0 = load3(cam), r1 = load3(cam + 3), r2 = load3(cam + 6);
      const V3 cam_pos = load3(cam + 9), light = load3(cam + 12);
      const V3 light_rgb = load3(cam + 15), indirect = load3(cam + 18);
      const float fS = (float)P.shadow_samples;
#define REPLAY_LOAD_ROW(id) tb.load(id)
#define REPLAY_SCATTER(site, a, id, g) tb.scatter(site, a, id, g)
#include "bwd_ray.cuh"
#undef REPLAY_LOAD_ROW
#undef REPLAY_SCATTER
      col[(a * 3 + 0) * ppb + lp] = img_acc.x;
      col[(a * 3 + 1) * ppb + lp] = img_acc.y;
      col[(a * 3 + 2) * ppb + lp] = img_acc.z;
    }
    __syncthreads();
    // the replayed radiance: each pixel's rays added in ray order, ((0 +
    // c0) + c1) + ..., and divided by A, as one thread looping over them
    for (int l = threadIdx.x; P.want_img && l < ppb; l += kThreads) {
      const int p = pix[l];
      if (p < 0) break;
      V3 s = zero3();
      for (int a = 0; a < A; ++a)
        s = add(s, make(col[(a * 3 + 0) * ppb + l], col[(a * 3 + 1) * ppb + l],
                        col[(a * 3 + 2) * ppb + l]));
      img[(size_t)p * 3 + 0] = s.x / fA;
      img[(size_t)p * 3 + 1] = s.y / fA;
      img[(size_t)p * 3 + 2] = s.z / fA;
    }
    __syncthreads();  // col and pix are the next chunk's
  }

  // --- camera cotangents: the warp's 21 sums ---
  warp_camera(wacc + n_obj * kGradCols, dcam);
  WRITE_PARTIAL_ROW();
}

#undef STAGE_TABLES
#undef WRITE_PARTIAL_ROW

size_t whole_smem(const Params& P) {
  const size_t n_obj = (size_t)P.n_tri + P.n_sph;
  return sizeof(float) * (n_obj * kObjCols + kCamCols + kWarps * (n_obj * kGradCols + kCamCols));
}

// The chain kernel's: the tables, the radiance of a chunk's rays and its
// pixels (kernels/render_fwd.py:bwd_shared_bytes).
size_t chain_smem(const Params& P) {
  const int A = P.aa_x * P.aa_y;
  return whole_smem(P) + sizeof(float) * (size_t)pixels_per_block(A) * (A * 3 + 1);
}

// The chain-free kernel's: the tables and, for each tile a block takes,
// its warps' ballots of the pixels left out (render_bwd.py:free_shared_bytes).
size_t free_smem(const Params& P, int tiles_per_block) {
  return whole_smem(P) + sizeof(unsigned) * (size_t)tiles_per_block * kWarps;
}

// The chain launch's grid: one block a 128-pixel tile with a list (its
// blocks walk the listed pixels' chunks), else one block a chunk of every
// pixel.
unsigned chain_blocks(long long n_pix, int A, bool listed) {
  const long long ppb = listed ? kThreads : pixels_per_block(A);
  return (unsigned)((n_pix + ppb - 1) / ppb);
}

template <class F>
cudaError_t allow_smem(F kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Both launchers: ip and fp are HOST arrays (their fields are listed at
// make_params in bwd_common.cuh). g [rows, W, 3]; pid, lit [A, rows, W];
// bid [bounces, A, rows, W] (may be null when bounces == 0).
// img [rows, W, 3] receives the replayed radiance when want_img is set
// (else it may be null). Up to kRegBounces bounces the register instance
// of the chain launch runs and chain may be null; a deeper config runs the
// deep instance, which needs chain: kChainFloats * bounces * 128 * blocks
// floats of scratch, blocks the chain launch's grid (chain_blocks: with
// the list ceil(rows*W / 128), without it ceil(rows*W / pixels_per_block(A)));
// contents on entry do not matter.

// The chain-free launch (up to 32 objects) on a grid of `blocks` blocks of
// `tiles_per_block` tiles of 128 pixels each (render_bwd.py:free_grid;
// blocks * tiles_per_block must cover ceil(rows*W / 128) tiles, and
// tiles_per_block be at most kFreeMaxTiles): partial [blocks,
// (n_tri+n_sph)*16 + 21] is overwritten, list [ceil(rows*W / 128) * 128]
// and count [ceil(rows*W / 128)] receive the pixels left for the chain
// launch. Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a grid that does not cover the frame.
extern "C" int render_bwd_free_launch(const float* tri, const float* sph, const float* cam,
                                      const float* g, const int* pid, const float* lit,
                                      float* partial, float* img, int* list, int* count,
                                      const int* ip, const float* fp, int blocks,
                                      int tiles_per_block, void* stream) {
  const Params P = make_params(ip, fp);
  const long long n_pix = (long long)P.rows * P.width;
  if (n_pix == 0) return 0;
  const long long n_tiles = (n_pix + kThreads - 1) / kThreads;
  if (blocks <= 0 || tiles_per_block <= 0 || tiles_per_block > kFreeMaxTiles ||
      (long long)blocks * tiles_per_block < n_tiles)
    return (int)cudaErrorInvalidValue;
  const auto fn = render_bwd_free_kernel;
  const size_t smem = free_smem(P, tiles_per_block);
  const cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      tri, sph, cam, g, pid, lit, partial, img, list, count, tiles_per_block, P);
  return (int)cudaGetLastError();
}

// The chain launch: with list and off (the free launch's list and the
// inclusive sums of its counts, on the device) over the listed pixels;
// without (list null) over every pixel. partial [blocks, (n_tri+n_sph)*16
// + 21] is overwritten, blocks as chain_blocks says. Returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue when a deep config comes without its
// chain.
extern "C" int render_bwd_launch(const float* tri, const float* sph, const float* cam,
                                 const float* g, const int* pid, const float* lit,
                                 const int* bid, float* partial, float* img, float* chain,
                                 const int* list, const int* off, const int* ip, const float* fp,
                                 void* stream) {
  const Params P = make_params(ip, fp);
  const bool deep = P.bounces > kRegBounces;
  if (deep && chain == nullptr) return (int)cudaErrorInvalidValue;
  const long long n_pix = (long long)P.rows * P.width;
  if (n_pix == 0) return 0;
  const auto fn = deep ? render_bwd_kernel<true> : render_bwd_kernel<false>;
  const size_t smem = chain_smem(P);
  const cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = chain_blocks(n_pix, P.aa_x * P.aa_y, list != nullptr);
  fn<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(tri, sph, cam, g, pid, lit, bid, partial,
                                                      img, chain, list, off, P);
  return (int)cudaGetLastError();
}

// How many blocks of the chain-free kernel one SM holds in a scene of n_obj
// objects at kFreeMaxTiles tiles a block, the most shared memory it takes
// (the runtime's occupancy count), into *blocks.
extern "C" int render_bwd_free_blocks_per_sm(int n_obj, int* blocks) {
  Params P{};
  P.n_tri = n_obj;
  const auto fn = render_bwd_free_kernel;
  const size_t smem = free_smem(P, kFreeMaxTiles);
  const cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, smem);
}

// How many blocks of the chain kernel's instance for these parameters one
// SM holds (the runtime's occupancy count), into *blocks.
extern "C" int render_bwd_blocks_per_sm(const int* ip, const float* fp, int* blocks) {
  const Params P = make_params(ip, fp);
  const auto fn = P.bounces > kRegBounces ? render_bwd_kernel<true> : render_bwd_kernel<false>;
  const size_t smem = chain_smem(P);
  const cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, smem);
}
