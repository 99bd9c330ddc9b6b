// Streamed path-replay backward kernel for Hopper (sm_90a): the large-scene
// variant of render_bwd.cu, one launch per gradient for any triangle count,
// and the segmented sum that follows it.
//
// Replaces the streamed mode of the TPU kernel kernels/render_bwd.py:
// _bwd_kernel(streamed=True) of the JAX package. It computes the same
// cotangents as the whole-table kernel, per ray by the same code
// (bwd_ray.cuh). Three things differ:
//
// - The gather. The TPU kernel finds a lane's row by scanning the whole
//   streamed table at every site, because a TPU lane cannot index memory by
//   itself. A CUDA thread can: it loads row `id` of tri [T,19] or sph [S,12]
//   straight from device memory. No tile staging, no table scan.
// - The accumulator. The whole-table kernel keeps 16 floats per object and
//   warp in shared memory; at thousands of triangles that does not fit, and
//   its per-block partial sums would take gigabytes. Here a triangle's
//   cotangent leaves per ray and site: dlane [(1 + bounces) * A * rows * W,
//   16], row ((site * A + a) * n_pix + p), site 0 the primary hit and site
//   1 + k bounce step k, columns v0 e1 e2 n rgb | 0. The wrapper hands the
//   buffer in zeroed and the kernel writes only the sites that hit a
//   triangle, so dead sites hold zeros. The few spheres and the camera row
//   keep the whole-table design: warp-shuffle sums into per-warp
//   accumulators in shared memory and one partial row per block,
//   [n_sph*16 + 21], summed over blocks by the wrapper. A warp holds other
//   rays than the whole-table kernel's warp, so on a scene both kernels can
//   run those sums agree to float rounding (1e-5), not bit for bit.
// - The launch, below.
//
// The per-site rows are then summed per triangle by the segmented sum,
// below: the wrapper sorts the sites' triangle ids once (a stable sort, so
// equal ids keep their site order), and two passes add each triangle's run
// of sorted positions in a fixed order, a long run split over warps in
// aligned tiles of kSegTile positions (a back wall hit by tens of
// thousands of sites is not one warp's work). No float atomics anywhere:
// two runs on the same inputs give bit-equal gradients, which index_add_ /
// scatter_add_ on the card do not.
//
// The launch: one thread per AA ray, as the whole-table forward kernel
// (render_fwd.cu). A block takes ppb consecutive pixels and all their
// rays: ray a of the block's pixel l is item a * ppb + l, and thread t
// takes items t, t + 128, ... ppb, a launch argument, is the forward's
// pixels_per_block(A) (32 at 2x2 AA, 128 at one ray: 128 rays a block, one
// a thread; past 4 rays a pixel a thread takes several). So a warp holds
// one AA index of 32 adjacent pixels: its record reads (pid[a][p],
// lit[a][p], bid[k][a][p]) coalesce, and its per-site
// stores (row ((site * A + a) * n_pix + p)) fill 2 KB of dlane in one
// piece. Each thread keeps its camera cotangents over its items and the
// warp sums them once. A ray's replayed radiance goes to shared memory, and
// after a barrier one thread per pixel adds the A of them in ray order and
// divides by A, as bwd_body.cuh's loop over a pixel's rays does, so the
// image is bit for bit that loop's. The per-site rows are the same rays'
// rows either way; only the warp's sums of the sphere and camera
// cotangents take another order. The deep instance's chain slot is the
// thread's, reused by its items in turn.
//
// Occupancy, by measurement (PERF.md, §6). One thread per pixel left most
// of the card idle: at dense_8192 (128x128, 2x2 AA) it was 128 blocks of 4
// warps for 132 SMs; one thread per ray makes it 512. __launch_bounds__
// holds the register instance to 3 blocks an SM and the deep instance to
// 4: the deep instance's 191 registers left it 2, so its 512 blocks at
// 256x256 ran in two waves.
//
// What bounds it on this card: the replay's FP32 work as in render_bwd.cu,
// plus 64 B of stores per triangle site; the segmented sum is bound by the
// bytes it gathers (64 B per live site).

#include "bwd_common.cuh"

namespace {

// The streamed kernel's tables: rows straight from device memory, triangle
// cotangents to the per-site buffer, sphere cotangents to the warp's
// accumulator in shared memory.
struct StreamedTables {
  const float* tri;
  const float* sph;
  float* wacc;   // [n_sph * 16] sphere sums of this warp
  float* dlane;  // this pixel's first row: dlane + p * 16
  size_t n_pix;
  int n_tri, A;

  __device__ __forceinline__ Row load(int id) const {
    if (id < 0) return miss_row();
    Row r;
    r.valid = true;
    r.is_sph = id >= n_tri;
    if (!r.is_sph) {
      const float* R = tri + (size_t)id * kTriCols;
      r.v0 = load3(R);
      r.e1 = load3(R + 3);
      r.e2 = load3(R + 6);
      r.n = load3(R + 9);
      r.rgb = load3(R + 12);
      r.mat = R[15];
      r.r2 = 0.0f;
    } else {
      const float* S = sph + (id - n_tri) * kSphCols;
      r.v0 = load3(S);
      r.e1 = r.e2 = r.n = zero3();
      r.rgb = load3(S + 4);
      r.mat = S[7];
      r.r2 = S[3];
    }
    return r;
  }

  __device__ __forceinline__ void scatter(int site, int a, int id, const RowGrad& g) {
    if (id >= 0 && id < n_tri) {
      float4* o = reinterpret_cast<float4*>(dlane + ((size_t)site * A + a) * n_pix * kGradCols);
      o[0] = make_float4(g.v0.x, g.v0.y, g.v0.z, g.e1.x);
      o[1] = make_float4(g.e1.y, g.e1.z, g.e2.x, g.e2.y);
      o[2] = make_float4(g.e2.z, g.n.x, g.n.y, g.n.z);
      o[3] = make_float4(g.rgb.x, g.rgb.y, g.rgb.z, 0.0f);
    }
    warp_scatter(wacc, id >= n_tri ? id - n_tri : -1, g);
  }
};

// Blocks an SM holds at the least, by instance (see "Occupancy" above).
constexpr int kRegMinBlocks = 3;
constexpr int kDeepMinBlocks = 4;

// Deep: the register or the deep instance of the bounce chain, as the
// whole-table kernel (render_bwd.cu). A block takes ppb pixels (a
// multiple of 32 with ppb * A a multiple of kThreads): ray a of the
// block's pixel l is item a * ppb + l, and thread t takes items t,
// t + kThreads, ...
template <bool Deep>
__global__ void __launch_bounds__(kThreads, Deep ? kDeepMinBlocks : kRegMinBlocks)
    render_bwd_streamed_kernel(const float* __restrict__ g_tri, const float* __restrict__ g_sph,
                               const float* __restrict__ g_cam, const float* __restrict__ g_img,
                               const int* __restrict__ pid, const float* __restrict__ lit_in,
                               const int* __restrict__ bid, float* __restrict__ dlane,
                               float* __restrict__ partial, float* __restrict__ img,
                               float* __restrict__ chain, Params P, int ppb) {
  extern __shared__ float smem[];
  const int A = P.aa_x * P.aa_y;
  const int acc_cols = P.n_sph * kGradCols + kCamCols;
  float* cam = smem;
  float* acc = cam + kCamCols;           // [kWarps][acc_cols]
  float* col = acc + kWarps * acc_cols;  // [A][3][ppb]: the rays' radiance

  for (int i = threadIdx.x; i < kCamCols; i += blockDim.x) cam[i] = g_cam[i];
  for (int i = threadIdx.x; i < kWarps * acc_cols; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();

  float* wacc = acc + (threadIdx.x >> 5) * acc_cols;
  StreamedTables tb;
  tb.tri = g_tri;
  tb.sph = g_sph;
  tb.wacc = wacc;
  tb.n_pix = (size_t)P.rows * P.width;
  tb.n_tri = P.n_tri;
  tb.A = A;
  constexpr bool Chain = true;
  const size_t n_pix = tb.n_pix;
  const size_t chain_stride = (size_t)gridDim.x * blockDim.x;

  const V3 r0 = load3(cam), r1 = load3(cam + 3), r2 = load3(cam + 6);
  const V3 cam_pos = load3(cam + 9), light = load3(cam + 12);
  const V3 light_rgb = load3(cam + 15), indirect = load3(cam + 18);
  const float fA = (float)A, fS = (float)P.shadow_samples;
  float dcam[kCamCols];
#pragma unroll
  for (int i = 0; i < kCamCols; ++i) dcam[i] = 0.0f;
  // the deep chain's slot is the thread's, reused by its items in turn
  ChainSteps<Deep> saved;
  ChainIds<Deep> saved_id;
  deep_chain<Deep>(saved, saved_id, chain, (size_t)blockIdx.x * blockDim.x + threadIdx.x,
                   chain_stride);

  for (int item = threadIdx.x; item < ppb * A; item += kThreads) {
    const int a = item / ppb, lp = item - a * ppb;
    const size_t p = (size_t)blockIdx.x * ppb + lp;
    // a lane past the ragged edge stays: it carries no ray (it reads no
    // id >= 0, so it never stores) but takes part in the warp's shuffles
    const bool in_img = p < n_pix;
    const int py = in_img ? (int)(p / P.width) : 0;
    const int px = in_img ? (int)(p - (size_t)py * P.width) : 0;
    const float bx0 = (float)px * (float)P.aa_x - P.half_w;
    const float by0 = (float)(P.row0 + py) * (float)P.aa_y - P.half_h;
    V3 gpix = zero3();
    if (in_img) gpix = load3(g_img + p * 3);
    // cotangent of one ray's color: the AA mean is sum / A
    const V3 dcolor = make(gpix.x / fA, gpix.y / fA, gpix.z / fA);
    tb.dlane = dlane + p * kGradCols;
    V3 img_acc = zero3();
#define REPLAY_LOAD_ROW(id) tb.load(id)
#define REPLAY_SCATTER(site, a, id, g) tb.scatter(site, a, id, g)
#include "bwd_ray.cuh"
#undef REPLAY_LOAD_ROW
#undef REPLAY_SCATTER
    col[(a * 3 + 0) * ppb + lp] = img_acc.x;
    col[(a * 3 + 1) * ppb + lp] = img_acc.y;
    col[(a * 3 + 2) * ppb + lp] = img_acc.z;
  }

  // --- camera cotangents: the warp's 21 sums ---
  warp_camera(wacc + P.n_sph * kGradCols, dcam);
  __syncthreads();

  // --- the replayed radiance: each pixel's rays added in ray order, ((0 +
  // c0) + c1) + ..., and divided by A, as one thread looping over them ---
  for (int l = threadIdx.x; P.want_img && l < ppb; l += kThreads) {
    const size_t p = (size_t)blockIdx.x * ppb + l;
    if (p >= n_pix) break;
    V3 s = zero3();
    for (int a = 0; a < A; ++a)
      s = add(s, make(col[(a * 3 + 0) * ppb + l], col[(a * 3 + 1) * ppb + l],
                      col[(a * 3 + 2) * ppb + l]));
    img[p * 3 + 0] = s.x / fA;
    img[p * 3 + 1] = s.y / fA;
    img[p * 3 + 2] = s.z / fA;
  }

  // --- the block's partial row: its warps' accumulators added in order ---
  float* out = partial + (size_t)blockIdx.x * acc_cols;
  for (int i = threadIdx.x; i < acc_cols; i += blockDim.x) {
    float s = acc[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += acc[w * acc_cols + i];
    out[i] = s;
  }
}

// The segmented sum: out[t] = the sum of rows[order[j]] over the sorted
// positions j in [bounds[t], bounds[t + 1]), for t < n_seg. Long runs are
// split over warps in two passes, so that no warp's work grows with a
// run's length beyond kSegTile rows plus one partial per tile:
// - segment_sum_tiles_kernel, one warp per aligned tile of kSegTile sorted
//   positions that lies wholly inside one run of an id in [0, n_seg): the
//   tile's rows summed into tiles[i];
// - segment_sum_runs_kernel, one warp per id: the positions of its run
//   before its first whole tile, then the partials of its whole tiles in
//   tile order, then the positions after its last whole tile.
// In both, lane l sums the float4 of columns 4 (l & 3) .. 4 (l & 3) + 3 of
// every eighth position (or tile) from l >> 2 on, front to back, and the
// eight groups meet in a fixed butterfly. The order of every addition
// depends on the sorted positions alone, so two runs give the same bits;
// no float atomics anywhere.
constexpr int kSegTile = 128;

// The sum of the eight lane groups' float4 (lanes l, l ^ 4, l ^ 8, ...).
__device__ __forceinline__ float4 groups_sum(float4 s) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    s.x += __shfl_xor_sync(kFull, s.x, off);
    s.y += __shfl_xor_sync(kFull, s.y, off);
    s.z += __shfl_xor_sync(kFull, s.z, off);
    s.w += __shfl_xor_sync(kFull, s.w, off);
  }
  return s;
}

__device__ __forceinline__ void add4(float4& s, float4 v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// Lane group g's sum over the positions [j0 + g, j1) in steps of 8: the
// float4 q of each position's row.
__device__ __forceinline__ void gather_rows(float4& s, const float4* __restrict__ rows,
                                            const long long* __restrict__ order, long long j0,
                                            long long j1, int g, int q) {
  // unrolled so that several gathers are in flight; the adds keep their order
#pragma unroll 4
  for (long long j = j0 + g; j < j1; j += 8) add4(s, rows[order[j] * 4 + q]);
}

__global__ void __launch_bounds__(kThreads)
    segment_sum_tiles_kernel(const float4* __restrict__ rows, const long long* __restrict__ order,
                             const int* __restrict__ sorted_ids, float4* __restrict__ tiles,
                             long long n, int n_seg) {
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long j0 = i * kSegTile;
  if (j0 + kSegTile > n) return;  // not a whole tile; whole warps leave together
  const int id = sorted_ids[j0];
  if (id != sorted_ids[j0 + kSegTile - 1] || id < 0 || id >= n_seg) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  gather_rows(s, rows, order, j0, j0 + kSegTile, g, q);
  s = groups_sum(s);
  if (g == 0) tiles[i * 4 + q] = s;
}

__global__ void __launch_bounds__(kThreads)
    segment_sum_runs_kernel(const float4* __restrict__ rows, const long long* __restrict__ order,
                            const long long* __restrict__ bounds,
                            const float4* __restrict__ tiles, float4* __restrict__ out,
                            int n_seg) {
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= n_seg) return;  // whole warps leave together
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const long long b = bounds[t], e = bounds[t + 1];
  // the whole tiles of the run: [i0, i1)
  const long long i0 = (b + kSegTile - 1) / kSegTile, i1 = e / kSegTile;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i0 >= i1) {
    gather_rows(s, rows, order, b, e, g, q);
  } else {
    gather_rows(s, rows, order, b, i0 * kSegTile, g, q);
#pragma unroll 4
    for (long long i = i0 + g; i < i1; i += 8) add4(s, tiles[i * 4 + q]);
    gather_rows(s, rows, order, i1 * kSegTile, e, g, q);
  }
  s = groups_sum(s);
  if (g == 0) out[(size_t)t * 4 + q] = s;
}

// Shared memory of one block: the camera row, the warps' sphere and camera
// accumulators and the radiance of the block's rays.
size_t streamed_smem(const Params& P, int ppb) {
  return sizeof(float) * (kCamCols + kWarps * ((size_t)P.n_sph * kGradCols + kCamCols) +
                          (size_t)ppb * P.aa_x * P.aa_y * 3);
}

// Whether ppb is a block's pixel count the kernel takes for A rays a pixel.
bool valid_ppb(int ppb, int A) { return ppb > 0 && ppb % 32 == 0 && (ppb * A) % kThreads == 0; }

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Launches one streamed backward pass on `stream`, ppb pixels a block (a
// multiple of 32, ppb * A a multiple of 128: kernels/render_fwd.py:
// pixels_per_block); ip, fp, g, pid, lit, bid and img as render_bwd_launch
// (render_bwd.cu). dlane [(1 + bounces) * A * rows * W, 16] must arrive
// zeroed; partial [blocks, n_sph*16 + 21] is overwritten, blocks =
// ceil(rows*W / ppb); chain [kChainFloats * bounces * blocks * 128] when
// bounces > 16, else null. Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a ppb the kernel does not take or a deep config
// without its chain.
extern "C" int render_bwd_streamed_launch(const float* tri, const float* sph, const float* cam,
                                          const float* g, const int* pid, const float* lit,
                                          const int* bid, float* dlane, float* partial,
                                          float* img, float* chain, const int* ip,
                                          const float* fp, int ppb, void* stream) {
  const Params P = make_params(ip, fp);
  const bool deep = P.bounces > kRegBounces;
  if ((deep && chain == nullptr) || !valid_ppb(ppb, P.aa_x * P.aa_y))
    return (int)cudaErrorInvalidValue;
  const long long n_pix = (long long)P.rows * P.width;
  if (n_pix == 0) return 0;
  const size_t smem = streamed_smem(P, ppb);
  const auto kernel = deep ? render_bwd_streamed_kernel<true> : render_bwd_streamed_kernel<false>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((n_pix + ppb - 1) / ppb);
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(tri, sph, cam, g, pid, lit, bid, dlane,
                                                          partial, img, chain, P, ppb);
  return (int)cudaGetLastError();
}

// How many blocks of the streamed kernel's instance for these parameters
// and ppb one SM holds (the runtime's occupancy count), into *blocks.
extern "C" int render_bwd_streamed_blocks_per_sm(const int* ip, const float* fp, int ppb,
                                                 int* blocks) {
  const Params P = make_params(ip, fp);
  if (!valid_ppb(ppb, P.aa_x * P.aa_y)) return (int)cudaErrorInvalidValue;
  const size_t smem = streamed_smem(P, ppb);
  const auto kernel = P.bounces > kRegBounces ? render_bwd_streamed_kernel<true>
                                              : render_bwd_streamed_kernel<false>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, smem);
}

// Launches the segmented sum on `stream`, both passes: rows [n, 16]
// float32 (16-byte aligned), order (int64 row indices, sorted by id),
// sorted_ids [n] (int32, the ids in that order) and bounds [n_seg + 1]
// (int64 positions in order) on the device; tiles [ceil(n / kSegTile), 16]
// is scratch; out [n_seg, 16] is overwritten.
extern "C" int segment_sum_launch(const float* rows, const long long* order,
                                  const int* sorted_ids, const long long* bounds, float* tiles,
                                  float* out, long long n, int n_seg, void* stream) {
  if (n_seg == 0) return 0;
  const auto* r4 = reinterpret_cast<const float4*>(rows);
  const long long n_tiles = n / kSegTile;  // whole tiles only
  if (n_tiles > 0) {
    const unsigned blocks = (unsigned)((n_tiles + kWarps - 1) / kWarps);
    segment_sum_tiles_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        r4, order, sorted_ids, reinterpret_cast<float4*>(tiles), n, n_seg);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((n_seg + kWarps - 1) / kWarps);
  segment_sum_runs_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      r4, order, bounds, reinterpret_cast<const float4*>(tiles), reinterpret_cast<float4*>(out),
      n_seg);
  return (int)cudaGetLastError();
}
