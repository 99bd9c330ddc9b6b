// Per-shard partial-scan kernels for Hopper (sm_90a): the triangle scans of
// the triangle-sharded (tp) wavefront pipeline, for an arbitrary ray batch.
//
// Replace the TPU kernels kernels/partial.py:_nearest_kernel and
// kernels/partial.py:_occluded_kernel of the JAX package. A shard holds a
// slice of the scene's triangles; nearest_tris_kernel finds each ray's
// nearest hit among them and occluded_tris_kernel whether any of them
// blocks the ray before the light. The winners of the shards are combined
// outside (ops/intersect.py: min t, lowest index on a tie, masked sum);
// spheres are not sharded and are not scanned here.
//
// Design:
// - One thread per ray. A batch is [N,3] starts and directions, contiguous
//   float32, read as they are: no (8,128) ray tiles, no padding, no packed
//   128-lane table rows, no "big" sentinel in the interface (a miss is
//   t = inf, id -1).
// - The block stages the shard's table through shared memory kThreads rows
//   at a time and every thread tests its ray against the tile. Every ray of
//   a batch runs exactly one scan, so the only block-uniform matter is the
//   ragged last block, whose spare threads load and wait.
// - The per-row arithmetic is the forward render kernels' own
//   (fwd_common.cuh): tri_test / nearest_finish, the general own-origin
//   test of the bounce scan, with a strict < in row order, so a tie goes to
//   the lowest row as argmin gives it to the plain version; occ_row, the
//   division-free occlusion test. A shard that holds the whole scene
//   therefore decides as the streamed forward kernel decides.
// - The winner id is an int32 output, not a float lane.
// - The occlusion scan (K5) was redesigned after a split of its time on
//   the dense_8192 frame (PERF.md, chip_timing.py --split): its row loop
//   ran at 61% of FP32 issue where the nearest-hit scan's reaches 73%, a
//   warp used 85% of its lane-rows (it runs as long as its slowest lane),
//   and an occluded ray's first occluder sits at row ~3,070 of 8,192. A
//   ray's bit is the OR of the same row tests in any order, so the kernel
//   may test more rows, or test them otherwise, and give the same bits:
//   * it tests kOccGroup rows a step as independent predicates and leaves
//     after the step that found an occluder, so the rows of a step overlap;
//   * a row is three float4 reads from the tile; a row that casts no
//     shadow (glass) and the rows past the table's end are stored as zeros,
//     which occ_row never counts, so there is no casts_shadow branch and no
//     bound in the loop;
//   * compacting the block's seeking rays into its low threads at tile
//     boundaries (so that warps with no ray left skip the tests) measured
//     the same time and was dropped (PERF.md);
//   * the block leaves when no ray is seeking (__syncthreads_or).
//   A cache of the rows that occluded a block's rays, tested first, was
//   not built: the rays of a block test the rows in one order, so a row
//   that occludes a neighbour lies at or after the ray's own first
//   occluder whenever it occludes the ray, and the cache could only add
//   tests (PERF.md).
//
// What bounds them on this card: the FP32 instruction rate (rays x rows x
// about 70 operations for a nearest-hit test, 55 for an occlusion test);
// the rays are 24-28 B read and 4-48 B written each, the table is read
// from the L2 cache once per block. No cp.async or TMA pipeline yet.
//
// Built with --fmad=false, never --use_fast_math (see render_fwd.cu).

#include <cmath>

#include "fwd_common.cuh"

namespace {

__device__ __forceinline__ void store3(float* p, V3 a) {
  p[0] = a.x;
  p[1] = a.y;
  p[2] = a.z;
}

__global__ void __launch_bounds__(kThreads)
    nearest_tris_kernel(const float* __restrict__ g_tri, const float* __restrict__ g_start,
                        const float* __restrict__ g_d, float* __restrict__ t_out,
                        float* __restrict__ pos, float* __restrict__ nrm,
                        float* __restrict__ rgb, float* __restrict__ mat,
                        int* __restrict__ idx, int n_tri, int n_rays) {
  __shared__ float tile[kThreads * kTriCols];
  const size_t r = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  // threads past the ragged edge stay: they carry no ray but load tiles
  const bool in = r < (size_t)n_rays;
  const V3 start = in ? load3(g_start + r * 3) : make(0.0f, 0.0f, 0.0f);
  const V3 d = in ? load3(g_d + r * 3) : make(0.0f, 0.0f, 0.0f);
  const V3 nd = make(-d.x, -d.y, -d.z);

  Best best = no_best();
  for (int base = 0; base < n_tri; base += kThreads) {
    __syncthreads();
    const int n = load_tile(tile, g_tri, kTriCols, n_tri, base);
    __syncthreads();
    if (in)
      for (int i = 0; i < n; ++i) tri_test(start, nd, tile + i * kTriCols, base + i, best);
  }
  if (!in) return;

  Params P = {};  // no spheres: nearest_finish reads only n_sph
  const HitInfo h = nearest_finish(P, g_tri, nullptr, start, d, best);
  t_out[r] = best.id >= 0 ? h.t : INFINITY;
  store3(pos + r * 3, h.pos);
  store3(nrm + r * 3, h.nrm);
  store3(rgb + r * 3, h.rgb);
  mat[r] = h.mat;
  idx[r] = best.id;
}

// K5's tile of the shadow table in shared memory: 128 rows of v0 e1 e2 E
// as three float4 each. A row that casts no shadow (material -1, glass)
// and the rows past the table's end are stored as zeros, which occ_row
// never counts (dA = 0 fails its triangle bound), so the row loop needs
// neither casts_shadow nor a bound of its own.
constexpr int kShdRow4 = 3;

__device__ __forceinline__ void load_shd_tile(float4* tile, const float* __restrict__ g,
                                              int n_rows, int row0) {
  const int row = row0 + (int)threadIdx.x;
  float R[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) R[c] = 0.0f;
  if (row < n_rows) {
    const float* src = g + (size_t)row * kShdCols;
    if (src[12] != -1.0f) {
#pragma unroll
      for (int c = 0; c < 12; ++c) R[c] = src[c];
    }
  }
  float4* dst = tile + threadIdx.x * kShdRow4;
  dst[0] = make_float4(R[0], R[1], R[2], R[3]);
  dst[1] = make_float4(R[4], R[5], R[6], R[7]);
  dst[2] = make_float4(R[8], R[9], R[10], R[11]);
}

// occ_row (fwd_common.cuh) on row i of the tile, read as three float4.
__device__ __forceinline__ bool occ_tile_row(const float4* tile, int i, V3 start, V3 dir,
                                             float dds, float radius_sq) {
  const float4 a = tile[i * kShdRow4], b = tile[i * kShdRow4 + 1], c = tile[i * kShdRow4 + 2];
  const float R[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
  return occ_row(R, 9, false, start, dir, dds, radius_sq);
}

// Rows tested a step, as independent predicates, before one exit test.
constexpr int kOccGroup = 4;

__global__ void __launch_bounds__(kThreads)
    occluded_tris_kernel(const float* __restrict__ g_shd, const float* __restrict__ g_start,
                         const float* __restrict__ g_d, const float* __restrict__ g_r2,
                         uint8_t* __restrict__ out, int n_tri, int n_rays) {
  __shared__ float4 tile[kThreads * kShdRow4];
  const size_t r = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = r < (size_t)n_rays;
  const V3 start = in ? load3(g_start + r * 3) : make(0.0f, 0.0f, 0.0f);
  const V3 dir = in ? load3(g_d + r * 3) : make(0.0f, 0.0f, 0.0f);
  const float radius_sq = in ? g_r2[r] : 0.0f;
  const float dds = dot(dir, dir);

  // this ray still looks for its first occluder
  bool seeking = in;
  for (int base = 0; base < n_tri; base += kThreads) {
    if (!__syncthreads_or(seeking)) break;  // block-uniform, and the barrier
    load_shd_tile(tile, g_shd, n_tri, base);
    __syncthreads();
    if (seeking) {
      const int n = min(kThreads, n_tri - base);
      for (int i = 0; i < n; i += kOccGroup) {
        bool hit = false;
#pragma unroll
        for (int k = 0; k < kOccGroup; ++k)
          hit |= occ_tile_row(tile, i + k, start, dir, dds, radius_sq);
        if (hit) {
          seeking = false;
          break;
        }
      }
    }
  }
  if (in) out[r] = seeking ? 0 : 1;
}

}  // namespace

// Nearest hit of n_rays rays (start, d: [n_rays,3]) among the n_tri rows of
// tri [n_tri,19] (v0 e1 e2 n rgb mat E), on `stream`. Writes t [n_rays]
// (inf on a miss), pos, nrm, rgb [n_rays,3] (zeros on a miss), mat [n_rays]
// (1 on a miss) and idx [n_rays] (the winning row, -1 on a miss). Returns
// cudaGetLastError() of the launch.
extern "C" int nearest_tris_launch(const float* tri, const float* start, const float* d,
                                   float* t, float* pos, float* nrm, float* rgb, float* mat,
                                   int* idx, int n_tri, int n_rays, void* stream) {
  if (n_rays == 0) return 0;
  const unsigned blocks = (unsigned)(((long long)n_rays + kThreads - 1) / kThreads);
  nearest_tris_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tri, start, d, t, pos, nrm, rgb, mat, idx, n_tri, n_rays);
  return (int)cudaGetLastError();
}

// Occlusion of n_rays rays (start, d: [n_rays,3], radius_sq [n_rays]) by
// the n_tri rows of shd [n_tri,13] (v0 e1 e2 E mat), on `stream`. Writes
// out [n_rays], one byte per ray: 1 where a row that casts a shadow lies
// before the light. Returns cudaGetLastError() of the launch.
extern "C" int occluded_tris_launch(const float* shd, const float* start, const float* d,
                                    const float* radius_sq, uint8_t* out, int n_tri,
                                    int n_rays, void* stream) {
  if (n_rays == 0) return 0;
  const unsigned blocks = (unsigned)(((long long)n_rays + kThreads - 1) / kThreads);
  occluded_tris_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      shd, start, d, radius_sq, out, n_tri, n_rays);
  return (int)cudaGetLastError();
}
