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
// Design (simple first):
// - One thread per ray. A batch is [N,3] starts and directions, contiguous
//   float32, read as they are: no (8,128) ray tiles, no padding, no packed
//   128-lane table rows, no "big" sentinel in the interface (a miss is
//   t = inf, id -1).
// - The block stages the shard's table through shared memory kThreads rows
//   at a time (load_tile) and every thread tests its ray against the tile.
//   Every ray of a batch runs exactly one scan, so the only block-uniform
//   matter is the ragged last block, whose spare threads load and wait.
// - The per-row arithmetic is the forward render kernels' own
//   (fwd_common.cuh): tri_test / nearest_finish, the general own-origin
//   test of the bounce scan, with a strict < in row order, so a tie goes to
//   the lowest row as argmin gives it to the plain version; occ_row behind
//   casts_shadow on plain triangle rows, the division-free occlusion test.
//   A shard that holds the whole scene therefore decides as the streamed
//   forward kernel decides.
// - The occlusion scan leaves a ray alone once it is occluded and ends when
//   no ray of the block is still looking (__syncthreads_or).
// - The winner id is an int32 output, not a float lane.
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

__global__ void __launch_bounds__(kThreads)
    occluded_tris_kernel(const float* __restrict__ g_shd, const float* __restrict__ g_start,
                         const float* __restrict__ g_d, const float* __restrict__ g_r2,
                         uint8_t* __restrict__ out, int n_tri, int n_rays) {
  __shared__ float tile[kThreads * kShdCols];
  const size_t r = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = r < (size_t)n_rays;
  const V3 start = in ? load3(g_start + r * 3) : make(0.0f, 0.0f, 0.0f);
  const V3 dir = in ? load3(g_d + r * 3) : make(0.0f, 0.0f, 0.0f);
  const float radius_sq = in ? g_r2[r] : 0.0f;
  const float dds = dot(dir, dir);
  Params P = {};  // casts_shadow reads only cpu_ref: materials count

  // this ray still looks for its first occluder
  bool seeking = in;
  for (int base = 0; base < n_tri; base += kThreads) {
    if (!__syncthreads_or(seeking)) break;  // block-uniform, and the barrier
    const int n = load_tile(tile, g_shd, kShdCols, n_tri, base);
    __syncthreads();
    if (seeking)
      for (int i = 0; i < n; ++i) {
        const float* R = tile + i * kShdCols;
        if (!casts_shadow(P, R, 12)) continue;
        if (occ_row(R, 9, false, start, dir, dds, radius_sq)) {
          seeking = false;
          break;
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
