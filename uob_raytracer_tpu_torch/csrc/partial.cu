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
// - A batch is [N,3] starts and directions, contiguous float32, read as
//   they are: no (8,128) ray tiles, no padding, no packed 128-lane table
//   rows, no "big" sentinel in the interface (a miss is t = inf, id -1).
// - The per-row arithmetic is the forward render kernels' own
//   (fwd_common.cuh), with a strict < in row order, so a tie goes to the
//   lowest row as argmin gives it to the plain version: tri_test's Cramer
//   solve for the nearest hit (in the form below), nearest_finish for the
//   winner's attributes; occ_row, the division-free occlusion test. A shard
//   that holds the whole scene therefore decides as the streamed forward
//   kernel decides.
// - The winner id is an int32 output, not a float lane.
// - The nearest-hit scan (K4) was redesigned after a split of its time on
//   the dense_8192 frame, the tp=2 shard and the 600-row shard (PERF.md,
//   chip_timing.py --split k4). One thread per ray issued its 94
//   instructions a row at about 83% of the card's rate, so only fewer
//   instructions could pay where rows are many; where they are few the grid
//   decided (the 600-row shard's 8,192 rays filled 64 of 132 SMs). Now:
//   * kNearGroups = 4 thread groups a ray, a block of 128 threads holding
//     32 rays; every warp is one group, so a warp tests one row at a time
//     and the tile reads stay broadcasts. The block stages a tile of 128
//     rows, group g tests its slice g of 32 rows, and at the end the
//     groups' winners are merged by (t, row), the lower row on equal t: the
//     id, t, u and v of one scan of all rows in order. Four groups were the
//     fastest or within 0.7% of it from 8,192 to 1,048,576 rays against
//     one and two (PERF.md, chip_timing.py --split k4);
//   * a row of the tile is v0 e1 e2 C as three float4 (48 B), C the
//     cofactors of (e1, e2) that det3 expands, computed once a row when
//     the tile is staged; detA and the t numerator are then three products
//     and two sums each, the same operations in the same order as det3, so
//     the bits are tri_test's (E = cross(e1, e2) would not give them: its
//     middle term differs from det3's in the sign of a zero). Rows past the
//     table's end are zeros, which never win (detA = 0), so the row loop
//     has no bound;
//   * the table is K4's own 16-float row (v0 e1 e2 n rgb mat, 64 B),
//     staged as float4 reads; the winner's position, n, rgb and mat are
//     read once from device memory, as nearest_finish reads them.
//   What bounds it now: the instructions it issues, about 80 a row at about
//   93% of the card's rate; the largest piece is the division with its
//   per-lane check for the slow path (15% of the time).
// - The occlusion scan (K5) was redesigned after a split of its time on
//   the dense_8192 frame (PERF.md, chip_timing.py --split): its row loop
//   ran at 61% of FP32 issue where the nearest-hit scan's reaches 73%, a
//   warp used 85% of its lane-rows (it runs as long as its slowest lane),
//   and an occluded ray's first occluder sits at row ~3,070 of 8,192. A
//   ray's bit is the OR of the same row tests in any order, so the kernel
//   may test more rows, or test them otherwise, and give the same bits:
//   * one thread per ray; the block stages the shadow table 128 rows at a
//     time;
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
// about 52 operations for a nearest-hit test, flops.nearest_work, and 55
// for an occlusion test); the rays are 24-28 B read and 4-48 B written
// each, the table is read from the L2 cache once per block. No cp.async or
// TMA pipeline yet.
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

// K4's table: a row of v0 e1 e2 n rgb mat (16 floats, 64 B, four float4).
constexpr int kNearCols = 16;
// K4's thread groups a ray (kernels/partial.py:NEAR_GROUPS).
constexpr int kNearGroups = 4;
// K4's tile of that table in shared memory: kThreads rows of v0 e1 e2 C as
// three float4 each, C = cofactors(e1, e2). The rows past the table's end
// are zeros: detA = 0 there, so they never win.
constexpr int kNearRow4 = 3;

// The cofactors of rows (b, c) that det3 (vec3.cuh) expands a along:
// det3(a, b, c) == cofactor_det(a, cofactors(b, c)) bit for bit, each a
// product and a difference in det3's order.
__device__ __forceinline__ V3 cofactors(V3 b, V3 c) {
  return make(b.y * c.z - b.z * c.y, b.x * c.z - b.z * c.x, b.x * c.y - b.y * c.x);
}
__device__ __forceinline__ float cofactor_det(V3 a, V3 C) {
  return a.x * C.x - a.y * C.y + a.z * C.z;
}

__device__ __forceinline__ void load_near_tile(float4* tile, const float* __restrict__ g,
                                               int n_rows, int row0) {
  const int row = row0 + (int)threadIdx.x;
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), m = a, c = a;
  if (row < n_rows) {
    const float4* src = reinterpret_cast<const float4*>(g + (size_t)row * kNearCols);
    a = src[0];  // v0, e1.x
    m = src[1];  // e1.y e1.z, e2.x e2.y
    const float4 q = src[2];  // e2.z, n
    const V3 C = cofactors(make(a.w, m.x, m.y), make(m.z, m.w, q.x));
    c = make_float4(q.x, C.x, C.y, C.z);
  }
  float4* dst = tile + threadIdx.x * kNearRow4;
  dst[0] = a;
  dst[1] = m;
  dst[2] = c;
}

// tri_test (fwd_common.cuh) on row i of the tile, table row `id`: detA =
// det3(nd, e1, e2) and the t numerator det3(b, e1, e2) from the row's
// cofactors, u and v by det3 as there. The same operations in the same
// order, so the same bits.
__device__ __forceinline__ void near_tile_row(const float4* tile, int i, V3 start, V3 nd, int id,
                                              Best& best) {
  const float4 a = tile[i * kNearRow4], m = tile[i * kNearRow4 + 1], c = tile[i * kNearRow4 + 2];
  const V3 v0 = make(a.x, a.y, a.z), e1 = make(a.w, m.x, m.y), e2 = make(m.z, m.w, c.x);
  const V3 C = make(c.y, c.z, c.w);
  const V3 b = sub(start, v0);
  const float detA = cofactor_det(nd, C);
  const bool degen = detA == 0.0f;
  const float recip = 1.0f / (degen ? 1.0f : detA);
  const float t = cofactor_det(b, C) * recip;
  const float u = det3(nd, b, e2) * recip;
  const float v = det3(nd, e1, b) * recip;
  if (t >= 0.0f && u >= 0.0f && v >= 0.0f && (u + v) <= 1.0f && !degen && t < best.t) {
    best.t = t;
    best.u = u;
    best.v = v;
    best.id = id;
  }
}

// The groups' winners of each ray merged into group 0's thread by (t,
// row): the lower t, the lower row on equal t. Each group's winner is the
// lowest of its rows at its least t, so the merge gives the winner of one
// scan of every row in order with the strict <. `w` is the tile, reused
// (one float4 a thread); every thread of the block calls it.
__device__ __forceinline__ Best merge_groups(float4* w, Best best, int g, int slot) {
  constexpr int kRays = kThreads / kNearGroups;
  __syncthreads();
  w[threadIdx.x] = make_float4(best.t, best.u, best.v, __int_as_float(best.id));
  __syncthreads();
  if (g == 0) {
#pragma unroll
    for (int h = 1; h < kNearGroups; ++h) {
      const float4 o = w[h * kRays + slot];
      const int id = __float_as_int(o.w);
      if (o.x < best.t || (o.x == best.t && id >= 0 && id < best.id)) {
        best.t = o.x;
        best.u = o.y;
        best.v = o.z;
        best.id = id;
      }
    }
  }
  return best;
}

// kNearGroups thread groups a ray: a block holds kRays = kThreads /
// kNearGroups rays; thread x is ray slot x % kRays of group x / kRays, so
// each warp is one group.
__global__ void __launch_bounds__(kThreads)
    nearest_tris_kernel(const float* __restrict__ g_tri, const float* __restrict__ g_start,
                        const float* __restrict__ g_d, float* __restrict__ t_out,
                        float* __restrict__ pos, float* __restrict__ nrm,
                        float* __restrict__ rgb, float* __restrict__ mat,
                        int* __restrict__ idx, int n_tri, int n_rays) {
  constexpr int kRays = kThreads / kNearGroups;   // rays a block
  constexpr int kSlice = kThreads / kNearGroups;  // rows of a tile a group tests
  __shared__ float4 tile[kThreads * kNearRow4];
  const int slot = (int)threadIdx.x % kRays, g = (int)threadIdx.x / kRays;
  const size_t r = (size_t)blockIdx.x * kRays + slot;
  // threads past the ragged edge stay: they carry no ray but load tiles
  const bool in = r < (size_t)n_rays;
  const V3 start = in ? load3(g_start + r * 3) : make(0.0f, 0.0f, 0.0f);
  const V3 d = in ? load3(g_d + r * 3) : make(0.0f, 0.0f, 0.0f);
  const V3 nd = make(-d.x, -d.y, -d.z);

  Best best = no_best();
  for (int base = 0; base < n_tri; base += kThreads) {
    __syncthreads();
    load_near_tile(tile, g_tri, n_tri, base);
    __syncthreads();
    if (in) {
#pragma unroll 4
      for (int i = g * kSlice; i < (g + 1) * kSlice; ++i)
        near_tile_row(tile, i, start, nd, base + i, best);
    }
  }
  best = merge_groups(tile, best, g, slot);
  if (!in || g != 0) return;

  // the winner's attributes, as nearest_finish (fwd_common.cuh) takes them
  V3 hp = make(0.0f, 0.0f, 0.0f), hn = hp, hc = hp;
  float hm = 1.0f;
  if (best.id >= 0) {
    const float* T = g_tri + (size_t)best.id * kNearCols;
    hp = add(load3(T), add(scale(best.u, load3(T + 3)), scale(best.v, load3(T + 6))));
    hn = load3(T + 9);
    hc = load3(T + 12);
    hm = T[15];
  }
  t_out[r] = best.id >= 0 ? best.t : INFINITY;
  store3(pos + r * 3, hp);
  store3(nrm + r * 3, hn);
  store3(rgb + r * 3, hc);
  mat[r] = hm;
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
// tri [n_tri,16] (v0 e1 e2 n rgb mat, 16-byte aligned), on a grid of
// `blocks` blocks (kernels/partial.py:nearest_grid, at least
// n_rays * kNearGroups / 128), on `stream`. Writes t [n_rays] (inf on a
// miss), pos, nrm, rgb [n_rays,3] (zeros on a miss), mat [n_rays] (1 on a
// miss) and idx [n_rays] (the winning row, -1 on a miss). Returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for too small
// a grid.
extern "C" int nearest_tris_launch(const float* tri, const float* start, const float* d,
                                   float* t, float* pos, float* nrm, float* rgb, float* mat,
                                   int* idx, int n_tri, int n_rays, int blocks, void* stream) {
  if (n_rays == 0) return 0;
  if ((long long)blocks * kThreads < (long long)n_rays * kNearGroups)
    return (int)cudaErrorInvalidValue;
  nearest_tris_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tri, start, d, t, pos, nrm, rgb, mat, idx, n_tri, n_rays);
  return (int)cudaGetLastError();
}

// How many blocks of the nearest-hit kernel one SM of the current device
// holds (the runtime's occupancy count), into *blocks: an instrument for
// the split and chip_smoke.py.
extern "C" int nearest_tris_blocks_per_sm(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, nearest_tris_kernel,
                                                            kThreads, 0);
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
