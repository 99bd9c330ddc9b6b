// Streamed forward render kernel for Hopper (sm_90a): the large-scene
// variant of render_fwd.cu, one launch per frame for any triangle count.
//
// Replaces the streamed mode of the TPU kernel kernels/render_fwd.py:
// _render_kernel(streamed=True) of the JAX package (_streamed_scan,
// _streamed_tri_scan, the merged primary scan and the mixed quad/triangle
// occlusion scan). It computes the same frame and the same decision record
// as the whole-table kernel, with the triangle table tri [T,19] and the
// optional shadow table shd [n_shd,13] left in device memory: a block
// stages them tile by tile (kThreads rows at a time) into shared memory and
// all its threads scan the tile. Spheres and the camera row are staged
// whole. The tables are read as pack_scene / pack_shadow build them; the
// last tile is simply shorter (the TPU kernel's 128-lane packed rows are
// Mosaic's alignment rule and are not carried over).
//
// Design:
// - One thread per AA ray. A pixel's A rays sit in adjacent threads of
//   one block, floor(128 / A) pixels a block (A > 128: one pixel a block,
//   each thread taking every 128th ray). At 128x128 with 2x2 AA that is
//   512 blocks, where one thread per pixel gave 128 blocks of 4 warps on
//   132 SMs, under one warp per scheduler, and the scans waited on
//   latency. Each ray seeds its RNG from
//   its pixel's id and writes its own record entries; its colour goes to
//   shared memory, and one thread per pixel adds the A colours as
//   ((0 + c0) + c1) + ... in ray order, as the whole-table kernel's loop
//   over the rays does, scales by 1/A and writes the pixel.
// - Every per-row test, the bounce step, the shading set-up, the RNG and
//   the pack are the functions of fwd_common.cuh that the whole-table
//   kernel calls, rows come in index order with a strict < on t, and ids
//   are global triangle indices: a scene that both kernels can run gives
//   the same image and the same record bit for bit.
// - A cooperative tile load needs every thread of the block at the same
//   scan, so no thread leaves early (threads past the ragged edge or past
//   the block's last whole pixel carry no ray and only load) and every
//   loop around a scan is block-uniform: the bounce loop runs while ANY
//   ray of the block is active and the occlusion scan of a chunk of
//   samples runs while any ray of the block still has a sample of the
//   chunk that no row has occluded (__syncthreads_or), with finished rays
//   masked.
// - The soft-shadow pass sweeps the occlusion table once per chunk of
//   kChunk samples, not once per sample, in the whole-table kernel's order
//   (render_fwd.cu: occluded_samples): the chunk's sample directions are
//   drawn into registers in sample order, with a bit mask of the samples
//   still live; for each row that casts a shadow its invariants are
//   computed once (occ_row_invariants) and the sample part runs for every
//   sample of the chunk (occ_row_sample), the chunk's size a template
//   argument so that its tests unroll with no branch (unoccluded); the
//   spheres come after the rows, for the samples still live. The lit count
//   is S less the occluded samples, which does not depend on the order of
//   the tests, and each test is occ_row's operations in occ_row's order:
//   the count is the per-sample scan's, bit for bit. On the 8,192-triangle
//   scene at 3 samples a shading ray sweeps the table once where it swept
//   it three times.
// - The primary hit keeps its shared-origin form: each thread computes the
//   seven invariants of the tile row it loaded. The winner's attributes
//   (normal, colour, material) are read from device memory by index after
//   the scan, which a CUDA thread can do by itself, so the table is swept
//   once per scan and nothing is merged into the scan.
// - Each sweep: barrier, every thread copies one row of the tile from
//   device memory (the 622 KB table of 8,192 triangles stays in the L2
//   cache), barrier, scan. Double-buffering the copies with cp.async ran
//   4-6% slower on the H100: with four blocks an SM, the other blocks'
//   scans already hide one block's copy, and the extra barrier and tile
//   cost more than the overlap gains (PERF.md).
//
// What bounds it on this card: the FP32 instruction rate (rays x triangles
// x about 26 to 70 operations per test); the table traffic is L2 reads of
// 76 B per 128 row tests.
//
// Built with --fmad=false, never --use_fast_math (see render_fwd.cu).

#include "fwd_common.cuh"

namespace {

// Sample rays of the soft-shadow pass held in registers at a time. On the
// H100 (ptxas, and K3f's device ms on 8,192 triangles at 128x128, PERF.md):
// 3, 4 and 5 take 128 registers and 4 blocks an SM with 12-84 B of spills
// and ran fastest (4: fastest at 8 samples, within 1% of 3 at 3 samples);
// 6 and 8 take 159 registers and 3 blocks an SM, which puts the 512 blocks
// of a 128x128 frame at 2x2 AA in two waves, 22% slower.
constexpr int kChunk = 4;

// The samples of one chunk of N (the same for every thread of the block)
// that no occluder row and no sphere occludes, from `live`, the chunk's
// samples still unoccluded. The rows are swept tile by tile while any
// thread of the block has a live sample (block-uniform: its barrier is the
// tile's); for each row that casts a shadow, its invariants once, then the
// sample part of all N samples into a mask, with no branch between them (a
// sample already occluded is tested again and stays occluded). Then the
// spheres, for the samples still live.
template <int N>
__device__ __forceinline__ unsigned unoccluded(const Params& P, float* tile, const float* tbl,
                                               const OccTable& o, const float* sph,
                                               const Shade& sh, const V3 (&dir)[kChunk],
                                               const float (&dds)[kChunk], unsigned live) {
  for (int base = 0; base < o.rows; base += kThreads) {
    if (!__syncthreads_or(live != 0u)) break;  // block-uniform, and the barrier
    const int m = load_tile(tile, tbl, o.cols, o.rows, base);
    __syncthreads();
    for (int i = 0; i < m && live; ++i) {
      const float* R = tile + i * o.cols;
      if (!casts_shadow(P, R, o.mcol)) continue;
      const OccRow w = occ_row_invariants(R, o.ecol, sh.sstart);
      const bool quad = base + i < P.n_quads;
      unsigned hit = 0u;
#pragma unroll
      for (int k = 0; k < N; ++k)
        hit |= (unsigned)occ_row_sample(w, quad, dir[k], dds[k], sh.radius_sq) << k;
      live &= ~hit;
    }
  }
  for (int i = 0; i < P.n_sph && live; ++i) {
    const float* Sp = sph + i * kSphCols;
    if (Sp[7] == -1.0f) continue;  // glass casts no shadow
    const OccSph w = occ_sph_invariants(Sp, sh.sstart);
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (((live >> k) & 1u) && occ_sph_sample(w, dir[k], dds[k], sh.radius_sq))
        live &= ~(1u << k);
  }
  return live;
}

__global__ void __launch_bounds__(kThreads)
    render_fwd_streamed_kernel(const float* __restrict__ g_tri, const float* __restrict__ g_sph,
                               const float* __restrict__ g_cam, const float* __restrict__ g_shd,
                               float* __restrict__ img, uint32_t* __restrict__ packed,
                               int* __restrict__ pid, float* __restrict__ lit_out,
                               int* __restrict__ bid, Params P) {
  extern __shared__ float smem[];
  float* tile = smem;                       // [kThreads][kTriCols]
  float* prim = tile + kThreads * kTriCols;  // [kThreads][kPrimCols]
  float* sph = prim + kThreads * kPrimCols;
  float* cam = sph + P.n_sph * kSphCols;
  float* col = cam + kCamCols;  // [pixels of the block][A][3]: the rays' colours

  for (int i = threadIdx.x; i < P.n_sph * kSphCols; i += blockDim.x) sph[i] = g_sph[i];
  for (int i = threadIdx.x; i < kCamCols; i += blockDim.x) cam[i] = g_cam[i];
  __syncthreads();

  const int A = P.aa_x * P.aa_y;
  const int per_pix = min(A, kThreads);  // threads of one pixel
  const int ppb = kThreads / per_pix;    // pixels of the block
  const int lp = (int)threadIdx.x / per_pix, slot = (int)threadIdx.x - lp * per_pix;
  const size_t n_pix = (size_t)P.rows * P.width;
  const size_t p = (size_t)blockIdx.x * ppb + lp;
  // threads past the ragged edge or the block's last whole pixel stay: they
  // carry no ray but load tiles and meet every barrier
  const bool in_img = lp < ppb && p < n_pix;
  const int py = in_img ? (int)(p / P.width) : 0;
  const int px = in_img ? (int)(p - (size_t)py * P.width) : 0;
  const uint32_t gid = (uint32_t)((P.row0 + py) * P.width + px);  // < 2^24

  const V3 cam_pos = load3(cam + 9);
  const V3 r0 = load3(cam), r1 = load3(cam + 3), r2 = load3(cam + 6);
  const V3 light = load3(cam + 12), light_rgb = load3(cam + 15), indirect = load3(cam + 18);
  // shadow-pass occlusion geometry: the quad-merged table if given
  const float* occ_tbl = P.n_shd ? g_shd : g_tri;
  const OccTable occ = occ_table(P);
  const int S = P.shadow_samples;

  const float bx0 = (float)px * (float)P.aa_x - P.half_w;
  const float by0 = (float)(P.row0 + py) * (float)P.aa_y - P.half_h;

  // one round for A <= 128; past that each thread takes every 128th ray
  const int rounds = (A + per_pix - 1) / per_pix;
  for (int round = 0; round < rounds; ++round) {
    const int a = slot + round * per_pix;
    const bool ray = in_img && a < A;
    const V3 d = primary_dir(P, r0, r1, r2, bx0, by0, a);

    // --- primary nearest hit, shared-origin form, tile by tile ---
    float t_b = kBig;
    int idf = -1;
    for (int base = 0; base < P.n_tri; base += kThreads) {
      __syncthreads();
      const int n = load_tile(tile, g_tri, kTriCols, P.n_tri, base);
      if ((int)threadIdx.x < n)
        prim_invariants(cam_pos, tile + threadIdx.x * kTriCols, prim + threadIdx.x * kPrimCols);
      __syncthreads();
      if (ray)
        for (int i = 0; i < n; ++i)
          prim_test(d, tile + i * kTriCols, prim + i * kPrimCols, base + i, t_b, idf);
    }
    if (ray) prim_spheres(P, sph, cam_pos, d, t_b, idf);
    const HitInfo ph = prim_finish(P, g_tri, sph, cam_pos, d, t_b, idf);
    const bool hit = ray && t_b < kBig;
    if (pid && ray) pid[a * n_pix + p] = idf;
    // CPU-ref shades ANY hit triangle (no material logic, skeleton.cpp:268)
    const bool prim_diffuse = P.cpu_ref ? hit : (hit && ph.mat > 0.0f);

    // --- specular bounce loop: while any ray of the block is specular ---
    bool term_valid = false;
    V3 term_pos = make(0.0f, 0.0f, 0.0f), term_nrm = term_pos, term_rgb = term_pos;
    float weight = 1.0f;
    {
      bool active = hit && ph.mat <= 0.0f;
      V3 dcur = d, cpos = ph.pos, cnrm = ph.nrm;
      float cmat = ph.mat, medium = P.ior_air;
      int bi = 0;
      for (; bi < P.bounces; ++bi) {
        if (!__syncthreads_or(active)) break;  // block-uniform
        Bounce b;
        b.dead = false;
        if (active) {
          b = bounce_step(P, dcur, cpos, cnrm, cmat, medium, weight);
          // the reference's NaN direction renders black: the ray retires
          // and this step reads "inactive"
          if (b.dead) active = false;
        }
        Best best = no_best();
        const V3 nd = active ? make(-b.ndir.x, -b.ndir.y, -b.ndir.z) : make(0.0f, 0.0f, 0.0f);
        for (int base = 0; base < P.n_tri; base += kThreads) {
          __syncthreads();
          const int n = load_tile(tile, g_tri, kTriCols, P.n_tri, base);
          __syncthreads();
          if (active)
            for (int i = 0; i < n; ++i) tri_test(b.nstart, nd, tile + i * kTriCols, base + i, best);
        }
        int id_rec = -1;
        if (active) {
          const HitInfo h = nearest_finish(P, g_tri, sph, b.nstart, b.ndir, best);
          id_rec = h.id;
          const bool hit_n = h.t < kBig;
          if (hit_n && h.mat > 0.0f) {
            term_valid = true;
            term_pos = h.pos;
            term_nrm = h.nrm;
            term_rgb = h.rgb;
          }
          active = hit_n && h.mat <= 0.0f;
          if (active) {
            dcur = b.ndir;
            cpos = h.pos;
            cnrm = h.nrm;
            cmat = h.mat;
            medium = b.nmed;
          }
        }
        if (bid && ray) bid[((size_t)bi * A + a) * n_pix + p] = id_rec;
      }
      // steps no ray of the block ran read "inactive"
      if (bid && ray)
        for (; bi < P.bounces; ++bi) bid[((size_t)bi * A + a) * n_pix + p] = -1;
    }

    // --- one soft-shadow pass at the unified shading point ---
    const bool shading = prim_diffuse || term_valid;
    Shade sh;
    sh.sdir = sh.sstart = make(0.0f, 0.0f, 0.0f);
    sh.radius_sq = sh.lam_base = 0.0f;
    if (shading)
      sh = shade_setup(P, light, sel(prim_diffuse, ph.pos, term_pos),
                       sel(prim_diffuse, ph.nrm, term_nrm));
    Rng rng = rng_seed(gid);
    int dark = 0;
    for (int s0 = 0; s0 < S; s0 += kChunk) {
      const int n = min(kChunk, S - s0);
      V3 dir[kChunk];
      float dds[kChunk];
      // the chunk's n samples; the loops end at n (the same for every lane)
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (k >= n) break;
        dir[k] = sh.sdir;
        dds[k] = 0.0f;
        if (shading)
          sample_dir(P, rng.s0, rng.s1, rng.s2, sh.sdir, sh.radius_sq, dir[k], dds[k]);
      }
      // the chunk's samples that no row has occluded yet
      unsigned live = shading ? (1u << n) - 1u : 0u;
      // n is the same for every thread of the block: one instance a size
      static_assert(kChunk == 4, "a case for each chunk size below kChunk");
      switch (n) {
        case 1: live = unoccluded<1>(P, tile, occ_tbl, occ, sph, sh, dir, dds, live); break;
        case 2: live = unoccluded<2>(P, tile, occ_tbl, occ, sph, sh, dir, dds, live); break;
        case 3: live = unoccluded<3>(P, tile, occ_tbl, occ, sph, sh, dir, dds, live); break;
        default: live = unoccluded<kChunk>(P, tile, occ_tbl, occ, sph, sh, dir, dds, live);
      }
      if (shading) dark += n - __popc(live);
    }
    const float lit = (float)(S - dark);
    V3 color = make(0.0f, 0.0f, 0.0f);
    float lit_rec = 0.0f;
    if (shading) {
      lit_rec = lit;
      color = shade_color(P, lit, sh.lam_base, light_rgb, indirect, term_valid, term_rgb, weight,
                          ph.rgb);
    }
    if (ray) {
      if (lit_out) lit_out[a * n_pix + p] = lit_rec;
      float* c = col + ((size_t)lp * A + a) * 3;
      c[0] = color.x;
      c[1] = color.y;
      c[2] = color.z;
    }
  }

  // --- the AA sum of each pixel's rays, in ray order, by its first thread ---
  __syncthreads();
  if (in_img && slot == 0) {
    V3 acc = make(0.0f, 0.0f, 0.0f);
    for (int a = 0; a < A; ++a) acc = add(acc, load3(col + ((size_t)lp * A + a) * 3));
    write_pixel(img, packed, p, scale(P.inv_a, acc));
  }
}

// Pixels of one block: floor(kThreads / A) (one when A > kThreads).
inline int pixels_per_block(int A) { return kThreads / (A < kThreads ? A : kThreads); }

}  // namespace

// Launches one frame on `stream`; arguments as render_fwd_launch
// (render_fwd.cu). tri [n_tri,19] and shd [n_shd,13] are read from device
// memory tile by tile, so neither count is limited by shared memory.
// Returns cudaGetLastError() of the launch.
extern "C" int render_fwd_streamed_launch(const float* tri, const float* sph, const float* cam,
                                          const float* shd, float* img, uint32_t* packed,
                                          int* pid, float* lit, int* bid, const int* ip,
                                          const float* fp, void* stream) {
  const Params P = make_params(ip, fp);
  const long long n_pix = (long long)P.rows * P.width;
  if (n_pix == 0) return 0;
  const int A = P.aa_x * P.aa_y;
  const int ppb = pixels_per_block(A);
  const size_t smem = sizeof(float) * ((size_t)kThreads * (kTriCols + kPrimCols) +
                                       (size_t)P.n_sph * kSphCols + kCamCols + (size_t)ppb * A * 3);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        render_fwd_streamed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((n_pix + ppb - 1) / ppb);
  render_fwd_streamed_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      tri, sph, cam, shd, img, packed, pid, lit, bid, P);
  return (int)cudaGetLastError();
}
