// Fused forward render kernel for Hopper (sm_90a): one launch per frame.
//
// Replaces the TPU kernel kernels/render_fwd.py:_render_kernel of the JAX
// package (whole-table mode, image and packed outputs). It computes what
// that kernel computes, per pixel: AA ray generation, the primary nearest
// hit with the shared-origin invariants, the specular bounce loop, one
// soft-shadow pass at the unified shading point (division-free,
// quad-merged occlusion), the AA mean and the ARGB pack.
//
// Design (simple first):
// - One thread per pixel. The thread loops over the A = aa_x * aa_y rays of
//   its pixel and writes their mean; no cross-thread reduction. The
//   row-band offset row0 enters the pixel id as the TPU kernel's off_ref
//   does. The ragged edge is masked, not padded: the kernel writes
//   img [rows, W, 3] and packed [rows, W] directly.
// - Each block stages the scene tables (tri [T,19], sph [S,12], cam [21],
//   the optional shadow table shd [n_shd,13]) into shared memory, plus the
//   per-triangle shared-origin invariants of the primary hit. Every thread
//   of a warp then reads the same address (a broadcast), which stands in
//   for the TPU kernel's SMEM scalar reads and for the reference's
//   local-memory copy (kernels.cl:374-376).
// - The bounce loop is a per-ray for loop that exits when the ray stops
//   being specular. The TPU kernel instead runs the whole tile until no ray
//   in it is active; an inactive ray is never touched by its masked
//   updates, so the result is the same.
// - Scan order: triangles in index order, then spheres, with a strict <
//   on t, so ties go to the lowest index. The shadow pass skips the
//   occlusion scan of a ray that shades nothing (its color is 0 either
//   way), tests samples one after another, and stops a sample's scan at
//   its first occluder: the lit count is the same.
//
// What bounds it on this card: FP32 issue. The scene tables are read from
// shared memory and each pixel writes 16 B (12 B of image, 4 B packed), so
// device memory is not the limit.
//
// Residual outputs (the TPU kernel's with_residuals mode): with non-null
// pid, lit and bid pointers the kernel also writes each ray's decision
// record for the path-replay backward (render_bwd.cu): the primary hit's
// object id, the unoccluded shadow-sample count, and the object hit at
// every bounce step. Ids are 0..T-1 triangle, T+s sphere s, -1 miss or a
// step the ray never ran; lit is 0 on a ray that shades nothing. The
// layout is A-major (pid[a][p], bid[b][a][p]), so consecutive threads
// write consecutive addresses, and every element is written exactly once.
// With null pointers nothing is recorded and nothing else changes.
//
// The per-row tests, the bounce step, the shading set-up and the output
// pack live in fwd_common.cuh, shared with the streamed kernel
// (render_fwd_streamed.cu), which takes scenes whose tables do not fit
// shared memory and makes the same decisions bit for bit.
//
// Left for later PRs: FMA contraction (see below), warp-level early exit
// and a sample-parallel occlusion scan, hoisting the per-row occlusion
// invariants out of the sample loop, and occupancy tuning.
//
// Numerical hazards, handled here:
// 1. FMA contraction. nvcc contracts a*b+c by default; torch's eager ops
//    and the JAX CPU suite do not. This file is built with --fmad=false so
//    the kernel can be held tightly to its plain version. A later
//    performance PR may lift that flag, and must then re-measure parity.
//    --use_fast_math is never used: division and sqrt stay IEEE. Ray
//    normalisation divides by the length; it does not multiply by a
//    reciprocal.
// 2. RNG bit parity. xorshift is ^<<13, ^>>17, ^<<5 on uint32_t. The seed
//    is (gid, (uint)(gf*91.0f), (uint)(gf*19.0f)) with gf = (float)gid,
//    followed by one xorshift; the products round to float32 and then
//    truncate. crush converts u32 -> f32 with round to nearest
//    (__uint2float_rn), states >= 2^31 included.
// 3. The spheres' stable quadratic keeps the q == 0 and a == 0 guards.
//    cpu_ref mode scans no spheres and counts every triangle as an
//    occluder.
// 4. The ARGB pack is 255<<24 | trunc(clamp(255c,0,255))<<16 | ... of the
//    kernel's own float image, so it equals pack_argb of that image.
// 5. The Python wrapper checks dtype, device, contiguity and shapes, and
//    raises when this launcher returns a CUDA error.

#include "fwd_common.cuh"

namespace {

// General nearest hit for a ray (start, d) over the staged tables.
__device__ HitInfo nearest_hit(const Params& P, const float* tri, const float* sph, V3 start,
                               V3 d) {
  Best best = no_best();
  const V3 nd = make(-d.x, -d.y, -d.z);
  for (int i = 0; i < P.n_tri; ++i) tri_test(start, nd, tri + i * kTriCols, i, best);
  return nearest_finish(P, tri, sph, start, d, best);
}

// Does anything occlude the sample ray (start, dir) before the light? Quad
// rows first, then triangle rows, then spheres.
__device__ bool occluded(const Params& P, const float* tbl, const OccTable& o, const float* sph,
                         V3 start, V3 dir, float dds, float radius_sq) {
  for (int r = 0; r < o.rows; ++r) {
    const float* R = tbl + r * o.cols;
    if (!casts_shadow(P, R, o.mcol)) continue;
    if (occ_row(R, o.ecol, r < P.n_quads, start, dir, dds, radius_sq)) return true;
  }
  return occ_spheres(P, sph, start, dir, dds, radius_sq);
}

__global__ void __launch_bounds__(kThreads)
    render_fwd_kernel(const float* __restrict__ g_tri, const float* __restrict__ g_sph,
                      const float* __restrict__ g_cam, const float* __restrict__ g_shd,
                      float* __restrict__ img, uint32_t* __restrict__ packed,
                      int* __restrict__ pid, float* __restrict__ lit_out,
                      int* __restrict__ bid, Params P) {
  extern __shared__ float smem[];
  float* tri = smem;
  float* prim = tri + P.n_tri * kTriCols;
  float* sph = prim + P.n_tri * kPrimCols;
  float* cam = sph + P.n_sph * kSphCols;
  float* shd = cam + kCamCols;

  // --- stage the scene tables ---
  for (int i = threadIdx.x; i < P.n_tri * kTriCols; i += blockDim.x) tri[i] = g_tri[i];
  for (int i = threadIdx.x; i < P.n_sph * kSphCols; i += blockDim.x) sph[i] = g_sph[i];
  for (int i = threadIdx.x; i < kCamCols; i += blockDim.x) cam[i] = g_cam[i];
  for (int i = threadIdx.x; i < P.n_shd * kShdCols; i += blockDim.x) shd[i] = g_shd[i];
  __syncthreads();
  // the shared-origin invariants of the primary hit, one row per triangle
  const V3 cam_pos = load3(cam + 9);
  for (int i = threadIdx.x; i < P.n_tri; i += blockDim.x)
    prim_invariants(cam_pos, tri + i * kTriCols, prim + i * kPrimCols);
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n_pix = (size_t)P.rows * P.width;
  if (p >= P.rows * P.width) return;
  const int py = p / P.width;
  const int px = p - py * P.width;
  const uint32_t gid = (uint32_t)((P.row0 + py) * P.width + px);  // < 2^24

  const V3 r0 = load3(cam), r1 = load3(cam + 3), r2 = load3(cam + 6);
  const V3 light = load3(cam + 12), light_rgb = load3(cam + 15), indirect = load3(cam + 18);
  // shadow-pass occlusion geometry: the quad-merged table if given
  const float* occ_tbl = P.n_shd ? shd : tri;
  const OccTable occ = occ_table(P);
  const int S = P.shadow_samples;

  const float bx0 = (float)px * (float)P.aa_x - P.half_w;
  const float by0 = (float)(P.row0 + py) * (float)P.aa_y - P.half_h;
  const int A = P.aa_x * P.aa_y;
  V3 acc = make(0.0f, 0.0f, 0.0f);

  for (int a = 0; a < A; ++a) {
    const V3 d = primary_dir(P, r0, r1, r2, bx0, by0, a);

    // --- primary nearest hit, shared-origin form ---
    float t_b = kBig;
    int idf = -1;
    for (int i = 0; i < P.n_tri; ++i)
      prim_test(d, tri + i * kTriCols, prim + i * kPrimCols, i, t_b, idf);
    prim_spheres(P, sph, cam_pos, d, t_b, idf);
    const HitInfo ph = prim_finish(P, tri, sph, cam_pos, d, t_b, idf);
    const bool hit = t_b < kBig;
    if (pid) pid[a * n_pix + p] = idf;
    // CPU-ref shades ANY hit triangle (no material logic, skeleton.cpp:268)
    const bool prim_diffuse = P.cpu_ref ? hit : (hit && ph.mat > 0.0f);

    // --- specular bounce loop: per ray, until it stops being specular ---
    bool term_valid = false;
    V3 term_pos = make(0.0f, 0.0f, 0.0f), term_nrm = term_pos, term_rgb = term_pos;
    float weight = 1.0f;
    {
      bool active = hit && ph.mat <= 0.0f;
      V3 dcur = d, cpos = ph.pos, cnrm = ph.nrm;
      float cmat = ph.mat, medium = P.ior_air;
      int bi = 0;
      for (; bi < P.bounces && active; ++bi) {
        const Bounce b = bounce_step(P, dcur, cpos, cnrm, cmat, medium, weight);
        if (b.dead) break;  // the reference's NaN direction renders black
        const HitInfo h = nearest_hit(P, tri, sph, b.nstart, b.ndir);
        if (bid) bid[((size_t)bi * A + a) * n_pix + p] = h.id;
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
      // steps the ray never ran (and the step it died in) read "inactive"
      if (bid)
        for (; bi < P.bounces; ++bi) bid[((size_t)bi * A + a) * n_pix + p] = -1;
    }

    // --- one soft-shadow pass at the unified shading point ---
    V3 color = make(0.0f, 0.0f, 0.0f);
    float lit_rec = 0.0f;
    if (prim_diffuse || term_valid) {
      const Shade sh = shade_setup(P, light, sel(prim_diffuse, ph.pos, term_pos),
                                   sel(prim_diffuse, ph.nrm, term_nrm));
      Rng rng = rng_seed(gid);
      float lit = (float)S;
      for (int s = 0; s < S; ++s) {
        float dds;
        V3 dir;
        sample_dir(P, rng.s0, rng.s1, rng.s2, sh.sdir, sh.radius_sq, dir, dds);
        if (occluded(P, occ_tbl, occ, sph, sh.sstart, dir, dds, sh.radius_sq)) lit = lit - 1.0f;
      }
      lit_rec = lit;
      color = shade_color(P, lit, sh.lam_base, light_rgb, indirect, term_valid, term_rgb, weight,
                          ph.rgb);
    }
    if (lit_out) lit_out[a * n_pix + p] = lit_rec;
    acc = add(acc, color);
  }

  write_pixel(img, packed, (size_t)p, scale(P.inv_a, acc));
}

}  // namespace

// Launches one frame on `stream`. ip and fp are HOST arrays (their fields
// are listed at make_params in fwd_common.cuh). shd may be null when
// n_shd == 0. pid [A, rows, W], lit [A, rows, W] and bid [bounces, A, rows,
// W] are the residual outputs: all null (nothing recorded) or all given
// (bid may be null when bounces == 0). Returns cudaGetLastError() of the
// launch.
extern "C" int render_fwd_launch(const float* tri, const float* sph, const float* cam,
                                 const float* shd, float* img, uint32_t* packed, int* pid,
                                 float* lit, int* bid, const int* ip, const float* fp,
                                 void* stream) {
  const Params P = make_params(ip, fp);
  const long long n_pix = (long long)P.rows * P.width;
  if (n_pix == 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)P.n_tri * (kTriCols + kPrimCols) +
                                       (size_t)P.n_sph * kSphCols + kCamCols +
                                       (size_t)P.n_shd * kShdCols);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        render_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((n_pix + kThreads - 1) / kThreads);
  render_fwd_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      tri, sph, cam, shd, img, packed, pid, lit, bid, P);
  return (int)cudaGetLastError();
}
