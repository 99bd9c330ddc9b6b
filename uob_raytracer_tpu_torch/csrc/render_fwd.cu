// Fused forward render kernel for Hopper (sm_90a): one launch per frame.
//
// Replaces the TPU kernel kernels/render_fwd.py:_render_kernel of the JAX
// package (whole-table mode, image and packed outputs, and its
// with_residuals mode). It computes what that kernel computes, per AA ray:
// the ray, the primary nearest hit with the shared-origin invariants, the
// specular bounce loop, one soft-shadow pass at the unified shading point
// (division-free, quad-merged occlusion); then per pixel the AA mean and
// the ARGB pack.
//
// What bounds it on this card: FP32 issue. The scene tables sit in shared
// memory and each pixel writes 16 B (12 B of image, 4 B packed) plus its
// record, so device memory is not the limit. On the Cornell box most of
// the operations are the shadow pass: S jittered sample rays per shading
// ray against every occluder row (at full_1024 one sample took a quarter
// of the frame's time and the other nine the rest, PERF.md).
//
// Design:
// - The shadow pass in the TPU kernel's order (_lit_count): rows outer,
//   samples inner. What a row's test needs from the row and the shading
//   point alone (b, t_num, t_num^2, b x e2, e1 x b) is computed once per
//   row and shading ray, then each sample still unoccluded pays three dot
//   products and the accept test (fwd_common.cuh: occ_row_invariants,
//   occ_row_sample; the spheres likewise). The sample directions are drawn
//   from the pixel's stream in sample order into registers, kChunk at a
//   time, with a bit mask of the samples still unoccluded; a chunk's scan
//   ends when its mask is empty. Every decision uses occ_row's operations
//   in occ_row's order, so the lit count is the per-sample scan's.
// - One thread per AA ray, as the streamed kernel (render_fwd_streamed.cu).
//   A block takes pixels_per_block(A) consecutive pixels (a multiple of
//   32) and all their A rays: ray a of the block's pixel l is item
//   a * ppb + l, and thread t takes items t, t + 128, ... So a warp holds
//   one AA index of 32 adjacent pixels, and the A-major record
//   (pid[a][p], lit[a][p], bid[b][a][p]) is written coalesced; ppb * A is
//   a whole number of 128-thread rounds (32 pixels at 2x2 AA, 128 at one
//   ray, 128 pixels in 9 rounds at 3x3). Each ray seeds its RNG from its
//   pixel's id. Its colour goes to shared memory, and after a barrier one
//   thread per pixel adds the A colours as ((0 + c0) + c1) + ... in ray
//   order, scales by 1/A and writes the pixel, as one thread looping over
//   the rays did. The ragged edge is masked (pixels are counted linearly
//   over the band's rows), and the row-band offset row0 enters the pixel
//   id as the TPU kernel's off_ref does.
// - Occupancy by measurement: __launch_bounds__(kThreads, kMinBlocks)
//   holds ptxas to 72 registers, so that 7 blocks (28 warps) share an SM
//   where 126 registers left room for 4. The scans wait on shared-memory
//   and arithmetic latency more than they issue, and more warps hide it:
//   5, 6 and 7 blocks each ran faster than the one before, the spills (374
//   B) included, and 8 ran slower. A chunk of 10 or 12 samples (3 blocks),
//   a warp vote to skip a sample no lane needs, and rows restaged for
//   16-byte loads were measured and left out (PERF.md).
// - Each block stages the scene tables (tri [T,19], sph [S,12], cam [21],
//   the optional shadow table shd [n_shd,13]) into shared memory, plus the
//   per-triangle shared-origin invariants of the primary hit; every thread
//   of a warp reads the same address (a broadcast), which stands in for
//   the TPU kernel's SMEM scalar reads. The camera row is read where it is
//   used, not held in registers across a thread's rays.
// - The bounce loop is a per-ray for loop that exits when the ray stops
//   being specular. The TPU kernel instead runs the whole tile until no ray
//   in it is active; an inactive ray is never touched by its masked
//   updates, so the result is the same.
// - Scan order: triangles in index order, then spheres, with a strict <
//   on t, so ties go to the lowest index.
//
// Residual outputs (the TPU kernel's with_residuals mode): with non-null
// pid, lit and bid pointers the kernel also writes each ray's decision
// record for the path-replay backward (render_bwd.cu): the primary hit's
// object id, the unoccluded shadow-sample count, and the object hit at
// every bounce step. Ids are 0..T-1 triangle, T+s sphere s, -1 miss or a
// step the ray never ran; lit is 0 on a ray that shades nothing. Every
// element is written exactly once. With null pointers nothing is recorded
// and nothing else changes.
//
// The per-row tests, the bounce step, the shading set-up and the output
// pack live in fwd_common.cuh, shared with the streamed kernel
// (render_fwd_streamed.cu), which takes scenes whose tables do not fit
// shared memory and makes the same decisions bit for bit.
//
// Left for later PRs: FMA contraction (see below).
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
//    occluder; its S samples are the one unjittered ray.
// 4. The ARGB pack is 255<<24 | trunc(clamp(255c,0,255))<<16 | ... of the
//    kernel's own float image, so it equals pack_argb of that image.
// 5. The lit count is S less the occluded samples, an integer below 2^24,
//    so it equals S less one for each occluded sample in float32.
// 6. The Python wrapper checks dtype, device, contiguity and shapes, and
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

// Pixels of one block: 32 * 4 / gcd(A, 4), the fewest whole warps of
// pixels whose A rays fill whole rounds of kThreads threads.
__host__ __device__ inline int pixels_per_block(int A) {
  return A % 4 == 0 ? 32 : (A % 2 == 0 ? 64 : 128);
}

// Sample rays of the soft-shadow pass held in registers at a time.
constexpr int kChunk = 8;
// Blocks an SM holds (see "Occupancy by measurement" above).
constexpr int kMinBlocks = 7;

// How many of the S sample rays of one shading ray (start sh.sstart) meet
// an occluder before the light: the TPU kernel's order. The sample
// directions come from the pixel's stream in sample order, kChunk at a
// time into registers; per chunk the occluder rows are outer and the
// samples inner: a row's invariants once (occ_row_invariants), then the
// sample part for each sample still unoccluded; the scan ends when every
// sample of the chunk is occluded. Quad rows first, then triangle rows,
// then the spheres for the samples still live.
__device__ int occluded_samples(const Params& P, const float* tbl, const OccTable& o,
                                const float* sph, const Shade& sh, Rng& rng) {
  const int S = P.shadow_samples;
  int dark = 0;
  for (int s0 = 0; s0 < S; s0 += kChunk) {
    const int n = min(kChunk, S - s0);
    V3 dir[kChunk];
    float dds[kChunk];
    // the chunk's n samples; the loops end at n (the same for every lane)
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k >= n) break;
      sample_dir(P, rng.s0, rng.s1, rng.s2, sh.sdir, sh.radius_sq, dir[k], dds[k]);
    }
    unsigned live = (1u << n) - 1u;
    for (int r = 0; r < o.rows && live; ++r) {
      const float* R = tbl + r * o.cols;
      if (!casts_shadow(P, R, o.mcol)) continue;
      const OccRow w = occ_row_invariants(R, o.ecol, sh.sstart);
      const bool quad = r < P.n_quads;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (k >= n) break;
        if (((live >> k) & 1u) && occ_row_sample(w, quad, dir[k], dds[k], sh.radius_sq))
          live &= ~(1u << k);
      }
    }
    for (int i = 0; i < P.n_sph && live; ++i) {
      const float* Sp = sph + i * kSphCols;
      if (Sp[7] == -1.0f) continue;  // glass casts no shadow
      const OccSph w = occ_sph_invariants(Sp, sh.sstart);
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (k >= n) break;
        if (((live >> k) & 1u) && occ_sph_sample(w, dir[k], dds[k], sh.radius_sq))
          live &= ~(1u << k);
      }
    }
    dark += n - __popc(live);
  }
  return dark;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    render_fwd_kernel(const float* __restrict__ g_tri, const float* __restrict__ g_sph,
                      const float* __restrict__ g_cam, const float* __restrict__ g_shd,
                      float* __restrict__ img, uint32_t* __restrict__ packed,
                      int* __restrict__ pid, float* __restrict__ lit_out,
                      int* __restrict__ bid, Params P) {
  extern __shared__ float smem[];
  const int A = P.aa_x * P.aa_y;
  const int ppb = pixels_per_block(A);
  float* tri = smem;
  float* prim = tri + P.n_tri * kTriCols;
  float* sph = prim + P.n_tri * kPrimCols;
  float* cam = sph + P.n_sph * kSphCols;
  float* shd = cam + kCamCols;
  float* col = shd + P.n_shd * kShdCols;  // [A][3][ppb]: the rays' colours

  // --- stage the scene tables ---
  for (int i = threadIdx.x; i < P.n_tri * kTriCols; i += blockDim.x) tri[i] = g_tri[i];
  for (int i = threadIdx.x; i < P.n_sph * kSphCols; i += blockDim.x) sph[i] = g_sph[i];
  for (int i = threadIdx.x; i < kCamCols; i += blockDim.x) cam[i] = g_cam[i];
  for (int i = threadIdx.x; i < P.n_shd * kShdCols; i += blockDim.x) shd[i] = g_shd[i];
  __syncthreads();
  // the shared-origin invariants of the primary hit, one row per triangle
  for (int i = threadIdx.x; i < P.n_tri; i += blockDim.x)
    prim_invariants(load3(cam + 9), tri + i * kTriCols, prim + i * kPrimCols);
  __syncthreads();

  const size_t n_pix = (size_t)P.rows * P.width;
  // shadow-pass occlusion geometry: the quad-merged table if given
  const float* occ_tbl = P.n_shd ? shd : tri;
  const OccTable occ = occ_table(P);
  const int S = P.shadow_samples;

  for (int item = threadIdx.x; item < ppb * A; item += kThreads) {
    const int a = item / ppb, lp = item - a * ppb;
    const size_t p = (size_t)blockIdx.x * ppb + lp;
    if (p >= n_pix) continue;  // past the ragged edge: no ray
    const int py = (int)(p / P.width);
    const int px = (int)(p - (size_t)py * P.width);
    const uint32_t gid = (uint32_t)((P.row0 + py) * P.width + px);  // < 2^24
    const float bx0 = (float)px * (float)P.aa_x - P.half_w;
    const float by0 = (float)(P.row0 + py) * (float)P.aa_y - P.half_h;
    // the camera row is read where it is used, not held across the loop
    const V3 d = primary_dir(P, load3(cam), load3(cam + 3), load3(cam + 6), bx0, by0, a);
    const V3 cam_pos = load3(cam + 9);

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
      const Shade sh = shade_setup(P, load3(cam + 12), sel(prim_diffuse, ph.pos, term_pos),
                                   sel(prim_diffuse, ph.nrm, term_nrm));
      Rng rng = rng_seed(gid);
      const float lit = (float)(S - occluded_samples(P, occ_tbl, occ, sph, sh, rng));
      lit_rec = lit;
      color = shade_color(P, lit, sh.lam_base, load3(cam + 15), load3(cam + 18), term_valid,
                          term_rgb, weight, ph.rgb);
    }
    if (lit_out) lit_out[a * n_pix + p] = lit_rec;
    col[(a * 3 + 0) * ppb + lp] = color.x;
    col[(a * 3 + 1) * ppb + lp] = color.y;
    col[(a * 3 + 2) * ppb + lp] = color.z;
  }

  // --- the AA sum of each pixel's rays, in ray order, by one thread ---
  __syncthreads();
  const size_t p = (size_t)blockIdx.x * ppb + threadIdx.x;
  if ((int)threadIdx.x < ppb && p < n_pix) {
    V3 acc = make(0.0f, 0.0f, 0.0f);
    for (int a = 0; a < A; ++a)
      acc = add(acc, make(col[(a * 3 + 0) * ppb + threadIdx.x], col[(a * 3 + 1) * ppb + threadIdx.x],
                          col[(a * 3 + 2) * ppb + threadIdx.x]));
    write_pixel(img, packed, p, scale(P.inv_a, acc));
  }
}

// Shared memory of one block: the tables, the primary hit's invariants and
// the colours of the block's rays (kernels/render_fwd.py:shared_bytes).
size_t launch_smem(const Params& P) {
  const int A = P.aa_x * P.aa_y;
  return sizeof(float) * ((size_t)P.n_tri * (kTriCols + kPrimCols) + (size_t)P.n_sph * kSphCols +
                          kCamCols + (size_t)P.n_shd * kShdCols +
                          (size_t)pixels_per_block(A) * A * 3);
}

cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(render_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
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
  const size_t smem = launch_smem(P);
  const cudaError_t e = allow_smem(smem);
  if (e != cudaSuccess) return (int)e;
  const int ppb = pixels_per_block(P.aa_x * P.aa_y);
  const unsigned blocks = (unsigned)((n_pix + ppb - 1) / ppb);
  render_fwd_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      tri, sph, cam, shd, img, packed, pid, lit, bid, P);
  return (int)cudaGetLastError();
}

// How many blocks of render_fwd_kernel one SM holds at the launch these
// parameters describe (the runtime's occupancy count: registers, shared
// memory and threads), into *blocks. Returns the CUDA error.
extern "C" int render_fwd_blocks_per_sm(const int* ip, const float* fp, int* blocks) {
  const size_t smem = launch_smem(make_params(ip, fp));
  const cudaError_t e = allow_smem(smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, render_fwd_kernel, kThreads,
                                                            smem);
}
