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
// Left for later PRs: FMA contraction (see below), the streamed variant
// for scenes past the shared-memory budget, warp-level early exit and a
// sample-parallel occlusion scan, hoisting the per-row occlusion
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

#include <cstdint>
#include <cuda_runtime.h>

#include "vec3.cuh"

namespace {

constexpr float kBig = 3.0e38f;  // "no hit" t
constexpr int kTriCols = 19;     // v0 e1 e2 n rgb mat E=cross(e1,e2)
constexpr int kPrimCols = 7;     // t_num, B2 = b x e2, B1 = e1 x b
constexpr int kSphCols = 12;     // c r2 rgb mat pad
constexpr int kCamCols = 21;     // r0 r1 r2 camera light light_rgb indirect
constexpr int kShdCols = 13;     // v0 e1 e2 E mat
constexpr int kThreads = 128;

struct Params {
  int width, height, row0, rows;
  int aa_x, aa_y, shadow_samples, bounces;
  int n_tri, n_sph, n_quads, n_shd;
  int cpu_ref, fresnel, quirk_nan_tir;
  // float32 constants computed by the wrapper exactly as the JAX kernel
  // computes them: W*ax/2, H*ay/2, focal, spread, shadow-ray bias, bounce
  // bias, indices of refraction, 1/A, 4*pi
  float half_w, half_h, focal, light_spread, shadow_bias, bias;
  float ior_glass, ior_air, inv_a, pi4;
};

__device__ __forceinline__ uint32_t xorshift(uint32_t s) {
  s ^= s << 13;
  s ^= s >> 17;
  s ^= s << 5;
  return s;
}

// r * (float)u / 2^32 - r / 2 (kernels.cl:49-52); 4294967295.0f == 2^32.
__device__ __forceinline__ float crush(uint32_t u, float r) {
  return r * __uint2float_rn(u) / 4294967296.0f - r / 2.0f;
}

// Stable quadratic roots of a x^2 + b x + c (kernels.cl:140-143) with the
// q == 0 and a == 0 guards of the JAX kernel.
__device__ __forceinline__ void sphere_roots(float a_q, float b_q, float c_q, bool* no_sol,
                                             float* xmin, float* xmax) {
  const float disc = b_q * b_q - 4.0f * a_q * c_q;
  *no_sol = disc < 0.0f;
  const float sq = sqrtf(*no_sol ? 1.0f : disc);
  const float q = b_q > 0.0f ? -0.5f * (b_q + sq) : -0.5f * (b_q - sq);
  const bool qz = q == 0.0f;
  const float x0 = q / (a_q == 0.0f ? 1.0f : a_q);
  const float x1 = qz ? x0 : c_q / q;
  *xmin = nan_min(x0, x1);
  *xmax = nan_max(x0, x1);
}

struct HitInfo {
  float t;
  V3 pos, nrm, rgb;
  float mat;
  int id;  // 0..T-1 triangle, T+s sphere s, -1 miss
};

// General nearest hit for a ray (start, d): Cramer's rule per triangle,
// then the spheres (the JAX kernel's _nearest_hit).
__device__ HitInfo nearest_hit(const Params& P, const float* tri, const float* sph, V3 start,
                               V3 d) {
  float t_b = kBig, u_b = 0.0f, v_b = 0.0f;
  int best = -1;
  const V3 nd = make(-d.x, -d.y, -d.z);
  for (int i = 0; i < P.n_tri; ++i) {
    const float* T = tri + i * kTriCols;
    const V3 v0 = load3(T), e1 = load3(T + 3), e2 = load3(T + 6);
    const V3 b = sub(start, v0);
    const float detA = det3(nd, e1, e2);
    const bool degen = detA == 0.0f;
    const float recip = 1.0f / (degen ? 1.0f : detA);
    const float t = det3(b, e1, e2) * recip;
    const float u = det3(nd, b, e2) * recip;
    const float v = det3(nd, e1, b) * recip;
    if (t >= 0.0f && u >= 0.0f && v >= 0.0f && (u + v) <= 1.0f && !degen && t < t_b) {
      t_b = t;
      u_b = u;
      v_b = v;
      best = i;
    }
  }
  HitInfo h;
  h.pos = make(0.0f, 0.0f, 0.0f);
  h.nrm = h.pos;
  h.rgb = h.pos;
  h.mat = 1.0f;
  h.id = best;
  if (best >= 0) {
    const float* T = tri + best * kTriCols;
    h.pos = add(load3(T), add(scale(u_b, load3(T + 3)), scale(v_b, load3(T + 6))));
    h.nrm = load3(T + 9);
    h.rgb = load3(T + 12);
    h.mat = T[15];
  }
  for (int i = 0; i < P.n_sph; ++i) {
    const float* S = sph + i * kSphCols;
    const V3 c = load3(S);
    const V3 L = sub(start, c);
    bool no_sol;
    float xmin, xmax;
    sphere_roots(dot(d, d), 2.0f * dot(d, L), dot(L, L) - S[3], &no_sol, &xmin, &xmax);
    const float cand = xmin >= 0.0f ? xmin : xmax;
    if (!no_sol && cand >= 0.0f && cand < t_b) {
      t_b = cand;
      h.pos = add(start, scale(cand, d));
      const V3 pc = sub(h.pos, c);
      const float pclen = sqrtf(fmaxf(dot(pc, pc), 1e-30f));
      h.nrm = make(pc.x / pclen, pc.y / pclen, pc.z / pclen);
      h.rgb = load3(S + 4);
      h.mat = S[7];
      h.id = P.n_tri + i;
    }
  }
  h.t = t_b;
  return h;
}

// Does anything occlude the sample ray (start, dir) before the light?
// Division-free test (the JAX kernel's _lit_count): t >= 0 becomes
// t_num*dA >= 0, |t dir|^2 < r^2 becomes t_num^2 |dir|^2 < r^2 dA^2, and
// the u, v bounds multiply through by dA. Quad rows first (independent
// bounds), then triangle rows (simplex bound), then spheres.
__device__ bool occluded(const Params& P, const float* tbl, int cols, int ecol, int mcol,
                         int n_rows, const float* sph, V3 start, V3 dir, float dds,
                         float radius_sq) {
  for (int r = 0; r < n_rows; ++r) {
    const float* R = tbl + r * cols;
    // glass casts no shadow (kernels.cl:247,279); cpu_ref has no materials
    if (!P.cpu_ref && R[mcol] == -1.0f) continue;
    const V3 v0 = load3(R), e1 = load3(R + 3), e2 = load3(R + 6), E = load3(R + ecol);
    const V3 b = sub(start, v0);
    const float t_num = dot(b, E);
    const float t_num2 = t_num * t_num;
    const V3 B2 = cross(b, e2);
    const V3 B1 = cross(e1, b);
    const float dA = -dot(dir, E);
    const float u_n = -dot(dir, B2);
    const float v_n = -dot(dir, B1);
    const float dA2 = dA * dA;
    const bool base = (t_num * dA >= 0.0f) && (t_num2 * dds < radius_sq * dA2) &&
                      (u_n * dA >= 0.0f) && (v_n * dA >= 0.0f);
    // quad: parallelogram bounds (dA == 0 fails the strict t-window test);
    // triangle: simplex bound
    const bool inb = r < P.n_quads ? (u_n * dA <= dA2) && (v_n * dA <= dA2)
                                   : ((u_n + v_n) * dA <= dA2) && (dA != 0.0f);
    if (base && inb) return true;
  }
  for (int i = 0; i < P.n_sph; ++i) {
    const float* S = sph + i * kSphCols;
    if (S[7] == -1.0f) continue;
    const V3 L = sub(start, load3(S));
    bool no_sol;
    float xmin, xmax;
    sphere_roots(dds, 2.0f * dot(dir, L), dot(L, L) - S[3], &no_sol, &xmin, &xmax);
    if (!no_sol && ((xmin >= 0.0f && xmin * xmin * dds < radius_sq) ||
                    (xmax >= 0.0f && xmax * xmax * dds < radius_sq)))
      return true;
  }
  return false;
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
  // shared-origin invariants of the primary hit: every primary ray starts
  // at the camera, so b = cam - v0, t_num = b.E, b x e2 and e1 x b are
  // per-triangle constants
  const V3 cam_pos = load3(cam + 9);
  for (int i = threadIdx.x; i < P.n_tri; i += blockDim.x) {
    const float* T = tri + i * kTriCols;
    const V3 b = sub(cam_pos, load3(T));
    const V3 B2 = cross(b, load3(T + 6));
    const V3 B1 = cross(load3(T + 3), b);
    float* Q = prim + i * kPrimCols;
    Q[0] = dot(b, load3(T + 16));
    Q[1] = B2.x;
    Q[2] = B2.y;
    Q[3] = B2.z;
    Q[4] = B1.x;
    Q[5] = B1.y;
    Q[6] = B1.z;
  }
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
  const int occ_cols = P.n_shd ? kShdCols : kTriCols;
  const int occ_e = P.n_shd ? 9 : 16;
  const int occ_m = P.n_shd ? 12 : 15;
  const int occ_rows = P.n_shd ? P.n_shd : P.n_tri;
  const int S = P.shadow_samples;

  const float bx0 = (float)px * (float)P.aa_x - P.half_w;
  const float by0 = (float)(P.row0 + py) * (float)P.aa_y - P.half_h;
  const int A = P.aa_x * P.aa_y;
  V3 acc = make(0.0f, 0.0f, 0.0f);

  for (int a = 0; a < A; ++a) {
    // --- AA ray generation (kernels.cl:384-407) ---
    const V3 bv = make(bx0 + (float)(a % P.aa_x), by0 + (float)(a / P.aa_x), P.focal);
    V3 d = make(dot(r0, bv), dot(r1, bv), dot(r2, bv));
    if (!P.cpu_ref) {  // CPU-ref rays stay unnormalized (skeleton.cpp:259)
      const float dlen = sqrtf(dot(d, d));
      d = make(d.x / dlen, d.y / dlen, d.z / dlen);
    }

    // --- primary nearest hit, shared-origin form ---
    float t_b = kBig;
    int idf = -1;
    for (int i = 0; i < P.n_tri; ++i) {
      const float* T = tri + i * kTriCols;
      const float* Q = prim + i * kPrimCols;
      const float dA = -dot(d, load3(T + 16));
      const bool degen = dA == 0.0f;
      const float rA = 1.0f / (degen ? 1.0f : dA);
      const float t = Q[0] * rA;
      const float u = -dot(d, load3(Q + 1)) * rA;
      const float v = -dot(d, load3(Q + 4)) * rA;
      if (t >= 0.0f && u >= 0.0f && v >= 0.0f && (u + v) <= 1.0f && !degen && t < t_b) {
        t_b = t;
        idf = i;
      }
    }
    for (int i = 0; i < P.n_sph; ++i) {
      const float* Sp = sph + i * kSphCols;
      const V3 L = sub(cam_pos, load3(Sp));
      bool no_sol;
      float xmin, xmax;
      sphere_roots(dot(d, d), 2.0f * dot(d, L), dot(L, L) - Sp[3], &no_sol, &xmin, &xmax);
      const float cand = xmin >= 0.0f ? xmin : xmax;
      if (!no_sol && cand >= 0.0f && cand < t_b) {
        t_b = cand;
        idf = P.n_tri + i;
      }
    }
    const bool hit = t_b < kBig;
    if (pid) pid[a * n_pix + p] = idf;
    V3 pos = make(0.0f, 0.0f, 0.0f), nrm = pos, rgb = pos;
    float mat = 1.0f;
    if (hit) pos = add(cam_pos, scale(t_b, d));
    if (idf >= 0 && idf < P.n_tri) {
      const float* T = tri + idf * kTriCols;
      nrm = load3(T + 9);
      rgb = load3(T + 12);
      mat = T[15];
    } else if (idf >= P.n_tri) {
      const float* Sp = sph + (idf - P.n_tri) * kSphCols;
      const V3 pc = sub(pos, load3(Sp));
      const float pclen = sqrtf(fmaxf(dot(pc, pc), 1e-30f));
      nrm = scale(1.0f / pclen, pc);
      rgb = load3(Sp + 4);
      mat = Sp[7];
    }
    // CPU-ref shades ANY hit triangle (no material logic, skeleton.cpp:268)
    const bool prim_diffuse = P.cpu_ref ? hit : (hit && mat > 0.0f);

    // --- specular bounce loop: per ray, until it stops being specular ---
    bool term_valid = false;
    V3 term_pos = make(0.0f, 0.0f, 0.0f), term_nrm = term_pos, term_rgb = term_pos;
    float weight = 1.0f;
    {
      bool active = hit && mat <= 0.0f;
      V3 dcur = d, cpos = pos, cnrm = nrm;
      float cmat = mat, medium = P.ior_air;
      int bi = 0;
      for (; bi < P.bounces && active; ++bi) {
        // reflect (kernels.cl:54-65)
        const float dn = dot(dcur, cnrm);
        const V3 refl = sub(dcur, scale(2.0f * dn, cnrm));
        // refract (kernels.cl:67-88)
        const float c1 = dot(cnrm, dcur);
        const V3 nflip = sel(c1 < 0.0f, scale(-1.0f, cnrm), cnrm);
        const float c1a = fabsf(c1);
        const bool in_air = medium == P.ior_air;
        const float n1 = in_air ? P.ior_air : P.ior_glass;
        const float n2 = in_air ? P.ior_glass : P.ior_air;
        const float nr = n1 / n2;
        const float k = 1.0f - nr * nr * (1.0f - c1a * c1a);
        const bool tir = k < 0.0f;
        const float c2 = sqrtf(tir ? 1.0f : k);
        const V3 refr = add(scale(nr, dcur), scale(nr * c1a - c2, scale(-1.0f, nflip)));
        const bool is_mirror = cmat == 0.0f;
        const bool dead = P.quirk_nan_tir ? (tir && !is_mirror) : false;
        const bool use_refl = P.quirk_nan_tir ? is_mirror : (is_mirror || tir);
        if (dead) break;  // the reference's NaN direction renders black
        V3 ndir = sel(use_refl, refl, refr);
        const float nmed = use_refl ? P.ior_air : n2;
        const V3 nstart = add(cpos, scale(P.bias, ndir));
        const float nlen = sqrtf(fmaxf(dot(ndir, ndir), 1e-30f));
        ndir = make(ndir.x / nlen, ndir.y / nlen, ndir.z / nlen);
        if (P.fresnel) {
          float r0f = (n1 - n2) / (n1 + n2);
          r0f = r0f * r0f;
          const float x = 1.0f - c1a;
          const float x2 = x * x;
          const float refl_w = r0f + (1.0f - r0f) * (x * (x2 * x2));
          weight = weight * (use_refl ? 1.0f : 1.0f - refl_w);
        }
        const HitInfo h = nearest_hit(P, tri, sph, nstart, ndir);
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
          dcur = ndir;
          cpos = h.pos;
          cnrm = h.nrm;
          cmat = h.mat;
          medium = nmed;
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
      const V3 sp_pos = sel(prim_diffuse, pos, term_pos);
      const V3 sp_nrm = sel(prim_diffuse, nrm, term_nrm);
      const V3 sdir = sub(light, sp_pos);
      const V3 sstart = add(sp_pos, scale(P.shadow_bias, sdir));
      const float radius_sq = dot(sdir, sdir);
      const float rs_safe = radius_sq == 0.0f ? 1.0f : radius_sq;
      float lam_base = nan_max(dot(sdir, sp_nrm), 0.0f) / (P.pi4 * rs_safe);
      lam_base = radius_sq == 0.0f ? 0.0f : lam_base;

      const float gf = __uint2float_rn(gid);
      uint32_t s0 = xorshift(gid);
      uint32_t s1 = xorshift((uint32_t)(gf * 91.0f));
      uint32_t s2 = xorshift((uint32_t)(gf * 19.0f));
      float lit = (float)S;
      for (int s = 0; s < S; ++s) {
        V3 dir = sdir;
        float dds = radius_sq;
        if (!P.cpu_ref) {
          // jittered direction: sample s uses the (s+1)-th xorshift of the
          // pixel seed (kernels.cl:331). CPU-ref casts ONE unjittered hard
          // shadow ray (skeleton.cpp:220-241).
          s0 = xorshift(s0);
          s1 = xorshift(s1);
          s2 = xorshift(s2);
          dir = add(sdir, make(crush(s0, P.light_spread), crush(s1, P.light_spread),
                               crush(s2, P.light_spread)));
          dds = dot(dir, dir);
        }
        if (occluded(P, occ_tbl, occ_cols, occ_e, occ_m, occ_rows, sph, sstart, dir, dds,
                     radius_sq))
          lit = lit - 1.0f;
      }
      lit_rec = lit;
      const float dl_scale = lit * lam_base / (float)S;
      const V3 dl = make(light_rgb.x * dl_scale, light_rgb.y * dl_scale, light_rgb.z * dl_scale);
      // combine (kernels.cl:415-425)
      if (term_valid) {
        color = make(0.9f * (indirect.x + dl.x) * term_rgb.x * weight,
                     0.9f * (indirect.y + dl.y) * term_rgb.y * weight,
                     0.9f * (indirect.z + dl.z) * term_rgb.z * weight);
      } else {
        color = make(rgb.x * (indirect.x + dl.x), rgb.y * (indirect.y + dl.y),
                     rgb.z * (indirect.z + dl.z));
      }
    }
    if (lit_out) lit_out[a * n_pix + p] = lit_rec;
    acc = add(acc, color);
  }

  // --- AA mean + outputs ---
  const V3 fin = scale(P.inv_a, acc);
  float* o = img + (size_t)p * 3;
  o[0] = fin.x;
  o[1] = fin.y;
  o[2] = fin.z;
  const uint32_t cr = (uint32_t)(int)fminf(fmaxf(255.0f * fin.x, 0.0f), 255.0f);
  const uint32_t cg = (uint32_t)(int)fminf(fmaxf(255.0f * fin.y, 0.0f), 255.0f);
  const uint32_t cb = (uint32_t)(int)fminf(fmaxf(255.0f * fin.z, 0.0f), 255.0f);
  packed[p] = (255u << 24) + (cr << 16) + (cg << 8) + cb;
}

}  // namespace

// Launches one frame on `stream`. ip and fp are HOST arrays:
// ip = {width, height, row0, rows, aa_x, aa_y, shadow_samples, bounces,
//       n_tri, n_sph, n_quads, n_shd, cpu_ref, fresnel, quirk_nan_tir}
// fp = {half_w, half_h, focal, light_spread, shadow_bias, bias,
//       ior_glass, ior_air, inv_a, pi4}
// shd may be null when n_shd == 0. pid [A, rows, W], lit [A, rows, W] and
// bid [bounces, A, rows, W] are the residual outputs: all null (nothing
// recorded) or all given (bid may be null when bounces == 0). Returns
// cudaGetLastError() of the launch.
extern "C" int render_fwd_launch(const float* tri, const float* sph, const float* cam,
                                 const float* shd, float* img, uint32_t* packed, int* pid,
                                 float* lit, int* bid, const int* ip, const float* fp,
                                 void* stream) {
  Params P;
  P.width = ip[0];
  P.height = ip[1];
  P.row0 = ip[2];
  P.rows = ip[3];
  P.aa_x = ip[4];
  P.aa_y = ip[5];
  P.shadow_samples = ip[6];
  P.bounces = ip[7];
  P.n_tri = ip[8];
  P.n_sph = ip[9];
  P.n_quads = ip[10];
  P.n_shd = ip[11];
  P.cpu_ref = ip[12];
  P.fresnel = ip[13];
  P.quirk_nan_tir = ip[14];
  P.half_w = fp[0];
  P.half_h = fp[1];
  P.focal = fp[2];
  P.light_spread = fp[3];
  P.shadow_bias = fp[4];
  P.bias = fp[5];
  P.ior_glass = fp[6];
  P.ior_air = fp[7];
  P.inv_a = fp[8];
  P.pi4 = fp[9];
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
