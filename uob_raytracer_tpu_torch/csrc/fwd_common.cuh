// Device code shared by the two forward render kernels: the whole-table
// kernel (render_fwd.cu) and the streamed kernel (render_fwd_streamed.cu).
// Both make every decision with these functions, operation by operation
// and without FMA (--fmad=false), so a scene that both can run gives the
// same bits: the per-row hit and occlusion tests, the bounce step, the
// shading set-up, the RNG and the output pack. What differs between the
// kernels is only where a table row comes from (shared memory staged
// whole, or a tile of the table in device memory) and how the loops around
// the tests are arranged. The per-shard partial scans (partial.cu) take
// the general per-row tests and the tile load from here too.
//
// The helpers' shapes are measured, not only chosen: on the H100 the
// whole-table kernel ran 3.6% slower with the "casts no shadow" test as an
// early return inside occ_row (it is the caller's `continue` now) and 2.8%
// slower with sample_dir returning its direction beside a pointer
// out-parameter (it fills two references now). See PERF.md.
#pragma once

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

// ip = {width, height, row0, rows, aa_x, aa_y, shadow_samples, bounces,
//       n_tri, n_sph, n_quads, n_shd, cpu_ref, fresnel, quirk_nan_tir}
// fp = {half_w, half_h, focal, light_spread, shadow_bias, bias,
//       ior_glass, ior_air, inv_a, pi4}
inline Params make_params(const int* ip, const float* fp) {
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
  return P;
}

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

// --- AA ray generation (kernels.cl:384-407) ---
__device__ __forceinline__ V3 primary_dir(const Params& P, V3 r0, V3 r1, V3 r2, float bx0,
                                          float by0, int a) {
  const V3 bv = make(bx0 + (float)(a % P.aa_x), by0 + (float)(a / P.aa_x), P.focal);
  V3 d = make(dot(r0, bv), dot(r1, bv), dot(r2, bv));
  if (!P.cpu_ref) {  // CPU-ref rays stay unnormalized (skeleton.cpp:259)
    const float dlen = sqrtf(dot(d, d));
    d = make(d.x / dlen, d.y / dlen, d.z / dlen);
  }
  return d;
}

// --- the primary hit, shared-origin form: every primary ray starts at the
// camera, so b = cam - v0, t_num = b.E, b x e2 and e1 x b are per-triangle
// constants (7 floats at Q) ---
__device__ __forceinline__ void prim_invariants(V3 cam_pos, const float* T, float* Q) {
  const V3 b = sub(cam_pos, load3(T));
  const V3 B2 = cross(b, load3(T + 6));
  const V3 B1 = cross(load3(T + 3), b);
  Q[0] = dot(b, load3(T + 16));
  Q[1] = B2.x;
  Q[2] = B2.y;
  Q[3] = B2.z;
  Q[4] = B1.x;
  Q[5] = B1.y;
  Q[6] = B1.z;
}

// One triangle row against a primary ray: updates the running best
// (strict <, so ties keep the lowest index when rows come in index order).
__device__ __forceinline__ void prim_test(V3 d, const float* T, const float* Q, int i, float& t_b,
                                          int& idf) {
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

__device__ __forceinline__ void prim_spheres(const Params& P, const float* sph, V3 cam_pos, V3 d,
                                             float& t_b, int& idf) {
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
}

struct HitInfo {
  float t;
  V3 pos, nrm, rgb;
  float mat;
  int id;  // 0..T-1 triangle, T+s sphere s, -1 miss
};

// The primary winner's attributes. `tri` is the whole triangle table
// (shared or device memory); only row idf is read.
__device__ __forceinline__ HitInfo prim_finish(const Params& P, const float* tri, const float* sph,
                                               V3 cam_pos, V3 d, float t_b, int idf) {
  HitInfo h;
  h.t = t_b;
  h.id = idf;
  h.pos = make(0.0f, 0.0f, 0.0f);
  h.nrm = h.pos;
  h.rgb = h.pos;
  h.mat = 1.0f;
  if (t_b < kBig) h.pos = add(cam_pos, scale(t_b, d));
  if (idf >= 0 && idf < P.n_tri) {
    const float* T = tri + (size_t)idf * kTriCols;
    h.nrm = load3(T + 9);
    h.rgb = load3(T + 12);
    h.mat = T[15];
  } else if (idf >= P.n_tri) {
    const float* Sp = sph + (idf - P.n_tri) * kSphCols;
    const V3 pc = sub(h.pos, load3(Sp));
    const float pclen = sqrtf(fmaxf(dot(pc, pc), 1e-30f));
    h.nrm = scale(1.0f / pclen, pc);
    h.rgb = load3(Sp + 4);
    h.mat = Sp[7];
  }
  return h;
}

// --- the general nearest hit (the JAX kernel's _nearest_hit): Cramer's
// rule per triangle, then the spheres ---
struct Best {
  float t, u, v;
  int id;
};

__device__ __forceinline__ Best no_best() {
  Best b;
  b.t = kBig;
  b.u = 0.0f;
  b.v = 0.0f;
  b.id = -1;
  return b;
}

__device__ __forceinline__ void tri_test(V3 start, V3 nd, const float* T, int i, Best& best) {
  const V3 v0 = load3(T), e1 = load3(T + 3), e2 = load3(T + 6);
  const V3 b = sub(start, v0);
  const float detA = det3(nd, e1, e2);
  const bool degen = detA == 0.0f;
  const float recip = 1.0f / (degen ? 1.0f : detA);
  const float t = det3(b, e1, e2) * recip;
  const float u = det3(nd, b, e2) * recip;
  const float v = det3(nd, e1, b) * recip;
  if (t >= 0.0f && u >= 0.0f && v >= 0.0f && (u + v) <= 1.0f && !degen && t < best.t) {
    best.t = t;
    best.u = u;
    best.v = v;
    best.id = i;
  }
}

// The best triangle's attributes, then the spheres. `tri` as in prim_finish.
__device__ __forceinline__ HitInfo nearest_finish(const Params& P, const float* tri,
                                                  const float* sph, V3 start, V3 d,
                                                  const Best& best) {
  float t_b = best.t;
  HitInfo h;
  h.pos = make(0.0f, 0.0f, 0.0f);
  h.nrm = h.pos;
  h.rgb = h.pos;
  h.mat = 1.0f;
  h.id = best.id;
  if (best.id >= 0) {
    const float* T = tri + (size_t)best.id * kTriCols;
    h.pos = add(load3(T), add(scale(best.u, load3(T + 3)), scale(best.v, load3(T + 6))));
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

// --- occlusion: does row R occlude the sample ray (start, dir) before the
// light? Division-free test (the JAX kernel's _lit_count): t >= 0 becomes
// t_num*dA >= 0, |t dir|^2 < r^2 becomes t_num^2 |dir|^2 < r^2 dA^2, and
// the u, v bounds multiply through by dA. E at R + ecol; a quad row has
// independent bounds, a triangle row the simplex bound. The caller skips
// rows that cast no shadow (casts_shadow). ---
// glass casts no shadow (kernels.cl:247,279); cpu_ref has no materials
__device__ __forceinline__ bool casts_shadow(const Params& P, const float* R, int mcol) {
  return P.cpu_ref || R[mcol] != -1.0f;
}

__device__ __forceinline__ bool occ_row(const float* R, int ecol, bool is_quad, V3 start,
                                        V3 dir, float dds, float radius_sq) {
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
  const bool inb = is_quad ? (u_n * dA <= dA2) && (v_n * dA <= dA2)
                           : ((u_n + v_n) * dA <= dA2) && (dA != 0.0f);
  return base && inb;
}

// occ_row split in two for a scan that tests many sample rays of one
// shading point against a row: the part that depends only on the row and
// the start (b, t_num, t_num^2, b x e2, e1 x b) once per row, then the
// sample part per sample ray. Both are occ_row's operations in occ_row's
// order, so each sample gets occ_row's answer bit for bit.
struct OccRow {
  V3 E, B2, B1;
  float t_num, t_num2;
};

__device__ __forceinline__ OccRow occ_row_invariants(const float* R, int ecol, V3 start) {
  const V3 v0 = load3(R), e1 = load3(R + 3), e2 = load3(R + 6);
  OccRow w;
  w.E = load3(R + ecol);
  const V3 b = sub(start, v0);
  w.t_num = dot(b, w.E);
  w.t_num2 = w.t_num * w.t_num;
  w.B2 = cross(b, e2);
  w.B1 = cross(e1, b);
  return w;
}

__device__ __forceinline__ bool occ_row_sample(const OccRow& w, bool is_quad, V3 dir, float dds,
                                               float radius_sq) {
  const float dA = -dot(dir, w.E);
  const float u_n = -dot(dir, w.B2);
  const float v_n = -dot(dir, w.B1);
  const float dA2 = dA * dA;
  const bool base = (w.t_num * dA >= 0.0f) && (w.t_num2 * dds < radius_sq * dA2) &&
                    (u_n * dA >= 0.0f) && (v_n * dA >= 0.0f);
  const bool inb = is_quad ? (u_n * dA <= dA2) && (v_n * dA <= dA2)
                           : ((u_n + v_n) * dA <= dA2) && (dA != 0.0f);
  return base && inb;
}

__device__ __forceinline__ bool occ_spheres(const Params& P, const float* sph, V3 start, V3 dir,
                                            float dds, float radius_sq) {
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

// occ_spheres' test of one sphere split the same way: L = start - c and
// c_q = L.L - r^2 once per sphere, the roots per sample ray.
struct OccSph {
  V3 L;
  float c_q;
};

__device__ __forceinline__ OccSph occ_sph_invariants(const float* S, V3 start) {
  OccSph w;
  w.L = sub(start, load3(S));
  w.c_q = dot(w.L, w.L) - S[3];
  return w;
}

__device__ __forceinline__ bool occ_sph_sample(const OccSph& w, V3 dir, float dds,
                                               float radius_sq) {
  bool no_sol;
  float xmin, xmax;
  sphere_roots(dds, 2.0f * dot(dir, w.L), w.c_q, &no_sol, &xmin, &xmax);
  return !no_sol && ((xmin >= 0.0f && xmin * xmin * dds < radius_sq) ||
                     (xmax >= 0.0f && xmax * xmax * dds < radius_sq));
}

// Where the shadow pass finds its occluder rows: the quad-merged table if
// one was given, else the triangle table.
struct OccTable {
  int cols, ecol, mcol, rows;
};

__device__ __forceinline__ OccTable occ_table(const Params& P) {
  OccTable o;
  o.cols = P.n_shd ? kShdCols : kTriCols;
  o.ecol = P.n_shd ? 9 : 16;
  o.mcol = P.n_shd ? 12 : 15;
  o.rows = P.n_shd ? P.n_shd : P.n_tri;
  return o;
}

// --- one specular bounce step from the current hit: the new ray, the
// medium it travels in, and whether the reference's NaN direction kills
// the ray (it renders black). Multiplies the Fresnel weight in. ---
struct Bounce {
  V3 nstart, ndir;
  float nmed;
  bool dead;
};

__device__ __forceinline__ Bounce bounce_step(const Params& P, V3 dcur, V3 cpos, V3 cnrm,
                                              float cmat, float medium, float& weight) {
  Bounce o;
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
  o.dead = P.quirk_nan_tir ? (tir && !is_mirror) : false;
  const bool use_refl = P.quirk_nan_tir ? is_mirror : (is_mirror || tir);
  o.ndir = sel(use_refl, refl, refr);
  o.nmed = use_refl ? P.ior_air : n2;
  o.nstart = add(cpos, scale(P.bias, o.ndir));
  if (o.dead) return o;
  const float nlen = sqrtf(fmaxf(dot(o.ndir, o.ndir), 1e-30f));
  o.ndir = make(o.ndir.x / nlen, o.ndir.y / nlen, o.ndir.z / nlen);
  if (P.fresnel) {
    float r0f = (n1 - n2) / (n1 + n2);
    r0f = r0f * r0f;
    const float x = 1.0f - c1a;
    const float x2 = x * x;
    const float refl_w = r0f + (1.0f - r0f) * (x * (x2 * x2));
    weight = weight * (use_refl ? 1.0f : 1.0f - refl_w);
  }
  return o;
}

// --- the soft-shadow pass at the unified shading point ---
struct Shade {
  V3 sdir, sstart;
  float radius_sq, lam_base;
};

__device__ __forceinline__ Shade shade_setup(const Params& P, V3 light, V3 sp_pos, V3 sp_nrm) {
  Shade s;
  s.sdir = sub(light, sp_pos);
  s.sstart = add(sp_pos, scale(P.shadow_bias, s.sdir));
  s.radius_sq = dot(s.sdir, s.sdir);
  const float rs_safe = s.radius_sq == 0.0f ? 1.0f : s.radius_sq;
  s.lam_base = nan_max(dot(s.sdir, sp_nrm), 0.0f) / (P.pi4 * rs_safe);
  s.lam_base = s.radius_sq == 0.0f ? 0.0f : s.lam_base;
  return s;
}

// The pixel's sample stream: seeded from the pixel id, restarted for every
// AA ray of the pixel.
struct Rng {
  uint32_t s0, s1, s2;
};

__device__ __forceinline__ Rng rng_seed(uint32_t gid) {
  const float gf = __uint2float_rn(gid);
  Rng r;
  r.s0 = xorshift(gid);
  r.s1 = xorshift((uint32_t)(gf * 91.0f));
  r.s2 = xorshift((uint32_t)(gf * 19.0f));
  return r;
}

// The next sample ray's direction `dir` and its squared length `dds`. Jittered: sample
// s uses the (s+1)-th xorshift of the pixel seed (kernels.cl:331). CPU-ref
// casts ONE unjittered hard shadow ray (skeleton.cpp:220-241).
__device__ __forceinline__ void sample_dir(const Params& P, uint32_t& s0, uint32_t& s1,
                                           uint32_t& s2, V3 sdir, float radius_sq, V3& dir,
                                           float& dds) {
  dir = sdir;
  dds = radius_sq;
  if (!P.cpu_ref) {
    s0 = xorshift(s0);
    s1 = xorshift(s1);
    s2 = xorshift(s2);
    dir = add(sdir, make(crush(s0, P.light_spread), crush(s1, P.light_spread),
                         crush(s2, P.light_spread)));
    dds = dot(dir, dir);
  }
}

// combine (kernels.cl:415-425)
__device__ __forceinline__ V3 shade_color(const Params& P, float lit, float lam_base,
                                          V3 light_rgb, V3 indirect, bool term_valid,
                                          V3 term_rgb, float weight, V3 rgb) {
  const float dl_scale = lit * lam_base / (float)P.shadow_samples;
  const V3 dl = make(light_rgb.x * dl_scale, light_rgb.y * dl_scale, light_rgb.z * dl_scale);
  if (term_valid)
    return make(0.9f * (indirect.x + dl.x) * term_rgb.x * weight,
                0.9f * (indirect.y + dl.y) * term_rgb.y * weight,
                0.9f * (indirect.z + dl.z) * term_rgb.z * weight);
  return make(rgb.x * (indirect.x + dl.x), rgb.y * (indirect.y + dl.y),
              rgb.z * (indirect.z + dl.z));
}

// --- AA mean + outputs: the float pixel and its ARGB pack ---
__device__ __forceinline__ void write_pixel(float* img, uint32_t* packed, size_t p, V3 fin) {
  float* o = img + p * 3;
  o[0] = fin.x;
  o[1] = fin.y;
  o[2] = fin.z;
  const uint32_t cr = (uint32_t)(int)fminf(fmaxf(255.0f * fin.x, 0.0f), 255.0f);
  const uint32_t cg = (uint32_t)(int)fminf(fmaxf(255.0f * fin.y, 0.0f), 255.0f);
  const uint32_t cb = (uint32_t)(int)fminf(fmaxf(255.0f * fin.z, 0.0f), 255.0f);
  packed[p] = (255u << 24) + (cr << 16) + (cg << 8) + cb;
}

// --- streaming a table from device memory ---
// One tile of the table at g (row stride `cols` floats, n_rows rows in
// all), rows [row0, row0 + kThreads): thread r copies row row0 + r. The
// caller has a barrier before (the previous tile is no longer read) and
// after. Returns the number of rows in the tile.
__device__ __forceinline__ int load_tile(float* tile, const float* __restrict__ g, int cols,
                                         int n_rows, int row0) {
  const int n = min(kThreads, n_rows - row0);
  if ((int)threadIdx.x < n) {
    const float* src = g + (size_t)(row0 + threadIdx.x) * cols;
    float* dst = tile + threadIdx.x * cols;
    for (int c = 0; c < cols; ++c) dst[c] = src[c];
  }
  return n;
}

}  // namespace
