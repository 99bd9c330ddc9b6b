// Device code shared by the two path-replay backward kernels: the
// whole-table kernel (render_bwd.cu) and the streamed kernel
// (render_bwd_streamed.cu). Here are the declarations: the launch
// parameters, an object's row and its cotangent, the hit reconstruction and
// its hand-derived adjoint, the bounce step's geometry, and the warp's
// scatter. What one ray does with them (the forward sweep, the shading
// adjoint, the reverse sweep, the adjoint of the primary hit and the ray
// generation) is bwd_ray.cuh, which the streamed kernel and the
// whole-table chain kernel include inside their __global__ functions, one
// thread per AA ray; the whole-table chain-free kernel includes
// bwd_body.cuh, a pixel's rays in a loop around it. The kernels differ in
// their launch, in where an object's row is read from and in where a row's
// cotangent goes. The rules that make the gradient the framework's are
// listed at the top of render_bwd.cu. The warp's sums (warp_scatter,
// warp_camera) stay a butterfly per column: a reduce-scatter (a lane keeps
// half its columns at each level, 16 shuffles for an object's 16 columns
// where these take 80) gave the same bits but ran 4-9% slower in K2's
// launches, K2' and K3b, and 6% faster only in K3b's deep instance
// (PERF.md, PR 7).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "vec3.cuh"

namespace {

constexpr int kTriCols = 19;   // v0 e1 e2 n rgb mat E
constexpr int kSphCols = 12;   // c r2 rgb mat pad
constexpr int kCamCols = 21;   // r0 r1 r2 camera light light_rgb indirect
constexpr int kObjCols = 17;   // staged row: v0 e1 e2 n rgb mat r2
constexpr int kGradCols = 16;  // cotangent row: v0 e1 e2 n rgb r2
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// The bounce chain a ray keeps for its reverse sweep: 12 floats and an id
// per step. Up to kRegBounces steps it lives in a per-thread array (the
// register instance, the default); deeper configs take the deep instance,
// whose chain lives in a device buffer (DeepSteps, DeepIds).
constexpr int kRegBounces = 16;
constexpr int kStepFloats = 12;
constexpr int kChainFloats = kStepFloats + 1;  // a deep step: the floats and the id
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  int width, height, row0, rows;
  int aa_x, aa_y, shadow_samples, bounces;
  int n_tri, n_sph;
  int cpu_ref, fresnel, quirk_nan_tir, want_img;
  float half_w, half_h, focal, bias, ior_glass, ior_air, pi4;
};

__device__ __forceinline__ V3 zero3() { return make(0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ V3 neg(V3 a) { return make(-a.x, -a.y, -a.z); }

struct Row {  // one object's differentiable row and its frozen codes
  V3 v0, e1, e2, n, rgb;
  float mat, r2;
  bool is_sph, valid;
};

struct RowGrad {
  V3 v0, e1, e2, n, rgb;
  float r2;
};

__device__ __forceinline__ RowGrad zero_grad() {
  RowGrad g;
  g.v0 = g.e1 = g.e2 = g.n = g.rgb = zero3();
  g.r2 = 0.0f;
  return g;
}

// ip = {width, height, row0, rows, aa_x, aa_y, shadow_samples, bounces,
//       n_tri, n_sph, cpu_ref, fresnel, quirk_nan_tir, want_img}
// fp = {half_w, half_h, focal, bias, ior_glass, ior_air, pi4}
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
  P.cpu_ref = ip[10];
  P.fresnel = ip[11];
  P.quirk_nan_tir = ip[12];
  P.want_img = ip[13];
  P.half_w = fp[0];
  P.half_h = fp[1];
  P.focal = fp[2];
  P.bias = fp[3];
  P.ior_glass = fp[4];
  P.ior_air = fp[5];
  P.pi4 = fp[6];
  return P;
}

// The deep instance's chain: step k of this thread in a device buffer laid
// out thread-major, float j of step k at ((k * 13 + j) * stride + t) and
// its id at ((k * 13 + 12) * stride + t), t the thread's index in the grid
// and stride the grid's thread count, so that a warp's step-k stores and
// loads coalesce. saved[k][j] and saved_id[k] read as they do on the
// per-thread arrays of the register instance.
struct DeepRow {
  float* p;
  size_t stride;
  __device__ __forceinline__ float& operator[](int j) const { return p[(size_t)j * stride]; }
};
struct DeepSteps {
  float* p;  // the buffer at this thread's index
  size_t stride;
  __device__ __forceinline__ DeepRow operator[](int k) const {
    return DeepRow{p + (size_t)k * kChainFloats * stride, stride};
  }
};
struct DeepIds {
  int* p;  // the buffer's id column of step 0 at this thread's index
  size_t stride;
  __device__ __forceinline__ int& operator[](int k) const {
    return p[(size_t)k * kChainFloats * stride];
  }
};

// The chain storage of an instance: the per-thread arrays, or the buffer.
template <bool Deep>
using ChainSteps = std::conditional_t<Deep, DeepSteps, float[kRegBounces][kStepFloats]>;
template <bool Deep>
using ChainIds = std::conditional_t<Deep, DeepIds, int[kRegBounces]>;

// Points the deep instance's chain storage at this thread's pixel p of
// the buffer (stride: its length per float of a step); the register
// instance's arrays need nothing.
template <bool Deep>
__device__ __forceinline__ void deep_chain(ChainSteps<Deep>& saved, ChainIds<Deep>& saved_id,
                                           float* chain, size_t p, size_t stride) {
  if constexpr (Deep) {
    saved = DeepSteps{chain + p, stride};
    saved_id = DeepIds{reinterpret_cast<int*>(chain + kStepFloats * stride) + p, stride};
  }
}

// The row that stands for a miss (id -1).
__device__ __forceinline__ Row miss_row() {
  Row r;
  r.valid = r.is_sph = false;
  r.v0 = r.e1 = r.e2 = r.n = r.rgb = zero3();
  r.mat = 1.0f;
  r.r2 = 0.0f;
  return r;
}

struct HitOut {
  V3 pos, nrm, rgb;
};

// Hit reconstruction from the gathered row (ops/replay.py:_hit_from_row):
// Cramer u, v for the identified triangle, the stable quadratic root for
// the identified sphere. An invalid row gives zeros.
__device__ HitOut hit_fwd(const Row& r, V3 start, V3 d) {
  HitOut h;
  h.pos = h.nrm = h.rgb = zero3();
  if (!r.valid) return h;
  h.rgb = r.rgb;
  if (!r.is_sph) {
    const V3 nd = neg(d);
    const V3 b = sub(start, r.v0);
    const float detA = det3(nd, r.e1, r.e2);
    const float recip = 1.0f / (detA == 0.0f ? 1.0f : detA);
    const float u = det3(nd, b, r.e2) * recip;
    const float v = det3(nd, r.e1, b) * recip;
    h.pos = add(add(r.v0, scale(u, r.e1)), scale(v, r.e2));
    h.nrm = r.n;
    return h;
  }
  const V3 L = sub(start, r.v0);
  const float a_q = dot(d, d);
  const float b_q = 2.0f * dot(d, L);
  const float c_q = dot(L, L) - r.r2;
  const float disc = b_q * b_q - 4.0f * a_q * c_q;
  const bool no_sol = disc < 0.0f;
  const bool sq_zero = disc == 0.0f;
  float sq = sqrtf((no_sol || sq_zero) ? 1.0f : disc);
  sq = sq_zero ? 0.0f : sq;
  const float q = b_q > 0.0f ? -0.5f * (b_q + sq) : -0.5f * (b_q - sq);
  const bool qz = q == 0.0f;
  const float x0 = q / (a_q == 0.0f ? 1.0f : a_q);
  const float x1 = qz ? x0 : c_q / q;
  const float xmin = nan_min(x0, x1);
  const float xmax = nan_max(x0, x1);
  float cand = xmin >= 0.0f ? xmin : xmax;
  cand = no_sol ? 0.0f : cand;
  h.pos = add(start, scale(cand, d));
  const V3 pc = sub(h.pos, r.v0);
  const float pl2 = dot(pc, pc);
  const float plen = sqrtf(pl2 == 0.0f ? 1.0f : pl2);
  h.nrm = make(pc.x / plen, pc.y / plen, pc.z / plen);
  return h;
}

// Adjoint of hit_fwd: cotangents (dpos, dnrm, drgb) of its outputs give the
// row's cotangent g (overwritten) and are ADDED into dstart and dd.
__device__ void hit_bwd(const Row& r, V3 start, V3 d, V3 dpos, V3 dnrm, V3 drgb, RowGrad& g,
                        V3& dstart, V3& dd) {
  g = zero_grad();
  if (!r.valid) return;
  g.rgb = drgb;
  if (!r.is_sph) {
    g.n = dnrm;
    const V3 nd = neg(d);
    const V3 b = sub(start, r.v0);
    const float detA = det3(nd, r.e1, r.e2);
    const bool degen = detA == 0.0f;
    const float recip = 1.0f / (degen ? 1.0f : detA);
    const float nu = det3(nd, b, r.e2);
    const float nv = det3(nd, r.e1, b);
    const float u = nu * recip;
    const float v = nv * recip;
    // pos = v0 + u e1 + v e2
    const float du = dot(dpos, r.e1);
    const float dv = dot(dpos, r.e2);
    g.v0 = dpos;
    g.e1 = scale(u, dpos);
    g.e2 = scale(v, dpos);
    // u = nu * recip, v = nv * recip, recip = 1 / detA
    const float dnu = du * recip;
    const float dnv = dv * recip;
    const float drecip = du * nu + dv * nv;
    const float ddet = degen ? 0.0f : -(drecip * recip * recip);
    // det3(a, b, c) = a . (b x c): d/da = b x c, d/db = c x a, d/dc = a x b
    V3 dnd = scale(ddet, cross(r.e1, r.e2));
    g.e1 = add(g.e1, scale(ddet, cross(r.e2, nd)));
    g.e2 = add(g.e2, scale(ddet, cross(nd, r.e1)));
    dnd = add(dnd, scale(dnu, cross(b, r.e2)));
    V3 db = scale(dnu, cross(r.e2, nd));
    g.e2 = add(g.e2, scale(dnu, cross(nd, b)));
    dnd = add(dnd, scale(dnv, cross(r.e1, b)));
    g.e1 = add(g.e1, scale(dnv, cross(b, nd)));
    db = add(db, scale(dnv, cross(nd, r.e1)));
    dd = sub(dd, dnd);
    dstart = add(dstart, db);
    g.v0 = sub(g.v0, db);
    return;
  }
  // --- sphere: recompute the forward, then walk it backwards ---
  const V3 c = r.v0;
  const V3 L = sub(start, c);
  const float a_q = dot(d, d);
  const float b_q = 2.0f * dot(d, L);
  const float c_q = dot(L, L) - r.r2;
  const float disc = b_q * b_q - 4.0f * a_q * c_q;
  const bool no_sol = disc < 0.0f;
  const bool sq_zero = disc == 0.0f;
  float sq = sqrtf((no_sol || sq_zero) ? 1.0f : disc);
  sq = sq_zero ? 0.0f : sq;
  const float q = b_q > 0.0f ? -0.5f * (b_q + sq) : -0.5f * (b_q - sq);
  const bool qz = q == 0.0f;
  const bool az = a_q == 0.0f;
  const float a_s = az ? 1.0f : a_q;
  const float x0 = q / a_s;
  const float x1 = qz ? x0 : c_q / q;
  const float xmin = nan_min(x0, x1);
  const float xmax = nan_max(x0, x1);
  const bool take_min = xmin >= 0.0f;
  float cand = take_min ? xmin : xmax;
  cand = no_sol ? 0.0f : cand;
  const V3 pos = add(start, scale(cand, d));
  const V3 pc = sub(pos, c);
  const float pl2 = dot(pc, pc);
  const bool pz = pl2 == 0.0f;
  const float inv = 1.0f / sqrtf(pz ? 1.0f : pl2);
  // nrm = pc * inv, inv = pl2^(-1/2)
  V3 dpc = scale(inv, dnrm);
  const float dinv = dot(dnrm, pc);
  const float dpl2 = pz ? 0.0f : -0.5f * dinv * inv * inv * inv;
  dpc = add(dpc, scale(2.0f * dpl2, pc));
  // pc = pos - c; pos = start + cand d
  const V3 dp = add(dpos, dpc);
  V3 dc = neg(dpc);
  dstart = add(dstart, dp);
  dd = add(dd, scale(cand, dp));
  const float dcand = no_sol ? 0.0f : dot(dp, d);
  // cand = xmin or xmax; min/max split a tie evenly
  const float dxmin = take_min ? dcand : 0.0f;
  const float dxmax = take_min ? 0.0f : dcand;
  float dx0, dx1;
  if (x0 < x1) {
    dx0 = dxmin;
    dx1 = dxmax;
  } else if (x1 < x0) {
    dx0 = dxmax;
    dx1 = dxmin;
  } else {
    dx0 = dx1 = 0.5f * (dxmin + dxmax);
  }
  float dq = 0.0f, dc_q = 0.0f;
  if (qz) {
    dx0 += dx1;
  } else {
    dc_q = dx1 / q;
    dq = -(dx1 * c_q) / (q * q);
  }
  dq += dx0 / a_s;
  float da_q = az ? 0.0f : -(dx0 * q) / (a_s * a_s);
  float db_q = -0.5f * dq;
  const float dsq = b_q > 0.0f ? -0.5f * dq : 0.5f * dq;
  const float ddisc = (no_sol || sq_zero) ? 0.0f : dsq / (2.0f * sq);
  db_q += 2.0f * b_q * ddisc;
  da_q += -4.0f * c_q * ddisc;
  dc_q += -4.0f * a_q * ddisc;
  // c_q = L.L - r2; b_q = 2 d.L; a_q = d.d; L = start - c
  V3 dL = scale(2.0f * dc_q, L);
  g.r2 = -dc_q;
  dL = add(dL, scale(2.0f * db_q, d));
  dd = add(dd, scale(2.0f * db_q, L));
  dd = add(dd, scale(2.0f * da_q, d));
  dstart = add(dstart, dL);
  dc = sub(dc, dL);
  g.v0 = dc;
}

// One warp sums the row cotangents of the lanes that hit the same object
// and lane 0 adds each sum to the warp's accumulator: per distinct object,
// a 5-level xor butterfly for each of its 16 columns. Fixed order, no
// atomics. id < 0: this lane has nothing to add. All 32 lanes call it.
__device__ void warp_scatter(float* wacc, int id, const RowGrad& g) {
  const int lane = threadIdx.x & 31;
  unsigned todo = __ballot_sync(kFull, id >= 0);
  while (todo) {
    const int o = __shfl_sync(kFull, id, __ffs(todo) - 1);
    const bool m = id == o;
    float v[kGradCols] = {g.v0.x, g.v0.y, g.v0.z, g.e1.x, g.e1.y,  g.e1.z,  g.e2.x,  g.e2.y,
                          g.e2.z, g.n.x,  g.n.y,  g.n.z,  g.rgb.x, g.rgb.y, g.rgb.z, g.r2};
#pragma unroll
    for (int c = 0; c < kGradCols; ++c) {
      float s = m ? v[c] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
      if (lane == 0) wacc[o * kGradCols + c] += s;
    }
    todo &= ~__ballot_sync(kFull, m);
  }
}

// The warp's sums of the 21 camera columns, a 5-level butterfly each,
// added by lane 0 to the warp's 21 accumulators. All 32 lanes call it.
__device__ __forceinline__ void warp_camera(float* wcam, const float (&dcam)[kCamCols]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kCamCols; ++i) {
    float s = dcam[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    if (lane == 0) wcam[i] += s;
  }
}

__device__ __forceinline__ RowGrad add_grad(const RowGrad& a, const RowGrad& b) {
  RowGrad r;
  r.v0 = add(a.v0, b.v0);
  r.e1 = add(a.e1, b.e1);
  r.e2 = add(a.e2, b.e2);
  r.n = add(a.n, b.n);
  r.rgb = add(a.rgb, b.rgb);
  r.r2 = a.r2 + b.r2;
  return r;
}

// What one bounce step computes from its saved inputs, kept for the adjoint.
struct Step {
  V3 refl, nflip, ndir, ndirn, nstart;
  float dn, c1a, nr, k, c2, inv, nd2raw, w_step, x, r0f;
  bool tir, kz, use_refl, dead;
  float nmed;
};

// The geometry of one bounce step (ops/replay.py:211-246), up to the new
// ray (nstart, ndirn).
__device__ __forceinline__ Step step_geometry(const Params& P, V3 cur_d, V3 cur_pos, V3 cur_nrm,
                                              float cur_mat, float medium) {
  Step s;
  s.dn = dot(cur_d, cur_nrm);
  s.refl = sub(cur_d, scale(2.0f * s.dn, cur_nrm));
  s.nflip = sel(s.dn < 0.0f, neg(cur_nrm), cur_nrm);
  s.c1a = fabsf(s.dn);
  const bool in_air = medium == P.ior_air;
  const float n1 = in_air ? P.ior_air : P.ior_glass;
  const float n2 = in_air ? P.ior_glass : P.ior_air;
  s.nr = n1 / n2;
  s.k = 1.0f - s.nr * s.nr * (1.0f - s.c1a * s.c1a);
  s.tir = s.k < 0.0f;
  s.kz = s.k == 0.0f;
  s.c2 = sqrtf((s.tir || s.kz) ? 1.0f : s.k);
  s.c2 = s.kz ? 0.0f : s.c2;
  const V3 refr = add(scale(s.nr, cur_d), scale(s.nr * s.c1a - s.c2, neg(s.nflip)));
  const bool is_mirror = cur_mat == 0.0f;
  s.dead = P.quirk_nan_tir ? (s.tir && !is_mirror) : false;
  s.use_refl = P.quirk_nan_tir ? is_mirror : (is_mirror || s.tir);
  s.ndir = sel(s.use_refl, s.refl, refr);
  s.nmed = s.use_refl ? P.ior_air : n2;
  s.nstart = add(cur_pos, scale(P.bias, s.ndir));
  s.nd2raw = dot(s.ndir, s.ndir);
  const float nlen = sqrtf(fmaxf(s.nd2raw, 1e-30f));
  s.inv = 1.0f / nlen;
  s.ndirn = make(s.ndir.x / nlen, s.ndir.y / nlen, s.ndir.z / nlen);
  s.w_step = 1.0f;
  s.x = 0.0f;
  s.r0f = 0.0f;
  if (P.fresnel) {
    const float r = (n1 - n2) / (n1 + n2);
    s.r0f = r * r;
    s.x = 1.0f - s.c1a;
    const float x2 = s.x * s.x;
    const float refl_w = s.r0f + (1.0f - s.r0f) * (s.x * (x2 * x2));
    s.w_step = s.use_refl ? 1.0f : 1.0f - refl_w;
  }
  return s;
}

}  // namespace
