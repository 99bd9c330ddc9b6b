// Path-replay backward kernel for Hopper (sm_90a): one launch per gradient.
//
// Replaces the TPU kernel kernels/render_bwd.py:_bwd_kernel of the JAX
// package (whole-table mode). From the packed scene tables, the image
// cotangent g and the forward kernel's decision record (pid, lit, bid) it
// computes the cotangents of the tables: per ray it gathers the objects the
// ray hit, replays the lean reconstruction of the ray's radiance
// (ops/replay.py: ray generation + primary hit, the bounce chain, the
// shading tail) and runs the adjoint of that replay in reverse.
//
// The TPU kernel calls jax.vjp inside its body; CUDA has no autodiff, so
// every adjoint here is derived by hand. The rules that make the gradient
// the framework's (PARITY.md "Gradient semantics"): a select passes its
// cotangent to the chosen branch only; mat, is_sph, valid, medium, lit and
// the tir / use_refl / dead decisions are frozen; max(x, 0) passes where
// x > 0; the guards disc == 0, k == 0, detA == 0, q == 0, a_q == 0,
// pl2 == 0 and radius_sq == 0 give a zero derivative; a triangle's normal
// is the packed table's column 9..11 and its cotangent goes there (the
// wrapper pulls it back onto the vertices through pack_scene). Division
// and sqrt are IEEE with their plain derivatives.
//
// Design (simple first):
// - One thread per pixel, looping over its A rays as the forward kernel
//   does. Per ray: a forward sweep over the bounce steps the ray really ran
//   (the record's depth, not the budget) that keeps the 12 floats a step's
//   adjoint needs (cur_d, cur_pos, cur_nrm, cur_mat, medium, weight) in
//   per-thread storage, the shading adjoint, the reverse sweep, and the
//   adjoint of the primary hit and the ray generation. The TPU kernel's
//   VMEM chain scratch becomes that per-thread array; its depth is a
//   compile-time cap (kMaxBounces) that the wrapper enforces.
// - The object rows (28 x 17 floats on the Cornell box) are staged into
//   shared memory as one unified table, so a gather is one indexed read:
//   the TPU kernel's presence-bit gather loop and its de Bruijn LUT are not
//   needed for gathering.
// - The TPU kernel accumulates into tables that persist across its
//   sequential grid. Blocks run concurrently here, so each block reduces
//   its own rays' cotangents and writes one row of partial sums
//   [n_obj*16 + 21]; the sum over blocks is a torch.sum in the wrapper.
//   No float atomics anywhere: within a warp, the lanes that hit the same
//   object at the same site are summed by a shuffle butterfly (the warp
//   visits only the objects its rays hit, which is the presence word's
//   second job), lane 0 adds the result to the warp's accumulator in
//   shared memory, and the block adds its four warps in order. Two runs on
//   the same inputs give bit-equal gradients.
// - The reverse sweep runs to the deepest chain of the warp, with shallower
//   lanes idle, so that all 32 lanes meet at every shuffle.
//
// What bounds it on this card: FP32 issue and the shuffle reductions; the
// record it reads (4 + 4 + 4*bounces bytes per ray) and the partial sums it
// writes are small beside that.
//
// Built with --fmad=false like the forward kernel, and with the replay's
// forward arithmetic in the order of ops/replay.py, so that the recomputed
// decisions (tir, the root chosen, the side of the normal) are those of the
// plain version bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "vec3.cuh"

namespace {

constexpr int kTriCols = 19;   // v0 e1 e2 n rgb mat E
constexpr int kSphCols = 12;   // c r2 rgb mat pad
constexpr int kCamCols = 21;   // r0 r1 r2 camera light light_rgb indirect
constexpr int kObjCols = 17;   // staged row: v0 e1 e2 n rgb mat r2
constexpr int kGradCols = 16;  // cotangent row: v0 e1 e2 n rgb r2
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBounces = 16;
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

// The row of object `id` from the staged table; -1 reads the miss row.
__device__ __forceinline__ Row load_row(const float* obj, int n_tri, int id) {
  Row r;
  r.valid = id >= 0;
  r.is_sph = id >= n_tri;
  if (!r.valid) {
    r.v0 = r.e1 = r.e2 = r.n = r.rgb = zero3();
    r.mat = 1.0f;
    r.r2 = 0.0f;
    return r;
  }
  const float* R = obj + id * kObjCols;
  r.v0 = load3(R);
  r.e1 = load3(R + 3);
  r.e2 = load3(R + 6);
  r.n = load3(R + 9);
  r.rgb = load3(R + 12);
  r.mat = R[15];
  r.r2 = R[16];
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
// and lane 0 adds each sum to the warp's accumulator: fixed order, no
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

__global__ void __launch_bounds__(kThreads)
    render_bwd_kernel(const float* __restrict__ g_tri, const float* __restrict__ g_sph,
                      const float* __restrict__ g_cam, const float* __restrict__ g_img,
                      const int* __restrict__ pid, const float* __restrict__ lit_in,
                      const int* __restrict__ bid, float* __restrict__ partial,
                      float* __restrict__ img, Params P) {
  extern __shared__ float smem[];
  const int n_obj = P.n_tri + P.n_sph;
  const int acc_cols = n_obj * kGradCols + kCamCols;
  float* obj = smem;
  float* cam = obj + n_obj * kObjCols;
  float* acc = cam + kCamCols;  // [kWarps][acc_cols]

  // --- stage the unified object table and zero the accumulators ---
  for (int i = threadIdx.x; i < n_obj * kObjCols; i += blockDim.x) {
    const int o = i / kObjCols, c = i - o * kObjCols;
    float v;
    if (o < P.n_tri) {
      v = c < 16 ? g_tri[o * kTriCols + c] : 0.0f;  // v0 e1 e2 n rgb mat | r2 = 0
    } else {
      const float* S = g_sph + (o - P.n_tri) * kSphCols;
      v = c < 3 ? S[c] : c < 12 ? 0.0f : c < 15 ? S[4 + (c - 12)] : c == 15 ? S[7] : S[3];
    }
    obj[i] = v;
  }
  for (int i = threadIdx.x; i < kCamCols; i += blockDim.x) cam[i] = g_cam[i];
  for (int i = threadIdx.x; i < kWarps * acc_cols; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wacc = acc + warp * acc_cols;
  const size_t n_pix = (size_t)P.rows * P.width;
  const size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  // threads past the ragged edge stay: they carry no ray but take part in
  // the warp's shuffles
  const bool in_img = p < n_pix;
  const int py = in_img ? (int)(p / P.width) : 0;
  const int px = in_img ? (int)(p - (size_t)py * P.width) : 0;

  const V3 r0 = load3(cam), r1 = load3(cam + 3), r2 = load3(cam + 6);
  const V3 cam_pos = load3(cam + 9), light = load3(cam + 12);
  const V3 light_rgb = load3(cam + 15), indirect = load3(cam + 18);
  const int A = P.aa_x * P.aa_y;
  const float fA = (float)A, fS = (float)P.shadow_samples;
  const float bx0 = (float)px * (float)P.aa_x - P.half_w;
  const float by0 = (float)(P.row0 + py) * (float)P.aa_y - P.half_h;
  V3 gpix = zero3();
  if (in_img) gpix = load3(g_img + p * 3);
  // cotangent of one ray's color: the AA mean is sum / A
  const V3 dcolor = make(gpix.x / fA, gpix.y / fA, gpix.z / fA);

  float dcam[kCamCols];
#pragma unroll
  for (int i = 0; i < kCamCols; ++i) dcam[i] = 0.0f;
  V3 img_acc = zero3();
  float saved[kMaxBounces][12];
  int saved_id[kMaxBounces];

  for (int a = 0; a < A; ++a) {
    const int id0 = in_img ? pid[a * n_pix + p] : -1;
    const float lit = in_img ? lit_in[a * n_pix + p] : 0.0f;

    // --- forward: ray generation + primary reconstruction ---
    const V3 base = make(bx0 + (float)(a % P.aa_x), by0 + (float)(a / P.aa_x), P.focal);
    const V3 draw = make(dot(r0, base), dot(r1, base), dot(r2, base));
    V3 d = draw;
    float dlen = 1.0f;
    if (!P.cpu_ref) {
      dlen = sqrtf(dot(draw, draw));
      d = make(draw.x / dlen, draw.y / dlen, draw.z / dlen);
    }
    const Row prow = load_row(obj, P.n_tri, id0);
    const HitOut ph = hit_fwd(prow, cam_pos, d);
    const bool prim_diffuse = P.cpu_ref ? prow.valid : (prow.valid && prow.mat > 0.0f);

    // --- forward: the bounce chain, as deep as this ray ran ---
    bool term_valid = false;
    V3 term_pos = zero3(), term_nrm = zero3(), term_rgb = zero3();
    float weight = 1.0f;
    int n_exec = 0;
    {
      V3 cur_d = d, cur_pos = ph.pos, cur_nrm = ph.nrm;
      float cur_mat = prow.mat, medium = P.ior_air;
      bool active = prow.valid && prow.mat <= 0.0f;
      while (active && n_exec < P.bounces) {
        const Step s = step_geometry(P, cur_d, cur_pos, cur_nrm, cur_mat, medium);
        if (s.dead) break;  // the step changes nothing and retires the ray
        const int idk = bid[((size_t)n_exec * A + a) * n_pix + p];
        float* sv = saved[n_exec];
        sv[0] = cur_d.x, sv[1] = cur_d.y, sv[2] = cur_d.z;
        sv[3] = cur_pos.x, sv[4] = cur_pos.y, sv[5] = cur_pos.z;
        sv[6] = cur_nrm.x, sv[7] = cur_nrm.y, sv[8] = cur_nrm.z;
        sv[9] = cur_mat, sv[10] = medium, sv[11] = weight;
        saved_id[n_exec] = idk;
        ++n_exec;
        weight = weight * s.w_step;
        const Row row = load_row(obj, P.n_tri, idk);
        const HitOut h = hit_fwd(row, s.nstart, s.ndirn);
        if (row.valid && row.mat > 0.0f) {
          term_valid = true;
          term_pos = h.pos;
          term_nrm = h.nrm;
          term_rgb = h.rgb;
        }
        active = row.valid && row.mat <= 0.0f;
        if (active) {
          cur_d = s.ndirn;
          cur_pos = h.pos;
          cur_nrm = h.nrm;
          cur_mat = row.mat;
          medium = s.nmed;
        }
      }
    }

    // --- shading tail and its adjoint (lit frozen) ---
    V3 dp_pos = zero3(), dp_nrm = zero3(), dp_rgb = zero3();
    V3 dt_pos = zero3(), dt_nrm = zero3(), dt_rgb = zero3();
    float dw = 0.0f;
    if (prim_diffuse || term_valid) {
      const V3 sp_pos = sel(prim_diffuse, ph.pos, term_pos);
      const V3 sp_nrm = sel(prim_diffuse, ph.nrm, term_nrm);
      const V3 sdir = sub(light, sp_pos);
      const float radius_sq = dot(sdir, sdir);
      const bool rz = radius_sq == 0.0f;
      const float rs = rz ? 1.0f : radius_sq;
      const float cosl = dot(sdir, sp_nrm);
      const float m = nan_max(cosl, 0.0f);
      const float den = P.pi4 * rs;
      const float lam = rz ? 0.0f : m / den;
      const float dl_scale = lit * lam / fS;
      const V3 e = add(indirect, scale(dl_scale, light_rgb));
      V3 de;
      if (term_valid) {
        img_acc = add(img_acc, make(0.9f * e.x * term_rgb.x * weight,
                                    0.9f * e.y * term_rgb.y * weight,
                                    0.9f * e.z * term_rgb.z * weight));
        de = make(0.9f * term_rgb.x * weight * dcolor.x, 0.9f * term_rgb.y * weight * dcolor.y,
                  0.9f * term_rgb.z * weight * dcolor.z);
        dt_rgb = make(0.9f * e.x * weight * dcolor.x, 0.9f * e.y * weight * dcolor.y,
                      0.9f * e.z * weight * dcolor.z);
        dw = 0.9f * e.x * term_rgb.x * dcolor.x + 0.9f * e.y * term_rgb.y * dcolor.y +
             0.9f * e.z * term_rgb.z * dcolor.z;
      } else {
        img_acc = add(img_acc, make(ph.rgb.x * e.x, ph.rgb.y * e.y, ph.rgb.z * e.z));
        de = make(ph.rgb.x * dcolor.x, ph.rgb.y * dcolor.y, ph.rgb.z * dcolor.z);
        dp_rgb = make(e.x * dcolor.x, e.y * dcolor.y, e.z * dcolor.z);
      }
      // e = indirect + light_rgb * dl_scale
      dcam[18] += de.x, dcam[19] += de.y, dcam[20] += de.z;
      dcam[15] += de.x * dl_scale, dcam[16] += de.y * dl_scale, dcam[17] += de.z * dl_scale;
      const float ddl = dot(de, light_rgb);
      // dl_scale = lit * lam / S; lam = max(cosl, 0) / (4 pi rs)
      const float dlam = rz ? 0.0f : ddl * lit / fS;
      const float dm = dlam / den;
      const float drs = -(dlam * lam) / rs;
      const float dcosl = cosl > 0.0f ? dm : (cosl == 0.0f ? 0.5f * dm : 0.0f);
      const V3 dsdir = add(scale(dcosl, sp_nrm), scale(2.0f * drs, sdir));
      const V3 dsp_nrm = scale(dcosl, sdir);
      dcam[12] += dsdir.x, dcam[13] += dsdir.y, dcam[14] += dsdir.z;
      if (prim_diffuse) {
        dp_pos = neg(dsdir);
        dp_nrm = dsp_nrm;
      } else {
        dt_pos = neg(dsdir);
        dt_nrm = dsp_nrm;
      }
    }

    // --- reverse sweep over the chain, to the warp's deepest ray ---
    V3 dc_d = zero3(), dc_pos = zero3(), dc_nrm = zero3();
    int k_max = n_exec;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) k_max = max(k_max, __shfl_xor_sync(kFull, k_max, off));
    for (int k = k_max - 1; k >= 0; --k) {
      RowGrad gr = zero_grad();
      int sid = -1;
      if (k < n_exec) {
        const float* sv = saved[k];
        const V3 cur_d = make(sv[0], sv[1], sv[2]), cur_pos = make(sv[3], sv[4], sv[5]);
        const V3 cur_nrm = make(sv[6], sv[7], sv[8]);
        const float w_prev = sv[11];
        const Step s = step_geometry(P, cur_d, cur_pos, cur_nrm, sv[9], sv[10]);
        const Row row = load_row(obj, P.n_tri, saved_id[k]);
        const bool diffuse = row.valid && row.mat > 0.0f;
        const bool cont = row.valid && row.mat <= 0.0f;
        // which outputs of the step the later cotangents reach
        V3 dh_pos = zero3(), dh_nrm = zero3(), dh_rgb = zero3(), dndirn = zero3();
        if (diffuse) {
          dh_pos = dt_pos, dh_nrm = dt_nrm, dh_rgb = dt_rgb;
          dt_pos = dt_nrm = dt_rgb = zero3();
        }
        if (cont) {
          dndirn = dc_d, dh_pos = dc_pos, dh_nrm = dc_nrm;
          dc_d = dc_pos = dc_nrm = zero3();
        }
        V3 dnstart = zero3();
        hit_bwd(row, s.nstart, s.ndirn, dh_pos, dh_nrm, dh_rgb, gr, dnstart, dndirn);
        if (row.valid) sid = saved_id[k];
        // ndirn = ndir * inv, inv = max(ndir.ndir, 1e-30)^(-1/2)
        V3 dndir = scale(s.inv, dndirn);
        const float dinv = dot(dndirn, s.ndir);
        if (s.nd2raw >= 1e-30f)
          dndir = add(dndir, scale(2.0f * (-0.5f * dinv * s.inv * s.inv * s.inv), s.ndir));
        // nstart = cur_pos + bias * ndir
        dc_pos = add(dc_pos, dnstart);
        dndir = add(dndir, scale(P.bias, dnstart));
        // weight = w_prev * w_step
        float dc1a = 0.0f;
        if (P.fresnel) {
          const float dw_step = dw * w_prev;
          dw = dw * s.w_step;
          if (!s.use_refl) {
            const float x2 = s.x * s.x;
            dc1a = dw_step * (1.0f - s.r0f) * 5.0f * (x2 * x2);  // -drefl_w/dc1a * dw_step
          }
        }
        float ddn = 0.0f;
        if (s.use_refl) {
          // refl = cur_d - (2 dn) cur_nrm
          dc_d = add(dc_d, dndir);
          dc_nrm = add(dc_nrm, scale(-2.0f * s.dn, dndir));
          ddn = -2.0f * dot(dndir, cur_nrm);
        } else {
          // refr = nr cur_d + (nr c1a - c2) (-nflip)
          const float sc = s.nr * s.c1a - s.c2;
          dc_d = add(dc_d, scale(s.nr, dndir));
          const float dsc = -dot(dndir, s.nflip);
          const V3 dnflip = scale(-sc, dndir);
          dc1a += s.nr * dsc;
          if (!s.tir && !s.kz) {
            // c2 = sqrt(k), k = 1 - nr^2 (1 - c1a^2)
            const float dk = -dsc / (2.0f * s.c2);
            dc1a += dk * (s.nr * s.nr) * (2.0f * s.c1a);
          }
          dc_nrm = add(dc_nrm, s.dn < 0.0f ? neg(dnflip) : dnflip);
        }
        // c1a = |dn|
        ddn += s.dn > 0.0f ? dc1a : (s.dn < 0.0f ? -dc1a : 0.0f);
        dc_d = add(dc_d, scale(ddn, cur_nrm));
        dc_nrm = add(dc_nrm, scale(ddn, cur_d));
      }
      warp_scatter(wacc, sid, gr);
    }

    // --- adjoint of the primary hit and the ray generation ---
    {
      RowGrad gr;
      V3 dstart = zero3(), dd = dc_d;
      hit_bwd(prow, cam_pos, d, add(dp_pos, dc_pos), add(dp_nrm, dc_nrm), dp_rgb, gr, dstart, dd);
      V3 ddraw = dd;
      if (!P.cpu_ref) {
        // d = draw / |draw|
        const float inv = 1.0f / dlen;
        ddraw = sub(scale(inv, dd), scale(inv * inv * inv * dot(dd, draw), draw));
      }
      if (prow.valid) {
        dcam[0] += ddraw.x * base.x, dcam[1] += ddraw.x * base.y, dcam[2] += ddraw.x * base.z;
        dcam[3] += ddraw.y * base.x, dcam[4] += ddraw.y * base.y, dcam[5] += ddraw.y * base.z;
        dcam[6] += ddraw.z * base.x, dcam[7] += ddraw.z * base.y, dcam[8] += ddraw.z * base.z;
        dcam[9] += dstart.x, dcam[10] += dstart.y, dcam[11] += dstart.z;
      }
      warp_scatter(wacc, prow.valid ? id0 : -1, gr);
    }
  }

  if (P.want_img && in_img) {
    img[p * 3 + 0] = img_acc.x / fA;
    img[p * 3 + 1] = img_acc.y / fA;
    img[p * 3 + 2] = img_acc.z / fA;
  }

  // --- camera cotangents: warp butterfly, then the block's partial row ---
#pragma unroll
  for (int i = 0; i < kCamCols; ++i) {
    float s = dcam[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    if (lane == 0) wacc[n_obj * kGradCols + i] = s;
  }
  __syncthreads();
  float* out = partial + (size_t)blockIdx.x * acc_cols;
  for (int i = threadIdx.x; i < acc_cols; i += blockDim.x) {
    float s = acc[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += acc[w * acc_cols + i];
    out[i] = s;
  }
}

}  // namespace

// Launches one backward pass on `stream`. ip and fp are HOST arrays:
// ip = {width, height, row0, rows, aa_x, aa_y, shadow_samples, bounces,
//       n_tri, n_sph, cpu_ref, fresnel, quirk_nan_tir, want_img}
// fp = {half_w, half_h, focal, bias, ior_glass, ior_air, pi4}
// g [rows, W, 3]; pid, lit [A, rows, W]; bid [bounces, A, rows, W] (may be
// null when bounces == 0); partial [ceil(rows*W / 128), (n_tri+n_sph)*16 + 21]
// is overwritten; img [rows, W, 3] receives the replayed radiance when
// want_img is set (else it may be null). Returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue when bounces exceeds the kernel's cap.
extern "C" int render_bwd_launch(const float* tri, const float* sph, const float* cam,
                                 const float* g, const int* pid, const float* lit,
                                 const int* bid, float* partial, float* img, const int* ip,
                                 const float* fp, void* stream) {
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
  if (P.bounces > kMaxBounces) return (int)cudaErrorInvalidValue;
  const long long n_pix = (long long)P.rows * P.width;
  if (n_pix == 0) return 0;
  const size_t n_obj = (size_t)P.n_tri + P.n_sph;
  const size_t smem =
      sizeof(float) * (n_obj * kObjCols + kCamCols + kWarps * (n_obj * kGradCols + kCamCols));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        render_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((n_pix + kThreads - 1) / kThreads);
  render_bwd_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(tri, sph, cam, g, pid, lit,
                                                                       bid, partial, img, P);
  return (int)cudaGetLastError();
}
