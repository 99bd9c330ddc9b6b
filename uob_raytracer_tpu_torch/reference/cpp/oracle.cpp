// Scalar C++ oracle renderer.
//
// An independent, per-ray scalar implementation of the reference semantics
// (device kernel Source/kernels.cl:368-428 and the vestigial CPU renderer
// Source/skeleton.cpp:184-279), used from Python via ctypes to cross-check
// the vectorized NumPy oracle. Written scalar-first — one ray at a time, no
// SIMD, no shared code with the Python side — so a bug in the vectorized
// oracle's broadcasting can't hide here.
//
// Build with -ffp-contract=off: the parity contract with the NumPy oracle is
// plain (non-FMA) IEEE float32 arithmetic.

#include <cmath>
#include <cstdint>
#include <limits>

namespace {

struct V3 {
  float x, y, z;
};

inline V3 v3(float x, float y, float z) { return {x, y, z}; }
inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 operator*(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
inline V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 normalize(V3 a) {
  float n = std::sqrt(dot(a, a));
  return {a.x / n, a.y / n, a.z / n};
}

// Cofactor-expansion determinant of rows (a,b,c) — kernels.cl:31-35.
inline float det3(V3 a, V3 b, V3 c) {
  return a.x * (b.y * c.z - b.z * c.y) - a.y * (b.x * c.z - b.z * c.x) +
         a.z * (b.x * c.y - b.y * c.x);
}

struct SceneView {
  const float *tv0, *tv1, *tv2, *trgb, *tmat;
  int T;
  const float *sc, *sr2, *srgb, *smat;
  int S;
  V3 light_pos, light_color, indirect, camera;
  float yaw, pitch;
};

inline V3 ld(const float* p, int i) { return {p[3 * i], p[3 * i + 1], p[3 * i + 2]}; }

struct HitRec {
  int id = -1;  // triangle index, -2 sphere, -1 miss
  float t = std::numeric_limits<float>::max();
  V3 pos{}, normal{}, rgb{};
  float mat = 1.0f;
};

V3 tri_normal(const SceneView& s, int i) {
  V3 e1 = ld(s.tv1, i) - ld(s.tv0, i);
  V3 e2 = ld(s.tv2, i) - ld(s.tv0, i);
  V3 n = {e2.y * e1.z - e2.z * e1.y, e2.z * e1.x - e2.x * e1.z,
          e2.x * e1.y - e2.y * e1.x};  // cross(e2, e1), TestModelH.h:30
  return normalize(n);
}

// Nearest hit: triangles first (strict <, first index wins ties), then
// spheres with strict < against the running best (kernels.cl:168-241).
HitRec intersect(const SceneView& s, V3 start, V3 dir) {
  HitRec h;
  float cur = std::numeric_limits<float>::max();
  for (int i = 0; i < s.T; ++i) {
    V3 v0 = ld(s.tv0, i);
    V3 e1 = ld(s.tv1, i) - v0;
    V3 e2 = ld(s.tv2, i) - v0;
    V3 b = start - v0;
    float recip = 1.0f / det3(-dir, e1, e2);
    float t = det3(b, e1, e2) * recip;
    float u = det3(-dir, b, e2) * recip;
    float v = det3(-dir, e1, b) * recip;
    if (t < cur && u >= 0 && v >= 0 && (u + v) <= 1 && t >= 0) {
      h.id = i;
      h.pos = v0 + u * e1 + v * e2;
      h.normal = tri_normal(s, i);
      h.rgb = ld(s.trgb, i);
      h.mat = s.tmat[i];
      cur = t;
    }
  }
  for (int i = 0; i < s.S; ++i) {
    V3 L = start - ld(s.sc, i);
    float a = dot(dir, dir);
    float b = 2.0f * dot(dir, L);
    float c = dot(L, L) - s.sr2[i];
    float disc = b * b - 4.0f * a * c;
    if (disc < 0.0f) continue;
    float q = (b > 0) ? -0.5f * (b + std::sqrt(disc))
                      : -0.5f * (b - std::sqrt(disc));
    float x0 = q / a, x1 = c / q;
    float xmin = std::fmin(x0, x1), xmax = std::fmax(x0, x1);
    float cand = xmin >= 0.0f ? xmin : xmax;
    if (cand >= 0.0f && cand < cur) {
      h.id = -2;
      h.pos = start + cand * dir;
      h.normal = normalize(h.pos - ld(s.sc, i));
      h.rgb = ld(s.srgb, i);
      h.mat = s.smat[i];
      cur = cand;
    }
  }
  h.t = cur;
  return h;
}

// Occlusion toward the light; glass (mat == -1) skipped — kernels.cl:243-311.
bool in_shadow(const SceneView& s, V3 start, V3 dir, float radius_sq) {
  for (int i = 0; i < s.T; ++i) {
    if (s.tmat[i] == -1.0f) continue;
    V3 v0 = ld(s.tv0, i);
    V3 e1 = ld(s.tv1, i) - v0;
    V3 e2 = ld(s.tv2, i) - v0;
    V3 b = start - v0;
    float recip = 1.0f / det3(-dir, e1, e2);
    float t = det3(b, e1, e2) * recip;
    V3 dv = t * dir;
    float dist = dv.x * dv.x + dv.y * dv.y + dv.z * dv.z;
    if (t >= 0 && dist < radius_sq) {
      float u = det3(-dir, b, e2) * recip;
      float v = det3(-dir, e1, b) * recip;
      if (u >= 0 && v >= 0 && (u + v) <= 1) return true;
    }
  }
  for (int i = 0; i < s.S; ++i) {
    if (s.smat[i] == -1.0f) continue;
    V3 L = start - ld(s.sc, i);
    float a = dot(dir, dir);
    float b = 2.0f * dot(dir, L);
    float c = dot(L, L) - s.sr2[i];
    float disc = b * b - 4.0f * a * c;
    if (disc < 0.0f) continue;
    float q = (b > 0) ? -0.5f * (b + std::sqrt(disc))
                      : -0.5f * (b - std::sqrt(disc));
    float x0 = q / a, x1 = c / q;
    float xmin = std::fmin(x0, x1), xmax = std::fmax(x0, x1);
    float dd = dot(dir, dir);
    if (xmin >= 0.0f && xmin * xmin * dd < radius_sq) return true;
    if (xmax >= 0.0f && xmax * xmax * dd < radius_sq) return true;
  }
  return false;
}

struct U3 {
  uint32_t x, y, z;
};

inline U3 xorshift(U3 s) {
  s.x ^= s.x << 13; s.x ^= s.x >> 17; s.x ^= s.x << 5;
  s.y ^= s.y << 13; s.y ^= s.y >> 17; s.y ^= s.y << 5;
  s.z ^= s.z << 13; s.z ^= s.z >> 17; s.z ^= s.z << 5;
  return s;
}

inline V3 crush(U3 v, float range) {  // kernels.cl:49-52
  const float um = 4294967295.0f;
  return {range * (float)v.x / um - range / 2.0f,
          range * (float)v.y / um - range / 2.0f,
          range * (float)v.z / um - range / 2.0f};
}

struct Cfg {
  int shadow_samples, bounces, quirk_nan_tir;
  float light_spread, bias, ior_glass, ior_air;
};

V3 direct_light(const SceneView& s, const Cfg& c, V3 pos, V3 normal,
                uint32_t gid) {
  V3 sdir = s.light_pos - pos;
  V3 start = pos + c.bias * sdir;
  float radius_sq = sdir.x * sdir.x + sdir.y * sdir.y + sdir.z * sdir.z;
  float lambert = std::fmax(dot(sdir, normal), 0.0f) /
                  (4.0f * (float)M_PI * radius_sq);
  V3 lamb = {s.light_color.x * lambert, s.light_color.y * lambert,
             s.light_color.z * lambert};
  U3 st = xorshift({gid, (uint32_t)((float)gid * 91.0f),
                    (uint32_t)((float)gid * 19.0f)});
  V3 total = {0, 0, 0};
  for (int i = 0; i < c.shadow_samples; ++i) {
    st = xorshift(st);
    if (!in_shadow(s, start, sdir + crush(st, c.light_spread), radius_sq))
      total = total + lamb;
  }
  return (1.0f / (float)c.shadow_samples) * total;
}

V3 secondary_light(const SceneView& s, const Cfg& c, HitRec hit, V3 dir,
                   uint32_t gid) {
  V3 pos = hit.pos, normal = hit.normal;
  float mat = hit.mat;
  float medium = c.ior_air;
  for (int b = 0; b < c.bounces; ++b) {
    V3 new_dir;
    float new_medium;
    if (mat == 0.0f) {  // mirror, kernels.cl:54-65
      new_dir = dir - 2.0f * dot(dir, normal) * normal;
      new_medium = c.ior_air;
    } else {  // glass, kernels.cl:67-88
      V3 nrm = normal;
      float c1 = dot(normal, dir);
      if (c1 < 0.0f) nrm = -nrm;
      c1 = std::fabs(c1);
      float n1 = (medium == c.ior_air) ? c.ior_air : c.ior_glass;
      float n2 = (medium == c.ior_air) ? c.ior_glass : c.ior_air;
      float nr = n1 / n2;
      float k = 1.0f - nr * nr * (1.0f - c1 * c1);
      if (k < 0.0f) {
        if (c.quirk_nan_tir) return {0, 0, 0};  // NaN dir -> black
        new_dir = dir - 2.0f * dot(dir, normal) * normal;  // proper TIR
        new_medium = c.ior_air;
      } else {
        float c2 = std::sqrt(k);
        new_dir = nr * dir + (nr * c1 - c2) * (-nrm);
        new_medium = n2;
      }
    }
    V3 start = pos + c.bias * new_dir;
    new_dir = normalize(new_dir);
    HitRec h = intersect(s, start, new_dir);
    if (h.id == -1) return {0, 0, 0};
    if (h.mat > 0.0f) {
      V3 light = s.indirect + direct_light(s, c, h.pos, h.normal, gid);
      return {0.9f * light.x * h.rgb.x, 0.9f * light.y * h.rgb.y,
              0.9f * light.z * h.rgb.z};
    }
    pos = h.pos; normal = h.normal; mat = h.mat; dir = new_dir;
    medium = new_medium;
  }
  return {0, 0, 0};
}

void rot_rows(float yaw, float pitch, V3 r[3]) {  // skeleton.cpp:149-151
  float cy = std::cos(yaw), sy = std::sin(yaw);
  float cp = std::cos(pitch), sp = std::sin(pitch);
  r[0] = {cy, sp * sy, sy * cp};
  r[1] = {0.0f, cp, -sp};
  r[2] = {-sy, cy * sp, cp * cy};
}

}  // namespace

extern "C" {

// Full GPU-path semantics (kernels.cl draw). out is float[H][W][3].
int oracle_render_gpu(const float* tv0, const float* tv1, const float* tv2,
                      const float* trgb, const float* tmat, int T,
                      const float* sc, const float* sr2, const float* srgb,
                      const float* smat, int S, const float* light_pos,
                      const float* light_color, const float* indirect,
                      const float* camera, float yaw, float pitch, int width,
                      int height, int aa_x, int aa_y, int shadow_samples,
                      float light_spread, int bounces, float focal, float bias,
                      int quirk_nan_tir, float* out) {
  SceneView s{tv0, tv1, tv2, trgb, tmat, T, sc, sr2, srgb, smat, S,
              ld(light_pos, 0), ld(light_color, 0), ld(indirect, 0),
              ld(camera, 0), yaw, pitch};
  Cfg c{shadow_samples, bounces, quirk_nan_tir, light_spread, bias,
        1.52f, 1.0f};
  V3 r[3];
  rot_rows(yaw, pitch, r);
  for (int y = 0; y < height; ++y) {
    for (int x = 0; x < width; ++x) {
      uint32_t gid = (uint32_t)(y * width + x);
      V3 base = {(float)(x * aa_x) - (float)(width * aa_x) / 2.0f,
                 (float)(y * aa_y) - (float)(height * aa_y) / 2.0f, focal};
      V3 acc = {0, 0, 0};
      for (int dy = 0; dy < aa_y; ++dy) {
        for (int dx = 0; dx < aa_x; ++dx) {
          V3 d0 = base + v3((float)dx, (float)dy, 0.0f);
          V3 d = normalize({dot(r[0], d0), dot(r[1], d0), dot(r[2], d0)});
          HitRec h = intersect(s, s.camera, d);
          if (h.id == -1) continue;
          if (h.mat <= 0.0f) {
            acc = acc + secondary_light(s, c, h, d, gid);
          } else {
            V3 dl = direct_light(s, c, h.pos, h.normal, gid);
            V3 li = s.indirect + dl;
            acc = acc + v3(h.rgb.x * li.x, h.rgb.y * li.y, h.rgb.z * li.z);
          }
        }
      }
      float inv = 1.0f / (float)(aa_x * aa_y);
      out[(y * width + x) * 3 + 0] = acc.x * inv;
      out[(y * width + x) * 3 + 1] = acc.y * inv;
      out[(y * width + x) * 3 + 2] = acc.z * inv;
    }
  }
  return 0;
}

// Vestigial CPU-renderer semantics (skeleton.cpp:184-279): triangles only,
// unnormalized rays, |t*d| distances, one hard shadow ray, bias 1e-3.
int oracle_render_cpu_ref(const float* tv0, const float* tv1, const float* tv2,
                          const float* trgb, const float* tmat, int T,
                          const float* light_pos, const float* light_color,
                          const float* indirect, const float* camera,
                          float yaw, float pitch, int width, int height,
                          float focal, float bias, float* out) {
  SceneView s{tv0, tv1, tv2, trgb, tmat, T, nullptr, nullptr, nullptr,
              nullptr, 0, ld(light_pos, 0), ld(light_color, 0),
              ld(indirect, 0), ld(camera, 0), yaw, pitch};
  V3 r[3];
  rot_rows(yaw, pitch, r);
  for (int y = 0; y < height; ++y) {
    for (int x = 0; x < width; ++x) {
      V3 d0 = {(float)x - (float)width / 2.0f,
               (float)y - (float)height / 2.0f, focal};
      V3 d = {dot(r[0], d0), dot(r[1], d0), dot(r[2], d0)};  // unnormalized
      HitRec h = intersect(s, s.camera, d);
      V3 col = {0, 0, 0};
      if (h.id >= 0) {
        V3 rr = s.light_pos - h.pos;
        float radius = std::sqrt(dot(rr, rr));
        HitRec occ = intersect(s, h.pos + bias * rr, rr);
        // distance in unnormalized-direction units (skeleton.cpp:211)
        bool shadowed = false;
        if (occ.id >= 0) {
          V3 dv = occ.t * rr;
          shadowed = std::sqrt(dot(dv, dv)) < radius;
        }
        float lambert = std::fmax(dot(rr, h.normal), 0.0f) /
                        (4.0f * (float)M_PI * radius * radius);
        V3 dl = shadowed ? v3(0, 0, 0)
                         : v3(s.light_color.x * lambert,
                              s.light_color.y * lambert,
                              s.light_color.z * lambert);
        V3 li = dl + s.indirect;
        col = {h.rgb.x * li.x, h.rgb.y * li.y, h.rgb.z * li.z};
      }
      out[(y * width + x) * 3 + 0] = col.x;
      out[(y * width + x) * 3 + 1] = col.y;
      out[(y * width + x) * 3 + 2] = col.z;
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native OBJ loader — the C++ counterpart of Source/Loader.cpp:11-59:
// parses `v`/`f` records, scales vertices by `scale`, then negates and
// translates each face vertex. Returns the number of triangles written (or
// the required count if out_verts is null), -1 on file error.
// ---------------------------------------------------------------------------

#include <cstdio>
#include <cstring>
#include <vector>

extern "C" int oracle_load_obj(const char* path, float scale, const float* translate,
                               float* out_verts /* [n][3][3] or null */,
                               int max_tris) {
  std::FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  std::vector<V3> verts;
  int n_tris = 0;
  char line[512];
  V3 t = {translate[0], translate[1], translate[2]};
  while (std::fgets(line, sizeof line, f)) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      float x, y, z;
      if (std::sscanf(line + 1, "%f %f %f", &x, &y, &z) == 3)
        verts.push_back({scale * x, scale * y, scale * z});
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      int a, b, c;
      if (std::sscanf(line + 1, "%d %d %d", &a, &b, &c) == 3) {
        if (out_verts && n_tris < max_tris) {
          const int idx[3] = {a - 1, b - 1, c - 1};
          for (int k = 0; k < 3; ++k) {
            if (idx[k] < 0 || idx[k] >= (int)verts.size()) { std::fclose(f); return -2; }
            V3 p = -verts[idx[k]] + t;   // Loader.cpp:50-52
            out_verts[(n_tris * 3 + k) * 3 + 0] = p.x;
            out_verts[(n_tris * 3 + k) * 3 + 1] = p.y;
            out_verts[(n_tris * 3 + k) * 3 + 2] = p.z;
          }
        }
        ++n_tris;
      }
    }
  }
  std::fclose(f);
  return n_tris;
}
