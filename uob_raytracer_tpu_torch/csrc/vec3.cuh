// 3-vector helpers shared by the render kernels. Every sum of products is
// written out term by term and the sources are built with --fmad=false, so
// each intermediate rounds to float32 in the same order as the kernels'
// plain torch versions (ops/math3.py).
#pragma once

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 make(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 load3(const float* p) { return make(p[0], p[1], p[2]); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return make(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return make(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 scale(float s, V3 a) { return make(s * a.x, s * a.y, s * a.z); }
__device__ __forceinline__ V3 sel(bool m, V3 a, V3 b) { return m ? a : b; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return make(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
// Cofactor expansion, rows (a, b, c) (kernels.cl:31-35).
__device__ __forceinline__ float det3(V3 a, V3 b, V3 c) {
  return a.x * (b.y * c.z - b.z * c.y) - a.y * (b.x * c.z - b.z * c.x) +
         a.z * (b.x * c.y - b.y * c.x);
}
// jnp.minimum / jnp.maximum: NaN in, NaN out.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
