// Ray, slab and Möller–Trumbore device functions shared by the traversal
// kernels (trace.cu, two_phase.cu).
//
// Arithmetic follows the plain versions (ops/intersect.py) operation by
// operation. The kernels are built with -fmad=false, so the compiler
// contracts nothing; the Möller–Trumbore test calls __fmaf_rn where the
// JAX package's jitted ray_triangle is fused by XLA:CPU (jnp.cross's
// a1*b2 - a2*b1 as fma(a1, b2, -(a2*b1)), a 3-term jnp.sum(x*y) as
// fma(x2, y2, fma(x1, y1, x0*y0))), so kernel, plain version and JAX agree
// bit for bit in t, u and v, also for rays from 1e8 units away.
//
// Binary node records (idkengine_tpu_torch/bvh/flatten.py:bvh2_nodes), phase
// A's layout: one 32-byte record per node in DFS order: min.xyz f32 |
// right_or_first i32 | max.xyz f32 | count i32. An interior node (count 0)
// has its left child at the next record and its right child at
// `right_or_first`. No box is empty or NaN, so fminf/fmaxf in the slab test
// see no NaN (CUDA's fminf returns the non-NaN operand, which would let a
// NaN sentinel box pass).
#pragma once

#include <cuda_runtime.h>

#define TRACE_STACK_SIZE 64  // phase A's stack on the binary records
#define TRACE_BLOCK 128

namespace {

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// The direction component with |d| raised to at least 1e-20, sign kept (d
// == -0 counts as +): ops/trace.py:inverse_direction's and _box_prune's.
__device__ __forceinline__ float clamped_dir(float d) {
  const float tiny = 1e-20f;
  return fabsf(d) < tiny ? (d < 0.0f ? -tiny : tiny) : d;
}

__device__ __forceinline__ float inv_clamped(float d) { return 1.0f / clamped_dir(d); }

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int i) {
  Ray r;
  r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
  r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
  r.ix = inv_clamped(r.dx); r.iy = inv_clamped(r.dy); r.iz = inv_clamped(r.dz);
  return r;
}

// Slab test of the box [lo, hi] against [0, t_best]; tn_out is the entry
// distance (clamped to 0).
__device__ __forceinline__ bool slab_box(float lox, float loy, float loz, float hix,
                                         float hiy, float hiz, const Ray& r,
                                         float t_best, float& tn_out) {
  float t0 = (lox - r.ox) * r.ix;
  float t1 = (hix - r.ox) * r.ix;
  float tn = fminf(t0, t1);
  float tf = fmaxf(t0, t1);
  t0 = (loy - r.oy) * r.iy;
  t1 = (hiy - r.oy) * r.iy;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  t0 = (loz - r.oz) * r.iz;
  t1 = (hiz - r.oz) * r.iz;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  tn = fmaxf(tn, 0.0f);
  tn_out = tn;
  return (tf >= tn) && (tn <= t_best);
}

// Slab test against the box of binary node record `node` (two float4
// loads, kept in a and b: a.w is right_or_first, b.w the count, both as
// int bits).
__device__ __forceinline__ bool slab(const float4* __restrict__ nodes, int node,
                                     const Ray& r, float t_best, float& tn_out,
                                     float4& a, float4& b) {
  a = __ldg(nodes + 2 * node);
  b = __ldg(nodes + 2 * node + 1);
  return slab_box(a.x, a.y, a.z, b.x, b.y, b.z, r, t_best, tn_out);
}

// jnp.cross's component a1*b2 - a2*b1 as XLA:CPU rounds it.
__device__ __forceinline__ float cross_c(float a1, float b2, float a2, float b1) {
  return __fmaf_rn(a1, b2, -(a2 * b1));
}

// A 3-term jnp.sum(x*y) as XLA:CPU rounds it.
__device__ __forceinline__ float dot3(float x0, float x1, float x2, float y0, float y1,
                                      float y2) {
  return __fmaf_rn(x2, y2, __fmaf_rn(x1, y1, x0 * y0));
}

// Möller–Trumbore on one slot's p0, e1, e2, in ops/intersect.py:ray_triangle's
// form (pv = cross(d, e2), qv = cross(s, e1)).
__device__ __forceinline__ bool triangle_values(float p0x, float p0y, float p0z, float e1x,
                                                float e1y, float e1z, float e2x, float e2y,
                                                float e2z, const Ray& r, float& t, float& u,
                                                float& v) {
  const float pvx = cross_c(r.dy, e2z, r.dz, e2y);
  const float pvy = cross_c(r.dz, e2x, r.dx, e2z);
  const float pvz = cross_c(r.dx, e2y, r.dy, e2x);
  const float det = dot3(e1x, e1y, e1z, pvx, pvy, pvz);
  const bool ok_det = fabsf(det) > 1e-12f;
  const float inv_det = ok_det ? 1.0f / det : 0.0f;
  const float sx = r.ox - p0x;
  const float sy = r.oy - p0y;
  const float sz = r.oz - p0z;
  u = dot3(sx, sy, sz, pvx, pvy, pvz) * inv_det;
  const float qx = cross_c(sy, e1z, sz, e1y);
  const float qy = cross_c(sz, e1x, sx, e1z);
  const float qz = cross_c(sx, e1y, sy, e1x);
  v = dot3(r.dx, r.dy, r.dz, qx, qy, qz) * inv_det;
  t = dot3(e2x, e2y, e2z, qx, qy, qz) * inv_det;
  return ok_det && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f;
}

// triangle_values on slot `s` of the scalar arrays p0, e1, e2 ((T,3) f32).
__device__ __forceinline__ bool triangle(const float* __restrict__ p0,
                                         const float* __restrict__ e1,
                                         const float* __restrict__ e2, int s,
                                         const Ray& r, float& t, float& u,
                                         float& v) {
  return triangle_values(__ldg(p0 + 3 * s), __ldg(p0 + 3 * s + 1), __ldg(p0 + 3 * s + 2),
                         __ldg(e1 + 3 * s), __ldg(e1 + 3 * s + 1), __ldg(e1 + 3 * s + 2),
                         __ldg(e2 + 3 * s), __ldg(e2 + 3 * s + 1), __ldg(e2 + 3 * s + 2), r,
                         t, u, v);
}

// triangle_values on slot `s` of tri_vec ((T,12) f32 p0 | e1 | e2 | pad):
// three float4 loads in place of nine scalar ones.
__device__ __forceinline__ bool triangle_vec(const float4* __restrict__ tri_vec, int s,
                                             const Ray& r, float& t, float& u, float& v) {
  const float4* tv = tri_vec + 3 * s;
  const float4 a = __ldg(tv), b = __ldg(tv + 1), c = __ldg(tv + 2);
  return triangle_values(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, r, t, u, v);
}

inline dim3 grid_for(int n_rays) {
  return dim3((unsigned)((n_rays + TRACE_BLOCK - 1) / TRACE_BLOCK));
}

}  // namespace
