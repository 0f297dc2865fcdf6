// Ray, slab and Möller–Trumbore device functions shared by the traversal
// kernels (trace.cu, two_phase.cu).
//
// Arithmetic follows the plain versions (ops/intersect.py) operation by
// operation; the kernels are built with -fmad=false, so no multiply-add is
// contracted and kernel and plain version agree bit for bit in t, u and v.
//
// Node records (idkengine_tpu_torch/bvh/flatten.py:bvh2_nodes): one 32-byte
// record per node in DFS order: min.xyz f32 | right_or_first i32 | max.xyz
// f32 | count i32. An interior node (count 0) has its left child at the
// next record and its right child at `right_or_first`; a leaf covers
// triangle slots [first, first + count) of tri_p0/e1/e2 (T,3) f32. No box
// is empty or NaN, so fminf/fmaxf in the slab test see no NaN (CUDA's fminf
// returns the non-NaN operand, which would let a NaN sentinel box pass).
#pragma once

#include <cuda_runtime.h>

#define TRACE_STACK_SIZE 64
#define TRACE_BLOCK 128

namespace {

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ float inv_clamped(float d) {
  const float tiny = 1e-20f;
  float c = fabsf(d) < tiny ? (d < 0.0f ? -tiny : tiny) : d;
  return 1.0f / c;
}

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

// Slab test against the box of node record `node` (two float4 loads, kept
// in a and b: a.w is right_or_first, b.w the count, both as int bits).
__device__ __forceinline__ bool slab(const float4* __restrict__ nodes, int node,
                                     const Ray& r, float t_best, float& tn_out,
                                     float4& a, float4& b) {
  a = __ldg(nodes + 2 * node);
  b = __ldg(nodes + 2 * node + 1);
  return slab_box(a.x, a.y, a.z, b.x, b.y, b.z, r, t_best, tn_out);
}

// Möller–Trumbore on (p0, e1, e2) of triangle slot `s`; the operation order
// is that of ops/intersect.py:ray_triangle.
__device__ __forceinline__ bool triangle(const float* __restrict__ p0,
                                         const float* __restrict__ e1,
                                         const float* __restrict__ e2, int s,
                                         const Ray& r, float& t, float& u,
                                         float& v) {
  const float e1x = __ldg(e1 + 3 * s), e1y = __ldg(e1 + 3 * s + 1), e1z = __ldg(e1 + 3 * s + 2);
  const float e2x = __ldg(e2 + 3 * s), e2y = __ldg(e2 + 3 * s + 1), e2z = __ldg(e2 + 3 * s + 2);
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool ok_det = fabsf(det) > 1e-12f;
  const float inv_det = ok_det ? 1.0f / det : 0.0f;
  const float sx = r.ox - __ldg(p0 + 3 * s);
  const float sy = r.oy - __ldg(p0 + 3 * s + 1);
  const float sz = r.oz - __ldg(p0 + 3 * s + 2);
  u = (sx * pvx + sy * pvy + sz * pvz) * inv_det;
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return ok_det && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f;
}

// triangle() on values already loaded (p0, e1, e2 of one slot), in the
// same operation order: the trace kernel's vector leaf loads.
__device__ __forceinline__ bool triangle_values(float p0x, float p0y, float p0z, float e1x,
                                                float e1y, float e1z, float e2x, float e2y,
                                                float e2z, const Ray& r, float& t, float& u,
                                                float& v) {
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool ok_det = fabsf(det) > 1e-12f;
  const float inv_det = ok_det ? 1.0f / det : 0.0f;
  const float sx = r.ox - p0x;
  const float sy = r.oy - p0y;
  const float sz = r.oz - p0z;
  u = (sx * pvx + sy * pvy + sz * pvz) * inv_det;
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return ok_det && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f;
}

inline dim3 grid_for(int n_rays) {
  return dim3((unsigned)((n_rays + TRACE_BLOCK - 1) / TRACE_BLOCK));
}

}  // namespace
