"""Intersection primitives on ray batches. Counterpart: idkengine_tpu/ops/intersect.py.

ref: Resource/Shaders/include/IntersectionRoutines.glsl. The Möller–Trumbore
test rounds as the JAX package's jitted function does on XLA:CPU,
which contracts `jnp.cross`'s `a1*b2 - a2*b1` into fma(a1, b2, -(a2*b1))
and a 3-term `jnp.sum(x*y)` into fma(x2, y2, fma(x1, y1, x0*y0)): every
fused multiply-add here is rounded once (`fma`), so t, u and v are bit-equal
with the JAX package's, also for rays from 1e8 units away, where one
rounding more or less moves t by thousands of units. These are the plain
versions of the CUDA kernels (csrc/trace_math.cuh), which compute the same
form with __fmaf_rn, so the two agree bit for bit too. The slab test has
nothing to contract and stays unfused.
"""
from __future__ import annotations

import torch

INF = 3.4e38


def fma(a, b, c):
    """a * b + c of float32 tensors, rounded once to float32.

    PyTorch names no fused multiply-add, but ATen's addcmul computes
    c + 1 * a * b as one: nvcc contracts it on the card, and the CPU
    kernels, compiled for AVX2 with FMA, contract it in their vector and
    scalar loops alike. tests/test_torch_far_origin.py holds it to exact
    rational arithmetic on the CPU and tests/test_torch_cuda.py on the card,
    where the two roundings of a * b + c differ."""
    return torch.addcmul(c, a, b)


def _cross(ax, ay, az, bx, by, bz):
    """jnp.cross as XLA:CPU rounds it: each component's first product fused."""
    return (fma(ay, bz, -(az * by)), fma(az, bx, -(ax * bz)), fma(ax, by, -(ay * bx)))


def cross3(a, b):
    """jnp.cross of (...,3) tensors as XLA:CPU rounds it."""
    return torch.stack(_cross(a[..., 0], a[..., 1], a[..., 2], b[..., 0], b[..., 1], b[..., 2]),
                       dim=-1)


def _dot(ax, ay, az, bx, by, bz):
    """A 3-term jnp.sum(a * b) as XLA:CPU rounds it."""
    return fma(az, bz, fma(ay, by, ax * bx))


def ray_aabb(o, inv_d, bmin, bmax, t_max):
    """Slab test. o/inv_d: (...,3); bmin/bmax broadcastable. Returns (hit, t_near)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    tn = torch.clamp(tn, min=0.0)
    return (tf >= tn) & (tn <= t_max), tn


def ray_triangle(o, d, p0, e1, e2):
    """Möller–Trumbore. All (...,3). Returns (hit, t, u, v) with t>0."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
    e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
    pvx, pvy, pvz = _cross(dx, dy, dz, e2x, e2y, e2z)
    det = _dot(e1x, e1y, e1z, pvx, pvy, pvz)
    ok_det = det.abs() > 1e-12
    inv_det = torch.where(ok_det, 1.0 / det, torch.zeros_like(det))
    s = o - p0
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
    u = _dot(sx, sy, sz, pvx, pvy, pvz) * inv_det
    qx, qy, qz = _cross(sx, sy, sz, e1x, e1y, e1z)
    v = _dot(dx, dy, dz, qx, qy, qz) * inv_det
    t = _dot(e2x, e2y, e2z, qx, qy, qz) * inv_det
    hit = ok_det & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return hit, t, u, v


def ray_sphere(o, d, center, radius):
    """Returns (hit, t) nearest positive root (ref: IntersectionRoutines RayVsSphere).

    Unfused: a fused form (b's sum as `_dot`, fma(-r, r, |oc|^2),
    fma(b, b, -c), a correctly rounded root) reproduces the jitted JAX
    ray_sphere alone but not the JAX package's jitted path-tracer pipeline,
    whose denoised frame it moved to RMSE 8.1e-3 from the port's
    (tests/test_torch_pipeline.py holds the two to 1e-3); this form stays
    within it."""
    oc = o - center
    b = (oc * d).sum(-1)
    c = (oc * oc).sum(-1) - radius * radius
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > 0.0, t0, t1)
    return (disc >= 0.0) & (t > 0.0), t
