"""Plain ray-triangle queries over every triangle of a scene, for the
reference: Möller–Trumbore in PyTorch, with one level of culling of its
own (triangles in Morton order, in clusters of `cluster`, each cluster's
box padded and slab-tested first, conservatively). Imports nothing of the
program.

The hit test is the renderer's contract: a triangle is hit at 0 < t < t_max
with u, v, u + v in [0, 1]; the closest hit is the least t, ties going to
the lowest triangle index; t_max <= 0 marks a dead ray. Products that the
renderer fuses are fused here (`fma`), so a float32 query rounds as its
trace does.
"""
from __future__ import annotations

import torch

INF = float("inf")


def fma(a, b, c):
    """a * b + c, rounded once (ATen's addcmul is a fused multiply-add)."""
    return torch.addcmul(c, a, b)


def cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([fma(ay, bz, -(az * by)), fma(az, bx, -(ax * bz)),
                        fma(ax, by, -(ay * bx))], -1)


def dot(a, b):
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def moller_trumbore(o, d, p0, e1, e2):
    """(hit, t, u, v) of rays o, d (N,3) against triangles p0, e1, e2 (N,3)."""
    pv = cross(d, e2)
    det = dot(e1, pv)
    ok = det.abs() > 1e-12
    inv = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    s = o - p0
    u = dot(s, pv) * inv
    q = cross(s, e1)
    v = dot(d, q) * inv
    t = dot(e2, q) * inv
    hit = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return hit, t, u, v


def _morton(q):
    """30-bit Morton codes of (N,3) int64 cells in 0..1023."""
    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249
    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


class Tracer:
    """Closest-hit and occlusion queries over triangles v0, v1, v2 (T,3)
    float32, computed in `dtype`."""

    def __init__(self, v0, v1, v2, dtype=torch.float32, cluster=128, ray_chunk=1024,
                 test_chunk=1 << 23):
        self.dtype, self.k, self.ray_chunk, self.test_chunk = dtype, cluster, ray_chunk, test_chunk
        dev = v0.device
        n = v0.shape[0]
        cen = (v0 + v1 + v2) / 3.0
        lo, hi = cen.amin(0), cen.amax(0)
        q = ((cen - lo) / torch.clamp(hi - lo, min=1e-12) * 1023.0).long().clamp(0, 1023)
        order = torch.argsort(_morton(q))
        pad = (-n) % cluster
        self.tri_id = torch.cat([order, torch.full((pad,), -1, dtype=torch.long, device=dev)])
        take = torch.clamp(self.tri_id, min=0)
        real = (self.tri_id >= 0)[:, None]
        a, b, c = (torch.where(real, x[take], x[order[:1]]) for x in (v0, v1, v2))
        # the renderer's edges, in float32, then the query's precision;
        # padding triangles are degenerate and never hit
        self.p0 = a.to(dtype)
        self.e1 = torch.where(real, b - a, 0.0).to(dtype)
        self.e2 = torch.where(real, c - a, 0.0).to(dtype)
        m = self.tri_id.shape[0] // cluster
        corners = torch.stack([a, b, c], 1).reshape(m, cluster * 3, 3)
        verts = torch.cat([v0, v1, v2])
        span = float((verts.amax(0) - verts.amin(0)).amax())
        pad_w = 1e-4 + 1e-6 * span
        self.bmin = corners.amin(1) - pad_w
        self.bmax = corners.amax(1) + pad_w

    def _pairs(self, o, d, t_max):
        """(ray, cluster) pairs whose padded box the ray enters before t_max."""
        dd = torch.where(d.abs() < 1e-30, torch.where(d < 0, -1e-30, 1e-30), d).float()
        inv = 1.0 / dd
        o = o.float()
        t0 = (self.bmin[None] - o[:, None]) * inv[:, None]
        t1 = (self.bmax[None] - o[:, None]) * inv[:, None]
        tn = torch.clamp(torch.minimum(t0, t1).amax(-1), min=0.0)
        tf = torch.maximum(t0, t1).amin(-1)
        live = (t_max > 0)[:, None]
        tm = t_max.float()[:, None]
        return ((tf >= tn * (1 - 1e-6)) & (tn <= tm * (1 + 1e-6)) & live).nonzero(as_tuple=True)

    def _tests(self, o, d, t_max):
        """Every hit closer than t_max: (ray, triangle slot here, t), over
        rays in chunks and tests in chunks."""
        rays, slots, ts = [], [], []
        ar = torch.arange(self.k, device=o.device)
        for r0 in range(0, o.shape[0], self.ray_chunk):
            ro, rd, rt = (x[r0:r0 + self.ray_chunk] for x in (o, d, t_max))
            ray, cl = self._pairs(ro, rd, rt)
            step = max(1, self.test_chunk // self.k)
            for p0 in range(0, ray.shape[0], step):
                r = ray[p0:p0 + step, None].expand(-1, self.k).reshape(-1)
                s = (cl[p0:p0 + step, None] * self.k + ar).reshape(-1)
                hit, t, _, _ = moller_trumbore(ro[r], rd[r], self.p0[s], self.e1[s], self.e2[s])
                hit = hit & (t < rt[r])
                rays.append(r[hit] + r0)
                slots.append(s[hit])
                ts.append(t[hit])
        if not rays:
            e = torch.zeros(0, dtype=torch.long, device=o.device)
            return e, e, torch.zeros(0, dtype=self.dtype, device=o.device)
        return torch.cat(rays), torch.cat(slots), torch.cat(ts)

    def closest(self, o, d, t_max):
        """(t, triangle index or -1, u, v) of each ray's closest hit; t is
        t_max on a miss."""
        o, d, t_max = o.to(self.dtype), d.to(self.dtype), t_max.to(self.dtype)
        n = o.shape[0]
        ray, slot, t = self._tests(o, d, t_max)
        best = torch.full((n,), INF, dtype=self.dtype, device=o.device)
        best = best.scatter_reduce(0, ray, t, "amin")
        tie = t == best[ray]
        big = torch.iinfo(torch.long).max
        tri = torch.full((n,), big, dtype=torch.long, device=o.device)
        tri = tri.scatter_reduce(0, ray[tie], self.tri_id[slot[tie]], "amin")
        got = tri != big
        # the winner's slot here, to recompute its u, v
        where = torch.full((n,), -1, dtype=torch.long, device=o.device)
        win = tie & (self.tri_id[slot] == tri[ray])
        where[ray[win]] = slot[win]
        s = torch.clamp(where, min=0)
        _, tw, u, v = moller_trumbore(o, d, self.p0[s], self.e1[s], self.e2[s])
        t_out = torch.where(got, tw, t_max)
        return t_out, torch.where(got, tri, -1), torch.where(got, u, 0.0), torch.where(got, v, 0.0)

    def occluded(self, o, d, t_max):
        """True where some triangle lies at 0 < t < t_max."""
        o, d, t_max = o.to(self.dtype), d.to(self.dtype), t_max.to(self.dtype)
        ray, _, _ = self._tests(o, d, t_max)
        occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        occ[ray] = True
        return occ
