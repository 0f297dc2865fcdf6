"""A plain bounding-volume hierarchy for the reference's ray queries, built in
PyTorch from the triangles alone, with the contract of tracer.py exactly:
the same Möller–Trumbore (imported), a hit at 0 < t < t_max, the closest
hit the least t with ties going to the lowest triangle index, t_max <= 0 a
dead ray, an occlusion query answering a boolean. Imports nothing of the
program.

The tree: triangles in Morton order of their centroids (30-bit codes, ties
by index), LEAF to a leaf, the leaves under a complete binary tree in heap
order (node i's children 2i+1 and 2i+2), every box padded as tracer.py pads
its clusters' boxes and slab-tested with the same slack, so no triangle a
ray can hit is ever culled. The walk is a wavefront over rays in chunks:
each live ray takes the top POPS entries of a stack of its own a step, tests
the triangles of the leaves among them and pushes the children that the
inner ones' rays enter (the nearer above the farther); for closest hits each
entry keeps its box's entry distance and is skipped once a closer hit is
known. Box tests are float32; the triangle tests run in the query's dtype.
"""
from __future__ import annotations

import torch

from .tracer import _morton, moller_trumbore

LEAF = 4  # triangles a leaf
POPS = 8  # stack entries a ray takes a step
SLACK = 1e-6  # relative slack of the slab test (tracer.py's)
BIG = torch.iinfo(torch.long).max


class BvhTracer:
    """Closest-hit and occlusion queries over triangles v0, v1, v2 (T,3)
    float32, computed in `dtype`."""

    def __init__(self, v0, v1, v2, dtype=torch.float32, ray_chunk=1 << 21):
        self.dtype, self.ray_chunk = dtype, ray_chunk
        dev = v0.device
        n = v0.shape[0]
        cen = (v0 + v1 + v2) / 3.0
        lo, hi = cen.amin(0), cen.amax(0)
        q = ((cen - lo) / torch.clamp(hi - lo, min=1e-12) * 1023.0).long().clamp(0, 1023)
        order = torch.argsort(_morton(q), stable=True)
        leaves = -(-n // LEAF)
        self.depth = max(0, (leaves - 1).bit_length())  # levels below the root
        width = 1 << self.depth  # leaves of the complete tree, the last ones empty
        pad = width * LEAF - n
        self.tri_id = torch.cat([order, torch.full((pad,), -1, dtype=torch.long, device=dev)])
        take = torch.clamp(self.tri_id, min=0)
        real = (self.tri_id >= 0)[:, None]
        a, b, c = (torch.where(real, x[take], x[order[:1]]) for x in (v0, v1, v2))
        # the renderer's edges, in float32, then the query's precision;
        # padding triangles are degenerate and never hit
        self.p0 = a.to(dtype)
        self.e1 = torch.where(real, b - a, 0.0).to(dtype)
        self.e2 = torch.where(real, c - a, 0.0).to(dtype)
        verts = torch.cat([v0, v1, v2])
        span = float((verts.amax(0) - verts.amin(0)).amax())
        pad_w = 1e-4 + 1e-6 * span
        corners = torch.stack([a, b, c], 1).reshape(width, LEAF * 3, 3)
        real_c = real.reshape(width, LEAF, 1).expand(-1, -1, 3).reshape(width, LEAF * 3, 1)
        inf = float("inf")
        bmin = torch.where(real_c, corners, inf).amin(1) - pad_w
        bmax = torch.where(real_c, corners, -inf).amax(1) + pad_w
        levels = [(bmin, bmax)]
        for _ in range(self.depth):
            lo_, hi_ = levels[-1]
            levels.append((torch.minimum(lo_[0::2], lo_[1::2]),
                           torch.maximum(hi_[0::2], hi_[1::2])))
        levels.reverse()  # root first: heap order
        self.bmin = torch.cat([x for x, _ in levels])
        self.bmax = torch.cat([x for _, x in levels])
        self.empty = ~(self.bmin <= self.bmax).all(-1)
        self.first_leaf = width - 1  # heap index of leaf 0
        self.slot = torch.zeros(n, dtype=torch.long, device=dev)  # each triangle's slot
        self.slot[order] = torch.arange(n, device=dev)

    # -- the walk ------------------------------------------------------------
    def _boxes(self, node, o, inv, t_lim):
        """(entered, entry distance) of rays o, inv (M,3) float32 into the
        boxes of `node` (M,) before t_lim (M,) float32."""
        t0 = (self.bmin[node] - o) * inv
        t1 = (self.bmax[node] - o) * inv
        tn = torch.clamp(torch.minimum(t0, t1).amax(-1), min=0.0)
        tf = torch.maximum(t0, t1).amin(-1)
        hit = (tf >= tn * (1 - SLACK)) & (tn <= t_lim * (1 + SLACK)) & ~self.empty[node]
        return hit, tn

    def _walk(self, o, d, t_max, any_hit):
        """One chunk: (best t (N,) in dtype, its triangle index or BIG) for
        closest hits, (occluded (N,), None) for any hit."""
        n, dev = o.shape[0], o.device
        dd = torch.where(d.abs() < 1e-30, torch.where(d < 0, -1e-30, 1e-30), d).float()
        inv, of = 1.0 / dd, o.float()
        best = t_max.clone()  # hits must lie below t_max, then below the best
        best_tri = torch.full((n,), BIG, dtype=torch.long, device=dev)
        occ = torch.zeros(n, dtype=torch.bool, device=dev)
        # the stack holds its entries by depth, shallowest at the bottom, and
        # at most 2 POPS of any one depth: a step that pushes children of
        # depth l has popped every entry of depth l above their parents
        size = 2 * POPS * (self.depth + 1)
        stack = torch.zeros((n, size), dtype=torch.int32, device=dev)
        stack_t = torch.zeros((n, size), dtype=torch.float32, device=dev)
        root_hit, root_tn = self._boxes(torch.zeros(n, dtype=torch.long, device=dev), of, inv,
                                        t_max.float())
        sp = ((t_max > 0) & root_hit).long()
        stack_t[:, 0] = root_tn
        active = sp.nonzero().squeeze(1)
        k, j = torch.arange(LEAF, device=dev), torch.arange(POPS, device=dev)
        while active.numel():
            a = active
            cnt = torch.clamp(sp[a], max=POPS)
            pos = torch.clamp(sp[a, None] - 1 - j, min=0)  # the top POPS entries, top first
            node = stack[a[:, None], pos].long()
            valid = j < cnt[:, None]
            base = sp[a] - cnt
            if not any_hit:  # skip boxes behind the closest hit found since the push
                valid &= stack_t[a[:, None], pos] <= best[a, None].float() * (1 + SLACK)
            leaf = valid & (node >= self.first_leaf)
            # leaves: their triangles
            e, jj = leaf.nonzero(as_tuple=True)
            if e.numel():
                ra = a[e]
                slot = ((node[e, jj] - self.first_leaf)[:, None] * LEAF + k).reshape(-1)
                r = ra[:, None].expand(-1, LEAF).reshape(-1)
                hit, t, _, _ = moller_trumbore(o[r], d[r], self.p0[slot], self.e1[slot],
                                               self.e2[slot])
                hit = hit & (t < t_max[r])
                if any_hit:
                    occ[ra[hit.reshape(-1, LEAF).any(1)]] = True
                else:
                    t = torch.where(hit, t, float("inf")).reshape(-1, LEAF)
                    t_leaf = t.amin(1)
                    tri = torch.where(t == t_leaf[:, None], self.tri_id[slot].reshape(-1, LEAF),
                                      BIG).amin(1)
                    # each ray's least over its leaves of this step, ties to the lowest index
                    t_ray = torch.full_like(best, float("inf")).scatter_reduce(0, ra, t_leaf,
                                                                                "amin")
                    tri_ray = torch.full_like(best_tri, BIG).scatter_reduce(
                        0, ra, torch.where(t_leaf == t_ray[ra], tri, BIG), "amin")
                    t_ray, tri_ray = t_ray[ra], tri_ray[ra]
                    better = (t_ray < best[ra]) | ((t_ray == best[ra]) & (tri_ray < best_tri[ra]))
                    best[ra[better]] = t_ray[better]
                    best_tri[ra[better]] = tri_ray[better]
            # inner nodes: both children's boxes, pushed so that the children of
            # the top entry end on top, the nearer above the farther
            inner = valid & ~leaf
            e, jj = inner.nonzero(as_tuple=True)
            pushes = torch.zeros_like(node)
            if e.numel():
                ra, inode = a[e], node[e, jj]
                lim = (t_max[ra] if any_hit else best[ra]).float()
                c0, c1 = 2 * inode + 1, 2 * inode + 2
                h0, t0 = self._boxes(c0, of[ra], inv[ra], lim)
                h1, t1 = self._boxes(c1, of[ra], inv[ra], lim)
                swap = t1 < t0
                near, far = torch.where(swap, c1, c0), torch.where(swap, c0, c1)
                h_near, h_far = torch.where(swap, h1, h0), torch.where(swap, h0, h1)
                t_near, t_far = torch.where(swap, t1, t0), torch.where(swap, t0, t1)
                pushes[e, jj] = h_far.long() + h_near.long()
                # the deepest popped entry's children go in first
                rev = pushes.flip(1)
                at = (base[:, None] + (rev.cumsum(1) - rev).flip(1))[e, jj]
                for push, child, tc, p in ((h_far, far, t_far, at),
                                           (h_near, near, t_near, at + h_far.long())):
                    stack[ra[push], p[push]] = child[push].int()
                    stack_t[ra[push], p[push]] = tc[push]
            sp[a] = base + pushes.sum(1)
            if any_hit:
                sp[occ] = 0
            active = a[sp[a] > 0]
        return (occ, None) if any_hit else (best, best_tri)

    def _chunks(self, o, d, t_max, any_hit):
        outs = [self._walk(o[i:i + self.ray_chunk], d[i:i + self.ray_chunk],
                           t_max[i:i + self.ray_chunk], any_hit)
                for i in range(0, o.shape[0], self.ray_chunk)]
        if not outs:
            e = torch.zeros(0, device=o.device)
            return e.bool(), e.long()
        return torch.cat([x for x, _ in outs]), (None if any_hit else
                                                 torch.cat([y for _, y in outs]))

    # -- queries ---------------------------------------------------------------
    def closest(self, o, d, t_max):
        """(t, triangle index or -1, u, v) of each ray's closest hit; t is
        t_max on a miss."""
        o, d, t_max = o.to(self.dtype), d.to(self.dtype), t_max.to(self.dtype)
        _, tri = self._chunks(o, d, t_max, False)
        got = tri != BIG
        # the winner again, all rays at once, for its t, u, v (as tracer.py)
        where = torch.zeros_like(tri)
        where[got] = self.slot[tri[got]]
        _, tw, u, v = moller_trumbore(o, d, self.p0[where], self.e1[where], self.e2[where])
        t_out = torch.where(got, tw, t_max)
        return t_out, torch.where(got, tri, -1), torch.where(got, u, 0.0), torch.where(got, v, 0.0)

    def occluded(self, o, d, t_max):
        """True where some triangle lies at 0 < t < t_max."""
        o, d, t_max = o.to(self.dtype), d.to(self.dtype), t_max.to(self.dtype)
        return self._chunks(o, d, t_max, True)[0]
