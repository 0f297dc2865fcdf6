"""Scene arrays and the plain stackless BVH traversal. Counterpart: idkengine_tpu/ops/trace.py.

`trace_closest`/`trace_any` walk the threaded (stackless) flat BVH exactly
as the JAX package does (ref: BVHIntersect.glsl TraceRay/TraceRayAny): every
ray carries one DFS pointer; each step slab-tests the pointed node, tests up
to `max_leaf` triangles of a leaf, and follows the hit or miss link. They
are the port's CPU trace and the plain versions of the CUDA kernel in
`ops/packet_trace.py`, which computes the same hits with a per-ray stack;
with `max_steps` they stop each ray after that many steps, as the JAX
package's traces do, and are the plain versions of the capped kernels.
`trace_closest_two_level`/`trace_any_two_level` trace the static scene and
then each instance of an `InstanceSet` in its own space, as the JAX
package's two-level traces do; `two_level_closest`/`two_level_any` hold
that loop for any trace function, so the card's two-level traces in
`ops/packet_trace.py` are the same loop over the kernels.

Two changes of form, none of result: rays that finished are compacted out
after every step, and a leaf's triangles are tested as one batch, keeping
the first of the nearest hits below the current best, which is what the
JAX package's sequential strict-less loop keeps.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..bvh.flatten import FlatBvh, FlatTriangles, bvh2_nodes, bvh4_nodes, leaf_bits, thread_nodes
from .intersect import INF, fma, ray_aabb, ray_triangle

DEFAULT_MAX_LEAF = 4  # default for bvh.BuildSettings.max_leaf_triangle_count

# fields of the JAX package's SceneArrays, in its order
JAX_FIELDS = ("node_min", "node_max", "node_first", "node_count", "hit_link",
              "miss_link", "tri_p0", "tri_e1", "tri_e2", "tri_n", "tri_uv",
              "tri_mat", "tri_gn")


@dataclass
class SceneArrays:
    """Device-resident flattened scene (single merged BLAS).

    The threaded arrays serve the plain trace; `bvh_thread` holds them as
    the steps kernel's 32-byte records (bvh/flatten.py:thread_nodes) and
    `bvh_nodes` as phase A's binary records (bvh/flatten.py:bvh2_nodes);
    `bvh4_nodes` is the tree collapsed into the trace kernel's 4-wide
    layout (bvh/flatten.py:bvh4_nodes), `bvh4_child` the binary node each
    wide child copies (what a refit of the wide records gathers from),
    `bvh4_leaf_bits` the split of the leaf references of both the wide and
    the threaded records (bvh/flatten.py:leaf_bits), and `tri_vec` the
    triangles as the kernels load them (three float4s a slot)."""

    node_min: torch.Tensor  # (N,3) f32
    node_max: torch.Tensor  # (N,3) f32
    node_first: torch.Tensor  # (N,) i32
    node_count: torch.Tensor  # (N,) i32
    hit_link: torch.Tensor  # (N,) i32
    miss_link: torch.Tensor  # (N,) i32
    tri_p0: torch.Tensor  # (T,3) f32
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_n: torch.Tensor  # (T,3) i64 holding uint32 octahedral corner normals
    tri_uv: torch.Tensor  # (T,3,2) f32
    tri_mat: torch.Tensor  # (T,) i32
    tri_gn: torch.Tensor  # (T,3) f32 face normal
    bvh_nodes: torch.Tensor  # (N,8) i32 phase A's binary node records
    bvh_depth: int  # tree depth, root = 1
    bvh_thread: torch.Tensor  # (N,8) i32 steps kernel's threaded records
    bvh4_nodes: torch.Tensor  # (M,32) i32 trace kernel's 4-wide records
    bvh4_depth: int  # wide tree depth in records, root = 1
    bvh4_child: torch.Tensor  # (M,4) i32 binary node of each wide child, -1 empty
    bvh4_leaf_bits: int  # count bits of a leaf reference (bvh/flatten.py:leaf_bits)
    tri_vec: torch.Tensor  # (T,12) f32 p0 | e1 | e2 | pad, the kernels' leaf loads
    max_leaf: int = DEFAULT_MAX_LEAF
    bvh4_build_ms: float = 0.0  # host time of bvh4_nodes
    thread_build_ms: float = 0.0  # host time of thread_nodes

    @property
    def device(self) -> torch.device:
        return self.tri_p0.device

    @staticmethod
    def from_flat(flat_bvh: FlatBvh, flat_tris: FlatTriangles, max_leaf: int,
                  device) -> "SceneArrays":
        return from_jax_scene_arrays({
            "node_min": flat_bvh.node_min, "node_max": flat_bvh.node_max,
            "node_first": flat_bvh.node_first, "node_count": flat_bvh.node_count,
            "hit_link": flat_bvh.hit_link, "miss_link": flat_bvh.miss_link,
            "tri_p0": flat_tris.p0, "tri_e1": flat_tris.e1, "tri_e2": flat_tris.e2,
            "tri_n": flat_tris.n_packed, "tri_uv": flat_tris.uv,
            "tri_mat": flat_tris.mat, "tri_gn": flat_tris.geom_normal,
        }, max_leaf, device)


_TORCH_DTYPES = {np.float32: torch.float32, np.int32: torch.int32, np.int64: torch.int64}


def from_jax_scene_arrays(arrays: dict, max_leaf: int, device) -> SceneArrays:
    """The port's SceneArrays from the JAX package's SceneArrays fields
    (JAX_FIELDS) given as numpy arrays; `max_leaf` is its static leaf size.
    A field given as a tensor (the triangles of bvh/flatten.py's
    flatten_triangles_device) is taken on `device` as it is, with no host
    round trip; the node tables are built on the host from the numpy node
    arrays."""
    a = {k: arrays[k] if isinstance(arrays[k], torch.Tensor) else np.asarray(arrays[k])
         for k in JAX_FIELDS}
    nodes, depth = bvh2_nodes(a["node_min"], a["node_max"], a["node_first"],
                              a["node_count"], a["miss_link"])
    bits = leaf_bits(a["node_count"])
    t0 = time.perf_counter()
    wide, wide_depth, child = bvh4_nodes(a["node_min"], a["node_max"], a["node_first"],
                                         a["node_count"], a["miss_link"], bits)
    wide_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    threaded = thread_nodes(a["node_min"], a["node_max"], a["node_first"], a["node_count"],
                            a["miss_link"], bits)
    thread_ms = (time.perf_counter() - t0) * 1e3
    dtypes = {"node_first": np.int32, "node_count": np.int32, "hit_link": np.int32,
              "miss_link": np.int32, "tri_n": np.int64, "tri_mat": np.int32}

    def put(x, dtype=np.float32):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=_TORCH_DTYPES[dtype]).contiguous()
        # a copy: the caller's arrays may be read-only views of JAX buffers
        return torch.from_numpy(np.array(x, dtype)).to(device)

    fields = {k: put(a[k], dtypes.get(k, np.float32)) for k in JAX_FIELDS}
    tri = [fields[k].reshape(-1, 3) for k in ("tri_p0", "tri_e1", "tri_e2")]
    tri_vec = torch.cat([*tri, torch.zeros_like(tri[0])], dim=1)
    return SceneArrays(
        **fields,
        bvh_nodes=put(nodes, np.int32), bvh_depth=depth, bvh_thread=put(threaded, np.int32),
        bvh4_nodes=put(wide, np.int32), bvh4_depth=wide_depth, bvh4_child=put(child, np.int32),
        bvh4_leaf_bits=bits, tri_vec=tri_vec, max_leaf=int(max_leaf),
        bvh4_build_ms=wide_ms, thread_build_ms=thread_ms)


class Hit(NamedTuple):
    """SoA hit record for a ray batch."""

    t: torch.Tensor  # (R,) f32; >= t_max => miss
    slot: torch.Tensor  # (R,) i32 triangle slot, -1 = miss
    u: torch.Tensor  # (R,) f32 barycentric
    v: torch.Tensor  # (R,) f32


def inverse_direction(d: torch.Tensor) -> torch.Tensor:
    """1/d with |d| clamped to at least 1e-20, sign kept (d == -0 counts as +)."""
    tiny = torch.full_like(d, 1e-20)
    return 1.0 / torch.where(d.abs() < 1e-20, torch.where(d < 0, -tiny, tiny), d)


def _traverse(scene: SceneArrays, o, d, t_max, any_hit: bool,
              steps: torch.Tensor | None = None, max_steps: int | None = None,
              visited: tuple[torch.Tensor, torch.Tensor] | None = None,
              leaf_trips: torch.Tensor | None = None) -> Hit:
    """The stackless walk; where `steps` (R,) int32 is given, each ray's
    count of steps with its pointer >= 0 is added to it. With `max_steps`
    every ray stops after that many steps, as the JAX package's while_loop
    does at `step < max_steps`. Where `visited` (a bool (N,) over the
    records and a bool (T,) over the triangles) is given, every record a
    ray steps on and every triangle it tests is marked. Where `leaf_trips`
    (an int64 (1,)) is given, the leaf trips of warps of 32 rays in launch
    order that walk in lockstep, a ray a lane, are added to it: at each
    step, for each warp, the most triangles any of its rays tests there (an
    any-hit ray stops at its first occluder)."""
    r = o.shape[0]
    dev = o.device
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(r).contiguous()
    inv_d = inverse_direction(d)
    t_best = t_max.clone()
    slot = torch.full((r,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(r, device=dev)
    v = torch.zeros(r, device=dev)
    ks = torch.arange(scene.max_leaf, device=dev)
    ids = torch.arange(r, device=dev)  # rays still traversing
    ptr = torch.zeros(r, dtype=torch.int64, device=dev)  # their DFS pointers
    step = 0
    while ids.numel() and (max_steps is None or step < max_steps):
        step += 1
        if steps is not None:
            steps[ids] += 1
        if visited is not None:
            visited[0][ptr] = True
        box_hit, _ = ray_aabb(o[ids], inv_d[ids], scene.node_min[ptr],
                              scene.node_max[ptr], t_best[ids])
        count = scene.node_count[ptr]
        leaf = (box_hit & (count > 0)).nonzero().squeeze(1)
        if leaf_trips is not None:
            tested = torch.zeros(ids.numel(), dtype=torch.int64, device=dev)
        if leaf.numel():
            rid = ids[leaf]
            first = scene.node_first[ptr[leaf]].long()
            valid = ks[None, :] < count[leaf, None]
            tid = torch.where(valid, first[:, None] + ks[None, :], 0)
            if visited is not None:
                visited[1][tid[valid]] = True
            h, t, uu, vv = ray_triangle(o[rid, None, :], d[rid, None, :],
                                        scene.tri_p0[tid], scene.tri_e1[tid],
                                        scene.tri_e2[tid])
            if leaf_trips is not None:
                occluder = valid & h & (t < t_best[rid, None])
                first_occ = torch.where(occluder, ks[None, :], scene.max_leaf).amin(1)
                tested[leaf] = (torch.minimum(first_occ + 1, count[leaf].long()) if any_hit
                                else count[leaf].long())
            t_min, k_min = torch.where(valid & h, t, float("inf")).min(dim=1)
            closer = t_min < t_best[rid]
            rc, kc = rid[closer], k_min[closer, None]
            t_best[rc] = t_min[closer]
            slot[rc] = (first[closer] + k_min[closer]).to(torch.int32)
            u[rc] = uu[closer].gather(1, kc).squeeze(1)
            v[rc] = vv[closer].gather(1, kc).squeeze(1)
        if leaf_trips is not None:
            warp = ids // 32
            most = torch.zeros(int(warp[-1]) + 1, dtype=torch.int64, device=dev)
            most.scatter_reduce_(0, warp, tested, "amax")
            leaf_trips += most.sum()
        nxt = torch.where(box_hit & (count == 0), scene.hit_link[ptr],
                          scene.miss_link[ptr]).long()
        if any_hit:
            # stop rays that already found an occluder closer than t_max
            nxt = torch.where(t_best[ids] < t_max[ids], -1, nxt)
        keep = nxt >= 0
        ids, ptr = ids[keep], nxt[keep]
    return Hit(t=t_best, slot=slot, u=u, v=v)


def trace_closest(scene: SceneArrays, o, d, t_max=INF, max_steps: int | None = None) -> Hit:
    """Closest-hit trace for a ray batch. o/d: (R,3); t_max: (R,) or scalar;
    max_steps: at most that many steps a ray (the JAX package's cap), or
    None for none.

    ref: BVHIntersect.glsl TraceRay — re-expressed stackless."""
    return _traverse(scene, o, d, t_max, False, max_steps=max_steps)


def trace_closest_steps(scene: SceneArrays, o, d, t_max=INF,
                        max_steps: int = 1 << 30) -> tuple[Hit, torch.Tensor]:
    """trace_closest plus each ray's traversal steps, (R,) int32: the
    iterations it spends with its pointer >= 0, at most max_steps (the JAX
    package's cap and default; the debug-statistics path, ref: BLAS.cs
    DebugStatistics + the BVH-cost heatmap)."""
    steps = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)
    return _traverse(scene, o, d, t_max, False, steps, max_steps=max_steps), steps


def trace_any(scene: SceneArrays, o, d, t_max, max_steps: int | None = None) -> torch.Tensor:
    """Any-hit (occlusion) trace: bool (R,) 'occluded before t_max';
    max_steps as in trace_closest.

    ref: BVHIntersect.glsl TraceRayAny."""
    return _traverse(scene, o, d, t_max, True, max_steps=max_steps).slot >= 0


@dataclass
class InstanceSet:
    """Instanced content for two-level tracing: per-instance local-space
    scene arrays (shared between the instances of one model), world->local
    affines, world boxes, slot offsets (so hit slots index one combined
    attribute table) and normal matrices for shading."""

    scenes: list  # of SceneArrays, one per instance
    inv: torch.Tensor  # (I,3,4) world->local
    boxes: torch.Tensor  # (I,2,3) world AABBs
    slot_off: torch.Tensor  # (I,) int32 slot offset into the combined table
    normal_mat: torch.Tensor  # (I,3,3) inverse-transpose rotations


def instance_set_from_jax(scenes: list, max_leaf: int, inv, boxes, slot_off, normal_mat,
                          device) -> InstanceSet:
    """The port's InstanceSet from the JAX package's, given as numpy arrays:
    `scenes` one dict of SceneArrays fields (JAX_FIELDS) an instance, the
    same dict object for instances that share a model's arrays (they then
    share one SceneArrays here too)."""
    made: dict[int, SceneArrays] = {}
    for a in scenes:
        if id(a) not in made:
            made[id(a)] = from_jax_scene_arrays(a, max_leaf, device)

    def put(x, dtype):
        return torch.from_numpy(np.array(x, dtype)).to(device)

    return InstanceSet(scenes=[made[id(a)] for a in scenes], inv=put(inv, np.float32),
                       boxes=put(boxes, np.float32), slot_off=put(slot_off, np.int32),
                       normal_mat=put(normal_mat, np.float32))


def linear_map(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x @ m.T of (R,3) rows and a (3,3) matrix (or (R,3,3), a matrix a
    row), as XLA:CPU rounds the JAX package's jitted product: each
    component fma(x2, m[.,2], fma(x1, m[.,1], x0 * m[.,0]))."""
    if m.dim() == 2:
        m = m[None]
    return fma(x[:, 2:3], m[:, :, 2], fma(x[:, 1:2], m[:, :, 1], x[:, 0:1] * m[:, :, 0]))


def to_instance(inv: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """World rays into an instance's space through its (3,4) world->local
    affine: (o @ inv[:, :3].T + inv[:, 3], d @ inv[:, :3].T), rounded as
    the JAX package's two-level traces round them; directions stay
    unnormalized, so t stays world-space."""
    m = inv[:, :3]
    return (linear_map(m, o) + inv[:, 3]).contiguous(), linear_map(m, d).contiguous()


def _box_prune(box: torch.Tensor, o, d, best_t) -> torch.Tensor:
    """The rays that must enter an instance: its world box (2,3) is hit
    nearer than the best hit so far, by the JAX package's slab test (it
    divides by the clamped direction), and the ray is alive."""
    tiny = torch.full_like(d, 1e-20)
    dn = torch.where(d.abs() < 1e-20, torch.where(d < 0, -tiny, tiny), d)
    t0 = (box[0] - o) / dn
    t1 = (box[1] - o) / dn
    tn = torch.clamp(torch.minimum(t0, t1).amax(dim=-1), min=0.0)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    return (tf >= tn) & (tn < best_t) & (best_t > 0)


def two_level_closest(closest, static_scene: SceneArrays, inst_scenes, inst_inv, inst_boxes,
                      o, d, t_max, slot_off=None, max_steps: int | None = None):
    """The two-level closest-hit loop over a trace function `closest`
    (scene, o, d, t_max, max_steps=...) -> Hit: the static scene, then each
    instance whose box the ray must enter, with its t_max the best hit so
    far (-1, a dead ray, elsewhere). Returns (Hit, inst_id): slot indexes
    the owning arrays plus the instance's slot offset, inst_id -1 for a
    static hit or a miss."""
    r = o.shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device).expand(r).contiguous()
    best = closest(static_scene, o, d, t_max, max_steps=max_steps)
    inst_id = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    for i, scene_i in enumerate(inst_scenes):
        lo, ld = to_instance(inst_inv[i], o, d)
        tm_i = torch.where(_box_prune(inst_boxes[i], o, d, best.t), best.t, -1.0)
        h = closest(scene_i, lo, ld, tm_i, max_steps=max_steps)
        closer = h.slot >= 0  # t < tm_i: the kernel's hit test is strict
        off = 0 if slot_off is None else slot_off[i]
        best = Hit(t=torch.where(closer, h.t, best.t),
                   slot=torch.where(closer, h.slot + off, best.slot),
                   u=torch.where(closer, h.u, best.u), v=torch.where(closer, h.v, best.v))
        inst_id = torch.where(closer, i, inst_id)
    return best, inst_id


def two_level_any(occluded, static_scene: SceneArrays, inst_scenes, inst_inv, o, d, t_max,
                  max_steps: int | None = None) -> torch.Tensor:
    """The two-level occlusion loop over a trace function `occluded`: the
    static scene, then each instance for the rays not yet occluded (no box
    prune, as in the JAX package)."""
    r = o.shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device).expand(r).contiguous()
    occ = occluded(static_scene, o, d, t_max, max_steps=max_steps)
    for i, scene_i in enumerate(inst_scenes):
        lo, ld = to_instance(inst_inv[i], o, d)
        occ = occ | occluded(scene_i, lo, ld, torch.where(occ, -1.0, t_max),
                             max_steps=max_steps)
    return occ


def trace_closest_two_level(static_scene: SceneArrays, inst_scenes, inst_inv, inst_boxes,
                            o, d, t_max, slot_off=None, max_steps: int | None = None):
    """Two-level closest-hit trace, plain: merged static BLAS + per-instance
    BLASes through world->local ray transforms (ref: TLAS.cs traversal
    entering BLASes through instance inverse transforms). inst_scenes: one
    SceneArrays an instance (local space); inst_inv (I,3,4); inst_boxes
    (I,2,3) world AABBs. Returns (Hit, inst_id) as two_level_closest."""
    return two_level_closest(trace_closest, static_scene, inst_scenes, inst_inv, inst_boxes,
                             o, d, t_max, slot_off, max_steps)


def trace_any_two_level(static_scene: SceneArrays, inst_scenes, inst_inv, inst_boxes, o, d,
                        t_max, max_steps: int | None = None) -> torch.Tensor:
    """Occlusion over static + instanced content, plain (inst_boxes is not
    used: the JAX package prunes nothing here)."""
    del inst_boxes
    return two_level_any(trace_any, static_scene, inst_scenes, inst_inv, o, d, t_max,
                         max_steps)
