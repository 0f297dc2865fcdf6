"""Two-phase BVH traversal: an interior-only phase A records per-ray leaf
lists, phase B tests the listed leaves, and rays whose lists overflowed
finish in the one-phase trace.
Counterpart: idkengine_tpu/ops/two_phase.py (`phase_a`, `phase_b_closest`,
`phase_b_any`, `two_phase_closest`, `two_phase_any` and their steered forms).

The TPU package splits traversal so that its triangle tests run on dense
(ray, leaf) pairs instead of whole packets. The port keeps the path and its
contract over the whole-scene binary tree that `SceneArrays.bvh_nodes`
holds: a leaf id is the node index, the same in the threaded arrays and in
`bvh_nodes` (bvh/flatten.py:bvh2_nodes), and a leaf's triangles are
`node_first`/`node_count`. The kernels are `csrc/two_phase.cu` (phase A
replaces the TPU kernels K5a and K5b; phase B, which the JAX package runs
in XLA, is a second kernel, its triangles from `SceneArrays.tri_vec`) and
`csrc/trace.cu` for the fallback.

A CUDA tensor reaches the kernels or the call raises; the plain versions
(`*_plain`) run only for tensors on the CPU and are the kernels' oracles.
"""
from __future__ import annotations

import ctypes
import os

import torch

from ..profiling import call_site
from . import packet_trace as _pt
from ._build import CSRC_DIR, build_shared_library, find_nvcc
from .intersect import ray_aabb, ray_triangle
from .trace import Hit, SceneArrays, inverse_direction

D_SLOTS = 8  # leaf slots per ray (the JAX package's default)
TWO_PHASE_SOURCE = os.path.join(CSRC_DIR, "two_phase.cu")

_lib = None


def build_kernels() -> tuple[str, str]:
    """Compile csrc/two_phase.cu if needed. Returns (library path, compiler
    output with ptxas register and spill counts; empty when current)."""
    return build_shared_library("libidk_two_phase.so", [TWO_PHASE_SOURCE],
                                [find_nvcc(), *_pt.NVCC_FLAGS], headers=(_pt.TRACE_HEADER,))


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_kernels()[0])
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.idk_phase_a_stack_size.restype = ci
        lib.idk_phase_a_stack_size.argtypes = []
        lib.idk_phase_a.restype = ci
        lib.idk_phase_a.argtypes = [vp] * 6 + [ci, ci, vp]
        lib.idk_phase_b_closest.restype = ci
        lib.idk_phase_b_closest.argtypes = [vp] * 11 + [ci, ci, vp]
        lib.idk_phase_b_any.restype = ci
        lib.idk_phase_b_any.argtypes = [vp] * 8 + [ci, ci, vp]
        _lib = lib
    return _lib


def _t_max(o: torch.Tensor, t_max) -> torch.Tensor:
    r = o.shape[0]
    return torch.as_tensor(t_max, dtype=torch.float32, device=o.device).expand(r).contiguous()


def _check_phase_a(scene: SceneArrays, o, d, t_max) -> torch.Tensor:
    """Validate phase A's inputs; returns t_max as an (R,) float32 tensor.
    Raises where the tree is too deep for the kernel's stack."""
    t_max = _pt._check_rays(o, d, t_max)
    _pt._check_tensors(o.device, {"bvh_nodes": (scene.bvh_nodes, torch.int32)})
    if scene.bvh_nodes.dim() != 2 or scene.bvh_nodes.shape[1] != 8:
        raise ValueError("bvh_nodes must be (N,8) int32 records")
    limit = _load().idk_phase_a_stack_size()
    if scene.bvh_depth - 1 > limit:
        raise ValueError(f"BVH depth {scene.bvh_depth} needs a traversal stack of "
                         f"{scene.bvh_depth - 1}; the kernel holds {limit}")
    return t_max


def check_d_slots(d_slots: int):
    """Raises unless D = d_slots list entries a ray is one the two phases
    take: at least one."""
    if d_slots < 1:
        raise ValueError(f"phase B takes at least one list entry a ray, got d_slots={d_slots}")


def _check_phase_b(scene: SceneArrays, lists: torch.Tensor, o, d, t_max) -> torch.Tensor:
    """Validate phase B's inputs, D included, before any launch; returns
    t_max as an (R,) float32 tensor."""
    t_max = _pt._check_rays(o, d, t_max)
    r = o.shape[0]
    if lists.dim() != 2 or lists.shape[0] != r:
        raise ValueError(f"lists must be (R, D) for R={r} rays, got {tuple(lists.shape)}")
    check_d_slots(lists.shape[1])
    i32 = torch.int32
    _pt._check_tensors(o.device, {"lists": (lists, i32), "node_first": (scene.node_first, i32),
                                  "node_count": (scene.node_count, i32)})
    _pt._check_tri_vec(scene, o.device)
    return t_max


def _stream(o: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(o.device).cuda_stream)


# ---------------------------------------------------------------------------
# Plain versions (CPU path and the kernels' oracles)
# ---------------------------------------------------------------------------

def phase_a_plain(scene: SceneArrays, o, d, t_max, d_slots: int = D_SLOTS):
    """Interior-only traversal over the threaded arrays, in DFS order: each
    leaf whose box the ray hits within [0, t_max], under interiors it also
    hits, goes into the ray's list. Returns (lists (R, d_slots) int32 leaf
    node ids | -1, cnt (R,) int32 every wanted leaf, those beyond d_slots
    too)."""
    r = o.shape[0]
    dev = o.device
    t_max = _t_max(o, t_max)
    inv_d = inverse_direction(d)
    lists = torch.full((r, d_slots), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros(r, dtype=torch.int32, device=dev)
    ids = torch.arange(r, device=dev)
    ptr = torch.zeros(r, dtype=torch.int64, device=dev)
    while ids.numel():
        box_hit, _ = ray_aabb(o[ids], inv_d[ids], scene.node_min[ptr],
                              scene.node_max[ptr], t_max[ids])
        leaf = box_hit & (scene.node_count[ptr] > 0)
        rid, at = ids[leaf], cnt[ids[leaf]].long()
        room = at < d_slots
        lists[rid[room], at[room]] = ptr[leaf][room].to(torch.int32)
        cnt[rid] += 1
        nxt = torch.where(box_hit & ~leaf, scene.hit_link[ptr], scene.miss_link[ptr]).long()
        keep = nxt >= 0
        ids, ptr = ids[keep], nxt[keep]
    return lists, cnt


def phase_b_closest_plain(scene: SceneArrays, lists, o, d, t_max,
                          chunk: int = 1 << 17) -> Hit:
    """Closest hit over each ray's listed leaves: Hit with t = t_max and
    slot -1 where none lies closer. Of equal t, the earlier list entry and
    the earlier triangle in the leaf win (the JAX package's argmin rule).
    Works on `chunk` rays at a time to bound the gathered triangles."""
    r, n_slots = lists.shape
    t_max = _t_max(o, t_max)
    ks = torch.arange(scene.max_leaf, device=o.device)
    parts = []
    for lo in range(0, r, chunk):
        sl = slice(lo, min(lo + chunk, r))
        ls = lists[sl].long()
        valid = ls >= 0
        leaf = torch.clamp(ls, min=0)
        first = scene.node_first[leaf].long()  # (rc, D)
        count = torch.where(valid, scene.node_count[leaf], 0)
        ok = ks[None, None, :] < count[..., None]  # (rc, D, K)
        tid = torch.where(ok, first[..., None] + ks[None, None, :], 0)
        h, t, u, v = ray_triangle(o[sl, None, None, :], d[sl, None, None, :],
                                  scene.tri_p0[tid], scene.tri_e1[tid], scene.tri_e2[tid])
        rc = ls.shape[0]
        t = torch.where(ok & h, t, float("inf")).reshape(rc, -1)
        t_min, k_min = t.min(dim=1)  # the first of equal minima: list order
        closer = t_min < t_max[sl]
        kc = k_min[:, None]
        parts.append((torch.where(closer, t_min, t_max[sl]),
                      torch.where(closer, tid.reshape(rc, -1).gather(1, kc)[:, 0], -1),
                      torch.where(closer, u.reshape(rc, -1).gather(1, kc)[:, 0], 0.0),
                      torch.where(closer, v.reshape(rc, -1).gather(1, kc)[:, 0], 0.0)))
    if not parts:  # no rays
        parts = [(torch.zeros(0, device=o.device),) * 4]
    t, slot, u, v = (torch.cat(k) for k in zip(*parts))
    return Hit(t=t, slot=slot.to(torch.int32), u=u, v=v)


def phase_b_any_plain(scene: SceneArrays, lists, o, d, t_max) -> torch.Tensor:
    """Occlusion over each ray's listed leaves: True where one of their
    triangles lies at 0 < t < t_max."""
    return phase_b_closest_plain(scene, lists, o, d, t_max).slot >= 0


# ---------------------------------------------------------------------------
# Entry points: the kernels for CUDA tensors, the plain versions on the CPU
# ---------------------------------------------------------------------------

def phase_a(scene: SceneArrays, o: torch.Tensor, d: torch.Tensor, t_max,
            d_slots: int = D_SLOTS) -> tuple[torch.Tensor, torch.Tensor]:
    """(lists (R, d_slots) int32 leaf node ids | -1, cnt (R,) int32 wanted
    leaves; cnt > d_slots means the list overflowed). t_max < 0 marks a dead
    ray (cnt 0)."""
    if _pt._on_cpu(scene, o, d):
        return phase_a_plain(scene, o, d, t_max, d_slots)
    t_max = _check_phase_a(scene, o, d, t_max)
    if d_slots < 1:
        raise ValueError(f"d_slots must be positive, got {d_slots}")
    r = o.shape[0]
    lists = torch.empty((r, d_slots), dtype=torch.int32, device=o.device)
    cnt = torch.empty(r, dtype=torch.int32, device=o.device)
    if r:
        err = _load().idk_phase_a(_pt._ptr(scene.bvh_nodes), _pt._ptr(o), _pt._ptr(d),
                                  _pt._ptr(t_max), _pt._ptr(lists), _pt._ptr(cnt),
                                  d_slots, r, _stream(o))
        _pt._raise_on(err, "phase_a")
        phase_a.launches += 1
    return lists, cnt


def phase_b_closest(scene: SceneArrays, lists: torch.Tensor, o: torch.Tensor,
                    d: torch.Tensor, t_max) -> Hit:
    """Closest hit over each ray's listed leaves (see phase_b_closest_plain).
    D = lists.shape[1] must be at least 1, on either device."""
    if _pt._on_cpu(scene, o, d):
        check_d_slots(lists.shape[1])
        return phase_b_closest_plain(scene, lists, o, d, t_max)
    t_max = _check_phase_b(scene, lists, o, d, t_max)
    r = o.shape[0]
    t = torch.empty(r, dtype=torch.float32, device=o.device)
    slot = torch.empty(r, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if r:
        err = _load().idk_phase_b_closest(
            _pt._ptr(scene.node_first), _pt._ptr(scene.node_count), _pt._ptr(scene.tri_vec),
            _pt._ptr(lists), _pt._ptr(o), _pt._ptr(d), _pt._ptr(t_max), _pt._ptr(t),
            _pt._ptr(slot), _pt._ptr(u), _pt._ptr(v), lists.shape[1], r, _stream(o))
        _pt._raise_on(err, "phase_b_closest")
        phase_b_closest.launches += 1
    return Hit(t=t, slot=slot, u=u, v=v)


def phase_b_any(scene: SceneArrays, lists: torch.Tensor, o: torch.Tensor,
                d: torch.Tensor, t_max) -> torch.Tensor:
    """Occlusion over each ray's listed leaves, bool (R,); D as in
    phase_b_closest."""
    if _pt._on_cpu(scene, o, d):
        check_d_slots(lists.shape[1])
        return phase_b_any_plain(scene, lists, o, d, t_max)
    t_max = _check_phase_b(scene, lists, o, d, t_max)
    r = o.shape[0]
    occ = torch.empty(r, dtype=torch.bool, device=o.device)
    if r:
        err = _load().idk_phase_b_any(
            _pt._ptr(scene.node_first), _pt._ptr(scene.node_count), _pt._ptr(scene.tri_vec),
            _pt._ptr(lists), _pt._ptr(o), _pt._ptr(d), _pt._ptr(t_max), _pt._ptr(occ),
            lists.shape[1], r, _stream(o))
        _pt._raise_on(err, "phase_b_any")
        phase_b_any.launches += 1
    return occ


def two_phase_closest(scene: SceneArrays, o: torch.Tensor, d: torch.Tensor, t_max,
                      d_slots: int = D_SLOTS, tag: str = "") -> Hit:
    """Exact closest hit: phase A, phase B, then one one-phase trace for the
    rays whose lists overflowed, pruned by their phase-B t (the others carry
    t_max = -1 and leave at once). t is t_max on a miss. tag: the call
    site's, as packet_trace.trace_closest's: every launch runs in its
    range."""
    check_d_slots(d_slots)
    with call_site(False, tag):
        t_max = _t_max(o, t_max)
        lists, cnt = phase_a(scene, o, d, t_max, d_slots)
        hit = phase_b_closest(scene, lists, o, d, t_max)
        over = cnt > d_slots
        tm2 = torch.where(over & (t_max > 0.0), torch.minimum(hit.t, t_max), -1.0)
        h2 = _pt.trace_closest(scene, o, d, tm2, tag=tag)
    closer = h2.slot >= 0
    slot = torch.where(closer, h2.slot, hit.slot)
    return Hit(t=torch.where(slot >= 0, torch.where(closer, h2.t, hit.t), t_max), slot=slot,
               u=torch.where(closer, h2.u, hit.u), v=torch.where(closer, h2.v, hit.v))


def two_phase_any(scene: SceneArrays, o: torch.Tensor, d: torch.Tensor, t_max,
                  d_slots: int = D_SLOTS, tag: str = "") -> torch.Tensor:
    """Occlusion: phase A, phase B, then one one-phase any-hit trace for the
    rays whose lists overflowed and found no occluder; tag as in
    two_phase_closest."""
    check_d_slots(d_slots)
    with call_site(True, tag):
        t_max = _t_max(o, t_max)
        lists, cnt = phase_a(scene, o, d, t_max, d_slots)
        occ = phase_b_any(scene, lists, o, d, t_max)
        unresolved = (cnt > d_slots) & ~occ & (t_max > 0.0)
        return occ | _pt.trace_any(scene, o, d, torch.where(unresolved, t_max, -1.0), tag=tag)


# launch counts: each wrapper adds one where it launches its kernel
phase_a.launches = 0
phase_b_closest.launches = 0
phase_b_any.launches = 0


def reset_launch_counts():
    phase_a.launches = 0
    phase_b_closest.launches = 0
    phase_b_any.launches = 0
