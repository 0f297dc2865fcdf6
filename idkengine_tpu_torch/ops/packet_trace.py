"""Trace entry points: the CUDA traversal kernel for tensors on the card, the
plain stackless trace for tensors on the CPU.
Counterpart: idkengine_tpu/ops/packet_trace.py (the Pallas packet tracer).

`trace_closest`/`trace_any` answer what the JAX package's whole-table
(`packet_trace_closest/any`) and segmented (`packet_trace_*_steered`, loop or
unrolled) entry points answer, over one whole-scene BVH: the kernel
`csrc/trace.cu` (a 4-wide tree, `SceneArrays.bvh4_nodes`) replaces the three
TPU kernels K1, K2 and K4 (see its header). `trace_closest_steps` adds
per-ray traversal steps for the debug heatmap (K1 with `debug_iters`), over
the threaded records `SceneArrays.bvh_thread`. With `max_steps`,
`trace_closest` and `trace_any` stop each ray after that many steps of the
stackless binary walk, as the JAX package's XLA traces do
(`idkengine_tpu/ops/trace.py:122, 279`): on the card through the capped
kernels over the same threaded records, launched by `_closest_capped` and
`_any_capped`, whose counts are their own. `trace_closest_two_level` and
`trace_any_two_level` are the JAX package's two-level traces
(`idkengine_tpu/ops/trace.py:177, 227`) over these wrappers: one launch
for the static scene and one an instance, each counted by the wrapper
that makes it and by the two-level function. Each entry point but the
steps trace takes the JAX package's call-site `tag` (`pri`, `bnc`, `nee`,
`env`, an `a` after it for the alpha rounds, `spmd`) and launches inside
the profiler range that its Pallas kernel's name would carry
(profiling.call_site), which profiling.capture_device_profile buckets as
the JAX package buckets that kernel. `trace_closest_steps` takes the JAX
trace's `max_steps` too. The kernels are compiled
with nvcc on first use into `build/` and bound with ctypes. A CUDA tensor
reaches the kernel or the call raises; the plain version runs only for
tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import os
from functools import partial

import torch

from ..profiling import call_site
from . import trace as _plain
from ._build import CSRC_DIR, build_shared_library, find_nvcc
from .trace import Hit, SceneArrays

TRACE_SOURCE = os.path.join(CSRC_DIR, "trace.cu")
TRACE_HEADER = os.path.join(CSRC_DIR, "trace_math.cuh")  # shared with two_phase.cu
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the trace kernel's stack entries a ray: csrc/trace.cu idk_trace_stack_limit()
WIDE_STACK_LIMIT = 96

_lib = None


def build_kernels() -> tuple[str, str]:
    """Compile csrc/trace.cu if needed. Returns (library path, compiler
    output with ptxas register and spill counts; empty when current)."""
    return build_shared_library("libidk_trace.so", [TRACE_SOURCE],
                                [find_nvcc(), *NVCC_FLAGS], headers=(TRACE_HEADER,))


def bind_library(path: str) -> ctypes.CDLL:
    """Load a library built from csrc/trace.cu and declare its entry points."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.idk_trace_interface, lib.idk_trace_stack_limit, lib.idk_trace_shared_bytes):
        fn.restype = ci
        fn.argtypes = []
    lib.idk_trace_closest.restype = ci
    lib.idk_trace_closest.argtypes = [vp] * 10 + [ci, ci, ci, vp]
    lib.idk_trace_any.restype = ci
    lib.idk_trace_any.argtypes = [vp] * 7 + [ci, ci, ci, vp]
    lib.idk_trace_closest_steps.restype = ci
    lib.idk_trace_closest_steps.argtypes = [vp] * 10 + [ci, ci, vp]
    if hasattr(lib, "idk_trace_closest_steps_capped"):  # interface 5 on
        lib.idk_trace_closest_steps_capped.restype = ci
        lib.idk_trace_closest_steps_capped.argtypes = [vp] * 10 + [ci, ci, ci, vp]
    if hasattr(lib, "idk_trace_closest_capped"):  # interface 4 on
        lib.idk_trace_closest_capped.restype = ci
        lib.idk_trace_closest_capped.argtypes = [vp] * 9 + [ci, ci, ci, vp]
        lib.idk_trace_any_capped.restype = ci
        lib.idk_trace_any_capped.argtypes = [vp] * 6 + [ci, ci, ci, vp]
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = bind_library(build_kernels()[0])
        if lib.idk_trace_stack_limit() != WIDE_STACK_LIMIT:
            raise RuntimeError(f"{TRACE_SOURCE} holds {lib.idk_trace_stack_limit()} stack "
                               f"entries a ray, the wrapper expects {WIDE_STACK_LIMIT}")
        if lib.idk_trace_interface() < 5:
            raise RuntimeError(f"{TRACE_SOURCE} has no capped steps kernel (interface "
                               f"{lib.idk_trace_interface()})")
        _lib = lib
    return _lib


def _check_tensors(dev, tensors: dict):
    """Each named tensor (x, dtype) on `dev`, contiguous, of its dtype."""
    for name, (x, want) in tensors.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the rays on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.dtype != want:
            raise TypeError(f"{name} must be {want}, got {x.dtype}")


def _check_rays(o, d, t_max) -> torch.Tensor:
    """Validate the rays; returns t_max as an (R,) float32 tensor."""
    r = o.shape[0]
    if o.shape != (r, 3) or d.shape != (r, 3):
        raise ValueError(f"o and d must be (R,3), got {tuple(o.shape)} and {tuple(d.shape)}")
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device).expand(r).contiguous()
    f32 = torch.float32
    _check_tensors(o.device, {"o": (o, f32), "d": (d, f32), "t_max": (t_max, f32)})
    return t_max


def wide_stack_entries(scene: SceneArrays) -> int:
    """The trace kernel's stack depth for the scene's wide tree: a record
    pushes at most 3 of its 4 children, so 3 entries per record level.
    Raises where the kernel's stack (WIDE_STACK_LIMIT entries) is smaller."""
    entries = 3 * scene.bvh4_depth
    if entries > WIDE_STACK_LIMIT:
        raise ValueError(
            f"wide BVH depth {scene.bvh4_depth} needs a traversal stack of {entries} "
            f"entries; the kernel holds {WIDE_STACK_LIMIT}")
    return entries


def _check_tri_vec(scene: SceneArrays, dev):
    _check_tensors(dev, {"tri_vec": (scene.tri_vec, torch.float32)})
    if scene.tri_vec.shape != (scene.tri_p0.shape[0], 12) or scene.tri_vec.data_ptr() % 16:
        raise ValueError("tri_vec must be (T,12) float32, 16-byte aligned")
    if not 5 <= scene.bvh4_leaf_bits <= 30:
        raise ValueError(f"bvh4_leaf_bits must lie in 5..30, got {scene.bvh4_leaf_bits}")


def _check_wide(scene: SceneArrays, o, d, t_max) -> tuple[torch.Tensor, int]:
    """Validate the trace kernel's inputs; returns (t_max as an (R,) float32
    tensor, stack entries). Raises where the wide tree is too deep for the
    kernel's stack."""
    t_max = _check_rays(o, d, t_max)
    _check_tensors(o.device, {"bvh4_nodes": (scene.bvh4_nodes, torch.int32)})
    w = scene.bvh4_nodes
    if w.dim() != 2 or w.shape[1] != 32 or w.shape[0] < 1 or w.data_ptr() % 128:
        raise ValueError("bvh4_nodes must be (M,32) int32 records, 128-byte aligned")
    _check_tri_vec(scene, o.device)
    return t_max, wide_stack_entries(scene)


def _check_thread(scene: SceneArrays, o, d, t_max) -> torch.Tensor:
    """Validate the steps kernel's inputs; returns t_max as an (R,) float32
    tensor."""
    t_max = _check_rays(o, d, t_max)
    _check_tensors(o.device, {"bvh_thread": (scene.bvh_thread, torch.int32)})
    n = scene.bvh_thread
    if n.dim() != 2 or n.shape[1] != 8 or n.shape[0] < 1 or n.data_ptr() % 32:
        raise ValueError("bvh_thread must be (N,8) int32 records, 32-byte aligned")
    _check_tri_vec(scene, o.device)
    return t_max


def _on_cpu(scene: SceneArrays, o: torch.Tensor, d: torch.Tensor) -> bool:
    """True when the call takes the plain version: everything on the CPU.
    CUDA tensors go to the kernel; any other device, or a mix, raises."""
    devs = {o.device, d.device, scene.device}
    if len(devs) != 1:
        raise ValueError(f"scene and rays must share one device, got {sorted(map(str, devs))}")
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no trace kernel for device {o.device}")
    return o.device.type == "cpu"


def _ptr(x: torch.Tensor):
    return ctypes.c_void_p(x.data_ptr())


def _wide_tables(scene: SceneArrays) -> tuple:
    return _ptr(scene.bvh4_nodes), _ptr(scene.tri_vec)


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _check_cap(max_steps):
    if max_steps is not None and not 0 <= max_steps < 2 ** 31:
        raise ValueError(f"max_steps must lie in 0..2**31-1, got {max_steps}")


def trace_closest(scene: SceneArrays, o: torch.Tensor, d: torch.Tensor, t_max,
                  max_steps: int | None = None, tag: str = "") -> Hit:
    """Closest hit per ray: Hit(t, slot, u, v); slot -1 and t = t_max on a
    miss; t_max < 0 marks a dead ray. o/d: (R,3) f32; t_max: (R,) or scalar.
    max_steps: stop each ray after that many steps of the stackless binary
    walk (the capped kernel), or None for no cap (the trace kernel). tag:
    the call site's, as the JAX package's (pri, bnc, ...): the launch runs
    in the profiler range profiling.call_site_name(False, tag)."""
    _check_cap(max_steps)
    with call_site(False, tag):
        if _on_cpu(scene, o, d):
            return _plain.trace_closest(scene, o, d, t_max, max_steps=max_steps)
        if max_steps is not None:
            return _closest_capped(scene, o, d, t_max, max_steps)
        t_max, entries = _check_wide(scene, o, d, t_max)
        r = o.shape[0]
        t = torch.empty(r, dtype=torch.float32, device=o.device)
        slot = torch.empty(r, dtype=torch.int32, device=o.device)
        u = torch.empty_like(t)
        v = torch.empty_like(t)
        if r:
            next_ray = torch.zeros(1, dtype=torch.int32, device=o.device)
            stream = torch.cuda.current_stream(o.device).cuda_stream
            err = _load().idk_trace_closest(
                *_wide_tables(scene), _ptr(o), _ptr(d), _ptr(t_max), _ptr(t),
                _ptr(slot), _ptr(u), _ptr(v), _ptr(next_ray), r, entries, scene.bvh4_leaf_bits,
                ctypes.c_void_p(stream))
            _raise_on(err, "trace_closest")
            trace_closest.launches += 1
        return Hit(t=t, slot=slot, u=u, v=v)


def trace_any(scene: SceneArrays, o: torch.Tensor, d: torch.Tensor, t_max,
              max_steps: int | None = None, tag: str = "") -> torch.Tensor:
    """Occlusion per ray: bool (R,), True where a triangle lies at
    0 < t < t_max. t_max < 0 marks a dead ray (never occluded). max_steps
    as in trace_closest; tag too (nee, env, ...), the range
    profiling.call_site_name(True, tag)."""
    _check_cap(max_steps)
    with call_site(True, tag):
        if _on_cpu(scene, o, d):
            return _plain.trace_any(scene, o, d, t_max, max_steps=max_steps)
        if max_steps is not None:
            return _any_capped(scene, o, d, t_max, max_steps)
        t_max, entries = _check_wide(scene, o, d, t_max)
        r = o.shape[0]
        occ = torch.empty(r, dtype=torch.bool, device=o.device)
        if r:
            next_ray = torch.zeros(1, dtype=torch.int32, device=o.device)
            stream = torch.cuda.current_stream(o.device).cuda_stream
            err = _load().idk_trace_any(
                *_wide_tables(scene), _ptr(o), _ptr(d), _ptr(t_max), _ptr(occ),
                _ptr(next_ray), r, entries, scene.bvh4_leaf_bits, ctypes.c_void_p(stream))
            _raise_on(err, "trace_any")
            trace_any.launches += 1
        return occ


def trace_closest_steps(scene: SceneArrays, o: torch.Tensor, d: torch.Tensor,
                        t_max, max_steps: int = 1 << 30) -> tuple[Hit, torch.Tensor]:
    """trace_closest plus each ray's traversal steps, (R,) int32, counted as
    the stackless walk of ops/trace.py counts them (one node per step);
    each ray stops after max_steps steps (the JAX package's default, 1 << 30,
    is no cap on any real tree)."""
    _check_cap(max_steps)
    if _on_cpu(scene, o, d):
        return _plain.trace_closest_steps(scene, o, d, t_max, max_steps=max_steps)
    t_max = _check_thread(scene, o, d, t_max)
    r = o.shape[0]
    t = torch.empty(r, dtype=torch.float32, device=o.device)
    slot = torch.empty(r, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    steps = torch.empty(r, dtype=torch.int32, device=o.device)
    if r:
        stream = ctypes.c_void_p(torch.cuda.current_stream(o.device).cuda_stream)
        tables = (_ptr(scene.bvh_thread), _ptr(scene.tri_vec), _ptr(o), _ptr(d), _ptr(t_max),
                  _ptr(t), _ptr(slot), _ptr(u), _ptr(v), _ptr(steps), r)
        if max_steps >= scene.bvh_thread.shape[0]:
            # the walk steps on each record at most once (its links only go
            # forward): the cap stops no ray, the uncapped entry point serves
            err = _load().idk_trace_closest_steps(*tables, scene.bvh4_leaf_bits, stream)
        else:
            err = _load().idk_trace_closest_steps_capped(*tables, int(max_steps),
                                                         scene.bvh4_leaf_bits, stream)
        _raise_on(err, "trace_closest_steps")
        trace_closest_steps.launches += 1
    return Hit(t=t, slot=slot, u=u, v=v), steps


def _closest_capped(scene: SceneArrays, o: torch.Tensor, d: torch.Tensor, t_max,
                    max_steps: int) -> Hit:
    """Launches the capped closest-hit walk of the threaded records, at most
    max_steps nodes a ray (trace_closest(max_steps=...) on the card)."""
    t_max = _check_thread(scene, o, d, t_max)
    r = o.shape[0]
    t = torch.empty(r, dtype=torch.float32, device=o.device)
    slot = torch.empty(r, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if r:
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = _load().idk_trace_closest_capped(
            _ptr(scene.bvh_thread), _ptr(scene.tri_vec), _ptr(o), _ptr(d), _ptr(t_max), _ptr(t),
            _ptr(slot), _ptr(u), _ptr(v), r, int(max_steps), scene.bvh4_leaf_bits,
            ctypes.c_void_p(stream))
        _raise_on(err, "trace_closest (capped)")
        _closest_capped.launches += 1
    return Hit(t=t, slot=slot, u=u, v=v)


def _any_capped(scene: SceneArrays, o: torch.Tensor, d: torch.Tensor, t_max,
                max_steps: int) -> torch.Tensor:
    """Launches the capped any-hit walk (trace_any(max_steps=...) on the
    card)."""
    t_max = _check_thread(scene, o, d, t_max)
    r = o.shape[0]
    occ = torch.empty(r, dtype=torch.bool, device=o.device)
    if r:
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = _load().idk_trace_any_capped(
            _ptr(scene.bvh_thread), _ptr(scene.tri_vec), _ptr(o), _ptr(d), _ptr(t_max),
            _ptr(occ), r, int(max_steps), scene.bvh4_leaf_bits, ctypes.c_void_p(stream))
        _raise_on(err, "trace_any (capped)")
        _any_capped.launches += 1
    return occ


def _trace_launches() -> int:
    return (trace_closest.launches + trace_any.launches + _closest_capped.launches
            + _any_capped.launches)


def trace_closest_two_level(static_scene: SceneArrays, inst_scenes, inst_inv, inst_boxes,
                            o, d, t_max, slot_off=None, max_steps: int | None = None,
                            tag: str = ""):
    """Two-level closest hit (ops/trace.py:two_level_closest) through
    trace_closest: the trace kernel, or the capped kernel with max_steps,
    once for the static scene and once an instance, each launch tagged
    `tag`. Returns (Hit, inst_id). Its count is the kernel launches made
    inside it."""
    before = _trace_launches()
    out = _plain.two_level_closest(partial(trace_closest, tag=tag), static_scene, inst_scenes,
                                   inst_inv, inst_boxes, o, d, t_max, slot_off, max_steps)
    trace_closest_two_level.launches += _trace_launches() - before
    return out


def trace_any_two_level(static_scene: SceneArrays, inst_scenes, inst_inv, inst_boxes, o, d,
                        t_max, max_steps: int | None = None, tag: str = "") -> torch.Tensor:
    """Two-level occlusion (ops/trace.py:two_level_any) through trace_any,
    as trace_closest_two_level; inst_boxes is not used."""
    del inst_boxes
    before = _trace_launches()
    out = _plain.two_level_any(partial(trace_any, tag=tag), static_scene, inst_scenes, inst_inv,
                               o, d, t_max, max_steps)
    trace_any_two_level.launches += _trace_launches() - before
    return out


# launch counts: each wrapper adds one where it launches its kernel (the
# two-level functions the launches made inside them)
WRAPPERS = (trace_closest, trace_any, trace_closest_steps, _closest_capped, _any_capped,
            trace_closest_two_level, trace_any_two_level)


def reset_launch_counts():
    for fn in WRAPPERS:
        fn.launches = 0


reset_launch_counts()
