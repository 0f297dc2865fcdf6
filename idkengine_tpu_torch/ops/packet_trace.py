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
(`idkengine_tpu/ops/trace.py:177, 227`): on the card one launch of the
two-level kernel (csrc/trace.cu, uncapped or capped) walks the static
scene and every instance's BLAS, bit-equal to the per-instance loop
`ops/trace.py:two_level_closest/two_level_any` over `trace_closest` /
`trace_any`, which stays the yardstick of the tests. Each entry point but the
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
# csrc/trace.cu's TWO_LEVEL_MAX_BLAS and TWO_LEVEL_MAX_INSTANCES: the
# distinct BLASes (the static scene's included) and instances a two-level
# call takes
TWO_LEVEL_MAX_BLAS = 64
TWO_LEVEL_MAX_INSTANCES = 1024

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
    if hasattr(lib, "idk_trace_closest_two_level"):  # interface 6 on
        for fn in (lib.idk_two_level_max_blas, lib.idk_two_level_max_instances,
                   lib.idk_two_level_tables_bytes):
            fn.restype = ci
            fn.argtypes = []
        lib.idk_trace_closest_two_level.restype = ci
        lib.idk_trace_closest_two_level.argtypes = [vp] * 9 + [ci, ci, ci] + [vp] * 3 + [
            ci, ci, vp, vp]
        lib.idk_trace_any_two_level.restype = ci
        lib.idk_trace_any_two_level.argtypes = [vp] * 5 + [ci, ci, ci, vp, ci, ci, vp, vp]
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = bind_library(build_kernels()[0])
        if lib.idk_trace_stack_limit() != WIDE_STACK_LIMIT:
            raise RuntimeError(f"{TRACE_SOURCE} holds {lib.idk_trace_stack_limit()} stack "
                               f"entries a ray, the wrapper expects {WIDE_STACK_LIMIT}")
        if lib.idk_trace_interface() < 6:
            raise RuntimeError(f"{TRACE_SOURCE} has no two-level kernel (interface "
                               f"{lib.idk_trace_interface()})")
        limits = (lib.idk_two_level_max_blas(), lib.idk_two_level_max_instances(),
                  lib.idk_two_level_tables_bytes())
        want = (TWO_LEVEL_MAX_BLAS, TWO_LEVEL_MAX_INSTANCES, ctypes.sizeof(BlasTables))
        if limits != want:
            raise RuntimeError(f"{TRACE_SOURCE}'s two-level tables (BLASes, instances, "
                               f"bytes) are {limits}, the wrapper's {want}")
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


def _check_wide_tables(scene: SceneArrays, dev):
    """The trace kernel's tables: the wide records and tri_vec on `dev`."""
    _check_tensors(dev, {"bvh4_nodes": (scene.bvh4_nodes, torch.int32)})
    w = scene.bvh4_nodes
    if w.dim() != 2 or w.shape[1] != 32 or w.shape[0] < 1 or w.data_ptr() % 128:
        raise ValueError("bvh4_nodes must be (M,32) int32 records, 128-byte aligned")
    _check_tri_vec(scene, dev)


def _check_thread_tables(scene: SceneArrays, dev):
    """The steps and capped kernels' tables: the threaded records and
    tri_vec on `dev`."""
    _check_tensors(dev, {"bvh_thread": (scene.bvh_thread, torch.int32)})
    n = scene.bvh_thread
    if n.dim() != 2 or n.shape[1] != 8 or n.shape[0] < 1 or n.data_ptr() % 32:
        raise ValueError("bvh_thread must be (N,8) int32 records, 32-byte aligned")
    _check_tri_vec(scene, dev)


def _check_wide(scene: SceneArrays, o, d, t_max) -> tuple[torch.Tensor, int]:
    """Validate the trace kernel's inputs; returns (t_max as an (R,) float32
    tensor, stack entries). Raises where the wide tree is too deep for the
    kernel's stack."""
    t_max = _check_rays(o, d, t_max)
    _check_wide_tables(scene, o.device)
    return t_max, wide_stack_entries(scene)


def _check_thread(scene: SceneArrays, o, d, t_max) -> torch.Tensor:
    """Validate the steps kernel's inputs; returns t_max as an (R,) float32
    tensor."""
    t_max = _check_rays(o, d, t_max)
    _check_thread_tables(scene, o.device)
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
    """The one-level trace kernels' launches (trace_closest, trace_any and
    their capped walks)."""
    return (trace_closest.launches + trace_any.launches + _closest_capped.launches
            + _any_capped.launches)


class BlasTables(ctypes.Structure):
    """csrc/trace.cu's BlasTables, which a two-level call passes by value:
    the distinct BLASes' tables (the static scene's first) and each
    instance's BLAS."""

    _fields_ = [("nodes", ctypes.c_void_p * TWO_LEVEL_MAX_BLAS),
                ("tri_vec", ctypes.c_void_p * TWO_LEVEL_MAX_BLAS),
                ("leaf_bits", ctypes.c_int * TWO_LEVEL_MAX_BLAS),
                ("blas_of", ctypes.c_uint16 * TWO_LEVEL_MAX_INSTANCES)]


def _check_instances(inst_scenes, inst_inv, inst_boxes, slot_off, dev):
    """Validate an instance set's tensors: inv (I,3,4) and boxes (I,2,3)
    float32, slot_off (I,) int32 or None, I == len(inst_scenes), all on
    `dev` and contiguous."""
    n = len(inst_scenes)
    f32 = torch.float32
    tensors = {"inst_inv": (inst_inv, f32), "inst_boxes": (inst_boxes, f32)}
    shapes = {"inst_inv": (n, 3, 4), "inst_boxes": (n, 2, 3)}
    if slot_off is not None:
        tensors["slot_off"] = (slot_off, torch.int32)
        shapes["slot_off"] = (n,)
    for name, want in shapes.items():
        if tuple(tensors[name][0].shape) != want:
            raise ValueError(f"{name} must be {want} for {n} instances, got "
                             f"{tuple(tensors[name][0].shape)}")
    _check_tensors(dev, tensors)
    for s in inst_scenes:
        if s.device != dev:
            raise ValueError(f"an instance's scene is on {s.device}, the rays on {dev}")


def _two_level_tables(static_scene: SceneArrays, inst_scenes, capped: bool):
    """(BlasTables, distinct BLASes, stack entries) of a two-level call:
    the static scene's and each distinct instance BLAS's tables (the wide
    records, or the threaded ones when capped), each validated as the
    one-level kernels validate theirs; instances that share a model's
    tables share a BLAS. The stack entries are the deepest wide tree's.
    Raises beyond the kernel's TWO_LEVEL_MAX_INSTANCES and
    TWO_LEVEL_MAX_BLAS."""
    if len(inst_scenes) > TWO_LEVEL_MAX_INSTANCES:
        raise ValueError(f"{len(inst_scenes)} instances; the two-level kernel takes at most "
                         f"{TWO_LEVEL_MAX_INSTANCES}")
    tables = BlasTables()
    index: dict[tuple, int] = {}
    scenes = []
    blas_of = []
    for s in (static_scene, *inst_scenes):
        nodes = s.bvh_thread if capped else s.bvh4_nodes
        key = (nodes.data_ptr(), s.tri_vec.data_ptr(), s.bvh4_leaf_bits)
        if key not in index:
            if len(index) == TWO_LEVEL_MAX_BLAS:
                raise ValueError(f"more than {TWO_LEVEL_MAX_BLAS} distinct BLASes in a "
                                 "two-level call")
            if capped:
                _check_thread_tables(s, s.device)
            else:
                _check_wide_tables(s, s.device)
            b = index[key] = len(index)
            tables.nodes[b], tables.tri_vec[b] = key[0], key[1]
            tables.leaf_bits[b] = s.bvh4_leaf_bits
            scenes.append(s)
        blas_of.append(index[key])
    for k, b in enumerate(blas_of[1:]):
        tables.blas_of[k] = b
    entries = 0 if capped else max(wide_stack_entries(s) for s in scenes)
    return tables, len(scenes), entries


def _two_level_launch(any_hit: bool, static_scene: SceneArrays, inst_scenes, inst_inv,
                      inst_boxes, slot_off, o, d, t_max, max_steps):
    """Validate a two-level call's rays and tables on the card (its
    instances checked by _check_instances) and launch its kernel. Returns
    the outputs: (Hit, inst_id), or the occlusion."""
    dev = o.device
    t_max = _check_rays(o, d, t_max)
    tables, n_blas, entries = _two_level_tables(static_scene, inst_scenes,
                                                max_steps is not None)
    r, n = o.shape[0], len(inst_scenes)
    cap = -1 if max_steps is None else int(max_steps)
    if any_hit:
        out = torch.empty(r, dtype=torch.bool, device=dev)
    else:
        t = torch.empty(r, dtype=torch.float32, device=dev)
        slot = torch.empty(r, dtype=torch.int32, device=dev)
        u = torch.empty_like(t)
        v = torch.empty_like(t)
        inst = torch.empty(r, dtype=torch.int32, device=dev)
        out = (Hit(t=t, slot=slot, u=u, v=v), inst)
    if r:
        next_ray = torch.zeros(1, dtype=torch.int32, device=dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        lib = _load()
        if any_hit:
            err = lib.idk_trace_any_two_level(
                _ptr(o), _ptr(d), _ptr(t_max), _ptr(out), _ptr(next_ray), r, entries, cap,
                _ptr(inst_inv), n, n_blas, ctypes.byref(tables), stream)
        else:
            err = lib.idk_trace_closest_two_level(
                _ptr(o), _ptr(d), _ptr(t_max), _ptr(t), _ptr(slot), _ptr(u), _ptr(v),
                _ptr(inst), _ptr(next_ray), r, entries, cap, _ptr(inst_inv), _ptr(inst_boxes),
                None if slot_off is None else _ptr(slot_off), n, n_blas, ctypes.byref(tables),
                stream)
        _raise_on(err, "two-level trace")
    return out


def trace_closest_two_level(static_scene: SceneArrays, inst_scenes, inst_inv, inst_boxes,
                            o, d, t_max, slot_off=None, max_steps: int | None = None,
                            tag: str = ""):
    """Two-level closest hit (ops/trace.py:trace_closest_two_level): the
    static scene, then each instance (inst_scenes one SceneArrays an
    instance, inst_inv (I,3,4) world->local, inst_boxes (I,2,3) world
    boxes, slot_off (I,) int32 or None) whose box the ray must enter. On
    the card one launch of csrc/trace.cu's two-level kernel (capped with
    max_steps), inside the range profiling.call_site_name(False, tag);
    bit-equal to the loop ops/trace.py:two_level_closest over
    trace_closest. Returns (Hit, inst_id), inst_id -1 for a static hit or a
    miss."""
    _check_cap(max_steps)
    with call_site(False, tag):
        on_cpu = _on_cpu(static_scene, o, d)
        _check_instances(inst_scenes, inst_inv, inst_boxes, slot_off, o.device)
        if on_cpu:
            return _plain.trace_closest_two_level(static_scene, inst_scenes, inst_inv,
                                                  inst_boxes, o, d, t_max, slot_off, max_steps)
        out = _two_level_launch(False, static_scene, inst_scenes, inst_inv, inst_boxes,
                                slot_off, o, d, t_max, max_steps)
        if o.shape[0]:
            trace_closest_two_level.launches += 1
        return out


def trace_any_two_level(static_scene: SceneArrays, inst_scenes, inst_inv, inst_boxes, o, d,
                        t_max, max_steps: int | None = None, tag: str = "") -> torch.Tensor:
    """Two-level occlusion (ops/trace.py:trace_any_two_level), one launch
    on the card, as trace_closest_two_level; the instances are not pruned
    by their boxes (the JAX package prunes none here), but inst_boxes is
    checked all the same."""
    _check_cap(max_steps)
    with call_site(True, tag):
        on_cpu = _on_cpu(static_scene, o, d)
        _check_instances(inst_scenes, inst_inv, inst_boxes, None, o.device)
        if on_cpu:
            return _plain.trace_any_two_level(static_scene, inst_scenes, inst_inv, inst_boxes,
                                              o, d, t_max, max_steps)
        out = _two_level_launch(True, static_scene, inst_scenes, inst_inv, inst_boxes, None,
                                o, d, t_max, max_steps)
        if o.shape[0]:
            trace_any_two_level.launches += 1
        return out


# launch counts: each wrapper adds one where it launches its kernel
WRAPPERS = (trace_closest, trace_any, trace_closest_steps, _closest_capped, _any_capped,
            trace_closest_two_level, trace_any_two_level)


def reset_launch_counts():
    for fn in WRAPPERS:
        fn.launches = 0


reset_launch_counts()
