#!/usr/bin/env python3
"""Time traversal kernels built from several sources on the main path's ray
batches, in turns, on one CUDA card.

    python3 trace_ab.py LABEL=SOURCE[@FLAGS] [LABEL=SOURCE[@FLAGS] ...] [--reps N]
                        [--kinds trace steps capped phase_a phase_b pipeline]
                        [--frames N]

Each SOURCE is a trace.cu or a two_phase.cu (the trace_math.cuh it includes
is looked up beside it), built with the port's nvcc flags plus FLAGS
(space-separated, for example "-DSTEPS_PREFETCH=1") into
build/libidk_trace_ab_<LABEL>.so; the compilers run together. A library's
interface is read from what it exports:
- a trace.cu with `idk_trace_interface` is called through
  ops/packet_trace.py's wrappers (the wide tables with the scene's leaf
  bits; the steps kernel over the threaded records); one with only
  `idk_trace_stack_limit` takes the wide tables with 5 count bits and a
  steps kernel over the six threaded arrays; one with neither, the binary
  node records (`bvh_nodes`) for every query;
- a two_phase.cu's phase A takes the binary node records, its phase B
  tri_vec.

The batches are chip_smoke.py's: the 2.8M atrium's 1920x1080 primaries
(closest), 5-unit shadow rays from their hits (any-hit), the path-traced
frame's first bounce batch (closest), every trace of one deferred frame
(VXGI 256^3), and the debug view's 1920x1080 primaries. trace.cu libraries
run trace_closest/trace_any on the first four kinds and
trace_closest_steps on the debug view's rays and the primaries, and
(`capped`) the capped walks (trace_closest / trace_any with max_steps) on
the primaries, the shadow rays and the bounce batch at chip_smoke.py's
phase 15 caps (chip_smoke.capped_caps), each steps or capped batch printed
with the lane utilization of a ray a thread (chip_smoke.lane_utilization
of the plain walk's steps) and its lockstep warps' loop and leaf trips,
each capped batch also with the time the card takes at least to issue
those trips (capped_issue_ms); two_phase.cu
libraries run phase A (D = 8) on the primaries, the shadow rays and the
bounce batch, phase B (closest on the primaries and the bounce batch,
any-hit on the shadow rays) on the lists of the port's own phase A, and
(`pipeline`) the two-phase PathTracerPipeline frame of chip_smoke.py's
phase 9 with each library in the wrapper's place: one pipeline warmed up
to its denoised frames, then --frames frames a turn on the host clock.
Each library is held to the first library of its kind: with the same
interface, trace results by chip_smoke.check_agreement, steps, t, slot, u
and v equal on every ray, phase A's cnt equal on every ray and its list
sets where cnt <= D, phase B's and the capped walks' t, slot, u and v
(occlusion) equal on every ray. An older trace.cu does not round its
Möller–Trumbore test as the JAX package does (no fused multiply-adds), so
its results are only reported: the share of rays with the first library's
hit decision, and of those with t within 1e-5 relative. Times are
CUDA-event means over --reps launches, taken for the libraries of a kind in
the order given and then in reverse (A B C C B A), each line with the
card's name and power limit. The last line is one JSON object: label ->
batch -> [ms of the first turn, ms of the second].
"""
import argparse
import ctypes
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402

D_SLOTS = 8


def build(label, source, flags):
    from idkengine_tpu_torch.ops import packet_trace as kern
    from idkengine_tpu_torch.ops._build import build_shared_library, find_nvcc

    header = os.path.join(os.path.dirname(os.path.abspath(source)), "trace_math.cuh")
    return build_shared_library(f"libidk_trace_ab_{label}.so", [source],
                                [find_nvcc(), *kern.NVCC_FLAGS, *flags], headers=(header,))


def _stream():
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _hit_outputs(o):
    import torch

    r = o.shape[0]
    t = torch.empty(r, device=o.device)
    return t, torch.empty(r, dtype=torch.int32, device=o.device), torch.empty_like(t), \
        torch.empty_like(t)


def binary_call(lib, kind, scene, o, d, t_max):
    """One launch through the binary layout's interface."""
    import torch

    from idkengine_tpu_torch.ops import packet_trace as kern

    t_max = kern._check_rays(o, d, t_max)
    r, p = o.shape[0], kern._ptr
    tables = (p(scene.bvh_nodes), p(scene.tri_p0), p(scene.tri_e1), p(scene.tri_e2))
    if kind == "trace_any":
        occ = torch.empty(r, dtype=torch.bool, device=o.device)
        kern._raise_on(lib.idk_trace_any(*tables, p(o), p(d), p(t_max), p(occ), r, _stream()),
                       kind)
        return occ
    out = _hit_outputs(o)
    if kind == "trace_closest_steps":
        threaded = [p(getattr(scene, k)) for k in ("node_min", "node_max", "node_first",
                                                   "node_count", "hit_link", "miss_link")]
        steps = torch.empty(o.shape[0], dtype=torch.int32, device=o.device)
        kern._raise_on(lib.idk_trace_closest_steps(
            *threaded, *tables[1:], p(o), p(d), p(t_max), *map(p, out), p(steps), r, _stream()),
            kind)
        return kern.Hit(*out), steps
    kern._raise_on(lib.idk_trace_closest(*tables, p(o), p(d), p(t_max), *map(p, out), r,
                                         _stream()), kind)
    return kern.Hit(*out)


def wide5_call(lib, kind, scene, o, d, t_max):
    """One launch through the interface of the wide tables with 5 count
    bits (the steps kernel over the six threaded arrays)."""
    import torch

    from idkengine_tpu_torch.ops import packet_trace as kern

    if kind == "trace_closest_steps":
        return binary_call(lib, kind, scene, o, d, t_max)
    if scene.bvh4_leaf_bits != 5:
        raise ValueError("this library packs leaf counts in 5 bits")
    t_max, entries = kern._check_wide(scene, o, d, t_max)
    r, p = o.shape[0], kern._ptr
    next_ray = torch.zeros(1, dtype=torch.int32, device=o.device)
    tables = (p(scene.bvh4_nodes), p(scene.tri_vec), p(o), p(d), p(t_max))
    if kind == "trace_any":
        occ = torch.empty(r, dtype=torch.bool, device=o.device)
        kern._raise_on(lib.idk_trace_any(*tables, p(occ), p(next_ray), r, entries, _stream()),
                       kind)
        return occ
    out = _hit_outputs(o)
    kern._raise_on(lib.idk_trace_closest(*tables, *map(p, out), p(next_ray), r, entries,
                                         _stream()), kind)
    return kern.Hit(*out)


def binary_phase_a(lib, scene, o, d, t_max, d_slots):
    """Phase A through the binary layout's interface."""
    import torch

    from idkengine_tpu_torch.ops import packet_trace as kern

    t_max = kern._check_rays(o, d, t_max)
    r, p = o.shape[0], kern._ptr
    lists = torch.empty((r, d_slots), dtype=torch.int32, device=o.device)
    cnt = torch.empty(r, dtype=torch.int32, device=o.device)
    kern._raise_on(lib.idk_phase_a(p(scene.bvh_nodes), p(o), p(d), p(t_max), p(lists), p(cnt),
                                   d_slots, r, _stream()), "phase_a")
    return lists, cnt


def tracer(path):
    """(interface, (kind, scene, o, d, t_max[, max_steps]) -> result) of the
    trace library at path."""
    from idkengine_tpu_torch.ops import packet_trace as kern

    raw = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if not hasattr(raw, "idk_trace_interface"):
        wide = hasattr(raw, "idk_trace_stack_limit")
        raw.idk_trace_closest.argtypes = [vp] * (10 if wide else 11) + [ci] * (2 if wide else 1) \
            + [vp]
        raw.idk_trace_any.argtypes = [vp] * (7 if wide else 8) + [ci] * (2 if wide else 1) + [vp]
        raw.idk_trace_closest_steps.argtypes = [vp] * 17 + [ci, vp]
        call = wide5_call if wide else binary_call
        return (2 if wide else 1), lambda kind, *args: call(raw, kind, *args)
    lib = kern.bind_library(path)

    def call(kind, *args):
        saved, kern._lib = kern._lib, lib
        try:
            return getattr(kern, kind)(*args)
        finally:
            kern._lib = saved
    return lib.idk_trace_interface(), call


def phase_a_runner(path):
    """(scene, o, d, t_max) -> (lists, cnt) through the two-phase library at
    path."""
    raw = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    raw.idk_phase_a.argtypes = [vp] * 6 + [ci, ci, vp]
    return lambda *args: binary_phase_a(raw, *args, D_SLOTS)


class TwoPhaseLibrary:
    """The two-phase library at path behind the interface that
    ops/two_phase.py's wrappers call. Swapped into the wrapper's `_lib`."""

    def __init__(self, path):
        raw = ctypes.CDLL(path)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        raw.idk_phase_a.argtypes = [vp] * 6 + [ci, ci, vp]
        raw.idk_phase_b_closest.argtypes = [vp] * 11 + [ci, ci, vp]
        raw.idk_phase_b_any.argtypes = [vp] * 8 + [ci, ci, vp]
        self.idk_phase_a = raw.idk_phase_a
        self.idk_phase_a_stack_size = raw.idk_phase_a_stack_size
        self.idk_phase_b_closest = raw.idk_phase_b_closest
        self.idk_phase_b_any = raw.idk_phase_b_any


def with_two_phase(lib, fn, *args):
    """fn(*args) with lib in ops/two_phase.py's `_lib`."""
    from idkengine_tpu_torch.ops import two_phase as tp

    saved, tp._lib = tp._lib, lib
    try:
        return fn(*args)
    finally:
        tp._lib = saved


def phase_b_runner(lib):
    """(kind, scene, lists, o, d, t_max) -> Hit or occlusion through lib."""
    from idkengine_tpu_torch.ops import two_phase as tp

    def run(kind, scene, lists, o, d, t_max):
        fn = tp.phase_b_closest if kind == "trace_closest" else tp.phase_b_any
        return with_two_phase(lib, fn, scene, lists, o, d, t_max)
    return run


def check_exact(kind, got, want, what):
    """t, slot, u and v (occlusion) equal on every ray."""
    import torch

    if kind == "trace_any":
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: occlusion differs on {(got != want).sum().item()} rays")
        return
    for k in ("t", "slot", "u", "v"):
        if not torch.equal(getattr(got, k), getattr(want, k)):
            raise AssertionError(f"{what}: {k} differs")


def time_pipeline(db, cam, dev, libs, frames, card):
    """The two-phase PathTracerPipeline frame (chip_smoke.py's phase 9)
    with each two-phase library in turns (A B ... B A): ms/frame on the
    host clock over `frames` frames a turn, after a warm-up to its denoised
    frames. Returns label -> [ms of each turn]."""
    import torch

    from idkengine_tpu_torch.render import (PathTracerPipeline, PathTracerSettings,
                                            PtPipelineSettings)

    settings = PathTracerSettings(ray_depth=cs.DEPTH, russian_roulette=False,
                                  do_ray_sorting=True, sky_strength=1.0, use_two_phase=True)
    pipe = PathTracerPipeline(db, cs.WIDTH, cs.HEIGHT, settings, PtPipelineSettings(), device=dev)
    for _ in range(cs.DENOISE_AT):
        pipe.render_frame(cam)
    times = {label: [] for label in libs}
    for label in [*libs, *reversed(libs)]:
        with_two_phase(libs[label], pipe.render_frame, cam)  # the first frame after a swap
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(frames):
            with_two_phase(libs[label], pipe.render_frame, cam)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / frames * 1e3
        times[label].append(ms)
        cs.log(f"# two-phase pipeline frame (denoised, {cs.WIDTH}x{cs.HEIGHT}): {label} "
               f"{ms:.3f} ms/frame over {frames} frames; on {card}")
    return times


# Warp instructions trace.cu's trace_capped_kernel issues, by kind, read
# from its SASS (cuobjdump -sass; nvcc 12.8, sm_90a): a step at an interior
# node, from the loop's head to its closing branch, and a triangle of a
# leaf on the division's fast path (the closest-hit loop tests two a pass:
# half of the pass). A leaf's entry and exit are left out, so the issue
# time of these counts is a lower bound. CAPPED_SASS_SIZE is each
# instantiation's instruction count in that machine code: a library whose
# kernel has another is not the code these counts were read from, and gets
# no issue time.
STEP_INSTRUCTIONS = {"trace_closest": 44, "trace_any": 47}
TRIANGLE_INSTRUCTIONS = {"trace_closest": 67, "trace_any": 68}
CAPPED_SASS_SIZE = {"trace_closest": 456, "trace_any": 304}


def capped_sass_sizes(path):
    """kind -> instructions of the library's trace_capped_kernel<kind> in
    its SASS."""
    from idkengine_tpu_torch.tools import sass_count

    sizes = {}
    for name, instrs in sass_count.functions(sass_count.dump(path)).items():
        args = None if isinstance(name, tuple) else sass_count.template_args(
            name, "trace_capped_kernel")
        if args:
            sizes[("trace_closest", "trace_any")[args[0]]] = len(instrs)
    return sizes


def walk_trips(kind, args):
    """(lane utilization of a ray a thread, loop trips, leaf trips) of the
    plain walk on a steps or capped run's arguments (scene, o, d, t_max[,
    cap]), a ray a lane in warps of chip_smoke.WARP that walk in lockstep."""
    import torch

    from idkengine_tpu_torch.ops import trace as plain

    scene, o, d, t_max, *cap = args
    steps = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)
    leaf = torch.zeros(1, dtype=torch.int64, device=o.device)
    plain._traverse(scene, o, d, t_max, kind == "trace_any", steps, cap[0] if cap else None,
                    leaf_trips=leaf)
    return cs.lane_utilization(steps), cs.warp_trips(steps), int(leaf.item())


def capped_issue_ms(kind, trips, leaf, sms, clock_mhz):
    """The least time the card takes to issue a capped walk's lockstep
    trips at STEP_INSTRUCTIONS and TRIANGLE_INSTRUCTIONS: four warp
    instructions a cycle on every SM at clock_mhz."""
    n = trips * STEP_INSTRUCTIONS[kind] + leaf * TRIANGLE_INSTRUCTIONS[kind]
    return n / (4 * sms * clock_mhz * 1e6) * 1e3


def card_top_clock_mhz():
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return float(out.strip().splitlines()[0])


def check_steps(got, want, what):
    """Steps, t, slot, u and v equal on every ray."""
    import torch

    (gh, gs), (wh, ws) = got, want
    if not torch.equal(gs, ws):
        raise AssertionError(f"{what}: steps differ on {(gs != ws).sum().item()} rays")
    for k in ("t", "slot", "u", "v"):
        if not torch.equal(getattr(gh, k), getattr(wh, k)):
            raise AssertionError(f"{what}: {k} differs")


def check_phase_a(got, want, what):
    """cnt equal on every ray, list sets equal where cnt <= D."""
    import torch

    (gl, gc), (wl, wc) = got, want
    if not torch.equal(gc, wc):
        raise AssertionError(f"{what}: cnt differs on {(gc != wc).sum().item()} rays")
    fine = gc <= D_SLOTS
    if not torch.equal(torch.sort(gl[fine], 1).values, torch.sort(wl[fine], 1).values):
        raise AssertionError(f"{what}: list sets differ")


def report_loose(kind, got, want):
    """(share of rays with the same hit decision, share of those hits with t
    within 1e-5 relative) of an older trace library against the first."""
    import torch

    if kind == "trace_closest_steps":
        got, want = got[0], want[0]
    if kind == "trace_any":
        return (got == want).float().mean().item(), 1.0
    hit = got.slot >= 0
    same = hit == (want.slot >= 0)
    both = hit & (want.slot >= 0)
    close = torch.isclose(got.t[both], want.t[both], rtol=1e-5, atol=0)
    return same.float().mean().item(), close.float().mean().item() if both.any() else 1.0


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", help="LABEL=SOURCE[@FLAGS]")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--kinds", nargs="+",
                    choices=("trace", "steps", "capped", "phase_a", "phase_b", "pipeline"),
                    default=("trace", "steps", "phase_a", "phase_b"),
                    help="what to time (default: every kernel; `pipeline` adds the two-phase "
                         "pipeline frame)")
    ap.add_argument("--frames", type=int, default=8, help="pipeline frames a turn")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_ab: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = cs.phase_card()
    specs = []
    for spec in args.sources:
        label, rest = spec.split("=", 1)
        source, _, flags = rest.partition("@")
        specs.append((label, source, flags.split()))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(specs)) as pool:
        built = list(pool.map(lambda s: build(*s), specs))
    cs.log(f"# built {len(specs)} libraries in {time.perf_counter() - t0:.1f} s")
    for (label, _, flags), (_, out) in zip(specs, built):
        for line in out.splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill")):
                cs.log(f"#   {label} {' '.join(flags)}: {line.strip()}")
    traces, phase_as, two_phase_paths = {}, {}, {}
    for (label, source, _), (path, _) in zip(specs, built):
        if os.path.basename(source).startswith("two_phase"):
            phase_as[label] = phase_a_runner(path)
            two_phase_paths[label] = path
        else:
            traces[label] = tracer(path)

    db, scene, cam = cs.phase_scene(dev)
    pt = cs.make_tracer(db, scene, cam, dev)
    batches = {name: (kind, scene, o, d, t) for name, (kind, o, d, t)
               in cs.main_path_batches(cam, pt, dev).items()}
    del pt
    runs = []  # (name, kind, args, {label: fn}, {label: interface})
    fns = {label: fn for label, (_, fn) in traces.items()}
    faces = {label: face for label, (face, _) in traces.items()}
    if traces and "trace" in args.kinds:
        from idkengine_tpu_torch.render import DeferredPipeline

        pipe = DeferredPipeline(db, cs.WIDTH, cs.HEIGHT, cs._deferred_settings(cs.VXGI_RES),
                                device=dev)
        pipe.render_frame(cam)
        calls = {f"deferred {n} ({pass_})": call for n, (pass_, *call) in
                 enumerate(cs.record_deferred_traces(pipe, cam))}
        del pipe
        for name, (kind, *rest) in {**batches, **calls}.items():
            runs.append((name, kind, rest, fns, faces))
    if traces and "steps" in args.kinds:
        o, d, t_max = cs.debug_view_rays(cam, dev)
        for name, rest in (("steps debug view", (scene, o, d, t_max)),
                           ("steps primary", batches["primary"][1:])):
            runs.append((name, "trace_closest_steps", rest, fns, faces))
    counted = []  # the labels whose trace_capped_kernel is the code the counts are from
    if traces and "capped" in args.kinds:
        for (label, source, _), (path, _) in zip(specs, built):
            if label in traces:
                sizes = capped_sass_sizes(path)
                cs.log(f"# {label}: trace_capped_kernel SASS instructions {sizes}")
                if sizes == CAPPED_SASS_SIZE:
                    counted.append(label)
        names = ("primary", "shadow", "bounce")
        p99 = max(cs.steps_stats(*batches[name][1:])["steps_p99"] for name in names)
        for name in names:
            for cap in cs.capped_caps(p99):
                runs.append((f"capped {name} cap {cap}", batches[name][0],
                             (*batches[name][1:], cap), fns, faces))
    if phase_as and "phase_a" in args.kinds:
        fns = {label: (lambda f: lambda kind, *a: f(*a))(fn) for label, fn in phase_as.items()}
        faces = dict.fromkeys(phase_as, 1)
        for name in ("primary", "shadow", "bounce"):
            runs.append((f"phase_a {name}", "phase_a", batches[name][1:], fns, faces))
    two_libs = {label: TwoPhaseLibrary(path) for label, path in two_phase_paths.items()}
    if two_libs and "phase_b" in args.kinds:
        from idkengine_tpu_torch.ops import two_phase as tp

        fns = {label: phase_b_runner(lib) for label, lib in two_libs.items()}
        faces = dict.fromkeys(two_libs, 1)
        for name in ("primary", "shadow", "bounce"):
            kind, sc, o, d, t_max = batches[name]
            lists, _ = tp.phase_a(sc, o, d, t_max, D_SLOTS)
            runs.append((f"phase_b {name}", kind, (sc, lists, o, d, t_max), fns, faces))

    clock = card_top_clock_mhz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    times = {label: {} for label in [*traces, *phase_as]}
    for name, kind, rest, fns, faces in runs:
        first = next(iter(fns))
        ref = fns[first](kind, *rest)
        n_rays = rest[1].shape[0]
        for label, fn in fns.items():
            got = fn(kind, *rest)
            what = f"{label} against {first} on {name}"
            if kind == "phase_a":
                check_phase_a(got, ref, what)
                note = "cnt equal on every ray, list sets equal where cnt <= D"
            elif name.startswith(("phase_b", "capped")):
                check_exact(kind, got, ref, what)
                note = "t, slot, u, v (occlusion) equal on every ray"
            elif faces[label] != faces[first]:
                same, close = report_loose(kind, got, ref)
                note = (f"other arithmetic: hit decision equal on {same:.6f}, t within 1e-5 on "
                        f"{close:.6f} of common hits")
            elif kind == "trace_closest_steps":
                check_steps(got, ref, what)
                note = "steps, t, slot, u, v equal on every ray"
            else:
                agree, _ = cs.check_agreement(kind, got, ref, what)
                note = f"agrees on {agree:.6f}"
            cs.log(f"# {name} ({n_rays} rays, {kind}): {label} against {first}: {note}")
        if name.startswith(("capped", "steps")):
            util, trips, leaf = walk_trips(kind, rest)
            note = (f"# {name}: lane utilization of a ray a thread {util:.4f}; lockstep warps "
                    f"take {trips} loop trips and {leaf} leaf trips")
            if name.startswith("capped") and counted:
                issue = capped_issue_ms(kind, trips, leaf, sms, clock)
                note += (f": at least {issue:.4f} ms of issue for {', '.join(counted)} "
                         f"({STEP_INSTRUCTIONS[kind]} and {TRIANGLE_INSTRUCTIONS[kind]} "
                         f"instructions, {clock:.0f} MHz)")
            elif name.startswith("capped"):
                note += ("; no issue time: no library's trace_capped_kernel is the code "
                         "STEP_INSTRUCTIONS were read from")
            cs.log(note)
        for label in [*fns, *reversed(fns)]:
            ms = cs.cuda_time_ms(lambda: fns[label](kind, *rest), args.reps)
            times[label].setdefault(name, []).append(ms)
            cs.log(f"# {name} ({n_rays} rays, {kind}): {label} {ms:.4f} ms; on {card}")
    if two_libs and "pipeline" in args.kinds:
        for label, ms in time_pipeline(db, cam, dev, two_libs, args.frames, card).items():
            times.setdefault(label, {})["pipeline two-phase frame"] = ms
    cs.log(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
