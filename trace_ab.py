#!/usr/bin/env python3
"""Time trace kernels built from several sources on the main path's ray
batches, in turns, on one CUDA card.

    python3 trace_ab.py LABEL=SOURCE[@FLAGS] [LABEL=SOURCE[@FLAGS] ...] [--reps N]

Each SOURCE is a trace.cu (the trace_math.cuh it includes is looked up
beside it), built with the port's nvcc flags plus FLAGS (space-separated,
for example "-DX=1") into build/libidk_trace_ab_<LABEL>.so; the compilers
run together. A library that exports `idk_trace_stack_limit` is called
through ops/packet_trace.py's wrappers (the 4-wide tables); one that does
not, through the binary layout's interface (`bvh_nodes` records, the
kernel of csrc/trace.cu before the 4-wide tree).

The batches are chip_smoke.py's: the 2.8M atrium's 1920x1080 primaries
(closest), 5-unit shadow rays from their hits (any-hit), the path-traced
frame's first bounce batch (closest) and every trace of one deferred frame
(VXGI 256^3). Each library's results are held to the first library's by
chip_smoke.check_agreement. Times are CUDA-event means over --reps
launches, taken for the libraries in the order given and then in reverse
(A B C C B A), each line with the card's name and power limit. The last
line is one JSON object: label -> batch -> [ms of the first turn, ms of
the second].
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


def build(label, source, flags):
    from idkengine_tpu_torch.ops import packet_trace as kern
    from idkengine_tpu_torch.ops._build import build_shared_library, find_nvcc

    header = os.path.join(os.path.dirname(os.path.abspath(source)), "trace_math.cuh")
    return build_shared_library(f"libidk_trace_ab_{label}.so", [source],
                                [find_nvcc(), *kern.NVCC_FLAGS, *flags], headers=(header,))


def binary_call(lib, kind, scene, o, d, t_max):
    """One launch through the binary layout's interface."""
    import torch

    from idkengine_tpu_torch.ops import packet_trace as kern

    t_max = kern._check_inputs(scene, o, d, t_max)
    r, p = o.shape[0], kern._ptr
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    tables = (p(scene.bvh_nodes), p(scene.tri_p0), p(scene.tri_e1), p(scene.tri_e2))
    if kind == "trace_any":
        occ = torch.empty(r, dtype=torch.bool, device=o.device)
        kern._raise_on(lib.idk_trace_any(*tables, p(o), p(d), p(t_max), p(occ), r, stream), kind)
        return occ
    t = torch.empty(r, device=o.device)
    slot = torch.empty(r, dtype=torch.int32, device=o.device)
    u, v = torch.empty_like(t), torch.empty_like(t)
    kern._raise_on(lib.idk_trace_closest(*tables, p(o), p(d), p(t_max), p(t), p(slot), p(u),
                                         p(v), r, stream), kind)
    return kern.Hit(t=t, slot=slot, u=u, v=v)


def tracer(path):
    """(kind, scene, o, d, t_max) -> result, through the library at path."""
    from idkengine_tpu_torch.ops import packet_trace as kern

    raw = ctypes.CDLL(path)
    if not hasattr(raw, "idk_trace_stack_limit"):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        raw.idk_trace_closest.argtypes = [vp] * 11 + [ci, vp]
        raw.idk_trace_any.argtypes = [vp] * 8 + [ci, vp]
        return lambda kind, *args: binary_call(raw, kind, *args)
    lib = kern.bind_library(path)

    def call(kind, *args):
        saved, kern._lib = kern._lib, lib
        try:
            return getattr(kern, kind)(*args)
        finally:
            kern._lib = saved
    return call


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", help="LABEL=SOURCE[@FLAGS]")
    ap.add_argument("--reps", type=int, default=10)
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
    fns = {label: tracer(path) for (label, _, _), (path, _) in zip(specs, built)}

    db, scene, cam = cs.phase_scene(dev)
    pt = cs.make_tracer(db, scene, cam, dev)
    batches = {name: (kind, scene, o, d, t) for name, (kind, o, d, t)
               in cs.main_path_batches(cam, pt, dev).items()}
    del pt
    from idkengine_tpu_torch.render import DeferredPipeline

    pipe = DeferredPipeline(db, cs.WIDTH, cs.HEIGHT, cs._deferred_settings(cs.VXGI_RES),
                            device=dev)
    pipe.render_frame(cam)
    for n, call in enumerate(cs.record_deferred_traces(pipe, cam)):
        batches[f"deferred {n}"] = call
    del pipe

    first = specs[0][0]
    times = {label: {name: [] for name in batches} for label in fns}
    for name, (kind, sc, o, d, t_max) in batches.items():
        ref = fns[first](kind, sc, o, d, t_max)
        for label, fn in fns.items():
            agree, _ = cs.check_agreement(kind, fn(kind, sc, o, d, t_max), ref,
                                          f"{label} against {first} on {name}")
            cs.log(f"# {name} ({o.shape[0]} rays, {kind}): {label} agrees with {first} on "
                   f"{agree:.6f}")
        for label in [*fns, *reversed(fns)]:
            ms = cs.cuda_time_ms(lambda: fns[label](kind, sc, o, d, t_max), args.reps)
            times[label][name].append(ms)
            cs.log(f"# {name} ({o.shape[0]} rays, {kind}): {label} {ms:.4f} ms; on {card}")
    cs.log(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
