"""One run of one cell: set-up, the measured window, the traced frames, the
metrics, and the check against the plain reference.

Everything particular to a cell is found by name: the configuration's
file (BENCHMARK.json), the traffic mix (traffic/<name>.json), the scene
generator (scenes/<generator>.py), the renderer's driver
(renderers/<renderer>.py) and its plain reference
(reference/<renderer>.py), each metric's reader (metrics/<name>.py; a
name with a dot, such as frame_ms.textured, is the same quantity kept
apart for other cells and reads with the reader of the part before it), the
check's limits (limits/<cell>.json).

A renderer's driver defines Renderer(config, traffic, scene, device) with
`build_s` (the scene build's seconds), `frame_index` (the RNG's frame index
of its next frame), frame(pose) -> the (H,W,3) image of one frame, and
close(); its reference defines values(config, traffic, scene, frames,
pixels, device, dtype) -> (F, P, 3) for [(pose, frame index), ...].
"""
from __future__ import annotations

import copy
import gc
import json
import os
import subprocess
import sys
import time
from importlib import import_module
from types import SimpleNamespace

import torch

from . import checks, roofline, timeline
from .scenes.common import Light

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PACKAGE = "idkengine_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "idkengine_tpu")
CONTROL = {"float32": torch.bfloat16}  # the precision below the stated one


def read_json(path):
    with open(path) as f:
        return json.load(f)


def merged(base: dict, over: dict | None) -> dict:
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def cell(workload: str, root: str = ROOT):
    """(spec, workload entry, configuration's file, traffic mix) of a cell."""
    spec = read_json(os.path.join(root, "BENCHMARK.json"))
    wl = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == wl["config"])
    config = read_json(os.path.join(root, entry["file"]))
    traffic = read_json(os.path.join(root, "benchmark", "traffic", f"{wl['traffic']}.json"))
    return spec, wl, config, traffic


def metrics_of(spec: dict, workload: str, kind: str) -> list:
    """The cell's metrics of `kind` (end_to_end or per_layer)."""
    return [m for m in spec[kind] if workload in m.get("workloads", [workload])]


def banned_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def traced_frames(r, poses, first: int, n: int, device):
    """n frames under torch.profiler, each in timeline.FRAME_RANGE, after one
    frame that lets the profiler settle; the trace calls of the n frames.
    The n frames run once before with the recorder alone, so that the
    allocator holds the memory the recorded calls keep."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with roofline.record_traces(PACKAGE) as calls:
        for j in range(1, n + 1):
            r.frame(poses[(first + j) % len(poses)])
        sync(device)
    del calls
    with profile(activities=acts) as prof:
        r.frame(poses[first % len(poses)])
        sync(device)
        with roofline.record_traces(PACKAGE) as calls:
            for j in range(1, n + 1):
                with record_function(timeline.FRAME_RANGE):
                    r.frame(poses[(first + j) % len(poses)])
                    sync(device)
    return timeline.build(prof.events(), DeviceType.CPU, DeviceType.CUDA), list(calls)


def reader(name: str):
    """The module that reads metric `name`: metrics/<name before any dot>.py."""
    return import_module(f"benchmark.metrics.{name.split('.')[0]}")


def read_metrics(entries: list, data, log) -> dict:
    out = {}
    for m in entries:
        value = reader(m["name"]).read(data)
        if value is None:
            log(f"metric {m['name']}: nothing to read")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float, *,
             root: str = ROOT, device="cuda", overrides: dict | None = None,
             control: bool = False, log=None) -> dict:
    """One run; returns the result line's object (and, with `control`, the
    control's numbers under "control")."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    spec, wl, config, traffic = cell(workload, root)
    config = merged(config, (overrides or {}).get("config"))
    traffic = merged(traffic, (overrides or {}).get("traffic"))
    cuda = torch.device(device).type == "cuda"
    rng_pose, rng_frames, rng_pixels = checks.streams(seed, 3)

    scene = import_module(f"benchmark.scenes.{traffic['scene']['generator']}").generate(
        traffic["scene"], seed, device)
    scene.lights = [Light(tuple(x["position"]), tuple(x["radiance"]), float(x["radius"]))
                    for x in traffic["lights"]]
    r = import_module(f"benchmark.renderers.{config['renderer']}").Renderer(config, traffic,
                                                                            scene, device)
    poses = traffic["camera"]["poses"]
    k = int(rng_pose.integers(len(poses)))  # the seed's first pose
    n_px = int(config["width"]) * int(config["height"])
    px = torch.as_tensor(checks.pick_pixels(rng_pixels, n_px, int(traffic["check"]["pixels"])),
                         device=device)
    for _ in range(int(traffic["warmup_frames"])):
        r.frame(poses[k % len(poses)])
        k += 1
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    kept, enqueue_ms, marks, host_ms = [], [], [], []
    t0 = time.perf_counter()
    while True:
        pose_i, fi = k % len(poses), r.frame_index
        if cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        h0 = time.perf_counter()
        img = r.frame(poses[pose_i])
        enqueue_ms.append((time.perf_counter() - h0) * 1e3)
        if cuda:
            e1.record()
            marks.append((e0, e1))
        kept.append((pose_i, fi, img.reshape(-1, 3).index_select(0, px)))
        sync(device)
        t = time.perf_counter()
        host_ms.append((t - h0) * 1e3)
        k += 1
        if t - t0 >= seconds:
            break
    window_s = t - t0
    frame_ms = [a.elapsed_time(b) for a, b in marks] if cuda else host_ms
    found_banned = banned_modules()
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    data = SimpleNamespace(
        seed=seed, seconds=seconds, pixels=n_px, frames=len(kept), window_s=window_s,
        frame_ms=frame_ms, enqueue_ms=enqueue_ms, setup_s=setup_s, build_s=r.build_s, timeline=None,
        trace_calls=None, hand_kernels=import_module(f"{PACKAGE}.profiling").HAND_TRACE_KERNELS,
        peaks=roofline.peaks(torch.cuda.get_device_name(device)) if cuda else None)
    if trace:
        data.timeline, data.trace_calls = traced_frames(r, poses, k, int(traffic["trace_frames"]),
                                                        device)
        metrics = read_metrics(metrics_of(spec, workload, "per_layer"), data, log)
    else:
        metrics = read_metrics(metrics_of(spec, workload, "end_to_end"), data, log)

    # the program's state goes before the reference runs
    data.trace_calls = None
    r.close()
    del r, img
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    chosen = checks.pick_frames(rng_frames, len(kept), int(traffic["check"]["frames"]))
    prog = torch.stack([kept[i][2] for i in chosen]).float().cpu()
    frames = [(poses[kept[i][0]], kept[i][1]) for i in chosen]
    kept.clear()
    reference = import_module(f"benchmark.reference.{config['renderer']}")
    limits = checks.load_limits(workload, root)
    t_ref = time.perf_counter()
    ref = reference.values(config, traffic, scene, frames, px, device, torch.float32).cpu()
    log(f"reference: {len(frames)} frames x {px.shape[0]} pixels in "
        f"{time.perf_counter() - t_ref:.2f} s")
    found = checks.numbers(prog, ref, limits["pixel_rtol"])
    correct, compared = checks.judge(found, limits["limits"])
    failed = sum(not checks.judge(checks.numbers(prog[i:i + 1], ref[i:i + 1],
                                                 limits["pixel_rtol"]), limits["limits"])[0]
                 for i in range(len(chosen)))

    result = {"correct": bool(correct), "attempted": len(data.frame_ms), "failed": int(failed),
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": peak,
                         "power_limit": power_limit() if cuda else None}}
    if trace:
        result["device"]["busy_s"] = data.timeline.busy_s
        result["device"]["window_s"] = data.timeline.window_s
        result["breakdown"] = data.timeline.breakdown()
    if control:
        low = reference.values(config, traffic, scene, frames, px, device,
                               CONTROL[config["precision"]]).cpu()
        result["control"] = checks.numbers(low, ref, limits["pixel_rtol"])
    result["check"] = compared
    found_banned = sorted(set(found_banned) | set(banned_modules()))
    if found_banned:
        raise ImportError(f"the run loaded {', '.join(found_banned)}")
    return result
