#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and ends the run with a nonzero exit code):
  1. the card's name and power limit (nvidia-smi);
  2. build the native BVH library and the two CUDA kernels (BVH traversal,
     voxel scatter-max) from the repository's sources into build/, the three
     compilers started together;
  3. build the 2.8M-triangle atrium with the benchmark's build settings,
     lights and camera (SceneDatabase.build on the card);
  4. trace the main path's ray batches (1920x1080 primary rays; shadow rays
     from their hit points) with each kernel and with its plain PyTorch
     version, compare and time both;
  5. path-traced frame: render through PathTracer at 1920x1080, depth 2, ray
     sorting on, Russian roulette off: one warm-up frame, then timed frames
     with the kernels' launch counts reset just before; check the image, and
     check a small render on the card against the same render on the CPU;
  6. scatter-max: the voxelizer's real updates of the atrium at 256^3
     through the kernel and its plain version, bf16 on and off, compared
     for equality and timed beside `scatter_reduce_`; the grid's zero fill
     and the kernel's launch also timed apart;
  7. deferred frame: render through DeferredPipeline at 1920x1080 with
     SSAO, TAA, bloom, ray-traced shadows and VXGI at 256^3: one warm-up
     frame, then timed frames with every launch count reset just before;
     check the image; hold each trace kernel against its plain version on
     the rays of one more frame (G-buffer primaries, the voxelizer's and
     the lighting's shadow rays); profile one frame (device time of each
     pass, kernel launches, device busy share); check a small deferred
     render on the card against the CPU's;
  8. print the kernels' JSON line, then the result line.

The script imports nothing of JAX. Without a CUDA card it exits nonzero
before printing any result.
"""
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

TRIS = 2_800_000
WIDTH, HEIGHT, DEPTH = 1920, 1080, 2
TIMED_FRAMES = 4
BUILD = dict(max_leaf_triangle_count=12, traversal_cost=4.0, presplit_factor=0.0)
LIGHTS = [([0.0, 10.5, 0.0], [40.0, 38.0, 35.0], 0.8), ([6.0, 4.0, -20.0], [20.0, 10.0, 5.0], 0.5)]
CAMERA = dict(position=(0.0, 3.0, 24.0), yaw=-90.0, fov_y=65.0)
# kernel vs plain: slots equal on at least this share of rays (the rest are
# ties: two triangles at one t, met in another order); t, u, v bit-equal
# where the slots are equal (both built without FMA contraction, same
# operation order); occlusion equal on at least this share
AGREE = 0.999
KERNEL_SOURCE = "idkengine_tpu_torch/csrc/trace.cu"
TPU_KERNELS = {  # file:line of the Pallas kernels the CUDA kernel replaces
    "replaces": "idkengine_tpu/ops/packet_trace.py:979",  # K1 _make_kernel
    "also_replaces": "idkengine_tpu/ops/packet_trace.py:1531",  # K2 _make_kernel_steered_loop
}
SCATTER = {"route": "cuda", "source": "idkengine_tpu_torch/csrc/voxel_scatter.cu",
           "replaces": "idkengine_tpu/ops/voxel_scatter.py:73"}  # K3 _make_kernel
SMALL_RMSE = 1e-3  # card vs CPU render of a small atrium (golden contract)
VXGI_RES = 256  # bench.py:255's record and the reference's default
DEFERRED_FRAMES = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
HAND_KERNELS = ("trace_kernel", "scatter_max_kernel")  # __global__ names in csrc/


def log(msg):
    print(msg, flush=True)


def cuda_time_ms(fn, reps):
    """Mean device time of fn() over reps launches, after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    card = out.strip().splitlines()[0]
    log(card)
    return card


def phase_build():
    from idkengine_tpu_torch.bvh import builder
    from idkengine_tpu_torch.ops import packet_trace, voxel_scatter

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        bvh = pool.submit(builder.build_library)
        cuda = [pool.submit(m.build_kernels) for m in (packet_trace, voxel_scatter)]
        bvh.result()
        ptxas = "".join(f.result()[1] for f in cuda)
    log(f"# build (BVH library, trace and scatter-max kernels; the three compilers "
        f"started together): {time.perf_counter() - t0:.1f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"#   {line.strip()}")


def phase_scene(dev):
    import numpy as np

    from idkengine_tpu_torch.bvh.builder import BuildSettings
    from idkengine_tpu_torch.render import Camera
    from idkengine_tpu_torch.scene.procedural import atrium
    from idkengine_tpu_torch.scene.scene_db import SceneDatabase

    t0 = time.perf_counter()
    model = atrium(TRIS)
    t1 = time.perf_counter()
    db = SceneDatabase(BuildSettings(**BUILD))
    db.add_model(model)
    scene = db.build(dev)
    torch_sync(dev)
    t2 = time.perf_counter()
    for pos, rad, r in LIGHTS:
        db.lights.add(pos, rad, radius=r)
    cam = Camera(position=np.array(CAMERA["position"], np.float32), yaw=CAMERA["yaw"],
                 fov_y=CAMERA["fov_y"])
    m = db.meta
    log(f"# scene: atrium {m.n_triangles} tris, {m.n_nodes} nodes, depth {m.max_depth}, "
        f"SAH {m.sah_cost:.1f}; model {t1 - t0:.1f} s, build {t2 - t1:.1f} s "
        f"(BLAS {m.build_ms / 1e3:.1f} s)")
    return db, scene, cam


def torch_sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def compare_trace(kind, scene, o, d, t_max, reps=10):
    """One trace kernel ("trace_closest" or "trace_any") against its plain
    version on one ray batch; raises where they disagree. Returns the
    kernel's result, its numbers for the kernels' JSON line, and the share
    of rays on which both agree."""
    import torch

    from idkengine_tpu_torch.ops import packet_trace as kern
    from idkengine_tpu_torch.ops import trace as plain

    r = o.shape[0]
    got = getattr(kern, kind)(scene, o, d, t_max)
    t0 = time.perf_counter()
    want = getattr(plain, kind)(scene, o, d, t_max)
    torch_sync(o.device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    if kind == "trace_closest":
        same = got.slot == want.slot
        agree = same.float().mean().item()
        for k in ("t", "u", "v"):
            if not torch.equal(getattr(got, k)[same], getattr(want, k)[same]):
                raise AssertionError(f"trace_closest: {k} differs from the plain version")
        if not torch.equal(got.slot >= 0, want.slot >= 0) or agree < AGREE:
            raise AssertionError(f"trace_closest: slot agreement {agree:.6f} < {AGREE}")
        hit = (got.slot >= 0) & (want.slot >= 0)
        err = torch.where(hit, got.t - want.t, 0.0).abs().max().item()
        out_bytes = 16  # t, slot, u, v
    else:
        agree = (got == want).float().mean().item()
        if agree < AGREE:
            raise AssertionError(f"trace_any: agreement {agree:.6f} < {AGREE}")
        err = (got.float() - want.float()).abs().max().item()
        out_bytes = 1
    ms = cuda_time_ms(lambda: getattr(kern, kind)(scene, o, d, t_max), reps)
    scene_bytes = scene.bvh_nodes.numel() * 4 + 3 * scene.tri_p0.numel() * 4
    # rays (o, d, t_max) read once, results written once, the node and
    # triangle tables read once
    ray_bytes = r * 24 + torch.as_tensor(t_max).numel() * 4
    bound_ms = (ray_bytes + r * out_bytes + scene_bytes) / HBM_BYTES_PER_S * 1e3
    return got, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by="bytes", library_ms=None), agree


def phase_compare(scene, cam, dev):
    """Each kernel vs its plain version on the path tracer's ray batches."""
    import torch

    from idkengine_tpu_torch.render.camera import generate_rays
    from idkengine_tpu_torch.utils import rng

    r = WIDTH * HEIGHT
    state = rng.init_state(torch.arange(r, device=dev), 0)
    state, u_pix = rng.uniform2(state)
    state, u_lens = rng.uniform2(state)
    o, d = generate_rays(cam.ray_params(WIDTH, HEIGHT), WIDTH, HEIGHT, u_pix, u_lens)
    t_max = torch.full((r,), 3.4e38, device=dev)
    results = {}

    got, m, agree = compare_trace("trace_closest", scene, o, d, t_max)
    results["trace_closest"] = m
    log(f"# trace_closest, {r} primary rays: kernel {m['ms']:.3f} ms "
        f"(bound {m['bound_ms']:.3f} ms), plain {m['plain_ms']:.1f} ms; "
        f"hits {(got.slot >= 0).float().mean().item():.4f}, slot agreement {agree:.6f}, "
        f"max |dt| {m['max_abs_err']:g}")

    # shadow-like rays: from the primary hits, in random directions, up to 5
    # units; primary misses become dead rays, as NEE makes them
    g = torch.Generator(device=dev).manual_seed(0)
    sd = torch.randn((r, 3), generator=g, device=dev)
    sd = (sd / torch.linalg.vector_norm(sd, dim=-1, keepdim=True)).contiguous()
    hp = o + d * torch.where(got.slot >= 0, got.t, 0.0)[:, None]
    so = (hp - d * 1e-3).contiguous()
    s_tmax = torch.where(got.slot >= 0, 5.0, -1.0)
    occ, m, agree = compare_trace("trace_any", scene, so, sd, s_tmax)
    results["trace_any"] = m
    log(f"# trace_any, {r} shadow rays: kernel {m['ms']:.3f} ms "
        f"(bound {m['bound_ms']:.3f} ms), plain {m['plain_ms']:.1f} ms; "
        f"occluded {occ.float().mean().item():.4f}, agreement {agree:.6f}")
    return results


def reset_all_launch_counts():
    from idkengine_tpu_torch.ops import packet_trace, voxel_scatter

    packet_trace.reset_launch_counts()
    voxel_scatter.reset_launch_counts()


def read_launch_counts():
    from idkengine_tpu_torch.ops import packet_trace, voxel_scatter

    return {"trace_closest": packet_trace.trace_closest.launches,
            "trace_any": packet_trace.trace_any.launches,
            "scatter_max_dense": voxel_scatter.scatter_max_dense.launches}


def phase_frame(db, scene, cam, dev, card):
    import torch

    from idkengine_tpu_torch.render import PathTracer, PathTracerSettings
    from idkengine_tpu_torch.render.tonemap import tonemap

    settings = PathTracerSettings(ray_depth=DEPTH, russian_roulette=False,
                                  do_ray_sorting=True, sky_strength=1.0)
    t0 = time.perf_counter()
    pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), WIDTH, HEIGHT, settings,
                    device=dev)
    pt.render_frame(cam)  # warm-up
    torch_sync(dev)
    log(f"# tracer init + warm-up frame {time.perf_counter() - t0:.2f} s")

    reset_all_launch_counts()
    rays = 0.0
    t0 = time.perf_counter()
    for _ in range(TIMED_FRAMES):
        img = pt.render_frame(cam)
        rays += float(pt.last_rays_traced)
    torch_sync(dev)
    dt = time.perf_counter() - t0
    launches = read_launch_counts()
    log(f"# frame: {dt / TIMED_FRAMES * 1e3:.2f} ms/frame, {rays / dt / 1e6:.2f} Mrays/s "
        f"({rays / TIMED_FRAMES / 1e6:.3f} Mrays/frame), {WIDTH}x{HEIGHT} depth {DEPTH}, "
        f"{TRIS // 1000}k-tri atrium, on {card}; launches {launches}")
    for name in ("trace_closest", "trace_any"):
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched on the path-traced frame")

    out = tonemap(img)
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("image is not a finite (H,W,3) array")
    if not (img.max().item() > 0 and img.std().item() > 0):
        raise AssertionError("image is black or flat")
    if not (0.0 <= out.min().item() and out.max().item() <= 1.0):
        raise AssertionError("tonemapped image leaves [0,1]")
    log(f"# image: mean {img.mean().item():.5f}, std {img.std().item():.5f}, "
        f"tonemapped mean {out.mean().item():.5f}")
    return launches


def phase_small_reference(dev):
    """A small atrium rendered on the card and on the CPU must agree."""
    import numpy as np

    from idkengine_tpu_torch.bvh.builder import BuildSettings
    from idkengine_tpu_torch.render import Camera, PathTracer, PathTracerSettings
    from idkengine_tpu_torch.scene.procedural import atrium
    from idkengine_tpu_torch.scene.scene_db import SceneDatabase

    cam = Camera(position=np.array(CAMERA["position"], np.float32), yaw=CAMERA["yaw"],
                 fov_y=CAMERA["fov_y"])
    settings = PathTracerSettings(ray_depth=DEPTH, russian_roulette=False, do_ray_sorting=True)
    imgs = []
    for device in (dev, "cpu"):
        db = SceneDatabase(BuildSettings(**BUILD))
        db.add_model(atrium(8000))
        scene = db.build(device)
        for pos, rad, r in LIGHTS:
            db.lights.add(pos, rad, radius=r)
        pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), 96, 54, settings,
                        device=device)
        imgs.append(pt.render_frame(cam).cpu().numpy())
    rmse = float(np.sqrt(np.mean((imgs[0] - imgs[1]) ** 2)))
    log(f"# small atrium 96x54: card vs CPU RMSE {rmse:.3g} (limit {SMALL_RMSE})")
    if not rmse <= SMALL_RMSE:
        raise AssertionError("card render disagrees with the CPU render")


def _deferred_settings(res):
    from idkengine_tpu_torch.render import DeferredSettings2
    from idkengine_tpu_torch.render.vxgi import VxgiSettings

    # DeferredSettings2 defaults: SSAO, TAA and bloom on, ray-traced shadows
    return DeferredSettings2(use_vxgi=True, vxgi=VxgiSettings(resolution=res))


def _lights(db, dev):
    import torch

    soa = db.lights.soa()
    return {k: torch.as_tensor(soa[k], device=dev) for k in ("pos", "radius", "radiance")}


def phase_compare_scatter(db, scene, pipe, dev):
    """The scatter kernel vs its plain version on the voxelizer's updates."""
    import torch

    from idkengine_tpu_torch.ops import packet_trace as kern
    from idkengine_tpu_torch.ops import voxel_scatter as vs

    cell, vals = pipe.voxel_grid.updates(scene, pipe.mats, _lights(db, dev),
                                         len(db.lights.lights), frame=0,
                                         occlusion_fn=partial(kern.trace_any, scene))
    n_cells = VXGI_RES ** 3
    err = 0.0
    for bf16 in (False, True):
        got = vs.scatter_max_dense(cell, vals, n_cells, bf16=bf16)
        want = vs.scatter_max_dense_plain(cell, vals, n_cells, bf16)
        err = max(err, (got - want).abs().max().item())
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"scatter_max_dense (bf16={bf16}) differs from the plain "
                                 f"version in {bad} cells")
    per_cell = torch.bincount(cell.long(), minlength=n_cells)
    ms = cuda_time_ms(lambda: vs.scatter_max_dense(cell, vals, n_cells, bf16=True), 20)
    ms_f32 = cuda_time_ms(lambda: vs.scatter_max_dense(cell, vals, n_cells), 20)
    # the wrapper's two parts apart: the zero fill of the dense grid, and the
    # kernel's launch alone on a grid zeroed outside the timed span
    shape = (vals.shape[0], n_cells)
    fill_ms = cuda_time_ms(lambda: torch.zeros(shape, device=dev), 20)
    grid, spans = torch.zeros(shape, device=dev), []
    for _ in range(21):
        grid.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        vs._launch(cell, vals, grid, True)
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    launch_ms = sum(s.elapsed_time(e) for s, e in spans[1:]) / 20  # the first warms up
    plain_ms = cuda_time_ms(lambda: vs.scatter_max_dense_plain(cell, vals, n_cells, True), 5)
    index = cell.long().expand(vals.shape[0], -1).contiguous()
    library_ms = cuda_time_ms(lambda: torch.zeros((vals.shape[0], n_cells), device=dev)
                              .scatter_reduce_(1, index, vals, "amax"), 20)
    # updates (cell, vals) read once, the dense grid written once
    nbytes = cell.numel() * 4 + vals.numel() * 4 + vals.shape[0] * n_cells * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"# scatter_max_dense, {cell.numel()} updates x {vals.shape[0]} channels into "
        f"{VXGI_RES}^3 cells ({(per_cell > 0).sum().item()} cells hit, at most "
        f"{per_cell.max().item()} updates in one): kernel bf16 {ms:.4f} ms (zero fill alone "
        f"{fill_ms:.4f} ms, launch alone {launch_ms:.4f} ms), f32 {ms_f32:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB), plain bf16 {plain_ms:.4f} ms, "
        f"scatter_reduce_ amax (f32) {library_ms:.4f} ms; equal to the plain version, "
        f"bf16 on and off (max |diff| {err:g})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=library_ms)


def phase_deferred_frame(pipe, cam, dev, card):
    import torch

    t0 = time.perf_counter()
    pipe.render_frame(cam)  # warm-up (also builds the sample assignment, once per scene)
    torch_sync(dev)
    log(f"# deferred warm-up frame {time.perf_counter() - t0:.2f} s")

    reset_all_launch_counts()
    t0 = time.perf_counter()
    for _ in range(DEFERRED_FRAMES):
        out = pipe.render_frame(cam)
    torch_sync(dev)
    dt = time.perf_counter() - t0
    launches = read_launch_counts()
    log(f"# deferred frame: {dt / DEFERRED_FRAMES * 1e3:.2f} ms/frame, {WIDTH}x{HEIGHT}, "
        f"SSAO+TAA+bloom, ray-traced shadows, VXGI {VXGI_RES}^3, {TRIS // 1000}k-tri atrium, "
        f"on {card}; launches in {DEFERRED_FRAMES} frames {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched on the deferred frame")
    if tuple(out.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError("deferred image is not a finite (H,W,3) array")
    if not (0.0 <= out.min().item() and out.max().item() <= 1.0):
        raise AssertionError("deferred image leaves [0,1]")
    if not out.std().item() > 0.01:
        raise AssertionError("deferred image is flat")
    log(f"# deferred image: mean {out.mean().item():.5f}, std {out.std().item():.5f}")
    return launches


def phase_compare_deferred_traces(pipe, cam, results):
    """Each trace kernel against its plain version on the rays of one
    deferred frame, in the order the frame traces them: the voxelizer's
    shadow rays, the G-buffer's primaries, the lighting's shadow rays
    toward the lights. The frame's calls are recorded by standing in for
    the pipeline's trace functions for that one frame."""
    from idkengine_tpu_torch.render import pipeline as pipeline_mod

    calls = []

    def recording(kind):
        fn = getattr(pipeline_mod, kind)

        def run(scene, o, d, t_max):
            calls.append((kind, scene, o, d, t_max))
            return fn(scene, o, d, t_max)
        return run

    saved = pipeline_mod.trace_closest, pipeline_mod.trace_any
    pipeline_mod.trace_closest, pipeline_mod.trace_any = (recording("trace_closest"),
                                                          recording("trace_any"))
    try:
        pipe.render_frame(cam)
    finally:
        pipeline_mod.trace_closest, pipeline_mod.trace_any = saved
    for kind, scene, o, d, t_max in calls:
        _, m, agree = compare_trace(kind, scene, o, d, t_max, reps=5)
        log(f"# deferred frame's {kind}, {o.shape[0]} rays: kernel {m['ms']:.3f} ms "
            f"(bound {m['bound_ms']:.3f} ms), plain {m['plain_ms']:.1f} ms; "
            f"agreement {agree:.6f}, max |diff| {m['max_abs_err']:g}")
        entry = results[kind]
        entry["max_abs_err"] = max(entry["max_abs_err"], m["max_abs_err"])
        entry.setdefault("deferred_frame_calls", []).append(
            dict(rays=o.shape[0], agreement=agree, max_abs_err=m["max_abs_err"], ms=m["ms"],
                 plain_ms=m["plain_ms"], bound_ms=m["bound_ms"]))
    for kind in ("trace_closest", "trace_any"):
        if kind not in {c[0] for c in calls}:
            raise AssertionError(f"the deferred frame made no {kind} call")


def phase_deferred_profile(pipe, cam):
    """One deferred frame under torch.profiler: the device time of each pass
    (the pipeline's named ranges), kernel launches, device busy time against
    the frame's wall time, and the kernels that take most.

    The profiler gives a pass the kernels of the PyTorch ops inside it; the
    hand kernels, launched through ctypes outside any op, join no pass and
    are listed apart. Where the profiler also traces a pass's span on the
    device (from its first to its last kernel, the hand kernels and idle
    gaps included), that span is printed beside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.render_frame(cam)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == cuda and not e.key.startswith("deferred/")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    if busy_ms <= 0:
        log(f"# deferred frame under the profiler: {wall_ms:.2f} ms wall; device time not traced")
        return
    log(f"# deferred frame under the profiler: {wall_ms:.2f} ms wall, {launches} device "
        f"kernels, device busy {busy_ms:.2f} ms ({(1 - busy_ms / wall_ms) * 100:.1f}% idle); "
        f"each pass's PyTorch-op kernels (device span, host time):")
    spans = {e.key: e.device_time_total / 1e3 for e in events
             if e.key.startswith("deferred/") and e.device_type == cuda}
    for e in events:
        if e.key.startswith("deferred/") and e.device_type == cpu:
            span = spans.get(e.key)
            log(f"#   {e.key[len('deferred/'):]}: {e.device_time_total / 1e3:.2f} ms "
                f"({e.device_time_total / 1e3 / busy_ms * 100:.1f}% of busy; span "
                f"{'not traced' if span is None else f'{span:.2f} ms'}, "
                f"host {e.cpu_time_total / 1e3:.2f} ms)")
    for e in kernels:
        if any(name in e.key for name in HAND_KERNELS):
            log(f"#   hand kernel, in no pass: {e.self_device_time_total / 1e3:.2f} ms in "
                f"{e.count} launches: {e.key[:60]}")
    log("# most device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"#   {e.self_device_time_total / 1e3:.2f} ms in {e.count} launches: {e.key[:90]}")


def phase_small_deferred(dev):
    """A small deferred render on the card against the same render on the CPU."""
    import numpy as np

    from idkengine_tpu_torch.bvh.builder import BuildSettings
    from idkengine_tpu_torch.render import Camera, DeferredPipeline
    from idkengine_tpu_torch.scene.procedural import atrium
    from idkengine_tpu_torch.scene.scene_db import SceneDatabase

    cam = Camera(position=np.array(CAMERA["position"], np.float32), yaw=CAMERA["yaw"],
                 fov_y=CAMERA["fov_y"])
    imgs = []
    for device in (dev, "cpu"):
        db = SceneDatabase(BuildSettings(**BUILD))
        db.add_model(atrium(8000))
        db.build(device)
        for pos, rad, r in LIGHTS:
            db.lights.add(pos, rad, radius=r)
        pipe = DeferredPipeline(db, 96, 54, _deferred_settings(32), device=device)
        for _ in range(2):  # the second frame reads the TAA history
            img = pipe.render_frame(cam)
        imgs.append(img.cpu().numpy())
    rmse = float(np.sqrt(np.mean((imgs[0] - imgs[1]) ** 2)))
    log(f"# small deferred atrium 96x54, VXGI 32^3, 2 frames: card vs CPU RMSE {rmse:.3g} "
        f"(limit {SMALL_RMSE})")
    if not rmse <= SMALL_RMSE:
        raise AssertionError("card deferred render disagrees with the CPU render")


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    import idkengine_tpu_torch  # noqa: F401  (fails outside a checkout)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = phase_card()
    phase_build()
    db, scene, cam = phase_scene(dev)
    timings = phase_compare(scene, cam, dev)
    launches_pt = phase_frame(db, scene, cam, dev, card)
    phase_small_reference(dev)

    from idkengine_tpu_torch.render import DeferredPipeline

    pipe = DeferredPipeline(db, WIDTH, HEIGHT, _deferred_settings(VXGI_RES), device=dev)
    timings["scatter_max_dense"] = phase_compare_scatter(db, scene, pipe, dev)
    launches_def = phase_deferred_frame(pipe, cam, dev, card)
    phase_compare_deferred_traces(pipe, cam, timings)
    phase_deferred_profile(pipe, cam)
    phase_small_deferred(dev)

    kernels = []
    for name in ("trace_closest", "trace_any", "scatter_max_dense"):
        where = (dict(route="cuda", source=KERNEL_SOURCE, **TPU_KERNELS)
                 if name.startswith("trace") else SCATTER)
        by_path = {"pathtracer": launches_pt[name], "deferred": launches_def[name]}
        kernels.append(dict(name=name, **where, launches=sum(by_path.values()),
                            launches_by_path=by_path, **timings[name]))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
