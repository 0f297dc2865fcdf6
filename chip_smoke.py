#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and ends the run with a nonzero exit code):
  1. the card's name and power limit (nvidia-smi);
  2. build the native BVH library and the eight CUDA libraries (BVH
     traversal, two-phase traversal, voxel scatter-max, the five probes)
     from the repository's sources into build/, the nine compilers started
     together;
  3. build the 2.8M-triangle atrium with the benchmark's build settings,
     lights and camera (SceneDatabase.build on the card); the trace
     kernel's 4-wide table: size, depth, build time, stack; the steps
     kernel's threaded records: size, build time; the leaf bits; the
     build's device flatten against the host flatten, bit-equal on every
     field, each timed, the bytes each puts on the card, the build's
     seconds through each; EPO's value and time (phase_flatten);
  4. trace the path-traced frame's ray batches (1920x1080 primary rays;
     shadow rays from their hit points; the frame's first bounce batch)
     with each kernel and with its plain PyTorch version, compare and time
     both; each batch's bound and binary-tree steps per ray (mean, p99,
     max; rays from the sky pixels' far points apart);
  5. path-traced frame: render through PathTracer at 1920x1080, depth 2, ray
     sorting on, Russian roulette off: one warm-up frame, then timed frames
     with the kernels' launch counts reset just before; check the image;
     one more frame under the profiler, its hand trace kernels bucketed by
     the call site that launched them as the JAX package buckets its
     tagged kernels (primary, bounce_closest and nee above 0; with
     trace_other within 1% of the hand trace kernels' device time); check
     a small render on the card against the same render on the CPU;
  6. scatter-max: the voxelizer's real updates of the atrium at 256^3
     through the kernel and its plain version, bf16 on and off, compared
     for equality and timed beside `scatter_reduce_`; the grid's zero fill
     and the kernel's launch also timed apart;
  7. deferred frame: render through DeferredPipeline at 1920x1080 with
     SSAO, TAA, bloom, ray-traced shadows and VXGI at 256^3: one warm-up
     frame, then timed frames with every launch count reset just before;
     check the image; hold each trace kernel against its plain version on
     the rays of one more frame (G-buffer primaries, the voxelizer's and
     the lighting's shadow rays), with each call's time, bound and steps
     per ray; profile one frame (device time of each
     pass, kernel launches, device busy share; its untagged traces, any-hit
     shadow rays included, in trace_other as the JAX package's); check a
     small deferred render on the card against the CPU's;
  8. two-phase traversal on the main path's ray batches (phase 4's
     primaries and shadow rays, one bounce batch of the path-traced frame):
     phase A and phase B kernels against their plain versions, the
     two-phase traces against the one-phase kernels; times, overflow share,
     wanted leaves per ray;
  9. path-tracer pipeline frame (accumulate, à-trous denoise, bloom, AgX
     tonemap) through PathTracerPipeline at 1920x1080, one-phase and
     two-phase: warm-up to 32 samples, then timed frames that each denoise
     with the launch counts reset just before; the two accumulations
     compared; one frame of each profiled per pass;
 10. the denoiser record of the reference benchmark: 256x256, 8 spp
     denoised against a 256-spp accumulation, RMSE ratios;
 11. traversal-cost debug view at 1920x1080: the steps kernel against the
     plain stackless trace on the view's primaries;
 12. a small two-phase pipeline render on the card against the CPU's;
 13. probes: the TPU microbenchmarks' ports (idkengine_tpu_torch/tools/,
     P1-P6) through their mains at the tools' default sizes, each variant's
     device time and clock64 cycles per step with the launch counts reset
     just before; every variant's one-SM bound restated from the
     instructions its function needs (each tool's needed_cycles_per_step)
     and, where its step holds no inner loop, from its SASS
     (tools/sass_count.py) beside its time; then each kernel against its plain
     version at a reduced step count (outputs and chain state);
 14. textured frame: the 2.8M atrium with the material model of a real
     asset (scene/procedural.texture_atrium, made from --seed: textures,
     a normal map, alpha-tested and blended cloth, per-mesh overrides)
     under an env map from compute_atmosphere at 1024x512, written as flat
     RGBE and read back through load_hdr; PathTracer at 1920x1080, depth 2,
     sorting on, roulette off, env map and env NEE on: one warm-up frame,
     then timed frames beside phase 5's factor-only frame, the launches per
     frame, one frame under the profiler (the primaries' alpha re-traces
     in primary, the env shadow rays' any-hit tails in nee); the trace
     calls of one frame, with the call-site tags the JAX package gives them,
     each timed through its kernel by what it traces (closest hits, alpha
     re-traces, NEE and env-NEE rounds and tails), and the kernels against
     their plain versions on the first alpha re-trace batch and the env-NEE
     shadow batches; one timed deferred frame of the textured scene with
     its per-mesh overrides; a small textured, alpha-tested, env-lit render
     on the card against the CPU's;
 15. the capped kernels (trace_capped_kernel: the JAX package's traces with
     a step cap) against their plain versions on phase 4's batches, at a
     cap that stops most primaries early and at one above every batch's
     p99 steps, t, slot, u, v and occlusion equal on every ray: times,
     bounds at the steps taken, the share of rays the cap stopped, the lane
     utilization of a ray a thread (what a per-lane ray refill could gain);
     the steps kernel with the same caps (trace_closest_steps with
     max_steps) on the primaries, steps and hits equal on every ray, timed
     beside the uncapped steps kernel;
 16. path-traced frames (phase 5's settings) with max_trace_steps at each
     of phase 15's caps and with tile_size = 1920*1080/8, timed with the
     launch counts reset just before; the tiled accumulation bit-equal to
     phase 5's untiled one;
 17. the deferred frame's optional passes at full width on phase 14's
     textured scene (its blended cloth for OIT to peel): phase 7's settings
     alone, with each pass on alone (SSR, volumetric light, OIT, the rate
     classifier, PCF cube maps with the map-building first frame apart,
     render_scale=2 with TAAU), with SSR, volumetric light, OIT and the
     classifier all on; warm frames timed with the counts reset just
     before, each pass's launches a frame beside the base's; one frame of
     each setting under the profiler;
 18. each new pass, and the path-tracer pipeline with the adaptive bounce
     budget, rendered small on the card and on the CPU;
     phases 19 and 20 share one database: phase 3's atrium added unhoisted,
     its root node animated (a LINEAR translation and a turn about y of at
     most DYN_TURN degrees, which move every vertex), beside
     INSTANCE_COUNT instances of a 65k-triangle sphere with a BLAS of its
     own (transforms from --seed: scale 0.5-1.5, a turn about y, in front
     of the camera);
 19. dynamics at full width: update_device at two times, each checked
     against the C++ host refit of the vertices it made (boxes bit for bit
     in the threaded arrays and in the binary, threaded and 4-wide records,
     the 4-wide ones through bvh4_child; topology words unchanged; tri_vec
     the slot triangles) and against the host update at the same time
     (UPDATE_TOL); warm CUDA-event times of update_device in parts
     (transform, level sweeps, record refresh), of the host update (with
     the device flatten, and with the host flatten after it) and of
     linear-blend skinning over the atrium's vertices (4 of 64 joints a
     vertex, from --seed); on the refitted scene the primaries' kernel
     trace against the plain trace, and a path-traced frame at phase 5's
     settings timed beside phase 5's;
 20. the instanced frame at full width: its primaries, shadow rays and
     first bounce batch through the fused two-level kernel (one launch a
     call), bit-equal on every ray (t, slot, u, v, the instance id;
     occlusion) to the launch loop over the one-level kernels (1 + 16
     launches a call, ops/trace.py:two_level_closest / two_level_any), both
     timed in turns, and against the plain two-level path: t, slot, u, v,
     the instance id and occlusion under phase 4's rule (the same hit mask,
     slot and instance equal on AGREE of the rays, t, u, v bit-equal there:
     the trace kernel visits near children first, so a hit whose t falls
     below its box's entry distance can be culled there and kept by the
     plain DFS walk), and at CAP_LOW (the capped walk, the plain walk's
     order) equal on every ray; the share of primaries on an instance;
     PathTracer(instances=...) at 1920x1080, depth 2, sorting on, roulette
     off: warm-up, timed frames with the counts reset just before,
     launches a frame (DEPTH closest and DEPTH any-hit two-level launches,
     no one-level launch), one profiled frame, with no copy or synchronize
     inside a two-level call's range; the same frame once at
     max_trace_steps = CAP_LOW; set_instance_transform moves instance 0 out
     of view (its id leaves the primaries, no BLAS is rebuilt, the TLAS
     is); a small instanced scene (the Cornell box and two spheres, 48x48)
     on the card against the CPU;
 21. the app: the textured, animated atrium of phases 14 and 19 (2.8M
     triangles, its six textures as zlib-supercompressed RGBA8 KTX2) written
     as a .glb by write_glb; load_gltf(optimize=False) must give back the
     model bit for bit; load_gltf with deferred textures and the meshopt
     pass, SceneDatabase.build, phase 14's overrides (seconds of each);
     Engine at 1920x1080 with phase 14's tracer settings and env map: frames
     while AsyncTextureLoader's decodes land in the tracer's atlas, then one
     sample held against phase 14's first frame (RMSE <= SMALL_RMSE; the
     meshopt order builds another tree), the trace calls of one Engine frame
     against the plain trace (phase 4's rule), run_headless timed with the
     counts reset just before, one frame profiled; Engine.update to
     DYN_TIMES through update_device (each call's ms); the camera pushed
     into the floor and into a wall with camera_collision (it must end at
     least its radius from the surface, by intersect_ray); a physics light
     dropped; set_mode(RASTERIZER): the deferred frame with VXGI 256^3
     timed, its trace calls and scatter-max call against their plain
     versions, one frame profiled; add_model_runtime of phase 20's sphere
     and a frame through the two-level kernel (one launch a call, the
     primaries against the launch loop and the plain two-level trace);
     pick_entity at five
     pixels against the card's primary hits; three recorded frames through
     save / load / replay; save_config / load_config; then a small Engine
     (an 8000-triangle atrium as glTF, 48x32) on the card against the CPU in
     both modes;
 22. sharding and sorting at full width (parallel/shard.py,
     ops/device_sort.py): phase 5's frame rendered through
     ShardedPathTracer over a mesh of the card listed SHARDS times, from
     the same start (phase 4's and 5's frames), equal to phase 5's image on
     every pixel; timed frames
     with the counts reset just before (SHARDS x phase 5's trace launches,
     path `sharded`), each shard's sample and the gather timed apart
     beside the unsharded sample, one sharded and one unsharded frame
     profiled; shard_packet_closest / shard_packet_any on phase 4's three
     batches bit-equal to the unsharded kernels; dryrun_multichip over the
     mesh (the 110k atrium with two instanced spheres at 256x256, then the
     sharded traces); PathTracerPipeline(shard_devices=-1) (wraps only with
     more than one card); radix_argsort and sort_rays_by_key on 1920x1080
     keys from --seed in the 18-bit domain against a stable torch.argsort,
     timed beside one torch.sort and the unsharded frame's `pt/sort`; the
     Cornell box at 64x64 over a mixed mesh [card, CPU] against the
     CPU-only render;
 23. print the kernels' JSON line, then the result line.

The script prints its wall time before the kernels' line. It imports
nothing of JAX. Without a CUDA card it exits nonzero before printing any
result. `--seed` (default 0) seeds the textured scene's textures, the
instances' transforms, the skinning's joints and phase 22's sort keys.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
# the card's rates and the CUDA-event timer (fails outside a checkout)
from idkengine_tpu_torch.tools._probe import F32_OPS_PER_S, HBM_BYTES_PER_S  # noqa: E402
from idkengine_tpu_torch.tools._probe import time_ms as cuda_time_ms  # noqa: E402

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
TRACE = {"route": "cuda", "source": "idkengine_tpu_torch/csrc/trace.cu",
         "replaces": "idkengine_tpu/ops/packet_trace.py:979",  # K1 _make_kernel
         "also_replaces": ["idkengine_tpu/ops/packet_trace.py:1531",  # K2 steer loop
                           "idkengine_tpu/ops/packet_trace.py:1416"]}  # K4 unrolled steer
KERNELS_WHERE = {  # route, source and the Pallas kernels each wrapper's kernel replaces
    "trace_closest": TRACE,
    "trace_any": TRACE,
    # K1 with debug_iters=True, from idkengine_tpu/render/debug_view.py:53
    "trace_closest_steps": {"route": "cuda", "source": "idkengine_tpu_torch/csrc/trace.cu",
                            "replaces": "idkengine_tpu/ops/packet_trace.py:979"},
    "scatter_max_dense": {"route": "cuda", "source": "idkengine_tpu_torch/csrc/voxel_scatter.cu",
                          "replaces": "idkengine_tpu/ops/voxel_scatter.py:73"},  # K3
    "two_phase_a": {"route": "cuda", "source": "idkengine_tpu_torch/csrc/two_phase.cu",
                    "replaces": "idkengine_tpu/ops/two_phase.py:223",  # K5a _make_kernel_a
                    "also_replaces": ["idkengine_tpu/ops/two_phase.py:256"]},  # K5b steered
    # phase B runs in XLA in the JAX package (no Pallas kernel); this is its code
    "two_phase_b": {"route": "cuda", "source": "idkengine_tpu_torch/csrc/two_phase.cu",
                    "replaces": "idkengine_tpu/ops/two_phase.py:400"},
    # the capped walks: the JAX package's XLA traces with max_steps (no Pallas kernel)
    "trace_closest_capped": {"route": "cuda", "source": "idkengine_tpu_torch/csrc/trace.cu",
                             "replaces": "idkengine_tpu/ops/trace.py:122"},
    "trace_any_capped": {"route": "cuda", "source": "idkengine_tpu_torch/csrc/trace.cu",
                         "replaces": "idkengine_tpu/ops/trace.py:279"},
    # the two-level traces: XLA loops in the JAX package (no Pallas kernel),
    # one launch of csrc/trace.cu's two_level_kernel (two_level_capped_kernel
    # with a cap) a call here
    "trace_closest_two_level": {"route": "cuda", "source": "idkengine_tpu_torch/csrc/trace.cu",
                                "replaces": "idkengine_tpu/ops/trace.py:177"},
    "trace_any_two_level": {"route": "cuda", "source": "idkengine_tpu_torch/csrc/trace.cu",
                            "replaces": "idkengine_tpu/ops/trace.py:227"},
}
CAP_LOW = 64  # phase 15's first cap: below most primaries' binary-tree steps
CAP_STEP = 64  # the second cap: the next multiple of this above every batch's p99
WARP = 32  # lanes a warp: a ray a lane in the capped and steps kernels
TILE_SPLIT = 8  # phase 16's tiles: the frame's rays in eight launches
PASS_FRAMES = 3  # phase 17's timed frames a setting
PLAIN_CHUNK = 1920 * 1080  # rays a plain trace takes at once (plain_in_chunks)
PASS_OF_CALLER = {  # the function of the frame graph a recorded trace call was made in
    "voxelize": "voxelize", "render_gbuffer": "G-buffer", "shade_deferred": "lighting",
    "build_point_shadow": "pcf build", "_composite_transparency": "oit",
    "volumetric_light": "volumetric"}
RECORD_PASSES = {  # phase 17: the first frame whose new passes' traces are compared
    "deferred_pcf": ("pcf build",), "deferred_all_on": ("oit", "volumetric")}
DEFERRED_PASSES = {  # phase 17 and 18: each new pass alone
    "ssr": dict(use_ssr=True), "volumetric": dict(use_volumetric=True),
    "oit": dict(use_oit=True), "classifier": dict(use_classifier=True),
    "pcf": dict(shadows="pcf"), "render_scale": dict(render_scale=2)}
ALL_ON = dict(use_ssr=True, use_volumetric=True, use_oit=True, use_classifier=True)
SMALL_RMSE = 1e-3  # card vs CPU render of a small atrium (golden contract)
FAR_ORIGIN = 1e6  # the G-buffer puts sky pixels at o + d * 1e8 (render/gbuffer.py)
VXGI_RES = 256  # bench.py:255's record and the reference's default
DEFERRED_FRAMES = 4
HAND_KERNELS = ("trace_kernel", "trace_steps_kernel", "trace_capped_kernel",  # __global__
                "two_level_kernel", "two_level_capped_kernel",  # names in csrc/
                "scatter_max_kernel", "phase_a_kernel", "phase_b_kernel",
                "probe_slab_kernel", "probe_vpu_kernel", "probe_form_kernel", "probe_reduce_kernel",
                "probe_dual_kernel", "probe_prims_kernel")
PT_PASSES = ("pt_sample", "denoise", "bloom", "tonemap")  # PathTracerPipeline's ranges
DENOISE_AT = 32  # PtPipelineSettings' default: frames from 32 samples on denoise
OVERFLOW_CHECK = 65_536  # overflow rays whose lists are checked against the full plain list
ENV_SIZE = (1024, 512)  # the textured frame's env map, width x height
# the trace calls of one textured bounce, in the order the tracer makes them
TEXTURED_CALLS = ("closest", "alpha re-trace 1", "alpha re-trace 2", "NEE round 1",
                  "NEE round 2", "NEE any-hit tail", "env-NEE round 1", "env-NEE round 2",
                  "env-NEE any-hit tail")
# their call-site tags at bounce 0 (pri becomes bnc after it), as the JAX
# package tags them (idkengine_tpu/render/pathtracer.py:725, 752, 764)
TEXTURED_TAGS = ("pri", "pria", "pria", "neea", "neea", "neea", "enva", "enva", "enva")
PT_RANGES = "pt/"  # PathTracer's profiler ranges (render/pathtracer.py)
# the JAX package's trace buckets (idkengine_tpu/profiling.py:90-114), and
# how far their sum may lie from the hand trace kernels' device time
TRACE_BUCKETS = ("primary", "bounce_closest", "nee", "trace_other")
BUCKET_SHARE = 0.01
DYN_TIMES = (0.5, 1.25)  # phase 19's animation times (keyframes at 0, 1, 2 s)
DYN_SHIFT = (0.6, 0.3, -0.4)  # the root's translation at 1 s, m
DYN_TURN = 5.0  # the root's turn about y at 1 s, degrees
UPDATE_TOL = dict(rtol=1e-5, atol=1e-4)  # host update vs update_device (tests/test_dynamic.py's)
DYN_REPS = 5  # warm timed calls of each part of update_device
INSTANCE_COUNT = 16
SPHERE_RES = dict(n_lat=128, n_lon=256)  # the instanced sphere: 65,024 triangles
SKIN_JOINTS = 64  # the skinning timing's joints, four a vertex
INSTANCED_SHARE = 0.01  # the least share of primaries on an instance
SHARDS = 4  # phase 22: shards of the sharded frame, all on the one card
SHARD_RMSE = 1e-5  # the dry run's bound, where a sharded image is not bit-equal
SORT_BITS = 18  # phase 22: the ray sort key's domain (ops/device_sort.py)
PROBE_CHECK_ITERS = 256  # steps of each probe's kernel-vs-plain check
PROBE_CHECK_VISITS = 16  # leaf visits of bench_mxu_leaf's kernel-vs-plain check
PROBE_SRC = "idkengine_tpu_torch/csrc/"
PROBES_WHERE = {  # the probe wrappers: source and the tools' Pallas kernels they replace
    "bench_slab": {"route": "cuda", "source": PROBE_SRC + "bench_slab.cu",
                   "replaces": "tools/bench_slab.py:31"},  # P1 make(mode, reduce_mode)
    "bench_mxu_leaf": {"route": "cuda", "source": PROBE_SRC + "bench_mxu_leaf.cu",
                       "replaces": "tools/bench_mxu_leaf.py:92",  # P2 kernel_vpu
                       "also_replaces": ["tools/bench_mxu_leaf.py:129"]},  # kernel_mxu
    "bench_reduce": {"route": "cuda", "source": PROBE_SRC + "bench_reduce.cu",
                     "replaces": "tools/bench_reduce.py:21"},  # P3 make(mode)
    "bench_dual": {"route": "cuda", "source": PROBE_SRC + "bench_dual.cu",
                   "replaces": "tools/bench_dual.py:57",  # P4 kernel_d1
                   "also_replaces": ["tools/bench_dual.py:70", "tools/bench_dual.py:95"]},
    "bench_prims": {"route": "cuda", "source": PROBE_SRC + "bench_prims.cu",
                    "replaces": "tools/bench_prims.py:54"},  # P5 base_loop, bodies :71-116
    "bench_prims_extra": {"route": "cuda", "source": PROBE_SRC + "bench_prims.cu",
                          "replaces": "tools/bench_prims.py:158"},  # P6 base_loop, a4 :203
}


def log(msg):
    print(msg, flush=True)


def phase_card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    card = out.strip().splitlines()[0]
    log(card)
    return card


def phase_build():
    from idkengine_tpu_torch.bvh import builder
    from idkengine_tpu_torch.ops import packet_trace, two_phase, voxel_scatter
    from idkengine_tpu_torch.tools import (bench_dual, bench_mxu_leaf, bench_prims, bench_reduce,
                                           bench_slab)

    libraries = (packet_trace, two_phase, voxel_scatter, bench_slab, bench_mxu_leaf,
                 bench_reduce, bench_dual, bench_prims)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1 + len(libraries)) as pool:
        bvh = pool.submit(builder.build_library)
        cuda = [pool.submit(m.build_kernels) for m in libraries]
        bvh.result()
        ptxas = "".join(f.result()[1] for f in cuda)
    log(f"# build (BVH library; trace, two-phase, scatter-max and five probe libraries; the "
        f"{1 + len(libraries)} compilers started together): {time.perf_counter() - t0:.1f} s")
    for line in ptxas.splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")) or "error" in line.lower():
            log(f"#   {line.strip()}")
    log(f"#   trace_kernel: {packet_trace._load().idk_trace_shared_bytes()} bytes of dynamic shared "
        f"memory a 128-thread block (its stack's ring), beside the registers and the local "
        f"stack frame above")


def phase_scene(dev, card=None):
    """Phase 3: the atrium's build; with `card`, also phase_flatten's
    measurements. Returns (db, scene, cam)."""
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
    from idkengine_tpu_torch.ops.packet_trace import WIDE_STACK_LIMIT, wide_stack_entries

    w, entries = scene.bvh4_nodes, wide_stack_entries(scene)
    log(f"# trace kernel's tables: 4-wide nodes {w.shape[0]} records, {w.numel() * 4 / 1e6:.1f} MB "
        f"(binary {scene.bvh_nodes.numel() * 4 / 1e6:.1f} MB), depth {scene.bvh4_depth} "
        f"(binary {scene.bvh_depth}), {w[:, 28].float().mean().item():.2f} children a record, "
        f"built in {scene.bvh4_build_ms:.1f} ms ({scene.bvh4_build_ms / m.build_ms * 100:.1f}% "
        f"of the BLAS build); leaf table tri_vec {scene.tri_vec.numel() * 4 / 1e6:.1f} MB; "
        f"stack {entries} entries a ray (the kernel holds {WIDE_STACK_LIMIT}); steps kernel's "
        f"threaded records {scene.bvh_thread.shape[0]}, {scene.bvh_thread.numel() * 4 / 1e6:.1f} "
        f"MB, built in {scene.thread_build_ms:.1f} ms; the wide children's binary nodes "
        f"{scene.bvh4_child.numel() * 4 / 1e6:.1f} MB; leaf references with "
        f"{scene.bvh4_leaf_bits} count bits (largest leaf "
        f"{int(scene.node_count.max().item())} triangles)")
    if card is not None:
        phase_flatten(db, dev, card, t2 - t1)
    return db, scene, cam


def phase_flatten(db, dev, card, build_s):
    """Phase 3's device flatten and EPO at full size: flatten_triangles_device
    against the host flatten_triangles, bit-equal on every field, each
    timed warm; the bytes each puts on the card; the static scene's upload
    (SceneDatabase._upload: flatten, SceneArrays with its node tables)
    timed through each, and the build's seconds with each (the measured
    build, and the build less the device upload plus the host upload);
    EPO's value (SceneMeta.epo) and the time of one more BLAS.epo()."""
    import numpy as np
    import torch

    from idkengine_tpu_torch.bvh.flatten import flatten_triangles, flatten_triangles_device
    from idkengine_tpu_torch.ops.trace import SceneArrays

    args = (db._slot_tri, db._verts, db._indices, db._normals, db._uvs, db._tri_mat)
    max_leaf = db.build_settings.max_leaf_triangle_count

    def timed(fn):
        torch_sync(dev)
        t0 = time.perf_counter()
        out = fn()
        torch_sync(dev)
        return out, time.perf_counter() - t0

    host, host_s = timed(lambda: flatten_triangles(*args))
    flat, dev_s = timed(lambda: flatten_triangles_device(*args, device=dev))
    for f in ("p0", "e1", "e2", "n_packed", "uv", "mat", "geom_normal"):
        want = np.asarray(getattr(host, f))
        got = getattr(flat, f).cpu().numpy()
        if want.dtype.kind in "iu":
            want, got = want.astype(np.int64), got.astype(np.int64)
        if got.shape != want.shape or not np.array_equal(
                np.ascontiguousarray(got).view(np.uint8), np.ascontiguousarray(want).view(np.uint8)):
            raise AssertionError(f"flatten_triangles_device's {f} differs from the host flatten's")
    t = db._slot_tri.shape[0]
    # the indexed mesh as the device flatten puts it (int32 slots, indices
    # and materials, float32 vertices, normals, uvs); the de-indexed tables
    # had they all been made on the host (p0, e1, e2, face normal, the int64
    # corner normals, uvs, materials, and the kernels' tri_vec)
    dev_bytes = (4 * t + 4 * db._indices.size + 4 * (db._verts.size + db._normals.size
                                                     + db._uvs.size) + 4 * db._tri_mat.size)
    host_bytes = t * (4 * 3 * 4 + 8 * 3 + 4 * 6 + 4 + 4 * 12)
    del host, flat
    _, up_host_s = timed(lambda: SceneArrays.from_flat(db._flat, flatten_triangles(*args),
                                                       max_leaf, dev))
    _, up_dev_s = timed(lambda: SceneArrays.from_flat(
        db._flat, flatten_triangles_device(*args, device=dev), max_leaf, dev))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    epo = db.blas.epo()
    epo_s = time.perf_counter() - t0
    if not (np.isfinite(db.meta.epo) and epo == db.meta.epo):
        raise AssertionError(f"SceneMeta.epo {db.meta.epo} is not BLAS.epo() {epo}")
    log(f"# device flatten of {t} slots: {dev_s * 1e3:.1f} ms (host flatten {host_s * 1e3:.1f} "
        f"ms, warm), every field bit-equal (p0, e1, e2, n_packed, uv, mat, geom_normal); "
        f"bytes put on the card {dev_bytes / 1e6:.1f} MB (the host flatten's tables "
        f"{host_bytes / 1e6:.1f} MB); the static upload through the device flatten "
        f"{up_dev_s:.2f} s, through the host flatten {up_host_s:.2f} s; SceneDatabase.build "
        f"{build_s:.2f} s with the device flatten, {build_s - up_dev_s + up_host_s:.2f} s with "
        f"the host one (the build less the one upload plus the other); EPO {epo:.4f} "
        f"(SceneMeta.epo, each build) in {epo_s:.2f} s on the host "
        f"({os.cpu_count()} cores); on {card}")


def torch_sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def check_agreement(kind, got, want, what):
    """Raises unless two traces of one batch agree under the AGREE rule:
    closest hits with the same hit mask, slots equal on at least AGREE of
    the rays and t, u, v bit-equal there; occlusion equal on at least AGREE.
    Returns (share of rays that agree, largest |difference| in t or
    occlusion)."""
    import torch

    if kind == "trace_closest":
        same = got.slot == want.slot
        agree = same.float().mean().item()
        for k in ("t", "u", "v"):
            if not torch.equal(getattr(got, k)[same], getattr(want, k)[same]):
                raise AssertionError(f"{what}: {k} differs")
        if not torch.equal(got.slot >= 0, want.slot >= 0) or agree < AGREE:
            raise AssertionError(f"{what}: slot agreement {agree:.6f} < {AGREE}")
        hit = (got.slot >= 0) & (want.slot >= 0)
        return agree, torch.where(hit, got.t - want.t, 0.0).abs().max().item()
    agree = (got == want).float().mean().item()
    if agree < AGREE:
        raise AssertionError(f"{what}: agreement {agree:.6f} < {AGREE}")
    return agree, (got.float() - want.float()).abs().max().item()


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
    want = plain_in_chunks(kind, scene, o, d, t_max)
    torch_sync(o.device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    agree, err = check_agreement(kind, got, want, f"{kind} against the plain version")
    out_bytes = 16 if kind == "trace_closest" else 1  # t, slot, u, v; or one bool
    ms = cuda_time_ms(lambda: getattr(kern, kind)(scene, o, d, t_max), reps)
    # rays (o, d, t_max) read once, results written once, the smallest node
    # table the walk can take (the 4-wide records; the binary ones are
    # larger) and the triangles at 36 B a slot read once
    scene_bytes = (min(scene.bvh4_nodes.numel(), scene.bvh_nodes.numel()) * 4
                   + 3 * scene.tri_p0.numel() * 4)
    ray_bytes = r * 24 + torch.as_tensor(t_max).numel() * 4
    bound_ms = (ray_bytes + r * out_bytes + scene_bytes) / HBM_BYTES_PER_S * 1e3
    return got, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by="bytes", library_ms=None), agree


def plain_in_chunks(kind, scene, o, d, t_max):
    """The plain trace of a batch, PLAIN_CHUNK rays at a time (each ray is
    traced alone, so the answer is the whole batch's; the chunks bound the
    plain walk's memory on batches of many frames' rays)."""
    import torch

    from idkengine_tpu_torch.ops import trace as plain

    r = o.shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device).expand(r)
    parts = [getattr(plain, kind)(scene, o[i:i + PLAIN_CHUNK], d[i:i + PLAIN_CHUNK],
                                  t_max[i:i + PLAIN_CHUNK].contiguous())
             for i in range(0, r, PLAIN_CHUNK)]
    if len(parts) == 1:
        return parts[0]
    if kind == "trace_any":
        return torch.cat(parts)
    return type(parts[0])(*(torch.cat(f) for f in zip(*parts)))


def steps_stats(scene, o, d, t_max):
    """Mean, 99th percentile and largest over the batch of each ray's steps in the
    binary tree (the stackless walk's count, trace_closest_steps on the
    card; a dead ray counts one): the work that the layout does not change."""
    from idkengine_tpu_torch.ops import packet_trace as kern

    _, steps = kern.trace_closest_steps(scene, o, d, t_max)
    sf = steps.float()
    stats = dict(steps_mean=sf.mean().item(), steps_p99=sf.quantile(0.99).item(),
                 steps_max=int(steps.max().item()))
    far = o.abs().amax(dim=1) > FAR_ORIGIN
    if far.any():  # rays from the sky pixels' far points apart from the rest
        stats.update(far_share=far.float().mean().item(), far_steps_mean=sf[far].mean().item(),
                     far_steps_max=int(steps[far].max().item()),
                     near_steps_mean=sf[~far].mean().item() if (~far).any() else 0.0)
    return stats


def main_path_batches(cam, pt, dev):
    """The path-traced frame's ray batches at full width: 1920x1080 primary
    rays (closest), shadow-like rays from their hits (any-hit: random
    directions up to 5 units; primary misses become dead rays, as NEE makes
    them) and the frame's first bounce batch (closest, sorted, as the frame
    traces it). Each is (kind, o, d, t_max)."""
    from idkengine_tpu_torch.ops import packet_trace as kern

    o, d, t_max = primary_rays(cam, dev)
    hit = kern.trace_closest(pt.scene, o, d, t_max)
    return {"primary": ("trace_closest", o, d, t_max),
            "shadow": ("trace_any", *shadow_rays(o, d, hit)),
            "bounce": ("trace_closest", *capture_bounce_batch(pt, cam))}


def primary_rays(cam, dev):
    """The frame's 1920x1080 primary rays (o, d, t_max) of its first sample."""
    import torch

    from idkengine_tpu_torch.render.camera import generate_rays
    from idkengine_tpu_torch.utils import rng

    r = WIDTH * HEIGHT
    state = rng.init_state(torch.arange(r, device=dev), 0)
    state, u_pix = rng.uniform2(state)
    state, u_lens = rng.uniform2(state)
    o, d = generate_rays(cam.ray_params(WIDTH, HEIGHT), WIDTH, HEIGHT, u_pix, u_lens)
    return o, d, torch.full((r,), 3.4e38, device=dev)


def shadow_rays(o, d, hit):
    """Shadow-like rays from the hit points (random directions up to 5
    units; misses become dead rays, as NEE makes them): (o, d, t_max)."""
    import torch

    r = o.shape[0]
    g = torch.Generator(device=o.device).manual_seed(0)
    sd = torch.randn((r, 3), generator=g, device=o.device)
    sd = (sd / torch.linalg.vector_norm(sd, dim=-1, keepdim=True)).contiguous()
    hp = o + d * torch.where(hit.slot >= 0, hit.t, 0.0)[:, None]
    return (hp - d * 1e-3).contiguous(), sd, torch.where(hit.slot >= 0, 5.0, -1.0)


def log_batch(kind, label, o, m, agree, extra=""):
    if "far_share" in m:
        extra += (f"; rays from beyond {FAR_ORIGIN:g} (sky pixels) {m['far_share']:.4f}, their "
                  f"steps mean {m['far_steps_mean']:.2f} max {m['far_steps_max']}, the others' "
                  f"mean {m['near_steps_mean']:.2f}")
    log(f"# {kind}, {label} ({o.shape[0]} rays): kernel {m['ms']:.4f} ms, bound "
        f"{m['bound_ms']:.4f} ms, plain {m['plain_ms']:.1f} ms; binary-tree steps per ray mean "
        f"{m['steps_mean']:.2f} p99 {m['steps_p99']:.0f} max {m['steps_max']}; agreement "
        f"{agree:.6f}, max |diff| {m['max_abs_err']:g}{extra}")


def phase_compare(scene, cam, pt, dev, card):
    """Each trace kernel against its plain version on the path-traced
    frame's batches; times, bounds and steps per ray."""
    batches = main_path_batches(cam, pt, dev)
    results = {}
    for label, (kind, o, d, t_max) in batches.items():
        got, m, agree = compare_trace(kind, scene, o, d, t_max)
        m.update(steps_stats(scene, o, d, t_max))
        share = ((got.slot >= 0) if kind == "trace_closest" else got).float().mean().item()
        log_batch(kind, f"{label} batch", o, m, agree,
                  f"; {'hits' if kind == 'trace_closest' else 'occluded'} {share:.4f}; on {card}")
        entry = results.setdefault(kind, dict(m, batches=[]))  # the first batch stands for it
        entry["max_abs_err"] = max(entry["max_abs_err"], m["max_abs_err"])
        entry["batches"].append(dict(batch=label, rays=o.shape[0], agreement=agree, **m))
    return results, batches


def reset_all_launch_counts():
    from idkengine_tpu_torch.ops import packet_trace, two_phase, voxel_scatter

    packet_trace.reset_launch_counts()
    two_phase.reset_launch_counts()
    voxel_scatter.reset_launch_counts()


def read_launch_counts():
    from idkengine_tpu_torch.ops import packet_trace, two_phase, voxel_scatter

    return {"trace_closest": packet_trace.trace_closest.launches,
            "trace_any": packet_trace.trace_any.launches,
            "trace_closest_two_level": packet_trace.trace_closest_two_level.launches,
            "trace_any_two_level": packet_trace.trace_any_two_level.launches,
            "trace_closest_steps": packet_trace.trace_closest_steps.launches,
            "trace_closest_capped": packet_trace._closest_capped.launches,
            "trace_any_capped": packet_trace._any_capped.launches,
            "scatter_max_dense": voxel_scatter.scatter_max_dense.launches,
            "two_phase_a": two_phase.phase_a.launches,
            "two_phase_b": two_phase.phase_b_closest.launches + two_phase.phase_b_any.launches}


def main_settings():
    """The main path's tracer settings (phase 5)."""
    from idkengine_tpu_torch.render import PathTracerSettings

    return PathTracerSettings(ray_depth=DEPTH, russian_roulette=False, do_ray_sorting=True,
                              sky_strength=1.0)


def make_tracer(db, scene, cam, dev):
    """The path tracer of the main path, after one warm-up frame."""
    from idkengine_tpu_torch.render import PathTracer

    t0 = time.perf_counter()
    pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), WIDTH, HEIGHT, main_settings(),
                    device=dev)
    pt.render_frame(cam)  # warm-up
    torch_sync(dev)
    log(f"# tracer init + warm-up frame {time.perf_counter() - t0:.2f} s")
    return pt


def phase_frame(pt, cam, dev, card):
    import torch

    from idkengine_tpu_torch.render.tonemap import tonemap

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
    return launches, dict(ms=dt / TIMED_FRAMES * 1e3, mrays_per_s=rays / dt / 1e6)


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
    for name in ("trace_closest", "trace_any", "scatter_max_dense"):
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched on the deferred frame")
    if tuple(out.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError("deferred image is not a finite (H,W,3) array")
    if not (0.0 <= out.min().item() and out.max().item() <= 1.0):
        raise AssertionError("deferred image leaves [0,1]")
    if not out.std().item() > 0.01:
        raise AssertionError("deferred image is flat")
    log(f"# deferred image: mean {out.mean().item():.5f}, std {out.std().item():.5f}")
    return launches


def _calling_pass():
    """The pass of the deferred frame graph (PASS_OF_CALLER) whose code is
    on the stack, the innermost one."""
    f = sys._getframe(2)
    while f is not None and f.f_code.co_name not in PASS_OF_CALLER:
        f = f.f_back
    return "?" if f is None else PASS_OF_CALLER[f.f_code.co_name]


def record_deferred_traces(pipe, cam, render=None):
    """The trace calls (pass, kind, scene, o, d, t_max) of one deferred
    frame, in the order the frame makes them (phase 7's: the voxelizer's
    shadow rays, the G-buffer's primaries, the lighting's shadow rays
    toward the lights; the optional passes' between them), each with the
    pass that made it; recorded by standing in for the pipeline's trace
    functions. `render` (default pipe.render_frame(cam)) makes the frame."""
    from idkengine_tpu_torch.render import pipeline as pipeline_mod

    calls = []

    def recording(kind):
        fn = getattr(pipeline_mod, kind)

        def run(scene, o, d, t_max, **kw):
            calls.append((_calling_pass(), kind, scene, o, d, t_max))
            return fn(scene, o, d, t_max, **kw)
        return run

    saved = pipeline_mod.trace_closest, pipeline_mod.trace_any
    pipeline_mod.trace_closest, pipeline_mod.trace_any = (recording("trace_closest"),
                                                          recording("trace_any"))
    try:
        render() if render is not None else pipe.render_frame(cam)
    finally:
        pipeline_mod.trace_closest, pipeline_mod.trace_any = saved
    return calls


def compare_recorded(calls, frame, results, card, passes=None):
    """Each recorded trace call of one deferred frame (record_deferred_traces),
    or those of `passes` only, against its plain version: times, bounds,
    steps per ray, added to the kernel's batches. Raises where a pass of
    `passes` made no call."""
    for n, (pass_, kind, scene, o, d, t_max) in enumerate(calls):
        if passes is not None and pass_ not in passes:
            continue
        _, m, agree = compare_trace(kind, scene, o, d, t_max, reps=5)
        m.update(steps_stats(scene, o, d, t_max))
        log_batch(kind, f"{frame}'s call {n} ({pass_})", o, m, agree, f"; on {card}")
        entry = results[kind]
        entry["max_abs_err"] = max(entry["max_abs_err"], m["max_abs_err"])
        call = dict(rays=o.shape[0], agreement=agree, **m)
        entry.setdefault("deferred_frame_calls", []).append(dict(frame=frame, call=n,
                                                                 trace_pass=pass_, **call))
        entry["batches"].append(dict(batch=f"{frame} call {n} ({pass_})", **call))
    made = {c[0] for c in calls}
    for pass_ in passes or ():
        if pass_ not in made:
            raise AssertionError(f"{frame}: the {pass_} pass made no trace call")


def phase_compare_deferred_traces(pipe, cam, results, card):
    """Each trace kernel against its plain version on the rays of one
    deferred frame (record_deferred_traces); times, bounds, steps per ray."""
    calls = record_deferred_traces(pipe, cam)
    compare_recorded(calls, "deferred frame", results, card)
    for kind in ("trace_closest", "trace_any"):
        if kind not in {c[1] for c in calls}:
            raise AssertionError(f"the deferred frame made no {kind} call")


def profile_frame(render, title, is_pass):
    """One frame, render(), under torch.profiler: the device time of each
    pass (the ranges a pipeline names with record_function; is_pass(key)
    picks them), kernel launches, device busy time against the frame's
    wall time, and the kernels that take most.

    The profiler gives a pass the kernels of the PyTorch ops inside it; the
    hand kernels, launched through ctypes outside any op, join no pass and
    are listed apart, each with the call-site range it was launched in
    (profiling.attribute: the trace entry points' pt_closest_<tag> /
    pt_any_<tag>) and the bucket the JAX package's rule gives that range;
    the buckets of the whole frame follow (profiling.bucket_times). Where
    the profiler also traces a pass's span on the device (from its first
    to its last kernel, the hand kernels and idle gaps included), that span
    is printed beside it. Returns the wall and busy ms, each pass's device
    ms (None where no device time was traced), the unrounded buckets and
    attribute's list."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from idkengine_tpu_torch import profiling

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    ranges = {e.key for e in events if e.device_type == cpu}  # their device spans are no kernels
    kernels = [e for e in events if e.device_type == cuda and e.key not in ranges]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    if busy_ms <= 0:
        log(f"# {title} under the profiler: {wall_ms:.2f} ms wall; device time not traced")
        return None
    log(f"# {title} under the profiler: {wall_ms:.2f} ms wall, {launches} device "
        f"kernels, device busy {busy_ms:.2f} ms ({(1 - busy_ms / wall_ms) * 100:.1f}% idle); "
        f"each pass's PyTorch-op kernels (device span, host time):")
    spans = {e.key: e.device_time_total / 1e3 for e in events
             if is_pass(e.key) and e.device_type == cuda}
    for e in events:
        if is_pass(e.key) and e.device_type == cpu:
            span = spans.get(e.key)
            log(f"#   {e.key}: {e.device_time_total / 1e3:.2f} ms "
                f"({e.device_time_total / 1e3 / busy_ms * 100:.1f}% of busy; span "
                f"{'not traced' if span is None else f'{span:.2f} ms'}, "
                f"host {e.cpu_time_total / 1e3:.2f} ms)")
    sites = profiling.attribute(prof.events())
    by_site = {}
    for name, site, ms in sites:
        if any(k in name for k in HAND_KERNELS):
            key = (site, name.replace("(anonymous namespace)::", "").replace("void ", "")
                   .split("(")[0])
            n, total = by_site.get(key, (0, 0.0))
            by_site[key] = (n + 1, total + ms)
    for (site, kernel), (n, ms) in sorted(by_site.items(), key=lambda kv: -kv[1][1]):
        bucket = (profiling.range_bucket(site) if site is not None
                  else profiling.bucket(kernel))
        log(f"#   hand kernel {kernel}: {ms:.2f} ms in {n} launches, call site "
            f"{site or 'none'} -> {bucket}")
    buckets = profiling.bucket_times(sites, ndigits=None)
    log(f"# {title}'s buckets (profiling.capture_device_profile's, ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in buckets.items()))
    log("# most device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"#   {e.self_device_time_total / 1e3:.2f} ms in {e.count} launches: {e.key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                passes={e.key: e.device_time_total / 1e3 for e in events
                        if is_pass(e.key) and e.device_type == cpu},
                buckets=buckets, sites=sites)


def hand_trace_ms(prof, site=None) -> float:
    """Device ms of the hand trace kernels in profile_frame's result, all
    of them or those launched in call-site range `site`."""
    from idkengine_tpu_torch.profiling import HAND_TRACE_KERNELS

    return sum(ms for name, s, ms in prof["sites"]
               if any(k in name for k in HAND_TRACE_KERNELS) and (site is None or s == site))


def check_trace_buckets(prof, what, positive=("primary", "bounce_closest", "nee")):
    """The frame's trace buckets: each of `positive` above 0 ms, and with
    trace_other they sum, within 1%, to the device time of the hand trace
    kernels in the same profile. Raises otherwise."""
    if prof is None:
        raise AssertionError(f"{what}: the profiler traced no device time")
    by, hand = prof["buckets"], hand_trace_ms(prof)
    for b in positive:
        if not by.get(b, 0.0) > 0.0:
            raise AssertionError(f"{what}: bucket {b} is empty ({by})")
    total = sum(by.get(b, 0.0) for b in TRACE_BUCKETS)
    if not abs(total - hand) <= BUCKET_SHARE * hand:
        raise AssertionError(f"{what}: the trace buckets sum to {total:.3f} ms, the hand trace "
                             f"kernels take {hand:.3f} ms")
    log(f"# {what}: " + ", ".join(f"{b} {by.get(b, 0.0):.3f} ms" for b in TRACE_BUCKETS)
        + f"; sum {total:.3f} ms, the hand trace kernels {hand:.3f} ms (within "
        f"{BUCKET_SHARE:.0%})")


def check_deferred_buckets(prof):
    """The deferred frame's traces are untagged, as the JAX package's: every
    hand trace kernel in trace_other, its any-hit shadow rays too (nee,
    primary and bounce_closest empty). Raises otherwise."""
    check_trace_buckets(prof, "deferred frame", positive=("trace_other",))
    tagged = {b: prof["buckets"].get(b, 0.0) for b in ("primary", "bounce_closest", "nee")}
    if any(tagged.values()):
        raise AssertionError(f"the deferred frame's untagged traces landed in {tagged}")
    any_ms = sum(ms for name, _site, ms in prof["sites"]
                 if "trace_kernel<true" in name or "trace_capped_kernel<true>" in name)
    if not any_ms > 0:
        raise AssertionError("the deferred frame launched no any-hit trace kernel")
    log(f"# deferred frame: its any-hit trace kernels {any_ms:.3f} ms, in trace_other as the "
        f"JAX package buckets an untagged any-hit trace (pt_any_*_x)")


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


def capture_bounce_batch(pt, cam):
    """The rays (o, d, t_max) of the path-traced frame's second closest-hit
    trace (the first bounce, sorted), recorded by standing in for the
    tracer's trace_closest for one frame."""
    from idkengine_tpu_torch.render import pathtracer as pathtracer_mod

    calls, fn = [], pathtracer_mod.trace_closest

    def recording(scene, o, d, t_max, **kw):
        calls.append((o, d, t_max))
        return fn(scene, o, d, t_max, **kw)

    pathtracer_mod.trace_closest = recording
    try:
        pt.render_frame(cam)
    finally:
        pathtracer_mod.trace_closest = fn
    if len(calls) != DEPTH:
        raise AssertionError(f"the frame made {len(calls)} closest-hit traces, not {DEPTH}")
    return calls[1]


def compare_phase_a(scene, o, d, t_max):
    """Phase A kernel against its plain version: cnt equal on every ray,
    the same list sets where cnt <= D; on OVERFLOW_CHECK overflow rays at a
    fixed stride, every recorded id lies in the plain version's full list."""
    import torch

    from idkengine_tpu_torch.ops import two_phase as tp

    n_slots, r = tp.D_SLOTS, o.shape[0]
    lists, cnt = tp.phase_a(scene, o, d, t_max, n_slots)
    torch_sync(o.device)
    t0 = time.perf_counter()
    p_lists, p_cnt = tp.phase_a_plain(scene, o, d, t_max, n_slots)
    torch_sync(o.device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (cnt - p_cnt).abs().max().item()
    if not torch.equal(cnt, p_cnt):
        raise AssertionError(f"phase A: cnt differs on {(cnt != p_cnt).sum().item()} rays")
    if not torch.equal((lists >= 0).sum(1), torch.clamp(cnt, max=n_slots)):
        raise AssertionError("phase A: recorded entries are not min(cnt, D)")
    fine = cnt <= n_slots
    if not torch.equal(torch.sort(lists[fine], 1).values, torch.sort(p_lists[fine], 1).values):
        raise AssertionError("phase A: list sets differ from the plain version's")
    over = torch.nonzero(cnt > n_slots)[:, 0]
    if over.numel():
        sel = over[::max(1, over.numel() // OVERFLOW_CHECK)][:OVERFLOW_CHECK]
        full, _ = tp.phase_a_plain(scene, o[sel], d[sel], t_max[sel], int(cnt[sel].max()))
        rows = torch.arange(sel.numel(), device=o.device)[:, None] * scene.node_count.shape[0]
        got = lists[sel].long()
        if not torch.isin((rows + got)[got >= 0], (rows + full.long())[full >= 0]).all():
            raise AssertionError("phase A: an overflow ray recorded a leaf it does not want")
    ms = cuda_time_ms(lambda: tp.phase_a(scene, o, d, t_max, n_slots), 5)
    # each ray (o, d, t_max) read once, the smallest table the walk can take
    # read once (the binary records, 32 B a node; the 4-wide records with
    # the child map that names their leaves are larger), cnt and the D list
    # slots written once
    nbytes = r * 28 + scene.bvh_nodes.numel() * 4 + r * (n_slots + 1) * 4
    cf = cnt.float()
    stats = dict(overflow=(cnt > n_slots).float().mean().item(), cnt_mean=cf.mean().item(),
                 cnt_max=int(cnt.max().item()), checked_overflow_rays=int(min(
                     over.numel(), OVERFLOW_CHECK)))
    return lists, cnt, dict(max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                            library_ms=None), stats


def compare_phase_b(kind, scene, lists, o, d, t_max):
    """Phase B kernel against its plain version on the same lists: t, u, v
    bit-equal and slots equal (closest), occlusion equal (any)."""
    import torch

    from idkengine_tpu_torch.ops import two_phase as tp

    closest = kind == "trace_closest"
    fn = tp.phase_b_closest if closest else tp.phase_b_any
    plain_fn = tp.phase_b_closest_plain if closest else tp.phase_b_any_plain
    got = fn(scene, lists, o, d, t_max)
    t0 = time.perf_counter()
    want = plain_fn(scene, lists, o, d, t_max)
    torch_sync(o.device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    if closest:
        for k in ("t", "slot", "u", "v"):
            if not torch.equal(getattr(got, k), getattr(want, k)):
                raise AssertionError(f"phase B closest: {k} differs from the plain version")
        err = (got.t - want.t).abs().max().item()
    else:
        if not torch.equal(got, want):
            raise AssertionError("phase B any: occlusion differs from the plain version")
        err = (got.float() - want.float()).abs().max().item()
    ms = cuda_time_ms(lambda: fn(scene, lists, o, d, t_max), 5)
    # bytes: each ray (o, d, t_max) and its list read once, results written
    # once, the first/count of each listed leaf and its triangles (36 B)
    # read once; operations: one Möller test (about 50 float32 operations)
    # per listed triangle of each ray (all of them for closest hits)
    r, listed = o.shape[0], lists[lists >= 0].long()
    leaves = torch.unique(listed)
    nbytes = (r * 28 + lists.numel() * 4 + r * (16 if closest else 1)
              + leaves.numel() * 8 + scene.node_count[leaves].sum().item() * 36)
    tests = scene.node_count[listed].sum().item()
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, tests * 50 / F32_OPS_PER_S * 1e3
    bound = (dict(bound_ms=ops_ms, bound_by="operations") if closest and ops_ms > bytes_ms
             else dict(bound_ms=bytes_ms, bound_by="bytes"))
    return got, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound, library_ms=None), tests


def phase_two_phase(scene, batches):
    """Phase 8: the two-phase traversal on the main path's ray batches."""
    import torch

    from idkengine_tpu_torch.ops import packet_trace as kern
    from idkengine_tpu_torch.ops import two_phase as tp

    entries = {"two_phase_a": None, "two_phase_b": None}
    for name, (kind, o, d, t_max) in batches.items():
        closest = kind == "trace_closest"
        two_fn = tp.two_phase_closest if closest else tp.two_phase_any
        one_fn = getattr(kern, kind)
        lists, cnt, ma, st = compare_phase_a(scene, o, d, t_max)
        hb, mb, tests = compare_phase_b(kind, scene, lists, o, d, t_max)
        agree, _ = check_agreement(kind, two_fn(scene, o, d, t_max), one_fn(scene, o, d, t_max),
                                   f"two-phase {kind} against the one-phase kernel")
        # the fallback launch as the two-phase trace makes it
        over, live = cnt > tp.D_SLOTS, t_max > 0
        tm2 = (torch.where(over & live, torch.minimum(hb.t, t_max), -1.0) if closest
               else torch.where(over & ~hb & live, t_max, -1.0))
        fb_ms = cuda_time_ms(lambda: one_fn(scene, o, d, tm2), 5)
        two_ms = cuda_time_ms(lambda: two_fn(scene, o, d, t_max), 5)
        one_ms = cuda_time_ms(lambda: one_fn(scene, o, d, t_max), 5)
        log(f"# two-phase, {name} batch ({o.shape[0]} rays, {kind}): phase A {ma['ms']:.3f} ms "
            f"(bound {ma['bound_ms']:.3f}, plain {ma['plain_ms']:.1f}), phase B {mb['ms']:.3f} ms "
            f"(bound {mb['bound_ms']:.3f} by {mb['bound_by']}, {tests} triangle tests, plain "
            f"{mb['plain_ms']:.1f}), fallback {fb_ms:.3f} ms; two-phase call {two_ms:.3f} ms "
            f"against one-phase {one_ms:.3f} ms; overflow {st['overflow']:.4f}, wanted leaves "
            f"per ray mean {st['cnt_mean']:.2f} max {st['cnt_max']} "
            f"({st['checked_overflow_rays']} overflow lists checked); agreement {agree:.6f}")
        for key, m in (("two_phase_a", ma), ("two_phase_b", mb)):
            call = dict(batch=name, rays=o.shape[0], **m, fallback_ms=fb_ms, two_phase_ms=two_ms,
                        one_phase_ms=one_ms, agreement=agree, **st)
            if entries[key] is None:  # the primaries' numbers stand for the kernel
                entries[key] = dict(m, batches=[])
            entries[key]["max_abs_err"] = max(entries[key]["max_abs_err"], m["max_abs_err"])
            entries[key]["batches"].append(call)
    return entries


def phase_pipeline(db, cam, dev, card):
    """Phase 9: PathTracerPipeline frames at full width, one-phase and
    two-phase, timed in turns (one, two, two, one) after both warmed up to
    DENOISE_AT samples. Returns each one's launch counts over a timed set."""
    import torch

    from idkengine_tpu_torch.render import (PathTracerPipeline, PathTracerSettings,
                                            PtPipelineSettings)

    pipes = {}
    for label, two in (("pt_pipeline", False), ("pt_pipeline_two_phase", True)):
        settings = PathTracerSettings(ray_depth=DEPTH, russian_roulette=False,
                                      do_ray_sorting=True, sky_strength=1.0, use_two_phase=two)
        pipes[label] = PathTracerPipeline(db, WIDTH, HEIGHT, settings, PtPipelineSettings(),
                                          device=dev)
        t0 = time.perf_counter()
        for _ in range(DENOISE_AT):
            pipes[label].render_frame(cam)
        torch_sync(dev)
        log(f"# {label}: {DENOISE_AT} warm-up frames {time.perf_counter() - t0:.2f} s")
    launches, ms = {}, {label: [] for label in pipes}
    for label in ("pt_pipeline", "pt_pipeline_two_phase", "pt_pipeline_two_phase", "pt_pipeline"):
        pipe = pipes[label]
        reset_all_launch_counts()
        t0 = time.perf_counter()
        for _ in range(TIMED_FRAMES):
            out = pipe.render_frame(cam)
        torch_sync(dev)
        ms[label].append((time.perf_counter() - t0) / TIMED_FRAMES * 1e3)
        launches[label] = read_launch_counts()
        wanted = ("trace_closest", "trace_any") + (
            ("two_phase_a", "two_phase_b") if label.endswith("two_phase") else ())
        for name in wanted:
            if launches[label][name] == 0:
                raise AssertionError(f"{name} was not launched on the {label} frame")
        if tuple(out.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{label} image is not a finite (H,W,3) array")
        if not (0.0 <= out.min().item() and out.max().item() <= 1.0 and out.std().item() > 0.01):
            raise AssertionError(f"{label} image leaves [0,1] or is flat")
    for label, pipe in pipes.items():
        log(f"# {label} frame (denoised, bloom, AgX): "
            f"{' / '.join(f'{m:.2f}' for m in ms[label])} ms/frame over two sets of "
            f"{TIMED_FRAMES} frames (timed in turns one, two, two, one), "
            f"{WIDTH}x{HEIGHT} depth {DEPTH}, on {card}; launches per set {launches[label]}")
    rmse = torch.sqrt(torch.mean((pipes["pt_pipeline"].pt.image()
                                  - pipes["pt_pipeline_two_phase"].pt.image()) ** 2)).item()
    log(f"# two-phase against one-phase accumulation "
        f"({pipes['pt_pipeline'].pt.accumulated_samples} samples): RMSE {rmse:.3g} "
        f"(limit {SMALL_RMSE})")
    if not rmse <= SMALL_RMSE:
        raise AssertionError("the two-phase accumulation disagrees with the one-phase one")
    for label, pipe in pipes.items():
        profile_frame(lambda: pipe.render_frame(cam), f"{label} frame",
                      lambda k: k in PT_PASSES or k.startswith(PT_RANGES))
    return launches


def phase_denoise_record(db, scene, cam, dev):
    """Phase 10: the reference benchmark's denoiser record (bench.py:205-245):
    256x256, 8 spp denoised against a 256-spp accumulation, RMSE ratios in
    linear and tonemapped space. No gate: the reference fails its own."""
    import torch

    from idkengine_tpu_torch.render import PathTracer, PathTracerSettings
    from idkengine_tpu_torch.render.denoise import atrous_denoise
    from idkengine_tpu_torch.render.tonemap import tonemap

    n = 256
    settings = PathTracerSettings(ray_depth=DEPTH, russian_roulette=False, do_ray_sorting=True,
                                  sky_strength=1.0)
    pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), n, n, settings, device=dev)
    for _ in range(8):
        pt.render_frame(cam)
    noisy = pt.image().clone()
    alb, nrm, dep = pt._last_aovs
    args = (noisy, alb.reshape(n, n, 3), nrm.reshape(n, n, 3), dep.reshape(n, n))
    den = atrous_denoise(*args, variance=pt.variance())
    ms = cuda_time_ms(lambda: atrous_denoise(*args, variance=pt.variance()), 5)
    for _ in range(248):
        pt.render_frame(cam)
    ref = pt.image()

    def rmse(a, b):
        return torch.sqrt(torch.mean((a - b) ** 2)).item()

    if not bool(torch.isfinite(den).all()):
        raise AssertionError("denoised image is not finite")
    lin = rmse(den, ref) / max(rmse(noisy, ref), 1e-12)
    tmr = rmse(tonemap(den), tonemap(ref)) / max(rmse(tonemap(noisy), tonemap(ref)), 1e-12)
    log(f"# denoiser record, {n}x{n}, 8 spp denoised against 256 spp: RMSE ratio linear "
        f"{lin:.4f}, tonemapped {tmr:.4f} (the reference's gate is 0.85; not asserted); "
        f"atrous_denoise {ms:.3f} ms at {n}x{n}")


def phase_debug_view(db, scene, cam, dev, card):
    """Phase 11: the traversal-cost heatmap at full width, and the steps
    kernel against the plain stackless trace on the view's primaries."""
    import torch

    from idkengine_tpu_torch.ops import packet_trace as kern
    from idkengine_tpu_torch.ops import trace as plain
    from idkengine_tpu_torch.render import PathTracer, PathTracerSettings
    from idkengine_tpu_torch.render.camera import generate_rays
    from idkengine_tpu_torch.render.debug_view import traversal_cost_image

    pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), WIDTH, HEIGHT,
                    PathTracerSettings(ray_depth=DEPTH), device=dev)
    reset_all_launch_counts()
    t0 = time.perf_counter()
    img = traversal_cost_image(pt, cam)
    torch_sync(dev)
    view_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launch_counts()
    if launches["trace_closest_steps"] == 0:
        raise AssertionError("trace_closest_steps was not launched by the debug view")
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("heatmap is not a finite (H,W,3) array")
    if not (0.0 <= img.min().item() and img.max().item() <= 1.0 and img.std().item() > 0.01):
        raise AssertionError("heatmap leaves [0,1] or is flat")

    o, d, t_max = debug_view_rays(cam, dev)
    r = o.shape[0]
    got, steps = kern.trace_closest_steps(scene, o, d, t_max)
    t0 = time.perf_counter()
    want, want_steps = plain.trace_closest_steps(scene, o, d, t_max)
    torch_sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max((steps - want_steps).abs().max().item(), (got.t - want.t).abs().max().item())
    if not torch.equal(steps, want_steps):
        raise AssertionError(f"steps differ on {(steps != want_steps).sum().item()} rays")
    for k in ("t", "slot", "u", "v"):
        if not torch.equal(getattr(got, k), getattr(want, k)):
            raise AssertionError(f"trace_closest_steps: {k} differs from the plain version")
    ms = cuda_time_ms(lambda: kern.trace_closest_steps(scene, o, d, t_max), 5)
    one_ms = cuda_time_ms(lambda: kern.trace_closest(scene, o, d, t_max), 5)
    # rays read once, the least of a node the walk needs (its box, miss
    # link and leaf word: 32 B, the threaded record; the hit link follows
    # from the order) and the triangles (36 B each) read once,
    # t/slot/u/v/steps written once
    n_nodes, n_tris = scene.node_count.shape[0], scene.tri_p0.shape[0]
    nbytes = r * 28 + n_nodes * 32 + n_tris * 36 + r * 20
    sf = steps.float()
    log(f"# debug view {WIDTH}x{HEIGHT}: heatmap {view_ms:.2f} ms (host); steps kernel "
        f"{ms:.4f} ms, bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms (one-phase trace_closest "
        f"{one_ms:.4f} ms), plain {plain_ms:.1f} ms; steps mean {sf.mean().item():.1f} p99 "
        f"{sf.quantile(0.99).item():.0f} max {int(steps.max().item())}; steps and hits equal "
        f"on every ray; launches {launches}; on {card}")
    return dict(max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes", library_ms=None), launches


def debug_view_rays(cam, dev):
    """The debug view's rays (o, d, t_max): 1920x1080 primaries through the
    pixel centres, no lens jitter, no limit."""
    import torch

    from idkengine_tpu_torch.render.camera import generate_rays

    r = WIDTH * HEIGHT
    o, d = generate_rays(cam.ray_params(WIDTH, HEIGHT), WIDTH, HEIGHT,
                         torch.zeros((r, 2), device=dev))
    return o, d, torch.full((r,), 3.4e38, device=dev)


def phase_small_pipeline(dev):
    """Phase 12: a small two-phase pipeline render on the card against the
    same render on the CPU, denoising from the second frame."""
    import numpy as np

    from idkengine_tpu_torch.bvh.builder import BuildSettings
    from idkengine_tpu_torch.render import (Camera, PathTracerPipeline, PathTracerSettings,
                                            PtPipelineSettings)
    from idkengine_tpu_torch.scene.procedural import atrium
    from idkengine_tpu_torch.scene.scene_db import SceneDatabase

    cam = Camera(position=np.array(CAMERA["position"], np.float32), yaw=CAMERA["yaw"],
                 fov_y=CAMERA["fov_y"])
    settings = PathTracerSettings(ray_depth=DEPTH, russian_roulette=False, do_ray_sorting=True,
                                  use_two_phase=True)
    imgs = []
    for device in (dev, "cpu"):
        db = SceneDatabase(BuildSettings(**BUILD))
        db.add_model(atrium(8000))
        db.build(device)
        for pos, rad, r in LIGHTS:
            db.lights.add(pos, rad, radius=r)
        pipe = PathTracerPipeline(db, 96, 54, settings, PtPipelineSettings(denoise_at_samples=2),
                                  device=device)
        for _ in range(3):
            img = pipe.render_frame(cam)
        imgs.append(img.cpu().numpy())
    rmse = float(np.sqrt(np.mean((imgs[0] - imgs[1]) ** 2)))
    log(f"# small two-phase pipeline 96x54, 3 frames, denoised from the second: card vs CPU "
        f"RMSE {rmse:.3g} (limit {SMALL_RMSE})")
    if not rmse <= SMALL_RMSE:
        raise AssertionError("card pipeline render disagrees with the CPU render")


def compare_probe(got, want, t_tol):
    """A probe kernel's result against its plain version's; raises where
    they disagree. Without t_tol: the output and every chain tensor equal
    bit for bit. With it (bench_mxu_leaf, `T_TOL` of the kernel): the same
    slot on at least AGREE of the rays (the rest are ties) and t within
    t_tol where the slots are equal. Returns (largest |difference| of t
    where the slots are equal, or 0; share of rays whose slots agree)."""
    import torch

    if t_tol is None:
        for key, a, b in [("out", got.out, want.out),
                          *((k, got.chain[k], want.chain[k]) for k in want.chain)]:
            if a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"{key} differs from the plain version")
        return 0.0, 1.0
    same = got.chain["slot"] == want.chain["slot"]
    share = same.float().mean().item()
    if share < AGREE:
        raise AssertionError(f"slot agreement {share:.6f} < {AGREE}")
    t, t_want = got.chain["t"][same], want.chain["t"][same]
    if not torch.allclose(t, t_want, **t_tol):
        raise AssertionError(f"t differs beyond {t_tol} where the slots are equal")
    return (t - t_want).abs().max().item(), share


def read_probe_launches():
    from idkengine_tpu_torch.tools import (bench_dual, bench_mxu_leaf, bench_prims, bench_reduce,
                                           bench_slab)

    return {"bench_slab": bench_slab.slab_loop.launches,
            "bench_mxu_leaf": bench_mxu_leaf.vpu_moller.launches + bench_mxu_leaf.mxu_form.launches,
            "bench_reduce": bench_reduce.reduce_loop.launches,
            "bench_dual": bench_dual.dual_loop.launches,
            "bench_prims": bench_prims.prims_loop.launches,
            "bench_prims_extra": bench_prims.prims_extra_loop.launches}


def split_extra(prims: dict) -> tuple[dict, dict]:
    """bench_prims' variants (or results) apart from extra()'s a4."""
    from idkengine_tpu_torch.tools import bench_prims as bp

    extra = bp.label(bp.EXTRA, bp.DEFAULT_K)
    return {k: v for k, v in prims.items() if k != extra}, {extra: prims[extra]}


def restate_bounds(runs, card):
    """Every probe variant's one-SM bound restated, at the clock its run of
    the tool measured (clock64() cycles over device time), beside that
    run's time and the first bound (float operations over 67 TFLOP/s, on
    one of the 132 SMs): from the instructions its function needs
    (`needed_cycles_per_step` of its module, the bound each probe is held
    to) and, where its step loop holds no loop of its own, from its machine
    code (tools/sass_count.py: the step loop's warp instructions by class,
    what the compiled loop issues); both at compute capability 9.0's rates.
    Returns probe -> label -> the restated bounds' numbers."""
    from importlib import import_module

    from idkengine_tpu_torch.tools import sass_count

    out, sass = {}, {}
    for name in PROBES_WHERE:
        probe = "bench_prims" if name == "bench_prims_extra" else name
        module = import_module(f"idkengine_tpu_torch.tools.{probe}")
        if probe not in sass:
            sass[probe] = sass_count.restate(probe)
        out[name] = {}
        for label, run in runs[name].items():
            unit, cycles = next((k[len("cycles_per_"):], v) for k, v in run.items()
                                if k.startswith("cycles_per_"))
            units = run["units"]
            clock_hz = cycles * units / (run["ms"] * 1e-3)
            needed, by = module.needed_cycles_per_step(label)
            entry = dict(needed_one_sm_ms=needed * units / clock_hz * 1e3, needed_by=by,
                         needed_cycles_per_iter=needed, share_of_needed=needed / cycles,
                         clock_hz=clock_hz)
            b = sass[probe].get(label, {})
            if "bound_cycles_per_step" in b:
                entry.update(sass_one_sm_ms=b["bound_cycles_per_step"] * units / clock_hz * 1e3,
                             sass_by=b["bound_by"], sass_cycles_per_iter=b["bound_cycles_per_step"],
                             warp_instructions_per_iter=b["counts"])
                sass_text = (f"from its SASS {entry['sass_one_sm_ms']:.4f} ms "
                             f"({b['bound_cycles_per_step']:.1f} cycles, by {b['bound_by']})")
            elif b.get("inner_loops"):
                sass_text = "no SASS bound (its step loop holds a loop of its own)"
            else:
                sass_text = "no SASS bound (the steps a pass of its loop were not found)"
            beats = ("; the run BEATS it: a rate it assumes is taken too low" if needed > cycles
                     else "")
            unit = {"iter": "step", "tri-visit": "triangle visit"}.get(unit, unit)
            log(f"# {name} {label}: {run['ms']:.4f} ms ({cycles:.1f} cycles a {unit}) against its "
                f"bound from the instructions its function needs, {entry['needed_one_sm_ms']:.4f} "
                f"ms ({needed:.1f} cycles, by {by}; {needed / cycles:.1%} of the cycles{beats}), "
                f"and {sass_text}, at the measured {clock_hz / 1e9:.3f} GHz; the first bound "
                f"{run['bound']['one_sm_ms']:.4f} ms on one SM; on {card}")
            out[name][label] = entry
    return out


def phase_probes(dev, card):
    """Phase 13: the ports of the TPU microbenchmarks P1-P6. Their mains
    run as a user runs them (`python -m idkengine_tpu_torch.tools.<name>`,
    the tools' default sizes; bench_prims with `16 extra`), with every
    probe's launch count reset just before and read just after; each
    prints its variants' device time and clock64 cycles per step. Then
    every variant again at PROBE_CHECK_ITERS steps (PROBE_CHECK_VISITS
    leaf visits): its kernel against its plain version, both on the card,
    and both timed there (the plain version's second call, on the host
    clock, since it reads values back each step). Returns the six entries
    of the kernels' JSON line: `ms`, `plain_ms` and `bound_ms` are the
    first variant's at the check's size; each variant's time, cycles and
    bound at the tool's size are under `tool_size`."""
    import torch

    from idkengine_tpu_torch.tools import (bench_dual, bench_mxu_leaf, bench_prims, bench_reduce,
                                           bench_slab)

    t_start = time.perf_counter()
    for module in (bench_slab, bench_mxu_leaf, bench_reduce, bench_dual, bench_prims):
        module.reset_launch_counts()
    runs = {"bench_slab": bench_slab.main([]), "bench_mxu_leaf": bench_mxu_leaf.main([]),
            "bench_reduce": bench_reduce.main([]), "bench_dual": bench_dual.main([])}
    runs["bench_prims"], runs["bench_prims_extra"] = split_extra(
        bench_prims.main([str(bench_prims.DEFAULT_K), "extra"]))
    launches = read_probe_launches()
    log(f"# probes through their mains on {card}: {time.perf_counter() - t_start:.1f} s, "
        f"launches {launches}, vpu/form agreement {runs['bench_mxu_leaf'].pop('agreement'):.4f}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched by the probes' mains")
    restated = restate_bounds(runs, card)

    n = PROBE_CHECK_ITERS
    checks = {"bench_slab": bench_slab.variants(dev, iters=n),
              "bench_mxu_leaf": bench_mxu_leaf.variants(dev, n_visits=PROBE_CHECK_VISITS),
              "bench_reduce": bench_reduce.variants(dev, n), "bench_dual": bench_dual.variants(dev, n)}
    checks["bench_prims"], checks["bench_prims_extra"] = split_extra(
        bench_prims.variants(dev, n, extra=True))
    entries = []
    for name, variants in checks.items():
        steps = PROBE_CHECK_VISITS if name == "bench_mxu_leaf" else n
        per = {}
        for label, v in variants.items():
            run = runs[name][label]
            err, share = compare_probe(v.kernel(), v.plain(),
                                       bench_mxu_leaf.T_TOL.get(label) if name == "bench_mxu_leaf"
                                       else None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v.plain()
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            ms = cuda_time_ms(v.kernel, 3)
            cyc = {k: c for k, c in run.items() if k.startswith("cycles_per_")}
            per[label] = dict(steps=steps, ms=ms, plain_ms=plain_ms, **v.bound, max_abs_err=err,
                              agreement=share, tool_size=dict(ms=run["ms"], **cyc, **run["bound"],
                                                              **restated[name][label]))
            b = run["bound"]
            log(f"# {name} {label}: at the tool's size {run['ms']:.4f} ms, "
                f"{next(iter(cyc.values())):.1f} {next(iter(cyc))}, bound {b['bound_ms']:.6f} ms "
                f"by {b['bound_by']} (one SM {b['one_sm_ms']:.4f} ms); at {steps} steps kernel "
                f"{ms:.4f} ms, plain {plain_ms:.1f} ms, bound {v.bound['bound_ms']:.6f} ms; "
                + ("bit-equal" if name != "bench_mxu_leaf" else
                   f"slots agree on {share:.6f}, max |diff| of t {err:g}"))
        first = next(iter(per.values()))
        entries.append(dict(name=name, **PROBES_WHERE[name], launches=launches[name],
                            launches_by_path={"probes": launches[name]}, steps=first["steps"],
                            ms=first["ms"], plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
                            bound_by=first["bound_by"], library_ms=None,
                            max_abs_err=max(p["max_abs_err"] for p in per.values()),
                            variants=per))
    log(f"# phase 13 (probes) took {time.perf_counter() - t_start:.1f} s")
    return entries


def textured_atrium(dev, seed, tris):
    """The atrium with texture_atrium's material model on `dev`, and its
    per-mesh overrides set."""
    from idkengine_tpu_torch.bvh.builder import BuildSettings
    from idkengine_tpu_torch.scene.procedural import atrium, texture_atrium
    from idkengine_tpu_torch.scene.scene_db import SceneDatabase

    model = atrium(tris)
    shading = texture_atrium(model, seed)
    db = SceneDatabase(BuildSettings(**BUILD))
    db.add_model(model)
    scene = db.build(dev)
    for pos, rad, r in LIGHTS:
        db.lights.add(pos, rad, radius=r)
    for k, kw in shading.items():
        db.set_mesh_shading(k, **kw)
    return db, scene, shading


def textured_env(dev, width, height, path=None):
    """The env map: compute_atmosphere on `dev`, with a small sun; where
    `path` is given, written there as flat RGBE and read back (load_hdr)."""
    from idkengine_tpu_torch.render.sky import compute_atmosphere
    from idkengine_tpu_torch.scene.hdr import load_hdr, save_hdr

    env = compute_atmosphere(width, height, device=dev)
    env[height // 5:height // 5 + height // 64 + 1, width // 3:width // 3 + width // 64 + 1] = 60.0
    if path is None:
        return env
    save_hdr(path, env)
    return load_hdr(path)


def textured_settings():
    from idkengine_tpu_torch.render import PathTracerSettings

    return PathTracerSettings(ray_depth=DEPTH, russian_roulette=False, do_ray_sorting=True,
                              sky_strength=1.0, use_env_map=True, env_nee=True)


def record_pt_traces(pt, cam, render=None):
    """The trace calls (kind, label, o, d, t_max) of one frame of `pt`, in
    the order the tracer makes them, recorded by standing in for the
    tracer's trace functions. `render` (default pt.render_frame(cam)) makes
    the frame."""
    from idkengine_tpu_torch.render import pathtracer as pathtracer_mod

    calls = []

    def recording(kind):
        fn = getattr(pathtracer_mod, kind)

        def run(scene, o, d, t_max, tag=""):
            calls.append((kind, o, d, t_max, tag))
            return fn(scene, o, d, t_max, tag=tag)
        return run

    saved = pathtracer_mod.trace_closest, pathtracer_mod.trace_any
    pathtracer_mod.trace_closest, pathtracer_mod.trace_any = (recording("trace_closest"),
                                                              recording("trace_any"))
    try:
        render() if render is not None else pt.render_frame(cam)
    finally:
        pathtracer_mod.trace_closest, pathtracer_mod.trace_any = saved
    if len(calls) != DEPTH * len(TEXTURED_CALLS):
        raise AssertionError(f"the textured frame made {len(calls)} trace calls, not "
                             f"{DEPTH * len(TEXTURED_CALLS)}")
    tags = [c[4] for c in calls]
    want = [t.replace("pri", "bnc") if n >= len(TEXTURED_TAGS) else t
            for n, t in enumerate(TEXTURED_TAGS * DEPTH)]
    if tags != want:
        raise AssertionError(f"the textured frame's call-site tags are {tags}, not {want}")
    return [(kind, f"bounce {n // len(TEXTURED_CALLS)} {TEXTURED_CALLS[n % len(TEXTURED_CALLS)]}",
             o, d, t_max) for n, (kind, o, d, t_max, _tag) in enumerate(calls)]


def phase_textured(dev, card, seed, factor_frame, timings):
    """Phase 14: the textured frame (see the module's docstring). Returns
    the launch counts of its timed path-traced frames and of its deferred
    frame, the textured scene's database (phase 17 renders it) and the
    accumulated radiance of its first frame (one sample, phase 21's
    reference)."""
    import numpy as np
    import torch

    from idkengine_tpu_torch.ops import packet_trace as kern
    from idkengine_tpu_torch.render import Camera, DeferredPipeline, PathTracer
    from idkengine_tpu_torch.render.tonemap import tonemap

    t_start = time.perf_counter()
    cam = Camera(position=np.array(CAMERA["position"], np.float32), yaw=CAMERA["yaw"],
                 fov_y=CAMERA["fov_y"])
    db, scene, shading = textured_atrium(dev, seed, TRIS)
    torch_sync(dev)
    t1 = time.perf_counter()
    soa = db.materials.soa()
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_sky.hdr")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    env = textured_env(dev, *ENV_SIZE, path)
    t2 = time.perf_counter()
    log(f"# textured atrium {db.meta.n_triangles} tris (seed {seed}): scene {t1 - t_start:.1f} s; "
        f"atlas {soa['atlas'].shape[0]} layers, {soa['atlas'].nbytes / 1e6:.1f} MB; per-mesh "
        f"overrides on placements {sorted(shading)} of {db.n_meshes}; env map "
        f"{ENV_SIZE[0]}x{ENV_SIZE[1]} through flat RGBE ({os.path.getsize(path) / 1e6:.1f} MB) "
        f"in {t2 - t1:.2f} s")
    pt = PathTracer(scene, soa, db.lights.soa(), WIDTH, HEIGHT, textured_settings(), env_map=env,
                    slot_shading=db.slot_shading(), device=dev)
    torch_sync(dev)
    t3 = time.perf_counter()
    pt.render_frame(cam)  # warm-up
    torch_sync(dev)
    first_frame = pt.image().clone()  # sample 0 alone: phase 21 holds the Engine's frame to it
    log(f"# textured tracer init (attribute pack, alias table) {t3 - t2:.2f} s, warm-up frame "
        f"{time.perf_counter() - t3:.2f} s")

    reset_all_launch_counts()
    rays = 0.0
    t0 = time.perf_counter()
    for _ in range(TIMED_FRAMES):
        img = pt.render_frame(cam)
        rays += float(pt.last_rays_traced)
    torch_sync(dev)
    dt = time.perf_counter() - t0
    launches = {"pathtracer_textured": read_launch_counts()}
    per_frame = {k: v / TIMED_FRAMES for k, v in launches["pathtracer_textured"].items() if v}
    ms = dt / TIMED_FRAMES * 1e3
    log(f"# textured frame: {ms:.2f} ms/frame, {rays / dt / 1e6:.2f} Mrays/s "
        f"({rays / TIMED_FRAMES / 1e6:.3f} Mrays/frame), {WIDTH}x{HEIGHT} depth {DEPTH}, "
        f"textures, alpha test, normal maps, env NEE, per-mesh overrides; beside the factor-only "
        f"frame (phase 5) {factor_frame['ms']:.2f} ms/frame, {factor_frame['mrays_per_s']:.2f} "
        f"Mrays/s; on {card}; launches per frame {per_frame}")
    for name in ("trace_closest", "trace_any"):
        if launches["pathtracer_textured"][name] == 0:
            raise AssertionError(f"{name} was not launched on the textured frame")
    out = tonemap(img)
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("textured image is not a finite (H,W,3) array")
    if not (img.std().item() > 0 and 0.0 <= out.min().item() and out.max().item() <= 1.0):
        raise AssertionError("textured image is flat or its tonemap leaves [0,1]")
    log(f"# textured image: mean {img.mean().item():.5f}, std {img.std().item():.5f}, "
        f"tonemapped mean {out.mean().item():.5f}")
    prof = profile_frame(lambda: pt.render_frame(cam), "textured frame",
                         lambda k: k.startswith(PT_RANGES))
    check_trace_buckets(prof, "textured frame")
    alpha_ms, env_any_ms, env_rounds_ms = (hand_trace_ms(prof, site) for site in (
        "pt_closest_pria", "pt_any_enva", "pt_closest_enva"))
    if not (alpha_ms > 0 and env_any_ms > 0):
        raise AssertionError("the textured frame's primary alpha re-traces or env shadow rays "
                             "launched no hand kernel in their call-site ranges")
    log(f"# textured frame: the primaries' alpha re-traces (pt_closest_pria) {alpha_ms:.3f} ms "
        f"in primary; the env shadow rays' any-hit tail (pt_any_enva) {env_any_ms:.3f} ms in "
        f"nee; their alpha rounds' closest hits (pt_closest_enva) {env_rounds_ms:.3f} ms in "
        f"trace_other, where the JAX package's rule puts pt_closest_*_enva")

    # each trace call of one frame through its kernel, grouped by what it
    # traces; then the kernels against their plain versions on the new batches
    calls = record_pt_traces(pt, cam)
    by_what, any_ms = {}, 0.0
    for kind, label, o, d, t_max in calls:
        call_ms = cuda_time_ms(lambda: getattr(kern, kind)(scene, o, d, t_max), 5)
        live = int((t_max >= 0).sum().item())
        what = label.split(" ", 2)[2].rstrip(" 12")
        by_what[what] = by_what.get(what, 0.0) + call_ms
        extra = ""
        if label.endswith("NEE round 1"):
            # the same shadow rays as one any-hit trace: their cost without alpha
            one_ms = cuda_time_ms(lambda: kern.trace_any(scene, o, d, t_max), 5)
            any_ms += one_ms
            extra = f"; as one any-hit trace {one_ms:.4f} ms"
        log(f"#   {label} ({kind}): {live} live rays of {o.shape[0]}, kernel {call_ms:.4f} ms"
            f"{extra}")
    kernel_ms = sum(by_what.values())
    log(f"# textured frame's trace kernels {kernel_ms:.3f} ms a frame: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in by_what.items()))
    shadow_ms = sum(v for k, v in by_what.items() if "NEE" in k)
    if prof is not None:
        passes = prof["passes"]
        tex_ms = passes.get("pt/textures", 0.0)
        retrace_ms = passes.get("pt/alpha re-traces", 0.0) + by_what["alpha re-trace"]
        rounds_ms = passes.get("pt/shadow alpha rounds", 0.0) + shadow_ms - any_ms
        log(f"# textured frame's shares of {ms:.2f} ms: texture sampling (pt/textures) "
            f"{tex_ms:.2f} ms ({tex_ms / ms * 100:.1f}%); alpha re-traces of the camera and "
            f"bounce rays (their glue and kernels) {retrace_ms:.2f} ms "
            f"({retrace_ms / ms * 100:.1f}%); the shadow rays' alpha rounds above one any-hit "
            f"trace (glue and kernels, {shadow_ms:.2f} ms against {any_ms:.2f} ms) "
            f"{rounds_ms:.2f} ms ({rounds_ms / ms * 100:.1f}%); device busy {prof['busy_ms']:.2f}"
            f" ms of {prof['wall_ms']:.2f} ms wall, the hand kernels apart")
    checks = {"bounce 0 alpha re-trace 1": "the first alpha re-trace batch",
              "bounce 0 env-NEE round 1": "the env-NEE shadow batch (first round)",
              "bounce 0 env-NEE any-hit tail": "the env-NEE shadow batch (any-hit tail)"}
    for kind, label, o, d, t_max in calls:
        if label not in checks:
            continue
        _, m, agree = compare_trace(kind, scene, o, d, t_max, reps=5)
        m.update(steps_stats(scene, o, d, t_max))
        log_batch(kind, f"textured frame, {checks[label]}", o, m, agree,
                  f"; live rays {int((t_max >= 0).sum().item())}; on {card}")
        entry = timings[kind]
        entry["max_abs_err"] = max(entry["max_abs_err"], m["max_abs_err"])
        entry["batches"].append(dict(batch=f"textured {label}", rays=o.shape[0], agreement=agree,
                                     **m))
    del pt, calls

    # one deferred frame of the textured scene, per-mesh overrides on
    pipe = DeferredPipeline(db, WIDTH, HEIGHT, _deferred_settings(VXGI_RES), device=dev)
    if pipe.slot_shading() is None:
        raise AssertionError("the deferred pipeline took no per-mesh overrides")
    t0 = time.perf_counter()
    pipe.render_frame(cam)  # warm-up
    torch_sync(dev)
    warm = time.perf_counter() - t0
    reset_all_launch_counts()
    t0 = time.perf_counter()
    out = pipe.render_frame(cam)
    torch_sync(dev)
    launches["deferred_textured"] = read_launch_counts()
    log(f"# textured deferred frame: {(time.perf_counter() - t0) * 1e3:.2f} ms (one frame after a "
        f"{warm:.2f} s warm-up), {WIDTH}x{HEIGHT}, VXGI {VXGI_RES}^3, per-mesh overrides, on "
        f"{card}; launches {launches['deferred_textured']}")
    if tuple(out.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError("textured deferred image is not a finite (H,W,3) array")
    if not (0.0 <= out.min().item() and out.max().item() <= 1.0 and out.std().item() > 0.01):
        raise AssertionError("textured deferred image leaves [0,1] or is flat")
    del pipe
    torch.cuda.empty_cache()

    # a small textured, alpha-tested, env-lit render on the card and the CPU
    env_small = textured_env("cpu", 64, 32)
    imgs = []
    for device in (dev, "cpu"):
        sdb, sscene, _ = textured_atrium(device, seed, 8000)
        spt = PathTracer(sscene, sdb.materials.soa(), sdb.lights.soa(), 96, 54,
                         textured_settings(), env_map=env_small,
                         slot_shading=sdb.slot_shading(), device=device)
        imgs.append(spt.render_frame(cam).cpu().numpy())
    rmse = float(np.sqrt(np.mean((imgs[0] - imgs[1]) ** 2)))
    log(f"# small textured atrium 96x54, env NEE: card vs CPU RMSE {rmse:.3g} (limit "
        f"{SMALL_RMSE})")
    if not rmse <= SMALL_RMSE:
        raise AssertionError("the card's textured render disagrees with the CPU render")
    log(f"# phase 14 (textured frame) took {time.perf_counter() - t_start:.1f} s")
    return launches, db, first_frame


def capped_caps(p99):
    """Phase 15's caps: CAP_LOW, and the next multiple of CAP_STEP above
    `p99`, the largest 99th percentile of the batches' binary-tree steps."""
    return CAP_LOW, (int(p99) // CAP_STEP + 1) * CAP_STEP


def warp_trips(steps) -> int:
    """The loop trips of warps of WARP rays in launch order, a ray a lane,
    each warp walking until its longest ray stops (the last warp's missing
    lanes idle): the sum over warps of the warp's most steps."""
    import torch

    s = steps.reshape(-1).long()
    s = torch.nn.functional.pad(s, (0, -s.numel() % WARP))
    return int(s.reshape(-1, WARP).amax(1).sum().item())


def lane_utilization(steps) -> float:
    """The share of lane-steps that do work when each thread walks one ray:
    sum(steps) / (WARP * warp_trips(steps)); the most a per-lane ray refill
    could raise it to is 1."""
    trips = warp_trips(steps)
    return int(steps.long().sum().item()) / (WARP * trips) if trips else 1.0


def phase_capped(scene, batches, results, card):
    """Phase 15: the capped kernels against their plain versions on phase
    4's batches at CAP_LOW and at a cap above every batch's p99 steps.
    Returns (the caps, each capped kernel's numbers for the kernels' line:
    its first batch at CAP_LOW stands for it, every batch under "batches")."""
    import torch

    from idkengine_tpu_torch.ops import packet_trace as kern
    from idkengine_tpu_torch.ops import trace as plain

    p99 = max(b["steps_p99"] for kind in ("trace_closest", "trace_any")
              for b in results[kind]["batches"] if b["batch"] in batches)
    caps = capped_caps(p99)
    out = {}
    for label, (kind, o, d, t_max) in batches.items():
        any_hit = kind == "trace_any"
        name = f"{kind}_capped"
        r = o.shape[0]
        for cap in caps:
            got = getattr(kern, kind)(scene, o, d, t_max, max_steps=cap)
            steps = torch.zeros(r, dtype=torch.int32, device=o.device)
            t0 = time.perf_counter()
            want = plain._traverse(scene, o, d, t_max, any_hit, steps, cap)
            torch_sync(o.device)
            plain_ms = (time.perf_counter() - t0) * 1e3
            if any_hit:
                err = (got != (want.slot >= 0)).sum().item()
                if err:
                    raise AssertionError(f"{name} (cap {cap}, {label}): occlusion differs on "
                                         f"{err} rays")
            else:
                for k in ("t", "slot", "u", "v"):
                    if not torch.equal(getattr(got, k), getattr(want, k)):
                        raise AssertionError(f"{name} (cap {cap}, {label}): {k} differs")
                err = 0.0
            util = lane_utilization(steps)
            # the share the cap stopped: rays that would take a step more
            longer = torch.zeros_like(steps)
            plain._traverse(scene, o, d, t_max, any_hit, longer, cap + 1)
            stopped = (longer > cap).float().mean().item()
            ms = cuda_time_ms(lambda: getattr(kern, kind)(scene, o, d, t_max, max_steps=cap), 10)
            # rays (o, d, t_max) read once, results written once, and each
            # 32-byte threaded record and each 36-byte triangle that a walk
            # reads, read once (a record read again comes from L2: counted a
            # step at a time, 57.5 steps a primary at cap 64 gave 1.17 ms,
            # above the kernel's 0.53 ms on an H100 80GB HBM3 at 700 W)
            visited = (torch.zeros(scene.bvh_thread.shape[0], dtype=torch.bool, device=o.device),
                       torch.zeros(scene.tri_p0.shape[0], dtype=torch.bool, device=o.device))
            plain._traverse(scene, o, d, t_max, any_hit, max_steps=cap, visited=visited)
            records, tris = (int(v.sum().item()) for v in visited)
            taken = int(steps.long().sum().item())
            nbytes = r * 28 + r * (1 if any_hit else 16) + records * 32 + tris * 36
            m = dict(max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                     bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None)
            log(f"# {name}, {label} batch ({r} rays), cap {cap}: kernel {ms:.4f} ms, bound "
                f"{m['bound_ms']:.4f} ms ({records} records and {tris} triangles read; "
                f"{taken / r:.2f} steps a ray, at 32 B a step "
                f"{(r * 28 + r * (1 if any_hit else 16) + taken * 32) / HBM_BYTES_PER_S * 1e3:.4f}"
                f" ms), plain {plain_ms:.1f} ms; "
                f"the cap stopped {stopped:.4f} of the rays; lane utilization of a ray a "
                f"thread {util:.4f}; {'occlusion' if any_hit else 't, slot, u, v'} equal on "
                f"every ray; on {card}")
            entry = out.setdefault(name, dict(m, batches=[]))
            entry["max_abs_err"] = max(entry["max_abs_err"], m["max_abs_err"])
            entry["batches"].append(dict(batch=label, cap=cap, rays=r, stopped=stopped,
                                         lane_utilization=util,
                                         steps_mean=taken / r, records_read=records,
                                         triangles_read=tris, **m))
    phase_capped_steps(scene, batches["primary"][1:], caps, results["trace_closest_steps"], card)
    return caps, out


def phase_capped_steps(scene, rays, caps, entry, card):
    """Phase 15's capped steps kernel: trace_closest_steps with max_steps
    (the JAX trace's cap) against its plain version on phase 4's
    primaries at each cap, steps and hits bit-equal, timed beside the
    uncapped steps kernel on the same rays; each cap a batch of `entry`
    (phase 11's trace_closest_steps)."""
    import torch

    from idkengine_tpu_torch.ops import packet_trace as kern
    from idkengine_tpu_torch.ops import trace as plain

    o, d, t_max = rays
    r = o.shape[0]
    uncapped_ms = cuda_time_ms(lambda: kern.trace_closest_steps(scene, o, d, t_max), 10)
    for cap in caps:
        got, steps = kern.trace_closest_steps(scene, o, d, t_max, max_steps=cap)
        t0 = time.perf_counter()
        want, want_steps = plain.trace_closest_steps(scene, o, d, t_max, max_steps=cap)
        torch_sync(o.device)
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(steps, want_steps) or int(steps.max().item()) > cap:
            raise AssertionError(f"capped trace_closest_steps (cap {cap}): steps differ on "
                                 f"{(steps != want_steps).sum().item()} rays")
        for k in ("t", "slot", "u", "v"):
            if not torch.equal(getattr(got, k), getattr(want, k)):
                raise AssertionError(f"capped trace_closest_steps (cap {cap}): {k} differs")
        ms = cuda_time_ms(lambda: kern.trace_closest_steps(scene, o, d, t_max, max_steps=cap),
                          10)
        stopped = (steps == cap).float().mean().item()
        log(f"# trace_closest_steps, primary batch ({r} rays), cap {cap}: kernel {ms:.4f} ms "
            f"(uncapped {uncapped_ms:.4f} ms), plain {plain_ms:.1f} ms; {stopped:.4f} of the "
            f"rays at the cap; steps, t, slot, u, v equal on every ray; on {card}")
        entry.setdefault("batches", []).append(dict(
            batch="primary", cap=cap, rays=r, ms=ms, uncapped_ms=uncapped_ms, plain_ms=plain_ms,
            at_cap=stopped, max_abs_err=0.0))


def phase_capped_frames(db, scene, cam, dev, card, caps, ref):
    """Phase 16: path-traced frames of phase 5's settings with a step cap
    at each of phase 15's caps, and with tiles of 1920*1080/TILE_SPLIT
    rays; TIMED_FRAMES timed frames each, the launch counts reset just
    before them. Each tracer renders as many frames as phase 5's had (ref:
    its image and frame count); the tiled accumulation must equal phase
    5's bit for bit. A cap changes the image, so a capped frame is only
    checked to be finite and to launch the capped kernels, and its RMSE
    against phase 5's accumulation is printed, not held to a bound (phase
    15 holds the capped kernels to the plain walk). Returns the launch
    counts of each path."""
    from dataclasses import replace

    import torch

    from idkengine_tpu_torch.render import PathTracer, PathTracerSettings

    base = PathTracerSettings(ray_depth=DEPTH, russian_roulette=False, do_ray_sorting=True,
                              sky_strength=1.0)
    tile = WIDTH * HEIGHT // TILE_SPLIT
    runs = {f"pathtracer_cap{cap}": dict(max_trace_steps=cap) for cap in caps}
    runs["pathtracer_tiled"] = dict(tile_size=tile)
    launches = {}
    for label, kw in runs.items():
        pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), WIDTH, HEIGHT,
                        replace(base, **kw), device=dev)
        for _ in range(ref["frames"] - TIMED_FRAMES):
            pt.render_frame(cam)
        torch_sync(dev)
        reset_all_launch_counts()
        rays = 0.0
        t0 = time.perf_counter()
        for _ in range(TIMED_FRAMES):
            img = pt.render_frame(cam)
            rays += float(pt.last_rays_traced)
        torch_sync(dev)
        ms = (time.perf_counter() - t0) / TIMED_FRAMES * 1e3
        launches[label] = read_launch_counts()
        if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{label}: the image is not a finite (H,W,3) array")
        rmse = ((img - ref["image"]) ** 2).mean().sqrt().item()
        if "tile_size" in kw:
            if not torch.equal(img, ref["image"]):
                raise AssertionError("the tiled accumulation differs from phase 5's untiled one")
            if launches[label]["trace_closest"] != TIMED_FRAMES * DEPTH * TILE_SPLIT:
                raise AssertionError(f"the tiled frames made {launches[label]['trace_closest']} "
                                     f"closest-hit launches")
            what = f"tiles of {tile} rays, accumulation bit-equal to phase 5's"
        else:
            for name in ("trace_closest_capped", "trace_any_capped"):
                if launches[label][name] == 0:
                    raise AssertionError(f"{name} was not launched on the capped frame")
            what = (f"max_trace_steps {kw['max_trace_steps']}, RMSE against phase 5's "
                    f"uncapped accumulation {rmse:.4g}")
        log(f"# {label}: {ms:.2f} ms/frame (phase 5's {ref['ms']:.2f}), "
            f"{rays / TIMED_FRAMES / 1e6:.3f} Mrays/frame, {what}; launches in "
            f"{TIMED_FRAMES} frames {launches[label]}; on {card}")
        del pt
    return launches


def _check_deferred_image(out, label):
    import torch

    if tuple(out.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}: the deferred image is not a finite (H,W,3) array")
    if not (0.0 <= out.min().item() and out.max().item() <= 1.0 and out.std().item() > 0.01):
        raise AssertionError(f"{label}: the deferred image leaves [0,1] or is flat")


def phase_deferred_passes(db, cam, dev, card, results):
    """Phase 17: the deferred frame at full width on the textured scene with
    phase 7's settings, each new pass on alone, and all of them on; one
    frame of each setting profiled (each pass's device time, the launches,
    the busy share; the hand kernels apart, their launches by pass from
    each setting's counts beside the base's). The first frame of the PCF
    setting (which builds the maps) and of the all-on setting is recorded,
    and the trace calls of their new passes (RECORD_PASSES) are held
    against the plain trace, each added to the kernel's batches in
    results. Returns the launch counts of each setting's timed frames."""
    from dataclasses import replace

    import torch

    from idkengine_tpu_torch.render import DeferredPipeline

    runs = {"deferred_base": {}}
    runs.update({f"deferred_{k}": kw for k, kw in DEFERRED_PASSES.items()})
    runs["deferred_all_on"] = ALL_ON
    launches, per_frame, frame_ms = {}, {}, {}
    for label, kw in runs.items():
        pipe = DeferredPipeline(db, WIDTH, HEIGHT, replace(_deferred_settings(VXGI_RES), **kw),
                                device=dev)
        t0 = time.perf_counter()
        if label in RECORD_PASSES:  # warm-up; with PCF it builds the maps
            calls = record_deferred_traces(pipe, cam)
        else:
            pipe.render_frame(cam)
        torch_sync(dev)
        first_ms = (time.perf_counter() - t0) * 1e3
        reset_all_launch_counts()
        t0 = time.perf_counter()
        for _ in range(PASS_FRAMES):
            out = pipe.render_frame(cam)
        torch_sync(dev)
        frame_ms[label] = (time.perf_counter() - t0) / PASS_FRAMES * 1e3
        launches[label] = read_launch_counts()
        per_frame[label] = {k: v / PASS_FRAMES for k, v in launches[label].items() if v}
        _check_deferred_image(out, label)
        extra = ""
        if label != "deferred_base":
            base = per_frame["deferred_base"]
            extra = (f"; {frame_ms[label] - frame_ms['deferred_base']:+.2f} ms and kernel "
                     f"launches {({k: v - base.get(k, 0) for k, v in per_frame[label].items()})} "
                     f"a frame beside the base")
        if "shadows" in kw:
            builds = pipe._shadow_mgr.builds
            if builds != len(db.lights.lights):
                raise AssertionError(f"PCF built {builds} maps for {len(db.lights.lights)} "
                                     f"lights over {PASS_FRAMES + 1} frames of one camera")
            extra += (f"; first frame {first_ms:.2f} ms (builds {builds} maps of "
                      f"6x{pipe.settings.shadow_map_res}^2 rays, faces culled against the "
                      f"camera), then cached")
        if kw.get("use_classifier"):
            rate = pipe.rate_map
            if tuple(rate.shape) != (HEIGHT // 16, WIDTH // 16) or not bool(
                    torch.isfinite(rate).all()):
                raise AssertionError("the rate map is not a finite tile map")
            extra += f"; rate map mean {rate.mean().item():.4f}"
        log(f"# {label}: {frame_ms[label]:.2f} ms/frame over {PASS_FRAMES} warm frames, "
            f"{WIDTH}x{HEIGHT}, phase 7's settings{' + ' + str(kw) if kw else ''}, textured "
            f"{TRIS // 1000}k-tri atrium; launches a frame {per_frame[label]}{extra}; on {card}")
        profile_frame(lambda: pipe.render_frame(cam), f"{label} frame",
                      lambda key: key.startswith("deferred/"))
        del pipe
        if label in RECORD_PASSES:
            compare_recorded(calls, f"{label} first frame", results, card,
                             RECORD_PASSES[label])
            del calls
        torch.cuda.empty_cache()
    return launches


def phase_small_passes(dev, seed):
    """Phase 18: each new deferred pass (SSR and OIT on the textured small
    atrium, whose metal and blended cloth they need; the others on the
    plain one), and the path-tracer pipeline with the adaptive bounce
    budget, rendered at 96x54 on the card and on the CPU."""
    import numpy as np

    from idkengine_tpu_torch.bvh.builder import BuildSettings
    from idkengine_tpu_torch.render import (Camera, DeferredPipeline, DeferredSettings2,
                                            PathTracerPipeline, PathTracerSettings,
                                            PtPipelineSettings)
    from idkengine_tpu_torch.scene.procedural import atrium
    from idkengine_tpu_torch.scene.scene_db import SceneDatabase

    cam = Camera(position=np.array(CAMERA["position"], np.float32), yaw=CAMERA["yaw"],
                 fov_y=CAMERA["fov_y"])

    def small_db(device, textured):
        if textured:
            return textured_atrium(device, seed, 8000)[0]
        db = SceneDatabase(BuildSettings(**BUILD))
        db.add_model(atrium(8000))
        db.build(device)
        for pos, rad, r in LIGHTS:
            db.lights.add(pos, rad, radius=r)
        return db

    renders = {f"deferred {k}": (k in ("ssr", "oit"), kw) for k, kw in DEFERRED_PASSES.items()}
    renders["pt pipeline adaptive_rate"] = (False, None)
    for label, (textured, kw) in renders.items():
        imgs = []
        for device in (dev, "cpu"):
            db = small_db(device, textured)
            if kw is None:
                pipe = PathTracerPipeline(db, 96, 54, PathTracerSettings(
                    ray_depth=DEPTH, russian_roulette=False, do_ray_sorting=True),
                    PtPipelineSettings(adaptive_rate=True), device=device)
                frames = 3
            else:
                pipe = DeferredPipeline(db, 96, 54, DeferredSettings2(**kw), device=device)
                frames = 2
            for _ in range(frames):
                img = pipe.render_frame(cam)
            imgs.append(img.cpu().numpy())
        rmse = float(np.sqrt(np.mean((imgs[0] - imgs[1]) ** 2)))
        log(f"# small {label} 96x54{' (textured)' if textured else ''}: card vs CPU RMSE "
            f"{rmse:.3g} (limit {SMALL_RMSE})")
        if not (rmse <= SMALL_RMSE and np.isfinite(imgs[0]).all() and imgs[0].std() > 0.01):
            raise AssertionError(f"the card's small {label} render disagrees with the CPU's")


def sphere_model(n_lat, n_lon, radius=1.0):
    """tests/test_instancing.py's sphere model (one primitive, one node)."""
    import numpy as np

    from idkengine_tpu_torch.scene.model import Material, MeshPrimitive, Model, Node
    from idkengine_tpu_torch.scene.procedural import make_uv_sphere

    pos, idx = make_uv_sphere([0.0, 0.0, 0.0], radius, n_lat=n_lat, n_lon=n_lon)
    prim = MeshPrimitive(positions=pos.astype(np.float32), indices=idx.astype(np.uint32))
    prim.ensure_normals()
    return Model(primitives=[prim], nodes=[Node(mesh_primitives=[0])], root_nodes=[0],
                 materials=[Material(name="inst",
                                     base_color=np.array([0.9, 0.2, 0.2, 1], np.float32))])


def instance_matrices(seed, count=INSTANCE_COUNT):
    """(count,4,4) world matrices from `seed`: a uniform scale of 0.5-1.5, a
    turn about y, x in [-8, 8], y in [1, 4], z in [-20, 16] m (in front of
    the camera at (0, 3, 24))."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mats = np.tile(np.eye(4, dtype=np.float32), (count, 1, 1))
    for m in mats:
        s, a = rng.uniform(0.5, 1.5), rng.uniform(0.0, 2 * np.pi)
        c, n = np.cos(a), np.sin(a)
        m[:3, :3] = s * np.array([[c, 0, n], [0, 1, 0], [-n, 0, c]])
        m[:3, 3] = rng.uniform([-8, 1, -20], [8, 4, 16])
    return mats


def sway_animation():
    """Phase 19's animation of the root node: LINEAR keyframes at 0, 1 and
    2 s, at rest at 0 and 2 s, DYN_SHIFT and a turn of DYN_TURN degrees
    about y at 1 s."""
    import numpy as np

    from idkengine_tpu_torch.scene.model import Animation, AnimationChannel, AnimationSampler

    times = np.float32([0.0, 1.0, 2.0])
    half = np.radians(DYN_TURN) / 2
    shift = np.float32([[0, 0, 0], DYN_SHIFT, [0, 0, 0]])
    turn = np.float32([[0, 0, 0, 1], [0, np.sin(half), 0, np.cos(half)], [0, 0, 0, 1]])
    return Animation("sway", [AnimationChannel(0, "translation", AnimationSampler(times, shift)),
                              AnimationChannel(0, "rotation", AnimationSampler(times, turn))])


def dynamic_scene(dev, seed, tris=TRIS):
    """Phases 19-20's database: phase 3's atrium unhoisted with its root
    node animated, and INSTANCE_COUNT instances of the sphere; phase 3's
    lights. Returns (db, build seconds)."""
    from idkengine_tpu_torch.bvh.builder import BuildSettings
    from idkengine_tpu_torch.scene.procedural import atrium
    from idkengine_tpu_torch.scene.scene_db import SceneDatabase

    model = atrium(tris)
    model.animations.append(sway_animation())
    t0 = time.perf_counter()
    db = SceneDatabase(BuildSettings(**BUILD))
    db.add_model(model, hoist=False)
    db.add_instanced_model(sphere_model(**SPHERE_RES), instance_matrices(seed))
    db.build(dev)
    torch_sync(dev)
    for pos, rad, r in LIGHTS:
        db.lights.add(pos, rad, radius=r)
    return db, time.perf_counter() - t0


def _bits_equal(a, b) -> bool:
    import torch

    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def check_device_refit(db, before, after):
    """Phase 19's check of one update_device: the vertices it made (pulled
    to the host) refitted by the C++ core (BLAS.refit, FlatBvh.refresh_boxes)
    give the refitted scene's boxes bit for bit, in the threaded arrays and
    in the box words of every record table (the 4-wide ones through
    bvh4_child, empty children zero); topology words are those of `before`;
    tri_vec holds the slot triangles of those vertices."""
    from dataclasses import replace

    import numpy as np
    import torch

    verts = db.device_vertices.cpu().numpy()
    db.blas.refit(verts)
    flat = replace(db._flat)
    flat.refresh_boxes(db.blas.nodes)
    dev = after.device
    lo = torch.from_numpy(flat.node_min).to(dev)
    hi = torch.from_numpy(flat.node_max).to(dev)
    if not (_bits_equal(after.node_min, lo) and _bits_equal(after.node_max, hi)):
        raise AssertionError("update_device's boxes differ from the host refit's")
    lo_i, hi_i = lo.view(torch.int32), hi.view(torch.int32)
    for name in ("bvh_nodes", "bvh_thread"):
        rec, old = getattr(after, name), getattr(before, name)
        if not (torch.equal(rec[:, 0:3], lo_i) and torch.equal(rec[:, 4:7], hi_i)
                and torch.equal(rec[:, [3, 7]], old[:, [3, 7]])):
            raise AssertionError(f"update_device's {name} differ from the host refit's boxes")
    child = after.bvh4_child.long()
    has, src = child >= 0, torch.clamp(child, min=0)
    wide = after.bvh4_nodes
    for a in range(3):
        for h, words in ((0, lo_i), (4, hi_i)):
            want = torch.where(has, words[src, a], 0)
            if not torch.equal(wide[:, 8 * a + h:8 * a + h + 4], want):
                raise AssertionError("update_device's 4-wide records differ from the host "
                                     "refit's boxes")
    if not torch.equal(wide[:, 24:], before.bvh4_nodes[:, 24:]):
        raise AssertionError("update_device changed the 4-wide records' topology words")
    p = verts[db._indices[db._slot_tri.astype(np.int64)]]
    e1, e2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    want = np.concatenate([p[:, 0], e1, e2, np.zeros_like(e1)], 1)
    if not np.array_equal(after.tri_vec.cpu().numpy(), want):
        raise AssertionError("update_device's tri_vec is not the slot triangles")


def phase_dynamics(db, cam, dev, card, seed, frame_ref):
    """Phase 19 (see the module's docstring). Returns the launch counts of
    the refitted scene's timed frames."""
    import numpy as np
    import torch

    from idkengine_tpu_torch.render import PathTracer, PathTracerSettings
    from idkengine_tpu_torch.scene import skinning

    t_start = time.perf_counter()
    for t in DYN_TIMES:
        before = db.device_scene
        t0 = time.perf_counter()
        after = db.update_device(t)
        torch_sync(dev)
        first_s = time.perf_counter() - t0
        check_device_refit(db, before, after)
        host = db.update(t)
        diff = {k: (getattr(after, k) - getattr(host, k)).abs().max().item()
                for k in ("node_min", "node_max", "tri_p0")}
        for k in diff:
            if not torch.allclose(getattr(after, k), getattr(host, k), **UPDATE_TOL):
                raise AssertionError(f"update_device's {k} differs from the host update's")
        log(f"# update_device({t}): first call {first_s:.2f} s (the refit plan included); boxes "
            f"bit-equal to the C++ host refit of its vertices in node_min/max, bvh_nodes, "
            f"bvh_thread and bvh4_nodes (through bvh4_child), topology words unchanged, tri_vec "
            f"the slot triangles; against the host update at {t}: max |diff| node_min "
            f"{diff['node_min']:.3g}, node_max {diff['node_max']:.3g}, tri_p0 "
            f"{diff['tri_p0']:.3g} (limit rtol {UPDATE_TOL['rtol']}, atol {UPDATE_TOL['atol']})")

    t = DYN_TIMES[-1]
    host_ms = cuda_time_ms(lambda: db.update(t), 2)
    # the same update with the host flatten in place of the device one
    from idkengine_tpu_torch.bvh.flatten import flatten_triangles
    from idkengine_tpu_torch.scene import scene_db as scene_db_mod

    device_flatten = scene_db_mod.flatten_triangles_device
    scene_db_mod.flatten_triangles_device = lambda *a, device: flatten_triangles(*a)
    try:
        host_flatten_ms = cuda_time_ms(lambda: db.update(t), 2)
    finally:
        scene_db_mod.flatten_triangles_device = device_flatten
    db.update(t)
    refitter = db._get_refitter()
    sampled = db.placement_matrices(t)
    verts, normals = db.transform_vertices(*sampled)
    tris = refitter.triangles(verts, normals)
    node_min, node_max = refitter.boxes(tris["corners"], db.device_scene)
    parts = {
        "transform": lambda: db.transform_vertices(*db.placement_matrices(t)),
        "level sweeps": lambda: refitter.boxes(tris["corners"], db.device_scene),
        "record refresh": lambda: refitter.records(
            db.device_scene, refitter.triangles(verts, normals), node_min, node_max),
        "update_device": lambda: db.update_device(t),
    }
    ms = {k: cuda_time_ms(fn, DYN_REPS) for k, fn in parts.items()}
    n_verts, n_tris = verts.shape[0], db.device_scene.tri_p0.shape[0]
    log(f"# update_device at full width ({n_verts} vertices, {n_tris} slots, "
        f"{len(refitter.plan.levels)} interior levels; warm, {DYN_REPS} calls each): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
        + f"; host update (C++ refit, device flatten, upload, 4-wide collapse) {host_ms:.1f} "
        f"ms, with the host flatten {host_flatten_ms:.1f} ms (after it, in the same run); on "
        f"{card}")

    g = torch.Generator(device=dev).manual_seed(seed)
    joints = torch.randint(0, SKIN_JOINTS, (n_verts, 4), generator=g, device=dev)
    weights = torch.rand((n_verts, 4), generator=g, device=dev)
    weights = weights / weights.sum(1, keepdim=True)
    jm = torch.eye(4, device=dev).repeat(SKIN_JOINTS, 1, 1)
    q, _ = torch.linalg.qr(torch.randn((SKIN_JOINTS, 3, 3), generator=g, device=dev))
    jm[:, :3, :3], jm[:, :3, 3] = q, torch.randn((SKIN_JOINTS, 3), generator=g, device=dev)
    skin_ms = cuda_time_ms(lambda: (skinning.skin_positions(verts, joints, weights, jm),
                                    skinning.skin_normals(normals, joints, weights, jm)),
                           DYN_REPS)
    sp = skinning.skin_positions(verts, joints, weights, jm)
    if not bool(torch.isfinite(sp).all()):
        raise AssertionError("skinned positions are not finite")
    log(f"# skinning {n_verts} vertices, 4 of {SKIN_JOINTS} joints a vertex (seed {seed}): "
        f"skin_positions + skin_normals {skin_ms:.3f} ms; on {card}")

    scene = db.update_device(t)
    o, d, t_max = primary_rays(cam, dev)
    _, m, agree = compare_trace("trace_closest", scene, o, d, t_max)
    log(f"# trace_closest on the refitted scene, primaries ({o.shape[0]} rays): kernel "
        f"{m['ms']:.4f} ms, bound {m['bound_ms']:.4f} ms, plain {m['plain_ms']:.1f} ms; "
        f"agreement {agree:.6f}; on {card}")
    settings = PathTracerSettings(ray_depth=DEPTH, russian_roulette=False, do_ray_sorting=True,
                                  sky_strength=1.0)
    pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), WIDTH, HEIGHT, settings,
                    device=dev)
    pt.render_frame(cam)  # warm-up
    torch_sync(dev)
    reset_all_launch_counts()
    t0 = time.perf_counter()
    for _ in range(TIMED_FRAMES):
        img = pt.render_frame(cam)
    torch_sync(dev)
    frame_ms = (time.perf_counter() - t0) / TIMED_FRAMES * 1e3
    launches = read_launch_counts()
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(img).all()) or \
            not img.std().item() > 0:
        raise AssertionError("the refitted scene's image is not a finite, non-flat array")
    for name in ("trace_closest", "trace_any"):
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched on the refitted scene's frame")
    log(f"# refitted scene's frame: {frame_ms:.2f} ms/frame (phase 5's {frame_ref['ms']:.2f}), "
        f"{WIDTH}x{HEIGHT} depth {DEPTH}; launches in {TIMED_FRAMES} frames {launches}; on "
        f"{card}")
    del pt
    log(f"# phase 19 (dynamics) took {time.perf_counter() - t_start:.1f} s")
    return launches, dict(ms, host_update_ms=host_ms, skin_ms=skin_ms, frame_ms=frame_ms)


def check_two_level(kind, got, want, what, exact: bool) -> tuple[int, float]:
    """Raises unless a two-level trace agrees with its plain version. With
    `exact` (the capped kernel, which walks the plain version's order):
    t, slot, u, v, the instance id and occlusion equal on every ray.
    Without (the trace kernel, near children first): occlusion equal on
    every ray; for closest hits phase 4's rule (check_agreement) with the
    instance id beside the slot: the same hit mask, slot and instance equal
    on at least AGREE of the rays, t, u and v bit-equal there. Returns (the
    rays where slot or instance differ, the largest |difference| in t or
    occlusion)."""
    import torch

    if kind == "trace_any":
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: occlusion differs on {(got != want).sum().item()} rays")
        return 0, 0.0
    (hit, inst), (ref, ref_inst) = got, want
    same = (hit.slot == ref.slot) & (inst == ref_inst)
    n_diff = int((~same).sum().item())
    for k in ("t", "u", "v"):
        if not torch.equal(getattr(hit, k)[same], getattr(ref, k)[same]):
            raise AssertionError(f"{what}: {k} differs where slot and instance are equal")
    if not torch.equal(hit.slot >= 0, ref.slot >= 0):
        raise AssertionError(f"{what}: the hit masks differ")
    if (exact and n_diff) or n_diff > (1 - AGREE) * hit.slot.numel():
        raise AssertionError(f"{what}: slot or instance differs on {n_diff} rays")
    both = (hit.slot >= 0) & (ref.slot >= 0)
    return n_diff, torch.where(both, hit.t - ref.t, 0.0).abs().max().item()


def _scene_bytes(scene) -> int:
    """The smallest node table a walk can take and the triangles at 36 B a slot."""
    return (min(scene.bvh4_nodes.numel(), scene.bvh_nodes.numel()) * 4
            + 3 * scene.tri_p0.numel() * 4)


def compare_two_level(kind, static, iset, o, d, t_max, card, label, max_steps=None):
    """One two-level trace (kind "trace_closest" or "trace_any") through the
    fused kernel: one launch, bit-equal on every ray to the launch loop
    over the one-level kernels (ops/trace.py:two_level_closest /
    two_level_any), and against the plain two-level trace
    (check_two_level, exact with max_steps); the kernel and the loop timed
    in turns (kernel, loop, loop, kernel), the bound and the plain time.
    Returns (the kernel's result, its numbers for the kernels' line)."""
    import torch

    from idkengine_tpu_torch.ops import packet_trace as kern
    from idkengine_tpu_torch.ops import trace as plain

    name = f"{kind}_two_level"
    kw = {"slot_off": iset.slot_off} if kind == "trace_closest" else {}
    kw["max_steps"] = max_steps
    args = (static, iset.scenes, iset.inv, iset.boxes, o, d, t_max)
    reset_all_launch_counts()
    got = getattr(kern, name)(*args, **kw)
    torch_sync(o.device)
    launches = getattr(kern, name).launches
    if launches != 1 or kern._trace_launches():
        raise AssertionError(f"{name} made {launches} launches and "
                             f"{kern._trace_launches()} one-level launches, not 1 and 0")
    if kind == "trace_closest":
        def loop():
            return plain.two_level_closest(kern.trace_closest, static, iset.scenes, iset.inv,
                                           iset.boxes, o, d, t_max, iset.slot_off, max_steps)
        (ref, ref_inst), (hit, inst) = loop(), got
        same = all(torch.equal(getattr(hit, k), getattr(ref, k)) for k in ("t", "slot", "u", "v"))
        if not (same and torch.equal(inst, ref_inst)):
            raise AssertionError(f"{name}, {label}: the fused kernel differs from the launch "
                                 "loop")
    else:
        def loop():
            return plain.two_level_any(kern.trace_any, static, iset.scenes, iset.inv, o, d, t_max,
                                       max_steps)
        if not torch.equal(got, loop()):
            raise AssertionError(f"{name}, {label}: the fused kernel's occlusion differs from "
                                 "the launch loop's")
    t0 = time.perf_counter()
    want = getattr(plain, name)(*args, **kw)
    torch_sync(o.device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    n_diff, err = check_two_level(kind, got, want, f"{name}, {label}", max_steps is not None)

    def fused():
        return getattr(kern, name)(*args, **kw)
    ms_a, loop_a = cuda_time_ms(fused, 10), cuda_time_ms(loop, 10)
    loop_b, ms_b = cuda_time_ms(loop, 10), cuda_time_ms(fused, 10)
    r = o.shape[0]
    scenes = {s.tri_vec.data_ptr(): s for s in iset.scenes}.values()
    nbytes = (r * 28 + r * (20 if kind == "trace_closest" else 1) + _scene_bytes(static)
              + sum(_scene_bytes(s) for s in scenes))
    m = dict(max_abs_err=err, ms=(ms_a + ms_b) / 2, plain_ms=plain_ms,
             bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None,
             loop_ms=(loop_a + loop_b) / 2)
    share = ((got[1] >= 0) if kind == "trace_closest" else got).float().mean().item()
    cap = "" if max_steps is None else f", max_steps {max_steps}"
    log(f"# {name}, {label}{cap} ({r} rays): 1 launch a call, fused kernel {ms_a:.4f} / "
        f"{ms_b:.4f} ms, launch loop ({1 + len(iset.scenes)} launches) {loop_a:.4f} / "
        f"{loop_b:.4f} ms (in turns), bound {m['bound_ms']:.4f} ms, plain {plain_ms:.1f} ms; "
        "bit-equal to the loop on every ray; against the plain trace "
        + (f"slot or instance differ on {n_diff} rays, t, u, v equal elsewhere, max |t "
           f"diff| {err:g}; on an instance {share:.4f}"
           if kind == "trace_closest" else f"occlusion equal on every ray; occluded {share:.4f}")
        + f"; on {card}")
    return got, dict(m, batches=[dict(batch=label, rays=r, max_steps=max_steps, differ=n_diff,
                                      **m)])


def small_instanced_db(device):
    """The Cornell box and two instances of a sphere (tests/test_instancing.py)."""
    import numpy as np

    from idkengine_tpu_torch.bvh.builder import BuildSettings
    from idkengine_tpu_torch.scene.procedural import cornell_box
    from idkengine_tpu_torch.scene.scene_db import SceneDatabase

    mats = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    mats[1, :3, :3] *= 1.5
    mats[:, :3, 3] = [[150, 380, 250], [400, 380, 250]]
    db = SceneDatabase(BuildSettings(max_leaf_triangle_count=12, traversal_cost=4.0))
    db.add_model(cornell_box(emissive_quad=False))
    db.add_instanced_model(sphere_model(12, 16, radius=50.0), mats)
    db.build(device)
    db.lights.add([278, 480, 279.5], [6, 6, 6], radius=45.0)
    return db


def phase_instanced(db, cam, dev, card, frame_ref):
    """Phase 20 (see the module's docstring). Returns (the launch counts of
    the instanced frames, the two-level entries' numbers for the kernels'
    line)."""
    from dataclasses import replace

    import numpy as np
    import torch

    from idkengine_tpu_torch.ops import packet_trace as kern
    from idkengine_tpu_torch.render import Camera, PathTracer, PathTracerSettings
    from idkengine_tpu_torch.render import pathtracer as pathtracer_mod

    t_start = time.perf_counter()
    iset = db.instance_set()
    settings = PathTracerSettings(ray_depth=DEPTH, russian_roulette=False, do_ray_sorting=True,
                                  sky_strength=1.0)
    t0 = time.perf_counter()
    pt = PathTracer(db.device_scene, db.materials.soa(), db.lights.soa(), WIDTH, HEIGHT,
                    settings, instances=iset, inst_attr_srcs=db._inst_attr_srcs, device=dev)
    torch_sync(dev)
    init_s = time.perf_counter() - t0
    # the frame's first bounce batch, recorded by standing in for the
    # tracer's two-level closest-hit trace (its warm-up frame)
    calls, fn = [], pathtracer_mod.trace_closest_two_level

    def recording(*args, **kw):
        calls.append(args[4:7])
        return fn(*args, **kw)

    pathtracer_mod.trace_closest_two_level = recording
    try:
        pt.render_frame(cam)
    finally:
        pathtracer_mod.trace_closest_two_level = fn
    if len(calls) != DEPTH:
        raise AssertionError(f"the instanced frame made {len(calls)} closest-hit traces")
    log(f"# instanced scene: {db.meta.n_triangles} static triangles, {len(iset.scenes)} "
        f"instances of a {iset.scenes[0].tri_p0.shape[0]}-triangle sphere ({len(db._inst_blas)} "
        f"BLAS, {iset.scenes[0].bvh4_nodes.shape[0]} 4-wide records); tracer init "
        f"{init_s:.2f} s")

    static = db.device_scene
    o, d, t_max = primary_rays(cam, dev)
    timings = {}
    (hit, inst), m = compare_two_level("trace_closest", static, iset, o, d, t_max, card,
                                       "primary batch")
    timings["trace_closest_two_level"] = m
    share = (inst >= 0).float().mean().item()
    if share < INSTANCED_SHARE:
        raise AssertionError(f"only {share:.4f} of the primaries hit an instance")
    _, m = compare_two_level("trace_any", static, iset, *shadow_rays(o, d, hit), card,
                             "shadow batch")
    timings["trace_any_two_level"] = m
    _, m = compare_two_level("trace_closest", static, iset, *calls[1], card, "bounce batch")
    timings["trace_closest_two_level"]["batches"] += m["batches"]
    del calls
    for kind, rays in (("trace_closest", (o, d, t_max)), ("trace_any", shadow_rays(o, d, hit))):
        _, m = compare_two_level(kind, static, iset, *rays, card,
                                 "primary batch" if kind == "trace_closest" else "shadow batch",
                                 max_steps=CAP_LOW)
        timings[f"{kind}_two_level"]["batches"] += m["batches"]

    reset_all_launch_counts()
    rays = 0.0
    t0 = time.perf_counter()
    for _ in range(TIMED_FRAMES):
        img = pt.render_frame(cam)
        rays += float(pt.last_rays_traced)
    torch_sync(dev)
    frame_ms = (time.perf_counter() - t0) / TIMED_FRAMES * 1e3
    launches = {"pathtracer_instanced": read_launch_counts()}
    per_frame = {k: v / TIMED_FRAMES for k, v in launches["pathtracer_instanced"].items() if v}
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(img).all()) or \
            not img.std().item() > 0:
        raise AssertionError("the instanced image is not a finite, non-flat array")
    if per_frame != {"trace_closest_two_level": DEPTH, "trace_any_two_level": DEPTH}:
        raise AssertionError(f"the instanced frame made {per_frame} launches a frame, not "
                             f"{DEPTH} of each two-level trace and no other")
    log(f"# instanced frame: {frame_ms:.2f} ms/frame (phase 5's {frame_ref['ms']:.2f}), "
        f"{rays / TIMED_FRAMES / 1e6:.3f} Mrays/frame, {WIDTH}x{HEIGHT} depth {DEPTH}, "
        f"{INSTANCE_COUNT} instances; launches a frame {per_frame}; on {card}")
    profile_frame(lambda: pt.render_frame(cam), "instanced frame",
                  lambda k: k.startswith(PT_RANGES))
    # every trace call of the instanced frame is a two-level call
    waits = host_waits(lambda: pt.render_frame(cam), inside=("pt_closest_", "pt_any_"))
    log(f"# instanced frame: copies and synchronizes inside a two-level call's range {waits}")
    if waits:
        raise AssertionError(f"a two-level call copied or waited: {waits}")
    del pt

    capped = PathTracer(db.device_scene, db.materials.soa(), db.lights.soa(), WIDTH, HEIGHT,
                        replace(settings, max_trace_steps=CAP_LOW), instances=iset,
                        inst_attr_srcs=db._inst_attr_srcs, device=dev)
    reset_all_launch_counts()
    t0 = time.perf_counter()
    img = capped.render_frame(cam)
    torch_sync(dev)
    capped_ms = (time.perf_counter() - t0) * 1e3
    launches["pathtracer_instanced_cap"] = read_launch_counts()
    counts = {k: v for k, v in launches["pathtracer_instanced_cap"].items() if v}
    if not bool(torch.isfinite(img).all()) or \
            counts != {"trace_closest_two_level": DEPTH, "trace_any_two_level": DEPTH}:
        raise AssertionError(f"the capped instanced frame is not finite or made other launches "
                             f"than {DEPTH} of each two-level trace: {counts}")
    log(f"# instanced frame at max_trace_steps {CAP_LOW}: {capped_ms:.2f} ms (one frame, "
        f"compiled kernels warm); launches {launches['pathtracer_instanced_cap']}; on {card}")
    del capped

    builds = [b.build_ms for b in db._inst_blas]
    tlas = db.tlas
    moved = np.eye(4, dtype=np.float32)
    moved[:3, 3] = [0.0, 1000.0, 0.0]
    before = int((inst == 0).sum().item())
    t0 = time.perf_counter()
    db.set_instance_transform(0, moved)
    move_ms = (time.perf_counter() - t0) * 1e3
    iset2 = db.instance_set()
    _, inst2 = kern.trace_closest_two_level(static, iset2.scenes, iset2.inv, iset2.boxes, o, d,
                                            t_max, slot_off=iset2.slot_off)
    after = int((inst2 == 0).sum().item())
    if before == 0 or after != 0:
        raise AssertionError(f"instance 0 on {before} primaries before the move, {after} after")
    if [b.build_ms for b in db._inst_blas] != builds or db.tlas is tlas or \
            not db.tlas.nodes["max"][0][1] >= 1000.0:
        raise AssertionError("set_instance_transform rebuilt a BLAS or left the TLAS")
    log(f"# set_instance_transform(0): {move_ms:.2f} ms on the host; instance 0 on {before} "
        f"primaries before, {after} after; no BLAS rebuilt, the TLAS rebuilt "
        f"({db.tlas.nodes.shape[0]} nodes)")

    small_cam = Camera(position=np.array([278, 273, -800], np.float32), yaw=90.0, fov_y=38.0)
    imgs = []
    for device in (dev, "cpu"):
        sdb = small_instanced_db(device)
        spt = PathTracer(sdb.device_scene, sdb.materials.soa(), sdb.lights.soa(), 48, 48,
                         PathTracerSettings(ray_depth=DEPTH, sky_strength=0.0),
                         instances=sdb.instance_set(), inst_attr_srcs=sdb._inst_attr_srcs,
                         device=device)
        imgs.append(spt.render_frame(small_cam).cpu().numpy())
    rmse = float(np.sqrt(np.mean((imgs[0] - imgs[1]) ** 2)))
    log(f"# small instanced scene 48x48 (the Cornell box, two spheres): card vs CPU RMSE "
        f"{rmse:.3g} (limit {SMALL_RMSE})")
    if not (rmse <= SMALL_RMSE and imgs[0].std() > 0):
        raise AssertionError("the card's small instanced render disagrees with the CPU's")
    log(f"# phase 20 (instanced frame) took {time.perf_counter() - t_start:.1f} s")
    return launches, timings


def write_glb(model, path):
    """Write `model` as a binary glTF (.glb): one mesh a node that holds
    primitives (positions, normals, UVs, uint32 indices), the nodes' TRS
    and children, the materials' factors, alpha modes and cutoffs (with
    KHR_materials_ior and _transmission where they differ from glTF's
    defaults), each texture as a KTX2 image (image/ktx2, RGBA8, sRGB where
    the texture is, zlib-supercompressed: scheme 3) and the animations'
    samplers. The JAX package has no writer; this one serves the checks of
    the port's loader (phase 21, tests/test_torch_cuda.py). Returns the
    file's size in bytes."""
    import struct
    import zlib

    import numpy as np

    body, views, accessors = bytearray(), [], []

    def view(raw):
        body.extend(bytes(-len(body) % 4))
        views.append({"buffer": 0, "byteOffset": len(body), "byteLength": len(raw)})
        body.extend(raw)
        return len(views) - 1

    def accessor(arr, ctype, kind, bounds=False):
        arr = np.ascontiguousarray(arr)
        a = {"bufferView": view(arr.tobytes()), "componentType": ctype, "type": kind,
             "count": int(arr.shape[0])}
        if bounds:
            a["min"], a["max"] = arr.min(0).tolist(), arr.max(0).tolist()
        accessors.append(a)
        return len(accessors) - 1

    images = []
    for tex in model.textures:
        img = np.ascontiguousarray(tex.data, np.uint8)
        h, w = img.shape[:2]
        if img.shape[2] != 4:
            raise ValueError("the writer takes RGBA8 textures")
        raw = img.tobytes()
        payload = zlib.compress(raw)
        head = (b"\xabKTX 20\xbb\r\n\x1a\n"
                + struct.pack("<9I", 43 if tex.is_srgb else 37, 1, w, h, 0, 0, 1, 1, 3)
                + struct.pack("<IIIIQQ", 0, 0, 0, 0, 0, 0))
        ktx = head + struct.pack("<QQQ", len(head) + 24, len(payload), len(raw)) + payload
        images.append({"bufferView": view(ktx), "mimeType": "image/ktx2"})
    materials = []
    for m in model.materials:
        if np.any(np.asarray(m.absorbance) != 0):
            raise ValueError("the writer does not write KHR_materials_volume")
        pbr = {"baseColorFactor": np.asarray(m.base_color, np.float32).tolist(),
               "metallicFactor": float(m.metallic), "roughnessFactor": float(m.roughness)}
        g = {"name": m.name, "pbrMetallicRoughness": pbr,
             "emissiveFactor": np.asarray(m.emissive, np.float32).tolist()}
        for key, ti in (("baseColorTexture", m.base_color_texture),
                        ("metallicRoughnessTexture", m.metallic_roughness_texture)):
            if ti >= 0:
                pbr[key] = {"index": ti}
        for key, ti in (("normalTexture", m.normal_texture), ("emissiveTexture",
                                                               m.emissive_texture),
                        ("occlusionTexture", m.occlusion_texture)):
            if ti >= 0:
                g[key] = {"index": ti}
        if m.alpha_cutoff < 0:
            g["alphaMode"] = "OPAQUE"
        elif m.alpha_cutoff == 0:
            g["alphaMode"] = "BLEND"
        else:
            g["alphaMode"], g["alphaCutoff"] = "MASK", float(m.alpha_cutoff)
        if m.double_sided:
            g["doubleSided"] = True
        ext = {}
        if m.ior != 1.5:
            ext["KHR_materials_ior"] = {"ior": float(m.ior)}
        if m.transmission:
            ext["KHR_materials_transmission"] = {"transmissionFactor": float(m.transmission)}
        if ext:
            g["extensions"] = ext
        materials.append(g)
    meshes, nodes = [], []
    for node in model.nodes:
        n = {"name": node.name, "translation": np.asarray(node.translation).tolist(),
             "rotation": np.asarray(node.rotation).tolist(),
             "scale": np.asarray(node.scale).tolist()}
        if node.children:
            n["children"] = list(node.children)
        if node.mesh_primitives:
            prims = []
            for pi in node.mesh_primitives:
                p = model.primitives[pi]
                attrs = {"POSITION": accessor(p.positions.astype(np.float32), 5126, "VEC3", True)}
                if p.normals is not None:
                    attrs["NORMAL"] = accessor(p.normals.astype(np.float32), 5126, "VEC3")
                if p.uvs is not None:
                    attrs["TEXCOORD_0"] = accessor(p.uvs.astype(np.float32), 5126, "VEC2")
                prims.append({"attributes": attrs, "material": int(p.material),
                              "indices": accessor(p.indices.astype(np.uint32).reshape(-1),
                                                  5125, "SCALAR")})
            n["mesh"] = len(meshes)
            meshes.append({"primitives": prims})
        nodes.append(n)
    animations = []
    for anim in model.animations:
        samplers, channels = [], []
        for ch in anim.channels:
            sm = ch.sampler
            samplers.append({"input": accessor(sm.times.astype(np.float32), 5126, "SCALAR"),
                             "output": accessor(sm.values.astype(np.float32), 5126,
                                                {3: "VEC3", 4: "VEC4"}[sm.values.shape[1]]),
                             "interpolation": sm.interpolation})
            channels.append({"sampler": len(samplers) - 1,
                             "target": {"node": ch.node, "path": ch.path}})
        animations.append({"name": anim.name, "samplers": samplers, "channels": channels})
    doc = {"asset": {"version": "2.0", "generator": "chip_smoke.write_glb"},
           "scene": 0, "scenes": [{"nodes": list(model.root_nodes)}], "nodes": nodes,
           "meshes": meshes, "materials": materials,
           "textures": [{"source": i} for i in range(len(images))], "images": images,
           "accessors": accessors, "bufferViews": views, "animations": animations,
           "buffers": [{"byteLength": len(body)}]}
    js = json.dumps(doc, separators=(",", ":")).encode()
    js += b" " * (-len(js) % 4)
    body.extend(bytes(-len(body) % 4))
    total = 12 + 8 + len(js) + 8 + len(body)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(js), 0x4E4F534A))
        f.write(js)
        f.write(struct.pack("<II", len(body), 0x004E4942))
        f.write(body)
    return total


def check_gltf_round_trip(model, loaded):
    """Raises unless the loaded model holds every array, material field and
    texture pixel of `model` bit for bit (texture names aside: the loader
    names a texture by its image)."""
    import dataclasses

    import numpy as np

    def same(a, b, where):
        if dataclasses.is_dataclass(a):
            for f in dataclasses.fields(a):
                if not (where.startswith("textures") and f.name == "name"):
                    same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
        elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            if not (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                    and a.dtype == b.dtype and a.shape == b.shape
                    and a.tobytes() == b.tobytes()):
                raise AssertionError(f"the loaded glTF differs from the model at {where}")
        elif isinstance(a, (list, tuple)):
            if len(a) != len(b):
                raise AssertionError(f"the loaded glTF differs from the model at {where}")
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}[{i}]")
        elif not (type(a) is type(b) and a == b):
            raise AssertionError(f"the loaded glTF differs from the model at {where}: "
                                 f"{a!r} against {b!r}")

    for k in ("primitives", "materials", "textures", "nodes", "root_nodes", "animations",
              "skins"):
        same(getattr(model, k), getattr(loaded, k), k)


def app_model(seed, tris):
    """Phase 21's asset: the atrium with texture_atrium's material model and
    phase 19's animation of its root node. Returns (model, per-mesh
    overrides)."""
    from idkengine_tpu_torch.scene.procedural import atrium, texture_atrium

    model = atrium(tris)
    shading = texture_atrium(model, seed)
    model.animations.append(sway_animation())
    return model, shading


def engine_settings(width, height, vxgi_res):
    """EngineSettings of phase 21: phase 14's tracer settings, phase 7's
    deferred settings with VXGI at `vxgi_res`."""
    from idkengine_tpu_torch.engine import EngineSettings

    return EngineSettings(width=width, height=height, pt=textured_settings(),
                          deferred=_deferred_settings(vxgi_res))


def load_app_db(path, dev, shading, defer):
    """The database the Engine runs: the glTF loaded (textures decoded, or
    deferred), the meshopt pass, SceneDatabase.build on `dev`, phase 3's
    lights and phase 14's per-mesh overrides. Returns (db, model, the
    seconds of the parse, the meshopt pass and the build)."""
    from idkengine_tpu_torch.bvh.builder import BuildSettings
    from idkengine_tpu_torch.scene.gltf import load_gltf
    from idkengine_tpu_torch.scene.meshopt import optimize_model
    from idkengine_tpu_torch.scene.scene_db import SceneDatabase

    t0 = time.perf_counter()
    model = load_gltf(path, defer_textures=defer, optimize=False)
    t1 = time.perf_counter()
    optimize_model(model)  # load_gltf(optimize=True)'s last step, timed apart
    t2 = time.perf_counter()
    db = SceneDatabase(BuildSettings(**BUILD))
    db.add_model(model)
    db.build(dev)
    torch_sync(dev)
    for pos, rad, r in LIGHTS:
        db.lights.add(pos, rad, radius=r)
    for k, kw in shading.items():
        db.set_mesh_shading(k, **kw)
    return db, model, (t1 - t0, t2 - t1, time.perf_counter() - t2)


def record_scatter_calls(render):
    """The scatter-max calls (cell, vals, n_cells, bf16) of one frame,
    recorded by standing in for the voxelizer's voxel_scatter module."""
    from types import SimpleNamespace

    from idkengine_tpu_torch.render import vxgi as vxgi_mod

    calls, module = [], vxgi_mod.voxel_scatter

    def recording(cell, vals, n_cells, bf16=False):
        calls.append((cell, vals, n_cells, bf16))
        return module.scatter_max_dense(cell, vals, n_cells, bf16=bf16)

    vxgi_mod.voxel_scatter = SimpleNamespace(scatter_max_dense=recording)
    try:
        render()
    finally:
        vxgi_mod.voxel_scatter = module
    return calls


def pick_ray(cam, width, height, px, py):
    """Engine.pick_entity's ray through pixel (px, py), as it makes it."""
    import numpy as np

    params = cam.ray_params(width, height)
    u = (px + 0.5) / width * 2 - 1
    v = 1 - (py + 0.5) / height * 2
    d = params["forward"] + u * params["right"] + v * params["up"]
    return np.asarray(cam.position, np.float32), (d / np.linalg.norm(d)).astype(np.float32)


def settle(eng, move, updates, rest):
    """Push the camera with `move` for `updates` Engine updates of 1/60 s,
    then let it come to rest for `rest` more; returns each update's ms."""
    import numpy as np

    ms = []
    for i in range(updates + rest):
        t0 = time.perf_counter()
        eng.update(1.0 / 60.0, move=np.float32(move) if i < updates else np.zeros(3, np.float32))
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def phase_app(dev, card, seed, ref_frame, timings):
    """Phase 21 (see the module's docstring). Returns the launch counts of
    the Engine's path-traced, deferred and instanced frames."""
    import tempfile

    import numpy as np
    import torch

    from idkengine_tpu_torch import profiling
    from idkengine_tpu_torch.engine import Engine, RenderMode, load_config, save_config
    from idkengine_tpu_torch.ops import packet_trace as kern
    from idkengine_tpu_torch.ops import voxel_scatter as vs
    from idkengine_tpu_torch.render import Camera
    from idkengine_tpu_torch.render import pathtracer as pathtracer_mod
    from idkengine_tpu_torch.scene.async_io import (AsyncTextureLoader, MainThreadQueue,
                                                    attach_async_textures)
    from idkengine_tpu_torch.scene.gltf import load_gltf

    t_start = time.perf_counter()
    launches = {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_app_")
    path = os.path.join(tmp.name, "atrium.glb")
    model, shading = app_model(seed, TRIS)
    t0 = time.perf_counter()
    size = write_glb(model, path)
    log(f"# phase 21: wrote the textured, animated atrium ({model.triangle_count()} tris, "
        f"{len(model.primitives)} primitives, {len(model.textures)} KTX2 textures) as "
        f"{size / 1e6:.1f} MB of glb in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    check_gltf_round_trip(model, load_gltf(path, optimize=False))
    log(f"# load_gltf(optimize=False) gives back every array, material field and texture pixel "
        f"bit for bit ({time.perf_counter() - t0:.2f} s with the check)")
    del model

    db, lazy, (parse_s, meshopt_s, build_s) = load_app_db(path, dev, shading, defer=True)
    env_path = os.path.join(tmp.name, "sky.hdr")
    env = textured_env(dev, *ENV_SIZE, env_path)  # phase 14's map, through RGBE
    cam = Camera(position=np.array(CAMERA["position"], np.float32), yaw=CAMERA["yaw"],
                 fov_y=CAMERA["fov_y"])
    eng = Engine(db, engine_settings(WIDTH, HEIGHT, VXGI_RES), env_map=env, device=dev)
    eng.camera = cam
    t0 = time.perf_counter()
    pipe = eng._pipeline()
    torch_sync(dev)
    init_s = time.perf_counter() - t0
    loader = AsyncTextureLoader(MainThreadQueue())
    t0 = time.perf_counter()
    attach_async_textures(db, lazy, loader, mat_offset=0, pt=pipe.pt)
    during = 0
    while loader.outstanding:
        loader.queue.pump()
        eng.render()
        during += 1
    loader.wait_all()
    torch_sync(dev)
    decode_s = time.perf_counter() - t0
    if not (pipe.pt._has_textures and pipe.pt._has_normal_maps):
        raise AssertionError("the tracer did not take the decoded textures")
    log(f"# the Engine's database: parse {parse_s:.2f} s, meshopt pass {meshopt_s:.2f} s, "
        f"SceneDatabase.build {build_s:.2f} s; pipeline init {init_s:.2f} s; "
        f"{len(lazy.textures)} texture decodes through AsyncTextureLoader in {decode_s:.2f} s, "
        f"{during} frames rendered while they landed; atlas {tuple(pipe.pt.mats['atlas'].shape)}")

    # the frame after the decodes, at phase 14's first sample, against phase 14's
    pipe.reset_accumulation()
    pipe.pt._frame = 0  # the sample index of phase 14's first frame
    eng.render()
    img = pipe.pt.image()
    rmse = torch.sqrt(torch.mean((img - ref_frame) ** 2)).item()
    differ = int((img != ref_frame).any(dim=-1).sum().item())
    log(f"# Engine path-traced frame (one sample, {WIDTH}x{HEIGHT}, phase 14's settings and env "
        f"map) against phase 14's directly built frame: RMSE {rmse:.3g} (limit {SMALL_RMSE}), "
        f"{differ} of {WIDTH * HEIGHT} pixels differ (meshopt's triangle order builds another "
        f"tree)")
    if not rmse <= SMALL_RMSE:
        raise AssertionError("the Engine's frame of the loaded glTF disagrees with phase 14's")

    # the trace calls of one Engine frame against the plain trace
    calls = record_pt_traces(pipe.pt, cam, render=eng.render)
    for kind, label, o, d, t_max in calls:
        _, m, agree = compare_trace(kind, pipe.pt.scene, o, d, t_max, reps=3)
        m.update(steps_stats(pipe.pt.scene, o, d, t_max))
        log_batch(kind, f"Engine frame, {label}", o, m, agree,
                  f"; live rays {int((t_max >= 0).sum().item())}; on {card}")
        entry = timings[kind]
        entry["max_abs_err"] = max(entry["max_abs_err"], m["max_abs_err"])
        entry["batches"].append(dict(batch=f"engine {label}", rays=o.shape[0], agreement=agree,
                                     **m))
    del calls

    # timed frames through run_headless (update + render each)
    eng.run_headless(1)
    torch_sync(dev)
    reset_all_launch_counts()
    t0 = time.perf_counter()
    eng.run_headless(TIMED_FRAMES)
    torch_sync(dev)
    pt_ms = (time.perf_counter() - t0) / TIMED_FRAMES * 1e3
    launches["engine_pt"] = read_launch_counts()
    for name in ("trace_closest", "trace_any"):
        if launches["engine_pt"][name] == 0:
            raise AssertionError(f"{name} was not launched on the Engine's path-traced frames")
    out = eng.render()
    if tuple(out.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError("the Engine's image is not a finite (H,W,3) array")
    log(f"# Engine path-traced frames (run_headless: update_device + frame): {pt_ms:.2f} "
        f"ms/frame over {TIMED_FRAMES}, {WIDTH}x{HEIGHT}; launches {launches['engine_pt']}; "
        f"on {card}")
    profile_frame(lambda: eng.run_headless(1), "Engine path-traced frame (update + render)",
                  lambda k: k.startswith(PT_RANGES) or k in PT_PASSES)
    dev_profile = profiling.capture_device_profile(lambda: eng.run_headless(1))
    log(f"# profiling.capture_device_profile of one Engine frame (ms): {dev_profile}")

    # Engine.update at DYN_TIMES, through update_device
    host_calls = []
    host_update = db.update
    db.update = lambda *a, **k: host_calls.append(a) or host_update(*a, **k)
    eng.animation_time = 0.0
    for t in DYN_TIMES:
        ms = []
        while eng.animation_time < t - 1e-9:
            before = db.device_vertices
            t0 = time.perf_counter()
            eng.update(min(0.2, t - eng.animation_time))
            torch_sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            if db.device_vertices is before:
                raise AssertionError("Engine.update did not go through update_device")
        out = eng.render()
        torch_sync(dev)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"the frame after the update to {t} s is not finite")
        log(f"# Engine.update to {eng.animation_time:.3f} s through update_device: "
            + ", ".join(f"{x:.2f}" for x in ms) + " ms a call (up to 12 sub-steps each); the "
            f"next frame renders")
    if host_calls:
        raise AssertionError("Engine.update went through the host refit")
    db.update = host_update

    # the camera into the floor and into a wall, with camera_collision on
    cam.pitch, cam.velocity = 0.0, np.zeros(3, np.float32)
    for what, start, move, down in (("floor", (3.0, 0.8, 10.0), (0.0, -1.0, 0.0), (0, -1, 0)),
                                    ("wall", (-10.5, 3.0, 10.0), (-1.0, 0.0, 0.0), (-1, 0, 0))):
        cam.position = np.float32(start)
        ms = settle(eng, move, 60, 120)
        hit = db.intersect_ray(cam.position, np.float32(down))
        dist = np.inf if hit is None else hit[0]
        log(f"# camera pushed into the {what} for 1 s then at rest 2 s: ends at "
            f"{np.round(cam.position, 4).tolist()}, {dist:.5f} from the surface (radius "
            f"{cam.collision_radius}); update ms median {np.median(ms):.2f}, max "
            f"{np.max(ms):.2f}")
        if not dist >= cam.collision_radius:
            raise AssertionError(f"the camera ended {dist} from the {what}")
    # a physics light dropped onto the floor
    eng.settings.light_physics = True
    li = db.lights.add([2.0, 6.0, 8.0], [5.0, 5.0, 5.0], radius=0.3, has_physics=True)
    ms = settle(eng, (0, 0, 0), 0, 150)
    light = db.lights.lights[li]
    hit = db.intersect_ray(light.position, np.float32([0, -1, 0]))
    log(f"# physics light dropped from y 6: after 2.5 s at {np.round(light.position, 4).tolist()}"
        f", {hit[0] if hit else float('inf'):.4f} above the surface below it (radius "
        f"{light.radius}); update ms median {np.median(ms):.2f}")
    if hit is None or not (0.0 < light.position[1] < 6.0):
        raise AssertionError("the physics light left the scene")
    eng.settings.light_physics = False
    db.lights.remove(li)
    cam.position = np.array(CAMERA["position"], np.float32)  # back to phase 3's view
    cam.yaw, cam.pitch, cam.velocity = CAMERA["yaw"], 0.0, np.zeros(3, np.float32)

    # rasterizer mode: the deferred frame with VXGI 256^3 through the Engine
    eng.set_mode(RenderMode.RASTERIZER)
    t0 = time.perf_counter()
    eng.render()  # warm-up
    torch_sync(dev)
    warm_s = time.perf_counter() - t0
    reset_all_launch_counts()
    t0 = time.perf_counter()
    for _ in range(DEFERRED_FRAMES):
        out = eng.render()
    torch_sync(dev)
    deferred_ms = (time.perf_counter() - t0) / DEFERRED_FRAMES * 1e3
    launches["engine_deferred"] = read_launch_counts()
    for name in ("trace_closest", "trace_any", "scatter_max_dense"):
        if launches["engine_deferred"][name] == 0:
            raise AssertionError(f"{name} was not launched on the Engine's deferred frame")
    if tuple(out.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(out).all()) or \
            not out.std().item() > 0.01:
        raise AssertionError("the Engine's deferred image is not a finite, non-flat array")
    log(f"# Engine deferred frames: {deferred_ms:.2f} ms/frame over {DEFERRED_FRAMES} (warm-up "
        f"{warm_s:.2f} s), {WIDTH}x{HEIGHT}, VXGI {VXGI_RES}^3; launches "
        f"{launches['engine_deferred']}; on {card}")
    dpipe = eng._pipeline()
    scatters = []
    calls = record_deferred_traces(
        dpipe, cam, render=lambda: scatters.extend(record_scatter_calls(eng.render)))
    compare_recorded(calls, "Engine deferred frame", timings, card)
    if not scatters:
        raise AssertionError("the Engine's deferred frame made no scatter-max call")
    for cell, vals, n_cells, bf16 in scatters:
        got = vs.scatter_max_dense(cell, vals, n_cells, bf16=bf16)
        want = vs.scatter_max_dense_plain(cell, vals, n_cells, bf16)
        if not torch.equal(got, want):
            raise AssertionError("scatter_max_dense differs from its plain version on the "
                                 "Engine's call")
        ms = cuda_time_ms(lambda: vs.scatter_max_dense(cell, vals, n_cells, bf16=bf16), 10)
        timings["scatter_max_dense"].setdefault("batches", []).append(
            dict(batch="engine deferred frame", updates=cell.numel(), ms=ms))
        log(f"# scatter_max_dense on the Engine's call ({cell.numel()} updates x "
            f"{vals.shape[0]} channels, bf16 {bf16}): equal to the plain version, {ms:.4f} ms")
    del calls, scatters
    profile_frame(eng.render, "Engine deferred frame", lambda k: k.startswith("deferred/"))

    # a model added at run time: the two-level path
    eng.set_mode(RenderMode.PATH_TRACER)
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [2.0, 2.5, 12.0]
    t0 = time.perf_counter()
    inst = eng.add_model_runtime(sphere_model(**SPHERE_RES), m)
    add_ms = (time.perf_counter() - t0) * 1e3
    two_level, fn = [], pathtracer_mod.trace_closest_two_level

    def recording(*args, **kw):
        two_level.append(args[4:7])
        return fn(*args, **kw)

    pathtracer_mod.trace_closest_two_level = recording
    try:
        eng.render()  # warm-up: the new tracer
    finally:
        pathtracer_mod.trace_closest_two_level = fn
    torch_sync(dev)
    reset_all_launch_counts()
    t0 = time.perf_counter()
    out = eng.render()
    torch_sync(dev)
    inst_ms = (time.perf_counter() - t0) * 1e3
    launches["engine_instanced"] = read_launch_counts()
    tails = DEPTH * sum("tail" in c for c in TEXTURED_CALLS)  # the any-hit calls a frame
    want = {"trace_closest_two_level": DEPTH * len(TEXTURED_CALLS) - tails,
            "trace_any_two_level": tails}
    for name, n in want.items():
        if launches["engine_instanced"][name] != n:
            raise AssertionError(f"the instanced Engine frame made "
                                 f"{launches['engine_instanced'][name]} {name} launches, not "
                                 f"{n} (one a call)")
    iset = db.instance_set()
    (hit, hit_inst), _ = compare_two_level("trace_closest", db.device_scene, iset, *two_level[0],
                                           card, "Engine primaries")
    share = (hit_inst == inst).float().mean().item()
    log(f"# add_model_runtime of a {iset.scenes[0].tri_p0.shape[0]}-triangle sphere: "
        f"{add_ms:.1f} ms; the next frame {inst_ms:.2f} ms (one frame), launches "
        f"{launches['engine_instanced']}; its primaries on the sphere {share:.4f}; on {card}")
    if not (share > 0 and bool(torch.isfinite(out).all())):
        raise AssertionError("the sphere added at run time is not in the frame")
    del two_level

    # picking against the card's primary hits: the static scene at rest again
    # (the animation loops every 2 s; at 0 s it is at rest, as pick's BLAS)
    eng.animation_time = 0.0
    eng.update(0.0)
    pixels = [(WIDTH // 2, HEIGHT // 2), (WIDTH // 5, HEIGHT // 3), (4 * WIDTH // 5, HEIGHT // 4),
              (WIDTH // 3, 4 * HEIGHT // 5), (9 * WIDTH // 10, 9 * HEIGHT // 10)]
    for px, py in pixels:
        picked = eng.pick_entity(px, py)
        o, d = pick_ray(cam, WIDTH, HEIGHT, px, py)
        h = kern.trace_closest(db.device_scene, torch.as_tensor(o[None], device=dev),
                               torch.as_tensor(d[None], device=dev),
                               torch.full((1,), 3.4e38, device=dev))
        slot = int(h.slot[0].item())
        if picked is None or slot < 0:
            raise AssertionError(f"pixel {px},{py}: picked {picked}, card slot {slot}")
        tri = int(db._slot_tri[slot])
        rel = abs(picked[0] - h.t[0].item()) / picked[0]
        log(f"# pick_entity({px}, {py}): triangle {picked[3]} at t {picked[0]:.6f}; the card's "
            f"primary: slot {slot} -> triangle {tri}, t {h.t[0].item():.6f} (rel {rel:.2g})")
        if tri != picked[3] or not rel <= 1e-5:
            raise AssertionError(f"pick_entity({px}, {py}) disagrees with the card's hit")

    # the recorder and the settings file
    rec_path = os.path.join(tmp.name, "path.frd")
    for k in range(3):
        cam.position = np.float32([k * 1.5, 3.0 + k * 0.25, 20.0 - k * 2.0])
        cam.yaw, cam.pitch = -90.0 + 7.5 * k, -2.0 * k
        eng.recorder.record(cam, animation_time=eng.animation_time + k)
    eng.recorder.save(rec_path)
    loaded = type(eng.recorder).load(rec_path)
    for want in eng.recorder.frames:
        fs = loaded.replay(cam)
        if fs is None or fs.pack() != want.pack() or cam.position.tobytes() != \
                want.position.tobytes():
            raise AssertionError("a recorded frame did not survive save / load / replay")
    cfg_path = os.path.join(tmp.name, "engine.json")
    save_config(eng.settings, cfg_path)
    if load_config(cfg_path) != eng.settings:
        raise AssertionError("save_config / load_config did not round-trip the settings")
    log(f"# recorder: 3 frames through save / load / replay unchanged "
        f"({os.path.getsize(rec_path)} B); save_config / load_config round-trip the settings")
    del eng, pipe, dpipe, db, lazy, env
    tmp.cleanup()
    torch.cuda.empty_cache()
    log(f"# phase 21 (the app: a glTF through the Engine) took "
        f"{time.perf_counter() - t_start:.1f} s")
    return launches


def phase_small_engine(dev, seed):
    """Phase 21's last check: a small atrium written as a glTF and run
    through the Engine on the card and on the CPU, in both modes, 48x32."""
    import tempfile

    import numpy as np

    from idkengine_tpu_torch.engine import Engine, RenderMode
    from idkengine_tpu_torch.render import Camera

    model, shading = app_model(seed, 8000)
    env_small = textured_env("cpu", 64, 32)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_small_") as tmp:
        path = os.path.join(tmp, "small.glb")
        write_glb(model, path)
        imgs = {RenderMode.PATH_TRACER: [], RenderMode.RASTERIZER: []}
        for device in (dev, "cpu"):
            db, _, _ = load_app_db(path, device, shading, defer=False)
            eng = Engine(db, engine_settings(48, 32, 32), env_map=env_small, device=device)
            eng.camera = Camera(position=np.array(CAMERA["position"], np.float32),
                                yaw=CAMERA["yaw"], fov_y=CAMERA["fov_y"])
            for mode, frames in ((RenderMode.PATH_TRACER, 1), (RenderMode.RASTERIZER, 2)):
                eng.set_mode(mode)
                for _ in range(frames):  # the deferred frame's second reads the TAA history
                    img = eng.render()
                imgs[mode].append(img.cpu().numpy())
    for mode, (card_img, cpu_img) in imgs.items():
        rmse = float(np.sqrt(np.mean((card_img - cpu_img) ** 2)))
        log(f"# small Engine (atrium 8000 tris as glTF, 48x32, {mode.value}): card vs CPU RMSE "
            f"{rmse:.3g} (limit {SMALL_RMSE})")
        if not (rmse <= SMALL_RMSE and card_img.std() > 0):
            raise AssertionError(f"the card's small Engine frame ({mode.value}) disagrees with "
                                 f"the CPU's")


def phase_sharded_frame(db, scene, cam, dev, card, phase5):
    """Phase 22, the main path sharded: phase 5's frame through
    ShardedPathTracer over the card listed SHARDS times, from the same
    start; equal to phase 5's image on every pixel (else within
    SHARD_RMSE, the differing pixels counted). Returns the launches of the
    timed frames and the tracer."""
    import torch

    from idkengine_tpu_torch.parallel.shard import Mesh, ShardedPathTracer
    from idkengine_tpu_torch.render import PathTracer

    t0 = time.perf_counter()
    spt = ShardedPathTracer(PathTracer(scene, db.materials.soa(), db.lights.soa(), WIDTH, HEIGHT,
                                       main_settings(), device=dev), Mesh((dev,) * SHARDS))
    for _ in range(phase5["frames"] - TIMED_FRAMES):  # phase 5's warm-up and phase 4's frame
        spt.render_frame(cam)
    torch_sync(dev)
    log(f"# sharded tracer init + {phase5['frames'] - TIMED_FRAMES} untimed frames "
        f"{time.perf_counter() - t0:.2f} s")
    reset_all_launch_counts()
    rays = 0.0
    t0 = time.perf_counter()
    for _ in range(TIMED_FRAMES):
        img = spt.render_frame(cam)
        rays += float(spt.last_rays_traced)
    torch_sync(dev)
    dt = time.perf_counter() - t0
    launches = read_launch_counts()
    log(f"# sharded frame ({SHARDS} shards on {dev}): {dt / TIMED_FRAMES * 1e3:.2f} ms/frame "
        f"(phase 5's {phase5['ms']:.2f}), {rays / dt / 1e6:.2f} Mrays/s "
        f"({rays / TIMED_FRAMES / 1e6:.3f} Mrays/frame), on {card}; launches {launches}")
    for name in ("trace_closest", "trace_any"):
        if launches[name] != SHARDS * phase5["launches"][name]:
            raise AssertionError(f"sharded frame: {launches[name]} {name} launches, not "
                                 f"{SHARDS} x phase 5's {phase5['launches'][name]}")
    want = phase5["image"]
    if spt.accumulated_samples != phase5["frames"]:
        raise AssertionError("sharded frame: another number of samples than phase 5's")
    differ = int((img != want).any(dim=-1).sum().item())
    rmse = torch.sqrt(torch.mean((img - want) ** 2)).item()
    log(f"# sharded against phase 5's image after {spt.accumulated_samples} frames: "
        f"{'equal on every pixel' if differ == 0 else f'{differ} pixels differ'}, RMSE {rmse:.3g}")
    if not rmse <= SHARD_RMSE:
        raise AssertionError(f"sharded frame disagrees with phase 5's: RMSE {rmse}")
    return launches, dict(ms=dt / TIMED_FRAMES * 1e3, pixels_differ=differ, rmse=rmse), spt


def phase_shard_parts(spt, cam, dev, card):
    """Phase 22: each shard's sample, the unsharded sample and the gather
    timed apart (CUDA events), then one sharded and one unsharded frame
    under the profiler. Returns the unsharded frame's profile."""
    import torch

    from idkengine_tpu_torch.parallel.shard import shard_ranges

    pt = spt.pt
    cam_params = cam.ray_params(WIDTH, HEIGHT)
    ranges = shard_ranges(WIDTH * HEIGHT, SHARDS)
    shard_ms = [cuda_time_ms(lambda rng=rng: pt._render_sample(cam_params, 0, pixels=rng), 3)
                for rng in ranges]
    whole_ms = cuda_time_ms(lambda: pt._render_sample(cam_params, 0), 3)
    parts = [pt._render_sample(cam_params, 0, pixels=rng) for rng in ranges]
    gather_ms = cuda_time_ms(lambda: ([torch.cat([p[k] for p in parts]) for k in range(4)],
                                      sum(p[4] for p in parts)), 10)
    log(f"# shards' samples {', '.join(f'{m:.2f}' for m in shard_ms)} ms (sum "
        f"{sum(shard_ms):.2f}), the unsharded sample {whole_ms:.2f} ms, the gather "
        f"{gather_ms:.4f} ms (CUDA events, {SHARDS} shards on {dev}; on {card})")
    waits = host_waits(lambda: pt._render_sample(cam_params, 0, pixels=ranges[0]))
    log(f"# the runtime calls of one shard's sample that can wait for the card (a wait "
        f"would keep shards on distinct cards from overlapping): {waits or 'none'}")
    is_pass = lambda key: key.startswith("shard/") or key.startswith(PT_RANGES)  # noqa: E731
    sharded = profile_frame(lambda: spt.render_frame(cam), "sharded frame", is_pass)
    whole = profile_frame(lambda: pt.render_frame(cam), "unsharded frame (phase 5's settings)",
                          is_pass)
    return dict(shard_ms=shard_ms, sample_ms=whole_ms, gather_ms=gather_ms,
                profile=sharded), whole


def host_waits(fn, inside=None) -> dict:
    """The CUDA runtime calls made while fn() runs that can wait for the
    card (synchronizes, copies; torch.profiler's host events): name ->
    count; with `inside` (name prefixes of profiler ranges), only those
    made inside such a range, which must have been opened."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    ranges = [e.time_range for e in events if inside and e.name.startswith(inside)]
    if inside and not ranges:
        raise AssertionError(f"fn() opened no range named {inside}")
    waits = {}
    for e in events:
        if any(w in e.name for w in ("Synchronize", "cudaMemcpy")) and (not inside or any(
                r.start <= e.time_range.start and e.time_range.end <= r.end for r in ranges)):
            waits[e.name] = waits.get(e.name, 0) + 1
    torch.cuda.synchronize()
    return waits


def phase_shard_traces(scene, batches, dev, card):
    """Phase 22: shard_packet_closest / shard_packet_any over the card listed
    SHARDS times on phase 4's three batches, bit-equal to the unsharded
    kernels (t, slot, u, v; occlusion); both timed."""
    import torch

    from idkengine_tpu_torch.ops import packet_trace as kern
    from idkengine_tpu_torch.parallel.shard import Mesh, shard_packet_any, shard_packet_closest

    mesh = Mesh((dev,) * SHARDS)
    sharded = {"trace_closest": shard_packet_closest(mesh, scene),
               "trace_any": shard_packet_any(mesh, scene)}
    for label, (_, o, d, t_max) in batches.items():
        for kind, fn in sharded.items():
            want = getattr(kern, kind)(scene, o, d, t_max)
            got = fn(o, d, t_max)
            same = (all(torch.equal(a, b) for a, b in zip(got, want)) if kind == "trace_closest"
                    else torch.equal(got, want))
            if not same:
                raise AssertionError(f"sharded {kind} differs from the kernel on the {label} batch")
            ms = cuda_time_ms(lambda fn=fn, o=o, d=d, t_max=t_max: fn(o, d, t_max), 5)
            one_ms = cuda_time_ms(lambda kind=kind, o=o, d=d, t_max=t_max:
                                  getattr(kern, kind)(scene, o, d, t_max), 5)
            log(f"# sharded {kind}, {label} batch ({o.shape[0]} rays, {SHARDS} shards): "
                f"bit-equal to the kernel; {ms:.4f} ms against {one_ms:.4f} unsharded; on {card}")


def phase_sorts(dev, card, seed, frame_profile):
    """Phase 22: radix_argsort and sort_rays_by_key on 1920x1080 keys from
    `seed` in the 18-bit domain against a stable torch.argsort, each timed
    beside one torch.sort and the unsharded frame's `pt/sort` range."""
    import torch

    from idkengine_tpu_torch.ops.device_sort import radix_argsort, sort_rays_by_key

    r = WIDTH * HEIGHT
    g = torch.Generator(device=dev).manual_seed(seed)
    keys = torch.randint(0, 1 << SORT_BITS, (r,), generator=g, device=dev, dtype=torch.int32)
    want = torch.argsort(keys & ((1 << SORT_BITS) - 1), stable=True)
    if not torch.equal(radix_argsort(keys).long(), want):
        raise AssertionError("radix_argsort differs from a stable argsort")
    # the path tracer's sort payload: o, d, radiance, throughput; state, pixel, flags
    floats = [torch.rand((r, 3), generator=g, device=dev) for _ in range(4)]
    ints = [torch.randint(0, 1 << 32, (r,), generator=g, device=dev),
            torch.arange(r, device=dev), torch.randint(0, 8, (r,), generator=g, device=dev)]
    cols = (keys, *floats, *ints)
    out = sort_rays_by_key(keys, cols)
    if not torch.equal(out[0], torch.sort(keys).values):
        raise AssertionError("sort_rays_by_key: the keys are not sorted")
    pixel = out[6]
    for got, col in zip(out, cols):
        if not torch.equal(got, col[pixel]):
            raise AssertionError("sort_rays_by_key: a payload row left its key")
    radix_ms = cuda_time_ms(lambda: radix_argsort(keys), 10)
    payload_ms = cuda_time_ms(lambda: sort_rays_by_key(keys, cols[1:]), 10)
    sort_ms = cuda_time_ms(lambda: torch.sort(keys), 10)
    pt_sort = None if frame_profile is None else frame_profile["passes"].get("pt/sort")
    log(f"# sorts of {r} keys in {SORT_BITS} bits: radix_argsort {radix_ms:.4f} ms (equal to a "
        f"stable argsort), sort_rays_by_key with 4 float3 and 3 int64 columns {payload_ms:.4f} "
        f"ms, one torch.sort {sort_ms:.4f} ms; the unsharded frame's pt/sort "
        f"{'not traced' if pt_sort is None else f'{pt_sort:.2f} ms'} (one sort a bounce); "
        f"on {card}")
    return dict(radix_ms=radix_ms, sort_rays_ms=payload_ms, torch_sort_ms=sort_ms,
                pt_sort_ms=pt_sort)


def phase_shard_small(db, cam, dev, card):
    """Phase 22: dryrun_multichip over the card listed SHARDS times;
    PathTracerPipeline(shard_devices=-1) wraps its tracer only with more
    than one card; the Cornell box at 64x64 over a mixed mesh [card, CPU]
    against the CPU-only render (SMALL_RMSE; the CPU shard's pixels equal
    the CPU-only render's)."""
    import torch

    from idkengine_tpu_torch.parallel.dryrun import build_small_pt, dryrun_multichip
    from idkengine_tpu_torch.parallel.shard import Mesh, ShardedPathTracer
    from idkengine_tpu_torch.render import PathTracerPipeline, PtPipelineSettings

    t0 = time.perf_counter()
    out = dryrun_multichip(mesh=Mesh((dev,) * SHARDS))
    log(f"# dry run over {SHARDS} shards on {dev}: {time.perf_counter() - t0:.1f} s; on {card}")
    pipe = PathTracerPipeline(db, WIDTH, HEIGHT, main_settings(),
                              PtPipelineSettings(shard_devices=-1, denoise_at_samples=2),
                              device=dev)
    wrapped = isinstance(pipe.pt, ShardedPathTracer)
    if wrapped != (torch.cuda.device_count() > 1):
        raise AssertionError(f"shard_devices=-1 on {torch.cuda.device_count()} card(s): "
                             f"wrapped {wrapped}")
    img = pipe.render_frame(cam)
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("shard_devices=-1 pipeline frame is not a finite image")
    del pipe
    pt, box_cam = build_small_pt(64, 64, device=dev)
    img = ShardedPathTracer(pt, Mesh((dev, "cpu"))).render_frame(box_cam).cpu()
    ref = build_small_pt(64, 64, device="cpu")[0].render_frame(box_cam)
    rmse = torch.sqrt(torch.mean((img - ref) ** 2)).item()
    cpu_half = torch.equal(img[32:], ref[32:])
    log(f"# shard_devices=-1 on {torch.cuda.device_count()} card(s): wrapped {wrapped}; mixed "
        f"mesh [{dev}, cpu], Cornell box 64x64: against the CPU-only render RMSE {rmse:.3g} "
        f"(limit {SMALL_RMSE}), the CPU shard's rows equal: {cpu_half}")
    if not (rmse <= SMALL_RMSE and cpu_half):
        raise AssertionError("the mixed mesh's frame disagrees with the CPU-only render")
    return out


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of the textured scene")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = phase_card()
    phase_build()
    db, scene, cam = phase_scene(dev, card)
    pt = make_tracer(db, scene, cam, dev)
    timings, batches = phase_compare(scene, cam, pt, dev, card)
    launches, factor_frame = {}, None
    launches["pathtracer"], factor_frame = phase_frame(pt, cam, dev, card)
    phase5 = dict(image=pt.image().clone(), frames=pt.accumulated_samples, ms=factor_frame["ms"],
                  launches=launches["pathtracer"])
    check_trace_buckets(profile_frame(lambda: pt.render_frame(cam),
                                      "path-traced frame (phase 5's settings)",
                                      lambda k: k.startswith(PT_RANGES)), "phase 5's frame")
    del pt
    phase_small_reference(dev)

    from idkengine_tpu_torch.render import DeferredPipeline

    pipe = DeferredPipeline(db, WIDTH, HEIGHT, _deferred_settings(VXGI_RES), device=dev)
    timings["scatter_max_dense"] = phase_compare_scatter(db, scene, pipe, dev)
    launches["deferred"] = phase_deferred_frame(pipe, cam, dev, card)
    phase_compare_deferred_traces(pipe, cam, timings, card)
    check_deferred_buckets(profile_frame(lambda: pipe.render_frame(cam), "deferred frame",
                                         lambda key: key.startswith("deferred/")))
    phase_small_deferred(dev)
    del pipe
    torch.cuda.empty_cache()
    log(f"# phases 1-7 took {time.perf_counter() - t_start:.1f} s")

    timings.update(phase_two_phase(scene, batches))
    launches.update(phase_pipeline(db, cam, dev, card))
    phase_denoise_record(db, scene, cam, dev)
    timings["trace_closest_steps"], launches["debug_view"] = phase_debug_view(
        db, scene, cam, dev, card)
    phase_small_pipeline(dev)
    log(f"# phases 1-12 took {time.perf_counter() - t_start:.1f} s")
    probes = phase_probes(dev, card)
    log(f"# phases 1-13 took {time.perf_counter() - t_start:.1f} s")
    textured_launches, textured_db, textured_first = phase_textured(dev, card, args.seed,
                                                                    factor_frame, timings)
    launches.update(textured_launches)
    log(f"# phases 1-14 took {time.perf_counter() - t_start:.1f} s")
    caps, capped = phase_capped(scene, batches, timings, card)
    timings.update(capped)
    launches.update(phase_capped_frames(db, scene, cam, dev, card, caps, phase5))
    torch.cuda.empty_cache()
    log(f"# phases 1-16 took {time.perf_counter() - t_start:.1f} s")
    launches.update(phase_deferred_passes(textured_db, cam, dev, card, timings))
    del textured_db
    torch.cuda.empty_cache()
    log(f"# phases 1-17 took {time.perf_counter() - t_start:.1f} s")
    phase_small_passes(dev, args.seed)
    log(f"# phases 1-18 took {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    t_dyn = time.perf_counter()
    dyn_db, build_s = dynamic_scene(dev, args.seed)
    log(f"# phases 19-20's database: animated atrium {dyn_db.meta.n_triangles} tris, "
        f"{INSTANCE_COUNT} sphere instances; built in {build_s:.1f} s")
    dyn_launches, _ = phase_dynamics(dyn_db, cam, dev, card, args.seed, factor_frame)
    launches["pathtracer_refitted"] = dyn_launches
    inst_launches, two_level = phase_instanced(dyn_db, cam, dev, card, factor_frame)
    launches.update(inst_launches)
    timings.update(two_level)
    del dyn_db
    torch.cuda.empty_cache()
    log(f"# phases 19-20 took {time.perf_counter() - t_dyn:.1f} s")
    t_app = time.perf_counter()
    launches.update(phase_app(dev, card, args.seed, textured_first, timings))
    del textured_first
    phase_small_engine(dev, args.seed)
    log(f"# phase 21 took {time.perf_counter() - t_app:.1f} s")
    t_shard = time.perf_counter()
    launches["sharded"], _, spt = phase_sharded_frame(db, scene, cam, dev, card, phase5)
    del phase5
    _, whole = phase_shard_parts(spt, cam, dev, card)
    del spt
    phase_shard_traces(scene, batches, dev, card)
    del batches
    phase_sorts(dev, card, args.seed, whole)
    phase_shard_small(db, cam, dev, card)
    log(f"# phase 22 took {time.perf_counter() - t_shard:.1f} s")
    log(f"# phases 1-22 took {time.perf_counter() - t_start:.1f} s (the run's wall time)")

    kernels = []
    for name, where in KERNELS_WHERE.items():
        by_path = {path: counts[name] for path, counts in launches.items()}
        kernels.append(dict(name=name, **where, launches=sum(by_path.values()),
                            launches_by_path=by_path, **timings[name]))
    kernels += probes
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
