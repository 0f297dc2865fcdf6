#!/usr/bin/env python3
"""Time the port's path-traced frames from two or more checkouts on one
card, in turns.

    python3 frame_ab.py new=. old=build/parent [--frames 8] [--turns 2]
        [--kinds factor textured]

Each LABEL=DIR names a checkout (a directory holding idkengine_tpu_torch/,
for example the parent commit unpacked with `git archive` into build/).
Each turn runs every checkout once, in order, then in reverse order (A B,
B A, ...), each run in a process of its own that imports the port from its
checkout and renders, for each of `--kinds`, one warm-up frame and then
`--frames` timed frames of PathTracer on the card. The frames are
chip_smoke.py's, with its scene, build settings, lights, camera and
settings: `factor`, the 2.8M-triangle atrium with factor-only materials
(phase 5); `textured`, the same atrium with texture_atrium's material
model under the env map (phase 14; a checkout without it cannot run
this kind). Prints one line a run and kind (ms/frame, Mrays/s, the card's
name and power limit) and, last, each label's times. Needs a CUDA card;
exits nonzero without one.
"""
import argparse
import importlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def child(tree: str, frames: int, kinds: list) -> dict:
    """One run: each kind's frame of the checkout at `tree`, timed on the card."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    port = importlib.import_module("idkengine_tpu_torch")  # the checkout's, not this one's
    sys.path.insert(1, HERE)
    smoke = importlib.import_module("chip_smoke")  # the scene and settings of record
    from idkengine_tpu_torch.bvh.builder import BuildSettings
    from idkengine_tpu_torch.render import Camera, PathTracer, PathTracerSettings
    from idkengine_tpu_torch.scene.procedural import atrium
    from idkengine_tpu_torch.scene.scene_db import SceneDatabase

    if not torch.cuda.is_available():
        raise SystemExit("frame_ab: no CUDA card")
    dev = torch.device("cuda")
    cam = Camera(position=np.array(smoke.CAMERA["position"], np.float32),
                 yaw=smoke.CAMERA["yaw"], fov_y=smoke.CAMERA["fov_y"])
    out = {"port": os.path.dirname(port.__file__), "frames": {}}
    for kind in kinds:
        if kind == "factor":
            db = SceneDatabase(BuildSettings(**smoke.BUILD))
            db.add_model(atrium(smoke.TRIS))
            scene = db.build(dev)
            for pos, rad, r in smoke.LIGHTS:
                db.lights.add(pos, rad, radius=r)
            settings = PathTracerSettings(ray_depth=smoke.DEPTH, russian_roulette=False,
                                          do_ray_sorting=True, sky_strength=1.0)
            pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), smoke.WIDTH,
                            smoke.HEIGHT, settings, device=dev)
        else:
            db, scene, _ = smoke.textured_atrium(dev, 0, smoke.TRIS)
            pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), smoke.WIDTH,
                            smoke.HEIGHT, smoke.textured_settings(),
                            env_map=smoke.textured_env(dev, *smoke.ENV_SIZE),
                            slot_shading=db.slot_shading(), device=dev)
        pt.render_frame(cam)  # warm-up
        torch.cuda.synchronize()
        rays = 0.0
        t0 = time.perf_counter()
        for _ in range(frames):
            pt.render_frame(cam)
            rays += float(pt.last_rays_traced)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out["frames"][kind] = dict(ms=dt / frames * 1e3, mrays_per_s=rays / dt / 1e6)
        del pt, db, scene
        torch.cuda.empty_cache()
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="*", help="LABEL=DIR, two or more")
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--turns", type=int, default=2)
    parser.add_argument("--kinds", nargs="+", choices=("factor", "textured"), default=["factor"])
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.frames, args.kinds)))
        return 0
    trees = [t.split("=", 1) for t in args.trees]
    if len(trees) < 2 or any(len(t) != 2 for t in trees):
        parser.error("give two or more LABEL=DIR")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    order = []
    for turn in range(args.turns):
        order += trees if turn % 2 == 0 else trees[::-1]
    times = {(label, kind): [] for label, _ in trees for kind in args.kinds}
    for label, tree in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree,
                              "--frames", str(args.frames), "--kinds", *args.kinds], check=True,
                             capture_output=True, text=True,
                             timeout=900).stdout.strip().splitlines()[-1]
        run = json.loads(out)
        for kind, r in run["frames"].items():
            times[label, kind].append(r["ms"])
            print(f"# {label} ({run['port']}), {kind} frame: {r['ms']:.3f} ms/frame, "
                  f"{r['mrays_per_s']:.2f} Mrays/s, {args.frames} frames; on {card}", flush=True)
    for (label, kind), ms in times.items():
        print(f"# {label}, {kind} frame: " + " / ".join(f"{m:.3f}" for m in ms)
              + f" ms/frame; on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
