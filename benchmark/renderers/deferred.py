"""The program's deferred frame (`idkengine_tpu_torch.render.DeferredPipeline`,
the rasterizer mode) as a cell drives it: the scene built as the path
tracer's module builds it, the pipeline made with the configuration's
settings, and one frame a pose. Each pose is a camera cut for TAA: the
history is restarted before the frame, so the resolve does all of its work
on this frame's colour alone, while the velocity comes from the previous
pose as the pipeline keeps it.

config keys: width, height, settings (DeferredSettings2 fields; a nested
object gives the fields of that setting's own dataclass, such as vxgi).

The voxelizer lays its area-proportional samples over the triangles in the
order the program's BVH holds them (its slots), which no description of the
frame fixes: this module hands that order to the reference as
`scene.slot_triangles` (the scene's triangle index of each slot).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from benchmark import scatter
from benchmark.harness import PACKAGE, sync
from benchmark.renderers.path_tracer import port_scene
from idkengine_tpu_torch.bvh.builder import BuildSettings
from idkengine_tpu_torch.render import Camera, DeferredPipeline, DeferredSettings2
from idkengine_tpu_torch.scene.scene_db import SceneDatabase


def settings_of(cls, values: dict):
    """cls(**values), a nested object made into the dataclass of its field."""
    base = cls()
    kw = {}
    for k, v in values.items():
        cur = getattr(base, k)
        kw[k] = type(cur)(**v) if dataclasses.is_dataclass(cur) and isinstance(v, dict) else v
    return cls(**kw)


class Renderer:
    def __init__(self, config: dict, traffic: dict, scene, device):
        self.width, self.height = int(config["width"]), int(config["height"])
        self.fov_y = float(traffic["camera"]["fov_y"])
        db = SceneDatabase(BuildSettings(**traffic["build"]))
        db.add_model(port_scene(scene))
        t0 = time.perf_counter()
        db.build(device)
        sync(device)
        self.build_s = time.perf_counter() - t0
        for light in scene.lights:
            db.lights.add(list(light.position), list(light.radiance), radius=light.radius)
        for part, fields in scene.mesh_shading.items():
            db.set_mesh_shading(part, **fields)
        scene.slot_triangles = np.asarray(db._slot_tri, np.int64)
        self.pipe = DeferredPipeline(db, self.width, self.height,
                                     settings_of(DeferredSettings2, config["settings"]),
                                     device=device)
        self._recorders = contextlib.ExitStack()
        self._recorders.enter_context(scatter.record_scatters(PACKAGE))

    @property
    def frame_index(self) -> int:
        """The next frame's index: its Halton jitter and its RNG's frame."""
        return self.pipe.frame

    def frame(self, pose) -> torch.Tensor:
        """The (H,W,3) tonemapped image of one frame at pose [x, y, z, yaw, pitch]."""
        cam = Camera(position=np.asarray(pose[:3], np.float32), yaw=float(pose[3]),
                     pitch=float(pose[4]), fov_y=self.fov_y)
        self.pipe.history = None
        return self.pipe.render_frame(cam)

    def close(self):
        self._recorders.close()
        self.pipe = None
