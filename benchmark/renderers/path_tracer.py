"""The program's path tracer (`idkengine_tpu_torch.render.PathTracer`) as a
cell drives it: the scene data handed to the port's model and scene build,
the tracer made with the configuration's settings, and one frame a pose
after a reset of the accumulation, as an interactive viewer resets it when
the camera moves.

config keys: width, height, settings (PathTracerSettings fields). Where the
scene has a sky map, the tracer takes it with next-event estimation toward
it (use_env_map, env_nee); the scene's per-part shading overrides go to
SceneDatabase.set_mesh_shading.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import sync
from idkengine_tpu_torch.bvh.builder import BuildSettings
from idkengine_tpu_torch.render import Camera, PathTracer, PathTracerSettings
from idkengine_tpu_torch.scene import model as port_model
from idkengine_tpu_torch.scene.scene_db import SceneDatabase


def port_scene(scene):
    """The port's Model of a SceneData: one primitive a part, its normals
    given, under one root node."""
    m = port_model.Model(name="benchmark_scene")
    m.materials = [port_model.Material(
        name=x.name, base_color=np.asarray(x.base_color, np.float32),
        emissive=np.asarray(x.emissive, np.float32), metallic=x.metallic,
        roughness=x.roughness, ior=x.ior, transmission=x.transmission,
        absorbance=np.asarray(x.absorbance, np.float32), alpha_cutoff=x.alpha_cutoff,
        base_color_texture=x.base_color_texture,
        metallic_roughness_texture=x.metallic_roughness_texture,
        normal_texture=x.normal_texture, emissive_texture=x.emissive_texture)
        for x in scene.materials]
    m.textures = [port_model.Texture(name=t.name, data=t.data, is_srgb=t.srgb)
                  for t in scene.textures]
    for p in scene.parts:
        m.primitives.append(port_model.MeshPrimitive(positions=p.positions, indices=p.indices,
                                                     normals=p.normals, uvs=p.uvs,
                                                     material=p.material))
    m.nodes.append(port_model.Node(name="root", mesh_primitives=list(range(len(m.primitives)))))
    m.root_nodes.append(0)
    return m


class Renderer:
    def __init__(self, config: dict, traffic: dict, scene, device):
        self.device = device
        self.width, self.height = int(config["width"]), int(config["height"])
        self.fov_y = float(traffic["camera"]["fov_y"])
        db = SceneDatabase(BuildSettings(**traffic["build"]))
        db.add_model(port_scene(scene))
        t0 = time.perf_counter()
        arrays = db.build(device)
        sync(device)
        self.build_s = time.perf_counter() - t0
        for light in scene.lights:
            db.lights.add(list(light.position), list(light.radiance), radius=light.radius)
        for part, fields in scene.mesh_shading.items():
            db.set_mesh_shading(part, **fields)
        settings = dict(config["settings"])
        if scene.env is not None:  # a scene's sky map, with next-event estimation toward it
            settings.update(use_env_map=True, env_nee=True)
        self.tracer = PathTracer(arrays, db.materials.soa(), db.lights.soa(), self.width,
                                 self.height, PathTracerSettings(**settings), env_map=scene.env,
                                 slot_shading=db.slot_shading(), device=device)
        self.frame_index = 0  # the RNG's frame index of the next frame's sample
        self.spp = self.tracer.settings.spp_per_frame

    def frame(self, pose) -> torch.Tensor:
        """The (H,W,3) linear image of one frame at pose [x, y, z, yaw, pitch]."""
        cam = Camera(position=np.asarray(pose[:3], np.float32), yaw=float(pose[3]),
                     pitch=float(pose[4]), fov_y=self.fov_y)
        self.tracer.reset_accumulation()
        img = self.tracer.render_frame(cam)
        self.frame_index += self.spp
        return img

    def close(self):
        self.tracer = None
