"""The render pipelines: deferred ("rasterizer mode") and path-traced.
Counterpart: idkengine_tpu/render/pipeline.py (`DeferredSettings2`,
`DeferredPipeline`, `PtPipelineSettings`, `PathTracerPipeline`).

Frame graph (the reference's raster graph re-thought as ray + image-space
passes, ref: Source/Render/RasterPipeline.cs:264-625):
  Halton jitter → [VXGI voxelize] → G-buffer (primary rays) → SSAO →
  [cone-traced GI] → deferred lighting with ray-traced shadows → bloom →
  TAA resolve → tonemap.

Every trace goes through `ops.packet_trace.trace_closest/trace_any`: the CUDA
traversal kernel on the card, the plain trace on the CPU. The device is the
card unless the caller asks for the CPU, and the scene must lie there.

SSR, volumetric light, transparency (OIT), the rate classifier, PCF shadow
maps and the render-scale (TAAU) mode are not ported: their toggles raise
NotImplementedError, and their sub-settings are left out.

Path-tracer mode (ref: PathTracerPipeline.cs): accumulate samples →
à-trous denoise once `denoise_at_samples` are in → bloom → AgX tonemap.
The adaptive bounce budget and multi-device sharding raise
NotImplementedError.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from functools import partial

import numpy as np
import torch
from torch.profiler import record_function

from ..ops.packet_trace import trace_any, trace_closest
from ..utils import mathutil as mu
from . import bloom as bloom_mod
from . import deferred as deferred_mod
from . import denoise as denoise_mod
from . import ssao as ssao_mod
from . import taa as taa_mod
from . import tonemap as tonemap_mod
from .camera import Camera
from .gbuffer import render_gbuffer
from .pathtracer import PathTracer, PathTracerSettings, uv_density
from .vxgi import VoxelGrid, VxgiSettings


@dataclass
class DeferredSettings2:
    """Pass toggles (the reference's per-pass setting objects)."""

    use_vxgi: bool = False
    use_ssao: bool = True
    use_ssr: bool = False  # not ported
    use_volumetric: bool = False  # not ported
    use_taa: bool = True
    use_bloom: bool = True
    use_oit: bool = False  # not ported
    use_classifier: bool = False  # not ported
    shadows: str = "ray_traced"  # none | ray_traced; pcf is not ported
    render_scale: int = 1  # only 1 (native resolution + plain TAA) is ported
    vxgi: VxgiSettings = field(default_factory=VxgiSettings)
    deferred: deferred_mod.DeferredSettings = field(default_factory=deferred_mod.DeferredSettings)
    taa: taa_mod.TaaSettings = field(default_factory=taa_mod.TaaSettings)
    bloom: bloom_mod.BloomSettings = field(default_factory=bloom_mod.BloomSettings)
    tonemap: tonemap_mod.TonemapSettings = field(default_factory=tonemap_mod.TonemapSettings)


def _refuse_settings(s: DeferredSettings2):
    for flag, what in ((s.use_ssr, "use_ssr"), (s.use_volumetric, "use_volumetric"),
                       (s.use_oit, "use_oit"), (s.use_classifier, "use_classifier"),
                       (s.shadows == "pcf", "shadows='pcf'"),
                       (s.render_scale > 1, "render_scale>1")):
        if flag:
            raise NotImplementedError(f"DeferredSettings2.{what} is not ported")
    if s.shadows not in ("none", "ray_traced"):
        raise ValueError(f"unknown shadow mode {s.shadows!r}")


def material_tensors(soa: dict, device) -> dict:
    """MaterialTable.soa() on `device`: float32 factors, int64 texture
    layers, the uint8 atlas."""
    out = {}
    for k, v in soa.items():
        if k == "atlas":
            out[k] = torch.as_tensor(np.asarray(v, np.uint8), device=device)
        elif k.endswith("_layer"):
            out[k] = torch.as_tensor(np.asarray(v, np.int64), device=device)
        else:
            out[k] = torch.as_tensor(np.asarray(v, np.float32), device=device)
    return out


class DeferredPipeline:
    """The 'rasterizer mode' equivalent (ref: RasterPipeline.Render) over a
    built SceneDatabase."""

    def __init__(self, scene_db, width: int, height: int,
                 settings: DeferredSettings2 | None = None, *, device="cuda"):
        self.settings = settings or DeferredSettings2()
        _refuse_settings(self.settings)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if scene_db.device_scene is None:
            raise ValueError("build the scene database before making its pipeline")
        if scene_db.device_scene.device != self.device:
            raise ValueError(f"scene is on {scene_db.device_scene.device}, "
                             f"the pipeline on {self.device}")
        self.db = scene_db
        self.width = width
        self.height = height
        soa = scene_db.materials.soa()
        self.mats = material_tensors(soa, self.device)
        self._shading_key, self._slot_shading = None, None
        # decided once: the G-buffer samples the atlas only for a textured scene
        self._has_textures = any(bool(np.any(np.asarray(soa[k]) >= 0))
                                 for k in ("base_layer", "mr_layer", "emissive_layer"))
        self._uv_density = (None, None)  # (scene, its per-slot UV density)
        self.frame = 0
        self.history = None
        self._prev_cam_params = None
        self.voxel_grid = None
        if self.settings.use_vxgi:
            lo = scene_db.blas.nodes["min"][0] - 0.1
            hi = scene_db.blas.nodes["max"][0] + 0.1
            self.voxel_grid = VoxelGrid(lo, hi, self.settings.vxgi, device=self.device)

    def slot_shading(self):
        """The scene's per-slot shading rows on the device, or None; made
        again only when the database's mesh overrides change."""
        key = tuple((k, ms.row().tobytes()) for k, ms in sorted(self.db.mesh_shading.items()))
        if key != self._shading_key:
            rows = self.db.slot_shading()
            self._slot_shading = (None if rows is None
                                  else torch.as_tensor(rows, device=self.device))
            self._shading_key = key
        return self._slot_shading

    def slot_uv_density(self, scene):
        """The scene's per-slot UV density for the texture LOD, or None for a
        scene without textures; made again only for a rebuilt scene."""
        if not self._has_textures:
            return None
        if self._uv_density[0] is not scene:
            self._uv_density = (scene, uv_density(scene.tri_uv, scene.tri_e1, scene.tri_e2))
        return self._uv_density[1]

    # -- frame graph ---------------------------------------------------
    def render_frame(self, camera: Camera) -> torch.Tensor:
        """Returns the tonemapped (H,W,3) [0,1] image."""
        s = self.settings
        _refuse_settings(s)
        w, h = self.width, self.height
        dev = self.device
        soa = self.db.lights.soa()
        lights = {k: torch.as_tensor(soa[k], device=dev) for k in ("pos", "radius", "radiance")}
        n_lights = len(self.db.lights.lights)
        scene = self.db.device_scene
        # the callbacks trace the scene of this frame, never an older one
        closest = partial(trace_closest, scene)
        occluded = partial(trace_any, scene)

        # TAA jitter (Halton, ref: RasterPipeline.cs:266-299)
        jitter = mu.halton_2d(16)[self.frame % 16] if s.use_taa else np.array([0.5, 0.5])
        cam_params = camera.ray_params(w, h)
        prev_cam = self._prev_cam_params or cam_params

        # each pass is a named range for torch.profiler (free when no
        # profiler runs)
        # [VXGI] voxelize + mips (ref: Voxelizer.Render)
        if s.use_vxgi and n_lights > 0:
            with record_function("deferred/voxelize"):
                self.voxel_grid.voxelize(scene, self.mats, lights, n_lights, frame=self.frame,
                                         occlusion_fn=occluded)

        # G-buffer (primary visibility); TAA biases the texture LOD
        # (ref: TAAResolve.cs:76-80)
        with record_function("deferred/G-buffer"):
            bias = taa_mod.mip_bias(w, self.width) if s.use_taa else 0.0
            gbuf = render_gbuffer(closest, scene, self.mats, cam_params, prev_cam, w, h,
                                  jitter=torch.as_tensor(jitter, dtype=torch.float32),
                                  mip_bias=bias, slot_shading=self.slot_shading(),
                                  slot_uv_density=self.slot_uv_density(scene))

        # SSAO on view-space positions: position relative to the camera in
        # its basis
        ao = None
        if s.use_ssao:
            with record_function("deferred/SSAO"):
                cam = {k: torch.as_tensor(cam_params[k], device=dev)
                       for k in ("origin", "forward", "right", "up")}
                rel = gbuf.position - cam["origin"]
                view_z = -(rel * cam["forward"]).sum(-1)
                view_pos = torch.stack([(rel * cam["right"]).sum(-1),
                                        (rel * cam["up"]).sum(-1), -view_z], dim=-1)
                ao = ssao_mod.ssao(view_pos, gbuf.normal, self.frame)

        # cone-traced GI
        gi = None
        if s.use_vxgi and self.voxel_grid.radiance is not None:
            with record_function("deferred/cone trace"):
                r = w * h
                gi = self.voxel_grid.cone_trace(gbuf.position.reshape(r, 3),
                                                gbuf.normal.reshape(r, 3),
                                                self.frame).reshape(h, w, 3)

        # deferred lighting + ray-traced shadows
        occ = occluded if s.shadows == "ray_traced" else None
        dsettings = (replace(s.deferred, shadow_mode=s.shadows)
                     if s.shadows != s.deferred.shadow_mode else s.deferred)
        with record_function("deferred/lighting + shadows"):
            color = deferred_mod.shade_deferred(gbuf, lights, n_lights, cam_params["origin"],
                                                occ, dsettings, gi=gi, ao=ao, frame=self.frame)

        if s.use_bloom:
            with record_function("deferred/bloom"):
                color = color + bloom_mod.bloom(color, s.bloom)

        if s.use_taa:
            with record_function("deferred/TAA"):
                if self.history is None:
                    self.history = color
                color = taa_mod.taa_resolve(color, self.history, gbuf.velocity,
                                            1.0 / torch.clamp(gbuf.depth, min=1e-3), s.taa)
                self.history = color

        self._prev_cam_params = cam_params
        self.frame += 1
        with record_function("deferred/tonemap"):
            return tonemap_mod.tonemap(color, s.tonemap)


_PT_OUTPUTS = ("noisy", "denoised", "albedo", "normal")


@dataclass
class PtPipelineSettings:
    denoise_at_samples: int = 32  # ref: PathTracerPipeline auto-denoise threshold
    output: str = "denoised"  # noisy | denoised | albedo | normal (ref selector)
    adaptive_rate: bool = False  # not ported (render/adaptive.py)
    shard_devices: int = 0  # only 0 (one device) is ported
    use_bloom: bool = True
    bloom: bloom_mod.BloomSettings = field(default_factory=bloom_mod.BloomSettings)
    tonemap: tonemap_mod.TonemapSettings = field(default_factory=tonemap_mod.TonemapSettings)
    denoise: denoise_mod.DenoiseSettings = field(default_factory=denoise_mod.DenoiseSettings)


def _refuse_pt_settings(s: PtPipelineSettings):
    for flag, what in ((s.adaptive_rate, "adaptive_rate"),
                       (s.shard_devices != 0, "shard_devices!=0")):
        if flag:
            raise NotImplementedError(f"PtPipelineSettings.{what} is not ported")
    if s.output not in _PT_OUTPUTS:
        raise ValueError(f"unknown output {s.output!r}; one of {_PT_OUTPUTS}")


class PathTracerPipeline:
    """PT accumulation + denoise + post (ref: PathTracerPipeline.cs) over a
    built SceneDatabase."""

    def __init__(self, scene_db, width: int, height: int,
                 pt_settings: PathTracerSettings | None = None,
                 settings: PtPipelineSettings | None = None, env_map=None, *,
                 device="cuda"):
        self.settings = settings or PtPipelineSettings()
        _refuse_pt_settings(self.settings)
        if scene_db.device_scene is None:
            raise ValueError("build the scene database before making its pipeline")
        self.db = scene_db
        self.pt = PathTracer(scene_db.device_scene, scene_db.materials.soa(),
                             scene_db.lights.soa(), width, height, pt_settings,
                             env_map=env_map, slot_shading=scene_db.slot_shading(),
                             device=device)
        self.width, self.height = width, height

    def reset_accumulation(self):
        self.pt.reset_accumulation()

    def render_frame(self, camera: Camera) -> torch.Tensor:
        """Adds a frame's samples; returns the (H,W,3) [0,1] image of the
        chosen output."""
        s = self.settings
        _refuse_pt_settings(s)
        h, w = self.height, self.width
        # each pass is a named range for torch.profiler
        with record_function("pt_sample"):
            img = self.pt.render_frame(camera)
        alb, nrm, dep = self.pt._last_aovs
        if s.output == "albedo":
            return torch.clamp(alb.reshape(h, w, 3), 0.0, 1.0)
        if s.output == "normal":
            return nrm.reshape(h, w, 3) * 0.5 + 0.5
        color = img
        if s.output == "denoised" and self.pt.accumulated_samples >= s.denoise_at_samples:
            with record_function("denoise"):
                color = denoise_mod.atrous_denoise(
                    img, alb.reshape(h, w, 3), nrm.reshape(h, w, 3), dep.reshape(h, w),
                    s.denoise, variance=self.pt.variance())
        if s.use_bloom:
            with record_function("bloom"):
                color = color + bloom_mod.bloom(color, s.bloom)
        with record_function("tonemap"):
            return tonemap_mod.tonemap(color, s.tonemap)
