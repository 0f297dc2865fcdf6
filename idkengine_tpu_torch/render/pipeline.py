"""The render pipelines: deferred ("rasterizer mode") and path-traced.
Counterpart: idkengine_tpu/render/pipeline.py (`DeferredSettings2`,
`DeferredPipeline`, `PtPipelineSettings`, `PathTracerPipeline`).

Frame graph (the reference's raster graph re-thought as ray + image-space
passes, ref: Source/Render/RasterPipeline.cs:264-625):
  Halton jitter → [VXGI voxelize] → G-buffer (primary rays) → SSAO →
  [cone-traced GI] → deferred lighting with ray-traced or PCF cube-map
  shadows → [OIT depth peel] → [SSR] → [volumetric light] → bloom → TAA
  resolve, or TAAU to display resolution with `render_scale > 1` →
  [rate classifier] → tonemap.

Every trace goes through `ops.packet_trace.trace_closest/trace_any`: the CUDA
traversal kernel on the card, the plain trace on the CPU. The device is the
card unless the caller asks for the CPU, and the scene must lie there.

Path-tracer mode (ref: PathTracerPipeline.cs): accumulate samples →
à-trous denoise once `denoise_at_samples` are in → bloom → AgX tonemap;
with `adaptive_rate` the rate classifier sets next frame's per-pixel
bounce budget; with `shard_devices` each sample's pixels are split over
devices (parallel/shard.py: ShardedPathTracer).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from functools import partial

import numpy as np
import torch

from ..ops.packet_trace import trace_any, trace_closest
from ..parallel.shard import ShardedPathTracer, make_mesh
from ..profiling import pass_scope
from ..utils import mathutil as mu
from ..utils.compression import decompress_normal
from . import adaptive as adaptive_mod
from . import bloom as bloom_mod
from . import deferred as deferred_mod
from . import denoise as denoise_mod
from . import oit as oit_mod
from . import shadowmap as shadowmap_mod
from . import ssao as ssao_mod
from . import ssr as ssr_mod
from . import taa as taa_mod
from . import tonemap as tonemap_mod
from . import upscale as upscale_mod
from . import volumetric as vol_mod
from .camera import Camera, generate_rays
from .gbuffer import render_gbuffer
from .pathtracer import PathTracer, PathTracerSettings, sample_atlas, uv_density
from .vxgi import VoxelGrid, VxgiSettings


@dataclass
class DeferredSettings2:
    """Pass toggles (the reference's per-pass setting objects)."""

    use_vxgi: bool = False
    use_ssao: bool = True
    use_ssr: bool = False
    use_volumetric: bool = False
    use_taa: bool = True
    use_bloom: bool = True
    use_oit: bool = False  # depth-peeled transparency (ref: OIT #26)
    oit_layers: int = 4
    use_classifier: bool = False  # adaptive-rate map (ref: VRS #29)
    shadows: str = "ray_traced"  # none | pcf | ray_traced (ref modes)
    shadow_map_res: int = 256
    # render-scale mode (the FSR2 slot, ref: RasterPipeline.cs:611-624):
    # render the whole frame graph at (H/render_scale, W/render_scale) and
    # TAAU-resolve to display resolution. 1 = native + plain TAA.
    render_scale: int = 1
    upscale: upscale_mod.UpscaleSettings = field(default_factory=upscale_mod.UpscaleSettings)
    ssr: ssr_mod.SsrSettings = field(default_factory=ssr_mod.SsrSettings)
    vxgi: VxgiSettings = field(default_factory=VxgiSettings)
    deferred: deferred_mod.DeferredSettings = field(default_factory=deferred_mod.DeferredSettings)
    taa: taa_mod.TaaSettings = field(default_factory=taa_mod.TaaSettings)
    bloom: bloom_mod.BloomSettings = field(default_factory=bloom_mod.BloomSettings)
    tonemap: tonemap_mod.TonemapSettings = field(default_factory=tonemap_mod.TonemapSettings)


def _check_settings(s: DeferredSettings2, width: int, height: int):
    if s.shadows not in ("none", "pcf", "ray_traced"):
        raise ValueError(f"unknown shadow mode {s.shadows!r}")
    rs = max(1, int(s.render_scale))
    if width % rs or height % rs:
        raise ValueError(f"render_scale {rs} must divide the display resolution "
                         f"{width}x{height}")


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
        _check_settings(self.settings, width, height)
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
        self._shadow_mgr = None
        self.rate_map = None
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
        """Returns the tonemapped (H,W,3) [0,1] image; the frame is the span
        deferred/frame."""
        with pass_scope("deferred/frame"):
            return self._render_frame(camera)

    def _render_frame(self, camera: Camera) -> torch.Tensor:
        s = self.settings
        _check_settings(s, self.width, self.height)
        rs = max(1, int(s.render_scale))
        # render-scale mode: the whole frame graph runs at render resolution
        # and the TAAU resolve reconstructs display resolution (the FSR2
        # role, ref: RasterPipeline.cs:611-624)
        w, h = self.width // rs, self.height // rs
        dev = self.device
        cam_params = camera.ray_params(w, h)
        # the frame's host-to-device copies: the lights, the camera for SSAO
        with pass_scope("deferred/uploads"):
            soa = self.db.lights.soa()
            lights = {k: torch.as_tensor(soa[k], device=dev)
                      for k in ("pos", "radius", "radiance")}
            cam = ({k: torch.as_tensor(cam_params[k], device=dev)
                    for k in ("origin", "forward", "right", "up")} if s.use_ssao else None)
        n_lights = len(self.db.lights.lights)
        scene = self.db.device_scene
        # the callbacks trace the scene of this frame, never an older one
        closest = partial(trace_closest, scene)
        occluded = partial(trace_any, scene)

        # TAA jitter (Halton, ref: RasterPipeline.cs:266-299)
        jitter = (mu.halton_2d(16)[self.frame % 16] if (s.use_taa or rs > 1)
                  else np.array([0.5, 0.5], np.float32))
        prev_cam = self._prev_cam_params or cam_params

        # each pass is a named range for torch.profiler (free when no
        # profiler runs)
        # [VXGI] voxelize + mips (ref: Voxelizer.Render)
        if s.use_vxgi and n_lights > 0:
            with pass_scope("deferred/voxelize"):
                self.voxel_grid.voxelize(scene, self.mats, lights, n_lights, frame=self.frame,
                                         occlusion_fn=occluded)

        # G-buffer (primary visibility); TAA and TAAU bias the texture LOD
        # (ref: TAAResolve.cs:76-80)
        with pass_scope("deferred/G-buffer"):
            bias = taa_mod.mip_bias(w, self.width) if (rs > 1 or s.use_taa) else 0.0
            gbuf = render_gbuffer(closest, scene, self.mats, cam_params, prev_cam, w, h,
                                  jitter=torch.as_tensor(jitter, dtype=torch.float32),
                                  mip_bias=bias, slot_shading=self.slot_shading(),
                                  slot_uv_density=self.slot_uv_density(scene))

        # SSAO on view-space positions: position relative to the camera in
        # its basis
        ao = None
        if s.use_ssao:
            with pass_scope("deferred/SSAO"):
                rel = gbuf.position - cam["origin"]
                view_z = -(rel * cam["forward"]).sum(-1)
                view_pos = torch.stack([(rel * cam["right"]).sum(-1),
                                        (rel * cam["up"]).sum(-1), -view_z], dim=-1)
                ao = ssao_mod.ssao(view_pos, gbuf.normal, self.frame)

        # cone-traced GI
        gi = None
        if s.use_vxgi and self.voxel_grid.radiance is not None:
            with pass_scope("deferred/cone trace"):
                r = w * h
                gi = self.voxel_grid.cone_trace(gbuf.position.reshape(r, 3),
                                                gbuf.normal.reshape(r, 3),
                                                self.frame).reshape(h, w, 3)

        # PCF cube maps, each face culled against the camera frustum before
        # its 6*res^2-ray build (ref: CpuPointShadow.cs:116-185); a map is
        # rebuilt only when its light moved or a culled face came into view
        pcf_fn = None
        if s.shadows == "pcf" and n_lights > 0:
            with pass_scope("deferred/pcf build"):
                if self._shadow_mgr is None:
                    self._shadow_mgr = shadowmap_mod.PointShadowManager(
                        lambda o, d, tm: trace_closest(self.db.device_scene, o, d, tm).t,
                        s.shadow_map_res, device=dev)
                cam_frustum = camera.frustum(w, h)
                maps = [self._shadow_mgr.update(li, self.db.lights.lights[li].position,
                                                camera_frustum=cam_frustum)
                        for li in range(n_lights)]
            pcf_fn = lambda li, pts: shadowmap_mod.pcf_visibility(maps[li], pts)  # noqa: E731

        # deferred lighting + shadows
        occ = occluded if s.shadows == "ray_traced" else None
        dsettings = (replace(s.deferred, shadow_mode=s.shadows)
                     if s.shadows != s.deferred.shadow_mode else s.deferred)
        with pass_scope("deferred/lighting + shadows"):
            color = deferred_mod.shade_deferred(gbuf, lights, n_lights, cam_params["origin"],
                                                occ, dsettings, gi=gi, ao=ao, frame=self.frame,
                                                pcf_fn=pcf_fn)

        # depth-peeled OIT over the opaque result (ref: RecordTransparent/
        # ResolveTransparent; the layers arrive in depth order)
        if s.use_oit:
            with pass_scope("deferred/oit"):
                color = self._composite_transparency(color, cam_params, jitter, lights,
                                                     n_lights, closest, occluded)

        # SSR merge (ref: SSR then MergeTextures); misses fall back to the
        # sky along the reflected direction (ref: SSR/compute.glsl:79-81)
        if s.use_ssr:
            with pass_scope("deferred/ssr"):
                refl, _, _ = ssr_mod.ssr(color, gbuf.position, gbuf.normal, gbuf.depth,
                                         cam_params, settings=s.ssr)
                f = (1.0 - gbuf.roughness[..., None]) * gbuf.mask[..., None]
                color = color + refl * f * 0.5

        # volumetric light, shadow-traced at every march sample (ref:
        # VolumetricLight/compute.glsl:79)
        if s.use_volumetric and n_lights > 0:
            with pass_scope("deferred/volumetric"):
                color = color + vol_mod.volumetric_light(
                    gbuf.position, gbuf.depth, cam_params["origin"], lights["pos"],
                    lights["radiance"], n_lights, occluded if s.shadows != "none" else None)

        if s.use_bloom:
            with pass_scope("deferred/bloom"):
                color = color + bloom_mod.bloom(color, s.bloom)

        # TAA resolve at native resolution, or the TAAU resolve that
        # reconstructs display resolution from the jittered low-res frames
        if rs > 1:
            with pass_scope("deferred/taau"):
                vel_hr = upscale_mod.upsample_bilinear(gbuf.velocity, rs) * rs
                up_set = s.upscale if s.upscale.scale == rs else replace(s.upscale, scale=rs)
                self.history = upscale_mod.taau_resolve(
                    color, self.history, vel_hr,
                    (float(jitter[0]) - 0.5, float(jitter[1]) - 0.5), up_set)
                color = self.history[..., :3]
        elif s.use_taa:
            with pass_scope("deferred/TAA"):
                if self.history is None:
                    self.history = color
                color = taa_mod.taa_resolve(color, self.history, gbuf.velocity,
                                            1.0 / torch.clamp(gbuf.depth, min=1e-3), s.taa)
                self.history = color

        # adaptive-rate classifier map (ref: VRS tiles; consumers can feed it
        # back as per-tile sample budgets)
        if s.use_classifier:
            with pass_scope("deferred/classify"):
                self.rate_map = adaptive_mod.classify(color, gbuf.velocity)

        self._prev_cam_params = cam_params
        self.frame += 1
        with pass_scope("deferred/tonemap"):
            return tonemap_mod.tonemap(color, s.tonemap)

    def _composite_transparency(self, opaque_color, cam_params, jitter, lights, n_lights,
                                closest, occluded):
        """Depth-peel transparent surfaces along the camera rays, shade every
        layer with the full per-light loop and shadows (ref:
        RecordTransparent/fragment.glsl:77-93: transparent fragments get the
        opaque lighting), and composite front to back over the opaque
        shading (render/oit.py)."""
        s = self.settings
        h, w = opaque_color.shape[:2]  # render resolution
        o, d = generate_rays(cam_params, w, h, torch.as_tensor(jitter, dtype=torch.float32,
                                                               device=self.device))
        mats = self.mats
        scene = self.db.device_scene
        trans_of = mats["transmission"]
        occ_fn = occluded if s.shadows == "ray_traced" and n_lights else None

        def trace(o_, d_, t_min, t_far):
            hit = closest((o_ + d_ * t_min[..., None]).contiguous(), d_, t_far)
            p = o_ + d_ * (t_min + hit.t)[..., None]
            return hit.t, hit.slot >= 0, p, hit.slot, hit.u, hit.v

        def shade(t, valid, p, slot_raw, u, v):
            slot = torch.clamp(slot_raw, min=0).long()
            mid = scene.tri_mat[slot].long()
            base = mats["base_color"][mid]
            w_b = 1.0 - u - v
            uv = (scene.tri_uv[slot, 0] * w_b[..., None] + scene.tri_uv[slot, 1] * u[..., None]
                  + scene.tri_uv[slot, 2] * v[..., None])
            tex = sample_atlas(mats["atlas"], mats["base_layer"][mid], uv)
            alb = base[:, :3] * tex[..., :3]
            a = torch.where(trans_of[mid] > 0.0, 1.0 - trans_of[mid],
                            torch.where(base[:, 3] < 1.0, base[:, 3] * tex[..., 3], 1.0))
            # opaque hits end the peel without compositing: the opaque pass
            # shaded them
            stop = a >= 0.999
            n_c = decompress_normal(scene.tri_n[slot])  # (R, 3 corners, 3)
            ns = n_c[:, 0] * w_b[..., None] + n_c[:, 1] * u[..., None] + n_c[:, 2] * v[..., None]
            ns = ns / torch.clamp(torch.linalg.vector_norm(ns, dim=-1, keepdim=True), min=1e-12)
            ns = torch.where(((ns * d).sum(-1) > 0.0)[..., None], -ns, ns)
            mr = sample_atlas(mats["atlas"], mats["mr_layer"][mid], uv)
            met = mats["metallic"][mid] * mr[..., 2]
            rough = mats["roughness"][mid] * mr[..., 1]
            rgb = deferred_mod.shade_points(p, ns, alb, met, rough, cam_params["origin"],
                                            lights, n_lights, occ_fn, s.deferred,
                                            frame=self.frame)
            em = sample_atlas(mats["atlas"], mats["emissive_layer"][mid], uv)
            return rgb + mats["emissive"][mid] * em[..., :3], a, stop

        color, alpha = oit_mod.peel_layers(
            trace, shade, o, d, torch.full((w * h,), 3.4e38, device=self.device),
            layers=s.oit_layers)
        return oit_mod.composite_over(color.reshape(h, w, 3), alpha.reshape(h, w), opaque_color)


_PT_OUTPUTS = ("noisy", "denoised", "albedo", "normal")


@dataclass
class PtPipelineSettings:
    denoise_at_samples: int = 32  # ref: PathTracerPipeline auto-denoise threshold
    output: str = "denoised"  # noisy | denoised | albedo | normal (ref selector)
    # adaptive bounce budget from the rate classifier (render/adaptive.py):
    # smooth tiles end their paths earlier next frame
    adaptive_rate: bool = False
    # devices the path tracer's rays are split over (parallel/shard.py): 0
    # one, n the first n of the pipeline's device type, -1 every visible
    # card (one device on the CPU)
    shard_devices: int = 0
    use_bloom: bool = True
    bloom: bloom_mod.BloomSettings = field(default_factory=bloom_mod.BloomSettings)
    tonemap: tonemap_mod.TonemapSettings = field(default_factory=tonemap_mod.TonemapSettings)
    denoise: denoise_mod.DenoiseSettings = field(default_factory=denoise_mod.DenoiseSettings)


def _check_pt_settings(s: PtPipelineSettings):
    if s.shard_devices < -1:
        raise ValueError(f"shard_devices must be -1, 0 or a device count, got {s.shard_devices}")
    if s.output not in _PT_OUTPUTS:
        raise ValueError(f"unknown output {s.output!r}; one of {_PT_OUTPUTS}")


def _shard_count(shard_devices: int, device: torch.device) -> int:
    """Devices of PtPipelineSettings.shard_devices on `device`'s type."""
    if shard_devices == -1:
        return torch.cuda.device_count() if device.type == "cuda" else 1
    return max(shard_devices, 1)


class PathTracerPipeline:
    """PT accumulation + denoise + post (ref: PathTracerPipeline.cs) over a
    built SceneDatabase, its instances traced two-level."""

    def __init__(self, scene_db, width: int, height: int,
                 pt_settings: PathTracerSettings | None = None,
                 settings: PtPipelineSettings | None = None, env_map=None, *,
                 device="cuda"):
        self.settings = settings or PtPipelineSettings()
        _check_pt_settings(self.settings)
        if scene_db.device_scene is None:
            raise ValueError("build the scene database before making its pipeline")
        self.db = scene_db
        self.pt = PathTracer(scene_db.device_scene, scene_db.materials.soa(),
                             scene_db.lights.soa(), width, height, pt_settings,
                             env_map=env_map, instances=scene_db.instance_set(),
                             inst_attr_srcs=scene_db._inst_attr_srcs,
                             slot_shading=scene_db.slot_shading(), device=device)
        n = _shard_count(self.settings.shard_devices, self.pt.device)
        if n > 1:
            self.pt = ShardedPathTracer(self.pt, make_mesh(n, device=self.pt.device.type))
        self.width, self.height = width, height
        self._rate_depth = None

    def reset_accumulation(self):
        self.pt.reset_accumulation()
        self._rate_depth = None

    def render_frame(self, camera: Camera) -> torch.Tensor:
        """Adds a frame's samples; returns the (H,W,3) [0,1] image of the
        chosen output."""
        s = self.settings
        _check_pt_settings(s)
        h, w = self.height, self.width
        # each pass is a named range for torch.profiler
        with pass_scope("pt_sample"):
            img = self.pt.render_frame(camera, rate_depth=self._rate_depth)
        alb, nrm, dep = self.pt._last_aovs
        if s.adaptive_rate and self.pt.accumulated_samples >= 2:
            with pass_scope("classify"):
                rate = adaptive_mod.classify(img, torch.zeros((h, w, 2), device=img.device))
                self._rate_depth = adaptive_mod.bounce_budget(rate, self.pt.settings.ray_depth,
                                                              w, h)
        if s.output == "albedo":
            return torch.clamp(alb.reshape(h, w, 3), 0.0, 1.0)
        if s.output == "normal":
            return nrm.reshape(h, w, 3) * 0.5 + 0.5
        color = img
        if s.output == "denoised" and self.pt.accumulated_samples >= s.denoise_at_samples:
            with pass_scope("denoise"):
                color = denoise_mod.atrous_denoise(
                    img, alb.reshape(h, w, 3), nrm.reshape(h, w, 3), dep.reshape(h, w),
                    s.denoise, variance=self.pt.variance())
        if s.use_bloom:
            with pass_scope("bloom"):
                color = color + bloom_mod.bloom(color, s.bloom)
        with pass_scope("tonemap"):
            return tonemap_mod.tonemap(color, s.tonemap)
