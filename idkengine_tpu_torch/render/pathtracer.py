"""Wavefront path tracer over the ray megabatch.
Counterpart: idkengine_tpu/render/pathtracer.py (`PathTracerSettings`, `PathTracer`).

Every pixel's ray keeps a fixed place in a batch of W*H rays; dead rays
carry t_max < 0 and leave traversal at once (ref: Source/Render/
PathTracer.cs + Resource/Shaders/PathTracing/**). Per bounce: optional ray
sort, closest-hit trace, light spheres, hit attribute fetch, next-event
estimation with an any-hit shadow trace, BSDF sampling, Russian roulette;
then accumulation.

Image semantics are those of the JAX package's path without the packet
tracer: launch order is pixel order, each ray picks its NEE light from its
own RNG state, and shadow rays are not re-sorted. With `do_ray_sorting` the
whole ray state, RNG state included, is permuted by the octant+Morton key
and stays sorted; radiance returns to pixel order at the end, so sorting
changes the traversal order and never the image.

With `use_two_phase` every closest-hit and shadow trace goes through the
two-phase traversal (ops/two_phase.py), as the JAX package routes it
(pathtracer.py:614-646); the image is the one-phase image up to equal-t
ties.

The slice renders factor-only materials; textures, alpha-tested materials,
normal maps, environment maps, instances, per-mesh shading overrides,
adaptive bounce budgets and tiling raise NotImplementedError.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..ops.intersect import ray_sphere
from ..ops.packet_trace import trace_any, trace_closest
from ..ops.two_phase import two_phase_any, two_phase_closest
from ..ops.trace import SceneArrays
from ..utils import rng
from ..utils.compression import decompress_normal
from . import sampling, shading
from .camera import Camera, generate_rays

# Per-slot attribute columns (one row gather per hit): the channels of the
# JAX package's attribute pack that factor-only shading reads. Normals are
# uint32 bit patterns kept as two exact u16 halves in float32.
_GN, _N_LO, _N_HI, _ALBEDO, _EMISSIVE = 0, 3, 6, 9, 12
_METALLIC, _ROUGH, _TRANS, _IOR, _ABSORB = 15, 16, 17, 18, 19
ATTR_CH = 22

_DEAD_KEY = 0x7FFFFFFF
_NO_MAX_STEPS = 1 << 30


@dataclass(frozen=True)
class PathTracerSettings:
    """ref: PathTracer.cs settings block (:12-140). Same fields as the JAX
    package's settings; the port's slice refuses the ones marked."""

    ray_depth: int = 5
    spp_per_frame: int = 1
    russian_roulette: bool = True
    rr_min_bounce: int = 2
    nee: bool = True  # next-event estimation toward sphere lights
    use_packet_tracer: bool = True  # traversal kernel on the card (always)
    use_two_phase: bool = False  # traces through ops/two_phase.py
    do_ray_sorting: bool = False
    tile_size: int = 0  # only 0 (whole batch in one traversal) is ported
    light_spheres: bool = True
    sky_zenith: tuple = (0.45, 0.65, 1.0)
    sky_horizon: tuple = (0.9, 0.9, 0.95)
    sky_strength: float = 1.0
    use_env_map: bool = False  # not ported
    env_nee: bool = False  # not ported
    max_trace_steps: int = _NO_MAX_STEPS  # only the default is ported
    mip_bias: float = 0.0  # texture LOD bias; unused by factor-only materials


def _refuse_settings(s: PathTracerSettings):
    for flag, what in ((s.use_env_map, "use_env_map"), (s.env_nee, "env_nee"),
                       (s.tile_size > 0, "tile_size>0"),
                       (s.max_trace_steps != _NO_MAX_STEPS, "max_trace_steps")):
        if flag:
            raise NotImplementedError(f"PathTracerSettings.{what} is not ported")


def _morton_spread(v):
    # interleave 8 bits with 2-bit gaps
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


class PathTracer:
    """Owns the device buffers and the sample step; accumulates frames.

    Equivalent in role to PathTracer.cs + PathTracerPipeline.cs."""

    def __init__(self, scene: SceneArrays, materials: dict, lights: dict,
                 width: int, height: int, settings: PathTracerSettings | None = None,
                 env_map=None, instances=None, slot_shading=None, *, device="cuda"):
        for arg, what in ((env_map, "env_map"), (instances, "instances"),
                          (slot_shading, "slot_shading")):
            if arg is not None:
                raise NotImplementedError(f"PathTracer({what}=...) is not ported")
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if scene.device != self.device:
            raise ValueError(f"scene is on {scene.device}, the tracer on {self.device}")
        for key in ("base_layer", "mr_layer", "emissive_layer", "normal_layer"):
            if np.any(np.asarray(materials.get(key, [-1])) >= 0):
                raise NotImplementedError(f"textured materials ({key}) are not ported")
        cutoffs = np.asarray(materials["alpha_cutoff"])
        if np.any((cutoffs >= 0.0) & (np.asarray(materials["base_color"])[:, 3] < 1.0)):
            raise NotImplementedError("alpha-tested materials are not ported")

        self._use_settings(settings or PathTracerSettings())
        self.scene = scene
        self.width = width
        self.height = height
        self.n_lights = int(lights.get("count", 0))
        self.lights = {k: torch.as_tensor(np.asarray(lights[k], np.float32), device=self.device)
                       for k in ("pos", "radius", "radiance")}
        self._attr = self._pack_attr(scene, materials)
        n_px = height * width
        self.accum = torch.zeros((n_px, 3), device=self.device)
        # running mean of per-sample luminance^2 (per-pixel variance)
        self.accum_lum2 = torch.zeros((n_px,), device=self.device)
        self.accumulated_samples = 0
        self._frame = 0
        self.last_rays_traced = torch.zeros((), device=self.device)

    def _pack_attr(self, scene: SceneArrays, materials: dict) -> torch.Tensor:
        """(T, ATTR_CH) per-slot attributes: face normal, corner normals and
        material factors (JAX: `_pack_attr`, channels 6:25)."""
        m = {k: torch.as_tensor(np.asarray(materials[k], np.float32), device=self.device)
             for k in ("base_color", "emissive", "metallic", "roughness",
                       "transmission", "ior", "absorbance")}
        mat_f = torch.cat([m["base_color"][:, :3], m["emissive"], m["metallic"][:, None],
                           m["roughness"][:, None], m["transmission"][:, None],
                           m["ior"][:, None], m["absorbance"]], dim=-1)  # (M,13)
        mat = scene.tri_mat.long()
        attr = torch.zeros((mat.shape[0], ATTR_CH), device=self.device)
        attr[:, _GN:_GN + 3] = scene.tri_gn
        attr[:, _N_LO:_N_LO + 3] = (scene.tri_n & 0xFFFF).float()
        attr[:, _N_HI:_N_HI + 3] = (scene.tri_n >> 16).float()
        attr[:, _ALBEDO:_ALBEDO + 13] = mat_f[mat]
        return attr

    # -- settings with reset semantics (ref: PathTracer.cs setters) -------
    def _use_settings(self, settings: PathTracerSettings):
        _refuse_settings(settings)
        self.settings = settings
        # sky colours as device vectors, made once (not per bounce)
        self._sky_zenith = torch.tensor(settings.sky_zenith, device=self.device)
        self._sky_horizon = torch.tensor(settings.sky_horizon, device=self.device)

    def set_settings(self, **kw):
        self._use_settings(replace(self.settings, **kw))
        self.reset_accumulation()

    def reset_accumulation(self):
        """ref: PathTracer ResetAccumulation on camera/scene change."""
        self.accum.zero_()
        self.accum_lum2.zero_()
        self.accumulated_samples = 0

    # ----------------------------------------------------------------
    def _sky(self, d):
        t = torch.clamp(d[..., 1] * 0.5 + 0.5, 0.0, 1.0)[..., None]
        return (self._sky_horizon * (1.0 - t) + self._sky_zenith * t) * self.settings.sky_strength

    def _ray_sort_key(self, o, d, alive):
        """Direction octant (3 bits) << 24 | Morton cell of the origin; dead
        rays sort last."""
        scene_lo = self.scene.node_min[0]
        scene_ext = self.scene.node_max[0] - scene_lo
        q = torch.clamp((o - scene_lo) / torch.clamp(scene_ext, min=1e-6) * 256.0,
                        0.0, 255.0).to(torch.int64)
        cell = ((_morton_spread(q[:, 0]) << 2) | (_morton_spread(q[:, 1]) << 1)
                | _morton_spread(q[:, 2]))
        pos = (d >= 0).to(torch.int64)
        octant = pos[:, 0] + 2 * pos[:, 1] + 4 * pos[:, 2]
        return torch.where(alive, (octant << 24) | cell, _DEAD_KEY)

    def _render_sample(self, cam_params: dict, frame: int):
        s = self.settings
        w, h = self.width, self.height
        r = w * h
        dev = self.device
        scene, lights, attr = self.scene, self.lights, self._attr
        closest, occluded_fn = trace_closest, trace_any
        if s.use_two_phase:
            closest, occluded_fn = two_phase_closest, two_phase_any

        pixel_of = torch.arange(r, device=dev)  # ray i belongs to pixel pixel_of[i]
        state = rng.init_state(pixel_of, frame)
        # subpixel jitter + thin lens
        state, u_pix = rng.uniform2(state)
        state, u_lens = rng.uniform2(state)
        o, d = generate_rays(cam_params, w, h, u_pix, u_lens)

        radiance = torch.zeros((r, 3), device=dev)
        throughput = torch.ones((r, 3), device=dev)
        alive = torch.ones(r, dtype=torch.bool, device=dev)
        inside = torch.zeros(r, dtype=torch.bool, device=dev)
        # last bounce was delta-like (primary/specular/transmissive): BSDF
        # light hits count only then, NEE covers the diffuse paths
        last_delta = torch.ones(r, dtype=torch.bool, device=dev)
        aov_albedo = torch.zeros((r, 3), device=dev)
        aov_normal = torch.zeros((r, 3), device=dev)
        aov_depth = torch.zeros(r, device=dev)
        rays_traced = torch.zeros((), dtype=torch.int64, device=dev)

        for bounce in range(s.ray_depth):
            if s.do_ray_sorting and bounce > 0:
                # permute the whole ray state once; it stays sorted, and
                # the RNG state travels with its ray
                perm = torch.sort(self._ray_sort_key(o, d, alive)).indices
                fstate = torch.cat([o, d, radiance, throughput], dim=1)[perm]
                o, d = fstate[:, 0:3], fstate[:, 3:6]
                radiance, throughput = fstate[:, 6:9], fstate[:, 9:12]
                flags = (alive.long() | (inside.long() << 1) | (last_delta.long() << 2))
                istate = torch.stack([state, pixel_of, flags], dim=1)[perm]
                state, pixel_of, flags = istate[:, 0], istate[:, 1], istate[:, 2]
                alive, inside, last_delta = (flags & 1) != 0, (flags & 2) != 0, (flags & 4) != 0
                o, d = o.contiguous(), d.contiguous()
            rays_traced = rays_traced + alive.sum()
            t_max = torch.where(alive, 3.4e38, -1.0)
            hit = closest(scene, o, d, t_max)

            # analytic light spheres (ref: BVHIntersect.glsl:189-203 traces
            # lights before the BLAS)
            light_t = torch.full((r,), 3.4e38, device=dev)
            light_id = torch.full((r,), -1, dtype=torch.int64, device=dev)
            if s.light_spheres:
                for li in range(self.n_lights):
                    lh, lt = ray_sphere(o, d, lights["pos"][li], lights["radius"][li])
                    closer = lh & (lt < light_t)
                    light_t = torch.where(closer, lt, light_t)
                    light_id = torch.where(closer, li, light_id)

            hit_tri = alive & (hit.slot >= 0) & (hit.t < light_t)
            hit_light = alive & (light_id >= 0) & ~hit_tri
            miss = alive & ~hit_tri & ~hit_light

            # miss: sky
            radiance = radiance + torch.where(miss[..., None], throughput * self._sky(d), 0.0)
            # light hit: emitted radiance; with NEE on only delta-like paths
            # collect it (NEE owns the diffuse direct term)
            if s.light_spheres and self.n_lights > 0:
                l_emit = lights["radiance"][torch.clamp(light_id, min=0)]
                count_hit = hit_light & (last_delta | (not s.nee))
                radiance = radiance + torch.where(count_hit[..., None], throughput * l_emit, 0.0)

            # surface hit: one row gather of the packed slot attributes
            slot = torch.clamp(hit.slot, min=0).long()
            u_b, v_b = hit.u, hit.v
            w_b = 1.0 - u_b - v_b
            af = attr[slot]
            n_bits = (af[:, _N_HI:_N_HI + 3].long() << 16) | af[:, _N_LO:_N_LO + 3].long()
            n_c = decompress_normal(n_bits)  # (R,3 corners,3)
            ns = n_c[:, 0] * w_b[..., None] + n_c[:, 1] * u_b[..., None] + n_c[:, 2] * v_b[..., None]
            ns = ns / torch.clamp(torch.linalg.vector_norm(ns, dim=-1, keepdim=True), min=1e-12)
            gn = af[:, _GN:_GN + 3]
            # face-forward against the incoming ray
            gn = torch.where(((gn * d).sum(-1) > 0.0)[..., None], -gn, gn)
            ns = torch.where((ns * gn).sum(-1, keepdim=True) < 0.0, -ns, ns)

            albedo = af[:, _ALBEDO:_ALBEDO + 3]
            emissive = af[:, _EMISSIVE:_EMISSIVE + 3]
            metallic = af[:, _METALLIC]
            roughness = af[:, _ROUGH]
            transmission = af[:, _TRANS]
            ior = af[:, _IOR]
            absorb = af[:, _ABSORB:_ABSORB + 3]

            if bounce == 0:
                aov_albedo = torch.where(hit_tri[..., None], albedo, aov_albedo)
                aov_normal = torch.where(hit_tri[..., None], ns, aov_normal)
                aov_depth = torch.where(hit_tri, hit.t, aov_depth)

            # Beer–Lambert absorbance through the medium
            # (ref: FirstHit/compute.glsl:179-183)
            seg = torch.clamp(hit.t, max=1e30)
            att = torch.exp(-absorb * torch.where(inside, seg, 0.0)[..., None])
            throughput = torch.where(hit_tri[..., None], throughput * att, throughput)
            radiance = radiance + torch.where(hit_tri[..., None], throughput * emissive, 0.0)

            hp_point = o + d * hit.t[..., None]

            # next-event estimation: one light per ray, one shadow ray
            # (solid-angle sampling, ref: Sampling.glsl + ShadowsRayTraced)
            if s.nee and s.light_spheres and self.n_lights > 0:
                state, u_pick = rng.uniform(state)
                li = torch.clamp((u_pick * self.n_lights).long(), max=self.n_lights - 1)
                l_pos = lights["pos"][li]
                l_rad = lights["radius"][li]
                l_emit = lights["radiance"][li]
                state, u_l = rng.uniform2(state)
                ldir, lpdf, _ = sampling.sphere_light_sample(hp_point, l_pos, l_rad, u_l)
                cos_s = torch.clamp((ns * ldir).sum(-1), min=0.0)
                # distance to the sphere surface along ldir
                sh_hit, sh_t = ray_sphere(hp_point, ldir, l_pos, l_rad)
                eps_o = 1e-4 * torch.clamp(torch.linalg.vector_norm(hp_point, dim=-1), min=1.0)
                do_nee = hit_tri & (cos_s > 0.0) & sh_hit
                rays_traced = rays_traced + do_nee.sum()
                sh_tmax = torch.where(do_nee, sh_t - 2.0 * eps_o, -1.0)
                sh_o = hp_point + gn * eps_o[..., None]
                occluded = occluded_fn(scene, sh_o.contiguous(), ldir.contiguous(), sh_tmax)
                # full GGX BRDF (diffuse + rough specular); near-delta
                # specular and transmission are left to BSDF sampling
                brdf_cos = shading.ggx_brdf(ns, -d, ldir, albedo, metallic, roughness)
                brdf_cos = brdf_cos * (1.0 - transmission)[..., None]
                contrib = (throughput * brdf_cos * l_emit
                           / torch.clamp(lpdf, min=1e-8)[..., None] * float(self.n_lights))
                radiance = radiance + torch.where((do_nee & ~occluded)[..., None], contrib, 0.0)

            state, u_lobe = rng.uniform(state)
            state, u_dir = rng.uniform2(state)
            # transmission tint (ref: Shading.glsl:136-144): albedo when
            # entering or volumetric
            wants_tint = (absorb > 0.0).any(dim=-1) | ~inside
            trans_tint = torch.where(wants_tint[..., None], albedo, 1.0)
            surf = shading.sample_bsdf(d, ns, albedo, metallic, roughness, transmission,
                                       ior, inside, u_lobe, u_dir, trans_tint=trans_tint)
            eps = 1e-4 * torch.clamp(torch.linalg.vector_norm(hp_point, dim=-1, keepdim=True),
                                     min=1.0)
            side = torch.where(surf.is_transmissive[..., None], -gn, gn)
            o = torch.where(hit_tri[..., None], hp_point + side * eps, o)
            d = torch.where(hit_tri[..., None], surf.direction, d)
            throughput = torch.where(hit_tri[..., None], throughput * surf.throughput_mul,
                                     throughput)
            inside = torch.where(hit_tri & surf.is_transmissive, ~inside, inside)
            # delta-like only when the specular lobe is mirror-sharp; rough
            # specular is covered by the NEE GGX term
            last_delta = (surf.is_specular & (roughness < 0.15)) | surf.is_transmissive
            alive = hit_tri

            # russian roulette (ref: include/RussianRoulette.glsl)
            if s.russian_roulette and bounce >= s.rr_min_bounce:
                p = torch.clamp(throughput.amax(dim=-1), 0.02, 1.0)
                state, u_rr = rng.uniform(state)
                throughput = throughput / p[..., None]
                alive = alive & (u_rr < p)

        if s.do_ray_sorting and s.ray_depth > 1:
            # back to pixel order
            radiance = torch.empty_like(radiance).index_copy_(0, pixel_of, radiance)
        return radiance, aov_albedo, aov_normal, aov_depth, rays_traced

    # ----------------------------------------------------------------
    def render_frame(self, camera: Camera, rate_depth=None) -> torch.Tensor:
        """Trace spp_per_frame samples and fold them into the running average
        (ref: FinalDraw/compute.glsl accumulation). Returns image()."""
        if rate_depth is not None:
            raise NotImplementedError("render_frame(rate_depth=...) is not ported")
        cam_params = camera.ray_params(self.width, self.height)
        rays = torch.zeros((), dtype=torch.int64, device=self.device)
        for _ in range(self.settings.spp_per_frame):
            radiance, alb, nrm, dep, nrays = self._render_sample(cam_params, self._frame)
            n = self.accumulated_samples
            self.accum = (self.accum * n + radiance) / (n + 1)
            lum = radiance[:, 0] * 0.2126 + radiance[:, 1] * 0.7152 + radiance[:, 2] * 0.0722
            self.accum_lum2 = (self.accum_lum2 * n + lum * lum) / (n + 1)
            self.accumulated_samples = n + 1
            self._frame += 1
            self._last_aovs = (alb, nrm, dep)
            rays = nrays
        # rays traced (closest + shadow) by the frame's last sample; a device
        # scalar, float() to read
        self.last_rays_traced = rays.float()
        return self.image()

    def image(self) -> torch.Tensor:
        """(H,W,3) accumulated linear radiance."""
        return self.accum.reshape(self.height, self.width, 3)

    def variance(self) -> torch.Tensor:
        """(H,W) per-pixel variance of the accumulated MEAN luminance:
        (E[l^2] - E[l]^2) / n."""
        n = max(self.accumulated_samples, 1)
        mean_l = self.accum[:, 0] * 0.2126 + self.accum[:, 1] * 0.7152 + self.accum[:, 2] * 0.0722
        v = torch.clamp(self.accum_lum2 - mean_l * mean_l, min=0.0) / n
        return v.reshape(self.height, self.width)
