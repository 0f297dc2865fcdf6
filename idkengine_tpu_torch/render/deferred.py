"""Deferred lighting + ray-traced shadows over the G-buffer.
Counterpart: idkengine_tpu/render/deferred.py.

Re-expression of the reference's deferred shading pass (ref: Resource/
Shaders/DeferredLighting/fragment.glsl:50-92 + include/Impl.glsl:5-63 —
per-light GGX + attenuation) and the RT-shadows kernel (ref:
ShadowsRayTraced/compute.glsl:49-125). Shadow rays go through the trace
entry points given as `occlusion_fn`; the PCF mode reads point-light cube
maps through `pcf_fn` (render/shadowmap.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..profiling import count_shadow_rays
from ..utils import rng as rng_mod
from . import sampling, shading

_PI = 3.141592653589793


@dataclass(frozen=True)
class DeferredSettings:
    shadow_mode: str = "ray_traced"  # none | pcf | ray_traced (ref modes)
    shadow_samples: int = 1
    ambient: float = 0.03  # flat ambient when VXGI is off (ref: Impl.glsl)


def _light_visibility(pos, n, l_pos, l_r, dist, occlusion_fn, state, settings, surface=None):
    """Mean unoccluded share of `shadow_samples` rays toward a sphere light;
    with `surface` (the G-buffer's mask), the rays are counted under a
    profiler (profiling.count_shadow_rays)."""
    acc = torch.zeros(pos.shape[0], dtype=torch.float32, device=pos.device)
    for _ in range(settings.shadow_samples):
        state, u = rng_mod.uniform2(state)
        sdir, _, _ = sampling.sphere_light_sample(pos, l_pos, l_r, u)
        t_max = dist - l_r - 1e-3
        if surface is not None:
            count_shadow_rays(t_max, surface)
        occ = occlusion_fn(pos + n * 1e-3, sdir, t_max)
        acc = acc + 1.0 - occ.to(torch.float32)
    return acc / settings.shadow_samples, state


def shade_points(pos, n, alb, met, rough, cam_origin, lights, n_lights: int,
                 occlusion_fn, settings: DeferredSettings = DeferredSettings(),
                 frame=0, state=None):
    """Per-light GGX direct lighting (+ flat ambient) for arbitrary flat
    (R,3) points — the per-light loop shared by the deferred pass and the
    transparent layers (ref: RecordTransparent/fragment.glsl:77-93).
    occlusion_fn(o, d, t_max) -> occluded, or None."""
    r = pos.shape[0]
    view = torch.as_tensor(cam_origin, dtype=torch.float32, device=pos.device) - pos
    view = view / torch.clamp(torch.linalg.vector_norm(view, dim=-1, keepdim=True), min=1e-8)
    if state is None:
        state = rng_mod.init_state(torch.arange(r, device=pos.device), frame)
    out = torch.zeros((r, 3), dtype=torch.float32, device=pos.device)
    for li in range(n_lights):
        l_pos = lights["pos"][li]
        l_rad = lights["radiance"][li]
        l_r = lights["radius"][li]
        to_l = l_pos - pos
        dist = torch.linalg.vector_norm(to_l, dim=-1)
        ldir = to_l / torch.clamp(dist, min=1e-8)[..., None]
        vis = torch.ones(r, dtype=torch.float32, device=pos.device)
        if occlusion_fn is not None:
            vis, state = _light_visibility(pos, n, l_pos, l_r, dist, occlusion_fn, state,
                                           settings)
        brdf_cos = shading.ggx_brdf(n, view, ldir, alb, met, rough)
        att = _PI * l_r * l_r / torch.clamp(dist * dist, min=1e-4)
        out = out + brdf_cos * l_rad * (att * vis)[..., None]
    return out + settings.ambient * alb


def shade_deferred(gbuf, lights, n_lights: int, cam_origin, occlusion_fn,
                   settings: DeferredSettings = DeferredSettings(),
                   gi: torch.Tensor | None = None, ao: torch.Tensor | None = None,
                   frame=0, pcf_fn=None):
    """Direct lighting for every G-buffer pixel.

    occlusion_fn(o, d, t_max) -> bool occluded, or None for unshadowed;
    pcf_fn(light_index, points) -> visibility in [0,1] for shadow_mode
    "pcf" (cube shadow maps, render/shadowmap.py);
    gi: optional (H,W,3) cone-traced indirect; ao: optional (H,W) SSAO.
    One loop over the lights serves every mode: the JAX package's scan over
    many unshadowed lights adds the same per-light terms in the same order."""
    h, w = gbuf.albedo.shape[:2]
    r = h * w
    dev = gbuf.albedo.device
    pos = gbuf.position.reshape(r, 3)
    n = gbuf.normal.reshape(r, 3)
    alb = gbuf.albedo.reshape(r, 3)
    met = gbuf.metallic.reshape(r)
    rough = gbuf.roughness.reshape(r)
    mask = gbuf.mask.reshape(r)

    view = torch.as_tensor(cam_origin, dtype=torch.float32, device=dev) - pos
    view = view / torch.clamp(torch.linalg.vector_norm(view, dim=-1, keepdim=True), min=1e-8)

    state = rng_mod.init_state(torch.arange(r, device=dev), frame)
    out = gbuf.emissive.reshape(r, 3)
    pcf = settings.shadow_mode == "pcf" and pcf_fn is not None
    shadowed = settings.shadow_mode == "ray_traced" and occlusion_fn is not None
    for li in range(n_lights):
        l_pos = lights["pos"][li]
        l_rad = lights["radiance"][li]
        l_r = lights["radius"][li]
        to_l = l_pos - pos
        dist = torch.linalg.vector_norm(to_l, dim=-1)
        ldir = to_l / torch.clamp(dist, min=1e-8)[..., None]
        vis = torch.ones(r, dtype=torch.float32, device=dev)
        if pcf:
            vis = pcf_fn(li, pos)
        elif shadowed:
            vis, state = _light_visibility(pos, n, l_pos, l_r, dist, occlusion_fn, state,
                                           settings, surface=mask)
        brdf_cos = shading.ggx_brdf(n, view, ldir, alb, met, rough)
        # sphere-light irradiance ~ L_e * pi R^2 / d^2 (consistent with the
        # path tracer's area-emitter radiance convention)
        att = _PI * l_r * l_r / torch.clamp(dist * dist, min=1e-4)
        out = out + brdf_cos * l_rad * (att * vis)[..., None]

    # indirect: VXGI cone-traced GI or flat ambient (ref: Impl.glsl indirect)
    ao_f = 1.0 - ao.reshape(r) if ao is not None else torch.ones(r, device=dev)
    if gi is not None:
        out = out + gi.reshape(r, 3) * alb * ao_f[..., None]
    else:
        out = out + settings.ambient * alb * ao_f[..., None]

    out = torch.where(mask[..., None], out, 0.0)
    return out.reshape(h, w, 3)
