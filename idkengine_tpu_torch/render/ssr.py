"""Screen-space reflections (image space).
Counterpart: idkengine_tpu/render/ssr.py.

Re-expression of the reference's SSR (ref: Source/Render/SSR.cs +
Resource/Shaders/SSR/compute.glsl:55-95): a reflected-ray march through the
depth buffer, a binary-search refinement of the crossing interval
(compute.glsl:83-95), and a sky fallback on a miss (compute.glsl:79-81).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .gbuffer import _cam_vectors, _screen_xy


@dataclass(frozen=True)
class SsrSettings:
    samples: int = 24  # ray-march steps
    binary_steps: int = 5  # refinement bisections of the crossing interval
    max_distance: float = 50.0
    # gradient sky used when the march leaves the screen / finds nothing
    # (the reference samples its skybox cubemap on a miss)
    sky_zenith: tuple = (0.25, 0.45, 0.85)
    sky_horizon: tuple = (0.55, 0.65, 0.80)
    sky_strength: float = 1.0


def _sky_gradient(d, s: SsrSettings):
    t = torch.clamp(d[..., 1] * 0.5 + 0.5, 0.0, 1.0)[..., None]
    zen = torch.tensor(s.sky_zenith, dtype=torch.float32, device=d.device)
    hor = torch.tensor(s.sky_horizon, dtype=torch.float32, device=d.device)
    return (hor * (1.0 - t) + zen * t) * s.sky_strength


def ssr(color, gbuf_position, gbuf_normal, gbuf_depth, cam,
        settings: SsrSettings = SsrSettings(), use_sky: bool = True):
    """Returns (refl_color (H,W,3), hit (H,W) bool, refined_t (H,W)).

    On a miss refl_color falls back to the gradient sky along the reflected
    direction when use_sky (hit stays False). cam: the camera's ray-params
    dict (origin/forward/right/up), which projects marched points to the
    screen."""
    h, w = color.shape[:2]
    dev = color.device
    origin = _cam_vectors(cam, dev)["origin"]
    pos = gbuf_position
    n = gbuf_normal
    view = pos - origin
    view = view / torch.clamp(torch.linalg.vector_norm(view, dim=-1, keepdim=True), min=1e-8)
    refl = view - 2.0 * (view * n).sum(-1, keepdim=True) * n

    def below_surface(t):
        """At parameter t: (crossed behind geometry, near it, pixel x, y)."""
        p = pos + refl * t[..., None]
        px, py = _screen_xy(p.reshape(-1, 3), cam, w, h)
        px = px.reshape(h, w)
        py = py.reshape(h, w)
        inside = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        # truncation toward zero, as the JAX package's astype(int32)
        xi = torch.clamp(px.to(torch.int32), 0, w - 1).long()
        yi = torch.clamp(py.to(torch.int32), 0, h - 1).long()
        scene_t = gbuf_depth[yi, xi]
        ray_t = torch.linalg.vector_norm(p - origin, dim=-1)
        behind = inside & (ray_t > scene_t + 1e-3)
        near = ray_t < scene_t * 1.2  # reject crossings far behind geometry
        return behind, near, xi, yi

    step = settings.max_distance / settings.samples
    hit_ok = torch.zeros((h, w), dtype=torch.bool, device=dev)
    t_lo = torch.zeros((h, w), dtype=torch.float32, device=dev)  # last t in front
    t_hi = torch.full((h, w), step, dtype=torch.float32, device=dev)  # first t behind
    t = torch.full((h, w), step, dtype=torch.float32, device=dev)
    for _ in range(settings.samples):
        behind, near, _, _ = below_surface(t)
        newly = behind & near & ~hit_ok
        t_hi = torch.where(newly, t, t_hi)
        t_lo = torch.where(newly, t - step, t_lo)
        hit_ok = hit_ok | newly
        t = t + step

    # binary-search refinement of [t_lo, t_hi] (ref: SSR/compute.glsl:83-95)
    for _ in range(settings.binary_steps):
        tm = 0.5 * (t_lo + t_hi)
        behind, _, _, _ = below_surface(tm)
        t_hi = torch.where(behind, tm, t_hi)
        t_lo = torch.where(behind, t_lo, tm)

    t_ref = 0.5 * (t_lo + t_hi)
    _, _, xi, yi = below_surface(torch.where(hit_ok, t_ref, t_hi))
    hit_col = color[yi, xi]
    fallback = _sky_gradient(refl, settings) if use_sky else torch.zeros_like(hit_col)
    hit_col = torch.where(hit_ok[..., None], hit_col, fallback)
    return hit_col, hit_ok, torch.where(hit_ok, t_ref, torch.inf)
