"""Volumetric light: ray-marched per-light scattering + depth-aware upsample.
Counterpart: idkengine_tpu/render/volumetric.py.

Re-expression of the reference's volumetric light pass (ref:
Source/Render/VolumetricLighting.cs + Resource/Shaders/VolumetricLight/
{compute,Upscale/compute}.glsl): march the view ray at a reduced
resolution, accumulate Henyey–Greenstein-phased in-scattering with
absorbance, then upsample with depth-aware weights.

The occlusion test runs at every march sample toward every light, as the
reference's compute.glsl:79 does. The JAX package makes one any-hit trace
per sample and light; each ray is independent of the others, so here all
samples and lights go to the trace in one call (one kernel launch on the
card), and the answers are accumulated in the JAX package's order.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

_PI = 3.141592653589793


@dataclass(frozen=True)
class VolumetricSettings:
    samples: int = 16
    scattering: float = 0.03
    absorbance: float = 0.02
    phase_g: float = 0.3  # HG anisotropy
    downscale: int = 2


def _hg_phase(cos_t, g):
    return (1.0 - g * g) / torch.clamp(
        4.0 * _PI * torch.pow(1.0 + g * g - 2.0 * g * cos_t, 1.5), min=1e-6)


def volumetric_light(gbuf_position, gbuf_depth, cam_origin, lights_pos, lights_radiance,
                     n_lights: int, occlusion_fn=None,
                     settings: VolumetricSettings = VolumetricSettings()):
    """(H,W,3) in-scattered light along each view ray.

    occlusion_fn(o, d, t_max) -> bool occluded, evaluated at every march
    sample toward each light, or None for unshadowed."""
    h, w = gbuf_position.shape[:2]
    s = settings
    ds = s.downscale
    dev = gbuf_position.device
    cam_origin = torch.as_tensor(cam_origin, dtype=torch.float32, device=dev)
    pos = gbuf_position[::ds, ::ds]
    depth = torch.clamp(gbuf_depth[::ds, ::ds], max=200.0)
    hh, ww = pos.shape[:2]

    view = pos - cam_origin
    dist = torch.clamp(torch.linalg.vector_norm(view, dim=-1), min=1e-6)
    vdir = view / dist[..., None]
    seg = depth / s.samples

    # every sample point and its direction toward every light, (S, L, hh, ww)
    p = torch.stack([cam_origin + vdir * ((i + 0.5) * seg)[..., None]
                     for i in range(s.samples)])
    to_l = torch.stack([lights_pos[li] - p for li in range(n_lights)], dim=1)
    d2 = torch.clamp((to_l * to_l).sum(-1), min=1e-4)
    ldir = to_l / torch.sqrt(d2)[..., None]
    vis = None
    if occlusion_fn is not None and n_lights > 0:
        o = p[:, None].expand(-1, n_lights, -1, -1, -1).reshape(-1, 3).contiguous()
        occ = occlusion_fn(o, ldir.reshape(-1, 3).contiguous(),
                           (torch.sqrt(d2) - 1e-3).reshape(-1).contiguous())
        vis = 1.0 - occ.reshape(d2.shape).to(torch.float32)

    out = torch.zeros((hh, ww, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((hh, ww, 1), dtype=torch.float32, device=dev)
    for i in range(s.samples):
        for li in range(n_lights):
            cos_t = (vdir * ldir[i, li]).sum(-1)
            phase = _hg_phase(cos_t, s.phase_g)
            v = 1.0 if vis is None else vis[i, li]
            contrib = lights_radiance[li] * (phase * s.scattering * v / d2[i, li])[..., None]
            out = out + trans * contrib * seg[..., None]
        trans = trans * torch.exp(-(s.absorbance + s.scattering) * seg)[..., None]

    return depth_aware_upsample(out, depth, torch.clamp(gbuf_depth, max=200.0), ds)[:h, :w]


def depth_aware_upsample(low, low_depth, full_depth, ds: int):
    """Joint-bilateral upsample (ref: VolumetricLight/Upscale/compute.glsl):
    each full-res pixel blends the 4 surrounding low-res taps with bilinear
    weights scaled by depth similarity, so god rays don't bleed across
    silhouettes; plain bilinear where all taps mismatch."""
    hh, ww = low.shape[:2]
    h, w = full_depth.shape[:2]
    dev = low.device
    yy = torch.arange(h, dtype=torch.float32, device=dev) / ds
    xx = torch.arange(w, dtype=torch.float32, device=dev) / ds
    y0 = torch.clamp(torch.floor(yy).long(), 0, hh - 1)
    x0 = torch.clamp(torch.floor(xx).long(), 0, ww - 1)
    y1 = torch.clamp(y0 + 1, max=hh - 1)
    x1 = torch.clamp(x0 + 1, max=ww - 1)
    fy = torch.clamp(yy - y0, 0.0, 1.0)[:, None]
    fx = torch.clamp(xx - x0, 0.0, 1.0)[None, :]
    wb = [(1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx]
    taps = [(y0, x0), (y0, x1), (y1, x0), (y1, x1)]
    num = torch.zeros((h, w, low.shape[2]), dtype=low.dtype, device=dev)
    den = torch.zeros((h, w), dtype=low.dtype, device=dev)
    num_b = torch.zeros_like(num)
    den_b = torch.zeros_like(den)
    for (ty, tx), bw in zip(taps, wb):
        d_lr = low_depth[ty][:, tx]
        sim = torch.exp(-(d_lr - full_depth).abs()
                        / torch.clamp(0.05 * full_depth, min=1e-3))
        wgt = bw * sim
        c = low[ty][:, tx]
        num = num + c * wgt[..., None]
        den = den + wgt
        num_b = num_b + c * bw[..., None]
        den_b = den_b + bw
    bilateral = num / torch.clamp(den[..., None], min=1e-6)
    bilinear = num_b / torch.clamp(den_b[..., None], min=1e-6)
    return torch.where((den > 1e-3)[..., None], bilateral, bilinear)
