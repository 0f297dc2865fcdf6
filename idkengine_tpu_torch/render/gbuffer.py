"""G-buffer generation via primary rays.
Counterpart: idkengine_tpu/render/gbuffer.py.

Primary visibility is a ray cast through the trace entry points (the CUDA
traversal kernel on the card, the plain trace on the CPU) in place of the
reference's rasterized G-buffer fill (ref: Source/Render/RasterPipeline.cs:
364-414). The output layout matches the reference's attachments (ref:
RasterPipeline.cs:646-686: albedo, normal, metallic/roughness, emissive,
velocity, depth).

Materials are factor-only, as the port's MaterialTable holds them: the JAX
package's atlas lookup returns ones for a material without a texture layer,
so the factors are the result and the texture LOD is not computed. Per-mesh
shading overrides (`slot_shading`) are not ported and raise.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.compression import decompress_normal
from .camera import generate_rays


class GBuffer(NamedTuple):
    albedo: torch.Tensor  # (H,W,3)
    normal: torch.Tensor  # (H,W,3) world-space
    metallic: torch.Tensor  # (H,W)
    roughness: torch.Tensor  # (H,W)
    emissive: torch.Tensor  # (H,W,3)
    depth: torch.Tensor  # (H,W) ray t (inf = sky)
    position: torch.Tensor  # (H,W,3) world-space hit points
    velocity: torch.Tensor  # (H,W,2) screen-space motion (pixels)
    mask: torch.Tensor  # (H,W) bool hit


def _cam_vectors(cam: dict, device) -> dict:
    return {k: torch.as_tensor(cam[k], dtype=torch.float32, device=device)
            for k in ("origin", "forward", "right", "up")}


def render_gbuffer(trace_fn, scene, mats, cam_params, prev_cam_params,
                   width: int, height: int, jitter=None, mip_bias: float = 0.0,
                   slot_shading=None):
    """One G-buffer pass. trace_fn(o, d, t_max) -> Hit; mats: dict of
    material tensors on the scene's device (factor-only); jitter (2,)
    subpixel (TAA Halton jitter, ref: RasterPipeline.cs:266-299); mip_bias:
    texture LOD bias, without effect on factor-only materials."""
    if slot_shading is not None:
        raise NotImplementedError("render_gbuffer(slot_shading=...) is not ported")
    dev = scene.device
    r = width * height
    jit = torch.zeros(2, device=dev) + (
        torch.as_tensor(jitter, dtype=torch.float32, device=dev) if jitter is not None else 0.5)
    o, d = generate_rays(cam_params, width, height, jit.expand(r, 2))
    hit = trace_fn(o, d, torch.full((r,), 3.4e38, device=dev))

    slot = torch.clamp(hit.slot, min=0).long()
    mask = hit.slot >= 0
    u, v = hit.u, hit.v
    w_b = 1.0 - u - v
    n_c = decompress_normal(scene.tri_n[slot])  # (R,3 corners,3)
    ns = n_c[:, 0] * w_b[..., None] + n_c[:, 1] * u[..., None] + n_c[:, 2] * v[..., None]
    ns = ns / torch.clamp(torch.linalg.vector_norm(ns, dim=-1, keepdim=True), min=1e-12)
    gn = scene.tri_gn[slot]
    flip = (gn * d).sum(-1) > 0.0
    ns = torch.where(flip[..., None], -ns, ns)

    mat_id = scene.tri_mat[slot].long()
    albedo = mats["base_color"][mat_id][..., :3]
    metallic = mats["metallic"][mat_id]
    roughness = mats["roughness"][mat_id]
    emissive = mats["emissive"][mat_id]

    pos = o + d * torch.clamp(hit.t, max=1e8)[..., None]

    # velocity: reproject hit into the previous camera (static scene motion
    # comes entirely from the camera; per-object motion needs prev transforms)
    vel = _reproject_velocity(pos, cam_params, prev_cam_params, width, height)

    def img(a):
        return a.reshape(height, width)

    def img3(a):
        return a.reshape(height, width, 3)

    m3 = mask[..., None]
    return GBuffer(
        albedo=img3(torch.where(m3, albedo, 0.0)),
        normal=img3(torch.where(m3, ns, 0.0)),
        metallic=img(torch.where(mask, metallic, 0.0)),
        roughness=img(torch.where(mask, roughness, 1.0)),
        emissive=img3(torch.where(m3, emissive, 0.0)),
        depth=img(torch.where(mask, hit.t, torch.inf)),
        position=img3(pos),
        velocity=vel.reshape(height, width, 2),
        mask=img(mask),
    )


def _screen_xy(p, cam, width, height):
    """Project world point into pixel coords for a camera param dict."""
    c = _cam_vectors(cam, p.device)
    rel = p - c["origin"]
    r_ax, u_ax = c["right"], c["up"]
    z = (rel * c["forward"]).sum(-1)
    # right/up carry tan(fov)*aspect scaling already
    x_ndc = (rel * r_ax).sum(-1) / torch.clamp((r_ax * r_ax).sum(-1), min=1e-12)
    y_ndc = (rel * u_ax).sum(-1) / torch.clamp((u_ax * u_ax).sum(-1), min=1e-12)
    x_ndc = x_ndc / torch.clamp(z, min=1e-6)
    y_ndc = y_ndc / torch.clamp(z, min=1e-6)
    px = (x_ndc * 0.5 + 0.5) * width
    py = (0.5 - y_ndc * 0.5) * height
    return px, py


def _reproject_velocity(pos, cam, prev_cam, width, height):
    """Per-pixel motion vector = prev screen pos − current screen pos
    (ref: GBuffer velocity from prev positions)."""
    cx, cy = _screen_xy(pos, cam, width, height)
    px, py = _screen_xy(pos, prev_cam, width, height)
    return torch.stack([px - cx, py - cy], dim=-1)
