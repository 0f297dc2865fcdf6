"""G-buffer generation via primary rays.
Counterpart: idkengine_tpu/render/gbuffer.py.

Primary visibility is a ray cast through the trace entry points (the CUDA
traversal kernel on the card, the plain trace on the CPU) in place of the
reference's rasterized G-buffer fill (ref: Source/Render/RasterPipeline.cs:
364-414). The output layout matches the reference's attachments (ref:
RasterPipeline.cs:646-686: albedo, normal, metallic/roughness, emissive,
velocity, depth).

Materials are the factors times the texture atlas (base colour,
metal-roughness, emissive), sampled trilinearly at a ray-cone LOD, then
the per-mesh shading biases (`slot_shading`). A scene without any texture
skips the atlas (no `slot_uv_density`): its lookup returns ones, so the
image is the same.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.compression import decompress_normal
from .camera import generate_rays
from .pathtracer import sample_atlas


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
                   slot_shading=None, slot_uv_density=None):
    """One G-buffer pass. trace_fn(o, d, t_max) -> Hit; mats: dict of
    material tensors on the scene's device (factors, layer indices, atlas);
    jitter (2,) subpixel (TAA Halton jitter, ref: RasterPipeline.cs:266-299);
    mip_bias: texture LOD bias (ref: TAAResolve.cs:76-80); slot_shading:
    optional (n_slots, 10) per-mesh override rows (MeshShading.row order),
    whose emissive, specular and roughness biases apply as the raster
    G-buffer applies them (ref: GBuffer/fragment.glsl + Surface.glsl:85-96);
    slot_uv_density: the scene's per-slot UV density (pathtracer.uv_density)
    when any material has a texture, else None (factors only)."""
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
    if slot_uv_density is not None:
        # ray-cone texture LOD: the pixel footprint at the hit distance in
        # texels, through the triangle's UV density, trilinear across mips
        uv3 = scene.tri_uv[slot]
        uv = uv3[:, 0] * w_b[..., None] + uv3[:, 1] * u[..., None] + uv3[:, 2] * v[..., None]
        up = torch.as_tensor(cam_params["up"], dtype=torch.float32, device=dev)
        cone0 = 2.0 * torch.linalg.vector_norm(up) / height
        atlas = mats["atlas"]
        texel = hit.t * cone0 * slot_uv_density[slot] * float(atlas.shape[1])
        lod = torch.log2(torch.clamp(texel, min=1.0)) + mip_bias
        tex = [sample_atlas(atlas, mats[k][mat_id], uv, lod)
               for k in ("base_layer", "mr_layer", "emissive_layer")]
        albedo = albedo * tex[0][..., :3]
        metallic = metallic * tex[1][..., 2]
        roughness = roughness * tex[1][..., 1]
        emissive = emissive * tex[2][..., :3]
    if slot_shading is not None:
        sh = torch.as_tensor(slot_shading, dtype=torch.float32, device=dev)[slot]  # (R,10)
        emissive = emissive + sh[:, 0:1] * albedo
        metallic = torch.clamp(metallic + sh[:, 2], 0.0, 1.0)
        roughness = torch.clamp(roughness + sh[:, 3], 0.0, 1.0)

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
