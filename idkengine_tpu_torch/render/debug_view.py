"""Debug visualizations: BVH traversal-cost heatmap + selection box overlay.
Counterpart: idkengine_tpu/render/debug_view.py (`turbo`,
`traversal_cost_image`, `draw_box_overlay`).

ref: the reference's Turbo-colormap BVH-cost view (FinalDraw/compute.glsl:
32-37 with BVHIntersect debug counters) and the wireframe box renderer used
for entity selection (Source/Render/BoxRenderer.cs).

The heatmap counts per-ray steps of the stackless walk
(`ops.packet_trace.trace_closest_steps`: the steps kernel on the card, the
plain trace on the CPU), the JAX package's per-ray contract. Rays are made
and the heatmap returned in pixel order. The JAX function makes its rays in
tile-swizzle order on that path and never un-permutes the counts, which
scrambles its heatmap above 64x64; that fault is not copied.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.packet_trace import trace_closest_steps
from .camera import generate_rays

# Polynomial fit of the Turbo colormap (Google AI blog, public domain).
_TURBO_R = np.array([0.13572138, 4.61539260, -42.66032258, 132.13108234,
                     -152.94239396, 59.28637943])
_TURBO_G = np.array([0.09140261, 2.19418839, 4.84296658, -14.18503333,
                     4.27729857, 2.82956604])
_TURBO_B = np.array([0.10667330, 12.64194608, -60.58204836, 110.36276771,
                     -89.90310912, 27.34824973])


def turbo(x: torch.Tensor) -> torch.Tensor:
    """x in [0,1] -> (...,3) Turbo colormap (float32)."""
    x = torch.clamp(torch.as_tensor(x, dtype=torch.float32), 0.0, 1.0)
    pows = torch.stack([x ** i for i in range(6)], dim=-1)
    coef = torch.tensor(np.stack([_TURBO_R, _TURBO_G, _TURBO_B], axis=1), dtype=torch.float32,
                        device=x.device)  # (6, 3)
    return torch.clamp(pows @ coef, 0.0, 1.0)


def traversal_cost_image(pt, camera, max_cost: float = 256.0) -> torch.Tensor:
    """(H,W,3) Turbo heatmap of per-ray BVH traversal steps for the camera's
    primary rays (no subpixel jitter), on the path tracer's scene and device
    (ref: DoDebugBVHTraversal path)."""
    w, h = pt.width, pt.height
    r = w * h
    o, d = generate_rays(camera.ray_params(w, h), w, h, torch.zeros((r, 2), device=pt.device))
    tm = torch.full((r,), 3.4e38, device=pt.device)
    _, steps = trace_closest_steps(pt.scene, o, d, tm)
    return turbo(steps.float() / max_cost).reshape(h, w, 3)


def draw_box_overlay(image, camera, box_min, box_max, color=(1.0, 0.8, 0.1),
                     thickness: int = 1) -> np.ndarray:
    """Rasterize a wireframe AABB over a rendered (H,W,3) image (numpy
    copy), the entity-selection overlay (ref: BoxRenderer wireframe pass)."""
    if isinstance(image, torch.Tensor):
        image = image.cpu().numpy()
    img = np.asarray(image).copy()
    h, w = img.shape[:2]
    params = camera.ray_params(w, h)
    eye = np.asarray(params["origin"], np.float64)
    fwd = np.asarray(params["forward"], np.float64)
    right = np.asarray(params["right"], np.float64)
    up = np.asarray(params["up"], np.float64)
    lo = np.asarray(box_min, np.float64)
    hi = np.asarray(box_max, np.float64)
    corners = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                        [lo[0], hi[1], lo[2]], [hi[0], hi[1], lo[2]],
                        [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                        [lo[0], hi[1], hi[2]], [hi[0], hi[1], hi[2]]])
    edges = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
             (0, 4), (1, 5), (2, 6), (3, 7)]

    def project(p):
        v = p - eye
        z = v @ fwd
        if z <= 1e-6:
            return None
        # generate_rays convention: d = fwd + u*right + v*up per pixel
        u = (v @ right) / (right @ right) / z
        vv = (v @ up) / (up @ up) / z
        return (u + 1.0) * 0.5 * w, (1.0 - (vv + 1.0) * 0.5) * h

    col = np.asarray(color, img.dtype)
    for a, b in edges:
        pa, pb = project(corners[a]), project(corners[b])
        if pa is None or pb is None:
            continue
        n = int(max(abs(pb[0] - pa[0]), abs(pb[1] - pa[1]), 1)) * 2
        ts = np.linspace(0.0, 1.0, n)
        xs = np.clip((pa[0] + (pb[0] - pa[0]) * ts).astype(int), 0, w - 1)
        ys = np.clip((pa[1] + (pb[1] - pa[1]) * ts).astype(int), 0, h - 1)
        for t in range(-(thickness // 2), thickness // 2 + 1):
            img[np.clip(ys + t, 0, h - 1), xs] = col
            img[ys, np.clip(xs + t, 0, w - 1)] = col
    return img
