"""Temporal anti-aliasing resolve (image space, tensors).
Counterpart: idkengine_tpu/render/taa.py.

Re-expression of the reference's TAA (ref: Source/Render/TAAResolve.cs +
Resource/Shaders/TAAResolve/compute.glsl:24-103): velocity dilation via
closest-depth 3x3, Catmull-Rom history sampling, neighborhood min/max
clamp, and the PreferAliasingOverBlur blend boost.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class TaaSettings:
    blend: float = 0.05  # new-frame weight (1/16 in many impls)
    prefer_aliasing_over_blur: bool = True  # ref: TAAResolve.cs toggle
    clamp_history: bool = True


def _shift2d(img, dy, dx):
    return torch.roll(img, (dy, dx), dims=(0, 1))


def _neighborhood_minmax(color):
    """3x3 min/max over (H,W,3)."""
    lo = color
    hi = color
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            s = _shift2d(color, dy, dx)
            lo = torch.minimum(lo, s)
            hi = torch.maximum(hi, s)
    return lo, hi


def _dilate_velocity(velocity, depth):
    """Use velocity of the closest-depth pixel in the 3x3 neighborhood
    (ref: TAAResolve/compute.glsl velocity dilation)."""
    best_d = depth
    best_v = velocity
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            d = _shift2d(depth, dy, dx)
            v = _shift2d(velocity, dy, dx)
            closer = d > best_d  # reverse-Z: larger depth = closer
            best_v = torch.where(closer[..., None], v, best_v)
            best_d = torch.maximum(best_d, d)
    return best_v


def _sample_catmull_rom(img, y, x):
    """Catmull-Rom resampling of (H,W,3) at fractional coords (H,W)."""
    h, w = img.shape[0], img.shape[1]

    def cr_weights(f):
        f2 = f * f
        f3 = f2 * f
        w0 = -0.5 * f3 + f2 - 0.5 * f
        w1 = 1.5 * f3 - 2.5 * f2 + 1.0
        w2 = -1.5 * f3 + 2.0 * f2 + 0.5 * f
        w3 = 0.5 * f3 - 0.5 * f2
        return w0, w1, w2, w3

    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy = cr_weights(y - y0)
    wx = cr_weights(x - x0)
    y0, x0 = y0.long(), x0.long()
    out = torch.zeros_like(img)
    for j in range(4):
        yy = torch.clamp(y0 + (j - 1), 0, h - 1)
        row_acc = torch.zeros_like(img)
        for i in range(4):
            xx = torch.clamp(x0 + (i - 1), 0, w - 1)
            row_acc = row_acc + img[yy, xx] * wx[i][..., None]
        out = out + row_acc * wy[j][..., None]
    return out


def taa_resolve(color, history, velocity, depth, settings: TaaSettings = TaaSettings()):
    """One TAA resolve step.

    color: (H,W,3) current frame; history: (H,W,3) previous resolve;
    velocity: (H,W,2) screen-space motion in pixels (prev - cur);
    depth: (H,W) reverse-Z depth. Returns the new resolved frame."""
    h, w = color.shape[0], color.shape[1]
    dev = color.device
    vel = _dilate_velocity(velocity, depth)
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + vel[..., 1]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + vel[..., 0]
    hist = _sample_catmull_rom(history, yy, xx)
    if settings.clamp_history:
        lo, hi = _neighborhood_minmax(color)
        hist = torch.minimum(torch.maximum(hist, lo), hi)
    blend = settings.blend
    if settings.prefer_aliasing_over_blur:
        # boost current-frame weight where velocity is high
        speed = torch.linalg.vector_norm(vel, dim=-1, keepdim=True)
        blend = torch.clamp(blend + speed * 0.01, settings.blend, 0.5)
    out = hist * (1.0 - blend) + color * blend
    # history off-screen: fall back to current color
    off = (yy < 0) | (yy > h - 1) | (xx < 0) | (xx > w - 1)
    return torch.where(off[..., None], color, out)


def mip_bias(render_w: int, display_w: int) -> float:
    """Recommended texture LOD bias under TAA upsampling
    (ref: TAAResolve.cs:76-80)."""
    return math.log2(render_w / display_w) - 0.5
