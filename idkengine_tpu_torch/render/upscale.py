"""Temporal upscaler (TAAU), the FSR2 slot.
Counterpart: idkengine_tpu/render/upscale.py.

The reference hands colour, depth, velocity, jitter and camera to AMD's
FSR2 (ref: Source/Render/FSR2Wrapper.cs:37-71, RasterPipeline.cs:611-624).
Here, as in the JAX package, the frame graph renders at a reduced
resolution with a Halton jitter, and each low-resolution sample is
resolved into a full-resolution history at its true subpixel site, with
Catmull-Rom reprojection and the neighbourhood clamp of taa.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils import mathutil as mu
from .taa import _neighborhood_minmax, _sample_catmull_rom


@dataclass(frozen=True)
class UpscaleSettings:
    scale: int = 2  # render at (H/scale, W/scale), output (H, W)
    blend: float = 0.1  # history feedback (like TAA alpha)
    sharpen: float = 0.25  # RCAS-style post sharpen (ref: FSR2 sharpening)


def halton_jitter(frame: int) -> tuple[float, float]:
    """(2,3) Halton subpixel jitter, the sequence the reference feeds FSR2
    (ref: RasterPipeline TAA jitter + FSR2Wrapper jitter params)."""
    return mu.halton(frame % 16 + 1, 2) - 0.5, mu.halton(frame % 16 + 1, 3) - 0.5


def _taps(n: int, scale: int, shift: float, device):
    """High-res coordinates of n*scale pixels in a grid of n, their low-res
    floor and ceiling taps."""
    c = (torch.arange(n * scale, device=device) + 0.5) / scale - 0.5 - shift
    c0 = torch.clamp(torch.floor(c).long(), 0, n - 1)
    return c, c0, torch.clamp(c0 + 1, max=n - 1)


def upsample_bilinear(img, scale: int):
    h, w = img.shape[:2]
    yy, y0, y1 = _taps(h, scale, 0.0, img.device)
    xx, x0, x1 = _taps(w, scale, 0.0, img.device)
    fy = (yy - y0)[:, None, None]
    fx = (xx - x0)[None, :, None]
    c00 = img[y0][:, x0]
    c01 = img[y0][:, x1]
    c10 = img[y1][:, x0]
    c11 = img[y1][:, x1]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy


def upsample_jittered(img, scale: int, jx: float, jy: float):
    """Jitter-aware upsample: low-res sample (i,j) was rendered at the
    high-res position ((i+0.5+jy)*scale-0.5, (j+0.5+jx)*scale-0.5); sample
    the low-res grid at the shifted coordinates. Returns (hr_color,
    confidence), the confidence peaking where a pixel lands on a jittered
    sample."""
    h, w = img.shape[:2]
    yy, y0, y1 = _taps(h, scale, jy, img.device)
    xx, x0, x1 = _taps(w, scale, jx, img.device)
    fy = torch.clamp(yy - y0, 0.0, 1.0)[:, None, None]
    fx = torch.clamp(xx - x0, 0.0, 1.0)[None, :, None]
    c = (img[y0][:, x0] * (1 - fy) * (1 - fx)
         + img[y0][:, x1] * (1 - fy) * fx
         + img[y1][:, x0] * fy * (1 - fx)
         + img[y1][:, x1] * fy * fx)
    # distance (in high-res pixels) to the nearest low-res sample site
    dny = (torch.clamp((yy - torch.round(yy)).abs(), max=1.0) * scale)[:, None]
    dnx = (torch.clamp((xx - torch.round(xx)).abs(), max=1.0) * scale)[None, :]
    conf = torch.exp(-6.0 * (dny * dny + dnx * dnx))
    return c, conf


def taau_resolve(low_res_color, history, velocity_hr, jitter,
                 settings: UpscaleSettings = UpscaleSettings()):
    """One temporal-upscale step.

    low_res_color: (h, w, 3) current jittered frame; history: (H, W, 4)
    previous [rgb, accumulated weight] or None; velocity_hr: (H, W, 2)
    screen-space motion (pixels) at full res; jitter: (jx, jy) subpixel
    offset of this frame. Returns the new (H, W, 4) history; the image is
    history[..., :3].

    Each pixel accumulates a confidence-weighted average of the samples
    that land on it; motion decays the accumulated weight and engages the
    neighbourhood clamp."""
    s = settings.scale
    jx, jy = jitter
    hr, conf = upsample_jittered(low_res_color, s, float(jx), float(jy))
    if history is None:
        return torch.cat([hr, conf[..., None]], dim=-1)
    h, w = hr.shape[:2]
    dev = hr.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    hist4 = _sample_catmull_rom(history, yy - velocity_hr[..., 1], xx - velocity_hr[..., 0])
    hist = hist4[..., :3]
    wgt = torch.clamp(hist4[..., 3], min=0.0)
    speed = torch.linalg.vector_norm(velocity_hr, dim=-1)
    wgt = wgt * torch.exp(-speed)
    k = torch.clamp(speed / 2.0, 0.0, 1.0)[..., None]
    lo, hi = _neighborhood_minmax(hr)
    pad = (1.0 - conf[..., None]) * 0.15
    hist = hist * (1.0 - k) + torch.minimum(torch.maximum(hist, lo - pad), hi + pad) * k
    w_new = torch.clamp(wgt + conf, max=16.0 / max(settings.blend, 1e-3) * 0.25)
    out = ((hist * wgt[..., None] + hr * conf[..., None])
           / torch.clamp((wgt + conf)[..., None], min=1e-6))
    if settings.sharpen > 0:
        blur = (torch.roll(out, 1, 0) + torch.roll(out, -1, 0)
                + torch.roll(out, 1, 1) + torch.roll(out, -1, 1)) * 0.25
        out = out + (out - blur) * settings.sharpen
    return torch.cat([out, w_new[..., None]], dim=-1)
