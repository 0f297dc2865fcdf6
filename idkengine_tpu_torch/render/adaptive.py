"""Adaptive sampling-rate classifier, the variable-rate-shading slot.
Counterpart: idkengine_tpu/render/adaptive.py.

The reference scores 16x16 tiles by mean speed and the luminance's
coefficient of variation and emits a shading-rate image (ref:
Source/Render/LightingShadingRateClassifier.cs + Resource/Shaders/
ShadingRateClassification/*.glsl). As in the JAX package, the same scores
drive the path tracer's per-tile bounce budget instead. The tile sums are
the JAX package's `lax.reduce_window` sums (VALID: edge tiles that do not
fill 16x16 are dropped), taken as one reshape-sum for the three quantities
at once. Its order of addition is not reduce_window's, and the variance
E[x^2] - E[x]^2 of a near-flat tile cancels most of its digits, so the
rate may differ from the JAX package's by about 1e-3 of itself
(tests/test_torch_passes.py holds it to 2e-3).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

TILE = 16  # ref: 16x16 shading-rate tiles


@dataclass(frozen=True)
class ClassifierSettings:
    speed_factor: float = 0.2  # ref: GpuSettings SpeedFactor
    lum_variance_factor: float = 0.025  # ref: LumVarianceFactor
    min_rate: float = 0.25
    max_rate: float = 4.0


def _tile_sums(x):
    """(H,W,C) -> (H//16, W//16, C) sums of the whole 16x16 tiles."""
    th, tw = x.shape[0] // TILE, x.shape[1] // TILE
    return x[:th * TILE, :tw * TILE].reshape(th, TILE, tw, TILE, x.shape[2]).sum((1, 3))


def classify(color, velocity, settings: ClassifierSettings = ClassifierSettings()):
    """(H,W,3) color + (H,W,2) velocity -> per-tile sampling rate
    (H//16, W//16) in [min_rate, max_rate]: up with the luminance's
    coefficient of variation (noise wants samples), down with speed (motion
    blur hides it)."""
    lum = 0.2126 * color[..., 0] + 0.7152 * color[..., 1] + 0.0722 * color[..., 2]
    n = TILE * TILE
    sums = _tile_sums(torch.stack([lum, lum * lum, torch.linalg.vector_norm(velocity, dim=-1)],
                                  dim=-1)) / n
    s1, s2, mean_speed = sums.unbind(-1)
    var = torch.clamp(s2 - s1 * s1, min=0.0)
    coeff_var = torch.sqrt(var) / torch.clamp(s1, min=1e-4)
    rate = 1.0 + coeff_var / max(settings.lum_variance_factor, 1e-6) * 0.5
    rate = rate / (1.0 + mean_speed * settings.speed_factor)
    return torch.clamp(rate, settings.min_rate, settings.max_rate)


def sample_budget(rate, spp_base: int = 1):
    """Per-tile integer sample counts from the rate map."""
    return torch.clamp(torch.round(rate * spp_base), min=1.0).to(torch.int32)


def bounce_budget(rate, ray_depth: int, width: int, height: int) -> torch.Tensor:
    """The path tracer's per-pixel bounce budget from a tile rate map:
    round(ray_depth * rate) in [1, ray_depth] per tile, spread over its
    pixels; the edge tiles the classifier dropped keep the full depth.
    (H*W,) int32 in pixel order."""
    depth = torch.clamp(torch.round(ray_depth * rate), 1, ray_depth).to(torch.int32)
    dm = depth.repeat_interleave(TILE, 0).repeat_interleave(TILE, 1)
    full = torch.full((height, width), ray_depth, dtype=torch.int32, device=rate.device)
    full[:dm.shape[0], :dm.shape[1]] = dm[:height, :width]
    return full.reshape(-1)
