"""Bloom: threshold + downsample mip chain, then upsample-accumulate.
Counterpart: idkengine_tpu/render/bloom.py.

Re-expression of the reference's CoD-MW-style bloom
(ref: Source/Render/Bloom.cs:56-110 + Resource/Shaders/Bloom/compute.glsl):
a downsample chain with a 13-tap filter approximated here by a separable
box+tent, then an additive upsample chain.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class BloomSettings:
    threshold: float = 1.0
    max_color: float = 20.0  # clamp against fireflies (ref: Bloom MaxColor)
    strength: float = 0.15
    levels: int = 5


def _downsample2x(img):
    h, w = img.shape[0] & ~1, img.shape[1] & ~1
    x = img[:h, :w]
    return 0.25 * (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2] + x[1::2, 1::2])


def _tent_blur(img):
    """3x3 tent filter (wrapping at the borders)."""
    k = [1.0, 2.0, 1.0]
    out = torch.zeros_like(img)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out = out + torch.roll(img, (dy, dx), (0, 1)) * (k[dy + 1] * k[dx + 1] / 16.0)
    return out


def _upsample2x(img, target_hw):
    """Nearest 2x upsample cropped, or edge-padded, to target_hw, then tent."""
    h, w = target_hw
    dev = img.device
    rows = torch.clamp(torch.arange(h, device=dev) // 2, max=img.shape[0] - 1)
    cols = torch.clamp(torch.arange(w, device=dev) // 2, max=img.shape[1] - 1)
    return _tent_blur(img[rows][:, cols])


def bloom(hdr, settings: BloomSettings = BloomSettings()):
    """(H,W,3) HDR → (H,W,3) bloom contribution (add to scene color)."""
    x = torch.clamp(hdr, max=settings.max_color)
    luma_w = torch.tensor([0.2126, 0.7152, 0.0722], device=hdr.device)
    luma = (x * luma_w).sum(-1, keepdim=True)
    soft = torch.clamp(luma - settings.threshold, min=0.0)
    x = x * (soft / torch.clamp(luma, min=1e-4))

    # downsample chain
    mips = [x]
    for _ in range(settings.levels):
        if min(mips[-1].shape[0], mips[-1].shape[1]) < 4:
            break
        mips.append(_tent_blur(_downsample2x(mips[-1])))

    # upsample-accumulate chain (ref: Bloom.cs upsample pass)
    acc = mips[-1]
    for i in range(len(mips) - 2, -1, -1):
        acc = mips[i] + _upsample2x(acc, mips[i].shape[:2])
    return acc * (settings.strength / max(len(mips), 1))
