"""Environment-map importance sampling via alias tables.
Counterpart: idkengine_tpu/render/envsample.py.

Role: NEE toward bright HDR environment texels (sun disks in equirect
skies). The reference only evaluates its skybox on ray miss; pure BSDF
sampling never converges on a small bright sun, so this extension is
exposed as PathTracerSettings.env_nee.

The alias table (Vose 1991) is built on the host in numpy, once per map;
the device holds three flat tensors (prob, alias, pmf) and a draw is one
row pick, one compare and one select. The pdf is in solid-angle measure,
and texel -> direction follows the equirect convention of the path
tracer's sky lookup (x: phi, y: theta).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def build_alias(weights: np.ndarray):
    """Vose alias-table construction. weights (N,) >= 0, not all zero.
    Returns (prob (N,) f32, alias (N,) i32, pmf (N,) f32)."""
    w = np.asarray(weights, np.float64).ravel()
    n = w.size
    total = w.sum()
    if not np.isfinite(total) or total <= 0.0:
        w = np.ones_like(w)
        total = float(n)
    pmf = w / total
    scaled = pmf * n
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    # leftovers are exactly 1 up to float error
    return prob.astype(np.float32), alias, pmf.astype(np.float32)


class EnvSampler:
    """Per-texel alias sampler over an equirect (H,W,3) radiance map; its
    tables live on `device` (the card unless asked for the CPU)."""

    def __init__(self, env_map: np.ndarray, *, device="cuda"):
        env = np.asarray(env_map, np.float32)
        h, w = env.shape[0], env.shape[1]
        lum = (0.2126 * env[..., 0] + 0.7152 * env[..., 1]
               + 0.0722 * env[..., 2])
        # texel solid angle shrinks with sin(theta): weight it in so the
        # pmf is proportional to texel POWER, and pdf converts back
        theta_c = (np.arange(h, dtype=np.float64) + 0.5) / h * np.pi
        sin_t = np.maximum(np.sin(theta_c), 1e-6)[:, None]
        prob, alias, pmf = build_alias(np.maximum(lum, 0.0) * sin_t)
        self.h, self.w = h, w
        dev = torch.device(device)
        self.tables = {
            "prob": torch.from_numpy(prob).to(dev),
            "alias": torch.from_numpy(alias).to(dev),
            "pmf": torch.from_numpy(pmf).to(dev),
            "shape": (h, w),
        }


def sample(tables, u_bin, u_accept, u_jitter):
    """Draw directions from the alias table.

    u_bin/u_accept: (N,) uniforms; u_jitter: (N,2) in-texel jitter.
    Returns (dir (N,3), pdf (N,) solid-angle measure)."""
    h, w = tables["shape"]
    n = h * w
    i0 = torch.clamp((u_bin * n).to(torch.int64), max=n - 1)
    take_alias = u_accept >= tables["prob"][i0]
    pix = torch.where(take_alias, tables["alias"][i0].to(torch.int64), i0)
    y = torch.div(pix, w, rounding_mode="floor")
    x = pix - y * w
    theta = (y.to(torch.float32) + u_jitter[:, 0]) / h * math.pi
    phi = ((x.to(torch.float32) + u_jitter[:, 1]) / w - 0.5) * (2 * math.pi)
    sin_t = torch.sin(theta)
    d = torch.stack([sin_t * torch.cos(phi), torch.cos(theta), sin_t * torch.sin(phi)], -1)
    # pdf(omega) = pmf / texel_solid_angle, dOmega = (2pi/W)(pi/H) sin(theta)
    d_omega = (2.0 * math.pi / w) * (math.pi / h) * torch.clamp(sin_t, min=1e-6)
    return d, tables["pmf"][pix] / d_omega


def pdf(tables, d):
    """Solid-angle pdf of sampling direction(s) d (N,3) from the table
    (for MIS against BSDF sampling)."""
    h, w = tables["shape"]
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 2], d[..., 0])
    x = torch.clamp(((phi / (2 * math.pi) + 0.5) * w).to(torch.int64), 0, w - 1)
    y = torch.clamp((theta / math.pi * h).to(torch.int64), 0, h - 1)
    sin_t = torch.clamp(torch.sin(theta), min=1e-6)
    d_omega = (2.0 * math.pi / w) * (math.pi / h) * sin_t
    return tables["pmf"][y * w + x] / d_omega
