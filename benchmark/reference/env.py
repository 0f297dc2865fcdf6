"""The reference's sky map: its bilinear lookup by direction (phi wraps,
theta clamps at the poles) and next-event estimation toward it through a
Vose alias table over texel power (luminance times the texel's sin theta),
built here from the map as the renderer states it; imports nothing of the
program."""
from __future__ import annotations

import math

import numpy as np
import torch

from .materials import mix


def alias_table(env: np.ndarray):
    """(prob (N,) f32, alias (N,) i32, pmf (N,) f32) of an (H,W,3) map."""
    env = np.asarray(env, np.float32)
    h = env.shape[0]
    lum = 0.2126 * env[..., 0] + 0.7152 * env[..., 1] + 0.0722 * env[..., 2]
    theta = (np.arange(h, dtype=np.float64) + 0.5) / h * np.pi
    w = (np.maximum(lum, 0.0) * np.maximum(np.sin(theta), 1e-6)[:, None])
    w = np.asarray(w, np.float64).ravel()
    n = w.size
    total = w.sum()
    if not np.isfinite(total) or total <= 0.0:
        w, total = np.ones_like(w), float(n)
    pmf = w / total
    scaled = pmf * n
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    return prob.astype(np.float32), alias, pmf.astype(np.float32)


class Sky:
    def __init__(self, env: np.ndarray, strength: float, device, dtype):
        self.h, self.w = env.shape[0], env.shape[1]
        self.strength, self.dtype = strength, dtype
        self.flat = torch.as_tensor(np.asarray(env, np.float32), device=device).reshape(-1, 3)
        self.flat = self.flat.to(dtype)
        prob, alias, pmf = alias_table(env)
        self.prob = torch.as_tensor(prob, device=device).to(dtype)
        self.alias = torch.as_tensor(alias, device=device)
        self.pmf = torch.as_tensor(pmf, device=device).to(dtype)

    def radiance(self, d):
        h, w = self.h, self.w
        theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
        phi = torch.atan2(d[..., 2], d[..., 0])
        fx = (phi / (2 * np.pi) + 0.5) * w - 0.5
        fy = torch.clamp(theta / np.pi * h - 0.5, 0.0, h - 1.0)
        x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
        tx, ty = (fx - x0)[..., None], (fy - y0)[..., None]
        x0 = torch.remainder(x0, w)
        y0 = torch.clamp(y0, 0, h - 1)  # a no-op but where a coordinate is not a number
        x1 = torch.remainder(x0 + 1, w)
        y1 = torch.clamp(y0 + 1, max=h - 1)
        f = self.flat
        top = mix(f[y0 * w + x0], f[y0 * w + x1], tx)
        bot = mix(f[y1 * w + x0], f[y1 * w + x1], tx)
        return mix(top, bot, ty) * self.strength

    def sample(self, u_bin, u_accept, u_jitter):
        """(direction (N,3), solid-angle pdf (N,)) of alias draws."""
        h, w = self.h, self.w
        n = h * w
        i0 = torch.clamp((u_bin * n).to(torch.int64), max=n - 1)
        pix = torch.where(u_accept >= self.prob[i0], self.alias[i0].to(torch.int64), i0)
        y = torch.div(pix, w, rounding_mode="floor")
        x = pix - y * w
        theta = (y.to(self.dtype) + u_jitter[:, 0]) / h * math.pi
        phi = ((x.to(self.dtype) + u_jitter[:, 1]) / w - 0.5) * (2 * math.pi)
        sin_t = torch.sin(theta)
        d = torch.stack([sin_t * torch.cos(phi), torch.cos(theta), sin_t * torch.sin(phi)], -1)
        d_omega = (2.0 * math.pi / w) * (math.pi / h) * torch.clamp(sin_t, min=1e-6)
        return d, self.pmf[pix] / d_omega
