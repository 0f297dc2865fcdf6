"""An equirect sky for the scenes: single-scattering Rayleigh and Mie
atmosphere (the port's render/sky.compute_atmosphere arithmetic, default
settings, in PyTorch on the given device), a small sun patch, and the RGBE
round trip of a Radiance .hdr file (mantissa truncated, exponent biased
128, decoded without the half-step offset)."""
from __future__ import annotations

import numpy as np
import torch

_BETA_R = np.array([5.5e-6, 13.0e-6, 22.4e-6], np.float32)
_BETA_M = np.float32(21e-6)
SUN = (0.3, 0.8, 0.2)
PLANET, ATMOSPHERE = 6.371e6, 6.471e6
H_R, H_M, MIE_G, SUN_INTENSITY, I_STEPS, J_STEPS = 8000.0, 1200.0, 0.758, 22.0, 16, 4


def _exit(o, d, radius):
    b = (o * d).sum(-1)
    c = (o * o).sum(-1) - radius * radius
    return -b + torch.sqrt(torch.clamp(b * b - c, min=0.0))


def atmosphere(width: int, height: int, device="cpu") -> np.ndarray:
    """(height, width, 3) float32 radiance; x is phi, y is theta from +y."""
    dev = torch.device(device)
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    theta = (ys + 0.5) / height * np.pi
    phi = ((xs + 0.5) / width * 2.0 - 1.0) * np.pi
    d = np.stack([np.sin(theta) * np.cos(phi), np.cos(theta), np.sin(theta) * np.sin(phi)],
                 -1).astype(np.float32)
    d = torch.from_numpy(d.reshape(-1, 3)).to(dev)
    sun = np.asarray(SUN, np.float32)
    sun = torch.from_numpy(sun / np.linalg.norm(sun)).to(dev)
    o = torch.tensor([0.0, PLANET + 2.0, 0.0], device=dev).expand(d.shape)
    beta_r = torch.from_numpy(_BETA_R).to(dev)
    beta_m, beta_m_ext = float(_BETA_M), float(_BETA_M * 1.1)
    seg = _exit(o, d, ATMOSPHERE) / I_STEPS
    mu = (d * sun).sum(-1)
    phase_r = 3.0 / (16.0 * np.pi) * (1.0 + mu * mu)
    g = MIE_G
    phase_m = (3.0 / (8.0 * np.pi) * ((1.0 - g * g) * (1.0 + mu * mu))
               / ((2.0 + g * g) * torch.pow(1.0 + g * g - 2.0 * g * mu, 1.5)))
    n = d.shape[0]
    sum_r, sum_m = torch.zeros_like(d), torch.zeros_like(d)
    od_r, od_m = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
    for i in range(I_STEPS):
        p = o + d * ((i + 0.5) * seg)[..., None]
        h = torch.clamp(torch.linalg.vector_norm(p, dim=-1) - PLANET, min=0.0)
        hr, hm = torch.exp(-h / H_R) * seg, torch.exp(-h / H_M) * seg
        od_r, od_m = od_r + hr, od_m + hm
        sseg = _exit(p, sun.expand(p.shape), ATMOSPHERE) / J_STEPS
        od_sr, od_sm = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
        for j in range(J_STEPS):
            q = p + sun * ((j + 0.5) * sseg)[..., None]
            hq = torch.clamp(torch.linalg.vector_norm(q, dim=-1) - PLANET, min=0.0)
            od_sr = od_sr + torch.exp(-hq / H_R) * sseg
            od_sm = od_sm + torch.exp(-hq / H_M) * sseg
        att = torch.exp(-(beta_r * (od_r + od_sr)[..., None]
                          + beta_m_ext * (od_m + od_sm)[..., None]))
        sum_r, sum_m = sum_r + att * hr[..., None], sum_m + att * hm[..., None]
    rad = SUN_INTENSITY * (sum_r * beta_r * phase_r[..., None]
                           + sum_m * beta_m * phase_m[..., None])
    return rad.cpu().numpy().reshape(height, width, 3).astype(np.float32)


def with_sun(env: np.ndarray, value: float = 60.0) -> np.ndarray:
    h, w = env.shape[:2]
    env = env.copy()
    env[h // 5:h // 5 + h // 64 + 1, w // 3:w // 3 + w // 64 + 1] = value
    return env


def rgbe_roundtrip(img: np.ndarray) -> np.ndarray:
    """The radiance a flat RGBE .hdr file of img reads back as."""
    img = np.maximum(np.asarray(img, np.float32), 0.0)
    m = img.max(axis=-1)
    mant, e = np.frexp(m)
    scale = np.where(m > 1e-32, mant * 256.0 / np.where(m > 1e-32, m, 1.0), 0.0)
    rgb = np.minimum(img * scale[..., None], 255.0).astype(np.uint8)
    ex = np.where(m > 1e-32, e + 128, 0).astype(np.uint8)
    scale = np.exp2((ex.astype(np.int32) - 136).astype(np.float32))  # 128 bias, 8 mantissa bits
    out = rgb.astype(np.float32) * scale[..., None]
    out[ex == 0] = 0.0
    return out.astype(np.float32)
