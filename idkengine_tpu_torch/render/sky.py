"""Sky: HDR environment maps and procedural atmospheric scattering.
Counterpart: idkengine_tpu/render/sky.py.

Role of the reference's SkyBoxManager + AtmosphericScatterer
(ref: Source/Render/SkyBoxManager.cs:13-86 — ExternalAsset equirect/cubemap
vs InternalAtmosphericScattering modes;
Resource/Shaders/AtmosphericScattering/compute.glsl — Rayleigh+Mie
in-scattering). The environment is an equirectangular (H,W,3) radiance
array sampled by direction; the atmospheric mode computes the same
single-scattering integral into that array once, in torch on the device
the caller names (the card unless asked for the CPU).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class AtmosphereSettings:
    """ref: AtmosphericScatterer.cs settings (ISteps/JSteps/time/density)."""

    sun_direction: tuple = (0.3, 0.8, 0.2)
    sun_intensity: float = 22.0
    i_steps: int = 16  # view-ray samples
    j_steps: int = 4  # sun-ray samples
    planet_radius: float = 6.371e6
    atmosphere_radius: float = 6.471e6
    rayleigh_scale_height: float = 8000.0
    mie_scale_height: float = 1200.0
    mie_g: float = 0.758


_BETA_R = np.array([5.5e-6, 13.0e-6, 22.4e-6], np.float32)
_BETA_M = np.float32(21e-6)


def _ray_sphere_exit(o, d, radius):
    b = (o * d).sum(-1)
    c = (o * o).sum(-1) - radius * radius
    disc = torch.clamp(b * b - c, min=0.0)
    return -b + torch.sqrt(disc)


def compute_atmosphere(width: int = 256, height: int = 128,
                       settings: AtmosphereSettings = AtmosphereSettings(), *,
                       device="cuda") -> np.ndarray:
    """Single-scattering Rayleigh+Mie sky as an equirect (H,W,3) float32
    array, computed on `device` (the reference renders the same integral
    into a cubemap)."""
    s = settings
    dev = torch.device(device)
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    theta = (ys + 0.5) / height * np.pi
    phi = ((xs + 0.5) / width * 2.0 - 1.0) * np.pi
    d = np.stack(
        [np.sin(theta) * np.cos(phi), np.cos(theta), np.sin(theta) * np.sin(phi)], -1
    ).astype(np.float32)
    d = torch.from_numpy(d.reshape(-1, 3)).to(dev)

    sun = np.asarray(s.sun_direction, np.float32)
    sun = torch.from_numpy(sun / np.linalg.norm(sun)).to(dev)

    o = torch.tensor([0.0, s.planet_radius + 2.0, 0.0], device=dev).expand(d.shape)
    beta_r = torch.from_numpy(_BETA_R).to(dev)
    beta_m = float(_BETA_M)
    beta_m_ext = float(_BETA_M * 1.1)  # float32, as the JAX package rounds it

    t_exit = _ray_sphere_exit(o, d, s.atmosphere_radius)
    seg = t_exit / s.i_steps

    mu = (d * sun).sum(-1)
    phase_r = 3.0 / (16.0 * np.pi) * (1.0 + mu * mu)
    g = s.mie_g
    phase_m = (
        3.0 / (8.0 * np.pi)
        * ((1.0 - g * g) * (1.0 + mu * mu))
        / ((2.0 + g * g) * torch.pow(1.0 + g * g - 2.0 * g * mu, 1.5))
    )

    n = d.shape[0]
    sum_r = torch.zeros_like(d)
    sum_m = torch.zeros_like(d)
    od_r = torch.zeros(n, device=dev)
    od_m = torch.zeros(n, device=dev)
    for i in range(s.i_steps):
        p = o + d * ((i + 0.5) * seg)[..., None]
        h = torch.clamp(torch.linalg.vector_norm(p, dim=-1) - s.planet_radius, min=0.0)
        hr = torch.exp(-h / s.rayleigh_scale_height) * seg
        hm = torch.exp(-h / s.mie_scale_height) * seg
        od_r = od_r + hr
        od_m = od_m + hm
        # optical depth toward the sun
        t_sun = _ray_sphere_exit(p, sun.expand(p.shape), s.atmosphere_radius)
        sseg = t_sun / s.j_steps
        od_sr = torch.zeros(n, device=dev)
        od_sm = torch.zeros(n, device=dev)
        for j in range(s.j_steps):
            q = p + sun * ((j + 0.5) * sseg)[..., None]
            hq = torch.clamp(torch.linalg.vector_norm(q, dim=-1) - s.planet_radius, min=0.0)
            od_sr = od_sr + torch.exp(-hq / s.rayleigh_scale_height) * sseg
            od_sm = od_sm + torch.exp(-hq / s.mie_scale_height) * sseg
        tau = beta_r * (od_r + od_sr)[..., None] + beta_m_ext * (od_m + od_sm)[..., None]
        att = torch.exp(-tau)
        sum_r = sum_r + att * hr[..., None]
        sum_m = sum_m + att * hm[..., None]

    radiance = s.sun_intensity * (
        sum_r * beta_r * phase_r[..., None]
        + sum_m * beta_m * phase_m[..., None]
    )
    return radiance.cpu().numpy().reshape(height, width, 3).astype(np.float32)


class SkyBoxManager:
    """Environment source selector (ref: SkyBoxManager.cs modes)."""

    def __init__(self, *, device="cuda"):
        self.device = device
        self.env_map: np.ndarray | None = None

    def load_equirect_hdr(self, path: str):
        from ..scene.hdr import load_hdr

        self.env_map = load_hdr(path)
        return self.env_map

    def use_atmospheric_scattering(self, settings: AtmosphereSettings = AtmosphereSettings(),
                                   width: int = 256, height: int = 128):
        self.env_map = compute_atmosphere(width, height, settings, device=self.device)
        return self.env_map
