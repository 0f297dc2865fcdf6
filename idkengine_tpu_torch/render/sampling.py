"""Sampling routines on ray batches. Counterpart: idkengine_tpu/render/sampling.py.

ref: Resource/Shaders/include/Sampling.glsl: ONB construction, cosine
hemisphere, uniform sphere, sphere-light solid-angle sampling, reflection
and refraction.
"""
from __future__ import annotations

import torch

TWO_PI = 6.283185307179586


def _dot(a, b):
    return (a * b).sum(-1)


def build_onb(n):
    """Orthonormal basis from unit normal (...,3) → (t, b). Frisvad/Duff method."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0]], dim=-1)
    bt = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bt


def cosine_hemisphere(n, u):
    """Cosine-weighted hemisphere around n. u: (...,2) in [0,1)."""
    t, b = build_onb(n)
    phi = TWO_PI * u[..., 0]
    r = torch.sqrt(u[..., 1])
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u[..., 1], min=0.0))
    return t * x[..., None] + b * y[..., None] + n * z[..., None]


def uniform_sphere(u):
    """Uniform direction on the unit sphere. u: (...,2)."""
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def sphere_light_sample(p, center, radius, u):
    """Solid-angle sampling of a sphere light from shading point p.
    Returns (dir, pdf_solid_angle, dist_to_center)."""
    to_c = center - p
    dist2 = _dot(to_c, to_c)
    dist = torch.sqrt(dist2)
    # cone half-angle
    sin_max2 = torch.clamp(radius * radius / torch.clamp(dist2, min=1e-12), 0.0, 0.9999)
    cos_max = torch.sqrt(1.0 - sin_max2)
    # sample direction in cone
    cos_t = 1.0 - u[..., 0] * (1.0 - cos_max)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = TWO_PI * u[..., 1]
    w = to_c / torch.clamp(dist, min=1e-12)[..., None]
    t, b = build_onb(w)
    d = (t * (sin_t * torch.cos(phi))[..., None]
         + b * (sin_t * torch.sin(phi))[..., None]
         + w * cos_t[..., None])
    pdf = 1.0 / (TWO_PI * torch.clamp(1.0 - cos_max, min=1e-8))
    return d, pdf, dist


def reflect(d, n):
    return d - 2.0 * _dot(d, n)[..., None] * n


def refract(d, n, eta):
    """Snell refraction; returns (dir, total_internal_reflection_mask)."""
    cos_i = -_dot(d, n)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    refr = eta[..., None] * d + (eta * cos_i - cos_t)[..., None] * n
    return torch.where(tir[..., None], reflect(d, n), refr), tir
