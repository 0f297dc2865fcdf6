"""Path-tracing denoiser: SVGF-style edge-avoiding à-trous filter.
Counterpart: idkengine_tpu/render/denoise.py (`DenoiseSettings`, `atrous_denoise`).

Fills the role of the reference's OIDN bridge (ref: Source/OIDN/OIDN.cs +
PathTracerPipeline.cs:165-278) on the device, from the path tracer's AOVs:
albedo demodulation, edge-clamped taps, a firefly clamp, a luminance weight
normalised by the variance of the sample mean (SVGF eq. 3) with the variance
carried through each iteration, and a final blend toward the noisy input
where the relative variance is small. The JAX filter runs outside any
Pallas kernel; this is its plain PyTorch form, operation for operation.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

_LUMA = (0.2126, 0.7152, 0.0722)


@dataclass(frozen=True)
class DenoiseSettings:
    iterations: int = 3
    sigma_color: float = 2.0  # in sqrt(variance) units when variance given
    sigma_normal: float = 0.25
    sigma_depth: float = 0.6
    sigma_albedo: float = 0.25  # albedo guide: keeps emitter/material edges
    sigma_color_novar: float = 0.3  # fixed sigma for callers without variance
    albedo_floor: float = 0.05  # below this, a pixel is not demodulated
    # clamp a pixel's irradiance luminance to this many times the mean of
    # its 8 neighbours before filtering (0 = off); the reference's default
    firefly_clamp: float = 8.0
    # final lerp(noisy, filtered, rv/(rv+k)), rv = variance/lum^2 (0 = off)
    variance_blend: float = 4e-3


_KERNEL = [1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16]  # B3 spline


def _shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-clamped 2D shift (tap at p + (dy,dx)) for (H,W,...) tensors."""
    h, w = a.shape[0], a.shape[1]
    yi = torch.clamp(torch.arange(h, device=a.device) + dy, 0, h - 1)
    xi = torch.clamp(torch.arange(w, device=a.device) + dx, 0, w - 1)
    return a.index_select(0, yi).index_select(1, xi)


def _luminance(c: torch.Tensor) -> torch.Tensor:
    return c[..., 0] * _LUMA[0] + c[..., 1] * _LUMA[1] + c[..., 2] * _LUMA[2]


def atrous_denoise(color: torch.Tensor, albedo: torch.Tensor, normal: torch.Tensor,
                   depth: torch.Tensor, settings: DenoiseSettings = DenoiseSettings(),
                   variance: torch.Tensor | None = None) -> torch.Tensor:
    """Edge-avoiding à-trous wavelet denoise.

    color: (H,W,3) noisy radiance; albedo/normal: (H,W,3) AOVs; depth (H,W);
    variance: optional (H,W) variance of the accumulated mean luminance
    (PathTracer.variance()). Filters demodulated irradiance and re-modulates
    at the end."""
    s = settings
    # demodulate only where albedo is meaningful (not emitters or misses)
    amax = albedo.amax(dim=-1, keepdim=True)
    demod = torch.where(amax > s.albedo_floor, torch.clamp(albedo, min=1e-3),
                        torch.ones_like(albedo))
    irr = color / demod
    finite = torch.isfinite(depth)
    d_max = torch.where(finite, depth, torch.zeros_like(depth)).max()
    d_norm = depth / torch.clamp(d_max, min=1e-3)
    d_norm = torch.where(finite, d_norm, torch.ones_like(d_norm))

    if s.firefly_clamp > 0.0:
        lum0 = _luminance(irr)
        nsum = torch.zeros_like(lum0)
        for gy in (-1, 0, 1):
            for gx in (-1, 0, 1):
                if gy == 0 and gx == 0:
                    continue
                nsum = nsum + _shift(lum0, gy, gx)
        bound = s.firefly_clamp * nsum / 8.0 + 1e-4
        scale = torch.clamp(bound / torch.clamp(lum0, min=1e-12), max=1.0)
        irr = irr * scale[..., None]

    out = irr
    var = variance
    if var is not None:
        # the variance is of modulated radiance; the filter runs on
        # irradiance: Var[l/f] = Var[l] / f^2
        f = _luminance(demod * torch.ones_like(irr))
        var = var / torch.clamp(f * f, min=1e-6)
    for it in range(s.iterations):
        step = 1 << it
        acc = torch.zeros_like(out)
        wsum = torch.zeros(out.shape[:2] + (1,), dtype=out.dtype, device=out.device)
        lum = _luminance(out)
        if var is not None:
            v_acc = torch.zeros_like(var)
            w2sum = torch.zeros_like(var)
            # 3x3 Gaussian-blurred variance drives the luminance sigma
            gvar = torch.zeros_like(var)
            for gy in (-1, 0, 1):
                for gx in (-1, 0, 1):
                    gw = (2.0 if gy == 0 else 1.0) * (2.0 if gx == 0 else 1.0)
                    gvar = gvar + gw * _shift(var, gy, gx)
            gvar = gvar / 16.0
            sigma_l = s.sigma_color * torch.sqrt(torch.clamp(gvar, min=0.0)) + 1e-6
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                kw = _KERNEL[dy + 2] * _KERNEL[dx + 2]
                c_n = _shift(out, dy * step, dx * step)
                n_n = _shift(normal, dy * step, dx * step)
                d_n = _shift(d_norm, dy * step, dx * step)
                if var is not None:
                    l_n = _shift(lum, dy * step, dx * step)
                    w_c = torch.exp(-(l_n - lum).abs() / sigma_l)[..., None]
                else:
                    w_c = torch.exp(-((c_n - out) ** 2).sum(-1, keepdim=True)
                                    / (s.sigma_color_novar ** 2))
                w_n = torch.exp(-torch.clamp(1.0 - (n_n * normal).sum(-1, keepdim=True),
                                             min=0.0) / (s.sigma_normal ** 2))
                w_d = torch.exp(-(d_n - d_norm).abs()[..., None] / s.sigma_depth)
                a_n = _shift(albedo, dy * step, dx * step)
                w_a = torch.exp(-((a_n - albedo) ** 2).sum(-1, keepdim=True)
                                / (s.sigma_albedo ** 2))
                wgt = kw * w_c * w_n * w_d * w_a
                acc = acc + c_n * wgt
                wsum = wsum + wgt
                if var is not None:
                    v_n = _shift(var, dy * step, dx * step)
                    v_acc = v_acc + (wgt[..., 0] ** 2) * v_n
                    w2sum = w2sum + wgt[..., 0]
        out = acc / torch.clamp(wsum, min=1e-8)
        if var is not None:
            var = v_acc / torch.clamp(w2sum, min=1e-8) ** 2
    result = out * demod
    if variance is not None and s.variance_blend > 0.0:
        lum_c = _luminance(color)
        rv = variance / torch.clamp(lum_c * lum_c, min=1e-8)
        w_f = (rv / (rv + s.variance_blend))[..., None]
        result = color + (result - color) * w_f
    return result
