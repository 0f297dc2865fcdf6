"""Order-independent transparency by depth peeling.
Counterpart: idkengine_tpu/render/oit.py.

The reference records up to TRANSPARENT_LAYERS colour+depth layers a pixel
and sorts them in a resolve pass (ref: RecordTransparent/fragment.glsl,
ResolveTransparent/compute.glsl, RasterPipeline.cs:518-588,686-705). With
rays instead of a raster record pass, the K closest transparent surfaces
are found by depth peeling: K closest-hit traces, each restarting just past
the previous layer. The layers arrive in depth order, so the resolve is a
front-to-back alpha composite.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

TRANSPARENT_LAYERS = 10  # ref: AppInsert TRANSPARENT_LAYERS default


@dataclass(frozen=True)
class OitSettings:
    layers: int = 4  # K peels (10 matches the reference but 4 is plenty)
    alpha_min: float = 1e-3  # stop peeling when accumulated alpha ~ 1


def peel_layers(trace_fn, shade_fn, o, d, t_far, layers: int = 4):
    """Depth-peel up to `layers` transparent surfaces along rays (o, d).

    trace_fn(o, d, t_min, t_max) -> (t, valid, *aux) of the next hit past
    t_min (aux, e.g. triangle slot/u/v, is forwarded to the shader);
    shade_fn(t, valid, *aux) -> (rgb, alpha) or (rgb, alpha, stop) for that
    layer, `stop` marking rays whose peel ends here without compositing
    (an opaque hit the opaque pass already shaded).
    Returns (color (R,3), alpha (R,)) composited front-to-back."""
    r = o.shape[0]
    dev = o.device
    color = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    trans = torch.ones(r, dtype=torch.float32, device=dev)  # remaining transmittance
    t_min = torch.zeros(r, dtype=torch.float32, device=dev)
    stopped = torch.zeros(r, dtype=torch.bool, device=dev)
    for _ in range(layers):
        t, valid, *aux = trace_fn(o, d, t_min, t_far)
        valid = valid & ~stopped
        shaded = shade_fn(t, valid, *aux)
        rgb, a = shaded[:2]
        stop = shaded[2] if len(shaded) > 2 else torch.zeros(r, dtype=torch.bool, device=dev)
        take = valid & ~stop
        w = trans * a * take.to(torch.float32)
        color = color + rgb * w[..., None]
        trans = torch.where(take, trans * (1.0 - a), trans)
        t_min = torch.where(take, t_min + t + 1e-4, t_min)
        stopped = stopped | (valid & stop)
    return color, 1.0 - trans


def composite_over(transparent_rgb, transparent_alpha, opaque_rgb):
    """Resolve pass: transparent layers over the opaque shading result
    (ref: ResolveTransparent/compute.glsl final blend)."""
    a = transparent_alpha[..., None]
    return transparent_rgb + opaque_rgb * (1.0 - a)
