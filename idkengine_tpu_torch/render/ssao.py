"""Screen-space ambient occlusion (image space, tensors).
Counterpart: idkengine_tpu/render/ssao.py.

Re-expression of the reference's SSAO (ref: Source/Render/SSAO.cs +
Resource/Shaders/SSAO/compute.glsl): hemisphere samples around the
G-buffer normal, depth-compared in view space, with sample count /
radius / strength settings. The projection is the JAX package's, as
written: the port matches its output.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils import rng
from .sampling import cosine_hemisphere


@dataclass(frozen=True)
class SsaoSettings:
    samples: int = 10
    radius: float = 0.35
    strength: float = 1.3


def ssao(view_pos, normal, frame, settings: SsaoSettings = SsaoSettings()):
    """view_pos: (H,W,3) view-space positions (z<0 in front), normal (H,W,3)
    view-space normals. Returns (H,W) occlusion in [0,1] (1 = occluded)."""
    h, w = view_pos.shape[0], view_pos.shape[1]
    pix = torch.arange(h * w, device=view_pos.device).reshape(h, w)
    state = rng.init_state(pix, frame)

    occlusion = torch.zeros((h, w), dtype=torch.float32, device=view_pos.device)
    z = view_pos[..., 2]
    for _ in range(settings.samples):
        state, u = rng.uniform2(state)
        state, u2 = rng.uniform(state)
        # cosine-hemisphere sample around the normal, scaled into the radius
        dir3 = cosine_hemisphere(normal, u)
        p = view_pos + dir3 * (settings.radius * torch.sqrt(u2))[..., None]
        # project the sample to screen: perspective divide on view pos; a
        # sample on the camera plane divides 0 by 0, and NaN becomes pixel 0
        # as XLA's float-to-int conversion makes it
        px = torch.nan_to_num(((p[..., 0] / -p[..., 2]) * 0.5 + 0.5) * w, nan=0.0)
        py = torch.nan_to_num((0.5 - (p[..., 1] / -p[..., 2]) * 0.5) * h, nan=0.0)
        px = torch.clamp(px, 0, w - 1).to(torch.int64)
        py = torch.clamp(py, 0, h - 1).to(torch.int64)
        sample_z = z[py, px]
        # occluded if the depth buffer is in front of the sample point
        range_check = torch.exp(-torch.abs(z - sample_z))
        occluded = (sample_z > p[..., 2] + 0.02) & (sample_z < p[..., 2] + settings.radius)
        occlusion = occlusion + occluded.to(torch.float32) * range_check
    return torch.clamp(occlusion / settings.samples * settings.strength, 0.0, 1.0)
