"""PCG hash RNG, R2 sequence and interleaved gradient noise on tensors.
Counterpart: idkengine_tpu/utils/rng.py.

The same hash chain as the JAX package, bit for bit (ref: Random.glsl
PCGHash). State is an explicit uint32 value per ray held in an int64 tensor:
every product of two uint32 operands fits in 63 bits, and each step masks
back to 32 bits, so no op needs torch's thin uint32 coverage.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """PCG output permutation on uint32 values (int64 tensor in, int64 out)."""
    x = x.to(torch.int64) & _M32
    state = (x * 747796405 + 2891336453) & _M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _M32
    return (word >> 22) ^ word


def init_state(pixel_index: torch.Tensor, frame: int) -> torch.Tensor:
    """Per-pixel decorrelated RNG state (ref: FirstHit/compute.glsl seed)."""
    f = (int(frame) & _M32) * 83492791 & _M32
    return pcg_hash(((pixel_index.to(torch.int64) * 19349663) & _M32) ^ f)


def next_state(state: torch.Tensor) -> torch.Tensor:
    return pcg_hash(state)


def to_float01(state: torch.Tensor) -> torch.Tensor:
    """uint32 → float32 in [0,1)."""
    return (state >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform(state: torch.Tensor):
    """Returns (new_state, u01)."""
    s = next_state(state)
    return s, to_float01(s)


def uniform2(state: torch.Tensor):
    s1 = next_state(state)
    s2 = next_state(s1)
    return s2, torch.stack([to_float01(s1), to_float01(s2)], dim=-1)


# R2 low-discrepancy sequence with Cranley–Patterson rotation
# (ref: Shading.glsl:50-147 uses R2 + per-pixel rotation for BSDF sampling);
# the constants rounded to float32 as the JAX package's
_R2_G = 1.32471795724474602596
_R2_A1 = float(np.float32(1.0 / _R2_G))
_R2_A2 = float(np.float32(1.0 / (_R2_G * _R2_G)))


def r2(n: torch.Tensor) -> torch.Tensor:
    """(...,) sample index → (...,2) R2 sequence point, float32."""
    n = n.to(torch.float32)
    return torch.stack([torch.remainder(0.5 + _R2_A1 * n, 1.0),
                        torch.remainder(0.5 + _R2_A2 * n, 1.0)], dim=-1)


def r2_rotated(n: torch.Tensor, rotation01) -> torch.Tensor:
    """R2 point with per-pixel Cranley–Patterson rotation (...,2)."""
    return torch.remainder(r2(n) + rotation01, 1.0)


def interleaved_gradient_noise(px: torch.Tensor, py: torch.Tensor, frame) -> torch.Tensor:
    """Screen-space IGN in [0,1) (ref: Random.glsl InterleavedGradientNoise)."""
    f = float(np.float32(frame))
    x = px.to(torch.float32) + 5.588238 * f
    y = py.to(torch.float32) + 5.588238 * f
    return torch.remainder(52.9829189 * torch.remainder(0.06711056 * x + 0.00583715 * y, 1.0),
                           1.0)
