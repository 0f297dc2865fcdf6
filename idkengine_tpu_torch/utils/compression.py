"""Octahedral normal compression. Counterpart: idkengine_tpu/utils/compression.py.

The encoders run on the host in numpy (scene build); the decoder runs on
tensors (per-hit shading). Bit patterns are uint32 values held in int64
tensors, since torch's uint32 arithmetic coverage is thin.
"""
from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Octahedral unit-vector encoding (32-bit: 2x snorm16), host side
# ---------------------------------------------------------------------------

def _oct_wrap(v):
    return (1.0 - np.abs(v[..., ::-1])) * np.where(v >= 0.0, 1.0, -1.0)


def encode_octahedral(n: np.ndarray) -> np.ndarray:
    """Unit vectors (...,3) → (...,2) in [-1,1] octahedral coords."""
    n = np.asarray(n, np.float32)
    n = n / np.maximum(np.sum(np.abs(n), axis=-1, keepdims=True), 1e-20)
    p = n[..., :2]
    p = np.where(n[..., 2:3] >= 0.0, p, _oct_wrap(p))
    return p.astype(np.float32)


def pack_snorm2x16(p: np.ndarray) -> np.ndarray:
    """(...,2) in [-1,1] → uint32."""
    q = np.round(np.clip(p, -1.0, 1.0) * 32767.0).astype(np.int32)
    return ((q[..., 0] & 0xFFFF) | ((q[..., 1] & 0xFFFF) << 16)).astype(np.uint32)


def compress_normal(n: np.ndarray) -> np.ndarray:
    """Unit vector → uint32 (octahedral snorm2x16)."""
    return pack_snorm2x16(encode_octahedral(n))


# ---------------------------------------------------------------------------
# Decoding on tensors
# ---------------------------------------------------------------------------

def decode_octahedral(p: torch.Tensor) -> torch.Tensor:
    """(...,2) octahedral coords → (...,3) unit vectors."""
    x, y = p[..., 0], p[..., 1]
    z = 1.0 - x.abs() - y.abs()
    t = torch.clamp(-z, min=0.0)
    x = x + torch.where(x >= 0.0, -t, t)
    y = y + torch.where(y >= 0.0, -t, t)
    v = torch.stack([x, y, z], dim=-1)
    return v / torch.clamp(torch.sqrt((v * v).sum(-1, keepdim=True)), min=1e-20)


def unpack_snorm2x16(u: torch.Tensor) -> torch.Tensor:
    """uint32 bit patterns (any integer dtype) → (...,2) float32 in [-1,1]."""
    u = u.to(torch.int64)
    lo = u & 0xFFFF
    hi = (u >> 16) & 0xFFFF
    # sign-extend 16-bit
    lo = torch.where(lo >= 0x8000, lo - 0x10000, lo)
    hi = torch.where(hi >= 0x8000, hi - 0x10000, hi)
    return torch.stack([lo.float() / 32767.0, hi.float() / 32767.0], dim=-1)


def decompress_normal(u: torch.Tensor) -> torch.Tensor:
    return decode_octahedral(unpack_snorm2x16(u))


def compress_normal_t(n: torch.Tensor) -> torch.Tensor:
    """compress_normal on tensors (the JAX package's `compress_normal_xp`
    for jnp): unit vectors (...,3) → uint32 bit patterns in int64."""
    n = n / torch.clamp(n.abs().sum(-1, keepdim=True), min=1e-20)
    p = n[..., :2]
    wrap = (1.0 - p.flip(-1).abs()) * torch.where(p >= 0.0, 1.0, -1.0)
    p = torch.where(n[..., 2:3] >= 0.0, p, wrap)
    q = torch.round(torch.clamp(p, -1.0, 1.0) * 32767.0).to(torch.int64)
    return (q[..., 0] & 0xFFFF) | ((q[..., 1] & 0xFFFF) << 16)
