"""Octahedral normal compression. Counterpart: idkengine_tpu/utils/compression.py.

The encoders run on the host in numpy (scene build) and on tensors
(compress_normal_t: the device flatten, the device refit); the decoders run
on tensors (per-hit shading). R11G11B10F packing (pack_r11g11b10 on the
host, unpack_r11g11b10 on either). Bit patterns are uint32 values held in int64
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
    """compress_normal on tensors: unit vectors (...,3) → uint32 bit
    patterns in int64, bit-equal to the numpy encoder on any device (the
    L1 norm's sum in numpy's order, each operation rounded alone)."""
    a = n.abs()
    n = n / torch.clamp((a[..., 0] + a[..., 1]) + a[..., 2], min=1e-20)[..., None]
    p = n[..., :2]
    wrap = (1.0 - p.flip(-1).abs()) * torch.where(p >= 0.0, 1.0, -1.0)
    p = torch.where(n[..., 2:3] >= 0.0, p, wrap)
    q = torch.round(torch.clamp(p, -1.0, 1.0) * 32767.0).to(torch.int64)
    return (q[..., 0] & 0xFFFF) | ((q[..., 1] & 0xFFFF) << 16)


def compress_normal_xp(n, xp=np):
    """compress_normal for either backend, as the JAX package's: numpy
    arrays with xp=np (uint32), tensors with xp=torch (compress_normal_t:
    uint32 bit patterns in int64)."""
    if xp is np:
        return compress_normal(n)
    return compress_normal_t(n)


# ---------------------------------------------------------------------------
# R11G11B10 float packing (unsigned small floats; UVs / colors)
# ---------------------------------------------------------------------------

def _to_small_float(v: np.ndarray, exp_bits: int, man_bits: int) -> np.ndarray:
    """float32 (non-negative) → unsigned small float bit pattern (truncated
    mantissa, clamped exponent)."""
    v = np.maximum(np.asarray(v, np.float32), 0.0)
    bits = v.view(np.uint32) if v.flags["C_CONTIGUOUS"] else np.ascontiguousarray(v).view(np.uint32)
    exp = ((bits >> 23) & 0xFF).astype(np.int32) - 127
    man = (bits >> (23 - man_bits)) & ((1 << man_bits) - 1)
    bias = (1 << (exp_bits - 1)) - 1
    e = np.clip(exp + bias, 0, (1 << exp_bits) - 1)
    out = (e.astype(np.uint32) << man_bits) | man.astype(np.uint32)
    return np.where(v == 0.0, np.uint32(0), out).astype(np.uint32)


def pack_r11g11b10(v: np.ndarray) -> np.ndarray:
    """(...,3) non-negative floats → uint32 R11G11B10F (host side)."""
    v = np.asarray(v, np.float32)
    r = _to_small_float(v[..., 0], 5, 6)
    g = _to_small_float(v[..., 1], 5, 6)
    b = _to_small_float(v[..., 2], 5, 5)
    return (r | (g << 11) | (b << 22)).astype(np.uint32)


def _from_small_float(u, exp_bits: int, man_bits: int, xp):
    bias = (1 << (exp_bits - 1)) - 1
    if xp is np:
        e, m = (u >> man_bits).astype(np.int32), (u & ((1 << man_bits) - 1)).astype(np.float32)
        scale = np.exp2((e - bias).astype(np.float32))
        return np.where(u == 0, 0.0, scale * (1.0 + m / (1 << man_bits)))
    e, m = u >> man_bits, (u & ((1 << man_bits) - 1)).to(torch.float32)
    # 2^(e - bias) exactly, from its bits (e - bias lies in -15..16)
    scale = ((e - bias + 127) << 23).to(torch.int32).view(torch.float32)
    return torch.where(u == 0, 0.0, scale * (1.0 + m / (1 << man_bits)))


def unpack_r11g11b10(u, xp=np):
    """uint32 R11G11B10F → (...,3) float32: numpy with xp=np, tensors (any
    integer dtype holding the bits) with xp=torch."""
    if xp is np:
        uu = np.asarray(u).astype(np.uint32)
    else:
        uu = u.to(torch.int64) & 0xFFFFFFFF
    r = _from_small_float(uu & 0x7FF, 5, 6, xp)
    g = _from_small_float((uu >> 11) & 0x7FF, 5, 6, xp)
    b = _from_small_float((uu >> 22) & 0x3FF, 5, 5, xp)
    return xp.stack([r, g, b], axis=-1) if xp is np else torch.stack([r, g, b], dim=-1)
