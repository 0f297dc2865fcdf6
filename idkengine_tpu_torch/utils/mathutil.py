"""Host-side math helpers (numpy). Counterpart: idkengine_tpu/utils/mathutil.py.

Carried over as numpy code: vector normalisation, the camera's view and
reverse-Z projection matrices, TRS compose/decompose for model nodes,
quaternion slerp for animation, the Halton sequence of the TAA jitter, the
R2 sequence, 30-bit Morton codes and the area metrics.
"""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Low-discrepancy sequences
# ---------------------------------------------------------------------------

def halton(index: int | np.ndarray, base: int) -> np.ndarray:
    """Radical-inverse Halton sequence member(s). index is 0-based.

    Used for TAA sub-pixel jitter (ref: MyMath.cs:116-136)."""
    index = np.asarray(index, dtype=np.int64) + 1  # skip the 0 sample
    result = np.zeros(index.shape, dtype=np.float64)
    f = np.ones(index.shape, dtype=np.float64)
    i = index.copy()
    # enough iterations for any int32 index in any base >= 2
    for _ in range(63):
        active = i > 0
        f = np.where(active, f / base, f)
        result = np.where(active, result + f * (i % base), result)
        i = np.where(active, i // base, i)
    return result


def halton_2d(n: int) -> np.ndarray:
    """(n, 2) array of Halton(2,3) points in [0,1)^2 (TAA jitter sequence)."""
    idx = np.arange(n)
    return np.stack([halton(idx, 2), halton(idx, 3)], axis=-1).astype(np.float32)


# R2 sequence constants (plastic number), ref: Resource/Shaders/include/Sampling.glsl
_R2_G = 1.32471795724474602596
_R2_A1 = 1.0 / _R2_G
_R2_A2 = 1.0 / (_R2_G * _R2_G)


def r2_sequence(n: int | np.ndarray) -> np.ndarray:
    """R2 low-discrepancy sequence point(s) in [0,1)^2."""
    n = np.asarray(n, dtype=np.float64)
    return np.stack([(0.5 + _R2_A1 * n) % 1.0, (0.5 + _R2_A2 * n) % 1.0], axis=-1)


# ---------------------------------------------------------------------------
# Morton codes (30-bit, 10 bits per axis) — TLAS PLOC sort key
# (ref: MyMath.cs:288, TLAS.cs:52-56)
# ---------------------------------------------------------------------------

def _expand_bits_10(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64) & 0x3FF
    v = (v | (v << 16)) & np.uint64(0x030000FF)
    v = (v | (v << 8)) & np.uint64(0x0300F00F)
    v = (v | (v << 4)) & np.uint64(0x030C30C3)
    v = (v | (v << 2)) & np.uint64(0x09249249)
    return v


def morton_encode(xyz01: np.ndarray) -> np.ndarray:
    """30-bit Morton code from points normalized to [0,1)^3. xyz01: (..., 3)."""
    q = np.clip(xyz01 * 1024.0, 0.0, 1023.0).astype(np.uint32)
    return ((_expand_bits_10(q[..., 0]) << 2) | (_expand_bits_10(q[..., 1]) << 1)
            | _expand_bits_10(q[..., 2])).astype(np.uint32)


# ---------------------------------------------------------------------------
# Geometry helpers
# ---------------------------------------------------------------------------

def half_area(extent: np.ndarray) -> np.ndarray:
    """Half the surface area of an AABB with the given extents (..., 3): the
    SAH cost metric (ref: MyMath.cs HalvedArea)."""
    return extent[..., 0] * (extent[..., 1] + extent[..., 2]) + extent[..., 1] * extent[..., 2]


def triangle_area(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    return 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)


def normalize(v: np.ndarray, eps: float = 1e-20) -> np.ndarray:
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), eps)


# ---------------------------------------------------------------------------
# Camera matrices — reverse 0..1 depth convention (ref: Camera.cs:187-200,
# MyMath.cs:180).
# ---------------------------------------------------------------------------

def look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """4x4 world→view matrix (column-vector convention: view = M @ p_h)."""
    f = normalize(np.asarray(target, np.float64) - eye)
    s = normalize(np.cross(f, up))
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[:3, 3] = -m[:3, :3] @ eye
    return m.astype(np.float32)


def perspective_reverse_z(fovy: float, aspect: float, near: float) -> np.ndarray:
    """Infinite-far reverse-Z projection with [0,1] depth (1 at near, 0 at
    infinity; ref: Camera.cs:197-200)."""
    f = 1.0 / np.tan(fovy * 0.5)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = 0.0
    m[2, 3] = near
    m[3, 2] = -1.0
    return m


# ---------------------------------------------------------------------------
# Transform compose/decompose (ref: Source/Transformation.cs)
# ---------------------------------------------------------------------------

def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """(...,4) xyzw quaternion → (...,3,3) rotation matrix."""
    q = np.asarray(q, dtype=np.float64)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = np.where(n > 0, 2.0 / np.maximum(n, 1e-30), 0.0)
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    m = np.empty(q.shape[:-1] + (3, 3))
    m[..., 0, 0] = 1 - (yy + zz)
    m[..., 0, 1] = xy - wz
    m[..., 0, 2] = xz + wy
    m[..., 1, 0] = xy + wz
    m[..., 1, 1] = 1 - (xx + zz)
    m[..., 1, 2] = yz - wx
    m[..., 2, 0] = xz - wy
    m[..., 2, 1] = yz + wx
    m[..., 2, 2] = 1 - (xx + yy)
    return m.astype(np.float32)


def quat_slerp(q0: np.ndarray, q1: np.ndarray, t) -> np.ndarray:
    """Spherical lerp between xyzw quaternions; t broadcastable.

    Keyframe rotation interpolation (ref: ModelManager.cs:560-574)."""
    q0 = np.asarray(q0, np.float64)
    q1 = np.asarray(q1, np.float64)
    t = np.asarray(t, np.float64)[..., None]
    d = np.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = np.where(d < 0, -q1, q1)
    d = np.abs(d)
    # fall back to nlerp when nearly parallel
    theta = np.arccos(np.clip(d, -1.0, 1.0))
    sin_theta = np.sin(theta)
    safe = sin_theta > 1e-6
    w0 = np.where(safe, np.sin((1 - t) * theta) / np.where(safe, sin_theta, 1.0), 1 - t)
    w1 = np.where(safe, np.sin(t * theta) / np.where(safe, sin_theta, 1.0), t)
    out = w0 * q0 + w1 * q1
    return (out / np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-20)).astype(
        np.float32
    )


def trs_matrix(translation, rotation_q, scale) -> np.ndarray:
    """Compose (...,3) T, (...,4) xyzw R, (...,3) S into (...,4,4) (column vectors)."""
    translation = np.asarray(translation, np.float32)
    scale = np.asarray(scale, np.float32)
    r = quat_to_matrix(rotation_q)
    m = np.zeros(translation.shape[:-1] + (4, 4), dtype=np.float32)
    m[..., :3, :3] = r * scale[..., None, :]
    m[..., :3, 3] = translation
    m[..., 3, 3] = 1.0
    return m


def decompose_trs(m: np.ndarray):
    """4x4 → (T, R_xyzw, S). Assumes no shear (ref: Transformation.FromMatrix)."""
    m = np.asarray(m, np.float64)
    t = m[:3, 3].astype(np.float32)
    basis = m[:3, :3]
    s = np.linalg.norm(basis, axis=0)
    det = np.linalg.det(basis)
    if det < 0:
        s = s * np.array([-1.0, 1.0, 1.0])
    r = basis / s[None, :]
    q = matrix_to_quat(r)
    return t, q.astype(np.float32), s.astype(np.float32)


def matrix_to_quat(r: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix → xyzw quaternion."""
    r = np.asarray(r, np.float64)
    tr = np.trace(r)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array(
            [(r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s, 0.25 * s]
        )
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1.0, 0.0)) * 2
    q = np.empty(4)
    q[i] = 0.25 * s
    q[j] = (r[j, i] + r[i, j]) / s
    q[k] = (r[k, i] + r[i, k]) / s
    q[3] = (r[k, j] - r[j, k]) / s
    return q
