"""Linear-blend skinning. Counterpart: idkengine_tpu/scene/skinning.py.

Re-expression of the reference's skinning compute pass
(ref: Resource/Shaders/Skinning/compute.glsl — 4-joint LBS from joint
matrices). The joint matrices are made on the host in numpy; the blend runs
as two batched products on the caller's device (the JAX package computes
them in XLA, outside any Pallas kernel), and the refit consumes the skinned
tensors where they lie.
"""
from __future__ import annotations

import numpy as np
import torch


def joint_matrices(global_transforms: np.ndarray, skin) -> np.ndarray:
    """(J,4,4) skinning matrices = joint_global @ inverse_bind
    (ref: ModelManager joint matrix upload)."""
    jm = global_transforms[skin.joints] @ skin.inverse_bind_matrices
    return jm.astype(np.float32)


def _blend(joints, weights, jmats):
    """(V,4,4) per-vertex blend of the joint matrices."""
    return torch.einsum("vj,vjrc->vrc", weights, jmats[joints.long()])


def skin_positions(positions, joints, weights, jmats):
    """LBS: positions (V,3), joints (V,4) int, weights (V,4), jmats (J,4,4)
    tensors on one device. Returns skinned (V,3)."""
    m = _blend(joints, weights, jmats)
    p = torch.cat([positions, torch.ones_like(positions[:, :1])], dim=-1)
    return torch.einsum("vrc,vc->vr", m, p)[:, :3]


def skin_normals(normals, joints, weights, jmats):
    """Skin normals with the blended rotation part (no inverse-transpose —
    assumes uniform scale like the reference's mat4x3 path)."""
    m = _blend(joints, weights, jmats)[:, :3, :3]
    out = torch.einsum("vrc,vc->vr", m, normals)
    return out / torch.clamp(torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-12)
