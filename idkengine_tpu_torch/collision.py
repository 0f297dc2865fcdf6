"""Convex volumes and their separating-axis test (numpy, host side).
Counterpart: idkengine_tpu/collision.py (`Frustum`, `convex_sat_intersect`).

The deferred pipeline culls each point light's cube-map faces against the
camera frustum with these before it traces the faces' shadow-map rays (ref:
CpuPointShadow.cs:116-185). The JAX module's moving-sphere sweeps and
`camera_collision` serve the interactive engine's camera and light physics
and wait for it; they are not part of this module yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .utils.mathutil import normalize


@dataclass
class Frustum:
    """Convex frustum as corner points + unique face/edge axes
    (ref: Source/Shapes/Frustum.cs; built Gribb-Hartmann style from a
    clip-space matrix)."""

    corners: np.ndarray  # (8,3)
    axes: np.ndarray  # (K,3) face normals (unnormalized ok)
    edges: np.ndarray  # (E,3) edge directions for SAT cross axes

    @staticmethod
    def from_view_projection(vp: np.ndarray, zero_to_one_depth: bool = True,
                             far_depth: float = 1e-4):
        """Corners by unprojecting the NDC cube through inv(vp).

        The engine's reverse-Z projection has an infinite far plane (depth
        0); far corners are taken at `far_depth` instead."""
        inv = np.linalg.inv(np.asarray(vp, np.float64))
        z0 = far_depth if zero_to_one_depth else -1.0
        corners = []
        for z in (z0, 1.0):
            for y in (-1.0, 1.0):
                for x in (-1.0, 1.0):
                    h = inv @ np.array([x, y, z, 1.0])
                    corners.append(h[:3] / h[3])
        corners = np.asarray(corners)
        # face normals of the six quads; edge directions of the three families
        quads = [
            (corners[0], corners[1], corners[2]),  # near
            (corners[4], corners[6], corners[5]),  # far
            (corners[0], corners[2], corners[4]),  # left
            (corners[1], corners[5], corners[3]),  # right
            (corners[0], corners[4], corners[1]),  # bottom
            (corners[2], corners[3], corners[6]),  # top
        ]
        axes = [np.cross(b - a, c - a) for a, b, c in quads]
        edges = np.stack([
            corners[1] - corners[0], corners[2] - corners[0],
            corners[4] - corners[0], corners[5] - corners[1],
            corners[6] - corners[2], corners[7] - corners[3],
        ])
        return Frustum(corners=corners.astype(np.float64), axes=normalize(np.stack(axes)),
                       edges=normalize(edges))

    @staticmethod
    def from_corner_rays(origin, corner_dirs, near: float, far: float):
        """Frustum from an apex + 4 corner directions (cube-map-face
        frustums for per-face shadow culling, ref: CpuPointShadow.cs
        :116-185)."""
        origin = np.asarray(origin, np.float64)
        dirs = np.asarray(corner_dirs, np.float64)
        dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        corners = np.concatenate([origin + dirs * near, origin + dirs * far])
        axes = [np.cross(dirs[a], dirs[b]) for a, b in ((0, 1), (1, 2), (2, 3), (3, 0))]
        axes.append(np.cross(dirs[1] - dirs[0], dirs[2] - dirs[0]))  # near/far
        edges = normalize(np.concatenate([
            dirs, [corners[1] - corners[0], corners[2] - corners[1]]]))
        return Frustum(corners=corners, axes=normalize(np.stack(axes)), edges=edges)

    @staticmethod
    def from_aabb(lo, hi):
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        corners = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                            [lo[0], hi[1], lo[2]], [hi[0], hi[1], lo[2]],
                            [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                            [lo[0], hi[1], hi[2]], [hi[0], hi[1], hi[2]]])
        eye = np.eye(3)
        return Frustum(corners=corners, axes=eye.copy(), edges=eye.copy())


def convex_sat_intersect(a: Frustum, b: Frustum) -> bool:
    """Separating-axis test between two convex hulls (ref:
    Intersections.cs ConvexSATIntersect:458). Axes: both hulls' face
    normals + pairwise edge cross products."""
    cross = np.cross(a.edges[:, None, :], b.edges[None, :, :]).reshape(-1, 3)
    cross = cross[np.linalg.norm(cross, axis=-1) > 1e-9]
    for ax in np.concatenate([a.axes, b.axes, cross], axis=0):
        pa = a.corners @ ax
        pb = b.corners @ ax
        if pa.max() < pb.min() or pb.max() < pa.min():
            return False
    return True
