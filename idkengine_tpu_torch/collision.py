"""Scene collision and convex volumes (numpy, host side).
Counterpart: idkengine_tpu/collision.py.

Moving-sphere-vs-scene with sliding response (ref: Source/Shapes/
Intersections.cs:492-594 SceneVsMovingSphereCollisionRoutine): a recursive,
sub-stepped sphere sweep against box queries of the world BLAS, with the
per-triangle closest-point tests in the native C++ core (no numpy
fallback: the core is built at first use or the query raises). Consumed by
the camera and light physics (ref: Camera.cs:152-169, LightManager.cs:
237-361) through `camera_collision` and `light_collisions`.

The deferred pipeline culls each point light's cube-map faces against the
camera frustum with `Frustum` and `convex_sat_intersect` before it traces
the faces' shadow-map rays (ref: CpuPointShadow.cs:116-185).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .utils.mathutil import normalize


@dataclass
class CollisionSettings:
    """ref: Intersections.cs routine parameters."""

    test_steps: int = 4  # sweep sub-steps per recursion
    recursive_steps: int = 8  # max slide iterations
    epsilon: float = 1e-3


def scene_vs_moving_sphere(
    scene_db,
    position: np.ndarray,
    velocity_step: np.ndarray,
    radius: float,
    settings: CollisionSettings | None = None,
):
    """Move a sphere by velocity_step, sliding along scene geometry.
    Returns the final position (float32) after sliding."""
    settings = settings or CollisionSettings()
    pos = np.asarray(position, np.float64).copy()
    disp = np.asarray(velocity_step, np.float64).copy()

    for _ in range(settings.recursive_steps):
        step_len = np.linalg.norm(disp)
        if step_len < settings.epsilon * 0.01:
            break
        hit_any = False
        # substep length capped at radius/2: a substep longer than the
        # radius can carry the center THROUGH a surface, flipping the
        # contact normal and pushing the sphere out the far side
        n_sub = max(settings.test_steps,
                    int(np.ceil(step_len / max(radius * 0.5, 1e-6))))
        sub = disp / n_sub
        for _ in range(n_sub):
            new_pos = pos + sub
            # AABB around the swept sphere
            lo = np.minimum(pos, new_pos) - radius
            hi = np.maximum(pos, new_pos) + radius
            candidates = scene_db.intersect_box(lo.astype(np.float32), hi.astype(np.float32))
            if candidates.size:
                res = scene_db.blas.sphere_closest_triangle(
                    candidates, new_pos.astype(np.float32), radius
                )
                if res is not None:
                    closest, dist, local_i = res
                    # contact normal; degenerate (center on the surface) →
                    # use the triangle's face normal oriented toward travel
                    delta = new_pos - np.asarray(closest, np.float64)
                    if dist > 1e-5:
                        n = normalize(delta)
                    else:
                        tri = int(candidates[local_i])
                        vid = scene_db.blas.indices[tri]
                        a, b, c = scene_db.blas.vertices[vid].astype(np.float64)
                        n = normalize(np.cross(b - a, c - a))
                        if np.dot(n, pos - new_pos) < 0:
                            n = -n
                    penetration = radius - dist
                    pos = new_pos + n * (penetration + settings.epsilon)
                    # remove the normal component from the remaining motion
                    # (sliding plane, ref: Intersections.cs response)
                    disp = disp - np.dot(disp, n) * n
                    hit_any = True
                    break
            pos = new_pos
        if not hit_any:
            break
    return pos.astype(np.float32)


def moving_sphere_vs_sphere(p0, v0, r0, p1, v1, r1):
    """Continuous sphere-sphere collision over one step (ref:
    Intersections.cs MovingSphereVsSphere:398+): first t in [0,1] where the
    spheres touch, or None. Relative-motion quadratic."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    s = p1 - p0
    v = np.asarray(v1, np.float64) - np.asarray(v0, np.float64)
    r = float(r0) + float(r1)
    c0 = s @ s - r * r
    if c0 < 0.0:
        return 0.0  # already overlapping
    a = v @ v
    if a < 1e-20:
        return None
    b = v @ s
    if b >= 0.0:
        return None  # separating
    disc = b * b - a * c0
    if disc < 0.0:
        return None
    t = (-b - np.sqrt(disc)) / a
    return float(t) if 0.0 <= t <= 1.0 else None


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


def camera_collision(scene_db, camera, dt: float):
    """Advance the camera with collision response
    (ref: Camera.cs CollisionDetection:152-169)."""
    step = camera.velocity * dt
    new_pos = scene_vs_moving_sphere(
        scene_db, camera.position, step, camera.collision_radius
    )
    camera.position = new_pos
    return camera


def light_collisions(scene_db, light_manager, dt: float):
    """Simulate lights with scene collision + elastic light-light response
    (ref: LightManager.cs:237-361)."""

    def collide(pos, radius, vel):
        step = vel * dt
        new_pos = scene_vs_moving_sphere(scene_db, pos, step, radius)
        moved = new_pos - pos
        # reflect: kill velocity into surfaces (approximate restitution 0.4)
        if np.linalg.norm(moved - step) > 1e-5:
            vel = vel * 0.6
        return new_pos, vel

    light_manager.simulate(dt, collide_fn=collide)
