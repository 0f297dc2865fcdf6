"""Sphere lights (numpy). Counterpart: idkengine_tpu/scene/lights.py.

Up to MAX_LIGHTS emissive spheres that the path tracer intersects
analytically and samples for next-event estimation (ref: LightManager.cs,
CpuLight.cs), with a simple Verlet-style simulation on the host
(`simulate`): gravity, drag, an optional scene collision callback and
elastic light-light response (tiny N: host math, the device gets the SoA
snapshot).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MAX_LIGHTS = 256  # ref: LightManager.cs:18
GRAVITY = np.array([0.0, -9.81, 0.0], np.float32)


@dataclass
class CpuLight:
    position: np.ndarray
    radiance: np.ndarray  # emitted radiance (color * strength)
    radius: float = 0.3
    velocity: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    has_physics: bool = False
    point_shadow_index: int = -1


class LightManager:
    def __init__(self):
        self.lights: list[CpuLight] = []

    def add(self, position, radiance, radius=0.3, velocity=None, has_physics=False) -> int:
        if len(self.lights) >= MAX_LIGHTS:
            raise ValueError(f"at most {MAX_LIGHTS} lights (ref: LightManager.cs:18)")
        self.lights.append(
            CpuLight(
                position=np.asarray(position, np.float32).copy(),
                radiance=np.asarray(radiance, np.float32).copy(),
                radius=float(radius),
                velocity=np.zeros(3, np.float32) if velocity is None else np.asarray(velocity, np.float32).copy(),
                has_physics=has_physics,
            )
        )
        return len(self.lights) - 1

    def remove(self, index: int):
        """Swap-remove (ref: LightManager.cs:129-226)."""
        self.lights[index] = self.lights[-1]
        self.lights.pop()

    def soa(self) -> dict[str, np.ndarray]:
        """SoA snapshot for device upload (positions/radii/radiance)."""
        n = len(self.lights)
        if n == 0:
            return {
                "pos": np.zeros((1, 3), np.float32),
                "radius": np.zeros((1,), np.float32),
                "radiance": np.zeros((1, 3), np.float32),
                "count": 0,
            }
        return {
            "pos": np.stack([l.position for l in self.lights]).astype(np.float32),
            "radius": np.asarray([l.radius for l in self.lights], np.float32),
            "radiance": np.stack([l.radiance for l in self.lights]).astype(np.float32),
            "count": n,
        }

    def simulate(self, dt: float, collide_fn=None):
        """Advance light physics one sub-step (ref: CpuLight.cs:40-59 +
        LightManager.cs light-light elastic collisions :237-361).

        collide_fn(position, radius, velocity) -> (position, velocity) lets
        the caller plug the scene collision routine in."""
        for l in self.lights:
            if not l.has_physics:
                continue
            l.velocity = l.velocity + GRAVITY * dt
            # drag
            l.velocity *= max(1.0 - 0.02 * dt, 0.0)
            l.position = l.position + l.velocity * dt
            if collide_fn is not None:
                l.position, l.velocity = collide_fn(l.position, l.radius, l.velocity)
        # elastic sphere-sphere response between physics lights
        n = len(self.lights)
        for i in range(n):
            for j in range(i + 1, n):
                a, b = self.lights[i], self.lights[j]
                if not (a.has_physics or b.has_physics):
                    continue
                delta = b.position - a.position
                dist = float(np.linalg.norm(delta))
                min_dist = a.radius + b.radius
                if dist < min_dist and dist > 1e-6:
                    nrm = delta / dist
                    overlap = min_dist - dist
                    a.position -= nrm * (overlap * 0.5)
                    b.position += nrm * (overlap * 0.5)
                    # exchange normal velocity components (equal mass elastic)
                    va = float(a.velocity @ nrm)
                    vb = float(b.velocity @ nrm)
                    a.velocity += (vb - va) * nrm
                    b.velocity += (va - vb) * nrm
