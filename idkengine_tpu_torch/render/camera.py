"""Camera: FPS state (numpy) + thin-lens ray generation (torch).
Counterpart: idkengine_tpu/render/camera.py.

Host-side state mirrors the reference camera (ref: Source/Camera.cs); ray
generation is the path tracer's camera ray setup
(ref: PathTracing/FirstHit/compute.glsl:55-61 thin-lens DoF); the view and
projection matrices and the frustum serve the deferred pipeline's shadow-map
culling. The movement physics (`process_inputs`, `advance_simulation`: the
reference's velocity, impulse and drag, Camera.cs:122-150) serves the
engine's update, with collision through collision.camera_collision.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.intersect import fma
from ..profiling import pass_scope
from ..utils import mathutil as mu


@dataclass
class Camera:
    position: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.8, 5.0], np.float32))
    yaw: float = -90.0  # degrees, looking -z
    pitch: float = 0.0
    fov_y: float = 60.0  # degrees
    near: float = 0.05
    # thin lens
    focal_distance: float = 10.0
    lens_radius: float = 0.0
    # physics (ref: Camera.cs:122-150)
    velocity: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    mass: float = 1.0
    drag: float = 6.0
    speed: float = 6.0
    collision_radius: float = 0.35

    @property
    def forward(self) -> np.ndarray:
        cy, sy = np.cos(np.radians(self.yaw)), np.sin(np.radians(self.yaw))
        cp, sp = np.cos(np.radians(self.pitch)), np.sin(np.radians(self.pitch))
        return np.array([cy * cp, sp, sy * cp], np.float32)

    @property
    def right(self) -> np.ndarray:
        f = self.forward
        return mu.normalize(np.cross(f, [0.0, 1.0, 0.0])).astype(np.float32)

    @property
    def up(self) -> np.ndarray:
        return np.cross(self.right, self.forward).astype(np.float32)

    def view_matrix(self) -> np.ndarray:
        return mu.look_at(self.position, self.position + self.forward, np.array([0, 1, 0.0]))

    def projection_matrix(self, aspect: float) -> np.ndarray:
        return mu.perspective_reverse_z(np.radians(self.fov_y), aspect, self.near)

    def frustum(self, width: int, height: int, far: float = 1e4):
        """Camera frustum as a convex SAT volume (ref: Frustum.cs; used for
        per-face shadow culling at CpuPointShadow.cs:116-185). Reverse-Z has
        an infinite far plane, so culling uses a finite `far` cap."""
        from ..collision import Frustum

        aspect = width / height
        tan_half = np.tan(np.radians(self.fov_y) * 0.5)
        r = self.right * tan_half * aspect
        u = self.up * tan_half
        f = self.forward
        corner_dirs = np.stack([f - r - u, f + r - u, f + r + u, f - r + u])
        return Frustum.from_corner_rays(self.position, corner_dirs, self.near, far)

    def process_inputs(self, move: np.ndarray, dt: float, look: tuple[float, float] = (0, 0)):
        """Apply look deltas + acceleration impulses (ref: Camera.cs ProcessInputs)."""
        self.yaw += look[0]
        self.pitch = float(np.clip(self.pitch + look[1], -89.0, 89.0))
        acc = (
            self.right * move[0] + np.array([0, 1, 0], np.float32) * move[1] + self.forward * move[2]
        )
        norm = np.linalg.norm(acc)
        if norm > 1e-6:
            self.velocity = self.velocity + (acc / norm) * self.speed * dt * self.drag

    def advance_simulation(self, dt: float):
        """Velocity-Verlet-ish integration with drag (ref: Camera.cs:122-150)."""
        self.position = self.position + self.velocity * dt
        self.velocity = self.velocity * max(1.0 - self.drag * dt, 0.0)

    def ray_params(self, width: int, height: int) -> dict:
        """Static per-frame camera basis for raygen (float32 numpy vectors)."""
        aspect = width / height
        tan_half = np.tan(np.radians(self.fov_y) * 0.5)
        return {
            "origin": np.asarray(self.position, np.float32),
            "forward": self.forward,
            "right": (self.right * tan_half * aspect).astype(np.float32),
            "up": (self.up * tan_half).astype(np.float32),
            "focal_distance": np.float32(self.focal_distance),
            "lens_radius": np.float32(self.lens_radius),
        }


def generate_rays(params: dict, width: int, height: int, jitter: torch.Tensor,
                  lens_u: torch.Tensor | None = None, fused: bool = False,
                  pixels: torch.Tensor | None = None):
    """Primary ray batch (R=W*H,3) on jitter's device, ray i for pixel i;
    or, with `pixels` (R,) pixel indices, ray i for pixel pixels[i].
    jitter: (2,) or (R,2) subpixel offset in [0,1); lens_u: (R,2) uniforms
    for thin-lens DoF or None.

    The JAX package runs this function op by op in its G-buffer and under
    jit in its path tracer, and XLA:CPU rounds the two differently; so does
    the port. `fused` rounds as the jit does: the divisions by the width and
    height become products by their rounded reciprocals, constants fold,
    and each product fuses into the addition after it (also the thin lens's
    refocus). Each form is bit-equal to its counterpart without a lens.
    With one, the lens angle's sine and cosine round as ATen's do, which
    is not as XLA:CPU's (the C library's sinf and cosf): about 1% of them
    differ in the last place, the lens offset by at most two units in the
    last place of the lens radius (tests/test_torch_lens.py, which also
    holds a path-traced lens image to the JAX package's)."""
    dev = jitter.device
    # four blocking host-to-device copies (the span pt/camera upload)
    with pass_scope("pt/camera upload"):
        vec = {k: torch.as_tensor(params[k], dtype=torch.float32, device=dev)
               for k in ("origin", "forward", "right", "up")}
    px = torch.arange(width * height, device=dev) if pixels is None else pixels
    x = (px % width).to(torch.float32) + jitter[..., 0]
    y = torch.div(px, width, rounding_mode="floor").to(torch.float32) + jitter[..., 1]
    if fused:
        u = fma(x, torch.full_like(x, np.float32(1.0 / width) * 2), torch.full_like(x, -1.0))
        v = fma(-y, torch.full_like(y, np.float32(1.0 / height) * 2), torch.full_like(y, 1.0))
    else:
        u = x / width * 2.0 - 1.0
        v = 1.0 - y / height * 2.0
    d = vec["forward"][None, :] + u[:, None] * vec["right"][None, :] + v[:, None] * vec["up"][None, :]
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    o = vec["origin"].expand(d.shape)
    if lens_u is not None:
        # thin-lens: jitter origin on aperture disk, refocus at focal plane
        # (ref: FirstHit/compute.glsl:55-61)
        r = torch.sqrt(lens_u[..., 0]) * float(params["lens_radius"])
        phi = 2.0 * np.pi * lens_u[..., 1]
        right_n = vec["right"] / torch.linalg.vector_norm(vec["right"])
        up_n = vec["up"] / torch.linalg.vector_norm(vec["up"])
        offset = (right_n[None, :] * (r * torch.cos(phi))[:, None]
                  + up_n[None, :] * (r * torch.sin(phi))[:, None])
        fd = float(params["focal_distance"])
        focus = fma(d, torch.full_like(d, fd), o) if fused else o + d * fd
        o = o + offset
        d = focus - o
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return o.contiguous(), d.contiguous()
