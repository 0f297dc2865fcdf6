"""Point-light cube shadow maps: ray-traced build + PCF lookup.
Counterpart: idkengine_tpu/render/shadowmap.py.

The reference rasterizes the scene into six D16 faces per light (ref:
Source/Render/CpuPointShadow.cs:187-195, PointShadowManager.cs:12,29-37)
and samples them with 21-tap PCF (DeferredLighting/include/Impl.glsl).
Here, as in the JAX package, each face texel's distance is a closest-hit
ray from the light centre: 6*res^2 rays through the trace entry points (the
trace kernel on the card), faces culled against the camera frustum tracing
dead rays (t_max = -1, which the kernel skips). Maps are cached per light
until the light moves or a culled face comes into view.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

MAX_POINT_SHADOWS = 128  # ref: PointShadowManager.cs:12
FAR = 3.4e38  # what a texel with no hit stores

# 20 offset directions of the cube PCF, plus the centre tap (ref: Impl.glsl
# SampleOffsetDirections); rounded to float32 from the float64 quotient, as
# the JAX package's array is
_PCF_OFFSETS = (np.array(
    [
        [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
        [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
        [1, 1, 0], [1, -1, 0], [-1, -1, 0], [-1, 1, 0],
        [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
        [0, 1, 1], [0, -1, 1], [0, -1, -1], [0, 1, -1],
    ],
    np.float32,
) / np.sqrt(3.0)).astype(np.float32)


def _normalize(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _face_dirs(face: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Cube-map (face, u, v) -> unit direction, u/v in [-1, 1]. Face order
    +X,-X,+Y,-Y,+Z,-Z (GL convention, ref: CpuPointShadow face matrices)."""
    one = torch.ones_like(u)
    dirs = torch.stack([
        torch.stack([one, -v, -u], -1),
        torch.stack([-one, -v, u], -1),
        torch.stack([u, one, v], -1),
        torch.stack([u, -one, -v], -1),
        torch.stack([u, -v, one], -1),
        torch.stack([-u, -v, -one], -1),
    ], 0)  # (6, N, 3)
    d = dirs.gather(0, face.long()[None, :, None].expand(1, -1, 3))[0]
    return _normalize(d)


def _dir_to_face_uv(d):
    """Direction -> (face, u, v) with u/v in [0,1]; inverse of _face_dirs."""
    ax, ay, az = d[..., 0].abs(), d[..., 1].abs(), d[..., 2].abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)
    face = torch.where(
        is_x, torch.where(d[..., 0] > 0, 0, 1),
        torch.where(is_y, torch.where(d[..., 1] > 0, 2, 3), torch.where(d[..., 2] > 0, 4, 5)))
    ma = torch.clamp(torch.where(is_x, ax, torch.where(is_y, ay, az)), min=1e-12)
    u = torch.where(
        is_x, torch.where(d[..., 0] > 0, -d[..., 2], d[..., 2]),
        torch.where(is_y, d[..., 0], torch.where(d[..., 2] > 0, d[..., 0], -d[..., 0])))
    v = torch.where(is_y, torch.where(d[..., 1] > 0, d[..., 2], -d[..., 2]), -d[..., 1])
    return face, (u / ma) * 0.5 + 0.5, (v / ma) * 0.5 + 0.5


@dataclass
class PointShadowMap:
    """One light's cube distance map (6, res, res) f32 (ref: D16 cubemap)."""

    light_pos: np.ndarray
    maps: torch.Tensor  # (6, res, res) distance from the light
    res: int
    face_mask: np.ndarray | None = None  # (6,) faces actually traced


def face_visibility(light_pos, camera_frustum, far: float = 1e5) -> np.ndarray:
    """Each cube face's visibility against the camera frustum by convex SAT
    (ref: CpuPointShadow.cs per-face frustum culling :116-185): (6,) bool."""
    from ..collision import Frustum, convex_sat_intersect

    vis = np.ones(6, bool)
    corner_uv = torch.tensor([[-1, -1], [1, -1], [1, 1], [-1, 1]], dtype=torch.float32)
    for f in range(6):
        face = torch.full((4,), f, dtype=torch.int32)
        dirs = _face_dirs(face, corner_uv[:, 0], corner_uv[:, 1]).numpy()
        fr = Frustum.from_corner_rays(light_pos, dirs, 1e-3, far)
        vis[f] = convex_sat_intersect(fr, camera_frustum)
    return vis


def build_point_shadow(trace_closest_fn, light_pos, res: int = 256, t_max: float = FAR,
                       face_mask=None, device="cuda") -> PointShadowMap:
    """Trace 6*res^2 texel rays from the light centre on `device` and store
    each hit distance. trace_closest_fn(o, d, t_max) -> t. face_mask:
    optional (6,) bool; culled faces trace dead rays and store FAR."""
    dev = torch.device(device)
    face = torch.arange(6, dtype=torch.int32, device=dev).repeat_interleave(res * res)
    ij = torch.arange(res * res, dtype=torch.int32, device=dev)
    uu = ((ij % res).to(torch.float32) + 0.5) / res * 2.0 - 1.0
    vv = (torch.div(ij, res, rounding_mode="floor").to(torch.float32) + 0.5) / res * 2.0 - 1.0
    d = _face_dirs(face, uu.repeat(6), vv.repeat(6)).contiguous()
    o = torch.as_tensor(np.asarray(light_pos, np.float32), device=dev).expand(d.shape).contiguous()
    tm = torch.full((d.shape[0],), t_max, dtype=torch.float32, device=dev)
    if face_mask is not None:
        keep = torch.as_tensor(np.asarray(face_mask, bool), device=dev)[face.long()]
        tm = torch.where(keep, tm, -1.0)
    t = trace_closest_fn(o, d, tm)
    dist = torch.where(t > 0, t, FAR)
    return PointShadowMap(
        light_pos=np.asarray(light_pos, np.float32), maps=dist.reshape(6, res, res), res=res,
        face_mask=np.ones(6, bool) if face_mask is None else np.asarray(face_mask, bool))


def pcf_visibility(shadow: PointShadowMap, points, radius: float = 0.02,
                   bias: float = 1.5e-2) -> torch.Tensor:
    """(R,3) world points -> (R,) visibility in [0,1]: 21-tap PCF against the
    cube distance map (ref: Impl.glsl PCF + comparison sampler,
    CpuPointShadow.cs:226-231)."""
    dev = points.device
    delta = points - torch.as_tensor(shadow.light_pos, device=dev)
    dist = torch.linalg.vector_norm(delta, dim=-1)
    base = delta / torch.clamp(dist[..., None], min=1e-12)
    offs = torch.as_tensor(np.concatenate([np.zeros((1, 3), np.float32), _PCF_OFFSETS]),
                           device=dev)
    vis = torch.zeros_like(dist)
    res = shadow.res
    for k in range(offs.shape[0]):
        face, u, v = _dir_to_face_uv(_normalize(base + offs[k] * radius))
        # truncation toward zero, as the JAX package's astype(int32)
        x = torch.clamp((u * res).to(torch.int32), 0, res - 1).long()
        y = torch.clamp((v * res).to(torch.int32), 0, res - 1).long()
        md = shadow.maps[face.long(), y, x]
        vis = vis + (dist * (1.0 - bias) <= md).to(torch.float32)
    return vis / offs.shape[0]


class PointShadowManager:
    """Holds up to MAX_POINT_SHADOWS maps; rebuilds those of moved lights
    (ref: PointShadowManager.cs:29-45 + LightManager moved-flags)."""

    def __init__(self, trace_closest_fn, res: int = 256, device="cuda"):
        self._trace = trace_closest_fn
        self.res = res
        self.device = device
        self.shadows: dict[int, PointShadowMap] = {}
        self._positions: dict[int, np.ndarray] = {}
        self.builds = 0  # maps built so far (each a trace of 6*res^2 rays)

    def update(self, light_index: int, light_pos, camera_frustum=None) -> PointShadowMap:
        pos = np.asarray(light_pos, np.float32)
        prev = self._positions.get(light_index)
        mask = None if camera_frustum is None else face_visibility(pos, camera_frustum)
        cached = self.shadows.get(light_index)
        stale = prev is None or not np.allclose(prev, pos)
        if not stale and cached is not None and mask is not None:
            # a face culled at build time is now needed -> rebuild
            stale = bool(np.any(mask & ~cached.face_mask))
        if stale:
            if len(self.shadows) >= MAX_POINT_SHADOWS and light_index not in self.shadows:
                raise ValueError(f"at most {MAX_POINT_SHADOWS} point shadows")
            self.shadows[light_index] = build_point_shadow(self._trace, pos, self.res,
                                                           face_mask=mask, device=self.device)
            self._positions[light_index] = pos
            self.builds += 1
        return self.shadows[light_index]
