"""VXGI: voxelized global illumination — voxelize + mips + cone tracing.
Counterpart: idkengine_tpu/render/vxgi.py.

The reference's VXGI (ref: Source/Render/VXGI/Voxelizer/Voxelizer.cs +
Resource/Shaders/VXGI/Voxelize/** and ConeTracing/ConeTracer.cs +
include/TraceCone.glsl), as the JAX package re-designed it:

  - The rasterizing voxelizer (imageAtomicMax, Voxelizer.cs:109-208)
    becomes scatter voxelization: every triangle is point-sampled in
    proportion to its area, each sample's shadowed direct radiance is
    computed, and the samples land in the grid with a per-voxel max through
    `ops.voxel_scatter.scatter_max_dense` (the CUDA kernel on the card,
    values rounded to bf16 as the reference's rgba16f grid and the JAX
    package on its accelerator store them; the plain f32 version on the CPU,
    as the JAX package computes there).
  - The mip chain (Voxelizer.cs:210-228) is 2x2x2 average pooling on the
    channel-first (4,R,R,R) grid, flattened into one atlas.
  - Cone tracing (TraceCone.glsl:5-39) is the front-to-back trilinear
    mip-march over all query points.

Two faults of the JAX package are not copied: its sample assignment is
cached under `id()` of a scene array, which a rebuilt scene can reuse; here
the cache holds the scene object itself. And its occlusion callback is a
static argument of a compiled function that can keep an old scene; here it
is a plain argument of every call, so it traces the scene it is given.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import voxel_scatter
from ..utils import rng as rng_mod
from . import sampling

_PI = 3.141592653589793


@dataclass(frozen=True)
class VxgiSettings:
    """ref: Voxelizer/ConeTracer settings surfaces."""

    resolution: int = 128  # grid size per axis (reference default 256)
    # samples per voxel area of triangle: 1.0 matches the reference's
    # raster-injection density (one fragment per covered voxel)
    samples_per_tri_unit: float = 1.0
    max_samples: int = 1 << 20
    cones: int = 6
    cone_aperture_deg: float = 32.0
    max_cone_distance: float = 0.6  # fraction of grid diagonal
    strength: float = 1.0


def _mips_atlas(radiance):
    """Mip chain + flattened atlas from the (4,R,R,R) radiance grid: each
    level averages 2x2x2 blocks of the one above (ref: Voxelizer.cs:210-228)."""
    mips = [radiance]
    m = radiance
    while m.shape[1] > 4:
        c, r = m.shape[0], m.shape[1] // 2
        m = m.reshape(c, r, 2, r, 2, r, 2).sum(dim=(2, 4, 6)) * 0.125
        mips.append(m)
    atlas = torch.cat([mm.reshape(4, -1) for mm in mips], dim=1)
    return tuple(mips), atlas


def _inject(tri, tri_p0, tri_e1, tri_e2, tri_gn, tri_mat, mat_base, mat_emis, lights,
            grid_min, grid_max, frame, res: int, n_lights: int, occlusion_fn=None):
    """The voxelizer's updates: one sample per entry of `tri`, lit by every
    light (shadowed through occlusion_fn(o, d, t_max) -> bool occluded, or
    unshadowed when None). Returns (cell id (N,) int32 in [0, res^3),
    values (4, N) float32: rgb radiance and opacity 1)."""
    dev = tri_p0.device
    budget = tri.shape[0]
    state = rng_mod.init_state(torch.arange(budget, device=dev), frame)
    state, uv = rng_mod.uniform2(state)
    su = torch.sqrt(uv[..., 0])
    b1 = 1.0 - su
    b2 = uv[..., 1] * su
    # one row gather of all per-sample attributes
    mat_tbl = torch.cat([mat_base, mat_emis], dim=1)
    packed = torch.cat([tri_p0, tri_e1, tri_e2, tri_gn, mat_tbl[tri_mat.long()]], dim=1)
    g = packed[tri]
    px = g[:, 0] + g[:, 3] * b1 + g[:, 6] * b2
    py = g[:, 1] + g[:, 4] * b1 + g[:, 7] * b2
    pz = g[:, 2] + g[:, 5] * b1 + g[:, 8] * b2
    nx, ny, nz = g[:, 9], g[:, 10], g[:, 11]
    ar, ag, ab = g[:, 12], g[:, 13], g[:, 14]

    # direct lighting at each sample (shadowed, all lights)
    rr, rg, rb = g[:, 15], g[:, 16], g[:, 17]
    for li in range(n_lights):
        l_pos = lights["pos"][li]
        l_rad = lights["radiance"][li]
        l_r = lights["radius"][li]
        tlx, tly, tlz = l_pos[0] - px, l_pos[1] - py, l_pos[2] - pz
        dist = torch.sqrt(tlx * tlx + tly * tly + tlz * tlz)
        inv = 1.0 / torch.clamp(dist, min=1e-8)
        ldx, ldy, ldz = tlx * inv, tly * inv, tlz * inv
        ndl = torch.clamp(nx * ldx + ny * ldy + nz * ldz, min=0.0)
        att = _PI * l_r * l_r / torch.clamp(dist * dist, min=1e-4)
        vis = 1.0
        if occlusion_fn is not None:
            o = torch.stack([px + nx * 1e-3, py + ny * 1e-3, pz + nz * 1e-3], -1)
            d = torch.stack([ldx, ldy, ldz], -1)
            occ = occlusion_fn(o, d, dist - 1e-2)
            vis = 1.0 - occ.to(torch.float32)
        w = ndl * att * vis / _PI
        rr = rr + ar * l_rad[0] * w
        rg = rg + ag * l_rad[1] * w
        rb = rb + ab * l_rad[2] * w

    # each sample's cell of the grid
    ext = grid_max - grid_min

    def cell(p, axis):
        return torch.clamp((p - grid_min[axis]) / ext[axis] * res, 0, res - 1e-3).to(torch.int32)

    cell_id = ((cell(px, 0) * res + cell(py, 1)) * res + cell(pz, 2)).contiguous()
    vals = torch.stack([rr, rg, rb, torch.ones(budget, device=dev)], 0)
    return cell_id, vals


def _sample_assignment(scene, grid_min, grid_max, s: VxgiSettings) -> np.ndarray:
    """Deterministic area-proportional sample -> triangle map, on the host:
    samples uniformly spaced in cumulative-area space, so the map is one
    monotone searchsorted."""
    t = scene.tri_p0.shape[0]
    e1 = scene.tri_e1.cpu().numpy()
    e2 = scene.tri_e2.cpu().numpy()
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    voxel = (grid_max - grid_min) / s.resolution
    vox_area = float(np.mean(voxel)) ** 2
    want = np.clip(np.ceil(area / max(vox_area, 1e-12) * s.samples_per_tri_unit), 1.0, 64.0)
    total = np.cumsum(want)
    budget = int(min(s.max_samples, total[-1]))
    u = (np.arange(budget, dtype=np.float64) + 0.5) * (total[-1] / budget)
    return np.minimum(np.searchsorted(total, u, side="right"), t - 1)


class VoxelGrid:
    """World-aligned radiance grid (ref: rgba16f 3D texture, UBO 7 params)
    on `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, grid_min, grid_max, settings: VxgiSettings = VxgiSettings(),
                 device="cuda"):
        self.settings = settings
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._min_np = np.asarray(grid_min, np.float32)
        self._max_np = np.asarray(grid_max, np.float32)
        self.grid_min = torch.as_tensor(self._min_np, device=self.device)
        self.grid_max = torch.as_tensor(self._max_np, device=self.device)
        self.radiance = None  # (4,R,R,R) f32 — rgb + opacity, channel-first
        self.mips: list = []
        self._atlas = None  # (4, sum R_l^3) flattened mip chain
        self._res_levels = None
        self._offsets = None
        # sample -> triangle map, cached per (scene object, settings); the
        # key holds the scene itself, so a rebuilt scene never meets a stale map
        self._assign_key = None
        self._tri_assign = None

    # ------------------------------------------------------------------
    def updates(self, scene, mats, lights, n_lights: int, frame=0, occlusion_fn=None):
        """The voxelize pass's scatter input: (cell id (N,) int32, values
        (4,N) float32) of the frame's samples (see `voxelize`)."""
        if scene.device != self.device:
            raise ValueError(f"scene is on {scene.device}, the voxel grid on {self.device}")
        s = self.settings
        key = self._assign_key
        if key is None or key[0] is not scene or key[1] != s:
            tri_np = _sample_assignment(scene, self._min_np, self._max_np, s)
            self._tri_assign = torch.from_numpy(tri_np).to(self.device)
            self._assign_key = (scene, s)
        return _inject(self._tri_assign, scene.tri_p0, scene.tri_e1, scene.tri_e2, scene.tri_gn,
                       scene.tri_mat, mats["base_color"][:, :3], mats["emissive"][:, :3],
                       lights, self.grid_min, self.grid_max, frame, s.resolution, n_lights,
                       occlusion_fn)

    def voxelize(self, scene, mats, lights, n_lights: int, frame=0, occlusion_fn=None):
        """Scatter-voxelize direct lighting into the grid: sample, light,
        scatter-max, mips, atlas.

        scene: SceneArrays on the grid's device; mats/lights: dicts of
        tensors there; occlusion_fn(o, d, t_max) -> bool occluded, tracing
        `scene` (for shadowed injection). Returns the (4,R,R,R) grid."""
        res = self.settings.resolution
        cell_id, vals = self.updates(scene, mats, lights, n_lights, frame, occlusion_fn)
        grid = voxel_scatter.scatter_max_dense(cell_id, vals, res ** 3,
                                               bf16=self.device.type == "cuda")
        self.radiance = grid.reshape(4, res, res, res)
        mips, self._atlas = _mips_atlas(self.radiance)
        self.mips = list(mips)
        self._set_mip_tables()
        return self.radiance

    # ------------------------------------------------------------------
    def _set_mip_tables(self):
        sizes = [int(m.shape[1]) for m in self.mips]
        self._res_levels = torch.tensor(sizes, dtype=torch.int64, device=self.device)
        offsets = np.concatenate([[0], np.cumsum([r ** 3 for r in sizes[:-1]])])
        self._offsets = torch.as_tensor(offsets, dtype=torch.int64, device=self.device)

    # ------------------------------------------------------------------
    def _sample_level(self, lvl, px, py, pz):
        """Trilinear sample at per-sample mip level `lvl` (int (N,)); p in
        [0,1]^3 as 1-D component tensors. Returns (r,g,b,a) 1-D tensors."""
        resi = self._res_levels[lvl]
        resl = resi.to(torch.float32)
        off = self._offsets[lvl]

        def axis(p):
            x = torch.minimum(torch.clamp(p * resl - 0.5, min=0.0), resl - 1.001)
            x0 = torch.floor(x)
            return x0.long(), x - x0

        x0, fx = axis(px)
        y0, fy = axis(py)
        z0, fz = axis(pz)
        x1 = torch.minimum(x0 + 1, resi - 1)
        y1 = torch.minimum(y0 + 1, resi - 1)
        z1 = torch.minimum(z0 + 1, resi - 1)

        def corner(ix, iy, iz):
            return self._atlas[:, off + (ix * resi + iy) * resi + iz]  # (4,N)

        c00 = corner(x0, y0, z0) * (1 - fx) + corner(x1, y0, z0) * fx
        c10 = corner(x0, y1, z0) * (1 - fx) + corner(x1, y1, z0) * fx
        c01 = corner(x0, y0, z1) * (1 - fx) + corner(x1, y0, z1) * fx
        c11 = corner(x0, y1, z1) * (1 - fx) + corner(x1, y1, z1) * fx
        c0 = c00 * (1 - fy) + c10 * fy
        c1 = c01 * (1 - fy) + c11 * fy
        return tuple(c0 * (1 - fz) + c1 * fz)

    def sample_lod(self, p01, lod):
        """Sample with continuous LOD (lerp of the two bracketing levels).

        p01: (...,3) in [0,1]; lod: (...) float. Returns (...,4)."""
        shape = p01.shape[:-1]
        out = self._sample_lod_soa(p01[..., 0].reshape(-1), p01[..., 1].reshape(-1),
                                   p01[..., 2].reshape(-1), lod.reshape(-1))
        return torch.stack(out, -1).reshape(shape + (4,))

    def _sample_lod_soa(self, px, py, pz, lod):
        n_mips = len(self.mips)
        lod = torch.clamp(lod, 0.0, n_mips - 1.001)
        lo = torch.floor(lod).long()
        f = lod - lo.to(torch.float32)
        v0 = self._sample_level(lo, px, py, pz)
        v1 = self._sample_level(torch.clamp(lo + 1, max=n_mips - 1), px, py, pz)
        return tuple(a * (1 - f) + b * f for a, b in zip(v0, v1))

    # ------------------------------------------------------------------
    def cone_trace(self, origin, normal, frame=0):
        """Diffuse cone-traced GI for shade points (ref: TraceCone.glsl +
        ConeTraceGI Impl.glsl:26-76): N cones on the hemisphere, LOD from
        cone diameter, front-to-back alpha compositing."""
        s = self.settings
        res = s.resolution
        extent = self.grid_max - self.grid_min
        diag = torch.linalg.vector_norm(extent)
        voxel_size = extent.mean() / res
        tan_half = float(np.tan(np.radians(s.cone_aperture_deg) * 0.5))

        n_pts = origin.shape[0]
        dev = origin.device
        ox, oy, oz = origin[:, 0], origin[:, 1], origin[:, 2]
        tr = torch.zeros(n_pts, device=dev)
        tg = torch.zeros(n_pts, device=dev)
        tb = torch.zeros(n_pts, device=dev)
        state = rng_mod.init_state(torch.arange(n_pts, device=dev), frame)
        n_steps = 10
        inv_ext = 1.0 / extent
        for _ in range(s.cones):
            state, u = rng_mod.uniform2(state)
            # stratified cosine cones around the normal
            cone_dir = sampling.cosine_hemisphere(normal, u)
            cdx, cdy, cdz = cone_dir[:, 0], cone_dir[:, 1], cone_dir[:, 2]
            ar = torch.zeros(n_pts, device=dev)
            ag = torch.zeros(n_pts, device=dev)
            ab = torch.zeros(n_pts, device=dev)
            occ = torch.zeros(n_pts, device=dev)
            t = voxel_size * 2.0
            for _ in range(n_steps):
                p0 = (ox + cdx * t - self.grid_min[0]) * inv_ext[0]
                p1 = (oy + cdy * t - self.grid_min[1]) * inv_ext[1]
                p2 = (oz + cdz * t - self.grid_min[2]) * inv_ext[2]
                diam = torch.clamp(2.0 * tan_half * t, min=voxel_size)
                lod = torch.log2(diam / voxel_size).expand(n_pts)
                vr, vg, vb, va = self._sample_lod_soa(p0, p1, p2, lod)
                inb = ((p0 >= 0.0) & (p0 <= 1.0) & (p1 >= 0.0) & (p1 <= 1.0)
                       & (p2 >= 0.0) & (p2 <= 1.0)).to(torch.float32)
                a = torch.clamp(va, 0.0, 1.0) * inb
                w = (1.0 - occ) * a
                ar = ar + w * vr * inb
                ag = ag + w * vg * inb
                ab = ab + w * vb * inb
                occ = torch.clamp(occ + (1.0 - occ) * a, max=1.0)
                t = t * 1.7 + voxel_size
                t = torch.minimum(t, diag * s.max_cone_distance)
            tr, tg, tb = tr + ar, tg + ag, tb + ab
        k = s.strength / s.cones
        return torch.stack([tr, tg, tb], -1) * k
