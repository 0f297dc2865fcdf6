"""Plain reference of the deferred (rasterizer-mode) frame, whole frame at a
time.

It restates the renderer's frame graph from the scene data alone and imports
nothing of the program: Halton jitter, the voxelizer, the G-buffer, SSAO,
the cone-traced GI, per-light GGX with ray-traced shadows, bloom, the TAA
resolve and the AgX tonemap, each pass written again from the renderer's
description (IDKEngine's RasterPipeline.cs:264-625 as re-thought for rays:
primary visibility is a ray cast, the voxelizer is a scatter of
area-proportional point samples) with the configuration's settings, in the
renderer's order of operations, so that a float32 frame rounds as the
renderer's does. The queries run on bvh_tracer.py's tree (tracer.py's
contract). Bloom's chain, TAA's 3x3 neighbourhood and SSAO's screen-space
taps read other pixels, so every checked frame is worked out whole and the
checked pixels are taken from it.

Departures from the published passes, each the renderer's own and restated
here: SSAO compares view-space positions against screen taps along the
world-space normal's hemisphere (10 samples, radius 0.35, strength 1.3: the
renderer's settings, which its configuration does not carry); the cone
trace takes 6 fixed cones of 10 trilinear mip samples each; the voxel grid
is stored in bfloat16 on a card (rounded before the per-cell max, which
rounding's monotonicity makes the same as after) and in float32 elsewhere,
as the renderer stores it; each frame's TAA history is the frame's own
colour (renderers/deferred.py restarts it every pose) while the velocity
reprojects into the previous pose of the walk (warm-up and window frames
run consecutive poses).

The voxelizer's sample map lays its samples uniformly over the triangles'
cumulative sample counts in the order the renderer's BVH holds them, which
no description fixes; renderers/deferred.py hands that order over as
`scene.slot_triangles` (a permutation of the triangle indices, checked), and
the map is computed here from it with the renderer's arithmetic.

Shadow rays are traced only from pixels that have a surface: every pixel's
random stream is its own, so leaving the others out changes no draw, and
their colour is zero.

`dtype` is the precision of every float operation after the scene's tables
(float32 as the renderer states, bfloat16 for the control).
"""
from __future__ import annotations

import numpy as np
import torch

from .bvh_tracer import BvhTracer
from .path_tracer import (camera_vectors, cosine_hemisphere, ggx_brdf, octahedral_roundtrip,
                          rng_init, sphere_light_sample, uniform, uniform2)
from .tracer import cross, fma

PI = 3.141592653589793
SSAO_SAMPLES, SSAO_RADIUS, SSAO_STRENGTH = 10, 0.35, 1.3
CONE_STEPS = 10
AGX_IN = np.array([[0.842479062253094, 0.0423282422610123, 0.0423756549057051],
                   [0.0784335999999992, 0.878468636469772, 0.0784336],
                   [0.0792237451477643, 0.0791661274605434, 0.879142973793104]], np.float32)
AGX_OUT = np.linalg.inv(AGX_IN).astype(np.float32)
AGX_MIN_EV, AGX_MAX_EV = -12.47393, 4.026069


# -- the jitter -----------------------------------------------------------------------
def halton(i: int, base: int) -> float:
    """Radical inverse of i + 1 (the sequence skips its 0), in doubles."""
    i, f, r = i + 1, 1.0, 0.0
    while i > 0:
        f = f / base
        r = r + f * (i % base)
        i //= base
    return r


def jitter_of(frame: int) -> np.ndarray:
    """The TAA jitter of a frame: Halton(2, 3) at frame mod 16, float32."""
    k = frame % 16
    return np.array([halton(k, 2), halton(k, 3)], np.float32)


# -- the scene as the reference holds it ---------------------------------------------
def _unit_np(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-20)


class Scene:
    """The scene's tables on `device`: triangles, stored normals, face
    normals, materials, lights, the tree, the grid's bounds and the
    voxelizer's sample map."""

    def __init__(self, scene, vx: dict, device, dtype):
        pos, idx, nrm, mat = scene.concatenated()
        ti = torch.as_tensor(idx, device=device)
        p = torch.as_tensor(pos, device=device)[ti]  # (T,3,3)
        v0, v1, v2 = p[:, 0], p[:, 1], p[:, 2]
        self.p0, self.e1, self.e2 = v0, v1 - v0, v2 - v0
        g = cross(self.e1, self.e2)
        x, y, z = g.unbind(-1)
        length = torch.sqrt(fma(z, z, fma(y, y, x * x)).double()).float()
        self.gn = g / torch.clamp(length, min=1e-20)[..., None]
        # vertex normals as the renderer stores them: unit length twice over
        # (its model import and its scene build), then two snorm16 octahedral
        # coordinates
        nrm = _unit_np(_unit_np(np.asarray(nrm, np.float32) @ np.eye(3, dtype=np.float32))
                       @ np.eye(3, dtype=np.float32)).astype(np.float32)
        self.corner_n = octahedral_roundtrip(torch.as_tensor(nrm, device=device)[ti])
        self.mat = torch.as_tensor(np.asarray(mat, np.int64), device=device)
        m = scene.materials
        self.base = torch.tensor(np.array([mm.base_color[:3] for mm in m], np.float32),
                                 device=device)
        self.emis = torch.tensor(np.array([mm.emissive for mm in m], np.float32), device=device)
        self.metallic = torch.tensor(np.array([mm.metallic for mm in m], np.float32),
                                     device=device)
        self.roughness = torch.tensor(np.array([mm.roughness for mm in m], np.float32),
                                      device=device)
        self.l_pos = torch.tensor(np.array([l.position for l in scene.lights], np.float32),
                                  device=device)
        self.l_r = torch.tensor(np.array([l.radius for l in scene.lights], np.float32),
                                device=device)
        self.l_rad = torch.tensor(np.array([l.radiance for l in scene.lights], np.float32),
                                  device=device)
        # the grid: the scene's box, 0.1 wider on every side
        verts = np.asarray(pos, np.float32)[np.asarray(idx).reshape(-1)]
        self.grid_min = verts.min(0) - 0.1
        self.grid_max = verts.max(0) + 0.1
        self.sample_tri = torch.as_tensor(self._sample_map(scene, vx), device=device)
        if dtype != torch.float32:
            for k in ("p0", "e1", "e2", "gn", "corner_n", "base", "emis", "metallic",
                      "roughness", "l_pos", "l_r", "l_rad"):
                setattr(self, k, getattr(self, k).to(dtype))
        self.tracer = BvhTracer(v0, v1, v2, dtype)

    def _sample_map(self, scene, vx):
        """The triangle of each voxelizer sample: the renderer's want (ceil
        of area over a voxel's face, times the density, 1 to 64) summed in
        its slot order, the samples evenly spaced over the sum."""
        order = np.asarray(scene.slot_triangles, np.int64)
        t = self.p0.shape[0]
        if order.shape != (t,) or not np.array_equal(np.sort(order), np.arange(t)):
            raise ValueError("scene.slot_triangles is not a permutation of the triangles")
        e1 = self.e1.cpu().numpy()[order]
        e2 = self.e2.cpu().numpy()[order]
        area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        voxel = (self.grid_max - self.grid_min) / int(vx["resolution"])
        vox_area = float(np.mean(voxel)) ** 2
        want = np.clip(np.ceil(area / max(vox_area, 1e-12) * float(vx["samples_per_tri_unit"])),
                       1.0, 64.0)
        total = np.cumsum(want)
        budget = int(min(int(vx["max_samples"]), total[-1]))
        u = (np.arange(budget, dtype=np.float64) + 0.5) * (total[-1] / budget)
        return order[np.minimum(np.searchsorted(total, u, side="right"), t - 1)]


# -- the voxelizer -----------------------------------------------------------------
def voxelize(sc: Scene, vx: dict, frame: int, dt):
    """The mip chain's atlas (4, sum of R_l^3) and each level's size: each
    sample lit by every light through a shadow ray from its triangle's
    face, landed in its cell with a per-cell max."""
    dev = sc.p0.device
    res = int(vx["resolution"])
    tri = sc.sample_tri
    budget = tri.shape[0]
    state = rng_init(torch.arange(budget, device=dev), frame)
    state, uv = uniform2(state)
    uv = uv.to(dt)
    su = torch.sqrt(uv[..., 0])
    b1 = 1.0 - su
    b2 = uv[..., 1] * su
    p0, e1, e2, n = sc.p0[tri], sc.e1[tri], sc.e2[tri], sc.gn[tri]
    alb, emis = sc.base[sc.mat[tri]], sc.emis[sc.mat[tri]]
    px = p0[:, 0] + e1[:, 0] * b1 + e2[:, 0] * b2
    py = p0[:, 1] + e1[:, 1] * b1 + e2[:, 1] * b2
    pz = p0[:, 2] + e1[:, 2] * b1 + e2[:, 2] * b2
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    rr, rg, rb = emis[:, 0], emis[:, 1], emis[:, 2]
    lit, rays = [], []
    for li in range(sc.l_pos.shape[0]):
        l_pos, l_r = sc.l_pos[li], sc.l_r[li]
        tlx, tly, tlz = l_pos[0] - px, l_pos[1] - py, l_pos[2] - pz
        dist = torch.sqrt(tlx * tlx + tly * tly + tlz * tlz)
        inv = 1.0 / torch.clamp(dist, min=1e-8)
        ldx, ldy, ldz = tlx * inv, tly * inv, tlz * inv
        ndl = torch.clamp(nx * ldx + ny * ldy + nz * ldz, min=0.0)
        lit.append(ndl * (PI * l_r * l_r / torch.clamp(dist * dist, min=1e-4)))
        rays.append((torch.stack([px + nx * 1e-3, py + ny * 1e-3, pz + nz * 1e-3], -1),
                     torch.stack([ldx, ldy, ldz], -1), dist - 1e-2))
    # every light's shadow rays in one query
    occ = sc.tracer.occluded(*(torch.cat(x) for x in zip(*rays))).reshape(len(rays), -1)
    for li, ndl_att in enumerate(lit):
        l_rad = sc.l_rad[li]
        w = ndl_att * (1.0 - occ[li].to(dt)) / PI
        rr = rr + alb[:, 0] * l_rad[0] * w
        rg = rg + alb[:, 1] * l_rad[1] * w
        rb = rb + alb[:, 2] * l_rad[2] * w
    gmin = torch.as_tensor(sc.grid_min, device=dev).to(dt)
    ext = torch.as_tensor(sc.grid_max, device=dev).to(dt) - gmin

    def cell(p, axis):
        # (the integer clamps hold a coarse dtype's rounding inside the grid)
        return torch.clamp((p - gmin[axis]) / ext[axis] * res, 0, res - 1e-3).to(
            torch.int32).clamp(max=res - 1)

    cell_id = ((cell(px, 0) * res + cell(py, 1)) * res + cell(pz, 2)).long()
    vals = torch.stack([rr, rg, rb, torch.ones(budget, dtype=dt, device=dev)], 0)
    grid = torch.zeros((4, res ** 3), dtype=dt, device=dev)
    grid.scatter_reduce_(1, cell_id.expand(4, -1), vals, "amax")
    if dev.type == "cuda":  # the card's grid holds bfloat16
        grid = grid.to(torch.bfloat16).to(dt)
    mips = [grid.reshape(4, res, res, res)]
    m = mips[0]
    while m.shape[1] > 4:
        c, r = m.shape[0], m.shape[1] // 2
        m = m.reshape(c, r, 2, r, 2, r, 2).sum(dim=(2, 4, 6)) * 0.125
        mips.append(m)
    atlas = torch.cat([mm.reshape(4, -1) for mm in mips], dim=1)
    return atlas, [int(mm.shape[1]) for mm in mips]


def cone_trace(sc: Scene, vx: dict, atlas, sizes, origin, normal, frame: int, dt):
    """Diffuse GI of points (N,3): cosine-distributed cones, each marched
    front to back through trilinear samples of the mip level its
    diameter asks for, blended between two levels."""
    dev = origin.device
    res = int(vx["resolution"])
    res_levels = torch.tensor(sizes, dtype=torch.int64, device=dev)
    offsets = torch.as_tensor(np.concatenate([[0], np.cumsum([r ** 3 for r in sizes[:-1]])]),
                              dtype=torch.int64, device=dev)
    gmin = torch.as_tensor(sc.grid_min, device=dev).to(dt)
    extent = torch.as_tensor(sc.grid_max, device=dev).to(dt) - gmin
    diag = torch.linalg.vector_norm(extent)
    voxel_size = extent.mean() / res
    tan_half = float(np.tan(np.radians(float(vx["cone_aperture_deg"])) * 0.5))
    n_mips = len(sizes)

    def level(lvl, px, py, pz):
        resi = res_levels[lvl]
        resl = resi.to(dt)
        off = offsets[lvl]

        def axis(p):
            x = torch.minimum(torch.clamp(p * resl - 0.5, min=0.0), resl - 1.001)
            x0 = torch.floor(x)
            return x0.long().clamp(max=resi - 1), x - x0

        x0, fx = axis(px)
        y0, fy = axis(py)
        z0, fz = axis(pz)
        x1, y1, z1 = (torch.minimum(c + 1, resi - 1) for c in (x0, y0, z0))

        def corner(ix, iy, iz):
            return atlas[:, off + (ix * resi + iy) * resi + iz]

        c00 = corner(x0, y0, z0) * (1 - fx) + corner(x1, y0, z0) * fx
        c10 = corner(x0, y1, z0) * (1 - fx) + corner(x1, y1, z0) * fx
        c01 = corner(x0, y0, z1) * (1 - fx) + corner(x1, y0, z1) * fx
        c11 = corner(x0, y1, z1) * (1 - fx) + corner(x1, y1, z1) * fx
        c0 = c00 * (1 - fy) + c10 * fy
        c1 = c01 * (1 - fy) + c11 * fy
        return tuple(c0 * (1 - fz) + c1 * fz)

    def sample(px, py, pz, lod):
        lod = torch.clamp(lod, 0.0, n_mips - 1.001)
        lo = torch.floor(lod).long()
        f = lod - lo.to(dt)
        lo = lo.clamp(max=n_mips - 1)
        a = level(lo, px, py, pz)
        b = level(torch.clamp(lo + 1, max=n_mips - 1), px, py, pz)
        return tuple(u * (1 - f) + v * f for u, v in zip(a, b))

    n = origin.shape[0]
    ox, oy, oz = origin[:, 0], origin[:, 1], origin[:, 2]
    tr, tg, tb = (torch.zeros(n, dtype=dt, device=dev) for _ in range(3))
    state = rng_init(torch.arange(n, device=dev), frame)
    inv_ext = 1.0 / extent
    for _ in range(int(vx["cones"])):
        state, u = uniform2(state)
        cd = cosine_hemisphere(normal, u.to(dt))
        cdx, cdy, cdz = cd[:, 0], cd[:, 1], cd[:, 2]
        ar, ag, ab, occ = (torch.zeros(n, dtype=dt, device=dev) for _ in range(4))
        t = voxel_size * 2.0
        for _ in range(CONE_STEPS):
            p0 = (ox + cdx * t - gmin[0]) * inv_ext[0]
            p1 = (oy + cdy * t - gmin[1]) * inv_ext[1]
            p2 = (oz + cdz * t - gmin[2]) * inv_ext[2]
            diam = torch.clamp(2.0 * tan_half * t, min=voxel_size)
            lod = torch.log2(diam / voxel_size).expand(n)
            vr, vg, vb, va = sample(p0, p1, p2, lod)
            inb = ((p0 >= 0.0) & (p0 <= 1.0) & (p1 >= 0.0) & (p1 <= 1.0)
                   & (p2 >= 0.0) & (p2 <= 1.0)).to(dt)
            a = torch.clamp(va, 0.0, 1.0) * inb
            w = (1.0 - occ) * a
            ar = ar + w * vr * inb
            ag = ag + w * vg * inb
            ab = ab + w * vb * inb
            occ = torch.clamp(occ + (1.0 - occ) * a, max=1.0)
            t = t * 1.7 + voxel_size
            t = torch.minimum(t, diag * float(vx["max_cone_distance"]))
        tr, tg, tb = tr + ar, tg + ag, tb + ab
    k = float(vx["strength"]) / int(vx["cones"])
    return torch.stack([tr, tg, tb], -1) * k


# -- the G-buffer and the screen passes ------------------------------------------------
def _vectors(pose, fov, w, h, dev, dt):
    org, fwd, right, up = camera_vectors(pose, fov, w, h)
    return {k: torch.as_tensor(v, device=dev).to(dt)
            for k, v in zip(("origin", "forward", "right", "up"), (org, fwd, right, up))}


def _screen_xy(p, c, w, h):
    rel = p - c["origin"]
    r_ax, u_ax = c["right"], c["up"]
    z = (rel * c["forward"]).sum(-1)
    x_ndc = (rel * r_ax).sum(-1) / torch.clamp((r_ax * r_ax).sum(-1), min=1e-12)
    y_ndc = (rel * u_ax).sum(-1) / torch.clamp((u_ax * u_ax).sum(-1), min=1e-12)
    x_ndc = x_ndc / torch.clamp(z, min=1e-6)
    y_ndc = y_ndc / torch.clamp(z, min=1e-6)
    return (x_ndc * 0.5 + 0.5) * w, (0.5 - y_ndc * 0.5) * h


def gbuffer(sc: Scene, cam, prev, jitter, w, h, dt):
    """Primary rays through the jittered pixel centres: (hit mask, t, world
    position, shading normal, albedo, metallic, roughness, emissive,
    velocity in pixels), flat over the frame's pixels."""
    dev = sc.p0.device
    r = w * h
    jit = torch.as_tensor(jitter, device=dev).to(dt)
    pix = torch.arange(r, device=dev)
    x = (pix % w).to(dt) + jit[0]
    y = torch.div(pix, w, rounding_mode="floor").to(dt) + jit[1]
    u = x / w * 2.0 - 1.0
    v = 1.0 - y / h * 2.0
    d = (cam["forward"][None, :] + u[:, None] * cam["right"][None, :]
         + v[:, None] * cam["up"][None, :])
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    o = cam["origin"].expand(d.shape)
    t, tri, hu, hv = sc.tracer.closest(o, d, torch.full((r,), 3.4e38, device=dev).to(dt))
    mask = tri >= 0
    k = torch.clamp(tri, min=0)
    w_b = 1.0 - hu - hv
    n_c = sc.corner_n[k]
    ns = n_c[:, 0] * w_b[..., None] + n_c[:, 1] * hu[..., None] + n_c[:, 2] * hv[..., None]
    ns = ns / torch.clamp(torch.linalg.vector_norm(ns, dim=-1, keepdim=True), min=1e-12)
    flip = (sc.gn[k] * d).sum(-1) > 0.0
    ns = torch.where(flip[..., None], -ns, ns)
    m = sc.mat[k]
    pos = o + d * torch.clamp(t, max=1e8)[..., None]
    cx, cy = _screen_xy(pos, cam, w, h)
    qx, qy = _screen_xy(pos, prev, w, h)
    m3 = mask[..., None]
    return dict(mask=mask, depth=torch.where(mask, t, torch.inf), position=pos,
                normal=torch.where(m3, ns, 0.0), albedo=torch.where(m3, sc.base[m], 0.0),
                metallic=torch.where(mask, sc.metallic[m], 0.0),
                roughness=torch.where(mask, sc.roughness[m], 1.0),
                emissive=torch.where(m3, sc.emis[m], 0.0),
                velocity=torch.stack([qx - cx, qy - cy], -1))


def ssao(view_pos, normal, frame, dt):
    """(H,W) occlusion of view-space positions (H,W,3)."""
    h, w = view_pos.shape[0], view_pos.shape[1]
    state = rng_init(torch.arange(h * w, device=view_pos.device).reshape(h, w), frame)
    occlusion = torch.zeros((h, w), dtype=dt, device=view_pos.device)
    z = view_pos[..., 2]
    for _ in range(SSAO_SAMPLES):
        state, u = uniform2(state)
        state, u2 = uniform(state)
        dir3 = cosine_hemisphere(normal, u.to(dt))
        p = view_pos + dir3 * (SSAO_RADIUS * torch.sqrt(u2.to(dt)))[..., None]
        px = torch.nan_to_num(((p[..., 0] / -p[..., 2]) * 0.5 + 0.5) * w, nan=0.0)
        py = torch.nan_to_num((0.5 - (p[..., 1] / -p[..., 2]) * 0.5) * h, nan=0.0)
        px = torch.clamp(px, 0, w - 1).to(torch.int64).clamp(max=w - 1)
        py = torch.clamp(py, 0, h - 1).to(torch.int64).clamp(max=h - 1)
        sample_z = z[py, px]
        range_check = torch.exp(-torch.abs(z - sample_z))
        occluded = (sample_z > p[..., 2] + 0.02) & (sample_z < p[..., 2] + SSAO_RADIUS)
        occlusion = occlusion + occluded.to(dt) * range_check
    return torch.clamp(occlusion / SSAO_SAMPLES * SSAO_STRENGTH, 0.0, 1.0)


def lighting(sc: Scene, g, origin, gi, ao, settings: dict, frame: int, dt):
    """Per-light GGX with one shadow ray a light and sample, the emission,
    and the GI times albedo and (1 - AO); zero where no surface."""
    dev = sc.p0.device
    pos, n, alb = g["position"], g["normal"], g["albedo"]
    met, rough, mask = g["metallic"], g["roughness"], g["mask"]
    r = pos.shape[0]
    view = origin - pos
    view = view / torch.clamp(torch.linalg.vector_norm(view, dim=-1, keepdim=True), min=1e-8)
    state = rng_init(torch.arange(r, device=dev), frame)
    out = g["emissive"]
    samples = int(settings["deferred"]["shadow_samples"])
    lights = range(sc.l_pos.shape[0])
    rays = []  # each light's shadow rays, sample by sample, from the lit pixels
    for li in lights:
        dist = torch.linalg.vector_norm(sc.l_pos[li] - pos, dim=-1)
        for _ in range(samples):
            state, u = uniform2(state)
            sdir, _ = sphere_light_sample(pos, sc.l_pos[li], sc.l_r[li], u.to(dt))
            rays.append(((pos + n * 1e-3)[mask], sdir[mask], (dist - sc.l_r[li] - 1e-3)[mask]))
    hit = sc.tracer.occluded(*(torch.cat(x) for x in zip(*rays))).reshape(len(rays), -1)
    for li in lights:
        l_pos, l_rad, l_r = sc.l_pos[li], sc.l_rad[li], sc.l_r[li]
        to_l = l_pos - pos
        dist = torch.linalg.vector_norm(to_l, dim=-1)
        ldir = to_l / torch.clamp(dist, min=1e-8)[..., None]
        acc = torch.zeros(r, dtype=dt, device=dev)
        for k in range(samples):
            occ = torch.zeros(r, dtype=torch.bool, device=dev)
            occ[mask] = hit[li * samples + k]
            acc = acc + 1.0 - occ.to(dt)
        vis = acc / samples
        brdf_cos = ggx_brdf(n, view, ldir, alb, met, rough)
        att = PI * l_r * l_r / torch.clamp(dist * dist, min=1e-4)
        out = out + brdf_cos * l_rad * (att * vis)[..., None]
    ao_f = 1.0 - ao.reshape(r)
    out = out + gi * alb * ao_f[..., None]
    return torch.where(mask[..., None], out, 0.0)


def _tent(img):
    k = [1.0, 2.0, 1.0]
    out = torch.zeros_like(img)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out = out + torch.roll(img, (dy, dx), (0, 1)) * (k[dy + 1] * k[dx + 1] / 16.0)
    return out


def bloom(hdr, b: dict):
    """The thresholded downsample chain (2x2 box then tent, wrapping),
    accumulated back up with nearest upsamples and tents."""
    x = torch.clamp(hdr, max=float(b["max_color"]))
    luma_w = torch.tensor([0.2126, 0.7152, 0.0722], device=hdr.device).to(hdr.dtype)
    luma = (x * luma_w).sum(-1, keepdim=True)
    soft = torch.clamp(luma - float(b["threshold"]), min=0.0)
    x = x * (soft / torch.clamp(luma, min=1e-4))
    mips = [x]
    for _ in range(int(b["levels"])):
        if min(mips[-1].shape[0], mips[-1].shape[1]) < 4:
            break
        m = mips[-1]
        h2, w2 = m.shape[0] & ~1, m.shape[1] & ~1
        m = m[:h2, :w2]
        mips.append(_tent(0.25 * (m[0::2, 0::2] + m[1::2, 0::2] + m[0::2, 1::2] + m[1::2, 1::2])))
    acc = mips[-1]
    for i in range(len(mips) - 2, -1, -1):
        h, w = mips[i].shape[:2]
        rows = torch.clamp(torch.arange(h, device=hdr.device) // 2, max=acc.shape[0] - 1)
        cols = torch.clamp(torch.arange(w, device=hdr.device) // 2, max=acc.shape[1] - 1)
        acc = mips[i] + _tent(acc[rows][:, cols])
    return acc * (float(b["strength"]) / max(len(mips), 1))


def taa(color, history, velocity, depth, a: dict):
    """The resolve: velocity of the nearest of the 3x3 neighbours (reverse
    depth), the history at the reprojected point by Catmull-Rom, clamped to
    the neighbourhood's range, blended with a weight that grows with speed;
    off-screen history gives way to the colour."""
    h, w = color.shape[0], color.shape[1]
    dev = color.device
    best_d, vel = depth, velocity
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            dn = torch.roll(depth, (dy, dx), dims=(0, 1))
            vn = torch.roll(velocity, (dy, dx), dims=(0, 1))
            vel = torch.where((dn > best_d)[..., None], vn, vel)
            best_d = torch.maximum(best_d, dn)
    yy = torch.arange(h, device=dev).to(color.dtype)[:, None] + vel[..., 1]
    xx = torch.arange(w, device=dev).to(color.dtype)[None, :] + vel[..., 0]

    def weights(f):
        f2 = f * f
        f3 = f2 * f
        return (-0.5 * f3 + f2 - 0.5 * f, 1.5 * f3 - 2.5 * f2 + 1.0,
                -1.5 * f3 + 2.0 * f2 + 0.5 * f, 0.5 * f3 - 0.5 * f2)

    y0, x0 = torch.floor(yy), torch.floor(xx)
    wy, wx = weights(yy - y0), weights(xx - x0)
    y0, x0 = y0.long(), x0.long()
    hist = torch.zeros_like(history)
    for j in range(4):
        rows = torch.clamp(y0 + (j - 1), 0, h - 1)
        row = torch.zeros_like(history)
        for i in range(4):
            row = row + history[rows, torch.clamp(x0 + (i - 1), 0, w - 1)] * wx[i][..., None]
        hist = hist + row * wy[j][..., None]
    if a["clamp_history"]:
        lo, hi = color, color
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                s = torch.roll(color, (dy, dx), dims=(0, 1))
                lo, hi = torch.minimum(lo, s), torch.maximum(hi, s)
        hist = torch.minimum(torch.maximum(hist, lo), hi)
    blend = float(a["blend"])
    if a["prefer_aliasing_over_blur"]:
        speed = torch.linalg.vector_norm(vel, dim=-1, keepdim=True)
        blend = torch.clamp(blend + speed * 0.01, float(a["blend"]), 0.5)
    out = hist * (1.0 - blend) + color * blend
    off = (yy < 0) | (yy > h - 1) | (xx < 0) | (xx > w - 1)
    return torch.where(off[..., None], color, out)


def tonemap(img, tm: dict):
    """AgX: inset, log2 exposure range, the sigmoid's polynomial, outset."""
    if not tm.get("agx", True) or float(tm.get("saturation", 1.0)) != 1.0:
        raise NotImplementedError("the reference's tonemap is AgX at saturation 1")
    x = img * float(2.0 ** float(tm.get("exposure", 0.0)))
    m_in = torch.as_tensor(AGX_IN, device=img.device).to(img.dtype)
    m_out = torch.as_tensor(AGX_OUT, device=img.device).to(img.dtype)
    x = x @ m_in.T
    x = torch.clamp((torch.log2(torch.clamp(x, min=1e-10)) - AGX_MIN_EV)
                    / (AGX_MAX_EV - AGX_MIN_EV), 0.0, 1.0)
    x2 = x * x
    x4 = x2 * x2
    x = (15.5 * x4 * x2 - 40.14 * x4 * x + 31.96 * x4 - 6.868 * x2 * x
         + 0.4298 * x2 + 0.1191 * x - 0.00232)
    return torch.clamp(x @ m_out.T, 0.0, 1.0)


# -- the frame -------------------------------------------------------------------------
def frame_image(sc: Scene, config: dict, fov: float, pose, prev_pose, frame: int, dt):
    """The (H,W,3) tonemapped image of one frame."""
    s = config["settings"]
    w, h = int(config["width"]), int(config["height"])
    dev = sc.p0.device
    cam = _vectors(pose, fov, w, h, dev, dt)
    prev = _vectors(prev_pose, fov, w, h, dev, dt)
    atlas, sizes = voxelize(sc, s["vxgi"], frame, dt)
    g = gbuffer(sc, cam, prev, jitter_of(frame), w, h, dt)
    rel = g["position"] - cam["origin"]
    view_z = -(rel * cam["forward"]).sum(-1)
    view_pos = torch.stack([(rel * cam["right"]).sum(-1), (rel * cam["up"]).sum(-1), -view_z], -1)
    ao = ssao(view_pos.reshape(h, w, 3), g["normal"].reshape(h, w, 3), frame, dt)
    gi = cone_trace(sc, s["vxgi"], atlas, sizes, g["position"], g["normal"], frame, dt)
    color = lighting(sc, g, cam["origin"], gi, ao, s, frame, dt).reshape(h, w, 3)
    color = color + bloom(color, s["bloom"])
    depth = 1.0 / torch.clamp(g["depth"].reshape(h, w), min=1e-3)
    color = taa(color, color, g["velocity"].reshape(h, w, 2), depth, s["taa"])
    return tonemap(color, s["tonemap"])


def values(config: dict, traffic: dict, scene, frames, px, device, dtype=torch.float32):
    """The frames' images at pixels px (P,) int64: (F, P, 3) float32 for
    frames [(pose, frame index), ...]."""
    s = config["settings"]
    want = {"use_vxgi": True, "use_ssao": True, "use_bloom": True, "use_taa": True,
            "use_ssr": False, "use_volumetric": False, "use_oit": False,
            "use_classifier": False, "shadows": "ray_traced", "render_scale": 1}
    if any(s.get(k) != v for k, v in want.items()):
        raise NotImplementedError(f"the reference renders the frame graph of {want}")
    dev = torch.device(device)
    poses = traffic["camera"]["poses"]
    fov = float(traffic["camera"]["fov_y"])
    sc = Scene(scene, s["vxgi"], dev, dtype)
    out = []
    for pose, fi in frames:
        prev_pose = poses[(poses.index(pose) - 1) % len(poses)]
        img = frame_image(sc, config, fov, pose, prev_pose, int(fi), dtype)
        out.append(img.reshape(-1, 3)[px.to(dev)].float())
    return torch.stack(out)
