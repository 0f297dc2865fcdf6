"""Plain reference of a path-traced frame, pixel by pixel.

It restates the renderer's semantics from the scene data alone (the
benchmark's SceneData: vertices, vertex normals, materials, lights) and
imports nothing of the program: the camera's rays from its pose, the PCG
hash chain seeded by pixel and frame, closest-hit and occlusion queries
over every triangle (tracer.py), the analytic light spheres, the face
normal and the smooth normal from the corners' normals as the renderer
stores them (octahedral, two snorm16), the three-lobe BSDF, next-event
estimation toward one light a ray (solid-angle sampling, GGX), Beer–Lambert
absorbance, the sky gradient, Russian roulette. Each pixel's sample is
independent of the others', so any set of (frame, pixel) pairs can be
worked out alone; the renderer's ray sort only permutes rays and changes
no pixel. One sample a frame after a reset is the frame's image.

`dtype` is the precision of every float operation: float32 as the
renderer states, bfloat16 for the control.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .env import Sky
from .materials import sample, strip, tangent_frames
from .tracer import Tracer, cross, fma

TWO_PI = 6.283185307179586
_M32 = 0xFFFFFFFF


# -- PCG hash chain (ref: Random.glsl) ----------------------------------------
def pcg(x):
    x = x & _M32
    state = (x * 747796405 + 2891336453) & _M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _M32
    return (word >> 22) ^ word


def rng_init(pixel, frame):
    f = (frame & _M32) * 83492791 & _M32
    return pcg(((pixel * 19349663) & _M32) ^ f)


def to01(s):
    return (s >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform(s):
    s = pcg(s)
    return s, to01(s)


def uniform2(s):
    s1 = pcg(s)
    s2 = pcg(s1)
    return s2, torch.stack([to01(s1), to01(s2)], -1)


# -- camera --------------------------------------------------------------------
def camera_vectors(pose, fov_y, width, height):
    """(origin, forward, right, up) float32 numpy of a pose [x, y, z, yaw,
    pitch] (degrees; yaw -90 looks down -z), right and up scaled to the
    image plane at distance 1."""
    pos = np.asarray(pose[:3], np.float32)
    yaw, pitch = float(pose[3]), float(pose[4])
    cy, sy = np.cos(np.radians(yaw)), np.sin(np.radians(yaw))
    cp, sp = np.cos(np.radians(pitch)), np.sin(np.radians(pitch))
    fwd = np.array([cy * cp, sp, sy * cp], np.float32)
    r = np.cross(fwd, [0.0, 1.0, 0.0])
    right = (r / np.maximum(np.linalg.norm(r, axis=-1, keepdims=True), 1e-20)).astype(np.float32)
    up = np.cross(right, fwd).astype(np.float32)
    tan_half = np.tan(np.radians(fov_y) * 0.5)
    return (pos, fwd, (right * tan_half * (width / height)).astype(np.float32),
            (up * tan_half).astype(np.float32))


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _unit(v):
    return v / torch.clamp(_norm(v), min=1e-12)


def camera_rays(cams, px, width, height, jitter, dtype):
    """Rays of pixels px (P,) through cameras cams (P,4,3): the subpixel
    jitter, then a pinhole lens's refocus at distance 10 (the renderer's
    thin lens at radius 0)."""
    org, fwd, right, up = cams.unbind(1)
    x = (px % width).to(dtype) + jitter[:, 0]
    y = torch.div(px, width, rounding_mode="floor").to(dtype) + jitter[:, 1]
    u = fma(x, torch.full_like(x, float(np.float32(1.0 / width) * 2)), torch.full_like(x, -1.0))
    v = fma(-y, torch.full_like(y, float(np.float32(1.0 / height) * 2)), torch.full_like(y, 1.0))
    d = fwd + u[:, None] * right + v[:, None] * up
    d = d / _norm(d)
    focus = fma(d, torch.full_like(d, 10.0), org)
    d = focus - org
    return org, d / _norm(d)


# -- normals as the renderer stores them ------------------------------------------
def octahedral_roundtrip(n):
    """Unit vectors (...,3) through two snorm16 octahedral coordinates and back."""
    a = n.abs()
    n = n / torch.clamp((a[..., 0] + a[..., 1]) + a[..., 2], min=1e-20)[..., None]
    p = n[..., :2]
    wrap = (1.0 - p.flip(-1).abs()) * torch.where(p >= 0.0, 1.0, -1.0)
    p = torch.where(n[..., 2:3] >= 0.0, p, wrap)
    p = torch.round(torch.clamp(p, -1.0, 1.0) * 32767.0) / 32767.0
    x, y = p[..., 0], p[..., 1]
    z = 1.0 - x.abs() - y.abs()
    t = torch.clamp(-z, min=0.0)
    x = x + torch.where(x >= 0.0, -t, t)
    y = y + torch.where(y >= 0.0, -t, t)
    v = torch.stack([x, y, z], -1)
    return v / torch.clamp(torch.sqrt((v * v).sum(-1, keepdim=True)), min=1e-20)


# -- sampling and shading (ref: Sampling.glsl, Shading.glsl, Pbr.glsl) -----------
def _dot(a, b):
    return (a * b).sum(-1)


def onb(n):
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0]], -1)
    bt = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], -1)
    return t, bt


def cosine_hemisphere(n, u):
    t, b = onb(n)
    phi = TWO_PI * u[..., 0]
    r = torch.sqrt(u[..., 1])
    z = torch.sqrt(torch.clamp(1.0 - u[..., 1], min=0.0))
    return (t * (r * torch.cos(phi))[..., None] + b * (r * torch.sin(phi))[..., None]
            + n * z[..., None])


def sphere_light_sample(p, center, radius, u):
    to_c = center - p
    dist2 = _dot(to_c, to_c)
    dist = torch.sqrt(dist2)
    sin_max2 = torch.clamp(radius * radius / torch.clamp(dist2, min=1e-12), 0.0, 0.9999)
    cos_max = torch.sqrt(1.0 - sin_max2)
    cos_t = 1.0 - u[..., 0] * (1.0 - cos_max)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = TWO_PI * u[..., 1]
    w = to_c / torch.clamp(dist, min=1e-12)[..., None]
    t, b = onb(w)
    d = (t * (sin_t * torch.cos(phi))[..., None] + b * (sin_t * torch.sin(phi))[..., None]
         + w * cos_t[..., None])
    return d, 1.0 / (TWO_PI * torch.clamp(1.0 - cos_max, min=1e-8))


def ray_sphere(o, d, center, radius):
    oc = o - center
    b = (oc * d).sum(-1)
    c = (oc * oc).sum(-1) - radius * radius
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0, t1 = -b - sq, -b + sq
    t = torch.where(t0 > 0.0, t0, t1)
    return (disc >= 0.0) & (t > 0.0), t


def reflect(d, n):
    return d - 2.0 * _dot(d, n)[..., None] * n


def refract(d, n, eta):
    cos_i = -_dot(d, n)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    refr = eta[..., None] * d + (eta * cos_i - cos_t)[..., None] * n
    return torch.where((sin2_t > 1.0)[..., None], reflect(d, n), refr)


def sample_bsdf(d_in, n, albedo, metallic, roughness, transmission, ior, inside, u_lobe, u_dir,
                trans_tint):
    """(direction, throughput multiplier, transmissive, specular): one lobe
    of three (diffuse, specular, transmission) by Fresnel-weighted chances."""
    cos_theta = torch.clamp(-(d_in * n).sum(-1), 0.0, 1.0)
    r = (1.0 - ior) / (1.0 + ior)
    f0 = r * r
    fres = f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - cos_theta, min=0.0), 5.0)
    spec_chance = fres + metallic * (1.0 - fres)
    trans_chance = transmission * (1.0 - spec_chance)
    pick_spec = u_lobe < spec_chance
    pick_trans = (~pick_spec) & (u_lobe < spec_chance + trans_chance)
    r2 = roughness * roughness
    cos_dir = cosine_hemisphere(n, u_dir)
    spec_dir = _unit(reflect(d_in, n) * (1.0 - r2)[..., None] + cos_dir * r2[..., None])
    spec_tint = albedo * metallic[..., None] + (1.0 - metallic[..., None])
    eta = torch.where(inside, ior, 1.0 / ior)
    cos_dir_t = cosine_hemisphere(-n, u_dir.flip(-1))
    trans_dir = _unit(refract(d_in, n, eta) * (1.0 - r2)[..., None] + cos_dir_t * r2[..., None])
    direction = torch.where(pick_spec[..., None], spec_dir,
                            torch.where(pick_trans[..., None], trans_dir, cos_dir))
    tp = torch.where(pick_spec[..., None], spec_tint,
                     torch.where(pick_trans[..., None], trans_tint, albedo))
    return direction, tp, pick_trans, pick_spec


def ggx_brdf(n, v, l, albedo, metallic, roughness):
    """GGX microfacet BRDF times cos: Smith geometry, Schlick Fresnel."""
    h = _unit(v + l)
    nl = torch.clamp((n * l).sum(-1), min=0.0)
    nv = torch.clamp((n * v).sum(-1), min=1e-4)
    nh = torch.clamp((n * h).sum(-1), min=0.0)
    vh = torch.clamp((v * h).sum(-1), min=0.0)
    a = torch.clamp(roughness * roughness, min=1e-3)
    a2 = a * a
    denom = nh * nh * (a2 - 1.0) + 1.0
    ndf = a2 / torch.clamp(math.pi * denom * denom, min=1e-8)
    k = (roughness + 1.0) ** 2 / 8.0
    g = (nv / (nv * (1.0 - k) + k)) * (nl / torch.clamp(nl * (1.0 - k) + k, min=1e-8))
    f0 = 0.04 * (1.0 - metallic[..., None]) + albedo * metallic[..., None]
    f = f0 + (1.0 - f0) * torch.pow(1.0 - vh, 5.0)[..., None]
    spec = ndf[..., None] * g[..., None] * f / torch.clamp(4.0 * nv * nl, min=1e-6)[..., None]
    diffuse = (1.0 - f) * (1.0 - metallic[..., None]) * albedo / math.pi
    return (diffuse + spec) * nl[..., None]


# -- the scene as the reference holds it --------------------------------------------
SHADE_DEFAULT = (0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0)
SHADE_FIELDS = ("emissive_bias", "normal_map_strength", "specular_bias", "roughness_bias",
                "transmission_bias", "ior_bias", "absorbance_bias", "tint_on_transmissive")
ALPHA_ROUNDS = 2  # re-traces past alpha-discarded surfaces


@dataclass
class RefScene:
    tracer: Tracer
    face_n: torch.Tensor  # (T,3) unit face normals
    corner_n: torch.Tensor  # (T,3,3) corner normals as stored
    mat: torch.Tensor  # (T,) material index
    factors: torch.Tensor  # (M,13) albedo, emissive, metallic, roughness, transmission, ior, absorb
    lights: tuple  # (pos (L,3), radius (L,), radiance (L,3))
    dtype: torch.dtype
    # the material model (None for a factor-only scene)
    uv3: torch.Tensor | None = None  # (T,3,2) corner UVs
    tex: torch.Tensor | None = None  # (M,4) texture of base, metal-roughness, emissive, normal
    strips: torch.Tensor | None = None  # (N,512,1024,4) uint8
    alpha: torch.Tensor | None = None  # (M,2) alpha factor, cutoff
    tangent: torch.Tensor | None = None  # (T,2,3) tangent, bitangent as stored
    density: torch.Tensor | None = None  # (T,) UV units a world unit
    shade: torch.Tensor | None = None  # (T,10) per-part overrides
    sky: Sky | None = None
    has_textures: bool = False
    has_alpha: bool = False
    has_normal_maps: bool = False
    has_shading: bool = False


def _shade_row(fields: dict):
    row = list(SHADE_DEFAULT)
    for k, v in fields.items():
        i = SHADE_FIELDS.index(k)
        if k == "absorbance_bias":
            row[6:9] = list(v)
        elif k == "tint_on_transmissive":
            row[9] = float(bool(v))
        else:
            row[i] = float(v)
    return row


def build_scene(scene, device, dtype=torch.float32, sky_strength=1.0) -> RefScene:
    """The reference's own tables from a SceneData."""
    pos, idx, nrm, mat = scene.concatenated()
    ti = torch.as_tensor(idx, device=device)
    p = torch.as_tensor(pos, device=device)[ti]  # (T,3,3)
    v0, v1, v2 = p[:, 0], p[:, 1], p[:, 2]
    e1, e2 = v1 - v0, v2 - v0
    g = cross(e1, e2)
    x, y, z = g.unbind(-1)
    length = torch.sqrt(fma(z, z, fma(y, y, x * x)).double()).float()
    face_n = g / torch.clamp(length, min=1e-20)[..., None]
    corner_n = octahedral_roundtrip(torch.as_tensor(nrm, device=device)[ti])
    m = scene.materials
    factors = torch.tensor([[*mm.base_color[:3], *mm.emissive, mm.metallic, mm.roughness,
                             mm.transmission, mm.ior, *mm.absorbance] for mm in m],
                           dtype=torch.float32, device=device)
    lights = (torch.tensor([l.position for l in scene.lights], dtype=torch.float32, device=device),
              torch.tensor([l.radius for l in scene.lights], dtype=torch.float32, device=device),
              torch.tensor([l.radiance for l in scene.lights], dtype=torch.float32, device=device))
    rs = RefScene(tracer=Tracer(v0, v1, v2, dtype), face_n=face_n.to(dtype),
                  corner_n=corner_n.to(dtype), mat=torch.as_tensor(mat, device=device),
                  factors=factors.to(dtype), lights=tuple(t.to(dtype) for t in lights),
                  dtype=dtype)
    tex = np.array([[mm.base_color_texture, mm.metallic_roughness_texture, mm.emissive_texture,
                     mm.normal_texture] for mm in m], np.int64)
    tex = np.where(tex < len(scene.textures), tex, -1)
    rs.has_textures = bool((tex[:, :3] >= 0).any())
    rs.has_normal_maps = bool((tex[:, 3] >= 0).any())
    rs.has_alpha = any(mm.alpha_cutoff >= 0.0 and (mm.base_color[3] < 1.0 or t[0] >= 0)
                       for mm, t in zip(m, tex))
    rows = np.array([_shade_row(scene.mesh_shading.get(i, {})) for i in range(len(scene.parts))],
                    np.float32)
    rs.has_shading = bool((rows != np.asarray(SHADE_DEFAULT, np.float32)).any())
    if rs.has_textures or rs.has_normal_maps or rs.has_alpha or rs.has_shading:
        uv3 = torch.as_tensor(scene.uvs(), device=device)[ti]
        rs.uv3 = uv3.to(dtype)
        rs.tex = torch.as_tensor(tex, device=device)
        rs.strips = torch.as_tensor(np.stack([strip(t) for t in scene.textures])
                                    if scene.textures else np.zeros((1, 512, 1024, 4), np.uint8),
                                    device=device)
        rs.alpha = torch.tensor([[mm.base_color[3], mm.alpha_cutoff] for mm in m],
                                dtype=torch.float32, device=device).to(dtype)
        tan, bit, dens = tangent_frames(uv3, e1, e2, face_n)
        rs.tangent = octahedral_roundtrip(torch.stack([tan, bit], 1)).to(dtype)
        rs.density = dens.to(dtype)
        rs.shade = torch.as_tensor(rows, device=device)[
            torch.as_tensor(scene.part_of_triangle(), device=device)].to(dtype)
    if scene.env is not None:
        rs.sky = Sky(scene.env, sky_strength, device, dtype)
    return rs


def _advance(t):
    """How far an alpha re-trace moves past a discarded hit at t."""
    return fma(t, torch.full_like(t, 1.0 + 1e-5), torch.full_like(t, 1e-4))


def _alpha_keep(rs, tri, u, v, state):
    """The stochastic alpha test at each ray's hit: MASK keeps alpha >=
    cutoff, BLEND keeps with probability alpha, OPAQUE keeps; one draw a
    ray."""
    k = torch.clamp(tri, min=0)
    c = rs.uv3[k]
    w = 1.0 - u - v
    uv = torch.stack([fma(c[:, 2, 0], v, fma(c[:, 0, 0], w, c[:, 1, 0] * u)),
                      fma(c[:, 2, 1], v, fma(c[:, 0, 1], w, c[:, 1, 1] * u))], -1)
    mk = rs.mat[k]
    a, cut = rs.alpha[mk, 0], rs.alpha[mk, 1]
    if rs.has_textures:
        a = a * sample(rs.strips, rs.tex[mk, 0], uv, dtype=rs.dtype)[:, 3]
    state, u_a = uniform(state)
    keep = torch.where(cut < 0.0, True, torch.where(cut > 0.0, a >= cut, u_a.to(rs.dtype) < a))
    return state, keep


def _closest(rs, state, o, d, t_max):
    """Closest hit past alpha-discarded surfaces: (state, t from o, tri, u, v)."""
    t, tri, u, v = rs.tracer.closest(o, d, t_max)
    if not rs.has_alpha:
        return state, t, tri, u, v
    t_base = torch.zeros_like(t_max)
    o_cur = o
    settled = torch.zeros(t_max.shape, dtype=torch.bool, device=o.device)
    for _ in range(ALPHA_ROUNDS):
        state, keep = _alpha_keep(rs, tri, u, v, state)
        has = tri >= 0
        redo = has & ~keep & ~settled
        settled = settled | (has & keep)
        adv = _advance(t)
        o_cur = torch.where(redo[..., None], fma(d, adv[..., None], o_cur), o_cur)
        t_base = torch.where(redo, t_base + adv, t_base)
        t2, tri2, u2, v2 = rs.tracer.closest(o_cur, d, torch.where(redo, t_max - t_base, -1.0))
        t, tri = torch.where(redo, t2, t), torch.where(redo, tri2, tri)
        u, v = torch.where(redo, u2, u), torch.where(redo, v2, v)
    return state, t_base + t, tri, u, v


def _occluded(rs, state, o, d, t_max):
    """Occlusion past alpha-discarded surfaces: alpha rounds of closest
    queries, then an occlusion query for anything still in the way."""
    if not rs.has_alpha:
        return state, rs.tracer.occluded(o, d, t_max)
    occ = torch.zeros(t_max.shape, dtype=torch.bool, device=o.device)
    t_base = torch.zeros_like(t_max)
    o_cur = o
    active = t_max > 0.0
    for _ in range(ALPHA_ROUNDS):
        t, tri, u, v = rs.tracer.closest(o_cur, d, torch.where(active, t_max - t_base, -1.0))
        hitm = active & (tri >= 0)
        state, keep = _alpha_keep(rs, tri, u, v, state)
        occ = occ | (hitm & keep)
        active = hitm & ~keep
        adv = _advance(t)
        o_cur = torch.where(active[..., None], fma(d, adv[..., None], o_cur), o_cur)
        t_base = torch.where(active, t_base + adv, t_base)
    return state, occ | rs.tracer.occluded(o_cur, d, torch.where(active, t_max - t_base, -1.0))


def radiance(rs: RefScene, settings: dict, cams, px, frames, width, height):
    """Linear radiance (P,3) float32 of pixels px (P,) int64 in frames
    `frames` (P,) int64 (the RNG's frame index), seen through cams (P,4,3)
    (camera_vectors of each pixel's frame)."""
    dt, dev = rs.dtype, px.device
    depth = int(settings.get("ray_depth", 5))
    nee = bool(settings.get("nee", True))
    rr = bool(settings.get("russian_roulette", True))
    rr_min = int(settings.get("rr_min_bounce", 2))
    strength = float(settings.get("sky_strength", 1.0))
    mip_bias = float(settings.get("mip_bias", 0.0))
    zenith = torch.tensor(settings.get("sky_zenith", (0.45, 0.65, 1.0)), dtype=dt, device=dev)
    horizon = torch.tensor(settings.get("sky_horizon", (0.9, 0.9, 0.95)), dtype=dt, device=dev)
    l_pos, l_rad, l_emit_all = rs.lights
    n_lights = l_pos.shape[0]
    p = px.shape[0]
    big = min(3.4e38, torch.finfo(dt).max)  # the renderer's "no hit yet"
    env = rs.sky is not None  # the sky map, with next-event estimation toward it
    surf = rs.uv3 is not None

    def f(u):
        return u.to(dt)

    def sky(d):
        if env:
            return rs.sky.radiance(d)
        s = torch.clamp(d[..., 1] * 0.5 + 0.5, 0.0, 1.0)[..., None]
        return (horizon * (1.0 - s) + zenith * s) * strength

    state = rng_init(px, frames)
    state, u_pix = uniform2(state)
    state, _ = uniform2(state)  # the thin lens's draw (radius 0)
    cams = cams.to(dt)
    o, d = camera_rays(cams, px, width, height, f(u_pix), dt)
    rad = torch.zeros((p, 3), dtype=dt, device=dev)
    thr = torch.ones((p, 3), dtype=dt, device=dev)
    alive = torch.ones(p, dtype=torch.bool, device=dev)
    inside = torch.zeros(p, dtype=torch.bool, device=dev)
    last_delta = torch.ones(p, dtype=torch.bool, device=dev)
    if rs.has_textures:  # the ray cone: a pixel wide at the camera
        t_acc = torch.zeros(p, dtype=dt, device=dev)
        spread = 2.0 * torch.linalg.vector_norm(cams[:, 3], dim=-1) / height
    for bounce in range(depth):
        t_max = torch.where(alive, big, -1.0).to(dt)
        state, t, tri, hu, hv = _closest(rs, state, o, d, t_max)
        light_t = torch.full((p,), big, dtype=dt, device=dev)
        light_id = torch.full((p,), -1, dtype=torch.long, device=dev)
        for li in range(n_lights):
            lh, lt = ray_sphere(o, d, l_pos[li], l_rad[li])
            closer = lh & (lt < light_t)
            light_t = torch.where(closer, lt, light_t)
            light_id = torch.where(closer, li, light_id)
        hit_tri = alive & (tri >= 0) & (t < light_t)
        hit_light = alive & (light_id >= 0) & ~hit_tri
        miss = alive & ~hit_tri & ~hit_light
        sky_mask = (miss & last_delta) if env else miss  # NEE owns the sky's direct term
        rad = rad + torch.where(sky_mask[..., None], thr * sky(d), 0.0)
        if n_lights:
            count = hit_light & (last_delta | (not nee))
            rad = rad + torch.where(count[..., None], thr * l_emit_all[torch.clamp(light_id, min=0)],
                                    0.0)
        k = torch.clamp(tri, min=0)
        w = 1.0 - hu - hv
        cn = rs.corner_n[k]
        ns = _unit(fma(cn[:, 2], hv[..., None], fma(cn[:, 0], w[..., None],
                                                    cn[:, 1] * hu[..., None])))
        gn = rs.face_n[k]
        gn = torch.where(((gn * d).sum(-1) > 0.0)[..., None], -gn, gn)
        ns = torch.where((ns * gn).sum(-1, keepdim=True) < 0.0, -ns, ns)
        mk = rs.mat[k]
        fac = rs.factors[mk]
        albedo, emissive = fac[:, 0:3], fac[:, 3:6]
        metallic, roughness, transmission, ior = fac[:, 6], fac[:, 7], fac[:, 8], fac[:, 9]
        absorb = fac[:, 10:13]
        if surf:
            c = rs.uv3[k]
            uv = torch.stack([fma(c[:, 2, 0], hv, fma(c[:, 0, 0], w, c[:, 1, 0] * hu)),
                              fma(c[:, 2, 1], hv, fma(c[:, 0, 1], w, c[:, 1, 1] * hu))], -1)
            tx = rs.tex[mk]
        lod = None
        if rs.has_textures:
            texel = spread * (t_acc + t) * rs.density[k] * float(rs.strips.shape[1])
            lod = torch.log2(torch.clamp(texel, min=1.0)) + mip_bias
        if rs.has_normal_maps:
            tan, bit = rs.tangent[k, 0], rs.tangent[k, 1]
            tan = _unit(tan - ns * (tan * ns).sum(-1, keepdim=True))
            bit = _unit(bit - ns * (bit * ns).sum(-1, keepdim=True))
            ntan = sample(rs.strips, tx[:, 3], uv, lod, dt)[:, :3] * 2.0 - 1.0
            pert = _unit(tan * ntan[:, 0:1] + bit * ntan[:, 1:2]
                         + ns * torch.clamp(ntan[:, 2:3], min=0.05))
            pert = torch.where((pert * gn).sum(-1, keepdim=True) < 0.0, -pert, pert)
            if rs.has_shading:
                pert = _unit(ns + (pert - ns) * rs.shade[k, 1:2])
            ns = torch.where((tx[:, 3] >= 0)[..., None], pert, ns)
        if rs.has_textures:
            base, mr, em = (sample(rs.strips, tx[:, j], uv, lod, dt) for j in range(3))
            albedo = albedo * base[:, :3]
            metallic = metallic * mr[:, 2]
            roughness = roughness * mr[:, 1]
            emissive = emissive * em[:, :3]
        tint_on_trans = None
        if rs.has_shading:
            sh = rs.shade[k]
            emissive = fma(sh[:, 0:1], albedo, emissive)
            metallic = torch.clamp(metallic + sh[:, 2], 0.0, 1.0)
            roughness = torch.clamp(roughness + sh[:, 3], 0.0, 1.0)
            transmission = torch.clamp(transmission + sh[:, 4], 0.0, 1.0)
            ior = torch.clamp(ior + sh[:, 5], min=1.0)
            absorb = torch.clamp(absorb + sh[:, 6:9], min=0.0)
            tint_on_trans = sh[:, 9] > 0.5
        seg = torch.clamp(t, max=1e30)
        att = torch.exp(-absorb * torch.where(inside, seg, 0.0)[..., None])
        thr = torch.where(hit_tri[..., None], thr * att, thr)
        rad = rad + torch.where(hit_tri[..., None], thr * emissive, 0.0)
        hp = o + d * t[..., None]
        eps = 1e-4 * torch.clamp(torch.linalg.vector_norm(hp, dim=-1), min=1.0)
        if nee and n_lights:
            state, u_pick = uniform(state)
            li = torch.clamp((f(u_pick) * n_lights).long(), max=n_lights - 1)
            lp, lr, le = l_pos[li], l_rad[li], l_emit_all[li]
            state, u_l = uniform2(state)
            ldir, lpdf = sphere_light_sample(hp, lp, lr, f(u_l))
            cos_s = torch.clamp((ns * ldir).sum(-1), min=0.0)
            sh_hit, sh_t = ray_sphere(hp, ldir, lp, lr)
            do = hit_tri & (cos_s > 0.0) & sh_hit
            sh_tmax = torch.where(do, sh_t - 2.0 * eps, -1.0)
            state, occ = _occluded(rs, state, hp + gn * eps[..., None], ldir, sh_tmax)
            brdf = ggx_brdf(ns, -d, ldir, albedo, metallic, roughness)
            brdf = brdf * (1.0 - transmission)[..., None]
            contrib = thr * brdf * le / torch.clamp(lpdf, min=1e-8)[..., None] * float(n_lights)
            rad = rad + torch.where((do & ~occ)[..., None], contrib, 0.0)
        if nee and env:
            state, u_e1 = uniform(state)
            state, u_e2 = uniform(state)
            state, u_ej = uniform2(state)
            edir, epdf = rs.sky.sample(f(u_e1), f(u_e2), f(u_ej))
            cos_e = torch.clamp((ns * edir).sum(-1), min=0.0)
            do_e = hit_tri & (cos_e > 0.0) & (epdf > 0.0)
            state, occ_e = _occluded(rs, state, hp + gn * eps[..., None], edir,
                                     torch.where(do_e, big, -1.0).to(dt))
            brdf_e = ggx_brdf(ns, -d, edir, albedo, metallic, roughness)
            brdf_e = brdf_e * (1.0 - transmission)[..., None]
            contrib_e = thr * brdf_e * sky(edir) / torch.clamp(epdf, min=1e-8)[..., None]
            rad = rad + torch.where((do_e & ~occ_e)[..., None], contrib_e, 0.0)
        state, u_lobe = uniform(state)
        state, u_dir = uniform2(state)
        wants = (absorb > 0.0).any(-1) | ~inside
        if tint_on_trans is not None:
            wants = wants & tint_on_trans
        tint = torch.where(wants[..., None], albedo, 1.0)
        new_d, mul, is_trans, is_spec = sample_bsdf(d, ns, albedo, metallic, roughness,
                                                    transmission, ior, inside, f(u_lobe),
                                                    f(u_dir), tint)
        side = torch.where(is_trans[..., None], -gn, gn)
        o = torch.where(hit_tri[..., None], hp + side * eps[..., None], o)
        d = torch.where(hit_tri[..., None], new_d, d)
        thr = torch.where(hit_tri[..., None], thr * mul, thr)
        inside = torch.where(hit_tri & is_trans, ~inside, inside)
        if rs.has_textures:
            t_acc = t_acc + torch.where(hit_tri, t, 0.0)
            spread = spread + torch.where(hit_tri, 0.35 * roughness, 0.0)
        last_delta = (is_spec & (roughness < 0.15)) | is_trans
        alive = hit_tri
        if rr and bounce >= rr_min:
            keep_p = torch.clamp(thr.amax(-1), 0.02, 1.0)
            state, u_rr = uniform(state)
            thr = thr / keep_p[..., None]
            alive = alive & (f(u_rr) < keep_p)
    return rad.float()


def values(config: dict, traffic: dict, scene, frames, px, device, dtype=torch.float32):
    """The frames' images at pixels px (P,) int64: (F, P, 3) float32 for
    frames [(pose, first RNG frame index), ...], each the mean of the
    configuration's samples a frame, accumulated from a reset as the
    renderer accumulates them. A scene's sky map is taken with next-event
    estimation toward it."""
    settings = dict(config["settings"])
    if settings.get("max_trace_steps", 1 << 30) < 1 << 30:
        raise NotImplementedError("the reference walks no capped traversal")
    width, height = int(config["width"]), int(config["height"])
    spp = int(settings.get("spp_per_frame", 1))
    fov = float(traffic["camera"]["fov_y"])
    rs = build_scene(scene, device, dtype, float(settings.get("sky_strength", 1.0)))
    n_px = px.shape[0]
    cams = torch.stack([torch.as_tensor(np.stack(camera_vectors(pose, fov, width, height)))
                        for pose, _ in frames]).to(device)  # (F,4,3)
    cams = cams[:, None].expand(-1, n_px, 4, 3).reshape(-1, 4, 3)
    px_all = px.to(device).repeat(len(frames))
    first = torch.tensor([fi for _, fi in frames], dtype=torch.long, device=device)
    first = first.repeat_interleave(n_px)
    acc = None
    for k in range(spp):
        r = radiance(rs, settings, cams, px_all, first + k, width, height)
        acc = r if acc is None else (acc * k + r) / (k + 1)
    return acc.reshape(len(frames), n_px, 3)
