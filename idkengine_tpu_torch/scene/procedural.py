"""Procedural test/benchmark scenes (numpy). Counterpart: idkengine_tpu/scene/procedural.py.

Carried over as numpy code: the Cornell box (correctness oracle) and the
parametric atrium whose triangle budget dials the scene from Sponza (262k)
to Bistro (2.8M) class, with the mesh primitives they are made of.
`texture_atrium` (the port's own) gives an atrium the material model of a
real asset: planar UVs and generated textures, alpha-tested and blended
cloth, per-mesh overrides.
"""
from __future__ import annotations

import numpy as np

from ..utils import mathutil as mu
from .model import Material, MeshPrimitive, Model, Node, Texture

# ---------------------------------------------------------------------------
# Mesh primitives
# ---------------------------------------------------------------------------

def make_quad(p0, p1, p2, p3) -> tuple[np.ndarray, np.ndarray]:
    """Two triangles from 4 corners (ccw)."""
    verts = np.asarray([p0, p1, p2, p3], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.uint32)
    return verts, idx


def make_box(center, size) -> tuple[np.ndarray, np.ndarray]:
    c = np.asarray(center, np.float32)
    s = np.asarray(size, np.float32) * 0.5
    corners = np.array(
        [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float32
    )
    verts = c + corners * s
    faces = [
        (0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3),
    ]
    idx = []
    for a, b, cc, d in faces:
        idx += [[a, b, cc], [a, cc, d]]
    return verts, np.asarray(idx, np.uint32)


def make_uv_sphere(center, radius, n_lat=16, n_lon=32) -> tuple[np.ndarray, np.ndarray]:
    th = np.linspace(0, np.pi, n_lat + 1)
    ph = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    pts = np.stack(
        [np.sin(T) * np.cos(P), np.cos(T), np.sin(T) * np.sin(P)], axis=-1
    ).reshape(-1, 3)
    verts = (np.asarray(center, np.float32) + radius * pts).astype(np.float32)
    idx = []
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            if i > 0:
                idx.append([a, b, c])
            if i < n_lat - 1:
                idx.append([b, d, c])
    return verts, np.asarray(idx, np.uint32)


def make_cylinder(base, height, radius, n=24) -> tuple[np.ndarray, np.ndarray]:
    base = np.asarray(base, np.float32)
    ph = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = np.stack([np.cos(ph) * radius, np.zeros(n), np.sin(ph) * radius], axis=-1)
    verts = np.concatenate([base + ring, base + ring + [0, height, 0]]).astype(np.float32)
    idx = []
    for j in range(n):
        a, b = j, (j + 1) % n
        idx += [[a, b, a + n], [b, b + n, a + n]]
    return verts, np.asarray(idx, np.uint32)


def make_subdivided_plane(origin, du, dv, nu, nv, height_fn=None) -> tuple[np.ndarray, np.ndarray]:
    """Plane spanned by du/dv with (nu+1)x(nv+1) vertices; optional displacement."""
    origin = np.asarray(origin, np.float64)
    du = np.asarray(du, np.float64)
    dv = np.asarray(dv, np.float64)
    us, vs = np.meshgrid(np.linspace(0, 1, nu + 1), np.linspace(0, 1, nv + 1), indexing="ij")
    pts = origin + us[..., None] * du + vs[..., None] * dv
    if height_fn is not None:
        n = mu.normalize(np.cross(du, dv))
        pts = pts + height_fn(us, vs)[..., None] * n
    verts = pts.reshape(-1, 3).astype(np.float32)
    idx = []
    for i in range(nu):
        for j in range(nv):
            a = i * (nv + 1) + j
            idx += [[a, a + nv + 1, a + 1], [a + 1, a + nv + 1, a + nv + 2]]
    return verts, np.asarray(idx, np.uint32)


# ---------------------------------------------------------------------------
# Scenes
# ---------------------------------------------------------------------------

def cornell_box(emissive_quad: bool = True) -> Model:
    """Classic Cornell box with two boxes and an emissive ceiling light.

    BASELINE config 1: CPU BVH build + ray queries; config 2 correctness.
    emissive_quad=False drops the area light (use a sphere light instead)."""
    model = Model(name="cornell_box")
    white = Material(name="white", base_color=np.array([0.73, 0.73, 0.73, 1], np.float32))
    red = Material(name="red", base_color=np.array([0.65, 0.05, 0.05, 1], np.float32))
    green = Material(name="green", base_color=np.array([0.12, 0.45, 0.15, 1], np.float32))
    light = Material(
        name="light",
        base_color=np.array([0, 0, 0, 1], np.float32),
        emissive=np.array([15.0, 15.0, 15.0], np.float32),
    )
    model.materials = [white, red, green, light]

    parts_mat = []
    # floor / ceiling / back wall (white)
    parts_mat.append((make_quad([0, 0, 0], [556, 0, 0], [556, 0, 559], [0, 0, 559]), 0))
    parts_mat.append((make_quad([0, 548, 0], [0, 548, 559], [556, 548, 559], [556, 548, 0]), 0))
    parts_mat.append((make_quad([0, 0, 559], [556, 0, 559], [556, 548, 559], [0, 548, 559]), 0))
    # left wall red, right wall green (x=556 left in cornell data; keep simple)
    parts_mat.append((make_quad([556, 0, 0], [556, 548, 0], [556, 548, 559], [556, 0, 559]), 1))
    parts_mat.append((make_quad([0, 0, 0], [0, 0, 559], [0, 548, 559], [0, 548, 0]), 2))
    # light quad slightly below ceiling
    if emissive_quad:
        parts_mat.append((make_quad([213, 547.5, 227], [343, 547.5, 227], [343, 547.5, 332], [213, 547.5, 332]), 3))
    # short box & tall box
    parts_mat.append((make_box([185, 82.5, 169], [165, 165, 165]), 0))
    parts_mat.append((make_box([368, 165, 351], [165, 330, 165]), 0))

    for (v, i), mat in parts_mat:
        model.primitives.append(MeshPrimitive(positions=v, indices=i, material=mat))
        model.primitives[-1].ensure_normals()
    root = Node(name="root", mesh_primitives=list(range(len(model.primitives))))
    model.nodes.append(root)
    model.root_nodes.append(0)
    return model


def atrium(tri_budget: int = 262_000, seed: int = 0) -> Model:
    """Parametric colonnaded atrium: floor, walls, columns, wavy curtains and
    statues. Geometry density scales with tri_budget (Sponza-class at ~262k,
    Bistro-class at ~2.8M)."""
    rs = np.random.RandomState(seed)
    model = Model(name=f"atrium_{tri_budget}")
    stone = Material(name="stone", base_color=np.array([0.65, 0.6, 0.55, 1], np.float32), roughness=0.8)
    floor_m = Material(name="floor", base_color=np.array([0.55, 0.5, 0.45, 1], np.float32), roughness=0.6)
    cloth_r = Material(name="cloth_red", base_color=np.array([0.55, 0.1, 0.1, 1], np.float32), roughness=0.9)
    cloth_g = Material(name="cloth_green", base_color=np.array([0.1, 0.4, 0.12, 1], np.float32), roughness=0.9)
    metal = Material(name="metal", base_color=np.array([0.9, 0.85, 0.7, 1], np.float32), metallic=1.0, roughness=0.25)
    model.materials = [stone, floor_m, cloth_r, cloth_g, metal]

    # scale detail to budget
    density = max(tri_budget / 262_000.0, 0.05)
    col_n = max(int(16 * density ** 0.5), 8)
    sphere_lat = max(int(24 * density ** 0.5), 8)
    curtain_div = max(int(40 * density ** 0.5), 8)

    W, H, D = 24.0, 12.0, 60.0  # atrium dimensions (meters)
    parts: list[tuple[tuple[np.ndarray, np.ndarray], int]] = []

    # floor slab + perimeter walls + ceiling border (leave center open: skylight)
    parts.append((make_box([0, -0.25, 0], [W, 0.5, D]), 1))
    parts.append((make_box([-W / 2 - 0.25, H / 2, 0], [0.5, H, D]), 0))
    parts.append((make_box([W / 2 + 0.25, H / 2, 0], [0.5, H, D]), 0))
    parts.append((make_box([0, H / 2, -D / 2 - 0.25], [W, H, 0.5]), 0))
    parts.append((make_box([0, H / 2, D / 2 + 0.25], [W, H, 0.5]), 0))
    parts.append((make_box([-W / 2 + W / 8, H + 0.25, 0], [W / 4, 0.5, D]), 0))
    parts.append((make_box([W / 2 - W / 8, H + 0.25, 0], [W / 4, 0.5, D]), 0))

    # two colonnade rows with entablature + second-storey columns
    n_cols = max(int(10 * density ** 0.33), 6)
    zs = np.linspace(-D / 2 + 3, D / 2 - 3, n_cols)
    for storey, (y0, h) in enumerate([(0.0, 5.0), (6.0, 4.0)]):
        for x in (-W / 4, W / 4):
            for z in zs:
                parts.append((make_cylinder([x, y0, z], h, 0.45, col_n), 0))
                parts.append((make_box([x, y0 + h + 0.25, z], [1.4, 0.5, 1.4]), 0))
            parts.append((make_box([x, y0 + h + 0.75, 0], [1.6, 0.5, D - 4]), 0))

    # wavy curtains hanging between upper columns
    for k, z in enumerate(zs[:-1]):
        mat = 2 + (k % 2)
        for x in (-W / 4 + 1.0, W / 4 - 1.0):
            span = zs[k + 1] - z - 0.6
            wave = lambda u, v, ph=rs.uniform(0, 6.28): 0.25 * np.sin(6 * u + ph) * (1 - v)
            parts.append(
                (
                    make_subdivided_plane(
                        [x, 9.5, z + 0.3], [0, -4.0, 0], [0, 0, span],
                        curtain_div, curtain_div, wave,
                    ),
                    mat,
                )
            )

    # statues: subdivided spheres on pedestals down the middle
    n_statues = max(int(6 * density ** 0.5), 3)
    for z in np.linspace(-D / 2 + 6, D / 2 - 6, n_statues):
        parts.append((make_box([0, 0.5, z], [1.6, 1.0, 1.6]), 0))
        parts.append((make_uv_sphere([0, 2.0, z], 0.9, sphere_lat, 2 * sphere_lat), 4))

    # grow until budget: scatter small rocks (icosphere-ish uv spheres)
    def tri_count():
        return sum(p[0][1].shape[0] for p in parts)

    while tri_count() < tri_budget * 0.98:
        pos = [rs.uniform(-W / 2 + 1, W / 2 - 1), rs.uniform(0.1, 0.4), rs.uniform(-D / 2 + 1, D / 2 - 1)]
        r = rs.uniform(0.08, 0.35)
        parts.append((make_uv_sphere(pos, r, sphere_lat, 2 * sphere_lat), 0))

    for (v, i), mat in parts:
        prim = MeshPrimitive(positions=v, indices=i, material=mat)
        prim.ensure_normals()
        model.primitives.append(prim)
    root = Node(name="root", mesh_primitives=list(range(len(model.primitives))))
    model.nodes.append(root)
    model.root_nodes.append(0)
    return model


def _checker(size, cells, a, b):
    yy, xx = np.mgrid[:size, :size]
    on = ((yy * cells // size + xx * cells // size) % 2 == 0)[..., None]
    return np.where(on, np.asarray(a, np.uint8), np.asarray(b, np.uint8)).astype(np.uint8)


def texture_atrium(model: Model, seed: int = 0, texture_cls=Texture) -> dict[int, dict]:
    """Give an atrium (atrium()) the material model of a textured asset, in
    place: planar UVs on every primitive; an sRGB checker base colour on
    `stone` and `floor`; a metal-roughness texture on `metal`; a
    tangent-space normal map on `stone`; an emissive texture on `floor`;
    `cloth_red` alpha-tested (MASK, cutoff 0.5, an alpha checker) and
    `cloth_green` blended (BLEND, base alpha 0.5); the rest opaque. Textures
    are made from `seed` with numpy, as `texture_cls` (the Texture class of
    the model's package). Returns per-mesh overrides for
    SceneDatabase.set_mesh_shading: placement index -> fields (an emissive
    bias on the first statue, a roughness bias on the first column)."""
    rs = np.random.RandomState(seed)
    size = 256
    for prim in model.primitives:
        p = prim.positions
        prim.uvs = np.stack([p[:, 0] * 0.25 + p[:, 1] * 0.125,
                             p[:, 2] * 0.25 + p[:, 1] * 0.125], -1).astype(np.float32)
    stone = _checker(size, 8, (200, 190, 175, 255), (120, 110, 100, 255))
    floor = _checker(size, 16, (225, 215, 200, 255), (60, 55, 50, 255))
    mr = np.zeros((size, size, 4), np.uint8)
    mr[..., 1] = rs.randint(40, 256, (size // 16, size // 16)).repeat(16, 0).repeat(16, 1)
    mr[..., 2] = rs.randint(128, 256, (size // 32, size // 32)).repeat(32, 0).repeat(32, 1)
    mr[..., 3] = 255
    x = np.arange(size) * (2 * np.pi / 32)
    normal = np.zeros((size, size, 4), np.uint8)
    normal[..., 0] = (128 + 100 * np.sin(x))[None, :].astype(np.uint8)
    normal[..., 1] = (128 + 100 * np.sin(x))[:, None].astype(np.uint8)
    normal[..., 2] = 200
    normal[..., 3] = 255
    glow = np.zeros((size, size, 4), np.uint8)
    glow[..., :3] = np.where((np.arange(size) % 64 < 4)[:, None, None], 255, 0)
    glow[..., 3] = 255
    cloth = _checker(size, 16, (255, 255, 255, 255), (255, 255, 255, 0))
    textures = [("stone", stone, True), ("floor", floor, True), ("mr", mr, False),
                ("normal", normal, False), ("glow", glow, True), ("cloth", cloth, True)]
    model.textures = [texture_cls(name=n, data=d, is_srgb=srgb) for n, d, srgb in textures]
    mats = {m.name: m for m in model.materials}
    for m in model.materials:
        m.alpha_cutoff = -1.0
    mats["stone"].base_color_texture, mats["stone"].normal_texture = 0, 3
    mats["floor"].base_color_texture, mats["floor"].emissive_texture = 1, 4
    mats["floor"].emissive = np.array([0.8, 0.6, 0.3], np.float32)
    mats["metal"].metallic_roughness_texture = 2
    mats["cloth_red"].alpha_cutoff, mats["cloth_red"].base_color_texture = 0.5, 5
    mats["cloth_green"].alpha_cutoff = 0.0
    mats["cloth_green"].base_color = np.array([0.1, 0.4, 0.12, 0.5], np.float32)
    names = [m.name for m in model.materials]
    kinds = [names[p.material] for p in model.primitives]
    statue = kinds.index("metal")
    column = next(i for i, k in enumerate(kinds) if k == "stone" and i > 6)
    return {statue: dict(emissive_bias=3.0), column: dict(roughness_bias=-0.5)}
