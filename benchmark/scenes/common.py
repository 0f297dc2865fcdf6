"""The scene data a renderer is given, made by the benchmark from the seed.

Both sides take it as it is: the program through its own model and scene
build (renderers/), the plain reference (reference/) from these arrays.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Material:
    """A material's factors, in the fields of a glTF metal-roughness material."""

    name: str
    base_color: tuple = (1.0, 1.0, 1.0, 1.0)
    emissive: tuple = (0.0, 0.0, 0.0)
    metallic: float = 0.0
    roughness: float = 1.0
    ior: float = 1.5
    transmission: float = 0.0
    absorbance: tuple = (0.0, 0.0, 0.0)
    alpha_cutoff: float = -1.0  # -1 opaque, 0 blend, > 0 mask
    # texture indices into SceneData.textures, -1 for none
    base_color_texture: int = -1
    metallic_roughness_texture: int = -1
    normal_texture: int = -1
    emissive_texture: int = -1


@dataclass
class Part:
    """One mesh: positions and smooth vertex normals (V,3) float32, indices
    (T,3) uint32, one material."""

    positions: np.ndarray
    indices: np.ndarray
    normals: np.ndarray
    material: int
    uvs: np.ndarray | None = None  # (V,2) float32


@dataclass
class Light:
    position: tuple
    radiance: tuple
    radius: float


@dataclass
class Texture:
    """An RGBA8 image (H,W,4) uint8; sRGB colour channels where `srgb`."""

    name: str
    data: np.ndarray
    srgb: bool


@dataclass
class SceneData:
    parts: list
    materials: list
    lights: list = field(default_factory=list)
    textures: list = field(default_factory=list)
    # per-part shading overrides: part index -> {field: value} of the
    # renderer's MeshShading (emissive_bias, normal_map_strength,
    # specular_bias, roughness_bias, ...)
    mesh_shading: dict = field(default_factory=dict)
    env: np.ndarray | None = None  # equirect (H,W,3) float32 radiance

    @property
    def n_triangles(self) -> int:
        return sum(p.indices.shape[0] for p in self.parts)

    def concatenated(self):
        """(positions (V,3), indices (T,3) int64 into them, normals (V,3),
        material of each triangle (T,)) of all parts, in part order."""
        offs = np.cumsum([0] + [p.positions.shape[0] for p in self.parts])
        pos = np.concatenate([p.positions for p in self.parts])
        nrm = np.concatenate([p.normals for p in self.parts])
        idx = np.concatenate([p.indices.astype(np.int64) + o for p, o in zip(self.parts, offs)])
        mat = np.concatenate([np.full(p.indices.shape[0], p.material, np.int64)
                              for p in self.parts])
        return pos, idx, nrm, mat

    def uvs(self) -> np.ndarray:
        """(V,2) vertex UVs of all parts (zeros where a part has none)."""
        return np.concatenate([p.uvs if p.uvs is not None
                               else np.zeros((p.positions.shape[0], 2), np.float32)
                               for p in self.parts])

    def part_of_triangle(self) -> np.ndarray:
        return np.concatenate([np.full(p.indices.shape[0], i, np.int64)
                               for i, p in enumerate(self.parts)])


def smooth_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals: each face's cross product added to its
    corners, corner by corner in face order, then normalized."""
    n = np.zeros_like(positions)
    p = positions[indices]
    fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    for k in range(3):
        np.add.at(n, indices[:, k], fn)
    return unit(n).astype(np.float32)


def unit(v: np.ndarray) -> np.ndarray:
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-20)


def box(center, size):
    c = np.asarray(center, np.float32)
    s = np.asarray(size, np.float32) * 0.5
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
                       np.float32)
    faces = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    idx = []
    for a, b, cc, d in faces:
        idx += [[a, b, cc], [a, cc, d]]
    return c + corners * s, np.asarray(idx, np.uint32)


def cylinder(base, height, radius, n):
    base = np.asarray(base, np.float32)
    ph = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = np.stack([np.cos(ph) * radius, np.zeros(n), np.sin(ph) * radius], axis=-1)
    verts = np.concatenate([base + ring, base + ring + [0, height, 0]]).astype(np.float32)
    j = np.arange(n)
    a, b = j, (j + 1) % n
    idx = np.stack([np.stack([a, b, a + n], -1), np.stack([b, b + n, a + n], -1)], 1)
    return verts, idx.reshape(-1, 3).astype(np.uint32)


def plane(origin, du, dv, nu, nv, height_fn=None):
    """(nu+1) x (nv+1) vertices spanned by du, dv from origin, displaced
    along the plane's normal by height_fn(u, v)."""
    origin, du, dv = (np.asarray(x, np.float64) for x in (origin, du, dv))
    us, vs = np.meshgrid(np.linspace(0, 1, nu + 1), np.linspace(0, 1, nv + 1), indexing="ij")
    pts = origin + us[..., None] * du + vs[..., None] * dv
    if height_fn is not None:
        pts = pts + height_fn(us, vs)[..., None] * unit(np.cross(du, dv))
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = (i * (nv + 1) + j).reshape(-1)
    idx = np.stack([np.stack([a, a + nv + 1, a + 1], -1),
                    np.stack([a + 1, a + nv + 1, a + nv + 2], -1)], 1)
    return pts.reshape(-1, 3).astype(np.float32), idx.reshape(-1, 3).astype(np.uint32)


def sphere_template(n_lat, n_lon):
    """Unit UV sphere: (points (V,3) float64, indices (T,3) uint32)."""
    th = np.linspace(0, np.pi, n_lat + 1)
    ph = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    pts = np.stack([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)], -1).reshape(-1, 3)
    idx = []
    for i in range(n_lat):
        jj = np.arange(n_lon)
        a, b = i * n_lon + jj, i * n_lon + (jj + 1) % n_lon
        c, d = (i + 1) * n_lon + jj, (i + 1) * n_lon + (jj + 1) % n_lon
        rows = []
        if i > 0:
            rows.append(np.stack([a, b, c], -1))
        if i < n_lat - 1:
            rows.append(np.stack([b, d, c], -1))
        idx.append(np.stack(rows, 1).reshape(-1, 3))
    return pts, np.concatenate(idx).astype(np.uint32)


def spheres(centers, radii, n_lat, n_lon):
    """Many UV spheres of one tessellation: (positions (N,V,3) float32,
    template indices (T,3))."""
    pts, idx = sphere_template(n_lat, n_lon)
    c = np.asarray(centers, np.float32)
    r = np.asarray(radii, np.float64)
    return (c[:, None, :] + r[:, None, None] * pts[None]).astype(np.float32), idx


def sphere_normals(positions: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """smooth_normals of each of N meshes that share one index list:
    positions (N,V,3) -> (N,V,3), each mesh's sums in its own face order."""
    n_mesh, n_vert = positions.shape[:2]
    p = positions[:, idx]  # (N,T,3,3)
    fn = np.cross(p[:, :, 1] - p[:, :, 0], p[:, :, 2] - p[:, :, 0])
    n = np.zeros_like(positions).reshape(-1, 3)
    base = (np.arange(n_mesh) * n_vert)[:, None]
    fn = fn.reshape(-1, 3)
    for k in range(3):
        np.add.at(n, (base + idx[None, :, k]).reshape(-1), fn)
    return unit(n).astype(np.float32).reshape(positions.shape)
