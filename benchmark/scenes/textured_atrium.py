"""The atrium with the material model of a textured asset, as the port's
`scene/procedural.texture_atrium` dresses it (the same textures and draws
from the seed): planar UVs on every part; an sRGB checker base colour on
stone and floor; a metal-roughness texture on metal; a tangent-space normal
map on stone; an emissive texture on floor; red cloth alpha-tested (cutoff
0.5, an alpha checker) and green cloth blended (alpha 0.5); an emissive
bias on the first statue and a roughness bias on the first column. Six
256x256 textures, which the port's atlas holds as six 512x512 layers with
their mips (12 MiB, inside the card's L2): a small set, not a textured
asset's, so the cell measures the material and alpha launches and not
texture bandwidth. The sky is an equirect map (sky.py): single-scattering
atmosphere with a small sun, through RGBE as a .hdr file holds it.

params: {"triangles": budget, "env": [width, height]}.
"""
from __future__ import annotations

import numpy as np

from . import atrium, sky
from .common import SceneData, Texture


def _checker(size, cells, a, b):
    yy, xx = np.mgrid[:size, :size]
    on = ((yy * cells // size + xx * cells // size) % 2 == 0)[..., None]
    return np.where(on, np.asarray(a, np.uint8), np.asarray(b, np.uint8)).astype(np.uint8)


def dress(scene: SceneData, seed: int) -> SceneData:
    rs = np.random.RandomState(seed % 2 ** 32)
    size = 256
    for p in scene.parts:
        q = p.positions
        p.uvs = np.stack([q[:, 0] * 0.25 + q[:, 1] * 0.125,
                          q[:, 2] * 0.25 + q[:, 1] * 0.125], -1).astype(np.float32)
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
    scene.textures = [Texture(n, d, s) for n, d, s in (
        ("stone", stone, True), ("floor", floor, True), ("mr", mr, False),
        ("normal", normal, False), ("glow", glow, True), ("cloth", cloth, True))]
    mats = {m.name: m for m in scene.materials}
    for m in scene.materials:
        m.alpha_cutoff = -1.0
    mats["stone"].base_color_texture, mats["stone"].normal_texture = 0, 3
    mats["floor"].base_color_texture, mats["floor"].emissive_texture = 1, 4
    mats["floor"].emissive = (0.8, 0.6, 0.3)
    mats["metal"].metallic_roughness_texture = 2
    mats["cloth_red"].alpha_cutoff, mats["cloth_red"].base_color_texture = 0.5, 5
    mats["cloth_green"].alpha_cutoff = 0.0
    mats["cloth_green"].base_color = (0.1, 0.4, 0.12, 0.5)
    names = [m.name for m in scene.materials]
    kinds = [names[p.material] for p in scene.parts]
    statue = kinds.index("metal")
    column = next(i for i, k in enumerate(kinds) if k == "stone" and i > 6)
    scene.mesh_shading = {statue: {"emissive_bias": 3.0}, column: {"roughness_bias": -0.5}}
    return scene


def generate(params: dict, seed: int, device="cpu") -> SceneData:
    scene = dress(atrium.generate(params, seed), seed)
    w, h = params.get("env", (1024, 512))
    scene.env = sky.rgbe_roundtrip(sky.with_sun(sky.atmosphere(w, h, device=device)))
    return scene
