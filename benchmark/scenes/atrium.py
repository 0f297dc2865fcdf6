"""The parametric colonnaded atrium: floor, walls, two storeys of columns,
wavy curtains, statues on pedestals, and small rocks scattered on the floor
until the triangle budget is met. The layout and the draws from the seed
are those of the port's `scene/procedural.atrium`, so a budget and a seed
give the same triangles; the rocks are made in one vectorized call.

params: {"triangles": budget}. The seed places the rocks and phases the
curtains' waves.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np

from .common import (Material, Part, SceneData, box, cylinder, plane, smooth_normals,
                     sphere_normals, spheres)

W, H, D = 24.0, 12.0, 60.0  # the hall (metres): x across, y up, z along

MATERIALS = [
    Material("stone", base_color=(0.65, 0.6, 0.55, 1.0), roughness=0.8),
    Material("floor", base_color=(0.55, 0.5, 0.45, 1.0), roughness=0.6),
    Material("cloth_red", base_color=(0.55, 0.1, 0.1, 1.0), roughness=0.9),
    Material("cloth_green", base_color=(0.1, 0.4, 0.12, 1.0), roughness=0.9),
    Material("metal", base_color=(0.9, 0.85, 0.7, 1.0), metallic=1.0, roughness=0.25),
]


def generate(params: dict, seed: int, device="cpu") -> SceneData:
    budget = int(params["triangles"])
    rs = np.random.RandomState(seed % 2 ** 32)
    density = max(budget / 262_000.0, 0.05)
    col_n = max(int(16 * density ** 0.5), 8)
    sphere_lat = max(int(24 * density ** 0.5), 8)
    curtain_div = max(int(40 * density ** 0.5), 8)
    meshes = []  # (positions, indices, material)

    meshes.append((*box([0, -0.25, 0], [W, 0.5, D]), 1))
    meshes.append((*box([-W / 2 - 0.25, H / 2, 0], [0.5, H, D]), 0))
    meshes.append((*box([W / 2 + 0.25, H / 2, 0], [0.5, H, D]), 0))
    meshes.append((*box([0, H / 2, -D / 2 - 0.25], [W, H, 0.5]), 0))
    meshes.append((*box([0, H / 2, D / 2 + 0.25], [W, H, 0.5]), 0))
    meshes.append((*box([-W / 2 + W / 8, H + 0.25, 0], [W / 4, 0.5, D]), 0))
    meshes.append((*box([W / 2 - W / 8, H + 0.25, 0], [W / 4, 0.5, D]), 0))

    n_cols = max(int(10 * density ** 0.33), 6)
    zs = np.linspace(-D / 2 + 3, D / 2 - 3, n_cols)
    for y0, h in [(0.0, 5.0), (6.0, 4.0)]:
        for x in (-W / 4, W / 4):
            for z in zs:
                meshes.append((*cylinder([x, y0, z], h, 0.45, col_n), 0))
                meshes.append((*box([x, y0 + h + 0.25, z], [1.4, 0.5, 1.4]), 0))
            meshes.append((*box([x, y0 + h + 0.75, 0], [1.6, 0.5, D - 4]), 0))

    for k, z in enumerate(zs[:-1]):
        for x in (-W / 4 + 1.0, W / 4 - 1.0):
            span = zs[k + 1] - z - 0.6
            ph = rs.uniform(0, 6.28)

            def wave(u, v, ph=ph):
                return 0.25 * np.sin(6 * u + ph) * (1 - v)

            meshes.append((*plane([x, 9.5, z + 0.3], [0, -4.0, 0], [0, 0, span],
                                  curtain_div, curtain_div, wave), 2 + (k % 2)))

    n_statues = max(int(6 * density ** 0.5), 3)
    statue_z = np.linspace(-D / 2 + 6, D / 2 - 6, n_statues)
    pos, idx = spheres([[0, 2.0, z] for z in statue_z], np.full(n_statues, 0.9),
                       sphere_lat, 2 * sphere_lat)
    for z, p in zip(statue_z, pos):
        meshes.append((*box([0, 0.5, z], [1.6, 1.0, 1.6]), 0))
        meshes.append((p, idx, 4))

    parts = [Part(p, i, smooth_normals(p, i), m) for p, i, m in meshes]
    # rocks until the budget: four draws each (x, y, z, radius)
    have = sum(p.indices.shape[0] for p in parts)
    n_rock_tris = 2 * sphere_lat * 2 * sphere_lat - 2 * (2 * sphere_lat)
    n_rocks = 0
    while have + n_rocks * n_rock_tris < budget * 0.98:
        n_rocks += 1
    u = rs.random_sample((n_rocks, 4))
    lo = np.array([-W / 2 + 1, 0.1, -D / 2 + 1, 0.08])
    hi = np.array([W / 2 - 1, 0.4, D / 2 - 1, 0.35])
    draws = lo + (hi - lo) * u
    if n_rocks:
        pos, idx = spheres(draws[:, :3], draws[:, 3], sphere_lat, 2 * sphere_lat)
        nrm = sphere_normals(pos, idx)
        parts += [Part(p, idx, n, 0) for p, n in zip(pos, nrm)]
    return SceneData(parts=parts, materials=[replace(m) for m in MATERIALS])
