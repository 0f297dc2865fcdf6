"""The path tracer's material model on the CPU, the port against the JAX
package's PathTracer(use_packet_tracer=False) on scenes built in code as
tests/test_alpha_normal.py and tests/test_mesh_shading.py build them: a
MASK checker quad, a BLEND quad, alpha shadows through holes, a
normal-mapped quad, per-mesh overrides and a per-pixel bounce budget. Each
image within RMSE 1e-3 (the port's bound, tests/test_torch_pathtracer.py),
each scene rendered once by each package (module-scoped fixtures)."""
import types

import numpy as np
import pytest
import torch
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")

from idkengine_tpu.render import Camera as JCamera  # noqa: E402
from idkengine_tpu.render import PathTracer as JPathTracer  # noqa: E402
from idkengine_tpu.render import PathTracerSettings as JSettings  # noqa: E402
from idkengine_tpu.scene import model as j_model  # noqa: E402
from idkengine_tpu.scene.procedural import make_quad as j_make_quad  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch.render import Camera, PathTracer, PathTracerSettings  # noqa: E402
from idkengine_tpu_torch.scene import model  # noqa: E402
from idkengine_tpu_torch.scene.procedural import make_quad  # noqa: E402
from idkengine_tpu_torch.scene.scene_db import SceneDatabase  # noqa: E402

from test_torch_trace import jax_core  # noqa: E402,F401

PORT = types.SimpleNamespace(model=model, make_quad=make_quad, SceneDatabase=SceneDatabase,
                             Camera=Camera, device="cpu")
JAX = types.SimpleNamespace(model=j_model, make_quad=j_make_quad, SceneDatabase=JSceneDatabase,
                            Camera=JCamera, device=None)
RMSE_MAX = 1e-3
RES = 32
FRONT = dict(position=np.array([0, 0, -3], np.float32), yaw=90.0, fov_y=40.0)
WHITE_SKY = dict(sky_strength=1.0, sky_zenith=(1, 1, 1), sky_horizon=(1, 1, 1))
FRONT_LIGHT = [([0.6, 0.8, -2.0], [40.0, 40.0, 40.0], 0.2)]  # lights the quads through NEE


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _checker_rgba(n=8, size=64):
    """Checker: cell (i+j) even opaque and warm, odd alpha 0."""
    img = np.zeros((size, size, 4), np.uint8)
    cell = size // n
    for j in range(n):
        for i in range(n):
            img[j * cell:(j + 1) * cell, i * cell:(i + 1) * cell] = (
                (240, 200, 120, 255) if (i + j) % 2 == 0 else (30, 60, 200, 0))
    return img


def _normal_map(size=64):
    """A tangent-space normal map tilting along u in a sine."""
    x = np.arange(size)
    nm = np.zeros((size, size, 4), np.uint8)
    nm[..., 0] = (128 + 90 * np.sin(x / 5.0))[None, :].astype(np.uint8)
    nm[..., 1] = (128 + 40 * np.cos(x / 7.0))[:, None].astype(np.uint8)
    nm[..., 2] = 220
    nm[..., 3] = 255
    return nm


def _quad(pkg, material, textures=(), corners=None, z=0.0, size=1.0, uv_axes=(0, 1)):
    m = pkg.model
    c = corners or ([-size, -size, z], [size, -size, z], [size, size, z], [-size, size, z])
    v, idx = pkg.make_quad(*c)
    prim = m.MeshPrimitive(positions=v.astype(np.float32), indices=idx.astype(np.uint32),
                           material=0)
    lo, hi = v.min(0), v.max(0)
    ax = list(uv_axes)
    prim.uvs = ((v[:, ax] - lo[ax]) / np.maximum(hi[ax] - lo[ax], 1e-6)).astype(np.float32)
    prim.ensure_normals()
    out = m.Model(primitives=[prim], nodes=[m.Node(name="quad", mesh_primitives=[0])],
                  materials=[material], textures=list(textures))
    out.root_nodes.append(0)
    return out


def _back(pkg):
    return _quad(pkg, pkg.model.Material(name="back",
                                         base_color=np.array([1, 0.2, 0.1, 1], np.float32)),
                 z=2.0, size=4.0)


def _mask_scene(pkg):
    m = pkg.model
    db = pkg.SceneDatabase()
    db.add_model(_quad(pkg, m.Material(name="checker", alpha_cutoff=0.5, base_color_texture=0,
                                       roughness=1.0),
                       [m.Texture(name="c", data=_checker_rgba(), is_srgb=True)]))
    db.add_model(_back(pkg))
    return db, {"lights": FRONT_LIGHT}


def _blend_scene(pkg):
    m = pkg.model
    db = pkg.SceneDatabase()
    db.add_model(_quad(pkg, m.Material(name="blend", alpha_cutoff=0.0, roughness=1.0,
                                       base_color=np.array([1, 1, 1, 0.3], np.float32)),
                       size=4.0))
    db.add_model(_back(pkg))
    return db, {"lights": FRONT_LIGHT}


def _shadow_scene(pkg):
    """A floor lit by a sphere light through a horizontal checker quad."""
    m = pkg.model
    db = pkg.SceneDatabase()
    db.add_model(_quad(pkg, m.Material(name="floor"),
                       corners=([-4, -1, -2], [4, -1, -2], [4, -1, 6], [-4, -1, 6]),
                       uv_axes=(0, 2)))
    db.add_model(_quad(pkg, m.Material(name="chk", alpha_cutoff=0.5, base_color_texture=0,
                                       double_sided=True),
                       [m.Texture(name="c", data=_checker_rgba(), is_srgb=True)],
                       corners=([-1, 1, 1], [1, 1, 1], [1, 1, 3], [-1, 1, 3]), uv_axes=(0, 2)))
    return db, {"lights": [([0.0, 6.0, 2.0], [60.0, 60.0, 60.0], 0.25)]}


def _normal_scene(pkg):
    m = pkg.model
    db = pkg.SceneDatabase()
    db.add_model(_quad(pkg, m.Material(name="bump", normal_texture=0, roughness=1.0,
                                       alpha_cutoff=-1.0),
                       [m.Texture(name="nm", data=_normal_map(), is_srgb=False)]))
    db.add_model(_back(pkg))
    return db, {"lights": FRONT_LIGHT}


def _two_quads(pkg):
    """Two stacked quads, one placement each, the upper one normal-mapped
    (tests/test_mesh_shading.py's model plus a normal map)."""
    m = pkg.model
    out = m.Model(name="two_quads",
                  materials=[m.Material(name="m0", alpha_cutoff=-1.0,
                                        base_color=np.array([0.5, 0.25, 0.125, 1], np.float32)),
                             m.Material(name="m1", normal_texture=0, alpha_cutoff=-1.0,
                                        roughness=0.6)],
                  textures=[m.Texture(name="nm", data=_normal_map(), is_srgb=False)])
    for i, y0 in enumerate((0.0, 1.0)):
        pos = np.array([[0, y0, 0], [2, y0, 0], [2, y0 + 1, 0], [0, y0 + 1, 0]], np.float32)
        p = m.MeshPrimitive(positions=pos, indices=np.array([[0, 1, 2], [0, 2, 3]], np.uint32),
                            material=i)
        p.uvs = pos[:, :2].copy()
        p.ensure_normals()
        out.primitives.append(p)
        out.nodes.append(m.Node(name=f"q{i}", mesh_primitives=[i]))
        out.root_nodes.append(i)
    return out


def _shading_scene(pkg):
    db = pkg.SceneDatabase()
    db.add_model(_two_quads(pkg))
    return db, {"shading": {0: dict(emissive_bias=5.0, roughness_bias=-0.3),
                            1: dict(normal_map_strength=0.4, specular_bias=0.5,
                                    emissive_bias=0.5)},
                "camera": dict(position=np.array([1.0, 1.0, -4.0], np.float32), yaw=90.0,
                               fov_y=45.0)}


SCENES = {
    # name: (scene, settings)
    "mask": (_mask_scene, dict(ray_depth=1, **WHITE_SKY)),
    "blend": (_blend_scene, dict(ray_depth=1, **WHITE_SKY)),
    "alpha_shadows": (_shadow_scene, dict(ray_depth=1, sky_strength=0.0, nee=True)),
    "normal_map": (_normal_scene, dict(ray_depth=1, **WHITE_SKY)),
    "mesh_shading": (_shading_scene, dict(ray_depth=1, nee=False, light_spheres=False,
                                          sky_strength=0.5)),
    "rate_depth": (_mask_scene, dict(ray_depth=2, nee=False, light_spheres=False,
                                     russian_roulette=False, **WHITE_SKY)),
}


def _rate_depth():
    """A per-pixel bounce budget: 1 on the left half, 2 on the right."""
    return np.tile(np.where(np.arange(RES) < RES // 2, 1, 2), RES).astype(np.int32)


def _render(pkg, name, budget=True):
    build, settings = SCENES[name]
    db, opts = build(pkg)
    scene = db.build() if pkg.device is None else db.build(pkg.device)
    for pos, rad, r in opts.get("lights", []):
        db.lights.add(pos, rad, radius=r)
    for k, kw in opts.get("shading", {}).items():
        db.set_mesh_shading(k, **kw)
    cam = pkg.Camera(**opts.get("camera", FRONT))
    rate = _rate_depth() if name == "rate_depth" and budget else None
    if pkg is JAX:
        pt = JPathTracer(scene, db.materials.soa(), db.lights.soa(), RES, RES,
                         JSettings(use_packet_tracer=False, **settings),
                         slot_shading=db.slot_shading())
        img = np.asarray(pt.render_frame(cam, rate_depth=None if rate is None
                                         else jax.numpy.asarray(rate)))
        return pt, img, db
    pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), RES, RES,
                    PathTracerSettings(**settings),
                    slot_shading=db.slot_shading(), device="cpu")
    img = pt.render_frame(cam, rate_depth=None if rate is None
                          else torch.from_numpy(rate)).numpy()
    return pt, img, db


@pytest.fixture(scope="module", params=list(SCENES))
def rendered(request):
    name = request.param
    return name, _render(PORT, name), _render(JAX, name)


def test_image_matches_jax(rendered):
    name, (pt, img, _), (jpt, jimg, _) = rendered
    assert img.shape == (RES, RES, 3) and np.isfinite(img).all()
    assert _rmse(img, jimg) <= RMSE_MAX, name
    assert float(pt.last_rays_traced) == float(jpt.last_rays_traced)
    # the AOVs of the primary hits (albedo, normal, depth)
    for got, want in zip(pt._last_aovs, jpt._last_aovs):
        close = np.isclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)
        assert close.mean() >= 0.999, name
    assert pt._has_alpha == jpt._has_alpha and pt._has_textures == jpt._has_textures
    assert pt._has_normal_maps == jpt._has_normal_maps
    assert pt._has_mesh_shading == jpt._has_mesh_shading


def test_attribute_pack_equals_jax(rendered):
    """Every channel of the per-slot pack (corner UVs, tangent frame,
    alpha, cutoff, UV density, overrides) equals the JAX package's."""
    name, (pt, _, _), (jpt, _, _) = rendered
    got = pt.attr_table().numpy()
    np.testing.assert_array_equal(got, np.asarray(jpt._attr)[:got.shape[0], :got.shape[1]],
                                  err_msg=name)


def test_the_feature_shows(rendered):
    """Each scene exercises what it is named for."""
    name, (pt, img, db), _ = rendered
    depth = pt._last_aovs[2].numpy().reshape(RES, RES)
    on = depth > 0
    if name in ("mask", "blend"):
        near, far = on & (depth < 4.0), on & (depth >= 4.0)  # front quad ~3, back ~5
        assert pt._has_alpha and near.sum() > 50 and far.sum() > 50
    elif name == "alpha_shadows":
        lum = img[on].mean(-1)
        assert (lum > lum.max() * 0.5).sum() > 20 and (lum < lum.max() * 0.1).sum() > 20
    elif name == "normal_map":
        nrm = pt._last_aovs[1].numpy().reshape(RES, RES, 3)[on]
        assert np.abs(nrm[:, 0]).max() > 0.3  # tilted off the quad's -z
    elif name == "mesh_shading":
        assert pt._has_mesh_shading
        rows = db.slot_shading()
        assert (rows[:, 0] > 0).all()
    else:
        # the right half (budget 2) renders as without a budget; the left
        # half (budget 1) stops after its primary hit
        full_pt, full, _ = _render(PORT, name, budget=False)
        half = RES // 2
        np.testing.assert_array_equal(img[:, half:], full[:, half:])
        assert not np.array_equal(img[:, :half], full[:, :half])
        assert float(pt.last_rays_traced) < float(full_pt.last_rays_traced)


def test_rate_depth_limits_bounces():
    """A budget of 1 everywhere renders what depth 1 renders; of 2, depth 2."""
    _, settings = SCENES["rate_depth"]
    db, _ = _mask_scene(PORT)
    scene = db.build("cpu")
    cam = Camera(**FRONT)
    imgs = {}
    for depth, budget in ((1, None), (2, 1), (2, None)):
        pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), RES, RES,
                        PathTracerSettings(**{**settings, "ray_depth": depth}), device="cpu")
        rate = None if budget is None else torch.full((RES * RES,), budget, dtype=torch.int32)
        imgs[(depth, budget)] = pt.render_frame(cam, rate_depth=rate).numpy()
    np.testing.assert_array_equal(imgs[(2, 1)], imgs[(1, None)])
    assert not np.array_equal(imgs[(2, None)], imgs[(1, None)])


def test_set_slot_shading_matches_construction():
    """Overrides set after construction render as overrides given to it."""
    db, opts = _shading_scene(PORT)
    scene = db.build("cpu")
    settings = PathTracerSettings(**SCENES["mesh_shading"][1])
    cam = Camera(**opts["camera"])
    before = PathTracer(scene, db.materials.soa(), db.lights.soa(), RES, RES, settings,
                        device="cpu").render_frame(cam).numpy()
    plain = PathTracer(scene, db.materials.soa(), db.lights.soa(), RES, RES, settings,
                       device="cpu")
    for k, kw in opts["shading"].items():
        db.set_mesh_shading(k, **kw)
    built = PathTracer(scene, db.materials.soa(), db.lights.soa(), RES, RES, settings,
                       slot_shading=db.slot_shading(), device="cpu")
    plain.set_slot_shading(db.slot_shading())
    assert plain.accumulated_samples == 0 and plain._has_mesh_shading
    np.testing.assert_array_equal(plain.render_frame(cam).numpy(),
                                  built.render_frame(cam).numpy())
    assert not np.array_equal(before, built.image().numpy())
