"""The environment model of the port against the JAX package: the RGBE
loader on files the test writes (flat and run-length scanlines), the alias
table and its draws, the atmospheric sky, the env-map sky with env NEE in
the path tracer, and the whole slice on a textured atrium (every material
feature, the env map, per-mesh overrides), where sorting the rays must
leave the image bit for bit as it was; the camera rays as the JAX package
rounds them eagerly and under jit, and an atrium whose walls are full of
alpha holes, where rays a rounding apart would re-trace into other
triangles."""
import numpy as np
import pytest
import torch
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from idkengine_tpu.bvh.builder import BuildSettings as JBuildSettings  # noqa: E402
from idkengine_tpu.render import Camera as JCamera  # noqa: E402
from idkengine_tpu.render import PathTracer as JPathTracer  # noqa: E402
from idkengine_tpu.render import PathTracerSettings as JSettings  # noqa: E402
from idkengine_tpu.render import envsample as j_envsample  # noqa: E402
from idkengine_tpu.render import sky as j_sky  # noqa: E402
from idkengine_tpu.render.camera import generate_rays as j_generate_rays  # noqa: E402
from idkengine_tpu.scene import hdr as j_hdr  # noqa: E402
from idkengine_tpu.scene import model as j_model  # noqa: E402
from idkengine_tpu.scene.procedural import atrium as j_atrium  # noqa: E402
from idkengine_tpu.scene.procedural import make_quad as j_make_quad  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch.bvh.builder import BuildSettings  # noqa: E402
from idkengine_tpu_torch.render import Camera, PathTracer, PathTracerSettings  # noqa: E402
from idkengine_tpu_torch.render import envsample, sky  # noqa: E402
from idkengine_tpu_torch.render.camera import generate_rays  # noqa: E402
from idkengine_tpu_torch.scene import hdr, model  # noqa: E402
from idkengine_tpu_torch.scene.procedural import atrium, make_quad, texture_atrium  # noqa: E402
from idkengine_tpu_torch.scene.scene_db import SceneDatabase  # noqa: E402

from test_torch_trace import jax_core  # noqa: E402,F401

RMSE_MAX = 1e-3
ALIAS_ERR = 1e-6
SAMPLE_RTOL = 1e-5
SKY_RTOL = 1e-4
SKY_ATOL = 1e-12  # radiance below any visible level (the nadir's, about 1e-37)
# the atrium as the benchmark builds it, cut to CPU size
BUILD = dict(max_leaf_triangle_count=12, traversal_cost=4.0, presplit_factor=0.0)
LIGHTS = [([0.0, 10.5, 0.0], [40.0, 38.0, 35.0], 0.8), ([6.0, 4.0, -20.0], [20.0, 10.0, 5.0], 0.5)]
ATRIUM_CAM = dict(position=np.array([0.0, 3.0, 24.0], np.float32), yaw=-90.0, fov_y=65.0)
ATRIUM_SETTINGS = dict(ray_depth=2, russian_roulette=False, sky_strength=1.0, use_env_map=True,
                       env_nee=True)
AW, AH = 48, 32


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _sun_env(h=32, w=64):
    """The atmospheric sky with a small bright sun block."""
    env = j_sky.compute_atmosphere(w, h)
    env[h // 5:h // 5 + 2, w // 3:w // 3 + 2] = 60.0
    return env


@pytest.fixture(scope="module")
def env_map():
    return _sun_env()


@pytest.mark.parametrize("rle", [False, True])
def test_load_hdr_matches_jax(tmp_path, rle):
    rs = np.random.RandomState(0)
    img = ((rs.rand(19, 37, 3) ** 4) * 80.0).astype(np.float32)
    img[3, 4:30] = 2.5  # runs for the RLE coder
    img[7] = 0.0
    path = str(tmp_path / f"sky_{int(rle)}.hdr")
    hdr.save_hdr(path, img, rle=rle)
    got, want = hdr.load_hdr(path), j_hdr.load_hdr(path)
    assert got.dtype == np.float32 and got.shape == (19, 37, 3)
    np.testing.assert_array_equal(got, want)
    # RGBE keeps 8 bits of mantissa under the largest channel's exponent
    assert (np.abs(got - img) <= img.max(-1, keepdims=True) / 128.0).all()
    mgr = sky.SkyBoxManager(device="cpu")
    np.testing.assert_array_equal(mgr.load_equirect_hdr(path), want)


def test_build_alias_matches_jax():
    rs = np.random.RandomState(1)
    w = (rs.rand(32, 64) ** 3).ravel()
    w[rs.rand(w.size) < 0.2] = 0.0
    for weights in (w, np.zeros(16)):
        prob, alias, pmf = envsample.build_alias(weights)
        jprob, jalias, jpmf = j_envsample.build_alias(weights)
        np.testing.assert_array_equal(alias, jalias)
        np.testing.assert_allclose(prob, jprob, rtol=0, atol=ALIAS_ERR)
        np.testing.assert_allclose(pmf, jpmf, rtol=0, atol=ALIAS_ERR)


def test_sample_and_pdf_match_jax(env_map):
    s = envsample.EnvSampler(env_map, device="cpu")
    js = j_envsample.EnvSampler(env_map)
    rs = np.random.RandomState(2)
    n = 20_000
    u1, u2 = rs.rand(n).astype(np.float32), rs.rand(n).astype(np.float32)
    uj = rs.rand(n, 2).astype(np.float32)
    d, p = envsample.sample(s.tables, *map(torch.from_numpy, (u1, u2, uj)))
    jd, jp = j_envsample.sample(js.tables, *map(jnp.asarray, (u1, u2, uj)))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=SAMPLE_RTOL, atol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=SAMPLE_RTOL)
    v = rs.randn(n, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    np.testing.assert_allclose(envsample.pdf(s.tables, torch.from_numpy(v)).numpy(),
                               np.asarray(j_envsample.pdf(js.tables, jnp.asarray(v))),
                               rtol=SAMPLE_RTOL)


def test_atmosphere_matches_jax():
    got = sky.compute_atmosphere(64, 32, device="cpu")
    want = j_sky.compute_atmosphere(64, 32)
    assert got.shape == (32, 64, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=SKY_RTOL, atol=0)
    s = sky.AtmosphereSettings(sun_direction=(-0.5, 0.3, 0.1), i_steps=8)
    np.testing.assert_allclose(
        sky.SkyBoxManager(device="cpu").use_atmospheric_scattering(s, 32, 16),
        j_sky.SkyBoxManager().use_atmospheric_scattering(j_sky.AtmosphereSettings(
            sun_direction=(-0.5, 0.3, 0.1), i_steps=8), 32, 16), rtol=SKY_RTOL, atol=SKY_ATOL)


def _floor(model_mod, quad):
    """tests/test_envsample.py's floor under the sky, plus a box to shade it."""
    m = model_mod
    pos, idx = quad([-5, 0, -5], [5, 0, -5], [5, 0, 5], [-5, 0, 5])
    prims = [m.MeshPrimitive(positions=pos.astype(np.float32), indices=idx.astype(np.uint32),
                             material=0)]
    pos2, idx2 = quad([-1, 0.01, 0], [1, 0.01, 0], [1, 2, 0], [-1, 2, 0])
    prims.append(m.MeshPrimitive(positions=pos2.astype(np.float32),
                                 indices=idx2.astype(np.uint32), material=1))
    for p in prims:
        p.ensure_normals()
    out = m.Model(primitives=prims, nodes=[m.Node(mesh_primitives=[0, 1])],
                  materials=[m.Material(name="floor", alpha_cutoff=-1.0),
                             m.Material(name="wall", roughness=0.3, metallic=0.5,
                                        alpha_cutoff=-1.0)])
    out.root_nodes.append(0)
    return out


ENV_CAM = dict(position=np.array([0, 2.0, 6.0], np.float32), yaw=-90.0, pitch=-15.0, fov_y=60.0)
ENV_SETTINGS = dict(ray_depth=1, russian_roulette=False, use_env_map=True, env_nee=True,
                    light_spheres=False)


@pytest.fixture(scope="module")
def env_renders(env_map):
    db = SceneDatabase()
    db.add_model(_floor(model, make_quad))
    scene = db.build("cpu")
    pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), 32, 32,
                    PathTracerSettings(**ENV_SETTINGS), env_map=env_map, device="cpu")
    img = pt.render_frame(Camera(**ENV_CAM)).numpy()
    jdb = JSceneDatabase()
    jdb.add_model(_floor(j_model, j_make_quad))
    jscene = jdb.build()
    jpt = JPathTracer(jscene, jdb.materials.soa(), jdb.lights.soa(), 32, 32,
                      JSettings(use_packet_tracer=False, **ENV_SETTINGS), env_map=env_map)
    jimg = np.asarray(jpt.render_frame(JCamera(**ENV_CAM)))
    return pt, img, jpt, jimg


def test_env_sky_and_env_nee_match_jax(env_renders):
    pt, img, jpt, jimg = env_renders
    assert pt._env_tables is not None and np.isfinite(img).all()
    assert _rmse(img, jimg) <= RMSE_MAX
    assert float(pt.last_rays_traced) == float(jpt.last_rays_traced)
    # env NEE traced shadow rays beside the primaries
    assert float(pt.last_rays_traced) > 32 * 32
    # the sky pixels show the map (misses on a delta-like path)
    sky_px = pt._last_aovs[2].numpy() == 0
    assert sky_px.any() and img.reshape(-1, 3)[sky_px].std() > 0


def test_env_nee_switched_on_later(env_map, env_renders):
    """set_settings turning env NEE on builds the tables at the next frame
    and renders as a tracer made with it."""
    pt0, img0 = env_renders[:2]
    db = SceneDatabase()
    db.add_model(_floor(model, make_quad))
    scene = db.build("cpu")
    pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), 32, 32,
                    PathTracerSettings(**{**ENV_SETTINGS, "env_nee": False}), env_map=env_map,
                    device="cpu")
    assert pt._env_tables is None
    pt.set_settings(env_nee=True)
    np.testing.assert_array_equal(pt.render_frame(Camera(**ENV_CAM)).numpy(), img0)


def _textured_atrium_db(pkg_model, pkg_atrium, db_cls, build_cls, device=None):
    m = pkg_atrium(4000)
    shading = texture_atrium(m, seed=0, texture_cls=pkg_model.Texture)
    db = db_cls(build_cls(**BUILD))
    db.add_model(m)
    scene = db.build() if device is None else db.build(device)
    for pos, rad, r in LIGHTS:
        db.lights.add(pos, rad, radius=r)
    for k, kw in shading.items():
        db.set_mesh_shading(k, **kw)
    return db, scene


@pytest.fixture(scope="module")
def atrium_renders(env_map):
    db, scene = _textured_atrium_db(model, atrium, SceneDatabase, BuildSettings, "cpu")
    imgs = {}
    for sort in (False, True):
        pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), AW, AH,
                        PathTracerSettings(do_ray_sorting=sort, **ATRIUM_SETTINGS),
                        env_map=env_map, slot_shading=db.slot_shading(), device="cpu")
        imgs[sort] = pt.render_frame(Camera(**ATRIUM_CAM)).numpy(), pt
    return imgs


def test_textured_sorting_leaves_the_image_unchanged(atrium_renders):
    (off, pt_off), (on, pt_on) = atrium_renders[False], atrium_renders[True]
    assert pt_on._has_textures and pt_on._has_alpha and pt_on._has_normal_maps
    assert pt_on._has_mesh_shading and pt_on._env_tables is not None
    np.testing.assert_array_equal(on, off)
    for a, b in zip(pt_on._last_aovs, pt_off._last_aovs):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert float(pt_on.last_rays_traced) == float(pt_off.last_rays_traced)


def test_textured_atrium_matches_jax(atrium_renders, env_map):
    """The whole slice: textures, alpha test, normal maps, env-map sky and
    env NEE, per-mesh overrides, at depth 2."""
    img, pt = atrium_renders[True]
    jdb, jscene = _textured_atrium_db(j_model, j_atrium, JSceneDatabase, JBuildSettings)
    jpt = JPathTracer(jscene, jdb.materials.soa(), jdb.lights.soa(), AW, AH,
                      JSettings(use_packet_tracer=False, **ATRIUM_SETTINGS), env_map=env_map,
                      slot_shading=jdb.slot_shading())
    jimg = np.asarray(jpt.render_frame(JCamera(**ATRIUM_CAM)))
    got = pt.attr_table().numpy()
    np.testing.assert_array_equal(got, np.asarray(jpt._attr)[:got.shape[0], :got.shape[1]])
    assert np.isfinite(img).all() and img.std() > 0
    assert _rmse(img, jimg) <= RMSE_MAX
    assert float(pt.last_rays_traced) == float(jpt.last_rays_traced)


@pytest.mark.parametrize("size", [(48, 32), (40, 24)])
@pytest.mark.parametrize("fused", [False, True])
def test_camera_rays_round_as_jax(size, fused):
    """generate_rays equals the JAX function run op by op (the G-buffer's
    rays) and, with `fused`, under jit (the path tracer's); the two
    roundings differ, so neither form serves both."""
    w, h = size
    params = JCamera(**ATRIUM_CAM).ray_params(w, h)
    rs = np.random.RandomState(w)
    jitter, lens = rs.rand(w * h, 2).astype(np.float32), rs.rand(w * h, 2).astype(np.float32)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    run = jax.jit(j_generate_rays, static_argnums=(1, 2)) if fused else j_generate_rays
    jo, jd = map(np.asarray, run(jparams, w, h, jnp.asarray(jitter), jnp.asarray(lens)))
    o, d = generate_rays(params, w, h, torch.from_numpy(jitter), torch.from_numpy(lens),
                         fused=fused)
    np.testing.assert_array_equal(o.numpy(), jo)
    np.testing.assert_array_equal(d.numpy(), jd)
    _, other = generate_rays(params, w, h, torch.from_numpy(jitter), torch.from_numpy(lens),
                             fused=not fused)
    assert (other.numpy() != jd).any()


def _holes_textures(pkg_model):
    """A checker whose dark cells are alpha holes, a normal map that turns
    every 25 texels, a random metal-roughness texture."""
    yy, xx = np.mgrid[:64, :64]
    cells = ((yy // 8 + xx // 8) % 2).astype(bool)
    chk = np.zeros((64, 64, 4), np.uint8)
    chk[..., :3] = np.where(cells[..., None], 230, 60)
    chk[..., 3] = np.where(cells, 255, 0)
    nm = np.zeros((64, 64, 4), np.uint8)
    nm[..., 0] = (128 + 60 * np.sin(xx / 4)).astype(np.uint8)
    nm[..., 1], nm[..., 2], nm[..., 3] = 128, 230, 255
    mr = np.random.RandomState(0).randint(0, 256, (64, 64, 4)).astype(np.uint8)
    return [pkg_model.Texture(name="chk", data=chk, is_srgb=True),
            pkg_model.Texture(name="nm", data=nm, is_srgb=False),
            pkg_model.Texture(name="mr", data=mr, is_srgb=False)]


def _holes_atrium_db(pkg_model, pkg_atrium, db_cls, build_cls, device=None):
    """The atrium with alpha holes in every stone wall (MASK at the default
    cutoff), a high-frequency normal map on them, alpha-tested and blended
    cloth and two per-mesh overrides."""
    m = pkg_atrium(4000)
    m.textures = _holes_textures(pkg_model)
    mats = {mat.name: mat for mat in m.materials}
    mats["stone"].base_color_texture, mats["stone"].normal_texture = 0, 1
    mats["metal"].metallic_roughness_texture = 2
    mats["cloth_red"].alpha_cutoff, mats["cloth_red"].base_color_texture = 0.5, 0
    mats["cloth_green"].alpha_cutoff = 0.0
    mats["cloth_green"].base_color = np.array([0.1, 0.4, 0.12, 0.5], np.float32)
    for p in m.primitives:
        p.uvs = (p.positions[:, [0, 2]] * 0.25 + p.positions[:, [1, 1]] * 0.1).astype(np.float32)
    db = db_cls(build_cls(**BUILD))
    db.add_model(m)
    scene = db.build() if device is None else db.build(device)
    db.lights.add(*LIGHTS[0][:2], radius=LIGHTS[0][2])
    db.set_mesh_shading(3, emissive_bias=2.0)
    db.set_mesh_shading(5, roughness_bias=-0.5)
    return db, scene


def test_alpha_holes_atrium_matches_jax():
    """Primary rays a rounding apart from the jitted JAX ones re-trace past
    a hole into another triangle: with the G-buffer's rounding of the
    camera rays this image is 1.2e-3 RMSE from JAX's (one pixel), with the
    path tracer's own it agrees."""
    env = j_sky.compute_atmosphere(64, 32)
    settings = dict(ray_depth=2, russian_roulette=False, sky_strength=1.0, use_env_map=True,
                    env_nee=True)
    db, scene = _holes_atrium_db(model, atrium, SceneDatabase, BuildSettings, "cpu")
    pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), AW, AH,
                    PathTracerSettings(**settings), env_map=env,
                    slot_shading=db.slot_shading(), device="cpu")
    img = pt.render_frame(Camera(**ATRIUM_CAM)).numpy()
    jdb, jscene = _holes_atrium_db(j_model, j_atrium, JSceneDatabase, JBuildSettings)
    jpt = JPathTracer(jscene, jdb.materials.soa(), jdb.lights.soa(), AW, AH,
                      JSettings(use_packet_tracer=False, **settings), env_map=env,
                      slot_shading=jdb.slot_shading())
    jimg = np.asarray(jpt.render_frame(JCamera(**ATRIUM_CAM)))
    assert pt._has_alpha and pt._has_normal_maps and pt._env_tables is not None
    assert np.isfinite(img).all() and img.std() > 0
    assert _rmse(img, jimg) <= RMSE_MAX
    assert np.abs(img - jimg).max() <= RMSE_MAX
    assert float(pt.last_rays_traced) == float(jpt.last_rays_traced)
