"""The material layer of the port against the JAX package: the texture atlas
(MaterialTable.soa) bit for bit, the atlas sampler, the per-mesh shading
rows of the scene database and the textured G-buffer. Inputs are made from
seeds with numpy; the JAX package resizes textures with Pillow, the port
with its own numpy resampler."""
import types

import numpy as np
import pytest
import torch
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from idkengine_tpu.render.camera import Camera as JCamera  # noqa: E402
from idkengine_tpu.render.gbuffer import render_gbuffer as j_render_gbuffer  # noqa: E402
from idkengine_tpu.render.pathtracer import _sample_atlas as j_sample_atlas  # noqa: E402
from idkengine_tpu.ops.trace import trace_closest as j_trace_closest  # noqa: E402
from idkengine_tpu.scene import materials as j_materials  # noqa: E402
from idkengine_tpu.scene import model as j_model  # noqa: E402
from idkengine_tpu.scene.procedural import atrium as j_atrium  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch.ops import packet_trace  # noqa: E402
from idkengine_tpu_torch.render.camera import Camera  # noqa: E402
from idkengine_tpu_torch.render.gbuffer import GBuffer, render_gbuffer  # noqa: E402
from idkengine_tpu_torch.render.pathtracer import sample_atlas, uv_density  # noqa: E402
from idkengine_tpu_torch.render.pipeline import (DeferredPipeline, DeferredSettings2,  # noqa: E402
                                                 material_tensors)
from idkengine_tpu_torch.scene import materials, model  # noqa: E402
from idkengine_tpu_torch.scene.procedural import atrium  # noqa: E402
from idkengine_tpu_torch.scene.scene_db import MeshShading, SceneDatabase  # noqa: E402

from test_torch_trace import jax_core  # noqa: E402,F401

PORT = types.SimpleNamespace(model=model, atrium=atrium, SceneDatabase=SceneDatabase)
JAX = types.SimpleNamespace(model=j_model, atrium=j_atrium, SceneDatabase=JSceneDatabase)
W, H = 40, 24
CAM = dict(position=np.array([0.0, 3.0, 24.0], np.float32), yaw=-90.0, fov_y=65.0)
SAMPLE_ERR = 1e-6


def _rgba_with_alpha_edges(rs, h, w):
    """Random colours; alpha 0, 255 or in between in blocks, so that the
    resize meets premultiplied edges."""
    img = rs.randint(0, 256, (h, w, 4)).astype(np.uint8)
    blocks = rs.randint(0, 3, (h // 8 + 1, w // 8 + 1))
    alpha = np.choose(blocks, [0, 255, 128]).repeat(8, 0).repeat(8, 1)[:h, :w]
    img[..., 3] = np.where(rs.rand(h, w) < 0.1, img[..., 3], alpha).astype(np.uint8)
    return img


def _textured_model(pkg, seed):
    """One model with four materials: a 64x64 sRGB RGBA upscale with alpha
    edges as base colour, a 700x600 linear downscale as metal-roughness and
    emissive, an 8x8 normal map shared by two; one texture index out of
    range and one undecodable."""
    rs = np.random.RandomState(seed)
    m = pkg.model
    tex = [m.Texture(name="base", data=_rgba_with_alpha_edges(rs, 64, 64), is_srgb=True),
           m.Texture(name="mr", data=rs.randint(0, 256, (600, 700, 4)).astype(np.uint8),
                     is_srgb=False),
           m.Texture(name="nm", data=rs.randint(0, 256, (8, 8, 4)).astype(np.uint8),
                     is_srgb=False),
           m.Texture(name="broken", data=None)]
    mats = [m.Material(name="a", base_color_texture=0, metallic_roughness_texture=1,
                       normal_texture=2),
            m.Material(name="b", emissive_texture=1, normal_texture=2, alpha_cutoff=0.0),
            m.Material(name="c", base_color_texture=3, normal_texture=7),
            m.Material(name="d", metallic=1.0, roughness=0.2, alpha_cutoff=-1.0)]
    return m.Model(materials=mats, textures=tex)


def test_resize_matches_pillow():
    rs = np.random.RandomState(0)
    for (h, w), (oh, ow) in [((64, 64), (512, 512)), ((600, 700), (512, 512)),
                             ((33, 17), (40, 9)), ((512, 300), (512, 512))]:
        for ch in (4, 3):
            img = (_rgba_with_alpha_edges(rs, h, w) if ch == 4
                   else rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
            want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
            np.testing.assert_array_equal(materials.resize_bilinear(img, ow, oh), want)


def test_atlas_bit_equal_to_jax():
    """The upscale (64x64 RGBA, sRGB, alpha edges), the downscale (700x600,
    linear) and their mip strips, and the four layer lists."""
    got, want = materials.MaterialTable(), j_materials.MaterialTable()
    for seed in (1, 2):
        assert got.add_model(_textured_model(PORT, seed)) == \
            want.add_model(_textured_model(JAX, seed))
    g, w = got.soa(), want.soa()
    assert set(g) == set(w)
    assert g["atlas"].shape == (6, materials.ATLAS_SIZE, 2 * materials.ATLAS_SIZE, 4)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    for layer in range(6):
        np.testing.assert_array_equal(got.atlas_layer(layer), want.atlas_layer(layer))
    # a late texture takes a new layer and every material slot that uses it
    m, jm = _textured_model(PORT, 3), _textured_model(JAX, 3)
    assert got.adopt_texture(m, 4, 2, m.textures[0]) == want.adopt_texture(jm, 4, 2,
                                                                         jm.textures[0])
    for k in ("base_layer", "mr_layer", "emissive_layer", "normal_layer", "atlas"):
        np.testing.assert_array_equal(got.soa()[k], want.soa()[k], err_msg=k)


def test_untextured_table_matches_jax():
    got, want = materials.MaterialTable().soa(), j_materials.MaterialTable().soa()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def atlas_inputs():
    table = materials.MaterialTable()
    table.add_model(_textured_model(PORT, 4))
    atlas = table.soa()["atlas"]
    rs = np.random.RandomState(5)
    n = 4096
    layer = rs.randint(-1, atlas.shape[0], n).astype(np.int32)
    uv = (rs.rand(n, 2) * 6.0 - 3.0).astype(np.float32)
    lod = (rs.rand(n) * 9.0 - 1.0).astype(np.float32)
    return atlas, layer, uv, lod


@pytest.mark.parametrize("with_lod", [False, True])
def test_sample_atlas_matches_jax(atlas_inputs, with_lod):
    atlas, layer, uv, lod = atlas_inputs
    got = sample_atlas(torch.from_numpy(atlas), torch.from_numpy(layer).long(),
                       torch.from_numpy(uv), torch.from_numpy(lod) if with_lod else None)
    want = jax.jit(j_sample_atlas)(jnp.asarray(atlas), jnp.asarray(layer), jnp.asarray(uv),
                                   jnp.asarray(lod) if with_lod else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=SAMPLE_ERR)
    # layer -1: factor-only, ones
    assert (got[torch.from_numpy(layer) < 0] == 1.0).all()
    assert (got[torch.from_numpy(layer) >= 0] < 1.0).any()


def _textured_atrium(pkg, device=None):
    """A small atrium with planar UVs, a checker base colour on stone, a
    random metal-roughness texture on metal, an emissive texture on
    cloth_green and overrides on two meshes."""
    rs = np.random.RandomState(6)
    m = pkg.model
    model = pkg.atrium(3000)
    yy, xx = np.mgrid[:64, :64]
    chk = np.zeros((64, 64, 4), np.uint8)
    chk[..., :3] = np.where(((yy // 8 + xx // 8) % 2 == 0)[..., None], 230, 50)
    chk[..., 3] = 255
    model.textures = [m.Texture(name="chk", data=chk, is_srgb=True),
                      m.Texture(name="mr", data=rs.randint(0, 256, (32, 32, 4)).astype(np.uint8),
                                is_srgb=False)]
    mats = {mat.name: mat for mat in model.materials}
    mats["stone"].base_color_texture = 0
    mats["metal"].metallic_roughness_texture = 1
    mats["cloth_green"].emissive_texture = 0
    mats["cloth_green"].emissive = np.array([2.0, 1.0, 0.5], np.float32)
    for p in model.primitives:
        p.uvs = (p.positions[:, [0, 2]] * 0.3 + p.positions[:, [1, 1]] * 0.1).astype(np.float32)
    db = pkg.SceneDatabase()
    db.add_model(model)
    if device is None:
        db.build()
    else:
        db.build(device)
    db.set_mesh_shading(2, emissive_bias=1.5, specular_bias=0.3)
    db.set_mesh_shading(5, roughness_bias=-0.4)
    return db


@pytest.fixture(scope="module")
def atria():
    return _textured_atrium(PORT, "cpu"), _textured_atrium(JAX)


def test_slot_shading_rows_match_jax(atria):
    db, jdb = atria
    assert db.n_meshes == jdb.n_meshes
    np.testing.assert_array_equal(db.slot_shading(), jdb.slot_shading())
    # rows follow the BVH's slot order: slot i carries its triangle's
    # placement's row
    rows = db.slot_shading()
    place = db._tri_prim[db._slot_tri]
    np.testing.assert_array_equal(rows[place == 2, 0], 1.5)
    np.testing.assert_array_equal(rows[place == 5, 3], np.float32(-0.4))
    np.testing.assert_array_equal(rows[(place != 2) & (place != 5)],
                                  np.broadcast_to(MeshShading.ROW_DEFAULT,
                                                  rows[(place != 2) & (place != 5)].shape))
    assert SceneDatabase().slot_shading() is None
    with pytest.raises(AttributeError):
        db.set_mesh_shading(0, no_such_field=1.0)


@pytest.fixture(scope="module")
def gbuffers(atria):
    db, jdb = atria
    cam = Camera(**CAM).ray_params(W, H)
    jcam = JCamera(**CAM).ray_params(W, H)
    scene, jscene = db.device_scene, jdb.device_scene
    jitter = np.array([0.3, 0.7], np.float32)
    mats = material_tensors(db.materials.soa(), "cpu")
    gbuf = render_gbuffer(lambda o, d, t: packet_trace.trace_closest(scene, o, d, t), scene,
                          mats, cam, cam, W, H, jitter=torch.from_numpy(jitter), mip_bias=-0.5,
                          slot_shading=torch.from_numpy(db.slot_shading()),
                          slot_uv_density=uv_density(scene.tri_uv, scene.tri_e1, scene.tri_e2))
    jmats = {k: jnp.asarray(v) for k, v in jdb.materials.soa().items()}
    jgbuf = j_render_gbuffer(lambda o, d, t: j_trace_closest(jscene, o, d, t), jscene, jmats,
                             jcam, jcam, W, H, jitter=jnp.asarray(jitter), mip_bias=-0.5,
                             slot_shading=jdb.slot_shading())
    return gbuf, jgbuf


@pytest.mark.parametrize("field", ["albedo", "metallic", "roughness", "emissive", "normal",
                                   "depth", "mask"])
def test_textured_gbuffer_matches_jax(gbuffers, field):
    gbuf, jgbuf = gbuffers
    assert field in GBuffer._fields
    got, want = getattr(gbuf, field).numpy(), np.asarray(getattr(jgbuf, field))
    assert got.shape == want.shape
    if field == "mask":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if field in ("albedo", "emissive"):
        assert got.std() > 0.01  # the textures and biases show


def test_deferred_pipeline_decides_textures_once(atria):
    """The deferred pipeline samples the atlas only for a textured scene: it
    decides so once, and makes the per-slot UV density once per scene."""
    db = atria[0]
    scene = db.device_scene
    settings = DeferredSettings2(use_vxgi=False)
    pipe = DeferredPipeline(db, W, H, settings, device="cpu")
    dens = pipe.slot_uv_density(scene)
    assert pipe.slot_uv_density(scene) is dens
    np.testing.assert_array_equal(dens.numpy(),
                                  uv_density(scene.tri_uv, scene.tri_e1, scene.tri_e2).numpy())
    plain = SceneDatabase()
    plain.add_model(atrium(500))
    plain.build("cpu")
    assert DeferredPipeline(plain, W, H, settings, device="cpu").slot_uv_density(
        plain.device_scene) is None


def test_material_modules_need_no_pillow_and_no_jax():
    """The material and environment modules import neither JAX nor Pillow:
    the card's machine has no Pillow."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "import idkengine_tpu_torch.render.pathtracer, idkengine_tpu_torch.scene.materials\n"
            "import idkengine_tpu_torch.render.envsample, idkengine_tpu_torch.render.sky\n"
            "import idkengine_tpu_torch.scene.hdr, idkengine_tpu_torch.render.gbuffer\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'idkengine_tpu', 'PIL')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo, timeout=120,
                   env={**os.environ, "PYTHONPATH": repo})
