"""Async texture IO in the port: background decode and one-per-frame upload,
against the JAX package's.

The queue tests mirror tests/test_async_io.py. The deferred-decode tests
load test_torch_gltf's asset with `defer_textures=True` (textures as KTX2
bytes, two under IDK_BC5 layouts) and decode it through
`attach_async_textures`: every material's layers hold the pixels an eager
load gives; with one worker (decodes land in submission order) the port's
tracer atlas and layer tables equal the JAX tracer's bit for bit; and the
port's tracer after the decodes renders the eager tracer's frame exactly
(its texture, alpha and normal-map gates follow the new layers; the JAX
tracer turns on only its texture gate there, so its late normal maps stay
off: a reference fault the port does not copy).
"""
import time

import numpy as np
import pytest
import torch

from idkengine_tpu.render import PathTracer as JPathTracer
from idkengine_tpu.render import PathTracerSettings as JSettings
from idkengine_tpu.scene import async_io as j_async_io
from idkengine_tpu.scene.gltf import load_gltf as j_load_gltf
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase
from idkengine_tpu_torch.render import Camera, PathTracer, PathTracerSettings
from idkengine_tpu_torch.scene.async_io import (AsyncTextureLoader, MainThreadQueue,
                                                attach_async_textures)
from idkengine_tpu_torch.scene.gltf import load_gltf
from idkengine_tpu_torch.scene.materials import LAYER_KEYS
from idkengine_tpu_torch.scene.scene_db import SceneDatabase

from test_torch_gltf import scene_json, write_asset
from test_torch_trace import jax_core  # noqa: F401
from worker_threads import share_cores

share_cores()


def test_main_thread_queue_lazy_one_per_pump():
    q = MainThreadQueue()
    hits = []
    for i in range(3):
        q.add_lazy(lambda i=i: hits.append(("lazy", i)))
    q.add_hasty(lambda: hits.append(("hasty", 0)))
    q.pump()
    assert hits == [("hasty", 0), ("lazy", 0)]
    q.pump()
    q.pump()
    assert len(hits) == 4 and q.pending() == 0


def test_async_loader_runs_decode_off_thread():
    q = MainThreadQueue()
    ld = AsyncTextureLoader(q)
    seen = []
    ld.submit(lambda: 41 + 1, lambda r: seen.append(r))
    deadline = time.time() + 10
    while not seen and time.time() < deadline:
        q.pump()
        time.sleep(0.005)
    assert seen == [42]
    # decode failure: the finisher is skipped, the queue still drains
    ld.submit(lambda: 1 / 0, lambda r: seen.append(r))
    ld.wait_all()
    assert seen == [42] and ld.outstanding == 0


@pytest.fixture(scope="module")
def asset(tmp_path_factory):
    path = tmp_path_factory.mktemp("asset")
    g, data, files = scene_json(np.random.RandomState(5))
    return write_asset(path, g, data, files, "glb")


def _port_db(path, defer):
    model = load_gltf(path, defer_textures=defer)
    db = SceneDatabase()
    db.add_model(model)
    db.build("cpu")
    db.lights.add([0.0, 3.0, 0.0], [20.0, 20.0, 20.0], radius=0.3)
    return db, model


def _tracer(db, settings=None):
    return PathTracer(db.device_scene, db.materials.soa(), db.lights.soa(), 16, 12,
                      settings or PathTracerSettings(ray_depth=2), device="cpu")


def _drain(db, model, pt, workers):
    loader = AsyncTextureLoader(MainThreadQueue(), workers=workers)
    attach_async_textures(db, model, loader, mat_offset=0, pt=pt)
    loader.wait_all(timeout=60)
    assert loader.outstanding == 0


def test_deferred_decodes_land_as_eager_ones(asset):
    eager, _ = _port_db(asset, defer=False)
    db, model = _port_db(asset, defer=True)
    assert all(t.data is None for t in model.textures)
    assert all((np.asarray(getattr(db.materials, k)) < 0).all() for k in LAYER_KEYS)
    _drain(db, model, None, workers=2)
    for k in LAYER_KEYS:
        got, want = getattr(db.materials, k), getattr(eager.materials, k)
        assert [g < 0 for g in got] == [w < 0 for w in want], k
        for g, w in zip(got, want):
            if w >= 0:
                np.testing.assert_array_equal(db.materials.atlas_layer(g),
                                              eager.materials.atlas_layer(w))
    assert any(l >= 0 for l in db.materials.normal_layer)


def test_tracer_atlas_matches_jax_after_async_decodes(asset):
    db, model = _port_db(asset, defer=True)
    pt = _tracer(db)
    jmodel = j_load_gltf(asset, defer_textures=True)
    jdb = JSceneDatabase()
    jdb.add_model(jmodel)
    jdb.build()
    jdb.lights.add([0.0, 3.0, 0.0], [20.0, 20.0, 20.0], radius=0.3)
    jpt = JPathTracer(jdb.device_scene, jdb.materials.soa(), jdb.lights.soa(), 16, 12,
                      JSettings(ray_depth=2, use_packet_tracer=False))
    assert not pt._has_textures and not jpt._has_textures
    _drain(db, model, pt, workers=1)
    loader = j_async_io.AsyncTextureLoader(j_async_io.MainThreadQueue(), workers=1)
    j_async_io.attach_async_textures(jdb, jmodel, loader, mat_offset=0, pt=jpt)
    loader.wait_all(timeout=60)
    assert pt._has_textures and jpt._has_textures
    np.testing.assert_array_equal(pt.mats["atlas"].numpy(), np.asarray(jpt.mats["atlas"]))
    for k in LAYER_KEYS:
        np.testing.assert_array_equal(pt.mats[k].numpy(), np.asarray(jpt.mats[k]))
    assert pt.mats["atlas"].shape[0] == 5
    # the JAX tracer turns on its texture gate only: its late normal maps stay
    # off (an eager JAX load turns them on); the port's follow the layers
    assert pt._has_normal_maps and not jpt._has_normal_maps


def test_tracer_after_async_decodes_renders_the_eager_frame(asset):
    cam = Camera(position=np.float32([0.5, 3.0, 4.0]), yaw=-100.0, pitch=-30.0, fov_y=60.0)
    eager, _ = _port_db(asset, defer=False)
    want = _tracer(eager)
    db, model = _port_db(asset, defer=True)
    pt = _tracer(db)
    before = pt.render_frame(cam).clone()
    _drain(db, model, pt, workers=2)
    pt.reset_accumulation()
    pt._frame = 0  # the eager tracer's first sample
    for k in ("_has_textures", "_has_alpha", "_has_normal_maps"):
        assert getattr(pt, k) == getattr(want, k), k
    img, ref = pt.render_frame(cam), want.render_frame(cam)
    assert torch.equal(img, ref)
    assert not torch.equal(before, ref)  # the textures changed the frame
