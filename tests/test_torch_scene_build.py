"""The scene build's device flatten and EPO metric against the JAX package,
on the CPU.

`flatten_triangles_device` against the JAX package's
`flatten_triangles_device` and the port's host `flatten_triangles` on the
Cornell box and the small atrium: every field bit-equal (the face normal's
fused cross product and its norm's rounding included). The SceneArrays of
`SceneDatabase.build` and `refit_host` (and of `update`, through the same
upload) hold the device flatten's tables. `BLAS.epo` against the JAX
package's on the same mesh, held to a relative 1e-6: both compute it in
the same C++ source with the same flags, summing the worker threads' parts
in a fixed order, and both meshes stay below the builder's threaded
recursion (8,192 triangles, `bvh.cpp:kSpawnMin`), so both trees number
their nodes alike (EPO samples nodes by index above 8,192 nodes).
`SceneMeta.epo` is set and logged after each build, and `IDK_EPO=0` skips
it as in the JAX package."""
import logging

import numpy as np
import pytest
import torch
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")

from idkengine_tpu.bvh import builder as j_builder  # noqa: E402
from idkengine_tpu.bvh import flatten as j_flatten  # noqa: E402
from idkengine_tpu_torch.bvh import flatten  # noqa: E402
from idkengine_tpu_torch.bvh.builder import BLAS, BuildSettings  # noqa: E402
from idkengine_tpu_torch.scene.procedural import atrium, cornell_box  # noqa: E402
from idkengine_tpu_torch.scene.scene_db import SceneDatabase  # noqa: E402

from test_torch_trace import jax_core  # noqa: E402,F401

FIELDS = ("p0", "e1", "e2", "n_packed", "uv", "mat", "geom_normal")
SCENE_FIELDS = dict(p0="tri_p0", e1="tri_e1", e2="tri_e2", n_packed="tri_n", uv="tri_uv",
                    mat="tri_mat", geom_normal="tri_gn")
EPO_RTOL = 1e-6
BUILD = dict(max_leaf_triangle_count=12, traversal_cost=4.0, presplit_factor=0.0)


@pytest.fixture(scope="module", params=["cornell", "atrium"])
def db(request):
    db = SceneDatabase(BuildSettings(**BUILD))
    db.add_model(cornell_box() if request.param == "cornell" else atrium(8000))
    db.build("cpu")
    return db


def _args(db):
    return (db._slot_tri, db._verts, db._indices, db._normals, db._uvs, db._tri_mat)


def _bits(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    return np.ascontiguousarray(a).view(np.uint8)


def test_device_flatten_equals_jax_and_host(db):
    host = flatten.flatten_triangles(*_args(db))
    dev = flatten.flatten_triangles_device(*_args(db), device="cpu")
    want = j_flatten.flatten_triangles_device(*_args(db))
    for f in FIELDS:
        got = getattr(dev, f)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu", f
        np.testing.assert_array_equal(_bits(got), _bits(getattr(want, f)), err_msg=f)
        np.testing.assert_array_equal(_bits(got), _bits(getattr(host, f)), err_msg=f)
    # without UVs: zeros, as the host flatten's
    args = list(_args(db))
    args[4] = None
    assert not flatten.flatten_triangles_device(*args, device="cpu").uv.any()


def test_build_update_and_refit_hold_the_device_flatten(db):
    def check(scene):
        host = flatten.flatten_triangles(*_args(db))
        for f, k in SCENE_FIELDS.items():
            np.testing.assert_array_equal(_bits(getattr(scene, k)), _bits(getattr(host, f)),
                                          err_msg=k)
        want = torch.cat([scene.tri_p0, scene.tri_e1, scene.tri_e2,
                          torch.zeros_like(scene.tri_p0)], dim=1)
        assert torch.equal(scene.tri_vec, want)

    check(db.device_scene)
    verts = db._verts.copy()
    try:
        check(db.refit_host(verts * np.float32(1.01) + np.float32(0.25)))
    finally:
        db.refit_host(verts)
    check(db.device_scene)


def test_epo_matches_jax(db):
    got = db.blas.epo()
    want = j_builder.BLAS(db._verts, db._indices, j_builder.BuildSettings(**BUILD)).epo()
    assert np.isfinite(got) and got > 0
    assert got == pytest.approx(want, rel=EPO_RTOL)
    assert db.meta.epo == got
    # a strided estimate over fewer sampled nodes is still finite
    assert np.isfinite(db.blas.epo(max_nodes=4))


def test_epo_is_logged_and_can_be_skipped(monkeypatch):
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    assert BLAS(verts, np.array([[0, 1, 2], [0, 2, 3]], np.uint32)).epo() >= 0.0
    sdb = SceneDatabase()
    sdb.add_model(cornell_box())
    records = []
    handler = logging.Handler(logging.INFO)
    handler.emit = records.append
    logger = logging.getLogger("idkengine_tpu_torch.scene.scene_db")
    logger.addHandler(handler)
    monkeypatch.setattr(logger, "level", logging.INFO)
    try:
        sdb.build("cpu")
    finally:
        logger.removeHandler(handler)
    assert np.isfinite(sdb.meta.epo)
    assert any("SAH" in r.getMessage() and f"EPO {sdb.meta.epo:.3f}" in r.getMessage()
               for r in records)
    monkeypatch.setenv("IDK_EPO", "0")
    sdb.build("cpu")
    assert np.isnan(sdb.meta.epo)
