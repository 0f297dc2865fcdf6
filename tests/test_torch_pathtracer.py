"""The whole slice on the CPU: the port's PathTracer against the JAX
package's PathTracer (same scene, camera, settings and frame index) and
against the stored Cornell golden, each at RMSE <= 1e-3 (the golden
contract of tests/test_golden.py), with equal ray counts."""
import os

import numpy as np
import pytest
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")

from idkengine_tpu.render import Camera as JCamera  # noqa: E402
from idkengine_tpu.render import PathTracer as JPathTracer  # noqa: E402
from idkengine_tpu.render import PathTracerSettings as JSettings  # noqa: E402
from idkengine_tpu.scene.procedural import cornell_box as j_cornell  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch.render import Camera, PathTracer, PathTracerSettings  # noqa: E402
from idkengine_tpu_torch.scene.procedural import cornell_box  # noqa: E402
from idkengine_tpu_torch.scene.scene_db import SceneDatabase  # noqa: E402

from test_torch_trace import jax_core  # noqa: E402,F401

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "cornell_64_4spp.npz")
RMSE_MAX = 1e-3
# tests/test_golden.py::_cornell_pt
CORNELL = dict(ray_depth=4, sky_strength=0.0, use_packet_tracer=False, spp_per_frame=4)
CAM = dict(position=np.array([278, 273, -800], np.float32), yaw=90.0, fov_y=38.0)
LIGHT = ([278, 480, 279.5], [6, 6, 6], 45.0)


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _port_cornell(**settings):
    db = SceneDatabase()
    db.add_model(cornell_box(emissive_quad=False))
    scene = db.build("cpu")
    db.lights.add(*LIGHT[:2], radius=LIGHT[2])
    return PathTracer(scene, db.materials.soa(), db.lights.soa(), 64, 64,
                      PathTracerSettings(**{**CORNELL, **settings}), device="cpu")


@pytest.fixture(scope="module")
def port_cornell():
    pt = _port_cornell()
    img = pt.render_frame(Camera(**CAM)).numpy()
    return pt, img


def test_cornell_matches_golden(port_cornell):
    _, img = port_cornell
    assert _rmse(img, np.load(GOLDEN)["img"]) <= RMSE_MAX


def test_cornell_matches_jax_pathtracer(port_cornell):
    pt, img = port_cornell
    db = JSceneDatabase()
    db.add_model(j_cornell(emissive_quad=False))
    scene = db.build()
    db.lights.add(*LIGHT[:2], radius=LIGHT[2])
    jpt = JPathTracer(scene, db.materials.soa(), db.lights.soa(), 64, 64, JSettings(**CORNELL))
    jimg = np.asarray(jpt.render_frame(JCamera(**CAM)))
    assert _rmse(img, jimg) <= RMSE_MAX
    assert float(pt.last_rays_traced) == float(jpt.last_rays_traced)
    # AOVs of the last sample: albedo, normal, depth (primary hit distance,
    # which carries the ray directions' last-place differences)
    for got, want in zip(pt._last_aovs, jpt._last_aovs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)
    # the second frame continues the seed sequence and accumulation
    img2 = pt.render_frame(Camera(**CAM)).numpy()
    jimg2 = np.asarray(jpt.render_frame(JCamera(**CAM)))
    assert _rmse(img2, jimg2) <= RMSE_MAX
    # per-pixel variance; a path whose lobe or roulette draw lies within
    # rounding of its threshold may branch differently, so a few pixels
    # may differ
    close = np.isclose(pt.variance().numpy(), np.asarray(jpt.variance()), rtol=1e-2, atol=1e-6)
    assert close.mean() >= 0.99
