"""The slice's own configuration, cut to CPU size: a small atrium at depth 2
with the bench's build settings, lights and camera, rays sorted between
bounces. The port's image against the JAX package's (RMSE <= 1e-3, equal
ray counts); sorting on against sorting off; instances of another type than
InstanceSet refused."""
import numpy as np
import pytest
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from idkengine_tpu.bvh.builder import BuildSettings as JBuildSettings  # noqa: E402
from idkengine_tpu.render import Camera as JCamera  # noqa: E402
from idkengine_tpu.render import PathTracer as JPathTracer  # noqa: E402
from idkengine_tpu.render import PathTracerSettings as JSettings  # noqa: E402
from idkengine_tpu.scene.procedural import atrium as j_atrium  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch.bvh.builder import BuildSettings  # noqa: E402
from idkengine_tpu_torch.render import Camera, PathTracer, PathTracerSettings  # noqa: E402
from idkengine_tpu_torch.render.tonemap import tonemap  # noqa: E402
from idkengine_tpu_torch.scene.procedural import atrium  # noqa: E402
from idkengine_tpu_torch.scene.scene_db import SceneDatabase  # noqa: E402

from test_torch_trace import jax_core  # noqa: E402,F401

W, H = 40, 24
# bench.py's main path: build settings, lights, camera and tracer settings
BUILD = dict(max_leaf_triangle_count=12, traversal_cost=4.0, presplit_factor=0.0)
LIGHTS = [([0.0, 10.5, 0.0], [40.0, 38.0, 35.0], 0.8), ([6.0, 4.0, -20.0], [20.0, 10.0, 5.0], 0.5)]
CAM = dict(position=np.array([0.0, 3.0, 24.0], np.float32), yaw=-90.0, fov_y=65.0)
SETTINGS = dict(ray_depth=2, russian_roulette=False, do_ray_sorting=True, sky_strength=1.0)


@pytest.fixture(scope="module")
def port_db():
    db = SceneDatabase(BuildSettings(**BUILD))
    db.add_model(atrium(8000))
    scene = db.build("cpu")
    for pos, rad, r in LIGHTS:
        db.lights.add(pos, rad, radius=r)
    return db, scene


def _port_pt(port_db, **kw):
    db, scene = port_db
    return PathTracer(scene, db.materials.soa(), db.lights.soa(), W, H,
                      PathTracerSettings(**{**SETTINGS, **kw}), device="cpu")


def test_atrium_matches_jax_pathtracer(port_db):
    pt = _port_pt(port_db)
    img = pt.render_frame(Camera(**CAM)).numpy()
    db = JSceneDatabase(JBuildSettings(**BUILD))
    db.add_model(j_atrium(8000))
    scene = db.build()
    for pos, rad, r in LIGHTS:
        db.lights.add(pos, rad, radius=r)
    jpt = JPathTracer(scene, db.materials.soa(), db.lights.soa(), W, H,
                      JSettings(**SETTINGS, use_packet_tracer=False))
    jimg = np.asarray(jpt.render_frame(JCamera(**CAM)))
    assert float(np.sqrt(np.mean((img - jimg) ** 2))) <= 1e-3
    assert float(pt.last_rays_traced) == float(jpt.last_rays_traced)
    assert np.isfinite(img).all() and img.std() > 0
    out = tonemap(torch.from_numpy(img)).numpy()
    assert out.shape == (H, W, 3) and out.min() >= 0.0 and out.max() <= 1.0


def test_sorting_leaves_the_image_unchanged(port_db):
    cam = Camera(**CAM)
    on = _port_pt(port_db, do_ray_sorting=True, ray_depth=3)
    off = _port_pt(port_db, do_ray_sorting=False, ray_depth=3)
    for _ in range(2):
        img_on = on.render_frame(cam).numpy()
        img_off = off.render_frame(cam).numpy()
    np.testing.assert_array_equal(img_on, img_off)
    assert float(on.last_rays_traced) == float(off.last_rays_traced)


@pytest.mark.parametrize("what", ["instances"])
def test_features_outside_the_slice_raise(port_db, what):
    """Instances are in the port since the dynamics slice: the tracer takes
    an InstanceSet (tests/test_torch_instancing.py) and refuses anything else."""
    db, scene = port_db
    with pytest.raises(TypeError):
        PathTracer(scene, db.materials.soa(), db.lights.soa(), W, H, device="cpu",
                   instances=object())
