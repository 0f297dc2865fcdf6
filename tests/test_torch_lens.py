"""The path tracer's thin lens against the JAX package: a 48x32 atrium seen
through a lens of radius 0.05, depth 2, two frames, as the JAX path tracer
without the packet tracer renders it (RMSE <= 1e-3, equal ray counts), and
the lens rays themselves against the jitted JAX function.

The rays are not bit-equal: XLA:CPU computes the lens angle's sine and
cosine with the C library's sinf and cosf, ATen with its own vector code,
and about 1% of them differ in the last place. The lens offset then moves
by at most two units in the last place of the lens radius, the origin by
that and one unit in the last place of its coordinate (where the sum
rounds the other way), the direction by at most two of 1 (the tolerances
below); the pinhole part of the rays is bit-equal
(tests/test_torch_env.py::test_camera_rays_round_as_jax)."""
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
from idkengine_tpu.render.camera import generate_rays as j_generate_rays  # noqa: E402
from idkengine_tpu.scene.procedural import atrium as j_atrium  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch.bvh.builder import BuildSettings  # noqa: E402
from idkengine_tpu_torch.render import Camera, PathTracer, PathTracerSettings  # noqa: E402
from idkengine_tpu_torch.render.camera import generate_rays  # noqa: E402
from idkengine_tpu_torch.scene.procedural import atrium  # noqa: E402
from idkengine_tpu_torch.scene.scene_db import SceneDatabase  # noqa: E402

from test_torch_trace import jax_core  # noqa: E402,F401

W, H = 48, 32
RMSE_MAX = 1e-3
BUILD = dict(max_leaf_triangle_count=12, traversal_cost=4.0, presplit_factor=0.0)
LIGHTS = [([0.0, 10.5, 0.0], [40.0, 38.0, 35.0], 0.8), ([6.0, 4.0, -20.0], [20.0, 10.0, 5.0], 0.5)]
LENS_CAM = dict(position=np.array([0.0, 3.0, 24.0], np.float32), yaw=-90.0, fov_y=65.0,
                lens_radius=0.05, focal_distance=12.0)
SETTINGS = dict(ray_depth=2, russian_roulette=False, sky_strength=1.0)


@pytest.mark.parametrize("size", [(W, H), (40, 24)])
def test_lens_rays_round_as_jit(size):
    """The path tracer's rays with a lens against the jitted JAX function's,
    to the rounding of the lens angle's sine and cosine; most rays equal."""
    w, h = size
    params = JCamera(**LENS_CAM).ray_params(w, h)
    rs = np.random.RandomState(w + 1)
    jitter, lens = rs.rand(w * h, 2).astype(np.float32), rs.rand(w * h, 2).astype(np.float32)
    jo, jd = map(np.asarray, jax.jit(j_generate_rays, static_argnums=(1, 2))(
        params, w, h, jnp.asarray(jitter), jnp.asarray(lens)))
    o, d = generate_rays(Camera(**LENS_CAM).ray_params(w, h), w, h, torch.from_numpy(jitter),
                         torch.from_numpy(lens), fused=True)
    lens_ulp = float(np.spacing(np.float32(LENS_CAM["lens_radius"])))
    assert (np.abs(o.numpy() - jo) <= 2 * lens_ulp + np.spacing(np.abs(jo))).all()
    np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=2 * float(np.spacing(np.float32(1))))
    assert (o.numpy() == jo).all(axis=1).mean() > 0.95
    assert np.abs(o.numpy() - LENS_CAM["position"]).max() > 0.01  # the lens moved the origins


def test_lens_image_matches_jax():
    db = SceneDatabase(BuildSettings(**BUILD))
    db.add_model(atrium(8000))
    scene = db.build("cpu")
    jdb = JSceneDatabase(JBuildSettings(**BUILD))
    jdb.add_model(j_atrium(8000))
    jscene = jdb.build()
    for pos, rad, r in LIGHTS:
        db.lights.add(pos, rad, radius=r)
        jdb.lights.add(pos, rad, radius=r)
    pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), W, H,
                    PathTracerSettings(**SETTINGS), device="cpu")
    jpt = JPathTracer(jscene, jdb.materials.soa(), jdb.lights.soa(), W, H,
                      JSettings(**SETTINGS, use_packet_tracer=False))
    for _ in range(2):
        img = pt.render_frame(Camera(**LENS_CAM)).numpy()
        jimg = np.asarray(jpt.render_frame(JCamera(**LENS_CAM)))
        assert float(np.sqrt(np.mean((img - jimg) ** 2))) <= RMSE_MAX
        assert float(pt.last_rays_traced) == float(jpt.last_rays_traced)
    assert np.isfinite(img).all() and img.std() > 0
