"""The port's debug views vs the JAX package's: per-ray traversal steps of
the plain stackless trace, the traversal-cost heatmap, the Turbo colormap
and the selection-box overlay.

Tolerances: steps and slots exactly equal (both walk the same threaded tree
in the same order, one node per step); heatmap colours within 5e-5: the
Turbo polynomial sums six float32 terms with coefficients up to 153, whose
last-place rounding (153 * 2^-24, about 1e-5 each) the two frameworks
distribute differently; the overlay exactly equal (numpy on both sides).

The JAX heatmap on the path without the packet tracer makes its rays in
tile-swizzle order and returns the counts in that order, unpermuted; the
swizzle is the identity only up to 64x64. So the two heatmaps are compared
at 32x32, and at 96x80 the port's is shown to be in pixel order and the
JAX one a tile-swizzled shuffle of it (a reference fault, not copied).
"""
import numpy as np
import pytest
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from idkengine_tpu.ops import trace as j_trace  # noqa: E402
from idkengine_tpu.render import Camera as JCamera  # noqa: E402
from idkengine_tpu.render import PathTracer as JPathTracer  # noqa: E402
from idkengine_tpu.render import PathTracerSettings as JSettings  # noqa: E402
from idkengine_tpu.render import debug_view as j_dv  # noqa: E402
from idkengine_tpu.render.pathtracer import tile_swizzle  # noqa: E402
from idkengine_tpu.scene.procedural import atrium as j_atrium  # noqa: E402
from idkengine_tpu.scene.procedural import cornell_box as j_cornell  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch.ops import packet_trace as t_pt  # noqa: E402
from idkengine_tpu_torch.render import Camera, PathTracer, PathTracerSettings  # noqa: E402
from idkengine_tpu_torch.render import debug_view as dv  # noqa: E402
from idkengine_tpu_torch.render.camera import generate_rays  # noqa: E402
from idkengine_tpu_torch.scene.procedural import cornell_box  # noqa: E402
from idkengine_tpu_torch.scene.scene_db import SceneDatabase  # noqa: E402

from test_torch_trace import BENCH, _port_scene, _rays, jax_core  # noqa: E402,F401

CAM = dict(position=np.array([278, 273, -800], np.float32), yaw=90.0, fov_y=38.0)
COLOR_ATOL = 5e-5


@pytest.fixture(scope="module")
def atrium_db():
    db = JSceneDatabase(BENCH)
    db.add_model(j_atrium(4000))
    return db, db.build()


def test_plain_steps_match_jax(atrium_db):
    _, jsc = atrium_db
    sc = _port_scene(jsc)
    o, d = _rays(jsc, 2048, 21)
    t_max = np.where(np.arange(2048) % 7 == 0, -1.0, 3.4e38).astype(np.float32)
    want, want_steps = j_trace.trace_closest_steps(jsc, jnp.asarray(o), jnp.asarray(d),
                                                   jnp.asarray(t_max))
    got, steps = t_pt.trace_closest_steps(sc, torch.from_numpy(o), torch.from_numpy(d),
                                          torch.from_numpy(t_max))
    np.testing.assert_array_equal(steps.numpy(), np.asarray(want_steps))
    np.testing.assert_array_equal(got.slot.numpy(), np.asarray(want.slot))
    assert steps.dtype == torch.int32 and (steps.numpy()[t_max < 0] == 1).all()
    # the same hits as the one-phase trace
    one = t_pt.trace_closest(sc, torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(t_max))
    for k in ("t", "slot", "u", "v"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(one, k).numpy())


@pytest.fixture(scope="module")
def cornell():
    jdb = JSceneDatabase()
    jdb.add_model(j_cornell(emissive_quad=False))
    jscene = jdb.build()
    db = SceneDatabase()
    db.add_model(cornell_box(emissive_quad=False))
    scene = db.build("cpu")
    return jdb, jscene, db, scene


def _pts(cornell, w, h):
    jdb, jscene, db, scene = cornell
    jpt = JPathTracer(jscene, jdb.materials.soa(), jdb.lights.soa(), w, h,
                      JSettings(use_packet_tracer=False))
    pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), w, h, PathTracerSettings(),
                    device="cpu")
    return jpt, pt


def test_cost_image_matches_jax_at_32(cornell):
    jpt, pt = _pts(cornell, 32, 32)
    want = np.asarray(j_dv.traversal_cost_image(jpt, JCamera(**CAM), max_cost=64))
    got = dv.traversal_cost_image(pt, Camera(**CAM), max_cost=64).numpy()
    assert got.shape == (32, 32, 3) and got.std() > 0.01
    np.testing.assert_allclose(got, want, rtol=0, atol=COLOR_ATOL)


def test_cost_image_in_pixel_order_at_96x80(cornell):
    w, h = 96, 80
    jpt, pt = _pts(cornell, w, h)
    cam = Camera(**CAM)
    got = dv.traversal_cost_image(pt, cam, max_cost=64).numpy()
    o, d = generate_rays(cam.ray_params(w, h), w, h, torch.zeros((w * h, 2)))
    _, steps = t_pt.trace_closest_steps(pt.scene, o, d, 3.4e38)
    want = dv.turbo(steps.float() / 64).reshape(h, w, 3).numpy()
    np.testing.assert_array_equal(got, want)
    # the reference's heatmap puts pixel swz[i]'s colour at position i
    jimg = np.asarray(j_dv.traversal_cost_image(jpt, JCamera(**CAM), max_cost=64))
    swz = tile_swizzle(w, h)
    assert not np.array_equal(swz, np.arange(w * h))
    np.testing.assert_allclose(jimg.reshape(-1, 3), got.reshape(-1, 3)[swz], rtol=0,
                               atol=COLOR_ATOL)


def test_turbo_matches_jax():
    x = np.linspace(-0.2, 1.2, 101).astype(np.float32)
    np.testing.assert_allclose(dv.turbo(torch.from_numpy(x)).numpy(),
                               np.asarray(j_dv.turbo(jnp.asarray(x))), rtol=0,
                               atol=COLOR_ATOL)


@pytest.mark.parametrize("thickness", [1, 3])
def test_box_overlay_matches_jax(thickness):
    rng = np.random.default_rng(5)
    base = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    args = ([100, 0, 100], [456, 300, 459])
    want = j_dv.draw_box_overlay(base, JCamera(**CAM), *args, thickness=thickness)
    got = dv.draw_box_overlay(torch.from_numpy(base), Camera(**CAM), *args,
                              thickness=thickness)
    assert (got != base).any()
    np.testing.assert_array_equal(got, want)
