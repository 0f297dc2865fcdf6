"""The traversal step cap and the path tracer's tiling against the JAX
package.

Capped traces (`max_steps` 1, 7 and 64) on the Cornell box and the small
atrium: the port's plain traces and a plain model of the capped kernel's
walk (test_torch_walks.record_walk) against the JAX package's
`trace_closest` and `trace_any` with `max_steps`, bit for bit in t, slot,
u, v and occlusion; `trace_closest_steps` with `max_steps` 7 and 64 in its
steps too. Capped path-traced frames of the 40x24 atrium against
the JAX path tracer without the packet tracer (RMSE <= 1e-3, equal ray
counts), tiled as JAX tiles them; a tiled frame is bit-equal to the untiled
one, with the rays sorted."""
import numpy as np
import pytest
import torch
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from idkengine_tpu.bvh.builder import BuildSettings as JBuildSettings  # noqa: E402
from idkengine_tpu.ops import trace as j_trace  # noqa: E402
from idkengine_tpu.render import Camera as JCamera  # noqa: E402
from idkengine_tpu.render import PathTracer as JPathTracer  # noqa: E402
from idkengine_tpu.render import PathTracerSettings as JSettings  # noqa: E402
from idkengine_tpu.scene.procedural import atrium as j_atrium  # noqa: E402
from idkengine_tpu.scene.procedural import cornell_box as j_cornell  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch.bvh.builder import BuildSettings  # noqa: E402
from idkengine_tpu_torch.ops import packet_trace  # noqa: E402
from idkengine_tpu_torch.ops.trace import JAX_FIELDS, from_jax_scene_arrays  # noqa: E402
from idkengine_tpu_torch.render import Camera, PathTracer, PathTracerSettings  # noqa: E402
from idkengine_tpu_torch.scene.procedural import atrium  # noqa: E402
from idkengine_tpu_torch.scene.scene_db import SceneDatabase  # noqa: E402

from test_torch_trace import jax_core  # noqa: E402,F401
from test_torch_walks import record_walk  # noqa: E402
from test_torch_wide_bvh import _rays  # noqa: E402

CAPS = (1, 7, 64)
RMSE_MAX = 1e-3
W, H = 40, 24
BUILD = dict(max_leaf_triangle_count=12, traversal_cost=4.0, presplit_factor=0.0)
LIGHTS = [([0.0, 10.5, 0.0], [40.0, 38.0, 35.0], 0.8), ([6.0, 4.0, -20.0], [20.0, 10.0, 5.0], 0.5)]
CAM = dict(position=np.array([0.0, 3.0, 24.0], np.float32), yaw=-90.0, fov_y=65.0)
SETTINGS = dict(ray_depth=2, russian_roulette=False, sky_strength=1.0)


@pytest.fixture(scope="module", params=["cornell", "atrium"])
def scene(request):
    db = JSceneDatabase(JBuildSettings(**BUILD))
    db.add_model(j_cornell() if request.param == "cornell" else j_atrium(8000))
    jsc = db.build()
    arrays = {k: np.asarray(getattr(jsc, k)) for k in JAX_FIELDS}
    return jsc, from_jax_scene_arrays(arrays, jsc.max_leaf, "cpu")


@pytest.mark.parametrize("cap", CAPS)
def test_capped_traces_match_jax(scene, cap):
    """Rays from inside the scene box, axis-parallel, from 1e8 away; dead
    rays and limits of 0 to infinity."""
    jsc, sc = scene
    o, d, t_max, _ = _rays(sc, 1024, 11)
    to, td, tt = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max)
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)
    want = j_trace.trace_closest(jsc, jo, jd, jt, max_steps=cap)
    got = packet_trace.trace_closest(sc, to, td, tt, max_steps=cap)
    walk, steps = record_walk(sc, to, td, tt, max_steps=cap)
    for k in ("t", "slot", "u", "v"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
        np.testing.assert_array_equal(getattr(walk, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert int(steps.max()) <= cap
    occ_want = np.asarray(j_trace.trace_any(jsc, jo, jd, jt, max_steps=cap))
    np.testing.assert_array_equal(packet_trace.trace_any(sc, to, td, tt, max_steps=cap).numpy(),
                                  occ_want)
    any_walk, _ = record_walk(sc, to, td, tt, max_steps=cap, any_hit=True)
    np.testing.assert_array_equal(any_walk.slot.numpy() >= 0, occ_want)
    # the cap stops rays: fewer hits than the uncapped trace, where one
    # step cannot reach a leaf
    full = packet_trace.trace_closest(sc, to, td, tt)
    if cap == 1:
        assert (got.slot.numpy() >= 0).sum() < (full.slot.numpy() >= 0).sum()


@pytest.mark.parametrize("cap", (7, 64))
def test_capped_steps_match_jax(scene, cap):
    """trace_closest_steps with max_steps: steps and hits bit for bit
    against the JAX package's, each ray's steps at most the cap."""
    jsc, sc = scene
    o, d, t_max, _ = _rays(sc, 1024, 13)
    want, want_steps = j_trace.trace_closest_steps(jsc, jnp.asarray(o), jnp.asarray(d),
                                                   jnp.asarray(t_max), max_steps=cap)
    got, steps = packet_trace.trace_closest_steps(sc, torch.from_numpy(o), torch.from_numpy(d),
                                                  torch.from_numpy(t_max), max_steps=cap)
    np.testing.assert_array_equal(steps.numpy(), np.asarray(want_steps))
    for k in ("t", "slot", "u", "v"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert int(steps.max()) <= cap


def test_cap_zero_and_the_default(scene):
    """max_steps=0 takes no step (every ray misses, t = t_max); a cap above
    every ray's steps is the uncapped trace."""
    _, sc = scene
    o, d, t_max, _ = _rays(sc, 256, 12)
    to, td, tt = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max)
    none = packet_trace.trace_closest(sc, to, td, tt, max_steps=0)
    assert (none.slot.numpy() == -1).all()
    np.testing.assert_array_equal(none.t.numpy(), t_max)
    assert not packet_trace.trace_any(sc, to, td, tt, max_steps=0).any()
    full = packet_trace.trace_closest(sc, to, td, tt)
    big = packet_trace.trace_closest(sc, to, td, tt, max_steps=1 << 30)
    for k in ("t", "slot", "u", "v"):
        assert torch.equal(getattr(big, k), getattr(full, k)), k
    with pytest.raises(ValueError):
        packet_trace.trace_closest(sc, to, td, tt, max_steps=-1)


@pytest.fixture(scope="module")
def atrium_pair():
    db = SceneDatabase(BuildSettings(**BUILD))
    db.add_model(atrium(8000))
    scene = db.build("cpu")
    jdb = JSceneDatabase(JBuildSettings(**BUILD))
    jdb.add_model(j_atrium(8000))
    jscene = jdb.build()
    for pos, rad, r in LIGHTS:
        db.lights.add(pos, rad, radius=r)
        jdb.lights.add(pos, rad, radius=r)
    return (db, scene), (jdb, jscene)


def _port_pt(atrium_pair, **kw):
    db, scene = atrium_pair[0]
    return PathTracer(scene, db.materials.soa(), db.lights.soa(), W, H,
                      PathTracerSettings(**{**SETTINGS, **kw}), device="cpu")


@pytest.mark.parametrize("cap,tile", [(64, 0), (24, W * H // 4)])
def test_capped_pathtracer_matches_jax(atrium_pair, cap, tile):
    """A cap that stops most primaries (24) and one that stops some (64),
    the first untiled, the second in four tiles as JAX tiles it."""
    jdb, jscene = atrium_pair[1]
    pt = _port_pt(atrium_pair, max_trace_steps=cap, tile_size=tile)
    jpt = JPathTracer(jscene, jdb.materials.soa(), jdb.lights.soa(), W, H,
                      JSettings(**SETTINGS, max_trace_steps=cap, tile_size=tile,
                                use_packet_tracer=False))
    img = pt.render_frame(Camera(**CAM)).numpy()
    jimg = np.asarray(jpt.render_frame(JCamera(**CAM)))
    assert float(np.sqrt(np.mean((img - jimg) ** 2))) <= RMSE_MAX
    assert float(pt.last_rays_traced) == float(jpt.last_rays_traced)
    uncapped = _port_pt(atrium_pair).render_frame(Camera(**CAM)).numpy()
    assert np.abs(img - uncapped).max() > 1e-2  # the cap changed the image


@pytest.mark.parametrize("cap", [None, 64])
def test_tiled_image_equals_untiled(atrium_pair, cap):
    """Tiles of a quarter of the batch, rays sorted between bounces, three
    bounces, two frames: bit for bit the untiled images and ray counts."""
    kw = dict(ray_depth=3, do_ray_sorting=True)
    if cap is not None:
        kw["max_trace_steps"] = cap
    tiled = _port_pt(atrium_pair, tile_size=W * H // 4, **kw)
    whole = _port_pt(atrium_pair, **kw)
    odd = _port_pt(atrium_pair, tile_size=W * H // 4 + 1, **kw)  # no whole tiles: one launch
    for _ in range(2):
        img = tiled.render_frame(Camera(**CAM)).numpy()
        np.testing.assert_array_equal(img, whole.render_frame(Camera(**CAM)).numpy())
        np.testing.assert_array_equal(img, odd.render_frame(Camera(**CAM)).numpy())
    assert float(tiled.last_rays_traced) == float(whole.last_rays_traced)
