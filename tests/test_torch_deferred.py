"""The deferred pipeline on the CPU: each ported pass and the whole frame
graph against the JAX package, on the same numpy-seeded inputs and the same
Cornell box. The JAX pipeline runs with `use_packet_tracer=False`, the trace
it runs on the CPU.

Tolerances: image-space passes repeat JAX's float32 operations in the same
order, so they agree to float32 rounding (rtol 1e-5 over a few dozen
operations). Traced quantities carry the traces' last-place differences in
t (tests/test_torch_trace.py). The tonemapped frame is held to the golden
contract of tests/test_golden.py, RMSE <= 1e-3.
"""
import numpy as np
import pytest
import torch
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from idkengine_tpu.ops.trace import trace_any as j_trace_any  # noqa: E402
from idkengine_tpu.ops.trace import trace_closest as j_trace_closest  # noqa: E402
from idkengine_tpu.render import Camera as JCamera  # noqa: E402
from idkengine_tpu.render import bloom as j_bloom  # noqa: E402
from idkengine_tpu.render import deferred as j_deferred  # noqa: E402
from idkengine_tpu.render import ssao as j_ssao  # noqa: E402
from idkengine_tpu.render import taa as j_taa  # noqa: E402
from idkengine_tpu.render.gbuffer import render_gbuffer as j_render_gbuffer  # noqa: E402
from idkengine_tpu.render.pipeline import DeferredPipeline as JDeferredPipeline  # noqa: E402
from idkengine_tpu.render.pipeline import DeferredSettings2 as JDeferredSettings2  # noqa: E402
from idkengine_tpu.render.vxgi import VxgiSettings as JVxgiSettings  # noqa: E402
from idkengine_tpu.scene.procedural import cornell_box as j_cornell  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu.utils import mathutil as j_mu  # noqa: E402
from idkengine_tpu_torch.ops import packet_trace  # noqa: E402
from idkengine_tpu_torch.render import Camera, DeferredPipeline, DeferredSettings2  # noqa: E402
from idkengine_tpu_torch.render import bloom, deferred, ssao, taa  # noqa: E402
from idkengine_tpu_torch.render.gbuffer import GBuffer, render_gbuffer  # noqa: E402
from idkengine_tpu_torch.render.vxgi import VxgiSettings  # noqa: E402
from idkengine_tpu_torch.scene.procedural import cornell_box  # noqa: E402
from idkengine_tpu_torch.scene.scene_db import SceneDatabase  # noqa: E402
from idkengine_tpu_torch.utils import mathutil as mu  # noqa: E402

from test_torch_trace import jax_core  # noqa: E402,F401

W, H = 48, 32
LIGHT = ([278, 480, 279.5], [6, 6, 6], 45.0)
CAM = dict(position=np.array([278, 273, -800], np.float32), yaw=90.0, fov_y=38.0)
# the second frame's camera has moved: TAA reprojects its history
CAM2 = dict(CAM, position=np.array([284, 270, -795], np.float32), yaw=89.0)
VX = dict(resolution=16, max_samples=4096)
RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def scenes():
    db = SceneDatabase()
    db.add_model(cornell_box(emissive_quad=False))
    db.build("cpu")
    db.lights.add(*LIGHT[:2], radius=LIGHT[2])
    jdb = JSceneDatabase()
    jdb.add_model(j_cornell(emissive_quad=False))
    jdb.build()
    jdb.lights.add(*LIGHT[:2], radius=LIGHT[2])
    return db, jdb


def _lights(db):
    soa = db.lights.soa()
    return ({k: torch.from_numpy(soa[k]) for k in ("pos", "radius", "radiance")},
            {k: jnp.asarray(soa[k]) for k in ("pos", "radius", "radiance")})


def test_halton_matches_jax():
    np.testing.assert_array_equal(mu.halton_2d(16), j_mu.halton_2d(16))
    np.testing.assert_array_equal(mu.halton(np.arange(40), 5), j_mu.halton(np.arange(40), 5))


def test_taa_resolve_matches_jax():
    rng = np.random.default_rng(1)
    color = rng.uniform(0, 4, (H, W, 3)).astype(np.float32)
    hist = rng.uniform(0, 4, (H, W, 3)).astype(np.float32)
    vel = rng.normal(0, 2.5, (H, W, 2)).astype(np.float32)  # some leave the screen
    depth = rng.uniform(0.01, 2.0, (H, W)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (color, hist, vel, depth)]
    j = [jnp.asarray(a) for a in (color, hist, vel, depth)]
    for s in (taa.TaaSettings(), taa.TaaSettings(prefer_aliasing_over_blur=False,
                                                 clamp_history=False)):
        js = j_taa.TaaSettings(**vars(s))
        _close(taa.taa_resolve(*t, s), j_taa.taa_resolve(*j, js))
    assert taa.mip_bias(640, 1280) == j_taa.mip_bias(640, 1280)


@pytest.mark.parametrize("shape", [(H, W), (37, 53)])
def test_bloom_matches_jax(shape):
    rng = np.random.default_rng(2)
    hdr = (rng.uniform(0, 1, shape + (3,)) ** 4 * 30).astype(np.float32)
    _close(bloom.bloom(torch.from_numpy(hdr)), j_bloom.bloom(jnp.asarray(hdr)))


def test_ssao_matches_jax():
    rng = np.random.default_rng(3)
    xy = rng.uniform(-1, 1, (H, W, 2))
    z = -rng.uniform(1.0, 3.0, (H, W, 1))
    view_pos = np.concatenate([xy * -z, z], -1).astype(np.float32)
    nrm = rng.standard_normal((H, W, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    got = ssao.ssao(torch.from_numpy(view_pos), torch.from_numpy(nrm), 5)
    want = j_ssao.ssao(jnp.asarray(view_pos), jnp.asarray(nrm), 5)
    assert float(np.asarray(want).max()) > 0
    _close(got, want)


@pytest.fixture(scope="module")
def gbuffers(scenes):
    db, jdb = scenes
    cam, prev = Camera(**CAM2).ray_params(W, H), Camera(**CAM).ray_params(W, H)
    jitter = mu.halton_2d(16)[3]
    mats = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in db.materials.soa().items()}
    scene = db.device_scene
    gbuf = render_gbuffer(lambda o, d, t: packet_trace.trace_closest(scene, o, d, t), scene,
                          mats, cam, prev, W, H, jitter=torch.from_numpy(jitter))
    jmats = {k: jnp.asarray(v) for k, v in jdb.materials.soa().items()}
    jscene = jdb.device_scene
    jgbuf = j_render_gbuffer(lambda o, d, t: j_trace_closest(jscene, o, d, t), jscene, jmats,
                             JCamera(**CAM2).ray_params(W, H), JCamera(**CAM).ray_params(W, H),
                             W, H, jitter=jnp.asarray(jitter))
    return gbuf, jgbuf


@pytest.mark.parametrize("field", GBuffer._fields)
def test_gbuffer_field_matches_jax(gbuffers, field):
    gbuf, jgbuf = gbuffers
    got, want = getattr(gbuf, field).numpy(), np.asarray(getattr(jgbuf, field))
    assert got.shape == want.shape
    if field == "mask":
        assert want.any() and not want.all()
        np.testing.assert_array_equal(got, want)
    elif field == "depth":
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        _close(got[np.isfinite(want)], want[np.isfinite(want)], atol=1e-3)
    else:
        # positions and velocities are hundreds of units: a last-place
        # difference in t moves them by up to about 1e-4
        _close(got, want, atol=1e-3 if field in ("position", "velocity") else ATOL)
    if field == "velocity":
        assert np.abs(want).max() > 0.5  # the camera moved


def test_shade_deferred_matches_jax(scenes, gbuffers):
    """Both packages shade JAX's G-buffer with ray-traced shadows, SSAO and
    an indirect term, each tracing its own scene."""
    db, jdb = scenes
    _, jgbuf = gbuffers
    rng = np.random.default_rng(4)
    gi = rng.uniform(0, 0.5, (H, W, 3)).astype(np.float32)
    ao = rng.uniform(0, 1, (H, W)).astype(np.float32)
    gbuf = GBuffer(*[torch.from_numpy(np.array(f)) for f in jgbuf])
    lights, jlights = _lights(db)
    origin = CAM2["position"]
    scene, jscene = db.device_scene, jdb.device_scene
    got = deferred.shade_deferred(
        gbuf, lights, 1, origin, lambda o, d, t: packet_trace.trace_any(scene, o, d, t),
        gi=torch.from_numpy(gi), ao=torch.from_numpy(ao), frame=7)
    want = j_deferred.shade_deferred(
        jgbuf, jlights, 1, jnp.asarray(origin), lambda o, d, t: j_trace_any(jscene, o, d, t),
        gi=jnp.asarray(gi), ao=jnp.asarray(ao), frame=7)
    assert float(np.asarray(want).max()) > 0
    _close(got, want, atol=1e-5)
    # unshadowed, flat ambient
    got = deferred.shade_deferred(gbuf, lights, 1, origin, None)
    want = j_deferred.shade_deferred(jgbuf, jlights, 1, jnp.asarray(origin), None)
    _close(got, want, atol=1e-5)
    # the point shader of the transparent layers
    r = H * W
    args = [np.asarray(jgbuf.position).reshape(r, 3), np.asarray(jgbuf.normal).reshape(r, 3),
            np.asarray(jgbuf.albedo).reshape(r, 3), np.asarray(jgbuf.metallic).reshape(r),
            np.asarray(jgbuf.roughness).reshape(r)]
    got = deferred.shade_points(*[torch.from_numpy(np.array(a)) for a in args], origin, lights, 1,
                                lambda o, d, t: packet_trace.trace_any(scene, o, d, t), frame=2)
    want = j_deferred.shade_points(*[jnp.asarray(a) for a in args], jnp.asarray(origin),
                                   jlights, 1, lambda o, d, t: j_trace_any(jscene, o, d, t),
                                   frame=2)
    _close(got, want, atol=1e-5)


def test_pipeline_matches_jax_over_two_frames(scenes):
    """VXGI, SSAO, TAA, bloom and ray-traced shadows; the second frame reads
    the TAA history of the first through a moved camera."""
    db, jdb = scenes
    pipe = DeferredPipeline(db, W, H, DeferredSettings2(use_vxgi=True, vxgi=VxgiSettings(**VX)),
                            device="cpu")
    jpipe = JDeferredPipeline(jdb, W, H, JDeferredSettings2(
        use_vxgi=True, vxgi=JVxgiSettings(**VX), use_packet_tracer=False))
    for cam in (CAM, CAM2):
        got = pipe.render_frame(Camera(**cam)).numpy()
        want = np.asarray(jpipe.render_frame(JCamera(**cam)))
        assert got.shape == (H, W, 3) and np.isfinite(got).all()
        assert 0.0 <= got.min() and got.max() <= 1.0 and got.std() > 0.05
        assert float(np.sqrt(np.mean((got - want) ** 2))) <= 1e-3
    assert pipe.frame == 2 and pipe.voxel_grid.radiance.shape == (4, 16, 16, 16)


def test_pipeline_refuses_scene_on_another_device(scenes):
    db, _ = scenes
    with pytest.raises(ValueError):
        DeferredPipeline(db, W, H, device="meta")
