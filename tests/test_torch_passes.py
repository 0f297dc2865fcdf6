"""The deferred frame's optional passes against the JAX package on the same
numpy-seeded inputs: volumetric light (unshadowed, with the Cornell box's
occlusion trace, and the JAX package's shadowed-march test), SSR (on a
G-buffer of the box, and the JAX package's refinement and sky-fallback
test), the OIT peel and composite, the TAAU upsamplers and resolve, and the
rate classifier.

Tolerances. The JAX package jits volumetric_light and ssr, and XLA:CPU
fuses their products into additions; the port rounds each operation
alone, so their values agree to float32 rounding over a few dozen
operations (rtol 1e-5, atol 1e-6) and the occlusion and SSR hit decisions
on every pixel but those within a rounding of a boundary (at least 99.5%
of SSR's pixels). The other passes run eagerly in the JAX package, op by
op as the port does, and agree to the same tolerance or exactly."""
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
from idkengine_tpu.render import adaptive as j_adaptive  # noqa: E402
from idkengine_tpu.render import oit as j_oit  # noqa: E402
from idkengine_tpu.render import ssr as j_ssr  # noqa: E402
from idkengine_tpu.render import upscale as j_upscale  # noqa: E402
from idkengine_tpu.render import volumetric as j_vol  # noqa: E402
from idkengine_tpu.render.camera import generate_rays as j_generate_rays  # noqa: E402
from idkengine_tpu.render.gbuffer import render_gbuffer as j_render_gbuffer  # noqa: E402
from idkengine_tpu.scene.procedural import cornell_box as j_cornell  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch.ops import packet_trace  # noqa: E402
from idkengine_tpu_torch.ops.trace import JAX_FIELDS, from_jax_scene_arrays  # noqa: E402
from idkengine_tpu_torch.render import Camera, adaptive, oit, ssr, upscale, volumetric  # noqa: E402
from idkengine_tpu_torch.render.camera import generate_rays  # noqa: E402

from test_torch_trace import jax_core  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-6
# the classifier's tile sums are not added in reduce_window's order, and a
# near-flat tile's variance cancels most digits: 7.0e-4 relative measured
RATE_RTOL = 2e-3
SSR_AGREE = 0.995
W, H = 48, 32
CAM = dict(position=np.array([278, 273, -800], np.float32), yaw=90.0, fov_y=38.0)
LIGHTS_POS = np.float32([[278, 480, 279.5], [120, 300, 150]])
LIGHTS_RAD = np.float32([[60, 60, 60], [30, 20, 10]])


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def box():
    """The Cornell box in both packages and the JAX G-buffer of a frame."""
    db = JSceneDatabase()
    db.add_model(j_cornell(emissive_quad=False))
    jsc = db.build()
    sc = from_jax_scene_arrays({k: np.asarray(getattr(jsc, k)) for k in JAX_FIELDS},
                               jsc.max_leaf, "cpu")
    jmats = {k: jnp.asarray(v) for k, v in db.materials.soa().items()}
    cp = JCamera(**CAM).ray_params(W, H)
    gbuf = j_render_gbuffer(lambda o, d, t: j_trace_closest(jsc, o, d, t), jsc, jmats, cp, cp,
                            W, H, jitter=jnp.full((2,), 0.5))
    return jsc, sc, gbuf


@pytest.mark.parametrize("occluded", [False, True])
@pytest.mark.parametrize("downscale", [1, 2])
def test_volumetric_light_matches_jax(box, occluded, downscale):
    """Four march samples toward two lights from the camera to the box's
    surfaces (depth capped at 200); with `occluded` every sample's shadow
    ray goes through each package's trace of the box."""
    jsc, sc, g = box
    origin = CAM["position"]
    # a camera inside the box, so that the 200-unit march crosses the boxes'
    # shadows
    pos = np.asarray(g.position)
    inside = np.float32([278, 200, 100])
    pos = inside + (pos - origin) * np.float32(0.5)
    depth = np.linalg.norm(pos - inside, axis=-1).astype(np.float32)
    st = volumetric.VolumetricSettings(samples=4, downscale=downscale)
    jst = j_vol.VolumetricSettings(samples=4, downscale=downscale)
    occ = (lambda o, d, t: packet_trace.trace_any(sc, o, d, t)) if occluded else None
    jocc = (lambda o, d, t: j_trace_any(jsc, o, d, t)) if occluded else None
    got = volumetric.volumetric_light(_t(pos), _t(depth), inside, _t(LIGHTS_POS),
                                      _t(LIGHTS_RAD), 2, occ, st)
    want = j_vol.volumetric_light(jnp.asarray(pos), jnp.asarray(depth), jnp.asarray(inside),
                                  jnp.asarray(LIGHTS_POS), jnp.asarray(LIGHTS_RAD), 2, jocc,
                                  settings=jst)
    assert got.shape == (H, W, 3) and float(np.asarray(want).max()) > 0
    _close(got, want)
    if occluded:  # the boxes' shadows darken some pixels
        free = volumetric.volumetric_light(_t(pos), _t(depth), inside, _t(LIGHTS_POS),
                                           _t(LIGHTS_RAD), 2, None, st)
        assert (free - got).max().item() > 1e-3 * free.max().item()


def test_volumetric_shadowed_march():
    """A mirror of tests/test_render.py::test_volumetric_shadowed_march: a
    blocker between the march and the light carves a shaft boundary, and
    the port's march equals JAX's on it."""
    h = w = 32
    xs = np.linspace(-4, 4, w, dtype=np.float32)
    pos = np.zeros((h, w, 3), np.float32)
    pos[..., 0] = xs[None, :]
    pos[..., 2] = 30.0
    depth = np.full((h, w), 30.0, np.float32)
    lp, lr = np.float32([[0.0, 10.0, 15.0]]), np.float32([[200.0, 200.0, 200.0]])

    def occ_box(xp, o, d, t_max):
        """Analytic slab blocker: x in [-2,0], y in [4,6], all z."""
        eps = 1e-9
        dy = xp.where(xp.abs(d[:, 1]) < eps, eps, d[:, 1])
        t0, t1 = (4.0 - o[:, 1]) / dy, (6.0 - o[:, 1]) / dy
        tn, tf = xp.minimum(t0, t1), xp.maximum(t0, t1)
        x_at = o[:, 0] + d[:, 0] * (0.5 * (tn + tf))
        return (tf > xp.maximum(tn, xp.zeros_like(tn))) & (tn < t_max) & (x_at > -2.0) & (
            x_at < 0.0)

    st = volumetric.VolumetricSettings(samples=12, downscale=1)
    jst = j_vol.VolumetricSettings(samples=12, downscale=1)
    args = (_t(pos), _t(depth), np.zeros(3, np.float32), _t(lp), _t(lr), 1)
    img_sh = volumetric.volumetric_light(*args, lambda o, d, t: occ_box(torch, o, d, t),
                                         st).numpy()
    img_un = volumetric.volumetric_light(*args, None, st).numpy()
    jargs = (jnp.asarray(pos), jnp.asarray(depth), jnp.zeros((3,), jnp.float32),
             jnp.asarray(lp), jnp.asarray(lr), 1)
    _close(img_sh, j_vol.volumetric_light(*jargs, lambda o, d, t: occ_box(jnp, o, d, t),
                                          settings=jst))
    _close(img_un, j_vol.volumetric_light(*jargs, None, settings=jst))
    lum_sh, lum_un = img_sh.mean(axis=(0, 2)), img_un.mean(axis=(0, 2))
    blocked, open_ = (xs > -1.8) & (xs < -0.2), xs > 1.0
    assert np.all(img_un >= img_sh - 1e-6)
    ratio = lum_sh[blocked].mean() / lum_sh[open_].mean()
    assert ratio < 0.6 * (lum_un[blocked].mean() / lum_un[open_].mean())


def test_depth_aware_upsample_matches_jax():
    rng = np.random.default_rng(7)
    low = rng.uniform(0, 2, (16, 24, 3)).astype(np.float32)
    low_d = rng.uniform(1, 50, (16, 24)).astype(np.float32)
    full_d = rng.uniform(1, 50, (H, W)).astype(np.float32)
    full_d[::3] = np.repeat(np.repeat(low_d, 2, 0), 2, 1)[::3]  # some taps agree in depth
    _close(volumetric.depth_aware_upsample(_t(low), _t(low_d), _t(full_d), 2),
           j_vol.depth_aware_upsample(jnp.asarray(low), jnp.asarray(low_d),
                                      jnp.asarray(full_d), 2))


def test_ssr_matches_jax_on_the_box(box):
    """The box's G-buffer with glossy normals bent at random: reflections,
    hit masks and refined t against JAX's."""
    _, _, g = box
    rng = np.random.default_rng(8)
    color = rng.uniform(0, 3, (H, W, 3)).astype(np.float32)
    n = np.asarray(g.normal) + rng.normal(0, 0.2, (H, W, 3)).astype(np.float32)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-6)
    depth = np.where(np.isfinite(np.asarray(g.depth)), np.asarray(g.depth), 1e4).astype(
        np.float32)
    cp = JCamera(**CAM).ray_params(W, H)
    st = ssr.SsrSettings(max_distance=1500.0)
    jst = j_ssr.SsrSettings(max_distance=1500.0)
    got = ssr.ssr(_t(color), _t(g.position), _t(n), _t(depth), Camera(**CAM).ray_params(W, H),
                  st)
    want = j_ssr.ssr(jnp.asarray(color), g.position, jnp.asarray(n), jnp.asarray(depth), cp,
                     settings=jst)
    ok, jok = got[1].numpy(), np.asarray(want[1])
    same = ok == jok
    assert same.mean() >= SSR_AGREE and jok.mean() > 0.2
    _close(got[0].numpy()[same], np.asarray(want[0])[same])
    _close(got[2].numpy()[same & jok], np.asarray(want[2])[same & jok], rtol=1e-4)


def test_ssr_binary_refinement_and_sky_fallback():
    """A mirror of tests/test_render.py::test_ssr_binary_refinement_and_sky_fallback
    on the port: a mirror floor and a striped wall; the refined t far below
    the march step, and the sky along the reflection on a miss; the port's
    result against JAX's on the same scene."""
    h = w = 64
    cam = dict(position=np.array([0.0, 1.0, 0.0], np.float32), yaw=90.0, pitch=-25.0, fov_y=60.0)
    cp = Camera(**cam).ray_params(w, h)
    o, d = generate_rays(cp, w, h, torch.full((h * w, 2), 0.5))
    o, d = o.numpy().reshape(h, w, 3), d.numpy().reshape(h, w, 3)
    jo, jd = j_generate_rays(JCamera(**cam).ray_params(w, h), w, h, jnp.full((h * w, 2), 0.5))
    np.testing.assert_array_equal(d, np.asarray(jd).reshape(h, w, 3))
    t_floor = np.where(d[..., 1] < -1e-6, (0.0 - o[..., 1]) / d[..., 1], np.inf)
    t_wall = np.where(d[..., 2] > 1e-6, (20.0 - o[..., 2]) / d[..., 2], np.inf)
    t = np.minimum(t_floor, t_wall)
    is_floor = t_floor < t_wall
    pos = (o + d * t[..., None]).astype(np.float32)
    normal = np.where(is_floor[..., None], [0.0, 1.0, 0.0], [0.0, 0.0, -1.0]).astype(np.float32)
    depth = t.astype(np.float32)
    stripe = (np.floor(pos[..., 1] * 0.5) % 2).astype(np.float32)
    color = np.where(is_floor[..., None], 0.0,
                     np.stack([stripe, 1.0 - stripe, 0 * stripe], -1)).astype(np.float32)
    refl_col, ok, t_ref = (x.numpy() for x in ssr.ssr(_t(color), _t(pos), _t(normal),
                                                      _t(depth), cp))
    want = j_ssr.ssr(jnp.asarray(color), jnp.asarray(pos), jnp.asarray(normal),
                     jnp.asarray(depth), JCamera(**cam).ray_params(w, h))
    assert (ok == np.asarray(want[1])).mean() >= SSR_AGREE

    rd = d.copy()
    rd[..., 1] = -rd[..., 1]
    t_true = np.where(rd[..., 2] > 1e-6, (20.0 - pos[..., 2]) / rd[..., 2], np.inf)
    floor_hit = is_floor & ok & np.isfinite(t_true) & (t_true < 45.0)
    assert floor_hit.sum() > 300
    err = np.abs(t_ref[floor_hit] - t_true[floor_hit])
    step = ssr.SsrSettings().max_distance / ssr.SsrSettings().samples
    assert np.median(err) < step / 8
    t0 = ssr.ssr(_t(color), _t(pos), _t(normal), _t(depth), cp,
                 ssr.SsrSettings(binary_steps=0))[2].numpy()
    assert np.median(np.abs(t0[floor_hit] - t_true[floor_hit])) > np.median(err) * 3
    miss = is_floor & ~ok
    assert miss.sum() > 10
    sky = ssr._sky_gradient(_t(rd), ssr.SsrSettings()).numpy()
    np.testing.assert_allclose(refl_col[miss], sky[miss], atol=1e-4)
    assert refl_col[miss].mean() > 0.05
    np.testing.assert_array_equal(sky, np.asarray(j_ssr._sky_gradient(jnp.asarray(rd),
                                                                      j_ssr.SsrSettings())))


def test_peel_layers_and_composite_match_jax():
    """Three layers of seeded surfaces a ray, some opaque (they stop the
    peel), traced by an analytic stack of planes at z = 1, 2, 3, 4."""
    rng = np.random.default_rng(9)
    r = 512
    o = np.zeros((r, 3), np.float32)
    d = np.tile(np.float32([0, 0, 1]), (r, 1))
    alpha = rng.uniform(0.1, 1.0, (r, 4)).astype(np.float32)
    rgb = rng.uniform(0, 2, (r, 4, 3)).astype(np.float32)

    def make(xp, asarray):
        planes = asarray(np.float32([1, 2, 3, 4]))
        a_t, c_t = asarray(alpha), asarray(rgb)

        def trace(o_, d_, t_min, t_far):
            nxt = xp.floor(t_min) + 1.0  # the next plane past t_min
            layer = xp.clip(nxt - 1.0, 0, 3)
            layer = layer.astype(jnp.int32) if xp is jnp else layer.long()
            return nxt - t_min, nxt <= planes[-1], layer

        def shade(t, valid, layer):
            rows = xp.arange(r)
            a = a_t[rows, layer]
            return c_t[rows, layer], a, a > 0.9
        return trace, shade

    got = oit.peel_layers(*make(torch, torch.from_numpy), _t(o), _t(d),
                          torch.full((r,), 3.4e38), layers=3)
    want = j_oit.peel_layers(*make(jnp, jnp.asarray), jnp.asarray(o), jnp.asarray(d),
                             jnp.full((r,), 3.4e38, jnp.float32), layers=3)
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert ((got[1] > 0) & (got[1] < 1)).any()
    opaque = rng.uniform(0, 1, (16, 32, 3)).astype(np.float32)
    c, a = got[0][:512].reshape(16, 32, 3), got[1][:512].reshape(16, 32)
    _close(oit.composite_over(c, a, _t(opaque)),
           j_oit.composite_over(jnp.asarray(c.numpy()), jnp.asarray(a.numpy()),
                                jnp.asarray(opaque)))


@pytest.mark.parametrize("scale", [2, 3])
def test_upsamplers_match_jax(scale):
    rng = np.random.default_rng(10 + scale)
    img = rng.uniform(0, 4, (12, 20, 3)).astype(np.float32)
    _close(upscale.upsample_bilinear(_t(img), scale),
           j_upscale.upsample_bilinear(jnp.asarray(img), scale))
    for frame in (0, 3, 7):
        jx, jy = upscale.halton_jitter(frame)
        assert (jx, jy) == j_upscale.halton_jitter(frame)
        for g, w in zip(upscale.upsample_jittered(_t(img), scale, jx, jy),
                        j_upscale.upsample_jittered(jnp.asarray(img), scale, jx, jy)):
            _close(g, w)


def test_taau_resolve_matches_jax():
    """Three resolves: the first starts the history, the next two reproject
    it through velocities that leave the screen in places."""
    rng = np.random.default_rng(12)
    s = upscale.UpscaleSettings()
    js = j_upscale.UpscaleSettings()
    hist, jhist = None, None
    for frame in range(3):
        low = rng.uniform(0, 4, (H // 2, W // 2, 3)).astype(np.float32)
        vel = rng.normal(0, 1.5, (H, W, 2)).astype(np.float32)
        jit = upscale.halton_jitter(frame)
        hist = upscale.taau_resolve(_t(low), hist, _t(vel), jit, s)
        jhist = j_upscale.taau_resolve(jnp.asarray(low), jhist, jnp.asarray(vel), jit, js)
        assert hist.shape == (H, W, 4)
        _close(hist, jhist, atol=1e-5)
        hist = torch.from_numpy(np.array(jhist))  # both go on from JAX's history


def test_classify_and_sample_budget_match_jax():
    """Tiles of noise, flat tiles, moving tiles and a frame whose edge tiles
    do not fill 16x16 (dropped, as lax.reduce_window's VALID drops them)."""
    rng = np.random.default_rng(13)
    h, w = 40, 56
    color = (0.4 + 0.02 * rng.uniform(0, 1, (h, w, 3))).astype(np.float32)
    color[:16, 16:32] = rng.uniform(0, 1, (16, 16, 3)) ** 3  # a noisy tile
    color[:16, :16] = 0.5
    vel = np.zeros((h, w, 2), np.float32)
    vel[16:32] = rng.normal(0, 8, (16, w, 2))
    rate = adaptive.classify(_t(color), _t(vel))
    want = j_adaptive.classify(jnp.asarray(color), jnp.asarray(vel))
    assert rate.shape == (2, 3)
    _close(rate, want, rtol=RATE_RTOL)
    r = rate.numpy()
    assert r.min() < 1.0 < r.max()
    for base in (1, 4):
        np.testing.assert_array_equal(adaptive.sample_budget(rate, base).numpy(),
                                      np.asarray(j_adaptive.sample_budget(want, base)))
