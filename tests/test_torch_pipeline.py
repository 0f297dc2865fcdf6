"""The port's path-tracer pipeline (accumulate, à-trous denoise, bloom,
tonemap) vs the JAX package's, and the denoiser alone.

Tolerances:
- `atrous_denoise`: rtol 1e-4, atol 1e-5. Each of 3 iterations sums 25 taps
  of products of four exps and a division; XLA and PyTorch round exp and
  division differently in the last place, and the differences compound
  through the iterations and the variance propagation.
- `PathTracerPipeline`: RMSE <= 1e-3 on the returned [0,1] image, the
  golden contract of the repository's image tests. The JAX pipeline runs
  without the packet tracer (pixel launch order, one light pick per ray),
  as the port's images follow that path. The albedo and normal outputs
  show the first hit of one jittered primary ray per pixel unfiltered, so
  there they agree within 1e-4 on all but at most 2 pixels in 1000: XLA
  and PyTorch round the ray direction differently in the last place, and a
  ray that grazes a triangle's edge may hit the neighbour across it (seen
  on one pixel of 960, at a crease, in one frame).

XLA compiles the unrolled à-trous filter (3 iterations of 25 taps) in
about 20 s per input shape and settings on one core, so the filter test
uses the pipeline's image size with its settings (one compile shared with
the pipeline's) and one other combination.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from idkengine_tpu.bvh.builder import BuildSettings as JBuildSettings  # noqa: E402
from idkengine_tpu.render import Camera as JCamera  # noqa: E402
from idkengine_tpu.render import PathTracerSettings as JSettings  # noqa: E402
from idkengine_tpu.render import denoise as j_dn  # noqa: E402
from idkengine_tpu.render.pipeline import PathTracerPipeline as JPipeline  # noqa: E402
from idkengine_tpu.render.pipeline import PtPipelineSettings as JPtSettings  # noqa: E402
from idkengine_tpu.scene.procedural import atrium as j_atrium  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch.bvh.builder import BuildSettings  # noqa: E402
from idkengine_tpu_torch.ops import packet_trace as t_pt  # noqa: E402
from idkengine_tpu_torch.ops import two_phase as tp  # noqa: E402
from idkengine_tpu_torch.render import (Camera, PathTracerPipeline,  # noqa: E402
                                        PathTracerSettings, PtPipelineSettings)
from idkengine_tpu_torch.render import bloom, tonemap  # noqa: E402
from idkengine_tpu_torch.render import denoise as dn  # noqa: E402
from idkengine_tpu_torch.scene.procedural import atrium  # noqa: E402
from idkengine_tpu_torch.scene.scene_db import SceneDatabase  # noqa: E402

from test_torch_atrium import BUILD, CAM, LIGHTS, SETTINGS  # noqa: E402
from test_torch_trace import jax_core  # noqa: E402,F401

W, H = 40, 24
FRAMES = 3
OUTPUTS = ("noisy", "denoised", "albedo", "normal")
RMSE = 1e-3


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _aovs(h, w, seed):
    """Noisy colour with fireflies, AOVs with emitter-like dark albedo,
    depth with misses (inf), and a variance, from a numpy seed."""
    rng = np.random.default_rng(seed)
    color = rng.gamma(2.0, 0.3, (h, w, 3)).astype(np.float32)
    color[rng.random((h, w)) < 0.02] *= 60.0  # fireflies
    albedo = rng.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)
    albedo[rng.random((h, w)) < 0.1] = 0.01  # below the demodulation floor
    normal = rng.standard_normal((h, w, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    depth = rng.uniform(1.0, 30.0, (h, w)).astype(np.float32)
    depth[rng.random((h, w)) < 0.05] = np.inf
    variance = rng.gamma(1.0, 0.02, (h, w)).astype(np.float32)
    return color, albedo, normal, depth, variance


@pytest.mark.parametrize("with_variance, firefly", [(True, 8.0), (False, 0.0)])
def test_atrous_denoise_matches_jax(with_variance, firefly):
    """With the variance and the default firefly clamp (the pipeline's
    call), and without either."""
    color, albedo, normal, depth, variance = _aovs(H, W, 3)
    var = variance if with_variance else None
    j_set = j_dn.DenoiseSettings(firefly_clamp=firefly)
    want = np.asarray(j_dn.atrous_denoise(
        jnp.asarray(color), jnp.asarray(albedo), jnp.asarray(normal), jnp.asarray(depth),
        j_set, variance=None if var is None else jnp.asarray(var)))
    got = dn.atrous_denoise(
        torch.from_numpy(color), torch.from_numpy(albedo), torch.from_numpy(normal),
        torch.from_numpy(depth), dn.DenoiseSettings(firefly_clamp=firefly),
        variance=None if var is None else torch.from_numpy(var)).numpy()
    assert np.isfinite(got).all() and not np.allclose(got, color)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_denoise_defaults_are_the_references():
    assert dn.DenoiseSettings() == dn.DenoiseSettings(**vars(j_dn.DenoiseSettings()))
    assert dn.DenoiseSettings().firefly_clamp == 8.0
    assert PtPipelineSettings().denoise_at_samples == JPtSettings().denoise_at_samples == 32


@pytest.fixture(scope="module")
def pipelines():
    """The JAX pipeline and the port's, one-phase and two-phase, over the
    same small atrium. Each case resets their accumulation and renders the
    same frames on all three, so their frame counters (the RNG seeds) stay
    equal and the cases run in any order."""
    jdb = JSceneDatabase(JBuildSettings(**BUILD))
    jdb.add_model(j_atrium(8000))
    jdb.build()
    db = SceneDatabase(BuildSettings(**BUILD))
    db.add_model(atrium(8000))
    db.build("cpu")
    for pos, rad, r in LIGHTS:
        jdb.lights.add(pos, rad, radius=r)
        db.lights.add(pos, rad, radius=r)
    jpipe = JPipeline(jdb, W, H, JSettings(**SETTINGS, use_packet_tracer=False),
                      JPtSettings(denoise_at_samples=2))
    one = PathTracerPipeline(db, W, H, PathTracerSettings(**SETTINGS),
                             PtPipelineSettings(denoise_at_samples=2), device="cpu")
    two = PathTracerPipeline(db, W, H, PathTracerSettings(**SETTINGS, use_two_phase=True),
                             PtPipelineSettings(denoise_at_samples=2), device="cpu")
    return jpipe, one, two


def _run_all(pipelines, output):
    """FRAMES frames of each pipeline in the output mode: (JAX, port
    one-phase, port two-phase) lists of images."""
    out = []
    for pipe, cam in zip(pipelines, (JCamera(**CAM), Camera(**CAM), Camera(**CAM))):
        pipe.reset_accumulation()
        pipe.settings.output = output
        out.append([np.asarray(pipe.render_frame(cam)) for _ in range(FRAMES)])
    return out


@pytest.mark.parametrize("output", OUTPUTS)
def test_pipeline_matches_jax(pipelines, output):
    """Three frames with the denoiser switched on from the second
    (denoise_at_samples=2), in every output mode."""
    one = pipelines[1]
    want, got, _ = _run_all(pipelines, output)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (H, W, 3) and np.isfinite(g).all()
        if output in ("albedo", "normal"):
            off = (np.abs(g - w).max(-1) > 1e-4).sum()
            assert off <= 2 * H * W // 1000, (output, i, off)
        else:
            assert _rmse(g, w) <= RMSE, (output, i, _rmse(g, w))
    if output in ("noisy", "denoised"):
        assert got[-1].min() >= 0.0 and got[-1].max() <= 1.0
        # "noisy" is the bloomed, tonemapped accumulation; "denoised" differs
        # from it once the denoiser is on
        s = one.settings
        img = one.pt.image()
        passthrough = tonemap.tonemap(img + bloom.bloom(img, s.bloom), s.tonemap).numpy()
        if output == "noisy":
            np.testing.assert_array_equal(got[-1], passthrough)
        else:
            assert not np.allclose(got[-1], passthrough, atol=1e-4)


@pytest.mark.parametrize("output", ["denoised", "noisy"])
def test_two_phase_pipeline_matches(pipelines, output):
    """use_two_phase routes every trace through the two-phase traversal:
    the image matches the JAX pipeline's and the port's own one-phase
    image, and its plain versions ran (no kernel launch on the CPU)."""
    tp.reset_launch_counts()
    t_pt.reset_launch_counts()
    want, ref, got = _run_all(pipelines, output)
    assert tp.phase_a.launches == 0 and t_pt.trace_closest.launches == 0
    for g, w, r in zip(got, want, ref):
        assert _rmse(g, w) <= RMSE and _rmse(g, r) <= RMSE


@pytest.mark.parametrize("what", ["shard_devices", "output"])
def test_unported_settings_raise(pipelines, what):
    """Settings outside the JAX package's range raise: a shard count below
    -1 (every other value is ported, tests/test_torch_multichip.py), an
    unknown output."""
    _, one, _ = pipelines
    with pytest.raises(ValueError):
        if what == "shard_devices":
            PathTracerPipeline(one.db, W, H, settings=PtPipelineSettings(shard_devices=-2),
                               device="cpu")
        else:
            PathTracerPipeline(one.db, W, H, settings=PtPipelineSettings(output="depth"),
                               device="cpu")
