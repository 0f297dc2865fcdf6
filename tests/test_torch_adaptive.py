"""The path-tracer pipeline's adaptive bounce budget against the JAX
package: `PtPipelineSettings(adaptive_rate=True)` over three frames of the
48x32 atrium at depth 3, where from the second frame on the rate
classifier (render/adaptive.py) sets each 16x16 tile's bounce budget for
the next frame. The budgets (`_rate_depth`) equal JAX's, pixel for pixel;
the images agree at RMSE <= 1e-3 (the golden contract). The JAX pipeline
runs without the packet tracer, the path the port's images follow.

Both pipelines classify the accumulated image with zero velocity, so every
tile's rate is at least 1 and every budget is the full depth: the JAX
package's adaptive budget never ends a path early, and the port's does as
it does. The ray counts are not compared: at depth 3 on this frame one
grazing ray of about 7,000 takes a bounce in the JAX package that it does
not take in the port, with or without the budget (a ray a rounding apart
hits the neighbour across an edge, as tests/test_torch_pipeline.py notes
of its AOVs)."""
import numpy as np
import pytest
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")

from idkengine_tpu.bvh.builder import BuildSettings as JBuildSettings  # noqa: E402
from idkengine_tpu.render import Camera as JCamera  # noqa: E402
from idkengine_tpu.render import PathTracerSettings as JSettings  # noqa: E402
from idkengine_tpu.render.pipeline import PathTracerPipeline as JPipeline  # noqa: E402
from idkengine_tpu.render.pipeline import PtPipelineSettings as JPtSettings  # noqa: E402
from idkengine_tpu.scene.procedural import atrium as j_atrium  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch.bvh.builder import BuildSettings  # noqa: E402
from idkengine_tpu_torch.render import (Camera, PathTracerPipeline,  # noqa: E402
                                        PathTracerSettings, PtPipelineSettings)
from idkengine_tpu_torch.render.adaptive import bounce_budget  # noqa: E402
from idkengine_tpu_torch.scene.procedural import atrium  # noqa: E402
from idkengine_tpu_torch.scene.scene_db import SceneDatabase  # noqa: E402

from test_torch_trace import jax_core  # noqa: E402,F401

W, H = 48, 32
FRAMES = 3
RMSE_MAX = 1e-3
BUILD = dict(max_leaf_triangle_count=12, traversal_cost=4.0, presplit_factor=0.0)
LIGHTS = [([0.0, 10.5, 0.0], [40.0, 38.0, 35.0], 0.8), ([6.0, 4.0, -20.0], [20.0, 10.0, 5.0], 0.5)]
CAM = dict(position=np.array([0.0, 3.0, 24.0], np.float32), yaw=-90.0, fov_y=65.0)
SETTINGS = dict(ray_depth=3, russian_roulette=False, sky_strength=1.0)


def test_adaptive_rate_matches_jax():
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
                      JPtSettings(adaptive_rate=True))
    pipe = PathTracerPipeline(db, W, H, PathTracerSettings(**SETTINGS),
                              PtPipelineSettings(adaptive_rate=True), device="cpu")
    budgets = []
    for frame in range(FRAMES):
        got = pipe.render_frame(Camera(**CAM)).numpy()
        want = np.asarray(jpipe.render_frame(JCamera(**CAM)))
        assert float(np.sqrt(np.mean((got - want) ** 2))) <= RMSE_MAX
        if frame == 0:
            assert pipe._rate_depth is None and getattr(jpipe, "_rate_depth", None) is None
        else:
            np.testing.assert_array_equal(pipe._rate_depth.numpy(),
                                          np.asarray(jpipe._rate_depth))
            budgets.append(pipe._rate_depth.numpy())
    assert (np.stack(budgets) == SETTINGS["ray_depth"]).all()
    pipe.reset_accumulation()
    assert pipe._rate_depth is None


def test_bounce_budget_spreads_tiles_and_keeps_edges():
    """A 2x3 rate map over a 40x56 frame: each tile's pixels take
    round(depth * rate) in [1, depth]; the edge rows and columns the tiles
    do not cover keep the full depth."""
    import torch

    rate = torch.tensor([[0.1, 0.5, 1.0], [2.0, 0.34, 0.75]])
    got = bounce_budget(rate, 4, 56, 40).reshape(40, 56)
    want = np.full((40, 56), 4, np.int32)
    for (i, j), r in np.ndenumerate(rate.numpy()):
        want[16 * i:16 * i + 16, 16 * j:16 * j + 16] = np.clip(np.round(4 * r), 1, 4)
    np.testing.assert_array_equal(got.numpy(), want)
