"""The deferred pipeline's optional passes on the CPU: each toggle on in
turn (SSR, volumetric light, OIT, the rate classifier, PCF cube-map
shadows, render_scale=2 with TAAU) over two frames against the JAX
package's `DeferredPipeline(use_packet_tracer=False)` on the same Cornell
box (tonemapped frames at RMSE <= 1e-3, the golden contract of
tests/test_golden.py). SSR and OIT run on a variant of the box with glossy
white walls (SSR weights a reflection by 1 - roughness), a transmissive
tall box and a blended short box for OIT to peel. Volumetric light runs on
the small atrium, whose metre-sized lights and depths give it a visible
share of the frame (in the box, 800 units from the camera, it adds about
1e-5). The second frame's camera has moved, so TAA and TAAU reproject
their history and PCF culls the cube faces anew."""
import numpy as np
import pytest
import torch
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")

from idkengine_tpu.render import Camera as JCamera  # noqa: E402
from idkengine_tpu.render.pipeline import DeferredPipeline as JDeferredPipeline  # noqa: E402
from idkengine_tpu.bvh.builder import BuildSettings as JBuildSettings  # noqa: E402
from idkengine_tpu.render.pipeline import DeferredSettings2 as JDeferredSettings2  # noqa: E402
from idkengine_tpu.scene.procedural import atrium as j_atrium  # noqa: E402
from idkengine_tpu.scene.procedural import cornell_box as j_cornell  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch.bvh.builder import BuildSettings  # noqa: E402
from idkengine_tpu_torch.render import Camera, DeferredPipeline, DeferredSettings2  # noqa: E402
from idkengine_tpu_torch.scene.procedural import atrium, cornell_box  # noqa: E402
from idkengine_tpu_torch.scene.scene_db import SceneDatabase  # noqa: E402

from test_torch_trace import jax_core  # noqa: E402,F401

W, H = 48, 32
RMSE_MAX = 1e-3
RATE_RTOL = 1e-5  # the frames agree to float32 rounding; the rate map equals JAX's here
BOX_LIGHTS = [([278, 480, 279.5], [6, 6, 6], 45.0), ([120, 300, 150], [3, 2, 1], 20.0)]
BOX_CAM = dict(position=np.array([278, 273, -800], np.float32), yaw=90.0, fov_y=38.0)
BOX_CAM2 = dict(BOX_CAM, position=np.array([284, 270, -795], np.float32), yaw=89.0)
# the small atrium as the benchmark builds and lights it
BUILD = dict(max_leaf_triangle_count=12, traversal_cost=4.0, presplit_factor=0.0)
ATRIUM_LIGHTS = [([0.0, 10.5, 0.0], [40.0, 38.0, 35.0], 0.8),
                 ([6.0, 4.0, -20.0], [20.0, 10.0, 5.0], 0.5)]
ATRIUM_CAM = dict(position=np.array([0.0, 3.0, 24.0], np.float32), yaw=-90.0, fov_y=65.0)
ATRIUM_CAM2 = dict(ATRIUM_CAM, position=np.array([0.3, 3.1, 23.5], np.float32), yaw=-91.0)
CAMS = {"box": (BOX_CAM, BOX_CAM2), "glossy": (BOX_CAM, BOX_CAM2),
        "atrium": (ATRIUM_CAM, ATRIUM_CAM2)}


def _see_through(model, material_cls):
    """Glossy white walls, the tall box transmissive, the short box blended
    at alpha 0.5."""
    model.materials[0].roughness = 0.3
    model.materials.append(material_cls(name="glass", base_color=np.array(
        [0.9, 0.95, 1.0, 1.0], np.float32), transmission=0.6, roughness=0.1))
    model.materials.append(material_cls(name="veil", base_color=np.array(
        [0.2, 0.3, 0.8, 0.5], np.float32), alpha_cutoff=0.0))
    model.primitives[-1].material = len(model.materials) - 2
    model.primitives[-2].material = len(model.materials) - 1
    return model


def _build(kind):
    from idkengine_tpu.scene.model import Material as JMaterial
    from idkengine_tpu_torch.scene.model import Material

    if kind == "atrium":
        db, jdb = SceneDatabase(BuildSettings(**BUILD)), JSceneDatabase(JBuildSettings(**BUILD))
        m, jm, lights = atrium(8000), j_atrium(8000), ATRIUM_LIGHTS
    else:
        db, jdb = SceneDatabase(), JSceneDatabase()
        m, jm, lights = cornell_box(emissive_quad=False), j_cornell(emissive_quad=False), BOX_LIGHTS
    if kind == "glossy":
        m, jm = _see_through(m, Material), _see_through(jm, JMaterial)
    db.add_model(m)
    jdb.add_model(jm)
    db.build("cpu")
    jdb.build()
    for pos, rad, r in lights:
        db.lights.add(pos, rad, radius=r)
        jdb.lights.add(pos, rad, radius=r)
    return db, jdb


@pytest.fixture(scope="module")
def scenes():
    return {kind: _build(kind) for kind in CAMS}


TOGGLES = {"ssr": dict(use_ssr=True), "volumetric": dict(use_volumetric=True),
           "oit": dict(use_oit=True), "classifier": dict(use_classifier=True),
           "pcf": dict(shadows="pcf", shadow_map_res=32), "render_scale": dict(render_scale=2)}
SCENE_OF = {"ssr": "glossy", "oit": "glossy", "volumetric": "atrium"}  # else "box"


@pytest.mark.parametrize("name", list(TOGGLES))
def test_toggle_matches_jax_over_two_frames(scenes, name):
    kind = SCENE_OF.get(name, "box")
    db, jdb = scenes[kind]
    kw = TOGGLES[name]
    pipe = DeferredPipeline(db, W, H, DeferredSettings2(**kw), device="cpu")
    jpipe = JDeferredPipeline(jdb, W, H, JDeferredSettings2(**kw, use_packet_tracer=False))
    for cam in CAMS[kind]:
        got = pipe.render_frame(Camera(**cam)).numpy()
        want = np.asarray(jpipe.render_frame(JCamera(**cam)))
        assert got.shape == (H, W, 3) and np.isfinite(got).all()
        assert 0.0 <= got.min() and got.max() <= 1.0 and got.std() > 0.05
        assert float(np.sqrt(np.mean((got - want) ** 2))) <= RMSE_MAX
    if name == "classifier":
        assert pipe.rate_map.shape == (H // 16, W // 16)
        np.testing.assert_allclose(pipe.rate_map.numpy(), np.asarray(jpipe.rate_map),
                                   rtol=RATE_RTOL)
    if name == "pcf":
        assert pipe._shadow_mgr.builds >= len(BOX_LIGHTS)
    if name == "render_scale":
        assert tuple(pipe.history.shape) == (H, W, 4)


def test_toggle_changes_the_frame(scenes):
    """Each pass leaves its mark: every toggle's frame differs from the
    frame of its scene with all of them off."""
    base = {kind: DeferredPipeline(scenes[kind][0], W, H, DeferredSettings2(), device="cpu")
            .render_frame(Camera(**CAMS[kind][0])) for kind in CAMS}
    for name, kw in TOGGLES.items():
        if name == "classifier":  # a map beside the frame, not in it
            continue
        kind = SCENE_OF.get(name, "box")
        img = DeferredPipeline(scenes[kind][0], W, H, DeferredSettings2(**kw),
                               device="cpu").render_frame(Camera(**CAMS[kind][0]))
        assert (img - base[kind]).abs().max().item() > 1e-2, name


def test_render_scale_must_divide_the_frame(scenes):
    db, _ = scenes["box"]
    with pytest.raises(ValueError):
        DeferredPipeline(db, 50, H, DeferredSettings2(render_scale=4), device="cpu")
