"""The port's data parallelism over the ray axis (parallel/shard.py) on a
mesh of eight CPU entries, against its own unsharded tracer and against the
JAX package's sharded tracer on the eight virtual CPU devices that
tests/conftest.py provisions.

Sharding does not change the port's math: each shard keys, generates and
traces its rays as the whole batch does, so the sharded sample, frame and
trace equal the unsharded ones on every pixel and every ray, in every
setting. Against JAX: RMSE <= 1e-3 (the port's image rule).

The JAX ShardedPathTracer differs from the JAX PathTracer in three ways,
each confirmed here and not copied (ROADMAP §3): it takes one sample a
frame whatever spp_per_frame, never updates accum_lum2 (variance() stays
zero), and renders without env NEE (it passes no env_tables)."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from idkengine_tpu.parallel import shard as j_shard  # noqa: E402
from idkengine_tpu.render import Camera as JCamera  # noqa: E402
from idkengine_tpu.render import PathTracer as JPathTracer  # noqa: E402
from idkengine_tpu.render import PathTracerSettings as JSettings  # noqa: E402
from idkengine_tpu.scene.procedural import cornell_box as j_cornell  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch import parallel  # noqa: E402
from idkengine_tpu_torch.bvh.builder import BuildSettings  # noqa: E402
from idkengine_tpu_torch.engine import Engine, EngineSettings  # noqa: E402
from idkengine_tpu_torch.ops import packet_trace  # noqa: E402
from idkengine_tpu_torch.parallel.dryrun import (build_nontoy_pt, check_sharded_traces,  # noqa: E402,E501
                                                 dryrun_multichip, packet_rays)
from idkengine_tpu_torch.parallel.shard import (Mesh, ShardedPathTracer, make_mesh,  # noqa: E402
                                                replicate, shard_ranges, shard_rays,
                                                shard_render)
from idkengine_tpu_torch.render import Camera, PathTracer, PathTracerSettings  # noqa: E402
from idkengine_tpu_torch.render.pipeline import PathTracerPipeline, PtPipelineSettings  # noqa: E402
from idkengine_tpu_torch.scene.procedural import atrium, cornell_box, texture_atrium  # noqa: E402
from idkengine_tpu_torch.scene.scene_db import SceneDatabase  # noqa: E402

from test_torch_trace import jax_core  # noqa: E402,F401

RMSE_MAX = 1e-3
SHARDS = 8
CORNELL = dict(ray_depth=3, sky_strength=0.0, use_packet_tracer=False)
CAM = dict(position=np.array([278, 273, -800], np.float32), yaw=90.0, fov_y=38.0)
LIGHT = ([278, 480, 279.5], [6, 6, 6], 45.0)
ATRIUM_BUILD = dict(max_leaf_triangle_count=12, traversal_cost=4.0)
FAULT = dict(ray_depth=1)  # the fault tests' tracers
ATRIUM_CAM = dict(position=np.array([0, 3, 24], np.float32), yaw=-90.0, fov_y=65.0)


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _env(seed=0, h=16, w=32):
    return (np.random.default_rng(seed).random((h, w, 3)) * 2.0).astype(np.float32)


def _port_cornell(width=64, height=8, env_map=None, **kw):
    db = SceneDatabase()
    db.add_model(cornell_box(emissive_quad=False))
    scene = db.build("cpu")
    db.lights.add(*LIGHT[:2], radius=LIGHT[2])
    return PathTracer(scene, db.materials.soa(), db.lights.soa(), width, height,
                      PathTracerSettings(**{**CORNELL, **kw}), env_map=env_map, device="cpu")


def _jax_cornell(width=64, height=8, env_map=None, **kw):
    db = JSceneDatabase()
    db.add_model(j_cornell(emissive_quad=False))
    scene = db.build()
    db.lights.add(*LIGHT[:2], radius=LIGHT[2])
    return JPathTracer(scene, db.materials.soa(), db.lights.soa(), width, height,
                       JSettings(**{**CORNELL, **kw}), env_map=env_map)


def _cpu_mesh(n=SHARDS):
    return make_mesh(n, device="cpu")


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_mesh_replicate_and_ranges():
    mesh = _cpu_mesh()
    assert len(mesh) == SHARDS and set(mesh.devices) == {torch.device("cpu")}
    assert len(make_mesh(device="cpu")) == 1  # torch sees one CPU
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")
    tree = {"a": torch.arange(6), "b": (torch.ones(2), 3), "c": [torch.zeros(1)]}
    reps = replicate(mesh, tree)
    assert len(reps) == SHARDS and all(r["a"] is tree["a"] for r in reps)  # one copy a device
    assert shard_ranges(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert shard_ranges(3, 8) == [(0, 1), (1, 2), (2, 3)]  # each shard at least one ray
    parts = shard_rays(Mesh(("cpu",) * 4), (torch.arange(10), torch.arange(20).reshape(10, 2)))
    assert [p[0].tolist() for p in parts] == [[0, 1, 2], [3, 4, 5], [6, 7], [8, 9]]
    assert torch.equal(torch.cat([p[1] for p in parts]), torch.arange(20).reshape(10, 2))


def test_sharded_sample_matches_unsharded_and_jax():
    """8-way sharded sample == the port's single-device sample on every
    pixel and AOV, and within RMSE_MAX of the JAX package's sharded sample."""
    pt = _port_cornell(128, 8)
    cam_params = Camera(**CAM).ray_params(128, 8)
    ref = pt._render_sample(cam_params, 0)
    got = shard_render(_cpu_mesh(), pt)(cam_params, 0)
    assert _equal(got, ref)
    assert float(got[4]) > 0

    jpt = _jax_cornell(128, 8)
    mesh = j_shard.make_mesh(SHARDS)
    jfn = j_shard.shard_render(mesh, jpt._render_sample)
    args = ([j_shard.replicate(mesh, a) for a in (jpt.scene, jpt.mats, jpt.lights)]
            + [None, j_shard.replicate(mesh, JCamera(**CAM).ray_params(128, 8)), jnp.uint32(0),
               None, None, None, None, j_shard.replicate(mesh, jpt._attr),
               j_shard.replicate(mesh, (jpt._swz, jpt._inv_swz))])
    jout = jfn(*args)
    assert _rmse(got[0].numpy(), jout[0]) <= RMSE_MAX
    assert float(got[4]) == float(jout[4])


def test_sharded_pathtracer_two_frames():
    """ShardedPathTracer over two frames equals the unsharded tracer frame
    for frame: image, variance, samples, rays, AOVs."""
    cam = Camera(**CAM)
    ref_pt = _port_cornell(128, 8)
    spt = ShardedPathTracer(_port_cornell(128, 8), _cpu_mesh())
    for _ in range(2):
        img = spt.render_frame(cam)
        ref = ref_pt.render_frame(cam)
        assert torch.equal(img, ref)
    assert img.shape == (8, 128, 3) and float(img.max()) > 0
    assert spt.accumulated_samples == 2 == spt.pt.accumulated_samples
    assert torch.equal(spt.variance(), ref_pt.variance())
    assert float(spt.last_rays_traced) == float(ref_pt.last_rays_traced) > 0
    assert _equal(spt._last_aovs, ref_pt._last_aovs)
    # attributes are the wrapped tracer's, written through the wrapper too
    spt.alpha_rounds = 3
    assert spt.pt.alpha_rounds == 3 and "alpha_rounds" not in vars(spt)


def _engine(n_shard):
    db = SceneDatabase()
    db.add_model(cornell_box(emissive_quad=False))
    db.build("cpu")
    db.lights.add(*LIGHT[:2], radius=LIGHT[2])
    s = EngineSettings(width=64, height=8)
    s.pt = dataclasses.replace(s.pt, ray_depth=2, sky_strength=0.0, use_packet_tracer=False)
    s.pt_pipeline.shard_devices = n_shard
    s.pt_pipeline.use_bloom = False
    eng = Engine(db, s, device="cpu")
    eng.camera.position = np.array([278, 273, -800], np.float32)
    eng.camera.yaw = 90.0
    return eng


def test_sharded_engine_pipeline():
    """Engine -> PathTracerPipeline -> ShardedPathTracer through
    PtPipelineSettings.shard_devices: the image equals the unsharded one;
    -1 on the CPU is one device and does not wrap."""
    eng = _engine(SHARDS)
    img = eng.render()
    pipe = eng._pipeline()
    assert isinstance(pipe.pt, ShardedPathTracer) and len(pipe.pt.mesh) == SHARDS
    ref = _engine(0)
    assert torch.equal(img, ref.render())
    assert torch.equal(eng.render(), ref.render())  # the second frame
    one = _engine(-1)
    one.render()
    assert isinstance(one._pipeline().pt, PathTracer)


@pytest.fixture(scope="module")
def packet_scene():
    db = SceneDatabase(BuildSettings(**ATRIUM_BUILD))
    db.add_model(atrium(20_000))
    return db.build("cpu")


@pytest.mark.parametrize("shards,rays", [(SHARDS, SHARDS * 256), (3, 1001)])
def test_shard_packet_traces_match(packet_scene, shards, rays):
    """shard_packet_closest / shard_packet_any bit-equal to the unsharded
    traces (t, slot, u, v, occlusion), also on uneven shards; on the CPU
    the plain walk runs and no kernel launches."""
    packet_trace.reset_launch_counts()
    out = check_sharded_traces(Mesh(("cpu",) * shards), packet_scene,
                               *packet_rays(packet_scene, rays))
    assert out["hits"] > rays // 2 and 0 < out["occluded"] < rays
    assert packet_trace.trace_closest.launches == 0


def test_dryrun_multichip_small():
    out = dryrun_multichip(SHARDS, device="cpu", small=True)
    assert out["rmse"] == 0.0 and out["pixels_differ"] == 0 and out["rays"] > 0


@pytest.mark.slow
def test_dryrun_multichip_nontoy():
    """The non-toy dry run at JAX's 256x256 (110k triangles, two instanced
    spheres) and the sharded traces; its card run is chip_smoke.py's."""
    out = dryrun_multichip(SHARDS, device="cpu")
    assert out["instanced"] and out["rays"] >= 100_000
    assert out["rmse"] == 0.0 and out["pixels_differ"] == 0


def _textured_pt(width, height, **kw):
    model = atrium(8000)
    shading = texture_atrium(model, 0)
    db = SceneDatabase(BuildSettings(**ATRIUM_BUILD))
    db.add_model(model)
    scene = db.build("cpu")
    db.lights.add([0.0, 10.5, 0.0], [40.0, 38.0, 35.0], radius=0.8)
    for k, v in shading.items():
        db.set_mesh_shading(k, **v)
    s = PathTracerSettings(ray_depth=2, russian_roulette=False, sky_strength=1.0,
                           use_env_map=True, env_nee=True, **kw)
    return PathTracer(scene, db.materials.soa(), db.lights.soa(), width, height, s,
                      env_map=_env(1, 32, 64), slot_shading=db.slot_shading(), device="cpu")


SETTINGS = {  # name -> the tracer
    "spp_per_frame": lambda: _port_cornell(spp_per_frame=3),
    "env_nee": lambda: _port_cornell(env_map=_env(), sky_strength=1.0, use_env_map=True,
                                     env_nee=True),
    "sorting": lambda: _port_cornell(do_ray_sorting=True, russian_roulette=True,
                                     rr_min_bounce=1),
    "tile_size": lambda: _port_cornell(tile_size=64, do_ray_sorting=True),
    "max_trace_steps": lambda: _port_cornell(max_trace_steps=6),
    "rate_depth": lambda: _port_cornell(ray_depth=4),
    "instances": lambda: build_nontoy_pt(32, 16, device="cpu")[0],
    "textured_alpha": lambda: _textured_pt(32, 16, do_ray_sorting=True),
}
ATRIUM_SETTINGS = ("instances", "textured_alpha")  # larger scenes: eight shards only


def _frames(tracer, cam, rd, n=2):
    """n frames from a fresh start: the images, then variance, samples and
    rays traced."""
    tracer.reset_accumulation()
    tracer._frame = 0
    imgs = [tracer.render_frame(cam, rate_depth=rd).clone() for _ in range(n)]
    return imgs, tracer.variance(), tracer.accumulated_samples, float(tracer.last_rays_traced)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_sharded_equals_unsharded(setting):
    """In each setting of the tracer, the sharded frames (eight shards, and
    three uneven ones) equal the unsharded frames of the same tracer on
    every pixel, with the same variance, samples and ray count."""
    atrium_scene = setting in ATRIUM_SETTINGS
    cam = Camera(**ATRIUM_CAM) if atrium_scene else Camera(**CAM)
    pt = SETTINGS[setting]()
    rd = None
    if setting == "rate_depth":
        rd = torch.from_numpy(np.random.default_rng(3).integers(
            1, 5, pt.width * pt.height).astype(np.int32))
    want = _frames(pt, cam, rd)
    assert float(want[0][-1].max()) > 0
    for mesh in (_cpu_mesh(),) if atrium_scene else (_cpu_mesh(), Mesh(("cpu",) * 3)):
        got = _frames(ShardedPathTracer(pt, mesh), cam, rd)
        assert all(torch.equal(a, b) for a, b in zip(got[0], want[0])), setting
        assert torch.equal(got[1], want[1]) and got[2:] == want[2:]


@pytest.fixture(scope="module")
def jax_sharded_faults():
    """The JAX ShardedPathTracer beside the JAX PathTracer on the Cornell
    box at 64x8 with one bounce (FAULT; JAX compiles it in a third of
    depth 3's time):
    spp_per_frame=2 (samples, variance), and env NEE on, with the unsharded
    render with env NEE off beside them."""
    cam = JCamera(**CAM)
    out = {}
    one = _jax_cornell(spp_per_frame=2, **FAULT)
    one.render_frame(cam)
    two = _jax_cornell(spp_per_frame=2, **FAULT)
    j_shard.ShardedPathTracer(two, j_shard.make_mesh(SHARDS)).render_frame(cam)
    out["spp"] = (one, two)
    env = dict(env_map=_env(), sky_strength=1.0, use_env_map=True, **FAULT)
    imgs = []
    for nee, sharded in ((True, False), (True, True), (False, False)):
        jpt = _jax_cornell(env_nee=nee, **env)
        tracer = j_shard.ShardedPathTracer(jpt, j_shard.make_mesh(SHARDS)) if sharded else jpt
        imgs.append(np.asarray(tracer.render_frame(cam)))
    out["env"] = imgs
    return out


def _moved_cornell_scene(dy=40.0):
    db = SceneDatabase()
    model = cornell_box(emissive_quad=False)
    for prim in model.primitives:
        prim.positions = prim.positions + np.float32([0.0, dy, 0.0])
    db.add_model(model)
    return db.build("cpu")


def test_jax_sharded_fault_scene_swap_not_copied():
    """The JAX Engine swaps `pipe.pt.scene` after an update; on the JAX
    ShardedPathTracer that lands on the wrapper, and its samples keep the
    scene replicated at construction. The port's wrapper writes through:
    the swap reaches the tracer and its replicas, and the sharded frame
    equals the unsharded frame of the new scene."""
    jpt = _jax_cornell()
    jspt = j_shard.ShardedPathTracer(jpt, j_shard.make_mesh(SHARDS))
    kept = jspt._scene_r
    jspt.scene = None
    assert jpt.scene is not None and jspt._scene_r is kept
    cam = Camera(**CAM)
    ref, spt = _port_cornell(), ShardedPathTracer(_port_cornell(), _cpu_mesh())
    before = spt.render_frame(cam).clone()
    assert torch.equal(before, ref.render_frame(cam))
    moved = _moved_cornell_scene()
    for tracer in (ref, spt):
        tracer.scene = moved
        tracer.reset_accumulation()
    assert spt.pt.scene is moved and "scene" not in vars(spt)
    img = spt.render_frame(cam)
    assert torch.equal(img, ref.render_frame(cam)) and not torch.equal(img, before)


def test_replicas_follow_the_tracer():
    """A replica on another device (here the meta device) copies each
    tensor of the tracer's device state once, again after an in-place
    write or a new tensor, and takes the tracer's settings each sample."""
    from idkengine_tpu_torch.parallel.shard import _Replicas

    meta = torch.device("meta")
    pt = _port_cornell()
    reps = _Replicas(pt)
    a = reps.on([meta, torch.device("cpu"), meta])
    assert a[0] is a[2] and a[1] is pt and a[0].device == meta
    assert a[0].scene.tri_vec.device == meta and a[0].mats["base_layer"].device == meta
    b = reps.on([meta])[0]
    assert b.scene.tri_vec is a[0].scene.tri_vec and b._attr_ext is a[0]._attr_ext
    pt.set_slot_shading(np.tile(np.float32([0.5, 1, 0, 0, 0, 0, 0, 0, 0, 1]), (4, 1)))
    pt.set_settings(ray_depth=2)
    c = reps.on([meta])[0]
    assert c._attr_ext is not b._attr_ext and c.scene.tri_vec is b.scene.tri_vec
    assert c.settings.ray_depth == 2 and c._has_mesh_shading
    pt.scene = _moved_cornell_scene()
    assert reps.on([meta])[0].scene.tri_vec is not c.scene.tri_vec


@pytest.mark.parametrize("fault", ["spp_per_frame", "variance", "env_nee"])
def test_jax_sharded_fault_not_copied(jax_sharded_faults, fault):
    """Each suspected fault of the JAX sharded tracer, confirmed against the
    JAX unsharded tracer; the port's sharded tracer equals its unsharded one
    in that setting (and test_sharded_equals_unsharded holds it so in
    every setting)."""
    cam = Camera(**CAM)
    if fault in ("spp_per_frame", "variance"):
        one, two = jax_sharded_faults["spp"]
        if fault == "spp_per_frame":
            assert one.accumulated_samples == 2 and two.accumulated_samples == 1
        else:
            assert float(jnp.max(one.variance())) > 0.0
            assert float(jnp.max(two.variance())) == 0.0
        kw = dict(spp_per_frame=2, **FAULT)
    else:
        on, sharded, off = jax_sharded_faults["env"]
        assert _rmse(on, off) > 10 * RMSE_MAX  # env NEE changes the image
        assert _rmse(sharded, off) == 0.0  # the sharded tracer renders without it
        kw = dict(env_map=_env(), sky_strength=1.0, use_env_map=True, env_nee=True, **FAULT)
    ref = _port_cornell(**kw)
    spt = ShardedPathTracer(_port_cornell(**kw), _cpu_mesh())
    assert torch.equal(spt.render_frame(cam), ref.render_frame(cam))
    assert spt.accumulated_samples == ref.accumulated_samples
    assert torch.equal(spt.variance(), ref.variance())
    if fault == "variance":
        assert float(spt.variance().max()) > 0.0
    if fault == "env_nee":
        assert _rmse(spt.image().numpy(), on) <= RMSE_MAX  # the JAX unsharded image


def test_pipeline_shard_devices_values():
    """0 and 1 are one device; -1 is one device on the CPU; 2 wraps the
    tracer over two CPU entries; below -1 raises."""
    db = SceneDatabase()
    db.add_model(cornell_box(emissive_quad=False))
    db.build("cpu")
    db.lights.add(*LIGHT[:2], radius=LIGHT[2])
    for n, wraps in ((0, False), (1, False), (-1, False), (2, True)):
        pipe = PathTracerPipeline(db, 16, 8, settings=PtPipelineSettings(shard_devices=n),
                                  device="cpu")
        assert isinstance(pipe.pt, ShardedPathTracer) == wraps, n
    with pytest.raises(ValueError):
        PathTracerPipeline(db, 16, 8, settings=PtPipelineSettings(shard_devices=-3),
                           device="cpu")
    assert parallel.make_mesh is make_mesh and parallel.shard_render is shard_render
    assert parallel.replicate is replicate
