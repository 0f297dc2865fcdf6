"""The port's app layer against the JAX package's: Engine (path-traced
frames, the mode switch, live settings, a model added at run time, the
animated scene through update_device, picking), the recorder's bytes, the
settings file, the viewer's headless parts and the pass timers.

Tolerances: Engine images RMSE <= 1e-3 on the returned [0,1] image (the
repository's golden contract) with equal ray counts; the camera after a
collision update to 1e-6 relative; picking, the recorder's bytes and the
settings tree exactly. Both packages render the Cornell box without its
emissive quad (tests/test_instancing.py's scene) at 24x24 with depth 2,
the JAX tracer without its packet tracer (the pixel-order path the port
follows), so the JAX package compiles one frame function for the static
and the animated scene (the animated root is at rest at the identity,
where the two packages' update_device agree, ROADMAP §3).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from idkengine_tpu import engine as j_engine  # noqa: E402
from idkengine_tpu import recorder as j_recorder  # noqa: E402
from idkengine_tpu.bvh.builder import BuildSettings as JBuildSettings  # noqa: E402
from idkengine_tpu.scene.model import Material as JMaterial  # noqa: E402
from idkengine_tpu.scene.model import MeshPrimitive as JMeshPrimitive  # noqa: E402
from idkengine_tpu.scene.model import Model as JModel  # noqa: E402
from idkengine_tpu.scene.model import Node as JNode  # noqa: E402
from idkengine_tpu.scene.procedural import cornell_box as j_cornell  # noqa: E402
from idkengine_tpu.scene.procedural import make_uv_sphere as j_sphere  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch import profiling, recorder, viewer  # noqa: E402
from idkengine_tpu_torch.bvh.builder import BuildSettings  # noqa: E402
from idkengine_tpu_torch.engine import (Engine, EngineSettings, RenderMode,  # noqa: E402
                                        load_config, save_config)
from idkengine_tpu_torch.render import DeferredPipeline  # noqa: E402
from idkengine_tpu_torch.scene.model import (Animation, AnimationChannel,  # noqa: E402
                                             AnimationSampler, Material, MeshPrimitive, Model,
                                             Node)
from idkengine_tpu_torch.scene.procedural import cornell_box, make_uv_sphere  # noqa: E402
from idkengine_tpu_torch.scene.scene_db import SceneDatabase  # noqa: E402

from test_torch_trace import jax_core  # noqa: E402,F401

W = H = 24
RMSE = 1e-3
LIGHT = ([278, 480, 279.5], [6, 6, 6], 45.0)


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _animate(model, anim_cls, chan_cls, sampler_cls):
    """test_dynamic.py's animation: the root node bobs up 60 units at 1 s."""
    times = np.float32([0.0, 1.0, 2.0])
    vals = np.float32([[0, 0, 0], [0, 60, 0], [0, 0, 0]])
    model.animations.append(anim_cls(name="bob", channels=[chan_cls(
        node=0, path="translation", sampler=sampler_cls(times=times, values=vals))]))
    return model


def _engines(animated=False, w=W, h=H):
    """(the port's Engine on the CPU, the JAX package's Engine) over the same
    scene, lights, settings and camera."""
    from idkengine_tpu.scene.model import Animation as JA
    from idkengine_tpu.scene.model import AnimationChannel as JC
    from idkengine_tpu.scene.model import AnimationSampler as JS

    out = []
    for port in (True, False):
        db = (SceneDatabase(BuildSettings(max_leaf_triangle_count=12, traversal_cost=4.0))
              if port else JSceneDatabase(JBuildSettings(max_leaf_triangle_count=12,
                                                          traversal_cost=4.0)))
        model = (cornell_box if port else j_cornell)(emissive_quad=False)
        if animated:
            _animate(model, *((Animation, AnimationChannel, AnimationSampler) if port
                              else (JA, JC, JS)))
        db.add_model(model, hoist=not animated)
        db.build("cpu") if port else db.build()
        db.lights.add(LIGHT[0], LIGHT[1], radius=LIGHT[2])
        eng = (Engine(db, EngineSettings(width=w, height=h), device="cpu") if port
               else j_engine.Engine(db, j_engine.EngineSettings(width=w, height=h)))
        eng.settings.pt = dataclasses.replace(eng.settings.pt, use_packet_tracer=False,
                                              ray_depth=2)
        eng.camera.position = np.float32([278, 273, -800])
        eng.camera.yaw = 90.0
        out.append(eng)
    return out


def _frame(eng):
    img = eng.render()
    rays = float(eng._pipeline().pt.last_rays_traced)
    return (img.numpy() if isinstance(img, torch.Tensor) else np.asarray(img)), rays


def test_engine_path_traced_frames_match_jax():
    port, ref = _engines()
    for step in range(3):
        if step == 2:  # a moved camera resets both accumulations
            for eng in (port, ref):
                eng.update(0.1, move=np.float32([0.3, 0.0, 1.0]), look=(2.0, -1.0))
            np.testing.assert_allclose(port.camera.position, ref.camera.position, rtol=1e-6)
            assert port._accum_dirty and ref._accum_dirty
        (a, ra), (b, rb) = _frame(port), _frame(ref)
        assert a.shape == (H, W, 3) and np.isfinite(a).all() and a.std() > 0
        assert _rmse(a, b) <= RMSE, step
        assert ra == rb, step
    assert port.frame_index == ref.frame_index == 3
    assert port._pipeline().pt.accumulated_samples == 1


def test_engine_animated_goes_through_update_device(monkeypatch):
    port, ref = _engines(animated=True)
    calls = []
    host = port.db.update
    monkeypatch.setattr(port.db, "update", lambda *a, **k: calls.append(a) or host(*a, **k))
    for eng in (port, ref):
        eng.update(0.25)
    assert not calls and port.db.device_vertices is not None
    (a, ra), (b, rb) = _frame(port), _frame(ref)
    assert _rmse(a, b) <= RMSE and ra == rb
    # the host refit path (IDK_HOST_REFIT) renders the same scene
    host_eng, _ = _engines(animated=True)
    monkeypatch.setenv("IDK_HOST_REFIT", "1")
    host_eng.update(0.25)
    assert host_eng.db.device_vertices is None
    c, _ = _frame(host_eng)
    assert _rmse(a, c) < 2e-2


def _sphere(port, radius=40.0):
    mod = (Model, Node, MeshPrimitive, Material, make_uv_sphere) if port else (
        JModel, JNode, JMeshPrimitive, JMaterial, j_sphere)
    model_cls, node_cls, prim_cls, mat_cls, sphere = mod
    pos, idx = sphere([0.0, 0.0, 0.0], radius, n_lat=12, n_lon=16)
    prim = prim_cls(positions=pos.astype(np.float32), indices=idx.astype(np.uint32))
    prim.ensure_normals()
    return model_cls(primitives=[prim], nodes=[node_cls(mesh_primitives=[0])], root_nodes=[0],
                     materials=[mat_cls(name="inst", base_color=np.float32([0.9, 0.2, 0.2, 1]))])


def test_engine_add_model_runtime_matches_jax():
    """tests/test_instancing.py's Engine case: a sphere dropped into the
    running scene shows up in the next frame, as in the JAX package's."""
    port, ref = _engines(w=32, h=32)
    (a0, _), _ = _frame(port), None
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [278, 273, 250]
    assert port.add_model_runtime(_sphere(True), m) == 0
    assert ref.add_model_runtime(_sphere(False), m) == 0
    assert port._pipelines == {} and port._accum_dirty
    (a1, ra), (b1, rb) = _frame(port), _frame(ref)
    assert (np.abs(a1 - a0) > 1e-3).mean() > 0.01  # the sphere shows up
    assert _rmse(a1, b1) <= RMSE and ra == rb
    assert port._pipeline().pt.instances is not None


def test_engine_mode_switch_renders_the_deferred_pipeline():
    port, _ = _engines()
    port.settings.deferred.use_ssao = False
    pt_img, _ = _frame(port)
    port.set_mode(RenderMode.RASTERIZER)
    img = port.render()
    direct = DeferredPipeline(port.db, W, H, port.settings.deferred, device="cpu")
    assert torch.equal(img, direct.render_frame(port.camera))
    assert isinstance(port._pipeline(), DeferredPipeline) and len(port._pipelines) == 2
    port.set_mode(RenderMode.PATH_TRACER)
    port.render()  # the cached tracer accumulates on
    assert port._pipeline().pt.accumulated_samples == 2 and port.frame_index == 3
    assert not np.array_equal(img.numpy(), pt_img)


def _settings_dict(s):
    d = dataclasses.asdict(s)
    d["mode"] = s.mode.value
    d["deferred"].pop("use_packet_tracer", None)
    return d


def test_set_and_toggle_option_match_jax():
    port, ref = _engines()
    port.render()
    ops = [("set", "pt.ray_depth", 3),  # a frozen leaf
           ("set", "deferred.taa.blend", 0.125),  # a frozen leaf two levels down
           ("toggle", "deferred.use_taa", None), ("toggle", "pt_pipeline.use_bloom", None),
           ("set", "pt_pipeline.output", "noisy"), ("set", "width", 20)]
    for op, path, value in ops:
        if op == "set":
            assert port.set_option(path, value) == ref.set_option(path, value)
        else:
            assert port.toggle_option(path) == ref.toggle_option(path)
    assert _settings_dict(port.settings) == _settings_dict(ref.settings)
    assert port.settings.pt.ray_depth == 3 and port._pipelines == {}
    with pytest.raises(AttributeError):
        port.set_option("pt.no_such_knob", 1)
    port.settings.width = W
    img = port.render()
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())


def test_pick_entity_matches_jax():
    port, ref = _engines(w=32, h=32)
    hits = 0
    for px, py in ((16, 16), (8, 20), (12, 11), (21, 18), (14, 23), (0, 0)):
        got, want = port.pick_entity(px, py), ref.pick_entity(px, py)
        assert got == want
        hits += got is not None
    assert hits == 5  # the box fills the view's middle, not its corners


def test_recorder_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    recs = (recorder.StateRecorder(), j_recorder.StateRecorder())
    port, _ = _engines()
    for i in range(3):
        port.camera.position = rng.normal(size=3).astype(np.float32)
        port.camera.yaw, port.camera.pitch = float(rng.normal()), float(rng.normal())
        for rec in recs:
            rec.record(port.camera, animation_time=0.25 * i)
    for a, b in zip(*(r.frames for r in recs)):
        assert a.pack() == b.pack() and len(a.pack()) == recorder.FrameState.SIZE
    paths = [tmp_path / "port.frd", tmp_path / "jax.frd"]
    for rec, path in zip(recs, paths):
        rec.save(str(path))
    assert paths[0].read_bytes() == paths[1].read_bytes()
    loaded = recorder.StateRecorder.load(str(paths[1]))
    cam = port.camera
    for want in recs[0].frames:
        fs = loaded.replay(cam)
        assert fs.pack() == want.pack()
        stored = recorder.FrameState.unpack(want.pack())  # float32 in the file
        np.testing.assert_array_equal(cam.position, want.position)
        assert (cam.yaw, cam.pitch, cam.fov_y) == (stored.yaw, stored.pitch, stored.fov_y)
    assert loaded.replay(cam) is None
    unpacked = recorder.FrameState.unpack(recs[1].frames[2].pack())
    assert unpacked.pack() == j_recorder.FrameState.unpack(unpacked.pack()).pack()


def test_render_replay_writes_frames(tmp_path):
    pytest.importorskip("PIL")
    port, _ = _engines()
    rec = recorder.StateRecorder()
    for _ in range(2):
        rec.record(port.camera)
    n = recorder.render_replay(
        rec, port.camera, lambda cam, fs: (port.render() * 255).to(torch.uint8), str(tmp_path))
    assert n == 2 and sorted(os.listdir(tmp_path)) == ["frame_00000.png", "frame_00001.png"]


def test_load_config_reads_a_jax_config(tmp_path):
    settings = j_engine.EngineSettings(width=640, height=360, mode=j_engine.RenderMode.RASTERIZER,
                                       camera_collision=False, light_physics=True)
    settings.pt = dataclasses.replace(settings.pt, ray_depth=7, sky_zenith=(0.1, 0.2, 0.3))
    settings.deferred.use_vxgi = True
    settings.deferred.vxgi = dataclasses.replace(settings.deferred.vxgi, resolution=64)
    settings.pt_pipeline.output = "albedo"
    path = str(tmp_path / "jax.json")
    j_engine.save_config(settings, path)
    got = load_config(path)
    assert isinstance(got, EngineSettings) and got.mode == RenderMode.RASTERIZER
    want = _settings_dict(settings)
    assert _settings_dict(got) == want
    assert got.pt.sky_zenith == (0.1, 0.2, 0.3) and got.deferred.vxgi.resolution == 64
    # the port's own file round-trips, and the JAX package reads it
    path2 = str(tmp_path / "port.json")
    save_config(got, path2)
    assert _settings_dict(load_config(path2)) == want
    assert _settings_dict(j_engine.load_config(path2)) == want
    with open(path2) as f:
        assert json.load(f)["mode"] == "rasterizer"


def test_viewer_input_ppm_and_toggles_headless():
    """test_render.py's viewer case on the port: the input snapshot, the PPM
    bytes (of a tensor, read back), the key toggles through the Engine."""
    class FakeViewer:
        _down = {"w", "d", "right"}
        poll_input = viewer.Viewer.poll_input

    move, look = FakeViewer().poll_input()
    np.testing.assert_allclose(move, [1, 0, 1])
    assert look[0] > 0 and look[1] == 0
    img = torch.rand(8, 6, 3)
    ppm = viewer.ppm_bytes(img)
    u8 = np.clip(img.numpy() * 255.0, 0, 255).astype(np.uint8)
    assert ppm == b"P6 6 8 255 " + u8.tobytes()
    assert viewer.ppm_bytes(img, 2)[:12] == b"P6 12 16 255"

    port, _ = _engines()

    class Toggler:
        engine = port
        _TOGGLES = viewer.Viewer._TOGGLES
        _PT_OUTPUTS = viewer.Viewer._PT_OUTPUTS
        _handle_toggle = viewer.Viewer._handle_toggle

    t = Toggler()
    assert t._handle_toggle("o") and port.settings.pt_pipeline.output == "noisy"
    assert t._handle_toggle("m") and port.settings.mode == RenderMode.RASTERIZER
    taa = port.settings.deferred.use_taa
    assert t._handle_toggle("1") and port.settings.deferred.use_taa != taa
    assert not t._handle_toggle("z")
    if not os.environ.get("DISPLAY"):
        with pytest.raises(Exception):
            viewer.run_viewer(port, max_frames=1)


def test_pass_scope_records_timings():
    """pass_scope records a span (with its args) only under a profiler,
    which times it on the profiler's clock; without one it is a shared
    no-op. The counters' report is empty on the CPU (no counting kernel)."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(64)
    assert not profiling.tracing()
    assert profiling.pass_scope("test/pass") is profiling.pass_scope("test/other", 3)
    with profiling.pass_scope("test/untraced"):
        x = x * 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.tracing()
        for i in range(3):
            with profiling.pass_scope("test/pass", i):
                x = x * 2
    assert not profiling.tracing()
    timed = [e for e in prof.events() if e.name == "test/pass"]
    assert len(timed) == 3 and all(e.cpu_time_total >= 0.0 for e in timed)
    assert not [e for e in prof.events() if e.name == "test/untraced"]
    profiling.reset()
    assert profiling.report() == {}
    profiling.log_report()
    assert profiling.capture_device_profile(lambda: x * 2) == {}  # no card: no device time
    # a hand kernel outside any call-site range is the JAX package's untagged
    # trace (pt_*_x): trace_other, closest or any hit; inside one, the
    # range's bucket by the JAX package's rule
    assert profiling.bucket("void trace_kernel<true>(float4 const*)") == "trace_other"
    assert profiling.bucket("void trace_kernel<false>(float4 const*)") == "trace_other"
    assert profiling.bucket("_ZN12_GLOBAL__N_112trace_kernelILb1EEEvPK6float4") == "trace_other"
    for tag, any_hit, want in (("pri", False, "primary"), ("pria", False, "primary"),
                               ("bnc", False, "bounce_closest"), ("nee", True, "nee"),
                               ("enva", True, "nee"), ("neea", False, "trace_other"),
                               ("", True, "trace_other"), ("spmd", False, "trace_other")):
        site = profiling.call_site_name(any_hit, tag)
        assert profiling.range_bucket(site) == want, site
        assert profiling.bucket_times([("void trace_kernel<false>(float4 const*)", site, 2.0)]) \
            == {want: 2.0, "total_device": 2.0}
    assert profiling.bucket("scatter_max_kernel") == "voxelize"
    profiling.reset()
    assert profiling.report() == {}


def test_run_headless_runs_each_frame_in_a_span():
    """Engine.run_headless: each iteration is one engine/frame span (args:
    the iteration), the path-traced frame's pt/frame inside it; on_frame
    sees each image."""
    from torch.profiler import ProfilerActivity, profile

    db = SceneDatabase(BuildSettings(max_leaf_triangle_count=12, traversal_cost=4.0))
    db.add_model(cornell_box(emissive_quad=False))
    db.build("cpu")
    db.lights.add(LIGHT[0], LIGHT[1], radius=LIGHT[2])
    eng = Engine(db, EngineSettings(width=8, height=8), device="cpu")
    eng.settings.pt = dataclasses.replace(eng.settings.pt, ray_depth=1)
    seen = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run_headless(2, on_frame=lambda i, img: seen.append((i, tuple(img.shape))))
    assert [i for i, _ in seen] == [0, 1]
    frames = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name == "engine/frame")
    inner = [e.time_range.start for e in prof.events() if e.name == "pt/frame"]
    assert len(frames) == 2 and len(inner) == 2
    assert all(any(s <= t <= e for s, e in frames) for t in inner)
