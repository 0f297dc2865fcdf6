"""The deferred frame's spans and its shadow-ray counters, on the CPU.

`DeferredPipeline.render_frame` is the span deferred/frame, its per-frame
host-to-device copies the span deferred/uploads, and every operation of the
frame lies in one of its pass spans below deferred/frame. While a profiler
runs, and only then, the lighting pass counts its live shadow rays and
those cast from pixels with no surface (`profiling.shadow_report`), apart
from the trace kernel's traversal rows (`profiling.report`). A frame renders
the same image, bit for bit, with and without a profiler."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from worker_threads import share_cores

share_cores()

from idkengine_tpu_torch import profiling  # noqa: E402
from idkengine_tpu_torch.render import Camera, DeferredPipeline, DeferredSettings2  # noqa: E402
from idkengine_tpu_torch.render import deferred, pipeline  # noqa: E402
from idkengine_tpu_torch.render.vxgi import VxgiSettings  # noqa: E402
from idkengine_tpu_torch.scene.procedural import atrium  # noqa: E402
from idkengine_tpu_torch.scene.scene_db import SceneDatabase  # noqa: E402

W, H = 48, 32
# looking up the hall toward the open middle of the roof: sky and surfaces
CAM = dict(position=np.array([0.0, 3.0, 20.0], np.float32), yaw=-90.0, pitch=35.0, fov_y=65.0)
LIGHTS = (([0.0, 10.5, 0.0], [40.0, 38.0, 35.0], 0.8), ([6.0, 4.0, -20.0], [20.0, 10.0, 5.0], 0.5))
CPU = torch.autograd.DeviceType.CPU


@pytest.fixture(scope="module")
def db():
    d = SceneDatabase()
    d.add_model(atrium(6000, seed=3))
    d.build("cpu")
    for pos, rad, r in LIGHTS:
        d.lights.add(pos, rad, radius=r)
    return d


def _pipe(db, **kw):
    s = DeferredSettings2(use_vxgi=True, vxgi=VxgiSettings(resolution=8, max_samples=512), **kw)
    return DeferredPipeline(db, W, H, s, device="cpu")


def _frame(pipe, traced=False):
    cam = Camera(**CAM)
    if not traced:
        return pipe.render_frame(cam), None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        img = pipe.render_frame(cam)
    return img, prof.events()


def test_counts_allocate_nothing_outside_a_profiler(db, monkeypatch):
    monkeypatch.setattr(profiling, "_shadow_counts", {})
    t_max = torch.ones(16)
    profiling.count_shadow_rays(t_max, torch.zeros(16, dtype=torch.bool))
    _frame(_pipe(db))
    assert profiling._shadow_counts == {} and profiling.shadow_report() == {}


@pytest.fixture(scope="module")
def traced(db):
    """One traced frame, with a planted traversal row, spies around the
    lighting pass and its trace entry point (the shadow traces' own t_max
    and the G-buffer's mask), and the counters read after it and after a
    reset; and the same frame untraced."""
    out = SimpleNamespace(seen=[], masks=[])
    real_any, real_shade = pipeline.trace_any, deferred.shade_deferred

    def spy_any(scene, o, d, t_max, *a, **kw):
        out.seen.append(t_max.clone())
        return real_any(scene, o, d, t_max, *a, **kw)

    def spy_shade(gbuf, *a, **kw):
        out.masks.append(gbuf.mask.reshape(-1).clone())
        out.seen.clear()  # the voxelizer's shadow rays are not the lighting pass's
        return real_shade(gbuf, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        for name in ("_shadow_counts", "_counters", "_counter_rows"):
            mp.setattr(profiling, name, {})
        profiling.counter_row(torch.device("cpu"), profiling.call_site_name(True)).add_(
            torch.tensor([10, 70, 30]))
        out.rows_before = profiling.report()
        mp.setattr(pipeline, "trace_any", spy_any)
        mp.setattr(deferred, "shade_deferred", spy_shade)
        out.img, out.events = _frame(_pipe(db), traced=True)
        out.rows, out.shadow = profiling.report(), profiling.shadow_report()
        profiling.reset()
        out.shadow_after_reset = profiling.shadow_report()
    out.untraced, _ = _frame(_pipe(db))
    return out


def test_counts_are_the_lighting_pass_live_rays_and_their_sky_share(traced):
    (mask,) = traced.masks
    assert len(traced.seen) == len(LIGHTS)
    rays = sum(int((t > 0).sum()) for t in traced.seen)
    sky = sum(int(((t > 0) & ~mask).sum()) for t in traced.seen)
    assert 0 < sky < rays
    assert traced.shadow == {"rays": rays, "sky_rays": sky}
    assert traced.shadow_after_reset == {"rays": 0, "sky_rays": 0}


def test_traversal_rows_are_unchanged_by_the_shadow_counts(traced):
    assert traced.rows == traced.rows_before == {"pt_any_x": {"rays": 10, "nodes": 70,
                                                              "tris": 30}}


def _inside(e, spans):
    return any(s.time_range.start <= e.time_range.start and e.time_range.end <= s.time_range.end
               for s in spans)


def test_a_traced_frame_opens_its_spans_and_renders_the_same_image(traced):
    assert torch.equal(traced.img, traced.untraced)
    events = traced.events
    ranges = [e for e in events if e.device_type == CPU and e.is_user_annotation]
    names = {e.name for e in ranges}
    assert {"deferred/frame", "deferred/uploads", "deferred/voxelize", "deferred/G-buffer",
            "deferred/SSAO", "deferred/cone trace", "deferred/lighting + shadows",
            "deferred/bloom", "deferred/TAA", "deferred/tonemap"} <= names
    (frame,) = [e for e in ranges if e.name == "deferred/frame"]
    passes = [e for e in ranges if e.name.startswith("deferred/") and e is not frame]
    ops = [e for e in events if e.device_type == CPU and not e.is_user_annotation
           and e.name.startswith("aten::") and _inside(e, [frame])]
    # no operation of the frame lies outside its pass spans
    assert ops and all(_inside(e, passes) for e in ops)
    (up,) = [e for e in ranges if e.name == "deferred/uploads"]
    assert any(_inside(e, [up]) for e in ops)
