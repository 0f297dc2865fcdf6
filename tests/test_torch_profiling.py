"""The profiler's per-pass buckets against the JAX package's rule, and the
call-site tags of the port's trace launches, on the CPU.

The JAX package names each Pallas trace kernel after its call site
(`pt_{closest,any}_{plain,steer,steerloop}_<tag>`) and buckets it by that
name (idkengine_tpu/profiling.py, capture_device_profile's nested
`bucket`, taken here from its code object: the JAX package is not
edited). The port launches its hand kernels inside a profiler range named
`pt_{closest,any}_<tag>` (profiling.call_site); `range_bucket` must give
every such range the bucket that the JAX rule gives every kernel name of
that call site. `attribute` is held to records shaped as torch.profiler's
events (the card's trace is checked by chip_smoke.py), and the path
tracer, the two-phase traces and the sharded traces are held to open the
JAX package's ranges around their launches."""
import contextlib
import json
import os
import types
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

jax = pytest.importorskip("jax")

from idkengine_tpu import profiling as j_profiling  # noqa: E402
from idkengine_tpu_torch import profiling  # noqa: E402
from idkengine_tpu_torch.bvh.builder import BuildSettings  # noqa: E402
from idkengine_tpu_torch.ops import packet_trace, two_phase  # noqa: E402
from idkengine_tpu_torch.parallel import shard  # noqa: E402
from idkengine_tpu_torch.render import Camera, PathTracer, PathTracerSettings  # noqa: E402
from idkengine_tpu_torch.scene.procedural import atrium, cornell_box, texture_atrium  # noqa: E402
from idkengine_tpu_torch.scene.scene_db import SceneDatabase  # noqa: E402

# every tag the JAX package passes (render/pathtracer.py:865, 1101, 1108,
# 1143 and their alpha rounds; parallel/shard.py:132, 153), and none
FORMS = ("plain", "steer", "steerloop")
TAGS = ("pri", "bnc", "nee", "env", "pria", "bnca", "neea", "enva", "spmd", "")
CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


def jax_bucket():
    """The JAX package's nested bucket(name) of capture_device_profile."""
    code = next(c for c in j_profiling.capture_device_profile.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "bucket")
    assert not code.co_freevars
    return types.FunctionType(code, {})


@pytest.mark.parametrize("tag", TAGS)
def test_call_site_buckets_as_jax(tag):
    """The port's range of a call site takes the bucket the JAX rule gives
    each of its kernel names, in every form, for closest and any hits."""
    want_of = jax_bucket()
    for any_hit in (False, True):
        kind = "any" if any_hit else "closest"
        site = profiling.call_site_name(any_hit, tag)
        assert site == f"pt_{kind}_{tag or 'x'}"
        for form in FORMS:
            want = want_of(f"pt_{kind}_{form}_{tag or 'x'}")
            assert profiling.range_bucket(site) == want, (site, form)
            assert profiling.range_bucket(f"pt_{kind}_{form}_{tag or 'x'}") == want


def test_range_bucket_is_the_jax_rule_on_other_names():
    want_of = jax_bucket()
    for name in ("jit__render_sample", "scatter_max", "sort.12", "copy.3", "fusion.7",
                 "dynamic-update-slice", "pt_closest_steer_prifb", "pt_any_plain_neerb"):
        assert profiling.range_bucket(name) == want_of(name), name


def _event(name, device_type, start, end, id_=0):
    return SimpleNamespace(name=name, device_type=device_type, id=id_,
                           time_range=SimpleNamespace(start=start, end=end))


def test_attribute_takes_the_innermost_call_site():
    """Host side: the launch's runtime event inside nested ranges; device
    side: a range's span where the launch was not traced; kernels without
    a range and PyTorch's kernels by their names."""
    events = [
        # a primary's alpha re-trace: pt/alpha re-traces > pt_closest_pria > launch
        _event("pt/alpha re-traces", CPU, 0, 100),
        _event("pt_closest_pria", CPU, 10, 50),
        _event("cudaLaunchKernel", CPU, 20, 21, id_=7),
        _event("void trace_kernel<false>(float4 const*)", CUDA, 200, 230, id_=7),
        _event("pt_closest_pria", CUDA, 190, 231),  # the range's span: not a kernel
        _event("vectorized_elementwise_kernel", CUDA, 190, 195, id_=6),
        # an NEE shadow launch the profiler did not trace on the host
        _event("pt_any_nee", CPU, 300, 320),
        _event("pt_any_nee", CUDA, 400, 500),
        _event("void trace_kernel<true>(float4 const*)", CUDA, 410, 490, id_=9),
        # a launch outside any call site, and the deferred frame's untagged any-hit
        _event("trace_capped_kernel<true>", CUDA, 600, 610, id_=11),
        _event("pt_any_x", CPU, 700, 710),
        _event("cudaLaunchKernel", CPU, 701, 702, id_=12),
        _event("phase_a_kernel", CUDA, 800, 820, id_=12),
    ]
    got = profiling.attribute(events)
    assert got == [("void trace_kernel<false>(float4 const*)", "pt_closest_pria", 0.03),
                   ("vectorized_elementwise_kernel", None, 0.005),
                   ("void trace_kernel<true>(float4 const*)", "pt_any_nee", 0.08),
                   ("trace_capped_kernel<true>", None, 0.01),
                   ("phase_a_kernel", "pt_any_x", 0.02)]
    by = profiling.bucket_times([(n, s, ms * 100) for n, s, ms in got])
    assert by == {"total_device": 14.5, "nee": 8.0, "trace_other": 3.0, "primary": 3.0,
                  "xla_glue": 0.5}
    assert profiling.bucket_times([]) == {}


def test_two_level_kernels_take_their_call_sites():
    """The fused two-level kernels, closest and any-hit, capped or not, are
    hand trace kernels: each takes the call-site range it was launched in
    and that range's bucket; outside any range, trace_other."""
    events = [
        _event("pt_closest_pri", CPU, 0, 50),
        _event("cudaLaunchKernel", CPU, 10, 11, id_=3),
        _event("void (anonymous namespace)::two_level_kernel<false>(float const*)", CUDA,
               100, 140, id_=3),
        _event("pt_any_nee", CPU, 200, 250),
        _event("cudaLaunchKernel", CPU, 210, 211, id_=4),
        _event("void (anonymous namespace)::two_level_capped_kernel<true>(float const*)", CUDA,
               300, 320, id_=4),
        _event("pt_closest_bnca", CPU, 400, 450),
        _event("cudaLaunchKernel", CPU, 410, 411, id_=5),
        _event("void (anonymous namespace)::two_level_kernel<false>(float const*)", CUDA,
               500, 510, id_=5),
        _event("void (anonymous namespace)::two_level_kernel<true>(float const*)", CUDA,
               600, 605, id_=6),
    ]
    got = profiling.attribute(events)
    assert [site for _, site, _ in got] == ["pt_closest_pri", "pt_any_nee", "pt_closest_bnca",
                                           None]
    by = profiling.bucket_times(got, ndigits=3)
    assert by == {"total_device": 0.075, "primary": 0.04, "nee": 0.02,
                  "bounce_closest": 0.01, "trace_other": 0.005}
    for name, _, _ in got:
        assert profiling.bucket(name) == "trace_other"


def test_two_level_traces_open_one_call_site(carried_instances):
    """A two-level call opens its call site's range once (the fused
    kernel's launch, on the CPU the plain loop), for closest and any hits."""
    static, iset, o, d = carried_instances
    names = _ranges(lambda: packet_trace.trace_closest_two_level(
        static, iset.scenes, iset.inv, iset.boxes, o, d, 3.4e38, slot_off=iset.slot_off,
        tag="pri"))
    assert names == ["pt_closest_pri"]
    names = _ranges(lambda: packet_trace.trace_any_two_level(
        static, iset.scenes, iset.inv, iset.boxes, o, d, 3.4e38, max_steps=64, tag="nee"))
    assert names == ["pt_any_nee"]


@pytest.fixture(scope="module")
def carried_instances():
    """The Cornell box with two instances of itself at a tenth of its size,
    on the CPU, and rays towards them."""
    mats = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    mats[:, :3, :3] *= 0.1
    mats[:, :3, 3] = [[150, 380, 250], [400, 380, 250]]
    db = SceneDatabase(BuildSettings(max_leaf_triangle_count=12, traversal_cost=4.0))
    db.add_model(cornell_box(emissive_quad=False))
    db.add_instanced_model(cornell_box(emissive_quad=False), mats)
    db.build("cpu")
    rs = np.random.default_rng(6)
    o = torch.from_numpy(rs.uniform([0, 0, -300], [556, 548, 0], (64, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(
        (np.float32([278, 380, 250]) - o.numpy()).astype(np.float32)), dim=-1)
    return db.device_scene, db.instance_set(), o, d


def _ranges(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if e.name.startswith(("pt_closest_", "pt_any_"))]


@pytest.fixture(scope="module")
def cornell_tracer():
    db = SceneDatabase()
    db.add_model(cornell_box(emissive_quad=False))
    scene = db.build("cpu")
    db.lights.add([0.0, 1.9, 0.0], [10.0, 10.0, 10.0], radius=0.1)
    cam = Camera(position=np.array([0.0, 1.0, 3.4], np.float32), yaw=-90.0, fov_y=40.0)
    return db, scene, cam


@pytest.fixture
def sites(monkeypatch):
    """The call-site ranges the trace entry points open, in order (a
    stand-in for profiling.call_site, without a profiler's cost)."""
    seen = []

    def spy(any_hit, tag=""):
        seen.append(profiling.call_site_name(any_hit, tag))
        return contextlib.nullcontext()

    for module in (packet_trace, two_phase):
        monkeypatch.setattr(module, "call_site", spy)
    return seen


def test_path_tracer_tags_its_launches(cornell_tracer, sites):
    """Bounce 0 traces as pri, later bounces as bnc, shadow rays as nee;
    the two-phase traces and the tiled and capped ones carry the same
    tags."""
    db, scene, cam = cornell_tracer
    for kw in ({}, dict(use_two_phase=True), dict(tile_size=64, max_trace_steps=64)):
        pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), 16, 16,
                        PathTracerSettings(ray_depth=2, russian_roulette=False, **kw),
                        device="cpu")
        sites.clear()
        pt.render_frame(cam)
        assert set(sites) == {"pt_closest_pri", "pt_closest_bnc", "pt_any_nee"}, kw
        assert sites[0] == "pt_closest_pri" and sites.count("pt_any_nee") >= 2, kw


@pytest.fixture(scope="module")
def textured_atrium():
    """A textured atrium with alpha-tested cloth, normal maps and a sphere
    light, on the CPU; a 16x32 env map; a camera down its hall."""
    model = atrium(3000)
    texture_atrium(model)
    db = SceneDatabase(BuildSettings(max_leaf_triangle_count=12, traversal_cost=4.0))
    db.add_model(model)
    scene = db.build("cpu")
    db.lights.add([0.0, 10.5, 0.0], [40.0, 38.0, 35.0], radius=0.8)
    rs = np.random.default_rng(3)
    env = rs.random((16, 32, 3)).astype(np.float32) * 4.0
    cam = Camera(position=np.array([0.0, 3.0, 24.0], np.float32), yaw=-90.0, fov_y=65.0)
    return db, scene, env, cam


def _textured_tracer(textured_atrium, w, h, **kw):
    db, scene, env, _cam = textured_atrium
    return PathTracer(scene, db.materials.soa(), db.lights.soa(), w, h,
                      PathTracerSettings(ray_depth=2, russian_roulette=False, use_env_map=True,
                                         env_nee=True, **kw), env_map=env, device="cpu")


def test_alpha_rounds_and_env_nee_carry_their_tags(textured_atrium, sites):
    """A textured atrium with alpha-tested cloth and an env map: the alpha
    re-traces as pria/bnca, the shadow alpha rounds and their any-hit tail
    as neea/enva (the JAX package's tag + "a")."""
    pt = _textured_tracer(textured_atrium, 12, 8)
    assert pt._has_alpha and pt._env_tables is not None
    pt.render_frame(textured_atrium[3])
    assert set(sites) == {"pt_closest_pri", "pt_closest_pria", "pt_closest_bnc",
                          "pt_closest_bnca", "pt_closest_neea", "pt_any_neea",
                          "pt_closest_enva", "pt_any_enva"}
    assert {profiling.range_bucket(n) for n in ("pt_closest_pria", "pt_any_enva")} == {
        "primary", "nee"}


def test_two_phase_and_sharded_traces_carry_their_tags(cornell_tracer):
    _db, scene, _cam = cornell_tracer
    rs = np.random.default_rng(5)
    o = torch.from_numpy((rs.uniform(-0.5, 0.5, (64, 3)) + [0, 1, 0]).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(rs.standard_normal((64, 3))
                                                       .astype(np.float32)), dim=-1)
    names = _ranges(lambda: two_phase.two_phase_closest(scene, o, d, 3.4e38, tag="bnc"))
    assert set(names) == {"pt_closest_bnc"}
    names = _ranges(lambda: two_phase.two_phase_any(scene, o, d, 3.4e38, tag="nee"))
    assert set(names) == {"pt_any_nee"}
    names = _ranges(lambda: packet_trace.trace_any(scene, o, d, 3.4e38))
    assert set(names) == {"pt_any_x"}
    mesh = shard.make_mesh(2, device="cpu")
    names = _ranges(lambda: shard.shard_packet_closest(mesh, scene)(o, d, 3.4e38))
    assert set(names) == {"pt_closest_spmd"}
    names = _ranges(lambda: shard.shard_packet_any(mesh, scene)(o, d, 3.4e38))
    assert set(names) == {"pt_any_spmd"}


# the frame's span tree (render/pathtracer.py): each span and the spans it
# may lie directly in
SPAN_PARENTS = {
    "pt/frame": {None}, "pt/raygen": {"pt/frame"}, "pt/camera upload": {"pt/raygen"},
    "pt/bounce": {"pt/frame"}, "pt/accumulate": {"pt/frame"},
    "pt/sort": {"pt/bounce"}, "pt/closest": {"pt/bounce"}, "pt/lights": {"pt/bounce"},
    "pt/shade": {"pt/bounce"}, "pt/nee": {"pt/bounce"}, "pt/env nee": {"pt/bounce"},
    "pt_closest_pri": {"pt/closest"}, "pt_closest_bnc": {"pt/closest"},
    "pt/alpha re-traces": {"pt/closest"}, "pt_closest_pria": {"pt/alpha re-traces"},
    "pt_closest_bnca": {"pt/alpha re-traces"}, "pt/textures": {"pt/shade"},
    "pt/shadow alpha rounds": {"pt/nee", "pt/env nee"},
    "pt_closest_neea": {"pt/shadow alpha rounds"}, "pt_closest_enva": {"pt/shadow alpha rounds"},
    "pt_any_neea": {"pt/nee"}, "pt_any_enva": {"pt/env nee"},
}


def _nesting(prof):
    """(name, is a span, the innermost span around it) of each event of a
    CPU trace, by time containment (the profiler's raw events: building its
    FunctionEvents takes seconds for a frame's 40,000)."""
    evs = sorted((e.start_ns(), -e.end_ns(), e.name(), e.is_user_annotation())
                 for e in prof.profiler.kineto_results.events())
    stack, out = [], []
    for _start, neg_end, name, is_span in evs:
        while stack and stack[-1][0] < -neg_end:
            stack.pop()
        out.append((name, is_span, stack[-1][1] if stack else None))
        if is_span:
            stack.append((-neg_end, name))
    return out


def test_a_frame_holds_the_documented_span_tree(textured_atrium, monkeypatch):
    """One 32x16 frame (depth 2, sorting, NEE and env NEE, textures and
    alpha; the walks capped at 16 steps to keep the CPU trace short) under
    torch.profiler: every span of the tree, each in its documented parent,
    no operation directly under pt/frame or pt/bounce, and the frame's and
    the bounces' indices as their spans' args."""
    pt = _textured_tracer(textured_atrium, 32, 16, do_ray_sorting=True, max_trace_steps=16)
    opened = []
    real = profiling.record_function

    def spy(name, args=None):
        opened.append((name, args))
        return real(name, args)

    monkeypatch.setattr(profiling, "record_function", spy)
    frame = pt._frame
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pt.render_frame(textured_atrium[3])
    events = _nesting(prof)
    spans = [(name, parent) for name, is_span, parent in events if is_span]
    assert {name for name, _ in spans} == set(SPAN_PARENTS)
    for name, parent in spans:
        assert parent in SPAN_PARENTS[name], (name, parent)
    assert [name for name, _ in spans].count("pt/bounce") == 2
    assert [name for name, _ in spans].count("pt/sort") == 1  # bounce 1 only
    stray = {name for name, is_span, parent in events
             if not is_span and parent in ("pt/frame", "pt/bounce")}
    assert not stray, stray
    assert ("pt/frame", str(frame)) in opened
    assert [a for n, a in opened if n == "pt/bounce"] == ["0", "1"]


def test_a_frame_opens_no_range_without_a_profiler(textured_atrium, monkeypatch):
    """With no profiler active, no span of a frame (the call sites' either)
    calls record_function."""
    def refuse(*args, **kw):
        raise AssertionError("record_function called with no profiler active")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not profiling.tracing()
    pt = _textured_tracer(textured_atrium, 32, 16, do_ray_sorting=True, max_trace_steps=16)
    pt.render_frame(textured_atrium[3])
    with profiling.pass_scope("test/span", 3), profiling.call_site(True, "nee"):
        pass


def test_counter_rows_report_reset_and_log(monkeypatch):
    """report() sums each call site's row over the devices' buffers and
    leaves out rows that counted no ray; reset() zeroes the rows in place;
    log_report() logs each site's rays and work a ray."""
    monkeypatch.setattr(profiling, "_counters", {})
    monkeypatch.setattr(profiling, "_counter_rows", {})
    cpu = torch.device("cpu")
    profiling.counter_row(cpu, "pt_closest_pri").add_(torch.tensor([10, 40, 90]))
    profiling.counter_row(cpu, "pt_any_nee").add_(torch.tensor([5, 15, 20]))
    profiling.counter_row(cpu, "pt_closest_pri").add_(torch.tensor([2, 8, 6]))
    profiling.counter_row(cpu, "pt_closest_bnc")  # a row that never counts
    # a second device's buffer (a shard's), as the kernel would fill it
    profiling._counters["other"] = torch.zeros_like(profiling._counters[cpu])
    profiling._counters["other"][profiling._counter_rows["pt_any_nee"]] += torch.tensor([1, 3, 4])
    assert profiling.report() == {"pt_closest_pri": {"rays": 12, "nodes": 48, "tris": 96},
                                  "pt_any_nee": {"rays": 6, "nodes": 18, "tris": 24}}
    lines = []
    monkeypatch.setattr(profiling.log, "info", lambda fmt, *args: lines.append(fmt % args))
    profiling.log_report()
    assert len(lines) == 2 and lines[1].startswith("pt_closest_pri")
    assert "12 rays" in lines[1] and "4.00 nodes/ray" in lines[1] and "8.00 tris/ray" in lines[1]
    buf = profiling._counters[cpu]
    profiling.reset()
    assert profiling.report() == {} and profiling._counters[cpu] is buf
    for k in range(profiling.MAX_COUNTER_SITES - 3):
        profiling.counter_row(cpu, f"pt_any_{k}")
    with pytest.raises(RuntimeError):
        profiling.counter_row(cpu, "pt_any_one_more")


def test_start_trace_writes_the_frame_spans(cornell_tracer, tmp_path):
    """The operator's route: start_trace, a frame, stop_trace; the Chrome
    trace it writes holds the frame's spans."""
    db, scene, cam = cornell_tracer
    pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), 16, 16,
                    PathTracerSettings(ray_depth=1), device="cpu")
    profiling.start_trace(str(tmp_path))
    try:
        pt.render_frame(cam)
    finally:
        path = profiling.stop_trace()
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"pt/frame", "pt/raygen", "pt/camera upload", "pt/bounce", "pt/closest",
            "pt_closest_pri", "pt/lights", "pt/shade", "pt/nee", "pt_any_nee",
            "pt/accumulate"} <= names
