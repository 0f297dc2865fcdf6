"""The deferred cell on the CPU: the plain tree of bvh_tracer.py against
tracer.py, query for query; the cell at 48x32 with a 16^3 grid (the result
line's schema, the program against the plain reference, the control in
bfloat16 failing, each fault planted under the deferred frame's timed path
turning `correct` false); the traffic mix the path-traced cell's walk."""
import json
import os

import pytest
import torch

from benchmark import harness
from benchmark.reference.bvh_tracer import BvhTracer
from benchmark.reference.tracer import Tracer
from benchmark.scenes import atrium
from benchmark.tests.common import small_run

from idkengine_tpu_torch.render import deferred, pipeline

CELL = "deferred-atrium2m"
GRID16 = {"config": {"settings": {"vxgi": {"resolution": 16}}}}


@pytest.fixture(scope="module")
def rays():
    """The 20,000-triangle atrium, one triangle planted again after the
    others (an equal-t tie for every ray through it), and 4,384 seeded rays:
    3,584 from inside the hall, 256 dead, 256 short, 32 from 1e8 units
    away, 256 through the planted triangle's centre."""
    scene = atrium.generate({"triangles": 20000}, 7)
    pos, idx, _, _ = scene.concatenated()
    p = torch.as_tensor(pos)[torch.as_tensor(idx)]
    p = torch.cat([p, p[1234:1235]])
    v0, v1, v2 = p[:, 0], p[:, 1], p[:, 2]
    g = torch.Generator().manual_seed(1)
    n = 4384
    o = ((torch.rand(n, 3, generator=g) - 0.5) * torch.tensor([22.0, 11.0, 58.0])
         + torch.tensor([0.0, 6.0, 0.0]))
    d = torch.randn(n, 3, generator=g)
    t_max = torch.full((n,), 3.4e38)
    t_max[:256] = -1.0
    t_max[256:512] = torch.rand(256, generator=g) * 5.0
    far = slice(512, 544)
    d = d / d.norm(dim=-1, keepdim=True)
    o[far] = o[far] - d[far] * 1e8
    t_max[far] = 2e8
    tie = slice(n - 256, n)
    c = (v0[-1] + v1[-1] + v2[-1]) / 3.0
    d[tie] = c - o[tie]
    d = d / d.norm(dim=-1, keepdim=True)
    return (v0, v1, v2), (o, d, t_max), tie


def test_bvh_tracer_answers_as_the_plain_tracer(rays):
    tris, (o, d, t_max), tie = rays
    plain, tree = Tracer(*tris), BvhTracer(*tris)
    want, got = plain.closest(o, d, t_max), tree.closest(o, d, t_max)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    t, tri, _, _ = got
    assert (tri[:256] == -1).all() and torch.equal(t[:256], t_max[:256])
    n_tri = tris[0].shape[0]
    # the planted copy ties with its original, which wins where it is the closest
    assert (tri[tie] == 1234).any() and not (tri == n_tri - 1).any()
    occ = tree.occluded(o, d, t_max)
    assert torch.equal(occ, plain.occluded(o, d, t_max))
    assert torch.equal(occ, tri >= 0)


def test_small_cell_schema_and_agreement():
    res = small_run(trace=True, control=True, workload=CELL, over=GRID16, seconds=1.5)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    spec = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    assert set(res["metrics"]) <= {m["name"] for m in harness.metrics_of(spec, CELL, "per_layer")}
    # the program's own counts, read on the CPU too
    assert 0.0 <= res["metrics"]["sky_shadow_ray_pct"]["value"] < 100.0
    limit = res["check"]["mismatch_pct"]["limit"]
    assert res["check"]["mismatch_pct"]["value"] <= limit
    assert res["control"]["mismatch_pct"] > limit
    json.dumps(res)


def test_end_to_end_metrics_of_an_untraced_run():
    res = small_run(seed=2 ** 31 + 29, workload=CELL, over=GRID16, seconds=1.0)
    assert set(res["metrics"]) == {"frame_ms.textured", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())


def _stale(real):
    """render_frame that renders its first frame and then returns that image
    again: the state is never advanced."""
    def run(self, cam):
        if not hasattr(self, "_stale"):
            self._stale = real(self, cam)
        return self._stale
    return run


def _lit(fault):
    real = deferred.shade_deferred

    def run(*args, **kw):
        return fault(real(*args, **kw))
    return run


def _half(color):
    out = color.clone()
    out[color.shape[0] // 2:] = 0.0
    return out


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered"])
def test_faults_turn_correct_false(monkeypatch, fault):
    if fault == "state_unchanged":
        monkeypatch.setattr(pipeline.DeferredPipeline, "render_frame",
                            _stale(pipeline.DeferredPipeline.render_frame))
    elif fault == "half_left_out":
        monkeypatch.setattr(deferred, "shade_deferred", _lit(_half))
    else:
        monkeypatch.setattr(deferred, "shade_deferred", _lit(lambda c: c * 1.01))
    res = small_run(seed=5, workload=CELL, over=GRID16, seconds=1.5)
    assert res["correct"] is False
    assert res["failed"] >= 1


def test_traffic_is_the_walk_of_the_path_traced_cell():
    _, _, _, walk = harness.cell("pt-atrium2m")
    _, wl, config, traffic = harness.cell(CELL)
    assert wl["chips"] == 1 and config["renderer"] == "deferred"
    for k in ("scene", "build", "lights", "camera"):
        assert traffic[k] == walk[k], k
    assert traffic["warmup_frames"] == walk["warmup_frames"]
