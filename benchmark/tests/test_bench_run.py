"""A run of the repository's cell at a small size on the CPU: the result
line's schema, the plain reference against the program, the control in
the precision below (bfloat16) failing, and each fault the cell can have,
planted under the timed path, turning `correct` false."""
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests.common import small_run

from idkengine_tpu_torch.render import pathtracer


@pytest.mark.parametrize("workload", ["pt-atrium2m", "pt-atrium2m-textured"])
def test_result_line_schema_and_agreement(workload):
    res = small_run(trace=True, control=True, workload=workload)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "check"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s", "window_s"} <= set(
        res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in res["breakdown"].values())
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(res["metrics"]) <= {m["name"] for m in harness.metrics_of(
        harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json")), workload,
        "per_layer")}
    limit = res["check"]["mismatch_pct"]["limit"]
    assert res["check"]["mismatch_pct"]["value"] <= limit
    # the control: the reference in bfloat16 in the program's place
    assert res["control"]["mismatch_pct"] > limit
    json.dumps(res)


@pytest.mark.parametrize("workload,names", [
    ("pt-atrium2m", {"frame_ms", "frame_ms_p95", "setup_s"}),
    ("pt-atrium2m-textured", {"frame_ms.textured", "setup_s"})])
def test_end_to_end_metrics_of_an_untraced_run(workload, names):
    res = small_run(seed=2 ** 31 + 17, workload=workload)
    assert set(res["metrics"]) == names
    assert all(m["value"] > 0 for m in res["metrics"].values())


def _sample_with(fault):
    real = pathtracer.PathTracer._render_sample

    def broken(self, *args, **kw):
        out = real(self, *args, **kw)
        return (fault(out[0]),) + tuple(out[1:])
    return broken


@pytest.mark.parametrize("workload", ["pt-atrium2m", "pt-atrium2m-textured"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered"])
def test_faults_turn_correct_false(monkeypatch, fault, workload):
    if fault == "state_unchanged":
        # the frame renders nothing: the image is the state as it was
        monkeypatch.setattr(pathtracer.PathTracer, "render_frame", lambda self, cam, rd=None:
                            self.image())
    elif fault == "half_left_out":
        def half(rad):
            out = rad.clone()
            out[rad.shape[0] // 2:] = 0.0
            return out
        monkeypatch.setattr(pathtracer.PathTracer, "_render_sample", _sample_with(half))
    else:
        monkeypatch.setattr(pathtracer.PathTracer, "_render_sample",
                            _sample_with(lambda rad: rad * 1.01))
    res = small_run(seed=5, workload=workload)
    assert res["correct"] is False
    assert res["failed"] >= 1


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "pt-atrium2m", "--seed",
                        "1", "--seconds", "1", "--trace", "0"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_in_a_folder_without_the_program_fails(tmp_path):
    import shutil
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "pt-atrium2m", "--seed",
                        "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
def test_small_cell_on_the_card(card):
    res = small_run(trace=True, control=True, device=card)
    assert res["correct"] is True
    assert res["control"]["mismatch_pct"] > res["check"]["mismatch_pct"]["limit"]
    assert res["device"]["busy_s"] > 0
