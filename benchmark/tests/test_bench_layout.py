"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by name."""
import json
import os
import re
import shutil

import pytest

from benchmark import harness

ROOT = harness.ROOT
SPEC = harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"][1] == "benchmark/run.py" and len(SPEC["command"]) <= 32
    assert all(line_ok(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"]) and line_ok(c["why"])
        assert c["source"].startswith("https://")
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        body = harness.read_json(os.path.join(ROOT, c["file"]))
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert {"source", "assumed", "reduced", "renderer", "precision"} <= set(body)
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["name"] in used


def test_workloads_and_their_files():
    names = set()
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line_ok(w["why"])
        assert w["chips"] in (1, 4) and w["name"] not in names
        assert (w["config"], w["traffic"]) not in pairs
        names.add(w["name"])
        pairs.add((w["config"], w["traffic"]))
        _, _, config, traffic = harness.cell(w["name"])
        for module in (f"scenes/{traffic['scene']['generator']}.py",
                       f"renderers/{config['renderer']}.py", f"reference/{config['renderer']}.py",
                       f"limits/{w['name']}.json"):
            assert os.path.isfile(os.path.join(harness.HERE, module)), module
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(SPEC["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    seen = set()
    for kind, keys in (("end_to_end", {"name", "unit", "better", "bound", "source"}),
                       ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for m in SPEC[kind]:
            assert set(m) - {"workloads"} == keys, m
            assert NAME.match(m["name"]) and m["name"] not in seen and UNIT.match(m["unit"])
            seen.add(m["name"])
            assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
            assert set(m.get("workloads", cells)) <= cells
            assert os.path.isfile(harness.reader(m["name"]).__file__)
            if kind == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert line_ok(m["layer"]) and m["moves"] in e2e
                # a metric's cells report the end-to-end metric it moves
                moved = next(x for x in SPEC["end_to_end"] if x["name"] == m["moves"])
                assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))
    assert "setup_s" in e2e
    for c in cells:
        reported = {m["name"] for m in harness.metrics_of(SPEC, c, "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.metrics_of(SPEC, c, "per_layer")


def test_a_new_traffic_mix_takes_only_a_file_and_an_entry(tmp_path):
    """A copy of the benchmark with one more traffic file and one more
    workload entry: the harness finds the new cell with no other change."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = dict(SPEC)
    walk = harness.read_json(os.path.join(harness.HERE, "traffic", "atrium2m-walk.json"))
    walk["scene"]["triangles"] = 110_000
    (root / "benchmark" / "traffic" / "atrium110k-walk.json").write_text(json.dumps(walk))
    spec["workloads"] = SPEC["workloads"] + [dict(SPEC["workloads"][0], name="pt-atrium110k",
                                                   traffic="atrium110k-walk")]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    _, wl, config, traffic = harness.cell("pt-atrium110k", str(root))
    assert traffic["scene"]["triangles"] == 110_000 and config["renderer"] == "path_tracer"
    with pytest.raises(KeyError):
        harness.cell("pt-atrium110k")
