"""The readers of the program's frame spans and traversal counters on a
hand-made timeline: the sort's and shading's device ms, the host's blocking
waits by gap label, nodes and triangles a ray; each reads nothing where the
program recorded nothing."""
from types import SimpleNamespace

import pytest

from benchmark import timeline
from benchmark.metrics import (host_wait_ms, pt_glue_ms, pt_shade_ms, pt_sort_ms,
                               trace_nodes_per_ray, trace_tris_per_ray)
from idkengine_tpu_torch import profiling

F = timeline.FRAME_RANGE


def op(name, ms, *ranges):
    return timeline.Op(name, 0.0, ms * 1e3, {F, "pt/frame", *ranges})


def data(ops=(), gaps=(), frames=2):
    tl = timeline.Timeline(ops=list(ops), frames=frames, window_s=0.1, busy_s=0.05,
                           gaps=list(gaps))
    return SimpleNamespace(timeline=tl, hand_kernels=("trace_kernel",))


def test_sort_and_shade_are_parts_of_the_glue():
    d = data([op("sort_kernel", 2.0, "pt/bounce", "pt/sort"),
              op("index_kernel", 1.0, "pt/bounce", "pt/sort"),
              op("gather_kernel", 4.0, "pt/bounce", "pt/shade"),
              op("atlas_kernel", 8.0, "pt/bounce", "pt/shade", "pt/textures"),
              op("void trace_kernel<false, false>", 16.0, "pt/bounce", "pt/closest",
                 "pt_closest_pri"),
              op("where_kernel", 0.5, "pt/bounce", "pt/lights")])
    assert pt_sort_ms.read(d) == 1.5
    assert pt_shade_ms.read(d) == 2.0  # less the texture range and the hand kernels
    assert pt_glue_ms.read(d) == 3.75
    assert pt_sort_ms.read(d) + pt_shade_ms.read(d) <= pt_glue_ms.read(d)
    none = data([op("where_kernel", 0.5, "pt/bounce", "pt/lights")])
    assert pt_sort_ms.read(none) is None and pt_shade_ms.read(none) is None
    untraced = SimpleNamespace(timeline=None, hand_kernels=())
    assert pt_sort_ms.read(untraced) is None and pt_shade_ms.read(untraced) is None


def test_host_wait_reads_blocking_gaps_under_the_programs_spans():
    gaps = [(0.004, "pt/camera upload > cudaStreamSynchronize"),
            (0.001, "pt/camera upload > cudaMemcpyAsync"),
            (0.002, "pt/textures > aten::_local_scalar_dense"),
            (0.003, "pt/nee > python"),  # the host in Python: no wait
            (0.005, "pt_closest_pri > cudaLaunchKernel"),
            (0.008, f"{F} > cudaDeviceSynchronize"),  # the harness's own wait
            (0.006, "aten::copy_")]  # outside any range
    assert host_wait_ms.read(data(gaps=gaps)) == pytest.approx(3.5)
    assert host_wait_ms.read(data(gaps=gaps[3:5])) == 0.0
    # the parent's spans: only the harness's range labels a gap
    assert host_wait_ms.read(data(gaps=gaps[5:])) is None
    assert host_wait_ms.read(SimpleNamespace(timeline=None)) is None


def test_traversal_counters_per_ray(monkeypatch):
    d = data()
    rows = {"pt_closest_pri": {"rays": 100, "nodes": 2500, "tris": 900},
            "pt_any_nee": {"rays": 60, "nodes": 700, "tris": 380}}
    monkeypatch.setattr(profiling, "report", lambda: rows)
    assert trace_nodes_per_ray.read(d) == 20.0
    assert trace_tris_per_ray.read(d) == 8.0
    assert trace_nodes_per_ray.read(SimpleNamespace(timeline=None)) is None
    # a program without counters: no rows, or the old pass timer's {name: ms}
    for old in ({}, {"pt/pass": 1.5}):
        monkeypatch.setattr(profiling, "report", lambda old=old: old)
        assert trace_nodes_per_ray.read(d) is None and trace_tris_per_ray.read(d) is None
    monkeypatch.delattr(profiling, "report")
    assert trace_nodes_per_ray.read(d) is None
