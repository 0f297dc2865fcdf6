"""The trace calls' bytes against a count by hand on a small scene: the
recorder stands in for the port's entry points during one frame."""
import numpy as np
import torch

from benchmark import roofline
from benchmark.renderers import path_tracer as driver
from benchmark.scenes import atrium
from benchmark.scenes.common import Light
from benchmark.tests.common import SMALL
from benchmark import harness


def test_bytes_of_a_frames_calls_by_hand():
    _, _, config, traffic = harness.cell("pt-atrium2m")
    config, traffic = harness.merged(config, SMALL["config"]), harness.merged(traffic,
                                                                               SMALL["traffic"])
    scene = atrium.generate(traffic["scene"], 3)
    scene.lights = [Light((0.0, 10.5, 0.0), (40.0, 38.0, 35.0), 0.8)]
    r = driver.Renderer(config, traffic, scene, "cpu")
    arrays = r.tracer.scene
    nodes = arrays.bvh4_nodes.shape[0] * 32 * 4  # (M, 32) int32 records
    tris = scene.n_triangles * 36  # p0, e1, e2 in float32
    with roofline.record_traces("idkengine_tpu_torch") as calls:
        r.frame(traffic["camera"]["poses"][0])
    px = 48 * 32
    kinds = [c.kind for c in calls]
    # depth 2: a closest trace and an occlusion trace a bounce
    assert kinds == ["trace_closest", "trace_any", "trace_closest", "trace_any"]
    primary = calls[0]
    assert primary.rays == px and primary.live() == px
    # a frame's worth of live rays is charged the whole tables
    assert primary.bytes(px) == px * 28 + px * 16 + nodes + tris
    for c in calls[1:]:
        live = int((c.t_max > 0).sum())
        out = 16 if c.kind == "trace_closest" else 1
        assert c.bytes(px) == live * 28 + px * out + (nodes + tris) * live // px


def test_a_dead_batch_reads_no_table():
    c = roofline.Call("trace_any", 100, torch.full((100,), -1.0), 10 ** 6)
    assert c.live() == 0 and c.bytes(100) == 100
    c = roofline.Call("trace_closest", 100, 5.0, 10 ** 6)
    assert c.bytes(100) == 100 * 28 + 100 * 16 + 10 ** 6


def test_tables_scale_with_live_rays_up_to_once():
    t_max = torch.full((1000,), -1.0)
    t_max[:250] = 1.0
    c = roofline.Call("trace_any", 1000, t_max, 10 ** 6)
    assert c.bytes(1000) == 250 * 28 + 1000 + 10 ** 6 // 4
    # more live rays than pixels (several samples in one call): the tables once
    assert c.bytes(100) == 250 * 28 + 1000 + 10 ** 6
    # a frame split into four calls is charged the tables as one call is
    parts = [roofline.Call("trace_closest", 250, 1.0, 10 ** 6) for _ in range(4)]
    whole = roofline.Call("trace_closest", 1000, 1.0, 10 ** 6)
    assert sum(p.bytes(1000) for p in parts) == whole.bytes(1000)


def test_peaks_table():
    p = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert roofline.peaks("no such card") is None
    assert np.isfinite(p["f32_flops_per_s"])
