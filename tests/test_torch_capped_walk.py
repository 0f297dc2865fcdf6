"""The capped walk's lane utilization and the plain walk's lockstep leaf
trips, on the CPU.

`chip_smoke.lane_utilization` and `warp_trips` against hand counts on
warps of 32 lanes: the share of lane-steps that do work when each thread
walks one ray and a warp runs until its longest ray stops (what a per-lane
ray refill could at best raise to 1). `ops/trace._traverse(leaf_trips=...)`
against the triangles the walk reads: the leaf trips of warps of 32 rays
in lockstep, from which trace_ab.py states the capped kernels' issue
time."""
import os
import sys

import numpy as np
import pytest
import torch
from worker_threads import share_cores

share_cores()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import WARP, lane_utilization, warp_trips  # noqa: E402
from idkengine_tpu_torch.ops import trace as plain  # noqa: E402


def test_equal_rays_use_every_lane():
    assert lane_utilization(torch.full((32,), 7, dtype=torch.int32)) == 1.0
    assert lane_utilization(torch.full((96,), 2, dtype=torch.int32)) == 1.0
    assert warp_trips(torch.full((96,), 2, dtype=torch.int32)) == 6


def test_one_long_ray_among_short_ones():
    steps = torch.ones(32, dtype=torch.int32)
    steps[5] = 100
    assert warp_trips(steps) == 100
    assert lane_utilization(steps) == pytest.approx((31 + 100) / (32 * 100))


def test_partial_last_warp_counts_its_idle_lanes():
    steps = torch.tensor([2] * 32 + [3] * 8, dtype=torch.int32)
    assert warp_trips(steps) == 2 + 3
    assert lane_utilization(steps) == pytest.approx((2 * 32 + 3 * 8) / (32 * 2 + 32 * 3))
    assert lane_utilization(torch.full((5,), 1, dtype=torch.int32)) == pytest.approx(5 / 32)


def test_launch_order_and_warp_width():
    assert WARP == 32
    # 32 rays of 1 step, then 31 of 1 and one of 9: warps (1 ... 1), (1 ... 1, 9)
    steps = torch.ones(64, dtype=torch.int32)
    steps[63] = 9
    assert warp_trips(steps) == 1 + 9
    assert lane_utilization(steps) == pytest.approx((63 + 9) / (32 * 10))
    # the long ray moved into the first warp: (9, 1 ... 1), (1 ... 1)
    assert lane_utilization(steps.flip(0)) == pytest.approx((63 + 9) / (32 * 10))
    # two long rays in one warp cost one warp's trips, in two warps two
    steps[0] = 9
    assert warp_trips(steps) == 9 + 9
    steps[0], steps[62] = 1, 9
    assert warp_trips(steps) == 1 + 9
    assert warp_trips(torch.zeros(0, dtype=torch.int32)) == 0
    assert lane_utilization(torch.zeros(0, dtype=torch.int32)) == 1.0


@pytest.fixture(scope="module")
def small_scene():
    from idkengine_tpu_torch.bvh.builder import BuildSettings
    from idkengine_tpu_torch.scene.procedural import atrium
    from idkengine_tpu_torch.scene.scene_db import SceneDatabase

    db = SceneDatabase(BuildSettings(max_leaf_triangle_count=12, traversal_cost=4.0,
                                     presplit_factor=0.0))
    db.add_model(atrium(2000))
    return db.build("cpu")


def _scene_rays(sc, n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(sc.node_min[0].numpy(), sc.node_max[0].numpy(), (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


def _leaf_trips(sc, o, d, t_max, any_hit, visited=None, steps=None):
    leaf = torch.zeros(1, dtype=torch.int64)
    hit = plain._traverse(sc, o, d, t_max, any_hit, steps, 64, visited, leaf_trips=leaf)
    return int(leaf.item()), hit


@pytest.mark.parametrize("any_hit", [False, True])
def test_warp_work_of_the_plain_walk(small_scene, any_hit):
    """The lockstep warps' work on the plain walk: one ray's loop trips are
    its steps and its leaf trips the triangles it tests: every triangle of
    each leaf it enters (the walk enters a leaf once), or fewer where an
    any-hit ray stops. A warp of one ray repeated takes that ray's trips;
    a batch's are the sum of its warps' (launch order, the last warp
    partial), and counting them changes no result."""
    sc = small_scene
    o, d = _scene_rays(sc, 70, 3)
    t_max = torch.full((70,), 4.0 if any_hit else 3.4e38)
    want = plain._traverse(sc, o, d, t_max, any_hit, max_steps=64)
    batch, got = _leaf_trips(sc, o, d, t_max, any_hit)
    assert torch.equal(got.t, want.t) and torch.equal(got.slot, want.slot)
    warps = sum(_leaf_trips(sc, o[i:i + 32], d[i:i + 32], t_max[i:i + 32], any_hit)[0]
                for i in range(0, 70, 32))
    assert batch == warps
    for i in range(4):
        seen = (torch.zeros(sc.bvh_thread.shape[0], dtype=torch.bool),
                torch.zeros(sc.tri_p0.shape[0], dtype=torch.bool))
        steps = torch.zeros(1, dtype=torch.int32)
        one, _ = _leaf_trips(sc, o[i:i + 1], d[i:i + 1], t_max[i:i + 1], any_hit, seen, steps)
        assert warp_trips(steps) == int(steps[0]) > 0
        if any_hit:
            assert one <= int(seen[1].sum())
        else:
            assert one == int(seen[1].sum())
        steps32 = torch.zeros(32, dtype=torch.int32)
        same = _leaf_trips(sc, o[i:i + 1].expand(32, 3), d[i:i + 1].expand(32, 3),
                           t_max[i:i + 1].expand(32), any_hit, steps=steps32)[0]
        assert same == one and warp_trips(steps32) == int(steps[0])
    assert batch > 0
