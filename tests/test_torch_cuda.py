"""CUDA kernels vs their plain versions, on the card (marker `cuda`; run
with `python -m pytest tests/test_torch_*.py -m cuda`). Without a card
these tests skip.

Scatter-max: the max of a set of floats does not depend on the order of
the atomics, so the kernel equals its plain version exactly.

Traversal (one-phase, two-phase and the steps kernel):
the kernel is built with -fmad=false and performs the plain version's float
operations in the same order, its fused multiply-adds as __fmaf_rn where
the plain version rounds them once, so t, u and v agree bit for bit
wherever both pick the same triangle. Slots may differ only at ties (two triangles at the
same t, met in another order: the kernel visits near children first, the
plain version in DFS order), on at most 0.1% of rays. Phase A's count of
wanted leaves does not depend on the visiting order, so it is equal on
every ray, and the lists hold the same sets where they did not overflow.
Occlusion does not depend on the order either (until the first occluder
every leaf whose box the ray passes before t_max is tested), so the any-hit
kernel equals its plain version on every ray. Rays from 1e8 units away
(f32 spacing 8 units) keep the hit mask, and t within 1e-5 relative on
SLOT_AGREE of the rays, but not the share of equal slots: there the
Möller–Trumbore t of a triangle carries errors of thousands of units (s =
o - p0 is 1e8 long), many hits tie, and a triangle's t can fall far below
its own box's entry distance, so which hit a closest query keeps depends
on which boxes it culled first (see test_torch_wide_bvh.py). The steps
kernel walks the threaded tree in the plain version's order, so it equals
it on every ray, from 1e8 too.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from idkengine_tpu_torch.bvh.builder import BuildSettings
from idkengine_tpu_torch.ops import packet_trace as kern
from idkengine_tpu_torch.ops import trace as plain
from idkengine_tpu_torch.ops import voxel_scatter as vs
from idkengine_tpu_torch.render import Camera, PathTracer, PathTracerSettings
from idkengine_tpu_torch.scene.procedural import atrium
from idkengine_tpu_torch.scene.scene_db import SceneDatabase
from worker_threads import share_cores

share_cores()

pytestmark = pytest.mark.cuda

BUILD = dict(max_leaf_triangle_count=12, traversal_cost=4.0, presplit_factor=0.0)
SLOT_AGREE = 0.999


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scenes(dev):
    db = SceneDatabase(BuildSettings(**BUILD))
    db.add_model(atrium(20_000))
    gpu = db.build(dev)
    db2 = SceneDatabase(BuildSettings(**BUILD))
    db2.add_model(atrium(20_000))
    return db, gpu, db2.build("cpu")


def _rays(sc, n, seed, dev):
    rng = np.random.default_rng(seed)
    lo, hi = sc.node_min[0].cpu().numpy(), sc.node_max[0].cpu().numpy()
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def test_closest_kernel_matches_plain(dev, scenes):
    _, sc, _ = scenes
    o, d = _rays(sc, 1 << 16, 1, dev)
    t_max = torch.where(torch.arange(o.shape[0], device=dev) % 7 == 0, -1.0, 3.4e38)
    before = kern.trace_closest.launches
    got = kern.trace_closest(sc, o, d, t_max)
    torch.cuda.synchronize()
    assert kern.trace_closest.launches == before + 1
    want = plain.trace_closest(sc, o, d, t_max)
    gs, ws = got.slot.cpu().numpy(), want.slot.cpu().numpy()
    np.testing.assert_array_equal(gs >= 0, ws >= 0)
    assert (gs == ws).mean() >= SLOT_AGREE
    same = gs == ws
    for k in ("t", "u", "v"):
        np.testing.assert_array_equal(getattr(got, k).cpu().numpy()[same],
                                      getattr(want, k).cpu().numpy()[same], err_msg=k)
    np.testing.assert_allclose(got.t.cpu().numpy(), want.t.cpu().numpy(), rtol=1e-6)


def test_any_kernel_matches_plain(dev, scenes):
    _, sc, _ = scenes
    o, d = _rays(sc, 1 << 16, 2, dev)
    t_max = torch.where(torch.arange(o.shape[0], device=dev) % 5 == 0, -1.0, 6.0)
    before = kern.trace_any.launches
    got = kern.trace_any(sc, o, d, t_max)
    torch.cuda.synchronize()
    assert kern.trace_any.launches == before + 1
    want = plain.trace_any(sc, o, d, t_max)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def _rays_of(kind, sc, n, seed, dev):
    """Rays of one kind (o, d, t_max) from a numpy seed: random directions
    from random points of the scene box ("incoherent"), the same with dead
    rays, t_max = 0 and -0.0 among short and long limits ("dead_and_zero"),
    from random points inside random leaves' boxes ("inside_leaves"), or
    from 1e8 units away towards random points of the scene ("from_1e8")."""
    rng = np.random.default_rng(seed)
    lo, hi = sc.node_min[0].cpu().numpy(), sc.node_max[0].cpu().numpy()
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    t_max = np.full(n, 3.4e38, np.float32)
    if kind == "dead_and_zero":
        t_max = rng.choice(np.float32([-1.0, 0.0, -0.0, 0.5, 5.0, 3.4e38]), n)
    elif kind == "inside_leaves":
        count = sc.node_count.cpu().numpy()
        leaf = rng.choice(np.nonzero(count > 0)[0], n)
        o = rng.uniform(sc.node_min[leaf].cpu().numpy(), sc.node_max[leaf].cpu().numpy())
    elif kind == "from_1e8":
        o = o - d * np.float32(1e8)
        t_max[:] = 2e8
    return (torch.from_numpy(o.astype(np.float32)).to(dev), torch.from_numpy(d).to(dev),
            torch.from_numpy(t_max.astype(np.float32)).to(dev))


@pytest.mark.parametrize("kind", ["incoherent", "dead_and_zero", "inside_leaves", "from_1e8"])
def test_wide_kernel_matches_plain(dev, scenes, kind):
    """The 4-wide kernel against the plain stackless trace: the same hit
    mask, t = t_max on a miss, t, u and v bit-equal where the slots agree,
    slots equal on SLOT_AGREE of the rays (from 1e8: t within 1e-5
    relative on SLOT_AGREE of the rays instead); occlusion equal on every
    ray and equal to the kernel's own closest hit before t_max."""
    _, sc, _ = scenes
    o, d, t_max = _rays_of(kind, sc, 1 << 16, 21, dev)
    got = kern.trace_closest(sc, o, d, t_max)
    want = plain.trace_closest(sc, o, d, t_max)
    hit = got.slot >= 0
    assert torch.equal(hit, want.slot >= 0)
    assert torch.equal(got.t[~hit], t_max[~hit]) and not hit[t_max <= 0].any()
    same = got.slot == want.slot
    for k in ("t", "u", "v"):
        assert torch.equal(getattr(got, k)[same], getattr(want, k)[same]), k
    if kind == "from_1e8":
        close = torch.isclose(got.t, want.t, rtol=1e-5, atol=0)
        assert close.float().mean().item() >= SLOT_AGREE
    else:
        assert same.float().mean().item() >= SLOT_AGREE
    assert hit.float().mean().item() > (0.01 if kind == "from_1e8" else 0.2)
    occ = kern.trace_any(sc, o, d, t_max)
    assert torch.equal(occ, plain.trace_any(sc, o, d, t_max))
    assert torch.equal(occ, hit)


@pytest.mark.parametrize("n", [1, 5, 33, 1 << 20])
def test_wide_kernel_batch_sizes(dev, scenes, n):
    """Launches smaller than one warp and larger than the card holds at
    once: every ray answered, as the plain version answers it."""
    _, sc, _ = scenes
    o, d, t_max = _rays_of("dead_and_zero", sc, n, 22, dev)
    got = kern.trace_closest(sc, o, d, t_max)
    want = plain.trace_closest(sc, o, d, t_max)
    assert torch.equal(got.slot >= 0, want.slot >= 0)
    same = got.slot == want.slot
    assert same.float().mean().item() >= SLOT_AGREE
    assert torch.equal(got.t[same], want.t[same])
    assert torch.equal(kern.trace_any(sc, o, d, t_max), plain.trace_any(sc, o, d, t_max))


def test_wide_kernel_refuses_a_stack_it_cannot_hold(dev, scenes):
    import dataclasses

    _, sc, _ = scenes
    o, d, _ = _rays_of("incoherent", sc, 64, 23, dev)
    deep = dataclasses.replace(sc, bvh4_depth=kern.WIDE_STACK_LIMIT // 3 + 1)
    before = (kern.trace_closest.launches, kern.trace_any.launches)
    with pytest.raises(ValueError, match="stack"):
        kern.trace_closest(deep, o, d, 1.0)
    with pytest.raises(ValueError, match="stack"):
        kern.trace_any(deep, o, d, 1.0)
    assert (kern.trace_closest.launches, kern.trace_any.launches) == before


def test_kernel_refuses_bad_inputs(dev, scenes):
    _, sc, _ = scenes
    o, d = _rays(sc, 64, 3, dev)
    with pytest.raises(TypeError):
        kern.trace_closest(sc, o.double(), d, 1.0)
    with pytest.raises(ValueError):
        kern.trace_closest(sc, o[:, :2], d, 1.0)
    with pytest.raises(ValueError):
        kern.trace_any(sc, o.t().contiguous().t(), d, 1.0)
    with pytest.raises(ValueError):
        kern.trace_closest(sc, o.cpu(), d, 1.0)


def test_pathtracer_on_card_matches_cpu(dev, scenes):
    db, gpu, cpu = scenes
    db.lights.add([0.0, 10.5, 0.0], [40.0, 38.0, 35.0], radius=0.8)
    db.lights.add([6.0, 4.0, -20.0], [20.0, 10.0, 5.0], radius=0.5)
    settings = PathTracerSettings(ray_depth=2, russian_roulette=False, do_ray_sorting=True)
    cam = Camera(position=np.array([0.0, 3.0, 24.0], np.float32), yaw=-90.0, fov_y=65.0)
    kern.reset_launch_counts()
    pt_gpu = PathTracer(gpu, db.materials.soa(), db.lights.soa(), 64, 48, settings, device=dev)
    img_gpu = pt_gpu.render_frame(cam).cpu().numpy()
    assert kern.trace_closest.launches == 2 and kern.trace_any.launches == 2
    pt_cpu = PathTracer(cpu, db.materials.soa(), db.lights.soa(), 64, 48, settings, device="cpu")
    img_cpu = pt_cpu.render_frame(cam).numpy()
    assert np.isfinite(img_gpu).all() and img_gpu.std() > 0
    assert float(np.sqrt(np.mean((img_gpu - img_cpu) ** 2))) <= 1e-3
    # the card's and the CPU's sin/cos/exp differ in the last place, so a
    # shadow ray whose cosine or sphere test sits at its threshold may be
    # traced on one and not the other
    rays_gpu, rays_cpu = float(pt_gpu.last_rays_traced), float(pt_cpu.last_rays_traced)
    assert abs(rays_gpu - rays_cpu) <= 1e-3 * rays_cpu


def _updates(kind, seed=0):
    """(cell (N,) int32, vals (C,N) float32, n_cells) from a numpy seed."""
    rng = np.random.default_rng(seed)
    if kind == "random_with_out_of_range":
        n_cells = 2048
        cell = rng.integers(-300, n_cells + 300, 700)
        vals = rng.uniform(0, 10, (4, 700))
    elif kind == "one_cell":  # every update lands in one cell
        n_cells = 4096
        cell = np.full(999, 77)
        vals = np.linspace(0, 5, 999 * 2).reshape(2, 999)
    return cell.astype(np.int32), vals.astype(np.float32), n_cells


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", ["random_with_out_of_range", "one_cell"])
def test_scatter_kernel_equals_plain(dev, kind, bf16):
    cell, vals, n_cells = _updates(kind)
    c, v = torch.from_numpy(cell), torch.from_numpy(vals)
    before = vs.scatter_max_dense.launches
    got = vs.scatter_max_dense(c.to(dev), v.to(dev), n_cells, bf16=bf16)
    torch.cuda.synchronize()
    assert vs.scatter_max_dense.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  vs.scatter_max_dense_plain(c, v, n_cells, bf16).numpy())


def test_scatter_kernel_at_voxelizer_width(dev):
    """2^20 updates into a 256^3 grid, many per cell, with zeros and -0.0."""
    g = torch.Generator(device=dev).manual_seed(0)
    n, n_cells = 1 << 20, 256 ** 3
    cell = torch.randint(0, n_cells // 64, (n,), generator=g, device=dev, dtype=torch.int32)
    vals = torch.rand((4, n), generator=g, device=dev) * 50.0
    vals[:, ::7] = 0.0
    vals[:, 3::11] = -0.0
    for bf16 in (False, True):
        got = vs.scatter_max_dense(cell, vals, n_cells, bf16=bf16)
        want = vs.scatter_max_dense_plain(cell, vals, n_cells, bf16)
        assert torch.equal(got, want)
        assert not torch.signbit(got).any()


def test_scatter_kernel_refuses_bad_inputs(dev):
    cell = torch.zeros(8, dtype=torch.int32, device=dev)
    vals = torch.ones((4, 8), device=dev)
    with pytest.raises(TypeError):
        vs.scatter_max_dense(cell.long(), vals, 64)
    with pytest.raises(TypeError):
        vs.scatter_max_dense(cell, vals.double(), 64)
    with pytest.raises(ValueError):
        vs.scatter_max_dense(cell, vals.t().contiguous().t(), 64)
    with pytest.raises(ValueError):
        vs.scatter_max_dense(cell.cpu(), vals, 64)


def test_deferred_pipeline_on_card_matches_cpu(dev):
    """VXGI (bf16 grid on the card, f32 on the CPU), SSAO, TAA, bloom and
    ray-traced shadows over two frames; the card's frame goes through both
    kernels."""
    from idkengine_tpu_torch.render import DeferredPipeline, DeferredSettings2
    from idkengine_tpu_torch.render.vxgi import VxgiSettings

    cam = Camera(position=np.array([0.0, 3.0, 24.0], np.float32), yaw=-90.0, fov_y=65.0)
    imgs = []
    for device in (dev, "cpu"):
        db = SceneDatabase(BuildSettings(**BUILD))
        db.add_model(atrium(8000))
        db.build(device)
        db.lights.add([0.0, 10.5, 0.0], [40.0, 38.0, 35.0], radius=0.8)
        db.lights.add([6.0, 4.0, -20.0], [20.0, 10.0, 5.0], radius=0.5)
        pipe = DeferredPipeline(db, 64, 48, DeferredSettings2(
            use_vxgi=True, vxgi=VxgiSettings(resolution=32)), device=device)
        kern.reset_launch_counts()
        vs.reset_launch_counts()
        for _ in range(2):
            img = pipe.render_frame(cam)
        imgs.append(img.cpu().numpy())
        if device == dev:
            assert vs.scatter_max_dense.launches == 2
            assert kern.trace_closest.launches == 2 and kern.trace_any.launches == 8
    assert np.isfinite(imgs[0]).all() and imgs[0].std() > 0.01
    assert float(np.sqrt(np.mean((imgs[0] - imgs[1]) ** 2))) <= 1e-3


def _list_sets(lists):
    """Each ray's recorded leaf ids as a sorted row, -1 padded."""
    return torch.sort(lists, dim=1).values


@pytest.mark.parametrize("d_slots", [2, 8])
def test_phase_a_kernel_matches_plain(dev, scenes, d_slots):
    """cnt equal on every ray; where cnt <= D the same set of leaves, in
    another order (near child first against DFS order); -1 after the
    recorded entries; dead rays get cnt 0."""
    from idkengine_tpu_torch.ops import two_phase as tp

    _, sc, _ = scenes
    o, d = _rays(sc, 1 << 15, 4, dev)
    t_max = torch.where(torch.arange(o.shape[0], device=dev) % 7 == 0, -1.0, 3.4e38)
    before = tp.phase_a.launches
    lists, cnt = tp.phase_a(sc, o, d, t_max, d_slots)
    torch.cuda.synchronize()
    assert tp.phase_a.launches == before + 1
    p_lists, p_cnt = tp.phase_a_plain(sc, o, d, t_max, d_slots)
    assert torch.equal(cnt, p_cnt) and (cnt[t_max < 0] == 0).all()
    assert (cnt > d_slots).any()
    n_rec = (lists >= 0).sum(1)
    assert torch.equal(n_rec, torch.clamp(cnt, max=d_slots))
    assert not ((lists[:, 1:] >= 0) & (lists[:, :-1] < 0)).any()
    fine = cnt <= d_slots
    assert torch.equal(_list_sets(lists[fine]), _list_sets(p_lists[fine]))


def tie_case(d_slots, dev, n=256, seed=0):
    """Phase B's inputs on a scene of coincident triangles, with -1 holes
    between list entries: (scene, lists, o, d, t_max). Every coordinate is
    dyadic and every determinant -1/4 or -1, so each rounding form (fused
    or not) gives the same t, u and v. Leaf 1 holds a triangle at z = 3 and
    one at z = 2; leaf 2 two copies of that z = 2 triangle (a tie inside a
    leaf, and with leaf 1: a tie across entries); leaf 3 a smaller one at
    z = 1.5; leaf 4 one at z = 4; node 0 is interior. Rays leave z = 0
    upward with slopes of 0 or +-1/16; lists draw leaves 1-4 and holes at
    random; t_max is 3.4e38, 2 (the z = 2 ties excluded by strict <), 2.5
    or -1 (dead)."""
    from types import SimpleNamespace

    rng = np.random.default_rng(seed)
    p0 = np.array([[0, 0, 3], [0, 0, 2], [0, 0, 2], [0, 0, 2], [0, 0, 1.5], [0, 0, 4]], np.float32)
    size = np.array([1, 1, 1, 1, 0.5, 1], np.float32)[:, None]
    e1 = size * np.array([1, 0, 0], np.float32)
    e2 = size * np.array([0, 1, 0], np.float32)
    tri = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    tri_vec = torch.cat([tri(p0), tri(e1), tri(e2), torch.zeros((6, 3), device=dev)], 1)
    scene = SimpleNamespace(
        node_first=torch.tensor([0, 0, 2, 4, 5], dtype=torch.int32, device=dev),
        node_count=torch.tensor([0, 2, 2, 1, 1], dtype=torch.int32, device=dev),
        tri_p0=tri(p0), tri_e1=tri(e1), tri_e2=tri(e2), tri_vec=tri_vec.contiguous(),
        max_leaf=2, bvh4_leaf_bits=5, device=tri_vec.device)
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rng.integers(1, 8, (n, 2)) / 32.0  # inside every triangle's corner
    d = np.ones((n, 3), np.float32)
    d[:, :2] = rng.integers(-1, 2, (n, 2)) / 16.0
    lists = rng.choice(np.array([-1, 1, 2, 3, 4], np.int32), (n, d_slots),
                       p=[0.4, 0.15, 0.15, 0.15, 0.15])
    t_max = rng.choice(np.array([3.4e38, 2.0, 2.5, -1.0], np.float32), n)
    return scene, torch.from_numpy(lists).to(dev), tri(o), tri(d), tri(t_max)


@pytest.mark.parametrize("d_slots", [4, 8])
def test_phase_b_kernels_match_plain(dev, scenes, d_slots):
    """On phase A's lists, the same lists with -1 holes punched between
    entries, and tie_case's coincident triangles: t, u, v bit-equal and
    slots equal (both take the first of equal minima: the earlier triangle
    of a leaf, the earlier list entry); occlusion equal."""
    from idkengine_tpu_torch.ops import two_phase as tp

    _, sc, _ = scenes
    o, d = _rays(sc, 1 << 15, 5, dev)
    t_max = torch.where(torch.arange(o.shape[0], device=dev) % 5 == 0, -1.0, 3.4e38)
    lists, _ = tp.phase_a(sc, o, d, t_max, d_slots)
    g = torch.Generator(device=dev).manual_seed(d_slots)
    holed = torch.where(torch.rand(lists.shape, generator=g, device=dev) < 0.3, -1, lists)
    ties = tie_case(d_slots, dev)
    assert (ties[1] < 0).any() and (ties[1] >= 0).any()
    for scene, ls, o, d, t_max in ((sc, lists, o, d, t_max), (sc, holed.contiguous(), o, d, t_max),
                                   ties):
        before = tp.phase_b_closest.launches
        got = tp.phase_b_closest(scene, ls, o, d, t_max)
        torch.cuda.synchronize()
        assert tp.phase_b_closest.launches == before + 1
        want = tp.phase_b_closest_plain(scene, ls, o, d, t_max)
        for k in ("t", "slot", "u", "v"):
            assert torch.equal(getattr(got, k), getattr(want, k)), k
        for s_tmax in (t_max, torch.where(t_max > 0, 2.0, -1.0)):
            assert torch.equal(tp.phase_b_any(scene, ls, o, d, s_tmax),
                               tp.phase_b_any_plain(scene, ls, o, d, s_tmax))
    assert (want.slot == 2).any(), "the tie across entries and inside leaf 2 should show"


@pytest.mark.parametrize("d_slots", [1, 3, 32])
@pytest.mark.parametrize("n", [1, 33, 1000])
def test_phase_b_kernel_list_widths(dev, scenes, d_slots, n):
    """D that is not a multiple of 4 (entries read one by one) and one that
    is (four at a time), at ray counts that leave a block part full."""
    from idkengine_tpu_torch.ops import two_phase as tp

    _, sc, _ = scenes
    o, d = _rays(sc, n, 37, dev)
    t_max = torch.where(torch.arange(n, device=dev) % 4 == 0, -1.0, 3.4e38)
    lists, _ = tp.phase_a(sc, o, d, t_max, d_slots)
    got = tp.phase_b_closest(sc, lists, o, d, t_max)
    want = tp.phase_b_closest_plain(sc, lists, o, d, t_max)
    for k in ("t", "slot", "u", "v"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    s_tmax = torch.where(t_max > 0, 4.0, -1.0)
    assert torch.equal(tp.phase_b_any(sc, lists, o, d, s_tmax),
                       tp.phase_b_any_plain(sc, lists, o, d, s_tmax))


def test_two_phase_on_card_matches_one_phase(dev, scenes):
    """The two-phase trace (phase A, phase B, one fallback launch) against
    the one-phase kernel: the rule of the closest-hit kernel test."""
    from idkengine_tpu_torch.ops import two_phase as tp

    _, sc, _ = scenes
    o, d = _rays(sc, 1 << 15, 6, dev)
    t_max = torch.where(torch.arange(o.shape[0], device=dev) % 9 == 0, -1.0, 3.4e38)
    tp.reset_launch_counts()
    kern.reset_launch_counts()
    got = tp.two_phase_closest(sc, o, d, t_max, 4)
    assert (tp.phase_a.launches, tp.phase_b_closest.launches,
            kern.trace_closest.launches) == (1, 1, 1)
    want = kern.trace_closest(sc, o, d, t_max)
    gs, ws = got.slot.cpu().numpy(), want.slot.cpu().numpy()
    np.testing.assert_array_equal(gs >= 0, ws >= 0)
    assert (gs == ws).mean() >= SLOT_AGREE
    np.testing.assert_allclose(got.t.cpu().numpy(), want.t.cpu().numpy(), rtol=1e-6)
    s_tmax = torch.where(t_max > 0, 6.0, -1.0)
    assert torch.equal(tp.two_phase_any(sc, o, d, s_tmax, 4), kern.trace_any(sc, o, d, s_tmax))
    assert tp.phase_b_any.launches == 1 and kern.trace_any.launches == 2


def test_two_phase_refuses_bad_inputs(dev, scenes):
    from idkengine_tpu_torch.ops import two_phase as tp

    _, sc, _ = scenes
    o, d = _rays(sc, 64, 7, dev)
    lists, _ = tp.phase_a(sc, o, d, 3.4e38, 4)
    with pytest.raises(TypeError):
        tp.phase_b_closest(sc, lists.long(), o, d, 3.4e38)
    with pytest.raises(ValueError):
        tp.phase_b_any(sc, lists[:32], o, d, 1.0)
    with pytest.raises(ValueError):
        tp.phase_a(sc, o, d, 1.0, 0)
    before = tp.phase_b_closest.launches, tp.phase_b_any.launches
    empty = torch.full((64, 0), -1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="at least one list entry"):
        tp.phase_b_closest(sc, empty, o, d, 3.4e38)
    with pytest.raises(ValueError, match="at least one list entry"):
        tp.phase_b_any(sc, empty, o, d, 3.4e38)
    assert (tp.phase_b_closest.launches, tp.phase_b_any.launches) == before
    with pytest.raises(ValueError):
        tp.phase_a(sc, o.cpu(), d, 1.0)


def test_fma_on_card_rounds_once(dev):
    """ops/intersect.fma on CUDA tensors is a*b + c rounded once, against
    exact rational arithmetic, on random and cancelling triples (where the
    two roundings differ): the card's plain versions round as the kernels'
    __fmaf_rn."""
    from fractions import Fraction

    from idkengine_tpu_torch.ops.intersect import fma

    rng = np.random.default_rng(36)
    n = 4096
    a = rng.standard_normal(n).astype(np.float32) * np.float32(1e4)
    b = rng.standard_normal(n).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32) * np.float32(1e4)
    c[::2] = -(a[::2] * b[::2])
    c[1::4] = np.nextafter(c[1::4], np.float32(0))
    got = fma(*(torch.from_numpy(x).to(dev) for x in (a, b, c))).cpu().numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        f = np.float32(float(exact))
        near = min((np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))),
                   key=lambda v: (abs(Fraction(float(v)) - exact),
                                  int(np.asarray(v).view(np.int32)) & 1))
        assert g == near, (x, y, z)
    assert not np.array_equal(got, a * b + c)


def _steps_equal(sc, o, d, t_max, max_steps=1 << 30):
    got, steps = kern.trace_closest_steps(sc, o, d, t_max, max_steps=max_steps)
    want, want_steps = plain.trace_closest_steps(sc, o, d, t_max, max_steps=max_steps)
    assert torch.equal(steps, want_steps)
    for k in ("t", "slot", "u", "v"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    return steps


@pytest.mark.parametrize("cap", [0, 1, 7, 64, 320])
@pytest.mark.parametrize("kind", ["incoherent", "dead_and_zero", "inside_leaves", "from_1e8"])
def test_capped_steps_kernel_matches_plain(dev, scenes, kind, cap):
    """trace_closest_steps with max_steps: steps, t, slot, u and v equal
    to the plain walk's with the same cap on every ray, none above it."""
    _, sc, _ = scenes
    steps = _steps_equal(sc, *_rays_of(kind, sc, 1 << 16, 34, dev), max_steps=cap)
    assert int(steps.max()) <= cap
    with pytest.raises(ValueError):
        kern.trace_closest_steps(sc, *_rays_of(kind, sc, 8, 34, dev), max_steps=-1)


def test_device_flatten_on_card_matches_host(dev, scenes):
    """flatten_triangles_device on the card: every field bit-equal to the
    host flatten (the cross product's fused products and the norm's
    correctly rounded root as on the CPU, no contracted multiply-add), and
    the card's build holds its tables."""
    from idkengine_tpu_torch.bvh.flatten import flatten_triangles, flatten_triangles_device

    db, sc, _ = scenes
    args = (db._slot_tri, db._verts, db._indices, db._normals, db._uvs, db._tri_mat)
    host = flatten_triangles(*args)
    got = flatten_triangles_device(*args, device=dev)
    for f, k in (("p0", "tri_p0"), ("e1", "tri_e1"), ("e2", "tri_e2"), ("n_packed", "tri_n"),
                 ("uv", "tri_uv"), ("mat", "tri_mat"), ("geom_normal", "tri_gn")):
        want = torch.from_numpy(np.asarray(getattr(host, f)).astype(
            np.int64 if f == "n_packed" else getattr(host, f).dtype))
        assert getattr(got, f).device.type == "cuda"
        assert torch.equal(getattr(got, f).cpu(), want), f
        assert torch.equal(getattr(sc, k).cpu(), want.to(getattr(sc, k).dtype)), k


def test_call_site_buckets_on_card(dev, scenes):
    """Each tagged launch's hand kernel lands in its call site's bucket in
    torch.profiler's trace of the card; an untagged any-hit launch in
    trace_other."""
    from idkengine_tpu_torch import profiling
    from idkengine_tpu_torch.ops import two_phase

    _, sc, _ = scenes
    o, d, t_max = _rays_of("incoherent", sc, 1 << 16, 35, dev)
    cases = {"primary": lambda: kern.trace_closest(sc, o, d, t_max, tag="pri"),
             "bounce_closest": lambda: two_phase.two_phase_closest(sc, o, d, t_max, tag="bnc"),
             "nee": lambda: kern.trace_any(sc, o, d, t_max, max_steps=64, tag="enva"),
             "trace_other": lambda: kern.trace_any(sc, o, d, t_max)}
    for bucket, fn in cases.items():
        fn()
        kernels = profiling.profile_kernels(fn)
        hand = [(n, s, ms) for n, s, ms in kernels
                if any(k in n for k in profiling.HAND_TRACE_KERNELS)]
        assert hand, bucket
        by = profiling.bucket_times(hand, ndigits=None)
        assert set(by) == {bucket, "total_device"}, (bucket, by)


@pytest.mark.parametrize("kind", ["incoherent", "dead_and_zero", "inside_leaves", "from_1e8"])
def test_steps_kernel_on_ray_kinds(dev, scenes, kind):
    """The threaded-record steps kernel against the plain stackless walk:
    steps, t, slot, u and v equal on every ray; a dead ray takes one step."""
    _, sc, _ = scenes
    o, d, t_max = _rays_of(kind, sc, 1 << 16, 31, dev)
    d[::97] = 0.0  # zero directions among them
    steps = _steps_equal(sc, o, d, t_max)
    assert (steps[t_max < 0] == 1).all()


@pytest.mark.parametrize("n", [1, 5, 31, 33, 4097, 1 << 20])
def test_steps_kernel_batch_sizes(dev, scenes, n):
    _, sc, _ = scenes
    _steps_equal(sc, *_rays_of("dead_and_zero", sc, n, 32, dev))


def test_steps_kernel_long_rays_among_short(dev, scenes):
    """Every other ray dead, and a few long rays (from inside leaves,
    across the scene) among short ones: steps, t, slot, u and v equal on
    every ray."""
    _, sc, _ = scenes
    o, d, t_max = _rays_of("inside_leaves", sc, 1 << 16, 33, dev)
    short = torch.arange(o.shape[0], device=dev) % 29 != 0
    t_max[short] = torch.where(short[short].cumsum(0) % 2 == 0, -1.0, 0.0)
    _steps_equal(sc, o, d, t_max)


def _phase_a_equal(sc, o, d, t_max, d_slots):
    """cnt equal on every ray, -1 after min(cnt, D) entries, the same sets
    where cnt <= D; on overflow every recorded id lies in the ray's full
    plain list. Returns cnt."""
    from idkengine_tpu_torch.ops import two_phase as tp

    lists, cnt = tp.phase_a(sc, o, d, t_max, d_slots)
    p_lists, p_cnt = tp.phase_a_plain(sc, o, d, t_max, d_slots)
    assert torch.equal(cnt, p_cnt)
    assert torch.equal((lists >= 0).sum(1), torch.clamp(cnt, max=d_slots))
    assert not ((lists[:, 1:] >= 0) & (lists[:, :-1] < 0)).any()
    fine = cnt <= d_slots
    assert torch.equal(_list_sets(lists[fine]), _list_sets(p_lists[fine]))
    over = torch.nonzero(~fine)[:, 0][:512]
    if over.numel():
        full, _ = tp.phase_a_plain(sc, o[over], d[over], t_max[over], int(cnt[over].max()))
        for got, want in zip(lists[over].tolist(), full.tolist()):
            assert set(got) <= set(want)
    return cnt


@pytest.mark.parametrize("kind", ["incoherent", "dead_and_zero", "inside_leaves", "from_1e8"])
def test_phase_a_kernel_on_ray_kinds(dev, scenes, kind):
    """The wide phase A against the plain binary DFS (see _phase_a_equal);
    dead rays get cnt 0."""
    _, sc, _ = scenes
    o, d, t_max = _rays_of(kind, sc, 1 << 16, 33, dev)
    d[::97] = 0.0
    cnt = _phase_a_equal(sc, o, d, t_max, 8)
    assert (cnt[t_max < 0] == 0).all()


@pytest.mark.parametrize("n", [1, 5, 33, 1 << 20])
def test_phase_a_kernel_batch_sizes(dev, scenes, n):
    _, sc, _ = scenes
    _phase_a_equal(sc, *_rays_of("dead_and_zero", sc, n, 34, dev), 8)


def test_large_leaves_on_card(dev):
    """A build with leaves above 32 triangles (6 count bits): the trace
    kernel, the steps kernel and phase A against their plain versions."""
    from idkengine_tpu_torch.ops import two_phase as tp

    db = SceneDatabase(BuildSettings(max_leaf_triangle_count=64, traversal_cost=40.0))
    db.add_model(atrium(20_000))
    sc = db.build(dev)
    assert int(sc.node_count.max()) > 32 and sc.bvh4_leaf_bits >= 6
    o, d, t_max = _rays_of("dead_and_zero", sc, 1 << 15, 35, dev)
    got = kern.trace_closest(sc, o, d, t_max)
    want = plain.trace_closest(sc, o, d, t_max)
    assert torch.equal(got.slot >= 0, want.slot >= 0)
    same = got.slot == want.slot
    assert same.float().mean().item() >= SLOT_AGREE
    assert torch.equal(got.t[same], want.t[same])
    assert torch.equal(kern.trace_any(sc, o, d, t_max), plain.trace_any(sc, o, d, t_max))
    _steps_equal(sc, o, d, t_max)
    _phase_a_equal(sc, o, d, t_max, 8)
    lists, _ = tp.phase_a(sc, o, d, t_max, 8)
    hb = tp.phase_b_closest(sc, lists, o, d, t_max)
    want_b = tp.phase_b_closest_plain(sc, lists, o, d, t_max)
    for k in ("t", "slot", "u", "v"):
        assert torch.equal(getattr(hb, k), getattr(want_b, k)), k


def test_steps_kernel_matches_plain(dev, scenes):
    """Both walk the threaded tree one node per step in the same order:
    steps, slots, t, u and v equal on every ray."""
    _, sc, _ = scenes
    o, d = _rays(sc, 1 << 15, 8, dev)
    t_max = torch.where(torch.arange(o.shape[0], device=dev) % 7 == 0, -1.0, 3.4e38)
    before = kern.trace_closest_steps.launches
    got, steps = kern.trace_closest_steps(sc, o, d, t_max)
    torch.cuda.synchronize()
    assert kern.trace_closest_steps.launches == before + 1
    want, want_steps = plain.trace_closest_steps(sc, o, d, t_max)
    assert torch.equal(steps, want_steps)
    for k in ("t", "slot", "u", "v"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k


def test_two_phase_pipeline_on_card_matches_cpu(dev):
    """PathTracerPipeline with use_two_phase, denoising from the second
    frame: the card's frames go through phase A, phase B and the fallback."""
    from idkengine_tpu_torch.ops import two_phase as tp
    from idkengine_tpu_torch.render import PathTracerPipeline, PtPipelineSettings

    cam = Camera(position=np.array([0.0, 3.0, 24.0], np.float32), yaw=-90.0, fov_y=65.0)
    settings = PathTracerSettings(ray_depth=2, russian_roulette=False, do_ray_sorting=True,
                                  use_two_phase=True)
    imgs = []
    for device in (dev, "cpu"):
        db = SceneDatabase(BuildSettings(**BUILD))
        db.add_model(atrium(8000))
        db.build(device)
        db.lights.add([0.0, 10.5, 0.0], [40.0, 38.0, 35.0], radius=0.8)
        db.lights.add([6.0, 4.0, -20.0], [20.0, 10.0, 5.0], radius=0.5)
        pipe = PathTracerPipeline(db, 64, 48, settings, PtPipelineSettings(denoise_at_samples=2),
                                  device=device)
        tp.reset_launch_counts()
        for _ in range(3):
            img = pipe.render_frame(cam)
        imgs.append(img.cpu().numpy())
        if device == dev:
            assert tp.phase_a.launches == 12 and tp.phase_b_closest.launches == 6
    assert np.isfinite(imgs[0]).all() and imgs[0].std() > 0.01
    assert float(np.sqrt(np.mean((imgs[0] - imgs[1]) ** 2))) <= 1e-3



def test_textured_alpha_env_render_on_card_matches_cpu(dev):
    """The material and environment model on the card: a textured atrium
    (textures, alpha-tested and blended cloth, a normal map, per-mesh
    overrides) under an atmospheric env map with env NEE, 64x64 at depth 2,
    rays sorted; its alpha re-traces and shadow rays go through the trace
    kernel."""
    from idkengine_tpu_torch.render.sky import compute_atmosphere
    from idkengine_tpu_torch.scene.procedural import texture_atrium

    cam = Camera(position=np.array([0.0, 3.0, 24.0], np.float32), yaw=-90.0, fov_y=65.0)
    env = compute_atmosphere(64, 32, device="cpu")
    env[6:8, 20:22] = 60.0  # a small sun
    settings = PathTracerSettings(ray_depth=2, russian_roulette=False, do_ray_sorting=True,
                                  use_env_map=True, env_nee=True)
    imgs = []
    for device in (dev, "cpu"):
        model = atrium(8000)
        shading = texture_atrium(model, seed=0)
        db = SceneDatabase(BuildSettings(**BUILD))
        db.add_model(model)
        scene = db.build(device)
        db.lights.add([0.0, 10.5, 0.0], [40.0, 38.0, 35.0], radius=0.8)
        for k, kw in shading.items():
            db.set_mesh_shading(k, **kw)
        pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), 64, 64, settings,
                        env_map=env, slot_shading=db.slot_shading(), device=device)
        kern.reset_launch_counts()
        imgs.append(pt.render_frame(cam).cpu().numpy())
        if device == dev:
            assert pt._has_alpha and pt._has_textures and pt._has_normal_maps
            # per bounce: a closest trace and its two alpha re-traces; two
            # rounds of closest traces and an any-hit tail for the NEE and
            # the env-NEE shadow rays each
            assert kern.trace_closest.launches == 2 * (3 + 2 + 2)
            assert kern.trace_any.launches == 2 * 2
    assert np.isfinite(imgs[0]).all() and imgs[0].std() > 0.01
    assert float(np.sqrt(np.mean((imgs[0] - imgs[1]) ** 2))) <= 1e-3

# The probes (idkengine_tpu_torch/tools/, the TPU microbenchmarks P1-P6):
# each kernel performs its plain version's operations in the same order
# (float sums in the order of `_probe.cta_sum`), so outputs and chain state
# are equal; bench_mxu_leaf's kernels keep the plain versions' slots on
# 99.9% of the rays (the rest are ties) and t within `T_TOL` where the slots
# agree (mxu_form's FFMA rounds once where the plain version rounds twice).
PROBE_STEPS = 100  # more than 64, so every mask plane of the slab probe is written
REDUCE_STEPS = (1, 2, 3, 4, 5, PROBE_STEPS, 256)  # 256: chip_smoke.py's PROBE_CHECK_ITERS
LAUNCH_TIMEOUT_S = 300  # P3's, P4's and P5/P6's launches, the nvcc builds, the process's start
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probe_equal(got, want):
    assert torch.equal(got.out, want.out)
    for k in want.chain:
        assert torch.equal(got.chain[k], want.chain[k]), k
    assert got.cycles.item() > 0


def test_reduce_probe_matches_plain(dev):
    """Every mode at 1-5 steps (each parity of the step buffer, first and
    second use), PROBE_STEPS and chip_smoke.py's 256."""
    from idkengine_tpu_torch.tools import bench_reduce as br

    x = br.make_inputs(dev, seed=11)
    for steps in REDUCE_STEPS:
        for mode in br.MODES:
            before = br.reduce_loop.launches
            got = br.reduce_loop(x, mode, steps)
            torch.cuda.synchronize()
            assert br.reduce_loop.launches == before + 1
            _probe_equal(got, br.reduce_loop_plain(x, mode, steps))


def test_dual_probe_matches_plain(dev):
    """Every kind at 1-5 steps (the deferred forms' barrier parities and
    slot ring before and after it wraps), PROBE_STEPS and 256."""
    from idkengine_tpu_torch.tools import bench_dual as bd

    x = bd.make_inputs(dev, seed=12)
    for steps in REDUCE_STEPS:
        for kind in bd.KINDS:
            _probe_equal(bd.dual_loop(x, kind, steps), bd.dual_loop_plain(x, kind, steps))


def test_reduce_and_dual_launches_return(dev):
    """Every mode of P3 and kind of P4 (the kernels with barrier phases of
    their own) at 1-5, 33, 100 steps and the tools' sizes returns within
    LAUNCH_TIMEOUT_S in a process of its own (the libraries' builds
    included): a barrier phase that never completes fails this test, and
    the process is killed, instead of hanging the session."""
    code = (
        "import torch\n"
        "from idkengine_tpu_torch.tools import bench_dual as bd, bench_reduce as br\n"
        "x, y = br.make_inputs('cuda'), bd.make_inputs('cuda')\n"
        "for n in (1, 2, 3, 4, 5, 33, 100, br.ITERS):\n"
        "    for m in br.MODES: br.reduce_loop(x, m, n)\n"
        "for n in (1, 2, 3, 4, 5, 33, 100, bd.ITERS):\n"
        "    for k in bd.KINDS: bd.dual_loop(y, k, n)\n"
        "torch.cuda.synchronize()\n"
        "print('returned')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT_S)
    assert proc.returncode == 0 and proc.stdout.strip() == "returned", proc.stderr


# 16: the tool's K, unrolled in the kernel; 1, 4, 37, 128: the general path
# (a tail of k % 4 after the 16-byte loads; b's row load spans 2 and 4
# warp-wide chunks at 37 and 128)
@pytest.mark.parametrize("k", [1, 4, 16, 37, 128])
def test_prims_probe_matches_plain(dev, k):
    """Every body at 1-5, PROBE_STEPS and 256 steps, in a process of its
    own that must return within LAUNCH_TIMEOUT_S (the library's build
    included): a barrier or warp vote that some threads skip fails this
    test, and the process is killed, instead of hanging the session."""
    code = (
        "import torch\n"
        "from idkengine_tpu_torch.tools import bench_prims as bp\n"
        f"k, steps_all = {k}, {REDUCE_STEPS}\n"
        "tab, x = bp.make_inputs('cuda', seed=13)\n"
        "for steps in steps_all:\n"
        "    for body in bp.BODIES:\n"
        "        got = (bp.prims_extra_loop(tab, x, k, steps) if body == bp.EXTRA\n"
        "               else bp.prims_loop(tab, x, body, k, steps))\n"
        "        torch.cuda.synchronize()\n"
        "        want = bp.prims_loop_plain(tab, x, body, k, steps)\n"
        "        assert torch.equal(got.out, want.out), (body, steps)\n"
        "        for c in want.chain:\n"
        "            assert torch.equal(got.chain[c], want.chain[c]), (body, steps, c)\n"
        "        assert got.cycles.item() > 0\n"
        "print('equal')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT_S)
    assert proc.returncode == 0 and proc.stdout.strip() == "equal", proc.stderr


@pytest.mark.parametrize("rows", [1, 8, 32])
def test_slab_probe_matches_plain(dev, rows):
    from idkengine_tpu_torch.tools import bench_slab as bs

    args = bs.make_inputs(dev, rows, seed=14)
    for mode in bs.MODES:
        for reduce in bs.REDUCES:
            _probe_equal(bs.slab_loop(*args, mode, reduce, PROBE_STEPS),
                         bs.slab_loop_plain(*args, mode, reduce, PROBE_STEPS))


def test_mxu_leaf_probe_matches_plain(dev):
    """Leaf and feature tables larger than one staged chunk (20 visits of
    20 triangles: two leaf rows a visit)."""
    from idkengine_tpu_torch.tools import bench_mxu_leaf as bm

    for kind, v in bm.variants(dev, 1024, 20, 20).items():
        got, want = v.kernel(), v.plain()
        same = got.chain["slot"] == want.chain["slot"]
        assert same.float().mean().item() >= SLOT_AGREE, kind
        torch.testing.assert_close(got.chain["t"][same], want.chain["t"][same], **bm.T_TOL[kind])
        assert (got.chain["slot"] >= 0).float().mean().item() > 0.05, kind


def test_probes_refuse_bad_inputs(dev):
    from idkengine_tpu_torch.tools import bench_reduce as br
    from idkengine_tpu_torch.tools import bench_slab as bs

    x = br.make_inputs(dev)
    with pytest.raises(TypeError):
        br.reduce_loop(x.double(), "sum4")
    with pytest.raises(ValueError):
        br.reduce_loop(x[:4], "sum4")
    with pytest.raises(ValueError):
        br.reduce_loop(torch.empty((128, 8), device=dev).t(), "sum4")
    args = bs.make_inputs(dev, 8)
    with pytest.raises(ValueError):
        bs.slab_loop(args[0].cpu(), *args[1:], "f32", "sum4")
    # a launch the library refuses (an unknown mode) raises
    out = torch.empty((8, 128), dtype=torch.int32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    with pytest.raises(RuntimeError):
        br._LIB("idk_bench_reduce", [x, out, torch.empty_like(x), cycles], [7, 10])


def _card_scene():
    """The scenes fixture's atrium, on the card."""
    db = SceneDatabase(BuildSettings(**BUILD))
    db.add_model(atrium(20_000))
    return db.build("cuda")


def _capped_equal(sc, o, d, t_max, cap):
    """The capped walks (trace_capped_kernel) against the plain stackless
    walk with the same cap: t, slot, u, v and occlusion equal on every ray
    (both visit the same nodes in the same order, with the same
    arithmetic); each call counts one capped launch and no trace_kernel
    launch."""
    kern.reset_launch_counts()
    got = kern.trace_closest(sc, o, d, t_max, max_steps=cap)
    occ = kern.trace_any(sc, o, d, t_max, max_steps=cap)
    torch.cuda.synchronize()
    assert (kern._closest_capped.launches, kern._any_capped.launches) == (1, 1)
    assert kern.trace_closest.launches == kern.trace_any.launches == 0
    want = plain.trace_closest(sc, o, d, t_max, max_steps=cap)
    for k in ("t", "slot", "u", "v"):
        assert torch.equal(getattr(got, k), getattr(want, k)), (k, cap)
    assert torch.equal(occ, plain.trace_any(sc, o, d, t_max, max_steps=cap)), cap


def _on_card_alone(body):
    """Runs `body` in a process of its own that must return within
    LAUNCH_TIMEOUT_S (the library's build included): a launch that never
    returns fails the test, and the process is killed, instead of hanging
    the session. `body` sees this module as `t`, `torch`, and the
    card's atrium as `sc`."""
    code = ("import sys, torch\n"
            f"sys.path.insert(0, {os.path.join(REPO, 'tests')!r})\n"
            "import test_torch_cuda as t\n"
            "sc = t._card_scene()\n"
            f"{body}\n"
            "print('equal')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT_S)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("equal"), proc.stderr


@pytest.mark.parametrize("cap", [0, 1, 7, 64, 1 << 30])
@pytest.mark.parametrize("kind", ["incoherent", "dead_and_zero", "inside_leaves", "from_1e8"])
def test_capped_kernels_match_plain(dev, kind, cap):
    """_capped_equal on each kind of ray at each cap."""
    _on_card_alone(f"t._capped_equal(sc, *t._rays_of({kind!r}, sc, 1 << 16, 41, 'cuda'), {cap})")


@pytest.mark.parametrize("n", [1, 5, 31, 33, 4097, 1 << 20])
def test_capped_kernels_batch_sizes(dev, n):
    """Batches that end inside a warp, fill one, and span many blocks, at
    caps 0, 1, 7, 48, 64 and 2^30."""
    _on_card_alone(f"rays = t._rays_of('dead_and_zero', sc, {n}, 42, 'cuda')\n"
                   "for cap in (0, 1, 7, 48, 64, 1 << 30):\n"
                   "    t._capped_equal(sc, *rays, cap)")


def test_capped_kernels_every_other_ray_dead(dev):
    """Every other ray dead (t_max < 0: one step at the root) among live
    ones, at every cap."""
    _on_card_alone("o, d, t_max = t._rays_of('incoherent', sc, 4097, 44, 'cuda')\n"
                   "t_max[::2] = -1.0\n"
                   "for cap in (0, 1, 7, 64, 1 << 30):\n"
                   "    t._capped_equal(sc, o, d, t_max, cap)")


def test_capped_kernels_long_rays_among_short(dev):
    """A few long rays (from inside leaves, across the whole scene) among
    short ones (dead, or t_max 0): most lanes of a warp stop early while one
    walks on."""
    _on_card_alone("o, d, t_max = t._rays_of('inside_leaves', sc, 1 << 16, 45, 'cuda')\n"
                   "short = torch.arange(o.shape[0], device='cuda') % 29 != 0\n"
                   "t_max[short] = torch.where(short[short].cumsum(0) % 2 == 0, -1.0, 0.0)\n"
                   "for cap in (64, 1 << 30):\n"
                   "    t._capped_equal(sc, o, d, t_max, cap)")


def test_capped_kernels_refuse_bad_inputs(dev, scenes):
    _, sc, _ = scenes
    o, d, t_max = _rays_of("incoherent", sc, 64, 43, dev)
    with pytest.raises(ValueError):
        kern.trace_closest(sc, o, d, t_max, max_steps=-1)
    with pytest.raises(ValueError):
        kern.trace_any(sc, o.cpu(), d, t_max, max_steps=8)


def _small_deferred(device, settings, frames=2, scene="atrium"):
    """Two frames of a 64x48 deferred render on `device`: the small atrium,
    or the Cornell box with glossy walls, a transmissive and a blended box."""
    from idkengine_tpu_torch.render import DeferredPipeline
    from idkengine_tpu_torch.scene.model import Material
    from idkengine_tpu_torch.scene.procedural import cornell_box

    if scene == "atrium":
        db = SceneDatabase(BuildSettings(**BUILD))
        db.add_model(atrium(8000))
        lights = [([0.0, 10.5, 0.0], [40.0, 38.0, 35.0], 0.8),
                  ([6.0, 4.0, -20.0], [20.0, 10.0, 5.0], 0.5)]
        cam = dict(position=np.array([0.0, 3.0, 24.0], np.float32), yaw=-90.0, fov_y=65.0)
    else:
        m = cornell_box(emissive_quad=False)
        m.materials[0].roughness = 0.3
        m.materials += [Material(name="glass", base_color=np.float32([0.9, 0.95, 1.0, 1.0]),
                                 transmission=0.6, roughness=0.1),
                        Material(name="veil", base_color=np.float32([0.2, 0.3, 0.8, 0.5]),
                                 alpha_cutoff=0.0)]
        m.primitives[-1].material, m.primitives[-2].material = 4, 5
        db = SceneDatabase()
        db.add_model(m)
        lights = [([278, 480, 279.5], [6, 6, 6], 45.0), ([120, 300, 150], [3, 2, 1], 20.0)]
        cam = dict(position=np.array([278, 273, -800], np.float32), yaw=90.0, fov_y=38.0)
    db.build(device)
    for pos, rad, r in lights:
        db.lights.add(pos, rad, radius=r)
    pipe = DeferredPipeline(db, 64, 48, settings, device=device)
    for _ in range(frames):
        img = pipe.render_frame(Camera(**cam))
    return img.cpu().numpy(), pipe


@pytest.mark.parametrize("toggle", ["ssr", "volumetric", "oit", "classifier", "pcf",
                                    "render_scale"])
def test_deferred_toggle_on_card_matches_cpu(dev, toggle):
    """Each optional pass's small render on the card against the CPU's
    (RMSE <= 1e-3): the card's frame goes through the trace kernels."""
    from idkengine_tpu_torch.render import DeferredSettings2

    kw = {"ssr": dict(use_ssr=True), "volumetric": dict(use_volumetric=True),
          "oit": dict(use_oit=True), "classifier": dict(use_classifier=True),
          "pcf": dict(shadows="pcf", shadow_map_res=64),
          "render_scale": dict(render_scale=2)}[toggle]
    scene = "box" if toggle in ("ssr", "oit") else "atrium"
    kern.reset_launch_counts()
    card, pipe = _small_deferred(dev, DeferredSettings2(**kw), scene=scene)
    assert kern.trace_closest.launches > 0
    cpu, cpu_pipe = _small_deferred("cpu", DeferredSettings2(**kw), scene=scene)
    assert np.isfinite(card).all() and card.std() > 0.01
    assert float(np.sqrt(np.mean((card - cpu) ** 2))) <= 1e-3
    if toggle == "classifier":
        np.testing.assert_allclose(pipe.rate_map.cpu().numpy(), cpu_pipe.rate_map.numpy(),
                                   rtol=1e-4)


def test_capped_and_tiled_pathtracer_on_card_matches_cpu(dev):
    """A capped, tiled frame of the small atrium on the card against the
    CPU's (RMSE <= 1e-3); the card's frame launches the capped kernels."""
    cam = Camera(position=np.array([0.0, 3.0, 24.0], np.float32), yaw=-90.0, fov_y=65.0)
    imgs = []
    for device in (dev, "cpu"):
        db = SceneDatabase(BuildSettings(**BUILD))
        db.add_model(atrium(8000))
        scene = db.build(device)
        db.lights.add([0.0, 10.5, 0.0], [40.0, 38.0, 35.0], radius=0.8)
        pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), 96, 54, PathTracerSettings(
            ray_depth=2, russian_roulette=False, do_ray_sorting=True, max_trace_steps=64,
            tile_size=96 * 54 // 4), device=device)
        kern.reset_launch_counts()
        imgs.append(pt.render_frame(cam).cpu().numpy())
        if device == dev:
            assert kern._closest_capped.launches == 8  # four tiles a bounce
            assert kern._any_capped.launches > 0 and kern.trace_closest.launches == 0
    assert float(np.sqrt(np.mean((imgs[0] - imgs[1]) ** 2))) <= 1e-3


def test_device_refit_on_card_matches_cpu(dev):
    """The refit (render/dynamic.py) of one build of the scenes fixture's
    atrium under a seeded displacement, on the card and on the CPU: every
    box and record word, tri_vec and the triangles bit for bit; the trace
    kernel on the refitted records against the plain trace. (One build
    for both: a threaded build may lay the slots out in another order.)"""
    from dataclasses import fields, replace

    from idkengine_tpu_torch.render.dynamic import DeviceRefitter, build_refit_plan

    db = SceneDatabase(BuildSettings(**BUILD))
    db.add_model(atrium(20_000))
    cpu = db.build("cpu")
    card = replace(cpu, **{f.name: getattr(cpu, f.name).to(dev) for f in fields(cpu)
                           if isinstance(getattr(cpu, f.name), torch.Tensor)})
    rng = np.random.default_rng(3)
    verts = db._verts + rng.normal(0, 0.05, db._verts.shape).astype(np.float32)
    plan = build_refit_plan(db._flat, db._slot_tri, db._indices, cpu.max_leaf)
    got, want = (DeviceRefitter(plan, sc).refit(sc, torch.from_numpy(verts).to(sc.device),
                                                torch.from_numpy(db._normals).to(sc.device))
                 for sc in (card, cpu))
    for k in ("node_min", "node_max", "bvh_nodes", "bvh_thread", "bvh4_nodes", "tri_vec",
              "tri_p0", "tri_e1", "tri_e2"):
        assert torch.equal(getattr(got, k).cpu(), getattr(want, k)), k
    o, d = _rays(got, 1 << 16, 5, dev)
    t_max = torch.full((o.shape[0],), 3.4e38, device=dev)
    hit, ref = kern.trace_closest(got, o, d, t_max), plain.trace_closest(got, o, d, t_max)
    same = hit.slot == ref.slot
    assert torch.equal(hit.slot >= 0, ref.slot >= 0) and same.float().mean() >= SLOT_AGREE
    for k in ("t", "u", "v"):
        assert torch.equal(getattr(hit, k)[same], getattr(ref, k)[same]), k
    assert torch.equal(kern.trace_any(got, o, d, 5.0), plain.trace_any(got, o, d, 5.0))


def _instanced_db(device):
    """tests/test_instancing.py's scene: the Cornell box and two instances
    of a sphere with a BLAS of its own."""
    from idkengine_tpu_torch.scene.model import Material, MeshPrimitive, Model, Node
    from idkengine_tpu_torch.scene.procedural import cornell_box, make_uv_sphere

    pos, idx = make_uv_sphere([0.0, 0.0, 0.0], 50.0, n_lat=12, n_lon=16)
    prim = MeshPrimitive(positions=pos.astype(np.float32), indices=idx.astype(np.uint32))
    prim.ensure_normals()
    sphere = Model(primitives=[prim], nodes=[Node(mesh_primitives=[0])], root_nodes=[0],
                   materials=[Material(base_color=np.array([0.9, 0.2, 0.2, 1], np.float32))])
    mats = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    mats[1, :3, :3] *= 1.5
    mats[:, :3, 3] = [[150, 380, 250], [400, 380, 250]]
    db = SceneDatabase(BuildSettings(max_leaf_triangle_count=12, traversal_cost=4.0))
    db.add_model(cornell_box(emissive_quad=False))
    db.add_instanced_model(sphere, mats)
    db.build(device)
    db.lights.add([278, 480, 279.5], [6, 6, 6], radius=45.0)
    return db


def _instanced_cam():
    return Camera(position=np.array([278, 273, -800], np.float32), yaw=90.0, fov_y=38.0)


@pytest.mark.parametrize("max_steps", [None, 64])
def test_two_level_on_card_matches_plain(dev, max_steps):
    """The two-level traces through the fused kernel (one launch a call)
    against the plain two-level traces on the same card tensors: occlusion
    equal on every ray; closest hits, through the capped kernel (which
    walks the plain order), t, slot, u, v and the instance id equal on
    every ray, and through the trace kernel as test_closest_kernel_matches_plain
    holds it (slot and instance equal on SLOT_AGREE of the rays, t, u, v
    bit-equal there, the same hit mask)."""
    from idkengine_tpu_torch.render.camera import generate_rays

    db = _instanced_db(dev)
    iset = db.instance_set()
    o, d = generate_rays(_instanced_cam().ray_params(128, 128), 128, 128,
                         torch.zeros(2, device=dev))
    o, d = o.contiguous(), d.contiguous()
    t_max = torch.where(torch.arange(o.shape[0], device=dev) % 9 == 0, -1.0, 3.4e38)
    args = (db.device_scene, iset.scenes, iset.inv, iset.boxes, o, d, t_max)
    kern.reset_launch_counts()
    hit, inst = kern.trace_closest_two_level(*args, slot_off=iset.slot_off, max_steps=max_steps)
    occ = kern.trace_any_two_level(*args, max_steps=max_steps)
    torch.cuda.synchronize()
    assert kern.trace_closest_two_level.launches == kern.trace_any_two_level.launches == 1
    want, want_inst = plain.trace_closest_two_level(*args, slot_off=iset.slot_off,
                                                    max_steps=max_steps)
    same = (hit.slot == want.slot) & (inst == want_inst)
    for k in ("t", "u", "v"):
        assert torch.equal(getattr(hit, k)[same], getattr(want, k)[same]), k
    assert torch.equal(hit.slot >= 0, want.slot >= 0) and (inst >= 0).any()
    assert bool(same.all()) if max_steps is not None else same.float().mean() >= SLOT_AGREE
    assert torch.equal(occ, plain.trace_any_two_level(*args, max_steps=max_steps))


def test_instanced_pathtracer_on_card_matches_cpu(dev):
    """PathTracer(instances=...) at 48x48 on the card against the CPU
    (RMSE <= 1e-3); the card's frame launches the two-level kernel once a
    trace call (two closest and two any-hit calls a depth-2 frame)."""
    imgs = []
    for device in (dev, "cpu"):
        db = _instanced_db(device)
        pt = PathTracer(db.device_scene, db.materials.soa(), db.lights.soa(), 48, 48,
                        PathTracerSettings(ray_depth=2, sky_strength=0.0),
                        instances=db.instance_set(), inst_attr_srcs=db._inst_attr_srcs,
                        device=device)
        kern.reset_launch_counts()
        imgs.append(pt.render_frame(_instanced_cam()).cpu().numpy())
        if device == dev:
            assert kern.trace_closest_two_level.launches == 2
            assert kern.trace_any_two_level.launches == 2
    assert np.isfinite(imgs[0]).all() and imgs[0].std() > 0
    assert float(np.sqrt(np.mean((imgs[0] - imgs[1]) ** 2))) <= 1e-3


def _placements(rng, count):
    """`count` seeded 4x4 transforms inside the atrium: a random turn,
    scales 1-3, places within its box."""
    mats = np.tile(np.eye(4, dtype=np.float32), (count, 1, 1))
    for m in mats:
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        m[:3, :3] = q * rng.uniform(1.0, 3.0)
        m[:3, 3] = rng.uniform([-10.0, 1.0, -25.0], [10.0, 11.0, 25.0])
    return mats


def _mesh(pos, idx):
    from idkengine_tpu_torch.scene.model import Material, MeshPrimitive, Model, Node

    prim = MeshPrimitive(positions=pos.astype(np.float32), indices=idx.astype(np.uint32))
    prim.ensure_normals()
    return Model(primitives=[prim], nodes=[Node(mesh_primitives=[0])], root_nodes=[0],
                 materials=[Material(name="inst")])


def _two_level_db(blas):
    """The atrium with 16 instances at seeded places: "shared", one 12x16
    sphere (one BLAS); "distinct", built with leaves above 32 triangles, 5
    quads (5 count bits), 6 spheres of 6x8 and 5 of 12x16 (6 count bits)."""
    from idkengine_tpu_torch.scene.procedural import make_uv_sphere

    rng = np.random.default_rng(17)
    sphere = _mesh(*make_uv_sphere([0.0, 0.0, 0.0], 1.0, n_lat=12, n_lon=16))
    if blas == "shared":
        db = SceneDatabase(BuildSettings(**BUILD))
        db.add_model(atrium(20_000))
        db.add_instanced_model(sphere, _placements(rng, 16))
    else:
        db = SceneDatabase(BuildSettings(max_leaf_triangle_count=40, traversal_cost=40.0,
                                         presplit_factor=0.0))
        db.add_model(atrium(20_000))
        quad = _mesh(np.float32([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]]),
                     np.uint32([[0, 1, 2], [0, 2, 3]]))
        db.add_instanced_model(quad, _placements(rng, 5))
        db.add_instanced_model(_mesh(*make_uv_sphere([0.0, 0.0, 0.0], 1.0, n_lat=6, n_lon=8)),
                               _placements(rng, 6))
        db.add_instanced_model(sphere, _placements(rng, 5))
    db.build("cuda")
    return db


def _two_level_rays(sc, n, seed):
    """_rays_of's dead_and_zero rays with every fourth from 1e8 units away."""
    o, d, t_max = _rays_of("dead_and_zero", sc, n, seed, "cuda")
    far = torch.arange(n, device="cuda") % 4 == 3
    return (torch.where(far[:, None], o - d * 1e8, o).contiguous(), d,
            torch.where(far, 2e8, t_max).contiguous())


def _fused_equal(static, parts, o, d, t_max, cap) -> int:
    """The fused two-level kernel (one launch a call) against the launch
    loop (ops/trace.py:two_level_closest / two_level_any over the one-level
    kernels, the same walks one BLAS a launch): t, slot, u, v and the
    instance id equal on every ray, occlusion too. Returns the rays on an
    instance."""
    scenes, inv, boxes, slot_off = parts
    kern.reset_launch_counts()
    hit, inst = kern.trace_closest_two_level(static, scenes, inv, boxes, o, d, t_max,
                                             slot_off=slot_off, max_steps=cap)
    occ = kern.trace_any_two_level(static, scenes, inv, boxes, o, d, t_max, max_steps=cap)
    torch.cuda.synchronize()
    assert kern.trace_closest_two_level.launches == kern.trace_any_two_level.launches == 1
    assert kern._trace_launches() == 0
    want, want_inst = plain.two_level_closest(kern.trace_closest, static, scenes, inv, boxes,
                                              o, d, t_max, slot_off, cap)
    for k in ("t", "slot", "u", "v"):
        assert torch.equal(getattr(hit, k), getattr(want, k)), (k, cap, o.shape[0])
    assert torch.equal(inst, want_inst), (cap, o.shape[0])
    assert torch.equal(occ, plain.two_level_any(kern.trace_any, static, scenes, inv, o, d,
                                                t_max, cap)), (cap, o.shape[0])
    return int((inst >= 0).sum().item())


def _two_level_cases(blas, n_inst):
    """_fused_equal on the first n_inst instances of _two_level_db(blas),
    at caps None, 0, 1 and 64 and batches of 1, 5, 33 and 2^20 rays."""
    db = _two_level_db(blas)
    static, iset = db.device_scene, db.instance_set()
    parts = (iset.scenes[:n_inst], iset.inv[:n_inst], iset.boxes[:n_inst],
             iset.slot_off[:n_inst])
    if blas == "distinct":
        assert {s.bvh4_leaf_bits for s in parts[0]} == {5, 6}
    on_instance = 0
    for n in (1, 5, 33, 1 << 20):
        o, d, t_max = _two_level_rays(static, n, n)
        for cap in (None, 0, 1, 64):
            on_instance += _fused_equal(static, parts, o, d, t_max, cap)
    assert (on_instance > 0) == (n_inst > 0)


@pytest.mark.parametrize("blas,n_inst", [("shared", 0), ("shared", 1), ("shared", 16),
                                         ("distinct", 16)])
def test_two_level_kernel_matches_launch_loop(dev, blas, n_inst):
    """The fused kernel bit-equal to the per-instance launch loop on every
    ray (_two_level_cases), its first launches in a process of its own."""
    _on_card_alone(f"t._two_level_cases({blas!r}, {n_inst})")


def test_two_level_kernel_refuses_bad_inputs(dev):
    """Mismatched instance tensors, a scene off the card, more instances
    than the kernel's parameter block holds: each raises before a launch."""
    db = _two_level_db("shared")
    static, iset = db.device_scene, db.instance_set()
    o, d, t_max = _two_level_rays(static, 64, 3)
    kern.reset_launch_counts()
    for kw in (dict(inst_inv=iset.inv[:3]), dict(inst_boxes=iset.boxes.cpu()),
               dict(inst_scenes=iset.scenes[:15]), dict(slot_off=iset.slot_off[:2])):
        args = dict(inst_scenes=iset.scenes, inst_inv=iset.inv, inst_boxes=iset.boxes,
                    slot_off=iset.slot_off)
        args.update(kw)
        with pytest.raises((ValueError, TypeError)):
            kern.trace_closest_two_level(static, o=o, d=d, t_max=t_max, **args)
    many = kern.TWO_LEVEL_MAX_INSTANCES + 1
    with pytest.raises(ValueError):
        kern.trace_any_two_level(static, [iset.scenes[0]] * many, iset.inv[:1].expand(many, 3, 4)
                                 .contiguous(), iset.boxes[:1].expand(many, 2, 3).contiguous(),
                                 o, d, t_max)
    assert kern.trace_closest_two_level.launches == kern.trace_any_two_level.launches == 0


def _app_engine(device, mode, path, shading):
    """chip_smoke's small Engine (phase 21): the glTF at `path` on `device`."""
    import chip_smoke as cs

    from idkengine_tpu_torch.engine import Engine

    db, _, _ = cs.load_app_db(path, device, shading, defer=False)
    eng = Engine(db, cs.engine_settings(48, 32, 32), env_map=cs.textured_env("cpu", 64, 32),
                 device=device)
    eng.camera = Camera(position=np.array(cs.CAMERA["position"], np.float32),
                        yaw=cs.CAMERA["yaw"], fov_y=cs.CAMERA["fov_y"])
    eng.set_mode(mode)
    return eng


@pytest.mark.parametrize("mode", ["path_tracer", "rasterizer"])
def test_gltf_engine_on_card_matches_cpu(dev, tmp_path, mode):
    """A small textured, animated atrium written as a glTF (chip_smoke's
    writer) through the Engine on the card and on the CPU: frames, an
    update through update_device, another frame (RMSE <= 1e-3 each)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs

    from idkengine_tpu_torch.engine import RenderMode

    model, shading = cs.app_model(0, 8000)
    path = str(tmp_path / "small.glb")
    cs.write_glb(model, path)
    imgs = []
    for device in (dev, "cpu"):
        eng = _app_engine(device, RenderMode(mode), path, shading)
        frames = [eng.render(), eng.render()]
        eng.update(0.25)
        frames.append(eng.render())
        if device == dev:
            assert eng.db.device_vertices is not None and eng.db.device_vertices.is_cuda
        imgs.append([f.cpu().numpy() for f in frames])
    for a, b in zip(*imgs):
        assert np.isfinite(a).all() and a.std() > 0
        assert float(np.sqrt(np.mean((a - b) ** 2))) <= 1e-3


def test_async_atlas_write_on_card(dev, tmp_path):
    """attach_async_textures writes each decoded layer into the tracer's
    atlas on the card (in place, or appended), equal to the CPU tracer's
    after the same decodes; the card frame after them matches the eager
    load's CPU frame (RMSE <= 1e-3)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs

    from idkengine_tpu_torch.scene.async_io import (AsyncTextureLoader, MainThreadQueue,
                                                    attach_async_textures)

    model, shading = cs.app_model(0, 8000)
    path = str(tmp_path / "small.glb")
    cs.write_glb(model, path)
    cam = Camera(position=np.array(cs.CAMERA["position"], np.float32), yaw=cs.CAMERA["yaw"],
                 fov_y=cs.CAMERA["fov_y"])
    tracers = []
    for device in (dev, "cpu"):
        db, lazy, _ = cs.load_app_db(path, device, shading, defer=True)
        pt = PathTracer(db.device_scene, db.materials.soa(), db.lights.soa(), 48, 32,
                        cs.textured_settings(), slot_shading=db.slot_shading(), device=device)
        pt.render_frame(cam)
        atlas = pt.mats["atlas"]
        loader = AsyncTextureLoader(MainThreadQueue(), workers=1)
        attach_async_textures(db, lazy, loader, mat_offset=0, pt=pt)
        loader.wait_all(timeout=120)
        assert pt.mats["atlas"].device == atlas.device and pt._has_textures
        tracers.append(pt)
    assert tracers[0].mats["atlas"].is_cuda and tracers[0].mats["atlas"].shape[0] == 6
    assert torch.equal(tracers[0].mats["atlas"].cpu(), tracers[1].mats["atlas"])
    eager, _, _ = cs.load_app_db(path, "cpu", shading, defer=False)
    want = PathTracer(eager.device_scene, eager.materials.soa(), eager.lights.soa(), 48, 32,
                      cs.textured_settings(), slot_shading=eager.slot_shading(), device="cpu")
    ref = want.render_frame(cam).numpy()
    pt = tracers[0]
    pt.reset_accumulation()
    pt._frame = 0
    img = pt.render_frame(cam).cpu().numpy()
    assert float(np.sqrt(np.mean((img - ref) ** 2))) <= 1e-3


def test_sharded_pathtracer_on_card_matches_unsharded(dev, scenes):
    """ShardedPathTracer over the card listed four times: each frame equal
    to the unsharded card frame on every pixel, four times its launches;
    the instanced scene's two-level traces likewise."""
    from idkengine_tpu_torch.parallel.shard import Mesh, ShardedPathTracer

    db, sc, _ = scenes
    cam = Camera(position=np.array([0, 3, 24], np.float32), yaw=-90.0, fov_y=65.0)
    settings = PathTracerSettings(ray_depth=2, russian_roulette=False, do_ray_sorting=True)
    lights = dict(count=1, pos=[[0.0, 10.5, 0.0]], radius=[0.8], radiance=[[40.0, 38.0, 35.0]])

    def tracer():
        return PathTracer(sc, db.materials.soa(), lights, 96, 54, settings, device=dev)

    ref, spt = tracer(), ShardedPathTracer(tracer(), Mesh((dev,) * 4))
    for _ in range(2):
        kern.reset_launch_counts()
        want = ref.render_frame(cam)
        n = kern.trace_closest.launches
        got = spt.render_frame(cam)
        assert kern.trace_closest.launches == 5 * n
        assert torch.equal(got, want)
    assert torch.equal(spt.variance(), ref.variance())
    idb = _instanced_db(dev)
    pts = [PathTracer(idb.device_scene, idb.materials.soa(), idb.lights.soa(), 48, 48,
                      PathTracerSettings(ray_depth=2, sky_strength=0.0),
                      instances=idb.instance_set(), inst_attr_srcs=idb._inst_attr_srcs,
                      device=dev) for _ in range(2)]
    spt = ShardedPathTracer(pts[1], Mesh((dev,) * 4))
    assert torch.equal(spt.render_frame(_instanced_cam()), pts[0].render_frame(_instanced_cam()))


def test_mixed_mesh_on_card_matches_cpu(dev):
    """A mesh of the card and the CPU: the tracer's state copied to the CPU,
    the halves gathered on the card; the card's rows equal the card-only
    frame's, the CPU's rows the CPU-only frame's."""
    from idkengine_tpu_torch.parallel.dryrun import build_small_pt
    from idkengine_tpu_torch.parallel.shard import Mesh, ShardedPathTracer

    pt, cam = build_small_pt(64, 64, device=dev)
    spt = ShardedPathTracer(pt, Mesh((dev, "cpu")))
    img = spt.render_frame(cam)
    assert img.is_cuda
    card = build_small_pt(64, 64, device=dev)[0].render_frame(cam).cpu()
    cpu = build_small_pt(64, 64, device="cpu")[0].render_frame(cam)
    assert torch.equal(img[:32].cpu(), card[:32]) and torch.equal(img[32:].cpu(), cpu[32:])
    assert float(torch.sqrt(torch.mean((img.cpu() - cpu) ** 2))) <= 1e-3


def test_shard_packet_on_card_bit_equal(dev, scenes):
    """shard_packet_closest / shard_packet_any over the card listed four
    times (and three, uneven) bit-equal to the unsharded kernels."""
    from idkengine_tpu_torch.parallel.dryrun import check_sharded_traces, packet_rays
    from idkengine_tpu_torch.parallel.shard import Mesh

    _, sc, _ = scenes
    for shards, n in ((4, 1 << 16), (3, 50_001)):
        kern.reset_launch_counts()
        out = check_sharded_traces(Mesh((dev,) * shards), sc, *packet_rays(sc, n))
        assert out["hits"] > 0 and kern.trace_closest.launches == 1 + shards


def test_device_sorts_on_card(dev):
    """radix_argsort equals a stable argsort of the low bits; sort_rays_by_key
    keeps each payload row with its key."""
    from idkengine_tpu_torch.ops.device_sort import radix_argsort, sort_rays_by_key

    g = torch.Generator(device=dev).manual_seed(5)
    keys = torch.randint(0, 1 << 24, (1 << 20,), generator=g, device=dev, dtype=torch.int32)
    want = torch.argsort(keys & ((1 << 18) - 1), stable=True)
    assert torch.equal(radix_argsort(keys).long(), want)
    ids = torch.arange(keys.shape[0], device=dev)
    vals = torch.rand((keys.shape[0], 3), generator=g, device=dev)
    k, v, i = sort_rays_by_key(keys, (keys, vals, ids))
    assert torch.equal(k, torch.sort(keys).values)
    assert torch.equal(v, vals[i]) and torch.equal(keys[i], k)


def test_dryrun_small_on_card(dev):
    from idkengine_tpu_torch.parallel.dryrun import dryrun_multichip
    from idkengine_tpu_torch.parallel.shard import Mesh

    out = dryrun_multichip(mesh=Mesh((dev,) * 4), small=True)
    assert out["pixels_differ"] == 0 and out["rmse"] == 0.0


def _counted(monkeypatch, fn):
    """fn() with the trace wrappers counting (as under a profiler) into
    fresh counters: (its result, profiling.report())."""
    from idkengine_tpu_torch import profiling

    monkeypatch.setattr(kern, "tracing", lambda: True)
    monkeypatch.setattr(profiling, "_counters", {})
    monkeypatch.setattr(profiling, "_counter_rows", {})
    out = fn()
    return out, profiling.report()


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("kind", ["incoherent", "dead_and_zero", "from_1e8"])
def test_counting_kernels_equal_the_plain_ones(dev, scenes, kind, monkeypatch):
    """The counting trace kernels return the plain kernels' results bit for
    bit, count every live ray (t_max not below 0) once, and repeat their
    counts exactly from run to run."""
    _, sc, _ = scenes
    o, d, t_max = _rays_of(kind, sc, 1 << 16, 41, dev)

    def both():
        return (kern.trace_closest(sc, o, d, t_max, tag="bnc"),
                kern.trace_any(sc, o, d, t_max, tag="nee"))

    hit, occ = both()
    live = int((~(t_max < 0)).sum())
    reports = []
    for _ in range(2):
        (c_hit, c_occ), report = _counted(monkeypatch, both)
        for a, b in zip(hit, c_hit):
            assert torch.equal(_bits(a), _bits(b))
        assert torch.equal(occ, c_occ)
        reports.append(report)
    assert reports[0] == reports[1]
    assert reports[0]["pt_closest_bnc"]["rays"] == live == reports[0]["pt_any_nee"]["rays"]
    for row in reports[0].values():
        assert row["nodes"] >= row["rays"] and row["tris"] > 0


MISS_KEY = 0x7FFFFFFF


def _wide_walk_counts(sc, o, d, t_max, any_hit: bool):
    """(records fetched, triangles tested) summed over the rays of
    csrc/trace.cu's walk_wide, replayed on the host: the slab tests of
    every record's children and the Möller–Trumbore test of every triangle
    for every ray, computed as the kernel computes them, then each live
    ray's walk in the kernel's order (the sorting network on the entry
    distance's bits, the far children pushed first, a popped child culled
    beyond the best hit, the any-hit walk stopped at its first)."""
    from idkengine_tpu_torch.ops.intersect import ray_triangle

    rec = sc.bvh4_nodes.cpu()
    m = rec.shape[0]
    box = rec[:, :24].contiguous().view(torch.float32).reshape(m, 6, 4)
    lo, hi = box[:, 0::2].permute(0, 2, 1), box[:, 1::2].permute(0, 2, 1)  # (M,4,3)
    oc, dc, tm = o.cpu(), d.cpu(), t_max.cpu().tolist()
    inv = plain.inverse_direction(dc)[:, None, None]
    t0 = (lo[None] - oc[:, None, None]) * inv
    t1 = (hi[None] - oc[:, None, None]) * inv
    tn = torch.clamp(torch.minimum(t0, t1).amax(-1), min=0.0)  # (R,M,4)
    tf = torch.maximum(t0, t1).amin(-1)
    key = tn.view(torch.int32)
    tv = sc.tri_vec.cpu()
    tri_hit, tri_t, _, _ = ray_triangle(oc[:, None], dc[:, None], tv[None, :, 0:3],
                                        tv[None, :, 3:6], tv[None, :, 6:9])
    refs, counts = rec[:, 24:28].tolist(), rec[:, 28].tolist()
    bits = sc.bvh4_leaf_bits
    nodes = tris = 0
    for i in range(oc.shape[0]):
        t_best = tm[i]
        if t_best < 0:
            continue
        tn_i, tf_i, key_i = tn[i].tolist(), tf[i].tolist(), key[i].tolist()
        hit_i, t_i = tri_hit[i].tolist(), tri_t[i].tolist()
        stack, code, found = [], 0, False
        while True:
            if code >= 0:
                nodes += 1
                k = [key_i[code][j] if (j < counts[code] and tf_i[code][j] >= tn_i[code][j]
                                        and tn_i[code][j] <= t_best) else MISS_KEY
                     for j in range(4)]
                c = list(refs[code])
                dist = list(tn_i[code])
                for a, b in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
                    if k[b] < k[a]:
                        k[a], k[b], c[a], c[b], dist[a], dist[b] = (k[b], k[a], c[b], c[a],
                                                                    dist[b], dist[a])
                if k[0] != MISS_KEY:
                    code = c[0]
                    stack += [(c[j], dist[j]) for j in (3, 2, 1) if k[j] != MISS_KEY]
                    continue
            else:
                leaf = ~code
                first, count = leaf >> bits, (leaf & ((1 << bits) - 1)) + 1
                for s in range(first, first + count):
                    tris += 1
                    if hit_i[s] and t_i[s] < t_best:
                        t_best, found = t_i[s], True
                        if any_hit:
                            break
                if any_hit and found:
                    break
            while stack:
                code, dist0 = stack.pop()
                if dist0 <= t_best:
                    break
            else:
                break
    return nodes, tris


def test_counts_equal_a_host_recount_of_the_walk(dev, monkeypatch):
    """On a 3,016-triangle atrium, the counting kernels' records and
    triangles equal a host replay of the same 4-wide walk, closest and
    any-hit, with dead rays among the live."""
    db = SceneDatabase(BuildSettings(**BUILD))
    db.add_model(atrium(3000))
    sc = db.build(dev)
    o, d, t_max = _rays_of("dead_and_zero", sc, 384, 43, dev)
    t_any = torch.where(t_max > 0, torch.clamp(t_max, max=4.0), t_max)

    def both():
        return (kern.trace_closest(sc, o, d, t_max, tag="pri"),
                kern.trace_any(sc, o, d, t_any, tag="nee"))

    _, report = _counted(monkeypatch, both)
    live = int((~(t_max < 0)).sum())
    for site, tm, any_hit in (("pt_closest_pri", t_max, False), ("pt_any_nee", t_any, True)):
        nodes, tris = _wide_walk_counts(sc, o, d, tm, any_hit)
        assert report[site] == {"rays": live, "nodes": nodes, "tris": tris}, site
