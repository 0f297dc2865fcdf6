"""Port's two-phase traversal (plain versions, CPU) vs the JAX package's
two-phase trace over resident tables, whose phase A is kernel K5a (in
interpret mode, as the JAX package's own tests run it), and vs the port's
own one-phase trace; phase-A invariants. Kernel K5b is in
test_torch_two_phase_steered.py.

Tolerances: hit presence equal on every ray; slots differ only on equal-t
ties (t within 1e-6: two triangles meeting at the hit point, met in another
order; the port lists leaves in its own order, the JAX kernel by the
packet's dominant sign); t within 1e-5 relative where slots agree (XLA and
PyTorch may round the same Möller test differently in the last place).
Occlusion equal on every ray. Against the port's own one-phase trace (same
arithmetic), t is bit-equal where slots agree. `cnt` is compared with the
port's own plain version only: the JAX package's tree is BVH8, its leaves
are not the port's. Phase B alone, on coincident triangles and lists with
-1 holes (exact arithmetic), equals the JAX package's phase_b_closest in
t, slot, u and v on every ray.
"""
import numpy as np
import pytest
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from idkengine_tpu.ops import two_phase as j_tp  # noqa: E402
from idkengine_tpu.scene.procedural import atrium as j_atrium  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch.ops import packet_trace as t_pt  # noqa: E402
from idkengine_tpu_torch.ops import two_phase as tp  # noqa: E402

from test_torch_cuda import tie_case  # noqa: E402
from test_torch_trace import BENCH, T_REL, _port_scene, _rays, jax_core  # noqa: E402,F401

D = 4  # small enough that lists overflow into the fallback


def assert_same_final_hits(got, want_t, want_slot, t_rel=T_REL):
    """Closest hits equal up to equal-t ties (see the module docstring)."""
    gs, gt = got.slot.numpy(), got.t.numpy()
    ws, wt = np.asarray(want_slot), np.asarray(want_t)
    np.testing.assert_array_equal(gs >= 0, ws >= 0)
    hit = ws >= 0
    assert hit.mean() > 0.2, "rays should mostly hit"
    same = hit & (gs == ws)
    np.testing.assert_allclose(gt[same], wt[same], rtol=t_rel, atol=0)
    tie = hit & (gs != ws)
    np.testing.assert_allclose(gt[tie], wt[tie], rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def scenes():
    db = JSceneDatabase(BENCH)
    db.add_model(j_atrium(8000))
    jsc = db.build()
    return db, jsc, _port_scene(jsc)


def test_matches_k5a_interpret(scenes):
    """Resident tables, phase A in kernel K5a (interpret mode), D = 4 so
    that overflowed rays take the fallback, following the JAX package's
    TestResident."""
    db, jsc, sc = scenes
    assert isinstance(db.packet_scene, j_tp.pk.PacketScene) and db.packet_scene.wide
    o, d = _rays(jsc, 1024, 11)
    n = len(o)
    want = j_tp.two_phase_closest(db.packet_scene, db.packet_leaf_first, db.packet_leaf_count,
                                  jnp.asarray(o), jnp.asarray(d),
                                  jnp.full((n,), 3.4e38, jnp.float32),
                                  interpret=True, rows=8, d_slots=D)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    lists, cnt = tp.phase_a(sc, ot, dt, 3.4e38, D)
    assert (cnt > D).any(), "some lists should overflow at D=4"
    got = tp.two_phase_closest(sc, ot, dt, 3.4e38, D)
    assert_same_final_hits(got, want.t, want.slot)
    occ_want = j_tp.two_phase_any(db.packet_scene, db.packet_leaf_first, db.packet_leaf_count,
                                  jnp.asarray(o), jnp.asarray(d),
                                  jnp.full((n,), 15.0, jnp.float32),
                                  interpret=True, rows=8, d_slots=D)
    occ_got = tp.two_phase_any(sc, ot, dt, 15.0, D)
    np.testing.assert_array_equal(occ_got.numpy(), np.asarray(occ_want))


@pytest.mark.parametrize("d_slots", [2, D, 8])
def test_matches_own_one_phase(scenes, d_slots):
    _, jsc, sc = scenes
    o, d = (torch.from_numpy(x) for x in _rays(jsc, 2048, 12))
    t_max = torch.where(torch.arange(2048) % 9 == 0, -1.0, 3.4e38)
    got = tp.two_phase_closest(sc, o, d, t_max, d_slots)
    want = t_pt.trace_closest(sc, o, d, t_max)
    assert_same_final_hits(got, want.t, want.slot, t_rel=0)
    np.testing.assert_array_equal(got.t.numpy(), want.t.numpy())  # t_max on a miss
    s_tmax = torch.where(t_max > 0, 6.0, -1.0)
    np.testing.assert_array_equal(tp.two_phase_any(sc, o, d, s_tmax, d_slots).numpy(),
                                  t_pt.trace_any(sc, o, d, s_tmax).numpy())


def test_phase_a_invariants(scenes):
    _, jsc, sc = scenes
    o, d = (torch.from_numpy(x) for x in _rays(jsc, 1024, 13))
    t_max = torch.where(torch.arange(1024) % 2 == 0, 3.4e38, -1.0)
    lists2, cnt2 = tp.phase_a(sc, o, d, t_max, 2)
    lists8, cnt8 = tp.phase_a(sc, o, d, t_max, 8)
    assert lists2.shape == (1024, 2) and lists2.dtype == torch.int32
    # recorded entries = min(cnt, D), left-packed
    for lists, k in ((lists2, 2), (lists8, 8)):
        rec = lists >= 0
        np.testing.assert_array_equal(rec.sum(1).numpy(), torch.clamp(cnt8, max=k).numpy())
        assert not (rec[:, 1:] & ~rec[:, :-1]).any()
    assert (cnt2 > 2).any(), "expect overflow at D=2 in a real scene"
    # cnt does not depend on D, and the plain lists are one DFS order
    np.testing.assert_array_equal(cnt2.numpy(), cnt8.numpy())
    np.testing.assert_array_equal(lists2.numpy(), lists8[:, :2].numpy())
    # every listed id is a leaf; dead rays stay dead
    listed = lists8[lists8 >= 0].long()
    assert (sc.node_count[listed] > 0).all()
    dead = t_max < 0
    assert (cnt8[dead] == 0).all() and (lists8[dead] == -1).all()
    hit = tp.two_phase_closest(sc, o, d, t_max, 2)
    assert (hit.slot[dead] == -1).all() and (hit.t[dead] == -1.0).all()


def test_phase_b_over_complete_lists(scenes):
    """Where no list overflowed, phase B alone gives the one-phase t; a leaf
    listed twice changes nothing (a later equal t never replaces the hit);
    phase_b_any is phase_b_closest's hit mask."""
    _, jsc, sc = scenes
    o, d = (torch.from_numpy(x) for x in _rays(jsc, 512, 14))
    lists, cnt = tp.phase_a(sc, o, d, 3.4e38, 8)
    fine = cnt <= 8
    hit = tp.phase_b_closest(sc, lists, o, d, 3.4e38)
    want = t_pt.trace_closest(sc, o, d, 3.4e38)
    np.testing.assert_array_equal(hit.t.numpy()[fine.numpy()], want.t.numpy()[fine.numpy()])
    doubled = torch.cat([lists[:, :1], lists[:, :1]], dim=1).contiguous()
    a = tp.phase_b_closest(sc, lists[:, :1].contiguous(), o, d, 3.4e38)
    b = tp.phase_b_closest(sc, doubled, o, d, 3.4e38)
    for k in ("t", "slot", "u", "v"):
        np.testing.assert_array_equal(getattr(a, k).numpy(), getattr(b, k).numpy())
    np.testing.assert_array_equal(tp.phase_b_any(sc, lists, o, d, 3.4e38).numpy(),
                                  (hit.slot >= 0).numpy())


def test_cpu_tensors_take_the_plain_version(scenes):
    _, jsc, sc = scenes
    o, d = (torch.from_numpy(x) for x in _rays(jsc, 64, 15))
    tp.reset_launch_counts()
    t_pt.reset_launch_counts()
    tp.two_phase_closest(sc, o, d, 3.4e38)
    tp.two_phase_any(sc, o, d, 5.0)
    assert (tp.phase_a.launches, tp.phase_b_closest.launches, tp.phase_b_any.launches,
            t_pt.trace_closest.launches, t_pt.trace_any.launches) == (0, 0, 0, 0, 0)


def _jax_leaf_tables(scene):
    """The JAX package's phase-B tables for a port scene's leaves, leaf id =
    node index: leaf_stack rows (N, 128) of 9 floats a triangle (p0, e1,
    e2), leaf_first and leaf_count."""
    first, count = scene.node_first.numpy(), scene.node_count.numpy()
    rows = np.zeros((first.shape[0], 128), np.float32)
    tris = torch.cat([scene.tri_p0, scene.tri_e1, scene.tri_e2], 1).numpy()
    for leaf, (f, c) in enumerate(zip(first, count)):
        rows[leaf, :9 * c] = tris[f:f + c].reshape(-1)
    return jnp.asarray(rows), jnp.asarray(first), jnp.asarray(count)


@pytest.mark.parametrize("d_slots", [4, 8])
def test_phase_b_ties_as_jax(d_slots):
    """Two coincident triangles in two listed leaves (and two in one leaf),
    lists with -1 holes between entries: the port's phase B (plain on the
    CPU) picks the same slot, t, u and v as JAX's phase_b_closest (the
    earlier triangle of a leaf, then the earlier list entry), and the same
    occlusion as its phase_b_any."""
    scene, lists, o, d, t_max = tie_case(d_slots, "cpu")
    tables = _jax_leaf_tables(scene)
    cnt = (lists >= 0).sum(1)
    args = [jnp.asarray(x.numpy()) for x in (lists, cnt)]
    rays = [jnp.asarray(x.numpy()) for x in (o, d, t_max)]
    want = j_tp.phase_b_closest(*args, *tables, *rays)
    got = tp.phase_b_closest(scene, lists, o, d, t_max)
    for k in ("t", "slot", "u", "v"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    slot = got.slot.numpy()
    assert (slot == 1).any() and (slot == 2).any(), "both tied leaves should win somewhere"
    assert not (slot == 3).any(), "the later copy inside leaf 2 never wins a tie"
    np.testing.assert_array_equal(tp.phase_b_any(scene, lists, o, d, t_max).numpy(),
                                  np.asarray(j_tp.phase_b_any(*args, *tables, *rays)))


@pytest.mark.parametrize("d_slots", [0, -1])
def test_unsupported_d_slots_refused(d_slots):
    """The wrapper's check (the one a CUDA call runs before its launch)
    refuses lists without entries, here on CPU tensors; so do the entry
    points on the CPU, and the two-phase traces refuse a D below one before
    phase A."""
    scene, lists, o, d, t_max = tie_case(8, "cpu", n=16)
    empty = torch.full((16, 0), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="at least one list entry"):
        tp._check_phase_b(scene, empty, o, d, t_max)
    for fn in (tp.phase_b_closest, tp.phase_b_any):
        with pytest.raises(ValueError, match="at least one list entry"):
            fn(scene, empty, o, d, t_max)
    tp.reset_launch_counts()
    for fn in (tp.two_phase_closest, tp.two_phase_any):
        with pytest.raises(ValueError, match="at least one list entry"):
            fn(scene, o, d, t_max, d_slots)
    assert (tp.phase_a.launches, tp.phase_b_closest.launches, tp.phase_b_any.launches) == (0, 0, 0)
    tp._check_phase_b(scene, lists, o, d, t_max)  # D = 8 passes
