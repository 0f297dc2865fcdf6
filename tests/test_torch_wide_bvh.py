"""The trace kernel's 4-wide node table (bvh/flatten.py:bvh4_nodes) and a
plain walk of it, against the JAX package.

The table's invariants are checked on the atrium, the Cornell box, a single
quad (a leaf-only root), an atrium built with leaves above 32 triangles
(6 count bits) and a hand-made deep chain. `wide_walk` below walks
the table as csrc/trace.cu does (a per-ray stack of (reference, entry
distance), the hit children taken nearest first and the others pushed far
first; the closest query culls a popped entry beyond its best hit, the
any-hit query stops at its first occluder), with the port's plain slab and
Möller–Trumbore arithmetic. It is the kernel's algorithm on the CPU; the
port's trace entry points do not use it.

Tolerance, as in test_torch_trace.py: slots equal on at least 99.9% of rays
(the rest are ties: two triangles at one t, met in another order); t within
1e-5 relative of the JAX traces; t, u and v bit-equal with them where the
slots agree (the port's Möller–Trumbore test rounds as XLA:CPU rounds the
JAX package's, ops/intersect.py). Rays that start 1e8 units away, where
the f32 spacing is 8 units, are held to the same hit mask as the JAX traces
(and the port's stackless trace, which equals them bit for bit), t, u and
v bit-equal where the slots agree, t within 1e-5 relative on 99.9% of the
rays and the same occlusion, but to no share of equal slots: the
Möller–Trumbore t carries errors of up to thousands of units there (s = o -
p0 is 1e8 long), many hits tie, and a triangle's t can fall far below its
own box's entry distance, so which hit a closest query keeps depends on
which boxes it culled first, and the wide walk culls in another order than
the stackless one (their slots differ on about 3.5% of the atrium's far
rays).
"""
import dataclasses

import numpy as np
import pytest
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from idkengine_tpu.bvh.builder import BuildSettings as JBuildSettings  # noqa: E402
from idkengine_tpu.ops import trace as j_trace  # noqa: E402
from idkengine_tpu.scene.model import MeshPrimitive, Model, Node  # noqa: E402
from idkengine_tpu.scene.procedural import atrium as j_atrium  # noqa: E402
from idkengine_tpu.scene.procedural import cornell_box as j_cornell  # noqa: E402
from idkengine_tpu.scene.procedural import make_quad  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch.bvh.flatten import bvh4_nodes, leaf_bits  # noqa: E402
from idkengine_tpu_torch.ops import packet_trace as t_pt  # noqa: E402
from idkengine_tpu_torch.ops import trace as t_trace  # noqa: E402
from idkengine_tpu_torch.ops.intersect import ray_aabb, ray_triangle  # noqa: E402
from idkengine_tpu_torch.ops.trace import (JAX_FIELDS, Hit, from_jax_scene_arrays,  # noqa: E402
                                           inverse_direction)

from test_torch_trace import jax_core  # noqa: E402,F401

BENCH = JBuildSettings(max_leaf_triangle_count=12, traversal_cost=4.0, presplit_factor=0.0)
T_REL = 1e-5
SLOT_AGREE = 0.999
INF = 3.4e38


def _quad() -> Model:
    model = Model(name="quad")
    v, i = make_quad([0, 0, 0], [4, 0, 0], [4, 0, 3], [0, 0, 3])
    model.primitives.append(MeshPrimitive(positions=v, indices=i, material=0))
    model.primitives[-1].ensure_normals()
    model.nodes.append(Node(name="root", mesh_primitives=[0]))
    model.root_nodes.append(0)
    return model


MODELS = {"atrium": lambda: j_atrium(8000), "cornell": j_cornell, "quad": _quad}
# a high traversal cost makes the builder keep leaves above 32 triangles
LEAF64 = JBuildSettings(max_leaf_triangle_count=64, traversal_cost=40.0, presplit_factor=0.0)


@pytest.fixture(scope="module", params=sorted(MODELS))
def scene(request):
    return _build(request.param, BENCH)


def _build(name, settings):
    db = JSceneDatabase(settings)
    db.add_model(MODELS[name]())
    jsc = db.build()
    arrays = {k: np.asarray(getattr(jsc, k)) for k in JAX_FIELDS}
    return name, jsc, arrays, from_jax_scene_arrays(arrays, jsc.max_leaf, "cpu")


def _decode(code, bits):
    c = ~np.asarray(code, np.int64)
    return c >> bits, (c & ((1 << bits) - 1)) + 1


def _chain(n_spine: int) -> dict:
    """Threaded arrays of a caterpillar tree: each of n_spine interior nodes
    has a one-triangle leaf on its left and the rest of the spine on its
    right (the last one two leaves), nested boxes along the x axis."""
    n = 2 * n_spine + 1
    count = np.zeros(n, np.int32)
    count[1::2] = 1
    count[-1] = 1
    first = np.where(count > 0, np.cumsum(count) - 1, -1).astype(np.int32)
    miss = np.full(n, -1, np.int32)
    miss[1:-1:2] = np.arange(2, n, 2)  # a left leaf falls through to the spine
    hit = np.where(count > 0, miss, np.arange(1, n + 1)).astype(np.int32)
    lo = np.zeros((n, 3), np.float32)
    hi = np.ones((n, 3), np.float32)
    lo[0::2, 0] = np.arange(n_spine + 1)  # the spine's boxes shrink towards +x
    hi[:, 0] = n_spine + 1
    lo[1::2, 0] = np.arange(n_spine)
    hi[1::2, 0] = np.arange(n_spine) + 1
    lo[-1, 0], hi[-1, 0] = n_spine, n_spine + 1
    t = count.sum()
    p0 = np.stack([np.arange(t) + 0.5, np.full(t, 0.2), np.full(t, 0.2)], 1).astype(np.float32)
    e1 = np.tile(np.float32([0.0, 0.5, 0.0]), (t, 1))
    e2 = np.tile(np.float32([0.0, 0.0, 0.5]), (t, 1))
    return {"node_min": lo, "node_max": hi, "node_first": first, "node_count": count,
            "hit_link": hit, "miss_link": miss, "tri_p0": p0, "tri_e1": e1, "tri_e2": e2,
            "tri_n": np.zeros((t, 3), np.uint32), "tri_uv": np.zeros((t, 3, 2), np.float32),
            "tri_mat": np.zeros(t, np.int32), "tri_gn": np.tile(np.float32([1, 0, 0]), (t, 1))}


def _check_table(arrays, sc):
    """The wide table's invariants against the threaded arrays it came from."""
    rec = sc.bvh4_nodes.numpy()
    bits = leaf_bits(arrays["node_count"])
    assert bits == sc.bvh4_leaf_bits
    words, depth, src = bvh4_nodes(arrays["node_min"], arrays["node_max"],
                                   arrays["node_first"], arrays["node_count"],
                                   arrays["miss_link"], bits)
    np.testing.assert_array_equal(words, rec)
    np.testing.assert_array_equal(src, sc.bvh4_child.numpy())
    assert depth == sc.bvh4_depth
    n_child = rec[:, 28]
    assert ((n_child >= 1) & (n_child <= 4)).all()
    assert (rec[:, 29:] == 0).all()
    slot_k = np.arange(4)[None, :]
    used = slot_k < n_child[:, None]
    np.testing.assert_array_equal(src >= 0, used)
    # empty slots are zero words: never a sentinel box
    assert (rec[:, :28].reshape(-1, 7, 4)[~np.repeat(used[:, None, :], 7, 1)] == 0).all()
    # every child box is its binary node's box, bit for bit
    lo_bits = np.asarray(arrays["node_min"], np.float32).view(np.int32)
    hi_bits = np.asarray(arrays["node_max"], np.float32).view(np.int32)
    s = np.maximum(src, 0)
    for axis in range(3):
        np.testing.assert_array_equal(rec[:, 8 * axis:8 * axis + 4][used], lo_bits[s, axis][used])
        np.testing.assert_array_equal(rec[:, 8 * axis + 4:8 * axis + 8][used],
                                      hi_bits[s, axis][used])
    count, first = arrays["node_count"], arrays["node_first"]
    code = rec[:, 24:28]
    leaf = used & (code < 0)
    inner = used & (code >= 0)
    np.testing.assert_array_equal(leaf, used & (count[s] > 0))
    # a leaf reference is its binary leaf's [first, first + count)
    f, c = _decode(code[leaf], bits)
    np.testing.assert_array_equal(f, first[src[leaf]])
    np.testing.assert_array_equal(c, count[src[leaf]])
    # every record but the root is referenced once, after its parent
    refs = np.sort(code[inner])
    np.testing.assert_array_equal(refs, np.arange(1, rec.shape[0]))
    parent = np.repeat(np.arange(rec.shape[0])[:, None], 4, 1)[inner]
    assert (code[inner] > parent).all()
    # every slot lies in exactly one leaf reference
    covered = np.zeros(sc.tri_p0.shape[0], np.int64)
    for a, b in zip(f, c):
        covered[a:a + b] += 1
    assert (covered == 1).all()
    # the depth: records on the longest path from the root
    level = np.zeros(rec.shape[0], np.int64)
    for i in range(rec.shape[0]):
        level[code[i][inner[i]]] = level[i] + 1
    assert level.max() + 1 == depth
    return src


def test_table_invariants(scene):
    name, _, arrays, sc = scene
    src = _check_table(arrays, sc)
    assert t_pt.wide_stack_entries(sc) <= t_pt.WIDE_STACK_LIMIT
    # the wide tree is about half as deep as the binary one
    assert sc.bvh4_depth <= (sc.bvh_depth + 2) // 2 + 1
    if name == "quad":  # a leaf-only root: one record, one leaf child
        assert arrays["node_count"][0] > 0
        assert sc.bvh4_nodes.shape[0] == 1 and src[0, 0] == 0
    else:
        assert sc.bvh4_nodes[:, 28].float().mean() > 2.5  # about 3 children a record


def _tree(a1: float, b: float) -> dict:
    """Threaded arrays of 9 nodes in DFS order: root 0 = (A 1, B 6); A = (A1 2,
    leaf 5); A1 = (leaves 3, 4); B = (leaves 7, 8). A's box is the largest,
    A1's and B's are cubes of side a1 and b."""
    count = np.int32([0, 0, 0, 1, 1, 1, 0, 1, 1])
    miss = np.int32([-1, 6, 5, 4, 5, 6, -1, 8, -1])
    side = np.float32([20, 10, a1, 1, 1, 1, b, 1, 1])
    lo = np.zeros((9, 3), np.float32)
    return {"node_min": lo, "node_max": lo + side[:, None],
            "node_first": np.where(count > 0, np.cumsum(count) - 1, -1).astype(np.int32),
            "node_count": count, "miss_link": miss}


@pytest.mark.parametrize("a1, b, root, second", [(2.0, 3.0, [2, 5, 7, 8], [3, 4]),
                                                 (5.0, 3.0, [3, 4, 5, 6], [7, 8])])
def test_collapse_opens_the_largest_child(a1, b, root, second):
    """From the root, A (largest) opens first; then the larger of A1 and B.
    The one left closed becomes the second record."""
    a = _tree(a1, b)
    rec, depth, src = bvh4_nodes(a["node_min"], a["node_max"], a["node_first"],
                                 a["node_count"], a["miss_link"], 5)
    assert sorted(src[0].tolist()) == root
    assert depth == 2 and rec.shape[0] == 2 and rec[0, 28] == 4
    assert src[1].tolist() == second + [-1, -1]
    assert (rec[:, 24:28][src >= 0] < 0).sum() == 5  # five leaves, five leaf references


def test_deep_chain_table_and_stack_bound():
    """A caterpillar of 300 interior nodes: three spine levels a record;
    the wrapper refuses the tree its stack cannot hold."""
    a = _chain(300)
    sc = from_jax_scene_arrays(a, 1, "cpu")
    _check_table(a, sc)
    assert sc.bvh4_depth == 100
    with pytest.raises(ValueError, match="stack"):
        t_pt.wide_stack_entries(sc)
    short = from_jax_scene_arrays(_chain(60), 1, "cpu")
    assert t_pt.wide_stack_entries(short) == 3 * short.bvh4_depth
    # rays down the spine hit every slot in order
    o = torch.tensor([[-1.0, 0.5, 0.5], [-1.0, 0.3, 0.3]])
    d = torch.tensor([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    got = wide_walk(short, o, d, INF)
    want = t_trace.trace_closest(short, o, d, INF)
    assert got.slot.tolist() == [-1, 0] and torch.equal(got.t, want.t)


def test_deep_tree_refused_by_the_trace_wrapper():
    """`wide_stack_entries` is what the CUDA wrapper checks before each
    launch: a scene of depth above the bound never reaches the kernel."""
    sc = from_jax_scene_arrays(_chain(60), 1, "cpu")
    deep = dataclasses.replace(sc, bvh4_depth=t_pt.WIDE_STACK_LIMIT // 3 + 1)
    with pytest.raises(ValueError, match="stack"):
        t_pt.wide_stack_entries(deep)
    t_pt.wide_stack_entries(dataclasses.replace(sc, bvh4_depth=t_pt.WIDE_STACK_LIMIT // 3))


def wide_walk(sc, o, d, t_max, any_hit=False):
    """The trace kernel's walk of the wide table, in plain PyTorch (see the
    module docstring). Returns Hit, or the occlusion mask when any_hit."""
    rec = sc.bvh4_nodes
    box = rec[:, :24].contiguous().view(torch.float32).reshape(-1, 6, 4)
    lo, hi = box[:, 0::2].transpose(1, 2), box[:, 1::2].transpose(1, 2)  # (M,4,3)
    ref, n_child = rec[:, 24:28].long(), rec[:, 28].long()
    r = o.shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32).expand(r).contiguous()
    inv_d = inverse_direction(d)
    t_best = t_max.clone()
    slot = torch.full((r,), -1, dtype=torch.int32)
    u, v = torch.zeros(r), torch.zeros(r)
    entries = t_pt.wide_stack_entries(sc)
    st_code = torch.zeros((r, entries), dtype=torch.long)
    st_t = torch.zeros((r, entries))
    sp = torch.zeros(r, dtype=torch.long)
    code = torch.zeros(r, dtype=torch.long)  # the root record
    alive = ~(t_max < 0)
    bits = sc.bvh4_leaf_bits
    mask = (1 << bits) - 1
    while True:
        ids = alive.nonzero().squeeze(1)
        if not ids.numel():
            break
        c = code[ids]
        pop = torch.ones(ids.numel(), dtype=torch.bool)
        inner = (c >= 0).nonzero().squeeze(1)
        if inner.numel():
            ii, rc = ids[inner], c[inner]
            hit, tn = ray_aabb(o[ii, None], inv_d[ii, None], lo[rc], hi[rc], t_best[ii, None])
            hit &= torch.arange(4) < n_child[rc, None]
            key, order = torch.sort(torch.where(hit, tn, torch.inf), dim=1, stable=True)
            codes = ref[rc].gather(1, order)
            n_hit = hit.sum(1)
            for j in (3, 2, 1):  # push the others, far first
                p = n_hit > j
                pr = ii[p]
                st_code[pr, sp[pr]] = codes[p, j]
                st_t[pr, sp[pr]] = key[p, j]
                sp[pr] += 1
            go = n_hit > 0
            code[ii[go]] = codes[go, 0]
            pop[inner[go]] = False
        leaf = (c < 0).nonzero().squeeze(1)
        if leaf.numel():
            li, lc = ids[leaf], ~c[leaf]
            first, count = lc >> bits, (lc & mask) + 1
            ks = torch.arange(int(count.max()))
            valid = ks[None, :] < count[:, None]
            tid = torch.where(valid, first[:, None] + ks[None, :], 0)
            h, t, uu, vv = ray_triangle(o[li, None], d[li, None], sc.tri_p0[tid], sc.tri_e1[tid],
                                        sc.tri_e2[tid])
            t_min, k_min = torch.where(valid & h, t, torch.inf).min(dim=1)
            closer = t_min < t_best[li]
            rc, kc = li[closer], k_min[closer, None]
            t_best[rc] = t_min[closer]
            slot[rc] = (first[closer] + k_min[closer]).to(torch.int32)
            u[rc] = uu[closer].gather(1, kc).squeeze(1)
            v[rc] = vv[closer].gather(1, kc).squeeze(1)
            if any_hit:  # stop at the first occluder
                alive[rc] = False
                pop[leaf[closer]] = False
        need = ids[pop]
        while need.numel():  # pop the nearest entry that can still hold a closer hit
            empty = sp[need] == 0
            alive[need[empty]] = False
            need = need[~empty]
            sp[need] -= 1
            ok = st_t[need, sp[need]] <= t_best[need]
            code[need[ok]] = st_code[need[ok], sp[need[ok]]]
            need = need[~ok]
    return slot >= 0 if any_hit else Hit(t=t_best, slot=slot, u=u, v=v)


def _rays(sc, n, seed):
    """Random directions from random points in the scene box, an eighth of
    them axis-parallel and an eighth from 1e8 units away towards a point of
    the scene; t_max mixes dead rays, 0, short and long limits."""
    rng = np.random.default_rng(seed)
    lo, hi = sc.node_min[0].numpy(), sc.node_max[0].numpy()
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    axis = rng.integers(0, 3, n)
    par = np.arange(n) % 8 == 1
    d[par] = 0.0
    d[par, axis[par]] = rng.choice([-1.0, 1.0], par.sum())
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    far = np.arange(n) % 8 == 2
    o[far] = o[far] - d[far] * np.float32(1e8)
    t_max = rng.choice(np.float32([-1.0, 0.0, 2.0, 50.0, INF]), n, p=[0.1, 0.05, 0.2, 0.3, 0.35])
    t_max[far] = np.float32(2e8)
    return o, d.astype(np.float32), t_max.astype(np.float32), far


def _assert_same_hits(got, want_t, want_slot, t_max):
    gs, gt = got.slot.numpy(), got.t.numpy()
    ws, wt = np.asarray(want_slot), np.asarray(want_t)
    np.testing.assert_array_equal(gs >= 0, ws >= 0)
    assert (gs == ws).mean() >= SLOT_AGREE
    hit = ws >= 0
    np.testing.assert_allclose(gt[hit], wt[hit], rtol=T_REL, atol=0)
    np.testing.assert_array_equal(gt[~hit], t_max[~hit])


def test_wide_walk_matches_jax(scene):
    name, jsc, _, sc = scene
    o, d, t_max, far = _rays(sc, 2048, 5)
    oj, dj = jnp.asarray(o), jnp.asarray(d)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    want = j_trace.trace_closest(jsc, oj, dj, jnp.asarray(t_max))
    got = wide_walk(sc, ot, dt, torch.from_numpy(t_max))
    near = Hit(*(x[torch.from_numpy(~far)] for x in got))
    _assert_same_hits(near, np.asarray(want.t)[~far], np.asarray(want.slot)[~far], t_max[~far])
    assert (got.slot.numpy() >= 0).mean() > (0.01 if name == "quad" else 0.2)
    dead = t_max < 0
    assert (got.slot.numpy()[dead] == -1).all()
    # every ray, from 1e8 away too: the JAX trace's hit mask, and t, u, v
    # bit-equal where both pick the same slot
    gs, ws = got.slot.numpy(), np.asarray(want.slot)
    np.testing.assert_array_equal(gs >= 0, ws >= 0)
    same = gs == ws
    for k in ("t", "u", "v"):
        np.testing.assert_array_equal(getattr(got, k).numpy()[same],
                                      np.asarray(getattr(want, k))[same], err_msg=k)
    close = np.isclose(got.t.numpy()[far], np.asarray(want.t)[far], rtol=T_REL, atol=0)
    assert close.mean() >= SLOT_AGREE
    # the port's stackless trace (the card's plain version) equals the JAX
    # trace bit for bit, from 1e8 too
    plain = t_trace.trace_closest(sc, ot, dt, torch.from_numpy(t_max))
    for k in ("t", "slot", "u", "v"):
        np.testing.assert_array_equal(getattr(plain, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    # any-hit: the JAX occlusion on every ray, and the closest hit before t_max
    occ_want = np.asarray(j_trace.trace_any(jsc, oj, dj, jnp.asarray(t_max)))
    occ = wide_walk(sc, ot, dt, torch.from_numpy(t_max), any_hit=True).numpy()
    np.testing.assert_array_equal(occ, occ_want)
    np.testing.assert_array_equal(occ, t_trace.trace_any(sc, ot, dt, torch.from_numpy(t_max)))
    np.testing.assert_array_equal(occ, got.slot.numpy() >= 0)
    assert not occ[dead].any()


def test_large_leaves():
    """An atrium built with leaves above 32 triangles: its table (6 count
    bits) and the wide walk, as test_table_invariants and
    test_wide_walk_matches_jax hold the other scenes."""
    built = _build("atrium", LEAF64)
    _, _, arrays, sc = built
    assert arrays["node_count"].max() > 32 and sc.bvh4_leaf_bits == 6
    test_table_invariants(built)
    test_wide_walk_matches_jax(built)


def test_wide_walk_scalar_t_max(scene):
    """Scalar t_max, short enough that many rays stop before a hit."""
    name, jsc, _, sc = scene
    o, d, _, far = _rays(sc, 512, 6)
    o, d = o[~far], d[~far]
    oj, dj = jnp.asarray(o), jnp.asarray(d)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    limit = 30.0 if name == "atrium" else 300.0
    want = j_trace.trace_closest(jsc, oj, dj, jnp.full((len(o),), limit, jnp.float32))
    got = wide_walk(sc, ot, dt, limit)
    _assert_same_hits(got, want.t, want.slot, np.full(len(o), limit, np.float32))
    occ_want = np.asarray(j_trace.trace_any(jsc, oj, dj, limit / 5))
    np.testing.assert_array_equal(wide_walk(sc, ot, dt, limit / 5, any_hit=True).numpy(),
                                  occ_want)
