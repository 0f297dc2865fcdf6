"""The steps kernel's threaded records (bvh/flatten.py:thread_nodes), the
wide table's child map and leaf references wider than 5 bits
(bvh/flatten.py:bvh4_nodes), and the nesting of the binary tree's boxes,
against the JAX package and the port's plain versions.

`record_walk` walks the threaded records as csrc/trace.cu's
trace_steps_kernel does (one record a step: the next record at a hit
interior node, else the miss link), with the port's plain slab and
Möller–Trumbore arithmetic; the port's entry points do not use it.

Tolerances: none. The record walk visits the nodes of the JAX package's
stackless trace in its order with its arithmetic, so steps, t, slot, u and
v are equal on every ray, from 1e8 units away too. test_boxes_nest checks
that every binary child's box lies within its parent's, bit for bit, on
every build here: what a walk that tests only the wide children's boxes
needs to want the same leaves as the binary walk (phase A over the wide
table was measured so, PERF.md).
"""
import numpy as np
import pytest
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from idkengine_tpu.bvh.builder import BuildSettings as JBuildSettings  # noqa: E402
from idkengine_tpu.ops import trace as j_trace  # noqa: E402
from idkengine_tpu.scene.procedural import atrium as j_atrium  # noqa: E402
from idkengine_tpu.scene.procedural import cornell_box as j_cornell  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch.bvh.flatten import (MIN_LEAF_BITS, bvh4_nodes, leaf_bits,  # noqa: E402
                                             leaf_reference, thread_nodes)
from idkengine_tpu_torch.ops import trace as t_trace  # noqa: E402
from idkengine_tpu_torch.ops.intersect import ray_aabb, ray_triangle  # noqa: E402
from idkengine_tpu_torch.ops.trace import JAX_FIELDS, from_jax_scene_arrays  # noqa: E402
from idkengine_tpu_torch.ops.trace import inverse_direction  # noqa: E402

from test_torch_wide_bvh import _rays  # noqa: E402
from test_torch_trace import jax_core  # noqa: E402,F401

BENCH = dict(max_leaf_triangle_count=12, traversal_cost=4.0)
BUILDS = {  # name -> (model, build settings)
    "atrium": (lambda: j_atrium(8000), dict(BENCH, presplit_factor=0.0)),
    "cornell": (j_cornell, dict(BENCH, presplit_factor=0.0)),
    "atrium_presplit": (lambda: j_atrium(8000), dict(BENCH, presplit_factor=0.3)),
    # a high traversal cost makes the builder keep leaves above 32 triangles
    "atrium_leaf64": (lambda: j_atrium(8000), dict(max_leaf_triangle_count=64,
                                                   traversal_cost=40.0, presplit_factor=0.0)),
}


@pytest.fixture(scope="module", params=sorted(BUILDS))
def scene(request):
    model, settings = BUILDS[request.param]
    db = JSceneDatabase(JBuildSettings(**settings))
    db.add_model(model())
    jsc = db.build()
    arrays = {k: np.asarray(getattr(jsc, k)) for k in JAX_FIELDS}
    return request.param, jsc, arrays, from_jax_scene_arrays(arrays, jsc.max_leaf, "cpu")


def _decode(word, bits):
    c = ~np.asarray(word, np.int64)
    return c >> bits, (c & ((1 << bits) - 1)) + 1


def test_boxes_nest(scene):
    """Every interior node's two children lie within its box, bit for bit
    (f32 comparisons of the stored values): a walk that tests only the wide
    children's boxes wants the same leaves as the binary walk where this
    holds, since the slab test's (x - o) * inv is monotone in x."""
    _, _, a, _ = scene
    lo, hi, count, miss = a["node_min"], a["node_max"], a["node_count"], a["miss_link"]
    inner = np.nonzero(count == 0)[0]
    for child in (inner + 1, miss[inner + 1]):
        assert (lo[child] >= lo[inner]).all() and (hi[child] <= hi[inner]).all()


def test_leaf_bits_and_references(scene):
    """The fewest count bits (at least 5) that hold the largest leaf; the
    wide table's leaf references decode with them to the binary leaves."""
    name, _, a, sc = scene
    largest = int(a["node_count"].max())
    bits = sc.bvh4_leaf_bits
    assert bits == leaf_bits(a["node_count"]) >= MIN_LEAF_BITS
    assert largest <= 1 << bits and (bits == MIN_LEAF_BITS or largest > 1 << (bits - 1))
    if name == "atrium_leaf64":
        assert largest > 32 and bits == 6
    rec, child = sc.bvh4_nodes.numpy(), sc.bvh4_child.numpy()
    code = rec[:, 24:28]
    used = np.arange(4)[None, :] < rec[:, 28:29]
    leaf = used & (code < 0)
    first, count = _decode(code[leaf], bits)
    np.testing.assert_array_equal(first, a["node_first"][child[leaf]])
    np.testing.assert_array_equal(count, a["node_count"][child[leaf]])


def test_child_map(scene):
    """bvh4_child: (M,4) int32, each used entry the binary node whose box
    the record copies, -1 on empty slots; every binary leaf once."""
    _, _, a, sc = scene
    rec, child = sc.bvh4_nodes.numpy(), sc.bvh4_child
    assert child.dtype == torch.int32 and child.is_contiguous()
    child = child.numpy()
    assert child.shape == (rec.shape[0], 4)
    used = np.arange(4)[None, :] < rec[:, 28:29]
    np.testing.assert_array_equal(child >= 0, used)
    lo_bits = np.asarray(a["node_min"], np.float32).view(np.int32)
    hi_bits = np.asarray(a["node_max"], np.float32).view(np.int32)
    s = np.maximum(child, 0)
    for axis in range(3):
        np.testing.assert_array_equal(rec[:, 8 * axis:8 * axis + 4][used], lo_bits[s, axis][used])
        np.testing.assert_array_equal(rec[:, 8 * axis + 4:8 * axis + 8][used],
                                      hi_bits[s, axis][used])
    leaf = used & (rec[:, 24:28] < 0)
    np.testing.assert_array_equal(np.sort(child[leaf]), np.nonzero(a["node_count"] > 0)[0])


def test_threaded_records(scene):
    """bvh_thread: the threaded arrays' boxes bit for bit, their miss
    links, leaf word 0 for an interior node and the leaf reference of
    (first, count) for a leaf; 32-byte records."""
    _, _, a, sc = scene
    rec = sc.bvh_thread.numpy()
    assert rec.shape == (a["node_min"].shape[0], 8) and sc.bvh_thread.dtype == torch.int32
    np.testing.assert_array_equal(rec[:, 0:3], np.asarray(a["node_min"], np.float32).view(np.int32))
    np.testing.assert_array_equal(rec[:, 4:7], np.asarray(a["node_max"], np.float32).view(np.int32))
    np.testing.assert_array_equal(rec[:, 3], a["miss_link"])
    leaf = a["node_count"] > 0
    assert (rec[~leaf, 7] == 0).all() and (rec[leaf, 7] < 0).all()
    first, count = _decode(rec[leaf, 7], sc.bvh4_leaf_bits)
    np.testing.assert_array_equal(first, a["node_first"][leaf])
    np.testing.assert_array_equal(count, a["node_count"][leaf])
    # the hit link that is not stored: the next record, or the miss link at a leaf
    n = rec.shape[0]
    np.testing.assert_array_equal(np.where(leaf, rec[:, 3], np.arange(1, n + 1)), a["hit_link"])


def record_walk(sc, o, d, t_max, max_steps=None, any_hit=False):
    """trace_steps_kernel's walk of the threaded records, in plain PyTorch:
    (Hit, steps). With max_steps and any_hit, trace_capped_kernel's: at most
    max_steps records a ray, and the any-hit walk ends after the leaf that
    found an occluder."""
    rec = sc.bvh_thread
    box = rec[:, [0, 1, 2, 4, 5, 6]].contiguous().view(torch.float32)
    miss, word = rec[:, 3].long(), rec[:, 7].long()
    bits = sc.bvh4_leaf_bits
    r = o.shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32).expand(r).contiguous()
    inv_d = inverse_direction(d)
    t_best = t_max.clone()
    slot = torch.full((r,), -1, dtype=torch.int32)
    u, v = torch.zeros(r), torch.zeros(r)
    steps = torch.zeros(r, dtype=torch.int32)
    ids, ptr = torch.arange(r), torch.zeros(r, dtype=torch.long)
    while ids.numel() and (max_steps is None or int(steps[ids].max()) < max_steps):
        steps[ids] += 1
        hit, _ = ray_aabb(o[ids], inv_d[ids], box[ptr, :3], box[ptr, 3:], t_best[ids])
        w = word[ptr]
        lf = (hit & (w < 0)).nonzero().squeeze(1)
        if lf.numel():
            rid, code = ids[lf], ~w[lf]
            first, count = code >> bits, (code & ((1 << bits) - 1)) + 1
            for k in range(int(count.max())):  # in order, strict <, as the kernel
                has = k < count
                rk, s = rid[has], (first + k)[has]
                h, t, uu, vv = ray_triangle(o[rk], d[rk], sc.tri_p0[s], sc.tri_e1[s],
                                            sc.tri_e2[s])
                better = h & (t < t_best[rk])
                rb = rk[better]
                t_best[rb], slot[rb] = t[better], s[better].to(torch.int32)
                u[rb], v[rb] = uu[better], vv[better]
        nxt = torch.where(hit & (w == 0), ptr + 1, miss[ptr])
        if any_hit:
            nxt = torch.where(slot[ids] >= 0, -1, nxt)
        keep = nxt >= 0
        ids, ptr = ids[keep], nxt[keep]
    return t_trace.Hit(t=t_best, slot=slot, u=u, v=v), steps


def test_record_walk_matches_jax_steps(scene):
    """The record walk against the JAX package's trace_closest_steps and the
    port's plain version: steps, t, slot, u and v equal on every ray (rays
    from inside the box, axis-parallel, dead, t_max 0, and from 1e8)."""
    _, jsc, _, sc = scene
    o, d, t_max, far = _rays(sc, 1024, 7)
    got, steps = record_walk(sc, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max))
    want, want_steps = j_trace.trace_closest_steps(jsc, jnp.asarray(o), jnp.asarray(d),
                                                   jnp.asarray(t_max))
    np.testing.assert_array_equal(steps.numpy(), np.asarray(want_steps))
    for k in ("t", "slot", "u", "v"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    plain, plain_steps = t_trace.trace_closest_steps(sc, torch.from_numpy(o), torch.from_numpy(d),
                                                     torch.from_numpy(t_max))
    assert torch.equal(plain_steps, steps) and torch.equal(plain.slot, got.slot)
    assert (steps.numpy()[t_max < 0] == 1).all() and (got.slot.numpy()[far] >= 0).any()


def test_leaf_reference_refuses_beyond_the_slot_space():
    """A leaf of 600 triangles takes 10 count bits and leaves 2^21 slots: a
    leaf ending beyond them is refused with a message that names the slot
    space; one inside them decodes."""
    node_min = np.zeros((3, 3), np.float32)
    node_max = np.ones((3, 3), np.float32)
    count = np.int32([0, 600, 1])
    miss = np.int32([-1, 2, -1])
    bits = leaf_bits(count)
    assert bits == 10
    for first_right, fits in ((600, True), ((1 << 21) - 1, True), (1 << 21, False)):
        first = np.int32([-1, 0, first_right])
        if fits:
            rec, _, child = bvh4_nodes(node_min, node_max, first, count, miss, bits)
            np.testing.assert_array_equal(np.sort(_decode(rec[0, 24:26], bits)[1]), [1, 600])
            words = thread_nodes(node_min, node_max, first, count, miss, bits)
            np.testing.assert_array_equal(_decode(words[1:, 7], bits)[0], [0, first_right])
        else:
            with pytest.raises(ValueError, match="slot space"):
                bvh4_nodes(node_min, node_max, first, count, miss, bits)
            with pytest.raises(ValueError, match="slot space"):
                leaf_reference(first[1:], count[1:], bits)
