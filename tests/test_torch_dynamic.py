"""Scene dynamics against the JAX package and the C++ host refit.

- The device refit (render/dynamic.py) of the 3,000-triangle atrium under a
  seeded displacement: its boxes bit-equal to the C++ host refit's, every
  record table (binary, threaded, 4-wide through bvh4_child) holding those
  boxes with its topology words unchanged, tri_vec the slot triangles, the
  refitted records walked as the kernels walk them; and bit-equal to the
  JAX package's DeviceRefitter (boxes, p0, e1, e2, face and corner normals).
- BLAS.refit against refit_nodes_numpy and the JAX package's, bit for bit.
- SceneDatabase.update and update_device on tests/test_dynamic.py's
  animated Cornell box at t = 0.5 and 1.25 against the JAX package's (bit
  for bit where both round alike; update_device against update within the
  JAX test's tolerance); a trace on the updated scene against JAX's; a
  skinned model; refit_host.
- The JAX package's update_device applies a placement's build-time
  transform twice (a model added with a transform): shown here, not copied.
- The JAX Engine's path tracer keeps its build-time attribute tables after
  an update: shown for both packages' tracers.
- The animation sampler (STEP, LINEAR, slerp, CUBICSPLINE) and skinning
  against the JAX package on seeded inputs."""
import numpy as np
import pytest
import torch
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from idkengine_tpu.bvh.builder import BLAS as JBLAS  # noqa: E402
from idkengine_tpu.bvh.builder import BuildSettings as JBuildSettings  # noqa: E402
from idkengine_tpu.ops import trace as j_trace  # noqa: E402
from idkengine_tpu.render import PathTracer as JPathTracer  # noqa: E402
from idkengine_tpu.render import PathTracerSettings as JSettings  # noqa: E402
from idkengine_tpu.render import dynamic as j_dynamic  # noqa: E402
from idkengine_tpu.scene import animation as j_animation  # noqa: E402
from idkengine_tpu.scene import model as j_model  # noqa: E402
from idkengine_tpu.scene import skinning as j_skinning  # noqa: E402
from idkengine_tpu.scene.procedural import atrium as j_atrium  # noqa: E402
from idkengine_tpu.scene.procedural import cornell_box as j_cornell  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch.bvh.builder import BLAS, BuildSettings, refit_nodes_numpy  # noqa: E402
from idkengine_tpu_torch.ops import packet_trace  # noqa: E402
from idkengine_tpu_torch.ops.trace import JAX_FIELDS, from_jax_scene_arrays  # noqa: E402
from idkengine_tpu_torch.render import PathTracer, PathTracerSettings  # noqa: E402
from idkengine_tpu_torch.render.dynamic import DeviceRefitter, build_refit_plan  # noqa: E402
from idkengine_tpu_torch.scene import animation, model, skinning  # noqa: E402
from idkengine_tpu_torch.scene.procedural import atrium, cornell_box  # noqa: E402
from idkengine_tpu_torch.scene.scene_db import SceneDatabase  # noqa: E402

from test_torch_trace import jax_core  # noqa: E402,F401
from test_torch_walks import record_walk  # noqa: E402
from test_torch_wide_bvh import _rays, wide_walk  # noqa: E402

ATRIUM = dict(max_leaf_triangle_count=12, traversal_cost=4.0, presplit_factor=0.0)
CORNELL = dict(max_leaf_triangle_count=12, traversal_cost=4.0)
# update_device against update (a device product against numpy's): the
# tolerance of tests/test_dynamic.py
UPDATE_TOL = dict(rtol=1e-5, atol=1e-4)
GN_TOL = dict(rtol=1e-4, atol=1e-4)
SKIN_TOL = dict(rtol=1e-5, atol=1e-5)  # two einsums, summed in another order


def _displaced(verts):
    rng = np.random.default_rng(3)
    return verts + rng.normal(0, 0.05, verts.shape).astype(np.float32)


@pytest.fixture(scope="module")
def refitted():
    """The port's 3,000-triangle atrium, refitted on the CPU under a seeded
    displacement, beside the C++ host refit of the same vertices."""
    db = SceneDatabase(BuildSettings(**ATRIUM))
    db.add_model(atrium(3000))
    sc = db.build("cpu")
    verts = _displaced(db._verts)
    plan = build_refit_plan(db._flat, db._slot_tri, db._indices, ATRIUM["max_leaf_triangle_count"])
    new = DeviceRefitter(plan, sc).refit(sc, torch.from_numpy(verts),
                                         torch.from_numpy(db._normals))
    db.blas.refit(verts)
    db._flat.refresh_boxes(db.blas.nodes)
    return db, sc, new, verts


def test_device_refit_matches_host_refit(refitted):
    db, sc, new, verts = refitted
    flat = db._flat
    np.testing.assert_array_equal(new.node_min.numpy(), flat.node_min)
    np.testing.assert_array_equal(new.node_max.numpy(), flat.node_max)
    assert not np.array_equal(sc.node_min.numpy(), flat.node_min)  # the boxes moved
    lo, hi = flat.node_min.view(np.int32), flat.node_max.view(np.int32)
    for name in ("bvh_nodes", "bvh_thread"):
        rec, old = getattr(new, name).numpy(), getattr(sc, name).numpy()
        np.testing.assert_array_equal(rec[:, 0:3], lo, err_msg=name)
        np.testing.assert_array_equal(rec[:, 4:7], hi, err_msg=name)
        np.testing.assert_array_equal(rec[:, [3, 7]], old[:, [3, 7]], err_msg=name)
    wide, old = new.bvh4_nodes.numpy(), sc.bvh4_nodes.numpy()
    child = new.bvh4_child.numpy()
    np.testing.assert_array_equal(wide[:, 24:], old[:, 24:])
    for k in range(4):
        has = child[:, k] >= 0
        c = child[has, k]
        for a in range(3):
            np.testing.assert_array_equal(wide[has, 8 * a + k], lo[c, a])
            np.testing.assert_array_equal(wide[has, 8 * a + 4 + k], hi[c, a])
            # an empty child's words stay zero (-1 gathers no node)
            assert (wide[~has, 8 * a + k] == 0).all() and (wide[~has, 8 * a + 4 + k] == 0).all()
    p = verts[db._indices[db._slot_tri.astype(np.int64)]]
    e1, e2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    np.testing.assert_array_equal(
        new.tri_vec.numpy(), np.concatenate([p[:, 0], e1, e2, np.zeros_like(e1)], 1))
    np.testing.assert_array_equal(new.tri_p0.numpy(), p[:, 0])
    np.testing.assert_array_equal(new.tri_e1.numpy(), e1)
    np.testing.assert_array_equal(new.tri_e2.numpy(), e2)
    g = np.cross(e1.astype(np.float64), e2.astype(np.float64))
    np.testing.assert_allclose(new.tri_gn.numpy(), g / np.linalg.norm(g, axis=-1, keepdims=True),
                               rtol=0, atol=1e-5)
    for k in ("node_first", "node_count", "hit_link", "miss_link", "tri_uv", "tri_mat"):
        assert torch.equal(getattr(new, k), getattr(sc, k)), k
    assert torch.equal(sc.bvh4_nodes, torch.from_numpy(old))  # the input scene is untouched


def test_refitted_records_walk_as_the_kernels(refitted):
    """The refitted threaded records walked as the steps and capped kernels
    walk them give the plain trace's hits bit for bit; the refitted 4-wide
    records walked as the trace kernel walks them give them bit for bit on
    the rays from inside the scene, and the same hit mask on the rays from
    1e8 units away (there the walk's order picks among triangles whose t
    differ below a float's resolution, 9 of 2,048 rays before the refit as
    after it)."""
    _db, _sc, new, _verts = refitted
    o, d, t_max, far = _rays(new, 2048, 21)
    to, td, tt = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max)
    want = packet_trace.trace_closest(new, to, td, tt)
    walked, _ = record_walk(new, to, td, tt)
    for k in ("t", "slot", "u", "v"):
        assert torch.equal(getattr(walked, k), getattr(want, k)), k
    wide = wide_walk(new, to, td, tt)
    near = torch.from_numpy(~far)
    for k in ("t", "slot", "u", "v"):
        assert torch.equal(getattr(wide, k)[near], getattr(want, k)[near]), k
    assert torch.equal(wide.slot >= 0, want.slot >= 0)
    np.testing.assert_array_equal(wide_walk(new, to, td, tt, any_hit=True).numpy(),
                                  packet_trace.trace_any(new, to, td, tt).numpy())


def test_device_refit_matches_jax_refit():
    """On the JAX package's own atrium arrays, carried over: every refreshed
    array bit-equal to its DeviceRefitter's."""
    jdb = JSceneDatabase(JBuildSettings(**ATRIUM))
    jdb.add_model(j_atrium(3000))
    jsc = jdb.build()
    sc = from_jax_scene_arrays({k: np.asarray(getattr(jsc, k)) for k in JAX_FIELDS},
                               jsc.max_leaf, "cpu")
    plan = build_refit_plan(jdb._flat, jdb._slot_tri, jdb._indices, jsc.max_leaf)
    jplan = j_dynamic.build_refit_plan(jdb._flat, jdb._slot_tri, jdb._indices, jsc.max_leaf)
    np.testing.assert_array_equal(plan.leaf_gather, jplan.leaf_gather)
    assert len(plan.levels) == len(jplan.levels)
    for lv, jlv in zip(plan.levels, jplan.levels):
        for a, b in zip(lv, jlv):
            np.testing.assert_array_equal(np.sort(a), np.sort(b))
    verts = _displaced(jdb._verts)
    got = DeviceRefitter(plan, sc).refit(sc, torch.from_numpy(verts),
                                         torch.from_numpy(jdb._normals))
    want, _, _ = j_dynamic.DeviceRefitter(jplan, jsc).refit(jsc, jnp.asarray(verts),
                                                           jnp.asarray(jdb._normals))
    for k in ("node_min", "node_max", "tri_p0", "tri_e1", "tri_e2", "tri_gn", "tri_n"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)).astype(
                                          getattr(got, k).numpy().dtype), err_msg=k)


def test_blas_refit_matches_numpy_and_jax():
    m = cornell_box(emissive_quad=False)
    verts = np.concatenate([p.positions for p in m.primitives]).astype(np.float32)
    off = np.cumsum([0] + [p.positions.shape[0] for p in m.primitives])
    idx = np.concatenate([p.indices + o for p, o in zip(m.primitives, off)]).astype(np.uint32)
    settings = dict(max_leaf_triangle_count=2)
    blas, jblas = BLAS(verts, idx, BuildSettings(**settings)), JBLAS(verts, idx,
                                                                       JBuildSettings(**settings))
    moved = _displaced(verts * 0.01)
    nodes = blas.nodes.copy()
    build_ms = blas.build_ms
    blas.refit(moved)
    jblas.refit(moved)
    refit_nodes_numpy(nodes, blas.tri_indices, moved, idx.reshape(-1, 3))
    for k in ("min", "max", "left_or_first", "count"):
        np.testing.assert_array_equal(blas.nodes[k], nodes[k], err_msg=k)
        np.testing.assert_array_equal(blas.nodes[k], jblas.nodes[k], err_msg=k)
    assert blas.build_ms == build_ms


def _animated(pkg, rest=None, rotate=False):
    """tests/test_dynamic.py:_animated_model of either package, optionally
    turning about y too; `rest` a (4,4) transform to add it with."""
    mdl, cornell = (j_model, j_cornell) if pkg == "jax" else (model, cornell_box)
    m = cornell(emissive_quad=False)
    times = np.array([0.0, 1.0, 2.0], np.float32)
    vals = np.array([[0, 0, 0], [0, 60, 0], [0, 0, 0]], np.float32)
    channels = [mdl.AnimationChannel(node=0, path="translation",
                                      sampler=mdl.AnimationSampler(times=times, values=vals))]
    if rotate:
        s = np.sin(np.radians(20.0) / 2)
        q = np.array([[0, 0, 0, 1], [0, s, 0, np.cos(np.radians(10.0))], [0, 0, 0, 1]],
                     np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        channels.append(mdl.AnimationChannel(
            node=0, path="rotation", sampler=mdl.AnimationSampler(times=times, values=q)))
    m.animations.append(mdl.Animation(name="bob", channels=channels))
    db = (JSceneDatabase(JBuildSettings(**CORNELL)) if pkg == "jax"
          else SceneDatabase(BuildSettings(**CORNELL)))
    db.add_model(m, transform=rest, hoist=False)
    if pkg == "jax":
        db.build()
    else:
        db.build("cpu")
    return db


def _rest():
    c, s = np.cos(np.radians(30.0)), np.sin(np.radians(30.0))
    r = np.eye(4, dtype=np.float32)
    r[[0, 0, 2, 2], [0, 2, 0, 2]] = [c, s, -s, c]
    r[:3, 3] = [40.0, 0.0, -25.0]
    return r


def _np(scene, k):
    return np.asarray(getattr(scene, k))


@pytest.mark.parametrize("t", [0.5, 1.25])
def test_update_matches_jax(t):
    """update and update_device on the animated Cornell box (translating and
    turning): the port's update bit-equal to the JAX package's in the boxes
    and triangles, its update_device bit-equal to JAX's update_device and
    within the JAX test's tolerance of update."""
    host, dev = _animated("port", rotate=True), _animated("port", rotate=True)
    jhost, jdev = _animated("jax", rotate=True), _animated("jax", rotate=True)
    s_host, s_dev = host.update(t), dev.update_device(t)
    j_host, j_dev = jhost.update(t), jdev.update_device(t)
    for k in ("node_min", "node_max", "tri_p0", "tri_e1", "tri_e2"):
        np.testing.assert_array_equal(_np(s_host, k), _np(j_host, k), err_msg=k)
        np.testing.assert_array_equal(_np(s_dev, k), _np(j_dev, k), err_msg=k)
        np.testing.assert_allclose(_np(s_dev, k), _np(j_host, k), err_msg=k, **UPDATE_TOL)
    np.testing.assert_allclose(_np(s_host, "tri_gn"), _np(j_host, "tri_gn"), rtol=0, atol=2.4e-7)
    np.testing.assert_array_equal(_np(s_dev, "tri_gn"), _np(j_dev, "tri_gn"))
    np.testing.assert_allclose(_np(s_dev, "tri_gn"), _np(j_host, "tri_gn"), **GN_TOL)
    assert (_np(s_dev, "tri_n") == _np(j_dev, "tri_n").astype(np.int64)).mean() >= 0.999
    # update_device's vertices stay beside the scene: the host refit of them
    # gives its boxes bit for bit
    dev.blas.refit(dev.device_vertices.numpy())
    dev._flat.refresh_boxes(dev.blas.nodes)
    np.testing.assert_array_equal(_np(s_dev, "node_min"), dev._flat.node_min)
    np.testing.assert_array_equal(_np(s_dev, "node_max"), dev._flat.node_max)


def test_update_device_rest_transform():
    """A model added with a transform: the JAX package's update_device
    applies it twice (its vertices are the build's world-space ones, moved
    by the animated node again); the port's holds to update."""
    t = 1.25
    j_host, j_dev = _animated("jax", _rest()).update(t), _animated("jax", _rest()).update_device(t)
    s_dev = _animated("port", _rest()).update_device(t)
    s_host = _animated("port", _rest()).update(t)
    assert np.abs(_np(j_dev, "tri_p0") - _np(j_host, "tri_p0")).max() > 10.0  # the fault
    for k in ("node_min", "node_max", "tri_p0"):
        np.testing.assert_allclose(_np(s_dev, k), _np(j_host, k), err_msg=k, **UPDATE_TOL)
        np.testing.assert_array_equal(_np(s_host, k), _np(j_host, k), err_msg=k)


def test_update_device_traces_as_jax():
    """A trace of the updated scene (peak displacement, +60 y) equals the
    JAX package's trace of its updated scene, and the picking ray hits the
    moved geometry as the host update's does."""
    sc = _animated("port").update_device(1.0)
    jsc = _animated("jax").update_device(1.0)
    o, d, t_max, _ = _rays(sc, 2048, 22)
    hit = packet_trace.trace_closest(sc, torch.from_numpy(o), torch.from_numpy(d),
                                     torch.from_numpy(t_max))
    jhit = j_trace.trace_closest(jsc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    for k in ("t", "slot", "u", "v"):
        np.testing.assert_array_equal(getattr(hit, k).numpy(), np.asarray(getattr(jhit, k)))
    po, pd = torch.tensor([[278.0, 333.0, -800.0]]), torch.tensor([[0.0, 0.0, 1.0]])
    pick = packet_trace.trace_closest(sc, po, pd, torch.full((1,), 3.4e38))
    host = packet_trace.trace_closest(_animated("port").update(1.0), po, pd,
                                      torch.full((1,), 3.4e38))
    assert int(pick.slot[0]) >= 0 and abs(float(pick.t[0]) - float(host.t[0])) < 1e-3


def _skinned(pkg):
    """A skinned strip bent by two joints, the second turning over time."""
    mdl = j_model if pkg == "jax" else model
    rng = np.random.default_rng(7)
    n = 40
    x = np.repeat(np.linspace(0, 10, n), 2).astype(np.float32)
    pos = np.stack([x, np.tile([0.0, 1.0], n), np.zeros(2 * n)], 1).astype(np.float32)
    idx = np.array([[2 * i, 2 * i + 1, 2 * i + 2] for i in range(n - 1)]
                   + [[2 * i + 1, 2 * i + 3, 2 * i + 2] for i in range(n - 1)], np.uint32)
    w1 = np.clip(pos[:, 0] / 10, 0, 1)
    weights = np.stack([1 - w1, w1, 0 * w1, 0 * w1], 1).astype(np.float32)
    joints = np.tile(np.array([0, 1, 0, 0], np.uint16), (2 * n, 1))
    prim = mdl.MeshPrimitive(positions=pos + rng.normal(0, 0.01, pos.shape).astype(np.float32),
                             indices=idx, joints=joints, weights=weights)
    prim.ensure_normals()
    nodes = [mdl.Node(name="mesh", mesh_primitives=[0], skin=0),
             mdl.Node(name="j0", children=[2]),
             mdl.Node(name="j1", parent=1, translation=np.float32([5, 0, 0]))]
    ibm = np.stack([np.eye(4), np.linalg.inv(mdl.Node(translation=np.float32([5, 0, 0]))
                                             .local_matrix())]).astype(np.float32)
    s = np.sin(np.radians(25.0))
    q = np.array([[0, 0, 0, 1], [0, 0, s, np.cos(np.radians(25.0))]], np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    anim = mdl.Animation(name="bend", channels=[mdl.AnimationChannel(
        node=2, path="rotation",
        sampler=mdl.AnimationSampler(times=np.float32([0, 1]), values=q))])
    m = mdl.Model(nodes=nodes, root_nodes=[0, 1], primitives=[prim],
                  materials=[mdl.Material()], animations=[anim],
                  skins=[mdl.Skin(joints=np.array([1, 2]), inverse_bind_matrices=ibm)])
    db = (JSceneDatabase(JBuildSettings(**CORNELL)) if pkg == "jax"
          else SceneDatabase(BuildSettings(**CORNELL)))
    db.add_model(m, hoist=False)
    if pkg == "jax":
        db.build()
    else:
        db.build("cpu")
    return db


def test_skinned_update_matches_jax():
    """A skinned model through update and update_device: both move the
    vertices as the JAX package's update does, within the skinning tolerance."""
    j_host = _skinned("jax").update(0.6)
    for s in (_skinned("port").update(0.6), _skinned("port").update_device(0.6)):
        for k in ("node_min", "node_max", "tri_p0", "tri_e1"):
            np.testing.assert_allclose(_np(s, k), _np(j_host, k), err_msg=k, **SKIN_TOL)
    assert np.abs(_np(j_host, "tri_p0") - _np(_skinned("jax").device_scene, "tri_p0")).max() > 0.5


def test_refit_host_matches_jax():
    db, jdb = SceneDatabase(BuildSettings(**ATRIUM)), JSceneDatabase(JBuildSettings(**ATRIUM))
    db.add_model(atrium(3000))
    jdb.add_model(j_atrium(3000))
    db.build("cpu")
    jdb.build()
    verts = _displaced(db._verts)
    got, want = db.refit_host(verts), jdb.refit_host(verts)
    for k in ("node_min", "node_max", "tri_p0", "tri_e1", "tri_e2"):
        np.testing.assert_array_equal(_np(got, k), _np(want, k), err_msg=k)


def test_attribute_tables_stay_stale_after_an_update():
    """The JAX Engine swaps its tracer's scene after an update and keeps its
    attribute tables (idkengine_tpu/engine.py:189-195): under a turn,
    shading reads the build-time face normals. The port's tracer mirrors it."""
    jdb, db = _animated("jax", rotate=True), _animated("port", rotate=True)
    jpt = JPathTracer(jdb.device_scene, jdb.materials.soa(), jdb.lights.soa(), 8, 8,
                      JSettings(ray_depth=1, use_packet_tracer=False))
    pt = PathTracer(db.device_scene, db.materials.soa(), db.lights.soa(), 8, 8,
                    PathTracerSettings(ray_depth=1), device="cpu")
    build_gn = db.device_scene.tri_gn.numpy()
    jpt.scene, pt.scene = jdb.update_device(0.5), db.update_device(0.5)
    n = build_gn.shape[0]
    jgn = np.asarray(jpt._attr)[:n, 6:9]  # the JAX table's face-normal channels
    gn = pt.attr_table()[:, 6:9].numpy()
    np.testing.assert_array_equal(gn, build_gn)
    np.testing.assert_allclose(jgn, build_gn, rtol=0, atol=2.4e-7)
    assert np.abs(pt.scene.tri_gn.numpy() - build_gn).max() > 0.05  # the scene turned


SAMPLERS = {
    "STEP": (4, "STEP"), "LINEAR": (3, "LINEAR"), "slerp": (4, "LINEAR"),
    "CUBICSPLINE": (3, "CUBICSPLINE")}


@pytest.mark.parametrize("kind", list(SAMPLERS))
def test_animation_sampler_matches_jax(kind):
    width, interp = SAMPLERS[kind]
    rng = np.random.default_rng(len(kind))
    times = np.sort(rng.uniform(0, 3, 6)).astype(np.float32)
    rows = 3 * len(times) if interp == "CUBICSPLINE" else len(times)
    values = rng.normal(0, 1, (rows, width)).astype(np.float32)
    if kind == "STEP":
        values /= np.linalg.norm(values, axis=1, keepdims=True)
    if kind == "slerp":
        values /= np.linalg.norm(values, axis=1, keepdims=True)
    s = model.AnimationSampler(times=times, values=values, interpolation=interp)
    js = j_model.AnimationSampler(times=times, values=values, interpolation=interp)
    for t in np.concatenate([[-1.0, 5.0], times, rng.uniform(0, 3, 40)]):
        np.testing.assert_array_equal(animation.sample(s, float(t)),
                                      j_animation.sample(js, float(t)))
    # channels into nodes and the hierarchy, looping past the duration
    path = {3: "translation", 4: "rotation"}[width] if kind != "STEP" else "rotation"
    m = model.Model(nodes=[model.Node(children=[1]), model.Node(parent=0)], root_nodes=[0],
                    animations=[model.Animation("a", [model.AnimationChannel(1, path, s)])])
    jm = j_model.Model(nodes=[j_model.Node(children=[1]), j_model.Node(parent=0)],
                       root_nodes=[0],
                       animations=[j_model.Animation("a", [j_model.AnimationChannel(1, path, js)])])
    for t in (0.7, 4.1):
        animation.apply_animation(m, m.animations[0], t)
        j_animation.apply_animation(jm, jm.animations[0], t)
        np.testing.assert_array_equal(animation.update_node_hierarchy(m),
                                      j_animation.update_node_hierarchy(jm))


def test_skinning_matches_jax():
    rng = np.random.default_rng(11)
    v, j = 700, 9
    trs = [model.Node(translation=rng.normal(0, 2, 3).astype(np.float32),
                      rotation=(q := rng.normal(0, 1, 4).astype(np.float32)) / np.linalg.norm(q))
           for _ in range(j)]
    transforms = np.stack([n.local_matrix() for n in trs])
    ibm = np.linalg.inv(np.stack([n.local_matrix() for n in trs[::-1]])).astype(np.float32)
    skin, jskin = (mdl.Skin(joints=np.arange(j), inverse_bind_matrices=ibm)
                   for mdl in (model, j_model))
    jm = skinning.joint_matrices(transforms, skin)
    np.testing.assert_array_equal(jm, j_skinning.joint_matrices(transforms, jskin))
    pos = rng.normal(0, 3, (v, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (v, 3)).astype(np.float32)
    joints = rng.integers(0, j, (v, 4)).astype(np.int32)
    w = rng.uniform(0, 1, (v, 4)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    got_p = skinning.skin_positions(*(torch.from_numpy(x) for x in (pos, joints, w, jm)))
    got_n = skinning.skin_normals(*(torch.from_numpy(x) for x in (nrm, joints, w, jm)))
    want_p = j_skinning.skin_positions(*(jnp.asarray(x) for x in (pos, joints, w, jm)))
    want_n = j_skinning.skin_normals(*(jnp.asarray(x) for x in (nrm, joints, w, jm)))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **SKIN_TOL)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), **SKIN_TOL)
