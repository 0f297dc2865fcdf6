"""Two-level (TLAS-path) instanced tracing against the JAX package.

The scene of tests/test_instancing.py (the Cornell box and two instances of
a sphere with a BLAS of its own), built by both packages. The port's plain
two-level traces on the JAX package's arrays (carried over with
from_jax_scene_arrays / instance_set_from_jax) equal the JAX package's
trace_closest_two_level and trace_any_two_level bit for bit on 64x64
camera rays and on random rays (t, slot, u, v, the instance id,
occlusion), uncapped and at max_steps=64; the port's own database makes
the JAX database's instance tables and TLAS. The instanced 48x48 path-traced
frame equals the JAX package's within RMSE 1e-3 and the baked scene as the
JAX test holds it (RMSE 3e-2, 2% of pixels). Moving an instance rebuilds
no BLAS; add_model_runtime joins the two-level path without the Engine."""
import dataclasses

import numpy as np
import pytest
import torch
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from idkengine_tpu.bvh.builder import TLAS as JTLAS  # noqa: E402
from idkengine_tpu.bvh.builder import BuildSettings as JBuildSettings  # noqa: E402
from idkengine_tpu.ops import trace as j_trace  # noqa: E402
from idkengine_tpu.render import Camera as JCamera  # noqa: E402
from idkengine_tpu.render import PathTracer as JPathTracer  # noqa: E402
from idkengine_tpu.render import PathTracerSettings as JSettings  # noqa: E402
from idkengine_tpu.render.camera import generate_rays as j_generate_rays  # noqa: E402
from idkengine_tpu.scene.model import Material as JMaterial  # noqa: E402
from idkengine_tpu.scene.model import MeshPrimitive as JMeshPrimitive  # noqa: E402
from idkengine_tpu.scene.model import Model as JModel  # noqa: E402
from idkengine_tpu.scene.model import Node as JNode  # noqa: E402
from idkengine_tpu.scene.procedural import cornell_box as j_cornell  # noqa: E402
from idkengine_tpu.scene.procedural import make_uv_sphere as j_sphere  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch.bvh.builder import TLAS, BuildSettings, tlas_nodes_numpy  # noqa: E402
from idkengine_tpu_torch.ops import packet_trace  # noqa: E402
from idkengine_tpu_torch.ops import trace as plain  # noqa: E402
from idkengine_tpu_torch.ops.trace import (JAX_FIELDS, from_jax_scene_arrays,  # noqa: E402
                                           instance_set_from_jax)
from idkengine_tpu_torch.render import (Camera, PathTracer, PathTracerPipeline,  # noqa: E402
                                        PathTracerSettings, PtPipelineSettings)
from idkengine_tpu_torch.render.camera import generate_rays  # noqa: E402
from idkengine_tpu_torch.scene.model import Material, MeshPrimitive, Model, Node  # noqa: E402
from idkengine_tpu_torch.scene.procedural import cornell_box, make_uv_sphere  # noqa: E402
from idkengine_tpu_torch.scene.scene_db import SceneDatabase  # noqa: E402

from test_torch_trace import jax_core  # noqa: E402,F401

RES = 48
RMSE_MAX = 1e-3
BUILD = dict(max_leaf_triangle_count=12, traversal_cost=4.0)
LIGHT = ([278, 480, 279.5], [6, 6, 6], 45.0)
INSTANCES = (([150, 380, 250], 1.0), ([400, 380, 250], 1.5))
SETTINGS = dict(ray_depth=2, sky_strength=0.0)
GN_ULPS = 2.4e-7  # two units in the last place of a unit normal's component


def _mat(t, s=1.0):
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] *= s
    m[:3, 3] = t
    return m


def _sphere_model(jax_side: bool, radius=50.0):
    """tests/test_instancing.py:_sphere_model, of either package."""
    sphere, prim_t, model_t, node_t, mat_t = (
        (j_sphere, JMeshPrimitive, JModel, JNode, JMaterial) if jax_side
        else (make_uv_sphere, MeshPrimitive, Model, Node, Material))
    pos, idx = sphere([0.0, 0.0, 0.0], radius, n_lat=12, n_lon=16)
    prim = prim_t(positions=pos.astype(np.float32), indices=idx.astype(np.uint32), material=0)
    prim.ensure_normals()
    m = model_t(primitives=[prim], nodes=[node_t(mesh_primitives=[0])],
                materials=[mat_t(name="inst", base_color=np.array([0.9, 0.2, 0.2, 1],
                                                                  np.float32))])
    m.root_nodes.append(0)
    return m


def _instanced_db(jax_side: bool):
    """tests/test_instancing.py:_instanced_db (the port's on the CPU)."""
    db_t, bs_t, cornell = ((JSceneDatabase, JBuildSettings, j_cornell) if jax_side
                           else (SceneDatabase, BuildSettings, cornell_box))
    db = db_t(bs_t(**BUILD))
    db.add_model(cornell(emissive_quad=False))
    db.add_instanced_model(_sphere_model(jax_side),
                           np.stack([_mat(t, s) for t, s in INSTANCES]))
    if jax_side:
        db.build()
    else:
        db.build("cpu")
    db.lights.add(LIGHT[0], LIGHT[1], radius=LIGHT[2])
    return db


def _baked_db():
    """The port's scene with the instances baked into the merged BLAS."""
    db = SceneDatabase(BuildSettings(**BUILD))
    db.add_model(cornell_box(emissive_quad=False))
    for t, s in INSTANCES:
        db.add_model(_sphere_model(False), transform=_mat(t, s), hoist=False)
    db.build("cpu")
    db.lights.add(LIGHT[0], LIGHT[1], radius=LIGHT[2])
    return db


def _cam(jax_side: bool):
    cam_t = JCamera if jax_side else Camera
    return cam_t(position=np.array([278, 273, -800], np.float32), yaw=90.0, fov_y=38.0)


def _arrays(jscene):
    return {k: np.asarray(getattr(jscene, k)) for k in JAX_FIELDS}


@pytest.fixture(scope="module")
def jdb():
    return _instanced_db(True)


@pytest.fixture(scope="module")
def carried(jdb):
    """The JAX database's static scene and InstanceSet in the port (CPU)."""
    iset = jdb.instance_set()
    made = {}
    scenes = [made.setdefault(id(s), _arrays(s)) for s in iset.scenes]
    static = from_jax_scene_arrays(_arrays(jdb.device_scene), jdb.device_scene.max_leaf, "cpu")
    return static, instance_set_from_jax(
        scenes, iset.scenes[0].max_leaf, np.asarray(iset.inv), np.asarray(iset.boxes),
        np.asarray(iset.slot_off), np.asarray(iset.normal_mat), "cpu")


def _camera_rays(n):
    jo, jd = j_generate_rays(_cam(True).ray_params(n, n), n, n, jnp.zeros(2))
    return np.array(jo), np.array(jd)


def _random_rays(n, seed):
    """Rays from the box's inside and from outside towards the spheres, with
    dead rays and short limits."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([0, 0, -300], [556, 548, 560], (n, 3)).astype(np.float32)
    target = np.float32([t for t, _ in INSTANCES])[rng.integers(0, 2, n)]
    d = target + rng.normal(0, 60, (n, 3)) - o
    d[::3] = rng.standard_normal((len(d[::3]), 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_max = rng.choice(np.float32([-1.0, 30.0, 300.0, 3.4e38]), n, p=[0.1, 0.2, 0.3, 0.4])
    return o, d, t_max.astype(np.float32)


@pytest.mark.parametrize("max_steps", [None, 64])
@pytest.mark.parametrize("rays", ["camera", "random"])
def test_two_level_matches_jax(jdb, carried, rays, max_steps):
    """t, slot, u, v and the instance id bit-equal to the JAX package's
    two-level closest hit, occlusion to its two-level any-hit."""
    static, iset = carried
    if rays == "camera":
        o, d = _camera_rays(64)
        t_max = np.full(o.shape[0], 3.4e38, np.float32)
    else:
        o, d, t_max = _random_rays(4096, 5)
    jiset = jdb.instance_set()
    cap = {} if max_steps is None else {"max_steps": max_steps}
    jhit, jinst = j_trace.trace_closest_two_level(
        jdb.device_scene, jiset.scenes, jiset.inv, jiset.boxes, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t_max), slot_off=jiset.slot_off, **cap)
    to, td, tt = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max)
    for fn in (plain.trace_closest_two_level, packet_trace.trace_closest_two_level):
        hit, inst = fn(static, iset.scenes, iset.inv, iset.boxes, to, td, tt,
                       slot_off=iset.slot_off, max_steps=max_steps)
        for k in ("t", "slot", "u", "v"):
            np.testing.assert_array_equal(getattr(hit, k).numpy(), np.asarray(getattr(jhit, k)),
                                          err_msg=k)
        np.testing.assert_array_equal(inst.numpy(), np.asarray(jinst))
    jocc = np.asarray(j_trace.trace_any_two_level(
        jdb.device_scene, jiset.scenes, jiset.inv, jiset.boxes, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t_max), **cap))
    for fn in (plain.trace_any_two_level, packet_trace.trace_any_two_level):
        occ = fn(static, iset.scenes, iset.inv, iset.boxes, to, td, tt, max_steps=max_steps)
        np.testing.assert_array_equal(occ.numpy(), jocc)
    ids = np.asarray(jinst)
    if rays == "camera":
        assert (ids >= 0).sum() > 50 and (ids < 0).sum() > 500  # spheres and walls
    assert set(np.unique(ids)) == {-1, 0, 1}


def test_port_database_matches_jax(jdb):
    """The port's instanced build makes the JAX database's instance tables,
    slot offsets, attribute sources and TLAS."""
    db = _instanced_db(False)
    iset, jiset = db.instance_set(), jdb.instance_set()
    assert len(iset.scenes) == 2 and iset.scenes[0] is iset.scenes[1]
    for k in ("inv", "boxes", "slot_off", "normal_mat"):
        np.testing.assert_array_equal(getattr(iset, k).numpy(), np.asarray(getattr(jiset, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(db.tlas.nodes, jdb.tlas.nodes)
    for k in ("node_min", "node_max", "tri_p0", "tri_e1", "tri_e2", "tri_n"):
        np.testing.assert_array_equal(getattr(iset.scenes[0], k).numpy(),
                                      np.asarray(getattr(jiset.scenes[0], k)), err_msg=k)
    # the JAX package flattens an instanced model in numpy (its face normal
    # from np.cross and np.linalg.norm), its static scene under jit, which
    # the port's flatten rounds as: the two differ in the last place
    np.testing.assert_allclose(iset.scenes[0].tri_gn.numpy(), np.asarray(jiset.scenes[0].tri_gn),
                               rtol=0, atol=GN_ULPS)
    for src, jsrc in zip(db._inst_attr_srcs, jdb._inst_attr_srcs):
        for f in dataclasses.fields(src):
            np.testing.assert_allclose(getattr(src, f.name), getattr(jsrc, f.name), rtol=0,
                                       atol=GN_ULPS if f.name == "geom_normal" else 0)


def test_tlas_matches_jax_and_covers_boxes():
    """TLAS through the C++ tlas_build equals the JAX package's; it and the
    numpy median-split tree hold each box in one leaf under boxes that
    cover it."""
    rng = np.random.default_rng(2)
    lo = rng.uniform(-50, 50, (37, 3)).astype(np.float32)
    aabbs = np.concatenate([lo, lo + rng.uniform(0.1, 9, (37, 3)).astype(np.float32)], 1)
    nodes = TLAS(aabbs).nodes
    np.testing.assert_array_equal(nodes, JTLAS(aabbs).nodes)
    for tree in (nodes, tlas_nodes_numpy(aabbs)):
        leaves = tree[tree["count"] > 0]
        assert sorted(leaves["left_or_first"]) == list(range(37))
        stack = [0]
        while stack:
            i = stack.pop()
            if tree["count"][i] == 0:
                kids = [int(tree["left_or_first"][i]), int(tree["left_or_first"][i]) + 1]
                for c in kids:
                    assert (tree["min"][c] >= tree["min"][i]).all()
                    assert (tree["max"][c] <= tree["max"][i]).all()
                stack += kids
            else:
                b = aabbs[tree["left_or_first"][i]]
                assert (tree["min"][i] <= b[:3]).all() and (tree["max"][i] >= b[3:]).all()


def test_instanced_render_matches_jax_and_baked(jdb):
    """The instanced 48x48 frame: within RMSE 1e-3 of the JAX package's
    instanced frame, and of the baked scene as tests/test_instancing.py
    holds the JAX one. PathTracerPipeline hands the instances to its
    tracer."""
    jpt = JPathTracer(jdb.device_scene, jdb.materials.soa(), jdb.lights.soa(), RES, RES,
                      JSettings(**SETTINGS, use_packet_tracer=False),
                      instances=jdb.instance_set(), inst_attr_srcs=jdb._inst_attr_srcs)
    want = np.asarray(jpt.render_frame(_cam(True)))
    db = _instanced_db(False)
    settings = PathTracerSettings(**SETTINGS)
    pt = PathTracer(db.device_scene, db.materials.soa(), db.lights.soa(), RES, RES, settings,
                    instances=db.instance_set(), inst_attr_srcs=db._inst_attr_srcs,
                    device="cpu")
    got = pt.render_frame(_cam(False)).numpy()
    rmse = float(np.sqrt(np.mean((got - want) ** 2)))
    assert rmse <= RMSE_MAX, rmse
    assert pt.attr_table().shape[0] == db._inst_slot_off[-1] + db._inst_attr_srcs[-1].mat.shape[0]
    ref = _baked_db()
    baked = PathTracer(ref.device_scene, ref.materials.soa(), ref.lights.soa(), RES, RES,
                       settings, device="cpu").render_frame(_cam(False)).numpy()
    assert float(np.sqrt(np.mean((got - baked) ** 2))) <= 3e-2
    assert np.mean(np.abs(got - baked) > 1e-3) < 0.02
    pipe = PathTracerPipeline(db, RES, RES, settings, PtPipelineSettings(output="noisy"),
                              device="cpu")
    assert pipe.pt.instances is not None
    pipe.render_frame(_cam(False))
    assert torch.equal(pipe.pt.image(), pt.image())


def _instance_ids(db, n=96):
    cam = _cam(False)
    o, d = generate_rays(cam.ray_params(n, n), n, n, torch.zeros(n * n, 2))
    iset = db.instance_set()
    _, inst = packet_trace.trace_closest_two_level(
        db.device_scene, iset.scenes, iset.inv, iset.boxes, o.contiguous(), d.contiguous(),
        torch.full((n * n,), 3.4e38), slot_off=iset.slot_off)
    return inst.numpy()


def test_instance_transform_update_without_rebuild():
    db = _instanced_db(False)
    n_nodes = [b.nodes.shape[0] for b in db._inst_blas]
    builds = [b.build_ms for b in db._inst_blas]
    scenes = list(db._inst_scene_arrays)
    tlas = db.tlas
    before = _instance_ids(db)
    db.set_instance_transform(0, _mat([150, 5000, 250]))  # out of view
    after = _instance_ids(db)
    assert (before == 0).sum() > 20
    assert (after == 0).sum() == 0, "moved instance still visible"
    assert (after == 1).sum() >= (before == 1).sum() * 0.9
    assert [b.nodes.shape[0] for b in db._inst_blas] == n_nodes
    assert [b.build_ms for b in db._inst_blas] == builds
    assert all(a is b for a, b in zip(db._inst_scene_arrays, scenes))
    assert db.tlas is not tlas and db.tlas.nodes.shape[0] >= 3
    assert db.tlas.nodes["max"][0][1] >= 5000 - 50  # the TLAS holds the moved box


def test_runtime_model_add_incremental():
    """Adding a model after build() builds ONLY its own BLAS and joins the
    instance path (tests/test_instancing.py's case without the Engine)."""
    db = SceneDatabase(BuildSettings(**BUILD))
    db.add_model(cornell_box(emissive_quad=False))
    db.build("cpu")
    static_nodes, scene = db.meta.n_nodes, db.device_scene
    assert db.add_model_runtime(_sphere_model(False), _mat([278, 380, 250])) == 0
    assert db.meta.n_nodes == static_nodes and db.device_scene is scene
    iset = db.instance_set()
    assert len(iset.scenes) == 1
    o = torch.tensor([[278.0, 380.0, -800.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    hit, iid = packet_trace.trace_closest_two_level(
        db.device_scene, iset.scenes, iset.inv, iset.boxes, o, d, torch.full((1,), 3.4e38),
        slot_off=iset.slot_off)
    assert int(iid[0]) == 0 and abs(float(hit.t[0]) - 1000.0) < 2.0
    assert int(hit.slot[0]) >= int(db._slot_tri.shape[0])  # after the static slots
    assert db.add_model_runtime(_sphere_model(False, radius=20.0), _mat([100, 380, 250])) == 1
    iset2 = db.instance_set()
    assert len(iset2.scenes) == 2
    assert int(iset2.slot_off[1]) == int(iset2.slot_off[0]) + iset2.scenes[0].tri_p0.shape[0]
    # a tracer made now takes both models' rows
    pt = PathTracer(db.device_scene, db.materials.soa(), db.lights.soa(), 8, 8,
                    PathTracerSettings(**SETTINGS), instances=iset2,
                    inst_attr_srcs=db._inst_attr_srcs, device="cpu")
    assert pt.attr_table().shape[0] == int(iset2.slot_off[1]) + iset2.scenes[1].tri_p0.shape[0]


# The cases the card's two-level kernel must reproduce (its oracle is the
# plain loop, held here to the JAX package): a static quad with the same
# quad as instance 0 (a static hit at the instance's t) and two coincident
# sphere instances (1 and 2: equal t, the earlier wins); and, built with
# leaves above 32 triangles, a sphere instance whose BLAS has 6 count bits
# beside the static quad's 5.
EDGE_QUAD = (np.float32([[-3, -1, 0], [-1, -1, 0], [-1, 1, 0], [-3, 1, 0]]),
             np.uint32([[0, 1, 2], [0, 2, 3]]))
EDGE_SPHERE = [0.0, 0.0, 2.0]
EDGE_T_MAX = np.float32([3.4e38, 30.0, 2.5, -1.0, 0.0, -0.0])
LEAF40 = dict(max_leaf_triangle_count=40, traversal_cost=40.0, presplit_factor=0.0)


def _mesh_model(jax_side: bool, pos, idx):
    prim_t, model_t, node_t, mat_t = ((JMeshPrimitive, JModel, JNode, JMaterial) if jax_side
                                      else (MeshPrimitive, Model, Node, Material))
    prim = prim_t(positions=pos.astype(np.float32), indices=idx.astype(np.uint32), material=0)
    prim.ensure_normals()
    m = model_t(primitives=[prim], nodes=[node_t(mesh_primitives=[0])],
                materials=[mat_t(name="m", base_color=np.array([0.8, 0.8, 0.8, 1], np.float32))])
    m.root_nodes.append(0)
    return m


def _carry(db):
    """A JAX database's static scene and InstanceSet in the port (CPU)."""
    jiset = db.instance_set()
    made = {}
    scenes = [made.setdefault(id(s), _arrays(s)) for s in jiset.scenes]
    static = from_jax_scene_arrays(_arrays(db.device_scene), db.device_scene.max_leaf, "cpu")
    iset = instance_set_from_jax(scenes, jiset.scenes[0].max_leaf, np.asarray(jiset.inv),
                                 np.asarray(jiset.boxes), np.asarray(jiset.slot_off),
                                 np.asarray(jiset.normal_mat), "cpu")
    return db, static, iset


def _edge_db(build, sphere_res, sphere_count, quad_instance):
    db = JSceneDatabase(JBuildSettings(**build))
    db.add_model(_mesh_model(True, *EDGE_QUAD))
    if quad_instance:
        db.add_instanced_model(_mesh_model(True, *EDGE_QUAD), np.eye(4, dtype=np.float32)[None])
    pos, idx = j_sphere([0.0, 0.0, 0.0], 0.5, n_lat=sphere_res[0], n_lon=sphere_res[1])
    db.add_instanced_model(_mesh_model(True, pos, idx),
                           np.stack([_mat(EDGE_SPHERE)] * sphere_count))
    db.build()
    return _carry(db)


@pytest.fixture(scope="module")
def edge():
    """The tie scene: the quad, the quad as instance 0, two coincident
    spheres."""
    return _edge_db(BUILD, (12, 16), 2, True)


@pytest.fixture(scope="module")
def leafy():
    """The quad and one sphere instance with leaves above 32 triangles."""
    return _edge_db(LEAF40, (6, 8), 1, False)


def _edge_rays(n, seed):
    """Rays onto the quad, onto the spheres, from inside their box and
    anywhere, each t_max of EDGE_T_MAX (the first half live)."""
    rng = np.random.default_rng(seed)
    k = n // 4
    quad = np.stack([rng.uniform(-2.9, -1.1, k), rng.uniform(-0.9, 0.9, k),
                     np.full(k, -3.0)], 1)
    quad_d = np.tile([0.0, 0.0, 1.0], (k, 1)) + rng.normal(0, 0.01, (k, 3))
    pair = np.float32([0.0, 0.0, -3.0]) + rng.normal(0, 0.1, (k, 3))
    pair_d = np.float32(EDGE_SPHERE) + rng.normal(0, 0.2, (k, 3)) - pair
    inside = np.float32(EDGE_SPHERE) + rng.uniform(-0.49, 0.49, (k, 3))
    anywhere = rng.uniform([-4, -2, -4], [3, 2, 4], (n - 3 * k, 3))
    o = np.concatenate([quad, pair, inside, anywhere]).astype(np.float32)
    d = np.concatenate([quad_d, pair_d, rng.standard_normal((n - 2 * k, 3))])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_max = EDGE_T_MAX[rng.integers(0, len(EDGE_T_MAX), n)]
    t_max[:n // 2] = 3.4e38  # most rays live, to meet the ties
    return o, d, t_max


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _hold_to_jax(carried, o, d, t_max, max_steps):
    """The plain loop and the port's entry points bit-equal to the JAX
    package's two-level traces (t by its bits, so -0 stays -0). Returns
    JAX's (Hit, inst_id, occlusion) as numpy arrays."""
    jdb, static, iset = carried
    jiset = jdb.instance_set()
    cap = {} if max_steps is None else {"max_steps": max_steps}
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)
    jhit, jinst = j_trace.trace_closest_two_level(jdb.device_scene, jiset.scenes, jiset.inv,
                                                  jiset.boxes, jo, jd, jt,
                                                  slot_off=jiset.slot_off, **cap)
    jocc = np.asarray(j_trace.trace_any_two_level(jdb.device_scene, jiset.scenes, jiset.inv,
                                                  jiset.boxes, jo, jd, jt, **cap))
    args = (static, iset.scenes, iset.inv, iset.boxes, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(t_max))
    for fn in (plain.trace_closest_two_level, packet_trace.trace_closest_two_level):
        hit, inst = fn(*args, slot_off=iset.slot_off, max_steps=max_steps)
        np.testing.assert_array_equal(_bits(hit.t.numpy()), _bits(jhit.t))
        for k in ("slot", "u", "v"):
            np.testing.assert_array_equal(getattr(hit, k).numpy(), np.asarray(getattr(jhit, k)),
                                          err_msg=k)
        np.testing.assert_array_equal(inst.numpy(), np.asarray(jinst))
    for fn in (plain.trace_any_two_level, packet_trace.trace_any_two_level):
        np.testing.assert_array_equal(fn(*args, max_steps=max_steps).numpy(), jocc)
    return {k: np.asarray(getattr(jhit, k)) for k in ("t", "slot")}, np.asarray(jinst), jocc


@pytest.mark.parametrize("max_steps", [None, 64])
def test_two_level_edge_cases_match_jax(edge, max_steps):
    """_hold_to_jax on the tie scene, whose rays meet each case: a static
    hit at the same t as instance 0's keeps the static hit, the coincident
    instance 1 wins over 2, rays from inside the spheres' box hit them,
    dead rays and t_max 0 and -0 hit nothing and keep their t_max."""
    _, _, iset = edge
    o, d, t_max = _edge_rays(2048, 11)
    hit, inst, occ = _hold_to_jax(edge, o, d, t_max, max_steps)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    alone = []  # instances 0 and 2 traced alone: each finds the winner's t
    for i in (0, 2):
        lo, ld = plain.to_instance(iset.inv[i], to, td)
        alone.append(plain.trace_closest(iset.scenes[i], lo, ld, torch.from_numpy(t_max),
                                         max_steps=max_steps).t.numpy())
    quad_tie = (inst == -1) & (hit["slot"] >= 0) & (alone[0] == hit["t"])
    pair_tie = (inst == 1) & (alone[1] == hit["t"])
    assert quad_tie[:512].sum() > 100 and pair_tie[512:1024].sum() > 100
    assert not (inst == 2).any()
    assert (inst[1024:1536] >= 1).sum() > 100  # from inside the spheres' box
    dead = ~(t_max > 0)
    assert dead.sum() > 50 and (hit["slot"][dead] == -1).all() and not occ[dead].any()
    np.testing.assert_array_equal(_bits(hit["t"][dead]), _bits(t_max[dead]))


def test_two_level_leaf_bits_differ_match_jax(leafy):
    """_hold_to_jax where the static scene's leaves take 5 count bits and
    the instance's 6 (a leaf of more than 32 triangles)."""
    _, static, iset = leafy
    assert static.bvh4_leaf_bits == 5 and iset.scenes[0].bvh4_leaf_bits == 6
    _, inst, _ = _hold_to_jax(leafy, *_edge_rays(1024, 13), None)
    assert (inst == 0).sum() > 100


def test_two_level_without_instances_matches_jax(edge):
    """I = 0: the two-level traces are the static scene's traces."""
    jdb, static, _ = edge
    o, d, t_max = _edge_rays(512, 12)
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)
    jinv, jboxes = jnp.zeros((0, 3, 4)), jnp.zeros((0, 2, 3))
    jhit, jinst = j_trace.trace_closest_two_level(jdb.device_scene, (), jinv, jboxes, jo, jd, jt,
                                                  slot_off=jnp.zeros((0,), jnp.int32))
    jocc = np.asarray(j_trace.trace_any_two_level(jdb.device_scene, (), jinv, jboxes, jo, jd,
                                                  jt))
    args = (static, [], torch.zeros((0, 3, 4)), torch.zeros((0, 2, 3)), torch.from_numpy(o),
            torch.from_numpy(d), torch.from_numpy(t_max))
    hit, inst = packet_trace.trace_closest_two_level(
        *args, slot_off=torch.zeros(0, dtype=torch.int32))
    np.testing.assert_array_equal(_bits(hit.t.numpy()), _bits(jhit.t))
    np.testing.assert_array_equal(hit.slot.numpy(), np.asarray(jhit.slot))
    assert (inst.numpy() == -1).all() and (np.asarray(jinst) == -1).all()
    assert (hit.slot.numpy() >= 0).any()
    np.testing.assert_array_equal(packet_trace.trace_any_two_level(*args).numpy(), jocc)


def test_two_level_wrappers_refuse_mismatched_instances(carried):
    """inv, boxes and slot_off of another instance count, or of the wrong
    type, and a scene list of another length raise before any trace."""
    static, iset = carried
    o, d = torch.zeros((4, 3)), torch.tensor([[0.0, 0.0, 1.0]] * 4)
    good = dict(inst_scenes=iset.scenes, inst_inv=iset.inv, inst_boxes=iset.boxes)
    bad = [dict(good, inst_inv=iset.inv[:1]), dict(good, inst_boxes=iset.boxes[:1]),
           dict(good, inst_scenes=iset.scenes[:1]), dict(good, inst_inv=iset.inv.double()),
           dict(good, inst_boxes=iset.boxes.reshape(2, 3, 2)),
           dict(good, inst_inv=iset.inv.transpose(1, 2).contiguous().transpose(1, 2))]
    for kw in bad:
        for fn in (packet_trace.trace_closest_two_level, packet_trace.trace_any_two_level):
            with pytest.raises((ValueError, TypeError)):
                fn(static, o=o, d=d, t_max=3.4e38, **kw)
    for slot_off in (iset.slot_off[:1], iset.slot_off.long(), iset.slot_off.float()):
        with pytest.raises((ValueError, TypeError)):
            packet_trace.trace_closest_two_level(static, o=o, d=d, t_max=3.4e38,
                                                 slot_off=slot_off, **good)
    hit, inst = packet_trace.trace_closest_two_level(static, o=o, d=d, t_max=3.4e38,
                                                     slot_off=iset.slot_off, **good)
    assert hit.t.shape == inst.shape == (4,)
