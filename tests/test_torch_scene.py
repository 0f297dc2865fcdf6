"""Port vs JAX package: SceneDatabase.build gives the same BVH, slot order
and triangle arrays, and the CUDA kernel's node layout describes that tree."""
import numpy as np
import pytest
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")

from idkengine_tpu.bvh.builder import BuildSettings as JBuildSettings  # noqa: E402
from idkengine_tpu.scene.procedural import atrium as j_atrium  # noqa: E402
from idkengine_tpu.scene.procedural import cornell_box as j_cornell  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch.bvh.builder import BuildSettings  # noqa: E402
from idkengine_tpu_torch.ops.trace import JAX_FIELDS, from_jax_scene_arrays  # noqa: E402
from idkengine_tpu_torch.scene.procedural import atrium, cornell_box  # noqa: E402
from idkengine_tpu_torch.scene.scene_db import SceneDatabase  # noqa: E402

from test_torch_trace import jax_core  # noqa: E402,F401

BENCH = dict(max_leaf_triangle_count=12, traversal_cost=4.0, presplit_factor=0.0)
EXACT = ("node_min", "node_max", "node_first", "node_count", "hit_link",
         "miss_link", "tri_p0", "tri_e1", "tri_e2", "tri_uv", "tri_mat")


def _jax_db(scene, settings):
    db = JSceneDatabase(None if settings is None else JBuildSettings(**settings))
    db.add_model(j_atrium(8000) if scene == "atrium" else j_cornell(emissive_quad=False))
    return db, db.build()


def _port_db(scene, settings):
    db = SceneDatabase(None if settings is None else BuildSettings(**settings))
    db.add_model(atrium(8000) if scene == "atrium" else cornell_box(emissive_quad=False))
    return db, db.build("cpu")


@pytest.fixture(scope="module", params=[("atrium", BENCH), ("cornell", None)],
                ids=["atrium8000-bench", "cornell-default"])
def both(request):
    scene, settings = request.param
    jdb, jsc = _jax_db(scene, settings)
    pdb, psc = _port_db(scene, settings)
    return jdb, jsc, pdb, psc


def test_build_matches_jax(both):
    jdb, jsc, pdb, psc = both
    for k in EXACT:
        np.testing.assert_array_equal(getattr(psc, k).numpy(), np.asarray(getattr(jsc, k)),
                                      err_msg=k)
    # normals: numpy encode (port) vs the JAX package's device encode; face
    # normals: numpy vs XLA norm, one rounding apart at most
    pn, jn = psc.tri_n.numpy(), np.asarray(jsc.tri_n).astype(np.int64)
    assert (pn == jn).mean() >= 0.999
    np.testing.assert_allclose(psc.tri_gn.numpy(), np.asarray(jsc.tri_gn), atol=1e-6, rtol=0)
    assert psc.max_leaf == jsc.max_leaf
    np.testing.assert_array_equal(pdb.materials.soa()["base_color"],
                                  jdb.materials.soa()["base_color"])
    assert pdb.meta.n_triangles == jdb.meta.n_triangles
    assert pdb.meta.n_nodes == jdb.meta.n_nodes


def test_from_jax_scene_arrays_round_trip(both):
    _, jsc, _, psc = both
    sc = from_jax_scene_arrays({k: np.asarray(getattr(jsc, k)) for k in JAX_FIELDS},
                               jsc.max_leaf, "cpu")
    for k in EXACT:
        np.testing.assert_array_equal(getattr(sc, k).numpy(), getattr(psc, k).numpy())
    np.testing.assert_array_equal(sc.bvh_nodes.numpy(), psc.bvh_nodes.numpy())
    assert sc.bvh_depth == psc.bvh_depth


def test_kernel_layout_describes_tree(both):
    _, _, pdb, sc = both
    rec = sc.bvh_nodes.numpy()
    count = sc.node_count.numpy()
    assert sc.bvh_depth == pdb.blas.max_depth
    np.testing.assert_array_equal(rec[:, 0:3].view(np.float32), sc.node_min.numpy())
    np.testing.assert_array_equal(rec[:, 4:7].view(np.float32), sc.node_max.numpy())
    np.testing.assert_array_equal(rec[:, 7], count)
    leaf = count > 0
    np.testing.assert_array_equal(rec[leaf, 3], sc.node_first.numpy()[leaf])
    # interior: left child = next record, right child after the left subtree;
    # both children lie inside the parent's box
    inner = np.nonzero(~leaf)[0]
    left, right = inner + 1, rec[inner, 3]
    np.testing.assert_array_equal(right, sc.miss_link.numpy()[left])
    lo, hi = sc.node_min.numpy(), sc.node_max.numpy()
    for c in (left, right):
        assert (lo[c] >= lo[inner] - 1e-6).all() and (hi[c] <= hi[inner] + 1e-6).all()
    # every slot lies in exactly one leaf
    covered = np.zeros(sc.tri_p0.shape[0], np.int64)
    for f, n in zip(sc.node_first.numpy()[leaf], count[leaf]):
        covered[f:f + n] += 1
    assert (covered == 1).all()
