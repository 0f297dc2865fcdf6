"""K3, the voxelizer's per-cell max-scatter, and the VXGI voxel grid: the
port against the JAX package on the CPU. The CUDA kernel is held against
its plain version on the card in tests/test_torch_cuda.py.

The max of a set of floats does not depend on the order it is taken in, so
the plain `scatter_max_dense` must equal the JAX kernel (Pallas interpret
mode) and the XLA oracle `zeros.at[:, cell].max(vals)` exactly, in f32 and
after bf16 rounding. The oracle wraps negative cell ids as numpy indices do,
while the kernel and the port drop them, so the oracle sees only the ids
in range.
"""
import numpy as np
import pytest
import torch
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from idkengine_tpu.ops.trace import trace_any as j_trace_any  # noqa: E402
from idkengine_tpu.ops.voxel_scatter import scatter_max_dense as j_scatter  # noqa: E402
from idkengine_tpu.render.vxgi import VoxelGrid as JVoxelGrid  # noqa: E402
from idkengine_tpu.render.vxgi import VxgiSettings as JVxgiSettings  # noqa: E402
from idkengine_tpu.scene.procedural import cornell_box as j_cornell  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch.ops import packet_trace  # noqa: E402
from idkengine_tpu_torch.ops import voxel_scatter as vs  # noqa: E402
from idkengine_tpu_torch.render.vxgi import VoxelGrid, VxgiSettings  # noqa: E402
from idkengine_tpu_torch.scene.procedural import cornell_box  # noqa: E402
from idkengine_tpu_torch.scene.scene_db import SceneDatabase  # noqa: E402

from test_torch_trace import jax_core  # noqa: E402,F401

LIGHT = ([278, 480, 279.5], [6, 6, 6], 45.0)
VX = dict(resolution=16, max_samples=4096)


def _updates(kind, seed=0):
    """(cell (N,) int32, vals (C,N) float32, n_cells) from a numpy seed."""
    rng = np.random.default_rng(seed)
    if kind == "random_with_out_of_range":
        n_cells = 2048
        cell = rng.integers(-300, n_cells + 300, 700)
        vals = rng.uniform(0, 10, (4, 700))
    elif kind == "one_cell":  # every update lands in one cell: the max wins, not a sum
        n_cells = 4096
        cell = np.full(999, 77)
        vals = np.linspace(0, 5, 999 * 2).reshape(2, 999)
    return cell.astype(np.int32), vals.astype(np.float32), n_cells


def _oracle(cell, vals, n_cells, bf16):
    keep = (cell >= 0) & (cell < n_cells)
    out = jnp.zeros((vals.shape[0], n_cells)).at[:, jnp.asarray(cell[keep])].max(
        jnp.asarray(vals[:, keep]))
    if bf16:
        out = out.astype(jnp.bfloat16).astype(jnp.float32)
    return np.asarray(out)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", ["random_with_out_of_range", "one_cell"])
def test_plain_equals_jax_kernel_and_oracle(kind, bf16):
    cell, vals, n_cells = _updates(kind)
    got = vs.scatter_max_dense(torch.from_numpy(cell), torch.from_numpy(vals), n_cells,
                               bf16=bf16).numpy()
    kernel = np.asarray(j_scatter(jnp.asarray(cell), jnp.asarray(vals), n_cells, bf16=bf16,
                                  interpret=True))
    np.testing.assert_array_equal(got, kernel)
    np.testing.assert_array_equal(got, _oracle(cell, vals, n_cells, bf16))


def test_plain_refuses_bad_shapes():
    with pytest.raises(ValueError):
        vs.scatter_max_dense(torch.zeros(5, dtype=torch.int32), torch.zeros(4, 6), 16)
    with pytest.raises(ValueError):
        vs.scatter_max_dense(torch.zeros(5, dtype=torch.int32), torch.zeros(5), 16)


# --------------------------------------------------------------------------
# VoxelGrid: voxelize, mips and cone tracing at resolution 16
# --------------------------------------------------------------------------

def _port_cornell(transform=None):
    db = SceneDatabase()
    db.add_model(cornell_box(emissive_quad=False), transform=transform)
    scene = db.build("cpu")
    db.lights.add(*LIGHT[:2], radius=LIGHT[2])
    mats = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in db.materials.soa().items()}
    soa = db.lights.soa()
    lights = {k: torch.from_numpy(soa[k]) for k in ("pos", "radius", "radiance")}
    return db, scene, mats, lights


def _grid_bounds(db):
    return db.blas.nodes["min"][0] - 0.1, db.blas.nodes["max"][0] + 0.1


@pytest.fixture(scope="module")
def grids():
    db, scene, mats, lights = _port_cornell()
    lo, hi = _grid_bounds(db)
    grid = VoxelGrid(lo, hi, VxgiSettings(**VX), device="cpu")
    grid.voxelize(scene, mats, lights, 1, frame=3,
                  occlusion_fn=lambda o, d, t: packet_trace.trace_any(scene, o, d, t))

    jdb = JSceneDatabase()
    jdb.add_model(j_cornell(emissive_quad=False))
    jscene = jdb.build()
    jdb.lights.add(*LIGHT[:2], radius=LIGHT[2])
    jmats = {k: jnp.asarray(v) for k, v in jdb.materials.soa().items()}
    jlights = {k: jnp.asarray(v) for k, v in jdb.lights.soa().items() if k != "count"}
    jgrid = JVoxelGrid(lo, hi, JVxgiSettings(**VX))
    jgrid.voxelize(jscene, jmats, jlights, 1, frame=3,
                   occlusion_fn=lambda o, d, t: j_trace_any(jscene, o, d, t))
    return grid, jgrid


def test_voxelize_matches_jax(grids):
    grid, jgrid = grids
    # the same samples, lit by the same float operations on the same CPU and
    # landed by an exact max: the grid and each mip level equal JAX's to
    # float32 rounding (the pooling sums 8 values, perhaps in another order)
    assert len(grid.mips) == len(jgrid.mips) == 3
    assert float(grid.radiance[3].sum()) > 0  # samples landed
    for got, want in zip(grid.mips, jgrid.mips):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(grid._atlas.numpy(), np.asarray(jgrid._atlas), rtol=1e-6, atol=1e-7)


def test_cone_trace_matches_jax(grids):
    grid, jgrid = grids
    rng = np.random.default_rng(5)
    lo, hi = grid._min_np, grid._max_np
    pts = rng.uniform(lo, hi, (512, 3)).astype(np.float32)
    nrm = rng.standard_normal((512, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    got = grid.cone_trace(torch.from_numpy(pts), torch.from_numpy(nrm), frame=2).numpy()
    want = np.asarray(jgrid.cone_trace(jnp.asarray(pts), jnp.asarray(nrm), frame=2))
    assert np.abs(want).max() > 0
    # 60 march steps of trilinear taps: float32 rounding accumulates
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    lod = torch.full((512,), 1.3)
    got = grid.sample_lod(torch.from_numpy(pts - lo) / torch.from_numpy(hi - lo), lod)
    want = jgrid.sample_lod(jnp.asarray((pts - lo) / (hi - lo)), jnp.full((512,), 1.3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_voxel_grid_follows_a_rebuilt_scene():
    """A rebuilt scene with the same triangle count but moved geometry: a
    grid that voxelized the old scene gives what a fresh grid gives."""
    db, scene, mats, lights = _port_cornell()
    lo, hi = _grid_bounds(db)
    grid = VoxelGrid(lo, hi, VxgiSettings(**VX), device="cpu")
    old = grid.voxelize(scene, mats, lights, 1, occlusion_fn=None).clone()

    squash = np.diag([1.0, 0.7, 0.9, 1.0]).astype(np.float32)
    db2, scene2, mats2, lights2 = _port_cornell(transform=squash)
    assert scene2.tri_p0.shape == scene.tri_p0.shape
    occ2 = lambda o, d, t: packet_trace.trace_any(scene2, o, d, t)  # noqa: E731
    reused = grid.voxelize(scene2, mats2, lights2, 1, occlusion_fn=occ2)
    fresh = VoxelGrid(lo, hi, VxgiSettings(**VX), device="cpu").voxelize(
        scene2, mats2, lights2, 1, occlusion_fn=occ2)
    assert not torch.equal(reused, old)
    assert torch.equal(reused, fresh)


def test_voxelize_refuses_scene_on_another_device():
    db, scene, mats, lights = _port_cornell()
    lo, hi = _grid_bounds(db)
    grid = VoxelGrid(lo, hi, VxgiSettings(**VX), device="meta")
    with pytest.raises(ValueError):
        grid.voxelize(scene, mats, lights, 1)
