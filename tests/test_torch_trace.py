"""Port's plain trace vs the JAX package's traces on the same BVH and rays:
the stackless XLA trace and kernel K1 (whole-table packet kernel, in
interpret mode as the JAX package's own tests run it). Kernel K2 is in
test_torch_steered.py.

Tolerance: slots equal on at least 99.9% of rays; where slots differ, both
traces hit at the same t (a tie: the same surface point on two triangles,
met in another order); t within 1e-5 relative.

`jax_bvh_core` (and the autouse fixture `jax_core`, imported by every
port test module that builds a JAX scene or BLAS) loads the JAX package's
native BVH core before the module's first JAX build; see its docstring.
"""
import fcntl
import os
import time

import numpy as np
import pytest
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from idkengine_tpu.bvh import builder as j_builder  # noqa: E402
from idkengine_tpu.bvh.builder import BuildSettings as JBuildSettings  # noqa: E402
from idkengine_tpu.ops import packet_trace as j_pt  # noqa: E402
from idkengine_tpu.ops import trace as j_trace  # noqa: E402
from idkengine_tpu.scene.procedural import atrium as j_atrium  # noqa: E402
from idkengine_tpu.scene.procedural import cornell_box as j_cornell  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch.ops import packet_trace as t_pt  # noqa: E402
from idkengine_tpu_torch.ops.trace import JAX_FIELDS, from_jax_scene_arrays  # noqa: E402

BENCH = JBuildSettings(max_leaf_triangle_count=12, traversal_cost=4.0, presplit_factor=0.0)
T_REL = 1e-5
SLOT_AGREE = 0.999
JAX_CORE_LOCK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "build", "jax_bvh_core.lock")
JAX_CORE_WAIT_S = 120.0


def jax_bvh_core(wait_s: float = JAX_CORE_WAIT_S, poll_s: float = 0.5):
    """Load the JAX package's native BVH core before a comparison builds a
    JAX scene. The reference compiles its core on first use, in place
    (`make`, then `ctypes.CDLL`; idkengine_tpu/bvh/builder.py `_load`), and
    where the build fails it builds every tree with a numpy median split
    (`_build_fallback`) whose slots are not the port's. Workers of a
    parallel test run race there: one may load a library another is still
    writing, or see its own `make` fail. So the port's workers take the
    core one at a time (an fcntl.flock on build/jax_bvh_core.lock), and
    each retries while the library is missing or fails to load, for at
    most `wait_s` seconds; then this raises with the reason. A comparison
    never runs against the fallback tree."""
    os.makedirs(os.path.dirname(JAX_CORE_LOCK), exist_ok=True)
    deadline = time.monotonic() + wait_s
    reason = "another test worker held build/jax_bvh_core.lock"
    with open(JAX_CORE_LOCK, "a") as lock:
        while True:
            try:
                fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() >= deadline:
                    raise RuntimeError(f"the JAX package's BVH core is not available after "
                                       f"{wait_s:g} s: {reason}") from None
                time.sleep(min(poll_s, 0.05))
        try:
            while True:
                try:
                    if j_builder.native_available():
                        return
                    reason = "its native build (make) failed"
                except OSError as e:  # a library another worker is still writing
                    reason = f"its library did not load ({e})"
                if time.monotonic() >= deadline:
                    break
                time.sleep(poll_s)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    raise RuntimeError(f"the JAX package's BVH core is not available after {wait_s:g} s: "
                       f"{reason}; its numpy fallback tree would not match the port's slots")


@pytest.fixture(scope="module", autouse=True)
def jax_core():
    """Before the module's first JAX build: jax_bvh_core()."""
    jax_bvh_core()


def _port_scene(jsc):
    return from_jax_scene_arrays({k: np.asarray(getattr(jsc, k)) for k in JAX_FIELDS},
                                 jsc.max_leaf, "cpu")


def _rays(sc, n, seed):
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(sc.node_min[0]), np.asarray(sc.node_max[0])
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _assert_same_hits(port_hit, ref_t, ref_slot):
    ps, pt = port_hit.slot.numpy(), port_hit.t.numpy()
    rs, rt = np.asarray(ref_slot), np.asarray(ref_t)
    np.testing.assert_array_equal(ps >= 0, rs >= 0)
    hit = rs >= 0
    assert hit.mean() > 0.2, "rays should mostly hit"
    assert (ps == rs).mean() >= SLOT_AGREE
    np.testing.assert_allclose(pt[hit], rt[hit], rtol=T_REL, atol=0)


@pytest.fixture(scope="module")
def atrium_db():
    db = JSceneDatabase(BENCH)
    db.add_model(j_atrium(8000))
    return db, db.build()


def test_plain_matches_jax_trace(atrium_db):
    _, jsc = atrium_db
    sc = _port_scene(jsc)
    o, d = _rays(jsc, 4096, 1)
    want = j_trace.trace_closest(jsc, jnp.asarray(o), jnp.asarray(d),
                                 jnp.full((len(o),), 3.4e38, jnp.float32))
    got = t_pt.trace_closest(sc, torch.from_numpy(o), torch.from_numpy(d), 3.4e38)
    _assert_same_hits(got, want.t, want.slot)
    # barycentrics of the same hit agree too
    same = got.slot.numpy() == np.asarray(want.slot)
    np.testing.assert_allclose(got.u.numpy()[same], np.asarray(want.u)[same], atol=1e-5)
    occ_want = j_trace.trace_any(jsc, jnp.asarray(o), jnp.asarray(d), 15.0)
    occ_got = t_pt.trace_any(sc, torch.from_numpy(o), torch.from_numpy(d), 15.0)
    np.testing.assert_array_equal(occ_got.numpy(), np.asarray(occ_want))


def test_dead_rays_and_t_max(atrium_db):
    _, jsc = atrium_db
    sc = _port_scene(jsc)
    o, d = _rays(jsc, 512, 2)
    t_max = np.where(np.arange(512) % 2 == 0, -1.0, 3.0).astype(np.float32)
    hit = t_pt.trace_closest(sc, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max))
    dead = t_max < 0
    assert (hit.slot.numpy()[dead] == -1).all()
    np.testing.assert_array_equal(hit.t.numpy()[dead], -1.0)
    live = hit.slot.numpy() >= 0
    assert (hit.t.numpy()[live] < 3.0).all()
    occ = t_pt.trace_any(sc, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max))
    assert not occ.numpy()[dead].any()
    np.testing.assert_array_equal(occ.numpy(), live)


def test_plain_matches_k1_interpret():
    """Cornell box, whole-table packet kernel K1 (interpret mode), following
    the JAX package's test_closest_matches_cpu / test_any_hit_matches_cpu."""
    db = JSceneDatabase(BENCH)
    db.add_model(j_cornell())
    jsc = db.build()
    assert isinstance(db.packet_scene, j_pt.PacketScene)
    sc = _port_scene(jsc)
    rs = np.random.RandomState(3)
    n = 1024
    verts = np.asarray(jsc.tri_p0)
    o = (verts.mean(0) + rs.randn(n, 3) * 300).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = j_pt.packet_trace_closest(db.packet_scene, jnp.asarray(o), jnp.asarray(d),
                                     jnp.full((n,), 1e30, jnp.float32), interpret=True)
    got = t_pt.trace_closest(sc, torch.from_numpy(o), torch.from_numpy(d), 1e30)
    _assert_same_hits(got, want.t, want.slot)
    occ_want = j_pt.packet_trace_any(db.packet_scene, jnp.asarray(o), jnp.asarray(d),
                                     jnp.full((n,), 250.0, jnp.float32), interpret=True)
    occ_got = t_pt.trace_any(sc, torch.from_numpy(o), torch.from_numpy(d), 250.0)
    np.testing.assert_array_equal(occ_got.numpy(), np.asarray(occ_want))


def test_cpu_tensors_take_the_plain_version(atrium_db):
    """The dispatch runs the plain version for CPU tensors and counts no
    kernel launch."""
    _, jsc = atrium_db
    sc = _port_scene(jsc)
    o, d = _rays(jsc, 64, 3)
    before = (t_pt.trace_closest.launches, t_pt.trace_any.launches)
    t_pt.trace_closest(sc, torch.from_numpy(o), torch.from_numpy(d), 3.4e38)
    t_pt.trace_any(sc, torch.from_numpy(o), torch.from_numpy(d), 15.0)
    assert (t_pt.trace_closest.launches, t_pt.trace_any.launches) == before


def test_jax_core_guard_loads_the_core():
    jax_bvh_core(wait_s=5.0)
    assert j_builder.native_available()


def test_jax_core_guard_fails_without_the_core(monkeypatch):
    """Where the JAX package's core cannot be had, the guard raises with its
    reason after its bounded wait: no comparison against the fallback tree."""
    monkeypatch.setattr(j_builder, "native_available", lambda: False)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="BVH core is not available.*make.*fallback"):
        jax_bvh_core(wait_s=0.3, poll_s=0.1)
    assert time.monotonic() - t0 < 10.0
