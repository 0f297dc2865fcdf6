"""Port's plain trace vs the JAX package's steered packet kernels over a
scene split into segments, in interpret mode as the JAX package's own tests
run them: K2 (the steer loop, the default) and K4 (K unrolled steer slots,
a residual pass and a backstop; `STEER_LOOP = 0`). The port answers both
with one whole-scene trace.

Tolerance: as test_torch_trace.py.
"""
import numpy as np
import pytest
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from idkengine_tpu.ops import packet_trace as j_pt  # noqa: E402
from idkengine_tpu.scene.procedural import atrium as j_atrium  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu_torch.ops import packet_trace as t_pt  # noqa: E402

from test_torch_trace import BENCH, _assert_same_hits, _port_scene, _rays  # noqa: E402
from test_torch_trace import jax_core  # noqa: E402,F401


@pytest.fixture(scope="module")
def segmented():
    """Segmented atrium and rays sorted by segment-wave key, following the
    JAX package's test_wave_and_steered_match_chained."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IDK_WAVE_SEGS", "6")
        db = JSceneDatabase(BENCH)
        db.add_model(j_atrium(8000))
        jsc = db.build()
    assert db.wave_scene is not None and len(db.wave_scene) >= 2
    o, d = _rays(jsc, 1024, 7)
    tm = jnp.full((len(o),), 3.4e38, jnp.float32)
    smin, smax = jnp.asarray(db.wave_seg_min), jnp.asarray(db.wave_seg_max)
    lo = jnp.asarray(jsc.node_min[0])
    key = j_pt.segment_wave_key(jnp.asarray(o), jnp.asarray(d), tm, smin, smax, lo,
                                jnp.asarray(jsc.node_max[0]) - lo)
    perm = np.asarray(jnp.argsort(key))
    return db, _port_scene(jsc), o[perm], d[perm], smin, smax


def _check_steered(segmented, **steer):
    db, sc, o, d, smin, smax = segmented
    tables = (db.wave_scene, db.wave_pairs_stack, db.wave_leaf_stack, smin, smax)
    want = j_pt.packet_trace_closest_steered(
        *tables, jnp.asarray(o), jnp.asarray(d), jnp.full((len(o),), 3.4e38, jnp.float32),
        interpret=True, rows=8, **steer)
    got = t_pt.trace_closest(sc, torch.from_numpy(o), torch.from_numpy(d), 3.4e38)
    _assert_same_hits(got, want.t, want.slot)
    occ_want = j_pt.packet_trace_any_steered(
        *tables, jnp.asarray(o), jnp.asarray(d), jnp.full((len(o),), 15.0, jnp.float32),
        interpret=True, rows=8, **steer)
    occ_got = t_pt.trace_any(sc, torch.from_numpy(o), torch.from_numpy(d), 15.0)
    np.testing.assert_array_equal(occ_got.numpy(), np.asarray(occ_want))


def test_plain_matches_k2_steered_interpret(segmented):
    """K2, the steer loop (and the JAX package's any-hit steered kernel),
    following test_wave_and_steered_match_chained and
    test_any_wave_and_steered_match_chained."""
    _check_steered(segmented)


def test_plain_matches_k4_steered_unrolled_interpret(segmented):
    """K4, the unrolled steer slots, chosen with STEER_LOOP = 0 as the JAX
    package's test_wave_and_steered_match_chained does; the flag is read at
    trace time, so the jit caches are cleared around it. One steer slot
    instead of the default 8: packets that hit more than one of the 3
    segments then take the residual pass and the backstop too, and
    interpret-mode compilation, which grows with the unrolled slots, stays
    near half a minute per entry point on one core."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_pt, "STEER_LOOP", 0)
        j_pt.packet_trace_closest_steered.clear_cache()
        j_pt.packet_trace_any_steered.clear_cache()
        try:
            _check_steered(segmented, k_steer=1)
        finally:
            j_pt.packet_trace_closest_steered.clear_cache()
            j_pt.packet_trace_any_steered.clear_cache()
