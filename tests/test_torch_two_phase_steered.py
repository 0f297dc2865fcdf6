"""Port's two-phase traversal (plain versions, CPU) vs the JAX package's
steered two-phase trace over a scene split into segments, whose phase A is
kernel K5b (in interpret mode), set up as the JAX package's
test_two_phase.py::TestSegmented. The port answers it with one whole-scene
two-phase trace.

With one steer slot (`k_steer=1`), packets that hit more than one of the
scene's 3 segments cannot steer them all, so the JAX trace's second pass
and backstop run too (with 3 slots every packet would cover every segment).
Interpret-mode compilation sets the file's time (about 30 s per entry point
on one core, growing with k_steer), whatever the ray count.

Tolerances: as test_torch_two_phase.py.
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
from idkengine_tpu_torch.ops import two_phase as tp  # noqa: E402

from test_torch_trace import BENCH, _port_scene, _rays, jax_core  # noqa: E402,F401
from test_torch_two_phase import D, assert_same_final_hits  # noqa: E402


@pytest.fixture(scope="module")
def steered():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IDK_WAVE_SEGS", "6")
        db = JSceneDatabase(BENCH)
        db.add_model(j_atrium(8000))
        jsc = db.build()
    ws = db.wave_set()
    assert ws is not None and ws.first_stack is not None and len(ws.segs) >= 3
    o, d = _rays(jsc, 1024, 16)
    tables = (ws.segs, ws.pairs_stack, ws.leaf_stack, ws.first_stack, ws.count_stack,
              ws.seg_min, ws.seg_max)
    return tables, _port_scene(jsc), o, d


def test_closest_matches_k5b_steered_interpret(steered):
    tables, sc, o, d = steered
    want = j_tp.two_phase_closest_steered(*tables, jnp.asarray(o), jnp.asarray(d),
                                          jnp.full((len(o),), 3.4e38, jnp.float32),
                                          interpret=True, rows=8, d_slots=D, k_steer=1)
    got = tp.two_phase_closest(sc, torch.from_numpy(o), torch.from_numpy(d), 3.4e38, D)
    assert_same_final_hits(got, want.t, want.slot)


def test_any_matches_k5b_steered_interpret(steered):
    tables, sc, o, d = steered
    want = j_tp.two_phase_any_steered(*tables, jnp.asarray(o), jnp.asarray(d),
                                      jnp.full((len(o),), 8.0, jnp.float32),
                                      interpret=True, rows=8, d_slots=D, k_steer=1)
    got = tp.two_phase_any(sc, torch.from_numpy(o), torch.from_numpy(d), 8.0, D)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
