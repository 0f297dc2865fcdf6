"""The port's ray-primitive arithmetic against the JAX package's as XLA:CPU
compiles it, down to the last bit, and the plain traces against the JAX
traces on rays from 1e8 units away.

XLA:CPU contracts `jnp.cross`'s `a1*b2 - a2*b1` into fma(a1, b2, -(a2*b1))
and a 3-term `jnp.sum(x*y)` into fma(x2, y2, fma(x1, y1, x0*y0));
ops/intersect.py computes that form with a fused multiply-add (`fma`),
which test_fma_rounds_once holds to exact rational arithmetic. At 1e8 units the f32 spacing
is 8 units and one rounding more or less moves a hit's t by thousands of
units, so before that form the port decided hits from far origins
differently from the JAX trace on 1.6% of the atrium's far rays and 20% of
a single quad's.

Tolerances: none (bit-equal on every ray).
"""
from fractions import Fraction

import numpy as np
import pytest
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from idkengine_tpu.ops import intersect as j_isect  # noqa: E402
from idkengine_tpu.ops import trace as j_trace  # noqa: E402
from idkengine_tpu_torch.ops import intersect as t_isect  # noqa: E402
from idkengine_tpu_torch.ops import trace as t_trace  # noqa: E402

from test_torch_wide_bvh import BENCH, MODELS, JSceneDatabase, _rays  # noqa: E402
from test_torch_wide_bvh import JAX_FIELDS, from_jax_scene_arrays  # noqa: E402
from test_torch_trace import jax_core  # noqa: E402,F401

N_PRIMITIVE = 100_000


def f32_round(x: Fraction) -> np.float32:
    """The float32 nearest to the exact value x, ties to even."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    best = min(abs(Fraction(float(c)) - x) for c in cands)
    near = [c for c in cands if abs(Fraction(float(c)) - x) == best]
    return min(near, key=lambda c: int(np.asarray(c).view(np.int32)) & 1)


def exact_fma(a, b, c) -> np.ndarray:
    """a * b + c of float32 arrays in exact rational arithmetic, rounded
    once to float32."""
    return np.array([f32_round(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)


def fma_cases(n: int, seed: int):
    """Random float32 triples, half of them cancelling (c = -(a*b) rounded,
    every fourth then moved one ulp): where a*b + c rounded twice and
    rounded once differ."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n).astype(np.float32) * np.float32(1e4)
    b = rng.standard_normal(n).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32) * np.float32(1e4)
    c[::2] = -(a[::2] * b[::2])
    c[1::4] = np.nextafter(c[1::4], np.float32(0))
    return a, b, c


def test_fma_rounds_once():
    """fma(a, b, c) is a*b + c rounded once to float32, against exact
    rational arithmetic (fma_cases), also on tensors of 7 elements (no
    vector loop) and on strided views."""
    a, b, c = fma_cases(4000, 11)
    got = t_isect.fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = exact_fma(a, b, c)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert not np.array_equal(want, a * b + c)  # the two roundings differ here
    small = t_isect.fma(*(torch.from_numpy(x[:7].copy()) for x in (a, b, c))).numpy()
    np.testing.assert_array_equal(small, want[:7])
    strided = t_isect.fma(*(torch.from_numpy(np.stack([x, x], 1))[:, 1] for x in (a, b, c)))
    np.testing.assert_array_equal(strided.numpy(), want)


def _triangle_rays(far: float, seed: int):
    rng = np.random.default_rng(seed)
    n = N_PRIMITIVE
    p0 = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    aim = p0 + rng.uniform(0, 0.5, (n, 1)).astype(np.float32) * e1 + \
        rng.uniform(0, 0.5, (n, 1)).astype(np.float32) * e2
    o = (aim - d * np.float32(far)).astype(np.float32)
    return o, d, p0, e1, e2


@pytest.mark.parametrize("far", [1e8, 3.0])
def test_ray_triangle_bit_equal_to_jitted_jax(far):
    """hit, t, u and v equal bit for bit on 100,000 seeded rays, from 1e8
    units away and from near the triangles."""
    args = _triangle_rays(far, 12)
    want = [np.asarray(x) for x in jax.jit(j_isect.ray_triangle)(*args)]
    got = [x.numpy() for x in t_isect.ray_triangle(*(torch.from_numpy(a) for a in args))]
    assert want[0].mean() > (0.005 if far > 1e6 else 0.5)  # from 1e8 most u, v err out
    for name, g, w in zip(("hit", "t", "u", "v"), got, want):
        np.testing.assert_array_equal(g.view(np.int32) if g.dtype == np.float32 else g,
                                      w.view(np.int32) if w.dtype == np.float32 else w,
                                      err_msg=name)


@pytest.fixture(scope="module", params=sorted(MODELS))
def scene(request):
    db = JSceneDatabase(BENCH)
    db.add_model(MODELS[request.param]())
    jsc = db.build()
    arrays = {k: np.asarray(getattr(jsc, k)) for k in JAX_FIELDS}
    return jsc, from_jax_scene_arrays(arrays, jsc.max_leaf, "cpu")


def test_plain_traces_equal_jax_traces(scene):
    """trace_closest, trace_any and trace_closest_steps (the JAX package's
    jitted while-loop traces) against the port's plain traces: the same hit
    mask, slots and steps, t, u and v bit-equal, on every ray; an eighth
    of the rays start 1e8 units away."""
    jsc, sc = scene
    o, d, t_max, far = _rays(sc, 4096, 14)
    oj, dj, tj = jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)
    ot, dt, tt = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max)
    want, want_steps = j_trace.trace_closest_steps(jsc, oj, dj, tj)
    got, steps = t_trace.trace_closest_steps(sc, ot, dt, tt)
    np.testing.assert_array_equal(steps.numpy(), np.asarray(want_steps))
    closest = t_trace.trace_closest(sc, ot, dt, tt)
    want_closest = j_trace.trace_closest(jsc, oj, dj, tj)
    for hit, ref in ((got, want), (closest, want_closest)):
        for k in ("slot", "t", "u", "v"):
            np.testing.assert_array_equal(getattr(hit, k).numpy(), np.asarray(getattr(ref, k)),
                                          err_msg=k)
    assert (closest.slot.numpy()[far] >= 0).any()
    np.testing.assert_array_equal(t_trace.trace_any(sc, ot, dt, tt).numpy(),
                                  np.asarray(j_trace.trace_any(jsc, oj, dj, tj)))
