"""Point-light cube shadow maps and the plain helpers they rest on, against
the JAX package: the camera's view and reverse-Z projection matrices, its
frustum, `collision.Frustum` and the separating-axis test, the cube faces'
directions and their inverse, the per-face culling, the ray-traced map
build on the Cornell box (res 16, with and without a face mask), the
21-tap PCF lookup and the manager's cache.

Tolerances: none where both packages run the same numpy code (the matrices,
the frusta, the SAT booleans) or the same float32 operations op by op (the
face directions, the maps, the PCF visibility: the JAX package runs these
eagerly, and the traces are bit-equal, tests/test_torch_trace.py)."""
import numpy as np
import pytest
import torch
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from idkengine_tpu import collision as j_collision  # noqa: E402
from idkengine_tpu.ops.trace import trace_closest as j_trace_closest  # noqa: E402
from idkengine_tpu.render import Camera as JCamera  # noqa: E402
from idkengine_tpu.render import shadowmap as j_shadowmap  # noqa: E402
from idkengine_tpu.scene.procedural import cornell_box as j_cornell  # noqa: E402
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase  # noqa: E402
from idkengine_tpu.utils import mathutil as j_mu  # noqa: E402
from idkengine_tpu_torch import collision  # noqa: E402
from idkengine_tpu_torch.ops import packet_trace  # noqa: E402
from idkengine_tpu_torch.ops.trace import JAX_FIELDS, from_jax_scene_arrays  # noqa: E402
from idkengine_tpu_torch.render import Camera, shadowmap  # noqa: E402
from idkengine_tpu_torch.utils import mathutil as mu  # noqa: E402

from test_torch_trace import jax_core  # noqa: E402,F401

BOX_CAM = dict(position=np.array([278, 273, -800], np.float32), yaw=90.0, fov_y=38.0)
LIGHT = np.array([278.0, 480.0, 279.5], np.float32)
RES = 16


def _cameras(n, seed):
    """Seeded cameras: positions in a 1000-unit box, any yaw, pitch in
    (-80, 80), fov 30-90."""
    rng = np.random.default_rng(seed)
    return [dict(position=rng.uniform(-500, 500, 3).astype(np.float32),
                 yaw=float(rng.uniform(-180, 180)), pitch=float(rng.uniform(-80, 80)),
                 fov_y=float(rng.uniform(30, 90)), near=float(rng.uniform(0.01, 1.0)))
            for _ in range(n)]


def _frustum_equal(a, b):
    for k in ("corners", "axes", "edges"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


def test_camera_matrices_match_jax():
    for cam in _cameras(8, 1):
        c, jc = Camera(**cam), JCamera(**cam)
        np.testing.assert_array_equal(c.view_matrix(), jc.view_matrix())
        np.testing.assert_array_equal(c.projection_matrix(16 / 9), jc.projection_matrix(16 / 9))
        _frustum_equal(c.frustum(64, 36), jc.frustum(64, 36))
    eye, target, up = np.float32([1, 2, 3]), np.float32([-4, 0.5, 9]), np.float32([0, 1, 0])
    np.testing.assert_array_equal(mu.look_at(eye, target, up), j_mu.look_at(eye, target, up))
    np.testing.assert_array_equal(mu.perspective_reverse_z(1.1, 1.5, 0.05),
                                  j_mu.perspective_reverse_z(1.1, 1.5, 0.05))


def test_frusta_and_sat_match_jax():
    """Frusta from view-projection matrices, corner rays and boxes; the SAT
    booleans of every pair, both ways round, equal to the JAX package's, and
    both answers among them."""
    ours, theirs = [], []
    for cam in _cameras(6, 2):
        c, jc = Camera(**cam), JCamera(**cam)
        vp = c.projection_matrix(1.5) @ c.view_matrix()
        f = collision.Frustum.from_view_projection(vp)
        jf = j_collision.Frustum.from_view_projection(vp)
        _frustum_equal(f, jf)
        ours += [f, c.frustum(48, 32, far=600.0)]
        theirs += [jf, jc.frustum(48, 32, far=600.0)]
    rng = np.random.default_rng(3)
    for _ in range(6):
        lo = rng.uniform(-500, 400, 3)
        hi = lo + rng.uniform(1, 300, 3)
        ours.append(collision.Frustum.from_aabb(lo, hi))
        theirs.append(j_collision.Frustum.from_aabb(lo, hi))
        _frustum_equal(ours[-1], theirs[-1])
    got = [[collision.convex_sat_intersect(a, b) for b in ours] for a in ours]
    want = [[j_collision.convex_sat_intersect(a, b) for b in theirs] for a in theirs]
    assert got == want
    flat = sum(got, [])
    assert any(flat) and not all(flat)


def test_cube_faces_match_jax():
    rng = np.random.default_rng(4)
    n = 600
    face = rng.integers(0, 6, n).astype(np.int32)
    u, v = rng.uniform(-1, 1, (2, n)).astype(np.float32)
    got = shadowmap._face_dirs(torch.from_numpy(face), torch.from_numpy(u), torch.from_numpy(v))
    want = j_shadowmap._face_dirs(jnp.asarray(face), jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:20] = np.float32([[1, 1, 0], [0, 1, 1], [1, 0, 1], [1, 1, 1]] * 5)  # ties between axes
    for g, w in zip(shadowmap._dir_to_face_uv(torch.from_numpy(d)),
                    j_shadowmap._dir_to_face_uv(jnp.asarray(d))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    f2, u2, v2 = shadowmap._dir_to_face_uv(got)  # the inverse
    np.testing.assert_array_equal(f2.numpy(), face)
    np.testing.assert_allclose(u2.numpy() * 2 - 1, u, atol=1e-5)
    np.testing.assert_allclose(v2.numpy() * 2 - 1, v, atol=1e-5)


def test_face_visibility_matches_jax():
    """Each cube face of a light against seeded cameras: the culling masks
    equal, some faces culled and some kept."""
    masks = []
    for cam in _cameras(10, 5) + [BOX_CAM]:
        got = shadowmap.face_visibility(LIGHT, Camera(**cam).frustum(48, 32))
        want = j_shadowmap.face_visibility(LIGHT, JCamera(**cam).frustum(48, 32))
        np.testing.assert_array_equal(got, want)
        masks.append(got)
    masks = np.array(masks)
    assert masks.any() and not masks.all()


@pytest.fixture(scope="module")
def box():
    db = JSceneDatabase()
    db.add_model(j_cornell(emissive_quad=False))
    jsc = db.build()
    sc = from_jax_scene_arrays({k: np.asarray(getattr(jsc, k)) for k in JAX_FIELDS},
                               jsc.max_leaf, "cpu")
    return jsc, sc


def _maps(box, mask):
    jsc, sc = box
    got = shadowmap.build_point_shadow(
        lambda o, d, t: packet_trace.trace_closest(sc, o, d, t).t, LIGHT, RES, face_mask=mask,
        device="cpu")
    want = j_shadowmap.build_point_shadow(lambda o, d, t: j_trace_closest(jsc, o, d, t).t,
                                          LIGHT, RES, face_mask=mask)
    return got, want


@pytest.mark.parametrize("mask", [None, np.array([1, 0, 1, 1, 0, 1], bool)])
def test_build_point_shadow_matches_jax(box, mask):
    got, want = _maps(box, mask)
    assert got.maps.shape == (6, RES, RES)
    np.testing.assert_array_equal(got.maps.numpy(), np.asarray(want.maps))
    np.testing.assert_array_equal(got.face_mask, want.face_mask)
    m = got.maps.numpy()
    assert (m < 1e30).mean() > 0.5  # the walls close most texels
    if mask is not None:
        assert (m[~mask] == shadowmap.FAR).all()


def test_pcf_visibility_matches_jax(box):
    """Points on the box's surfaces (hits of seeded rays from the light's
    side), some shadowed by the boxes, and points on the edges of the map's
    texels: visibilities equal, partial values among them."""
    jsc, sc = box
    got_map, want_map = _maps(box, None)
    rng = np.random.default_rng(6)
    n = 2000
    o = np.tile(np.float32([278, 274, 10]), (n, 1))
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    hit = packet_trace.trace_closest(sc, torch.from_numpy(o), torch.from_numpy(d), 3.4e38)
    pts = (o + d * hit.t.numpy()[:, None])[hit.slot.numpy() >= 0].astype(np.float32)
    for radius, bias in ((0.02, 1.5e-2), (0.08, 5e-3)):
        got = shadowmap.pcf_visibility(got_map, torch.from_numpy(pts), radius, bias).numpy()
        want = np.asarray(j_shadowmap.pcf_visibility(want_map, jnp.asarray(pts), radius, bias))
        np.testing.assert_array_equal(got, want)
    assert (got == 0).any() and (got == 1).any() and ((got > 0) & (got < 1)).any()


def test_manager_rebuilds_only_when_needed(box):
    """A map is built once while its light stays put and its faces stay
    covered; a moved light, or a culled face coming into view, rebuilds."""
    _, sc = box
    calls = []

    def trace(o, d, t):
        calls.append(int((t > 0).sum()))
        return packet_trace.trace_closest(sc, o, d, t).t

    mgr = shadowmap.PointShadowManager(trace, RES, device="cpu")
    narrow = Camera(position=np.float32([278, 480, 279.5]), yaw=0.0, fov_y=30.0).frustum(16, 16)
    first = mgr.update(0, LIGHT, camera_frustum=narrow)
    assert len(calls) == 1 and not first.face_mask.all() and calls[0] < 6 * RES * RES
    assert mgr.update(0, LIGHT, camera_frustum=narrow) is first and len(calls) == 1
    wide = Camera(**BOX_CAM).frustum(48, 32)
    mgr.update(0, LIGHT, camera_frustum=wide)
    expect = 2 if np.any(shadowmap.face_visibility(LIGHT, wide) & ~first.face_mask) else 1
    assert len(calls) == expect
    mgr.update(0, LIGHT + 1.0)
    assert len(calls) == expect + 1 and calls[-1] == 6 * RES * RES and mgr.builds == len(calls)
