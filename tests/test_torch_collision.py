"""The port's host scene queries, collision and physics against the JAX
package's, on the Cornell box.

The queries run in each package's own build of the same C++ core (the
port's copy of bvh.cpp; the JAX core loaded under test_torch_trace's lock,
so that it never takes its numpy fallback): closest-hit rays (t, u, v and
the triangle id equal), box queries (the same triangle set) and the
sphere's closest triangle on the same candidates (equal). The moving-sphere
sweep, sphere-sphere sweeps, camera input, camera collision, light
physics (LightManager.simulate with and without light_collisions) agree
with JAX to 1e-6 relative over seeded steps.
"""
import numpy as np
import pytest

from idkengine_tpu import collision as j_collision
from idkengine_tpu.bvh.builder import BuildSettings as JBuildSettings
from idkengine_tpu.render.camera import Camera as JCamera
from idkengine_tpu.scene.procedural import cornell_box as j_cornell
from idkengine_tpu.scene.scene_db import SceneDatabase as JSceneDatabase
from idkengine_tpu_torch import collision
from idkengine_tpu_torch.bvh.builder import BuildSettings
from idkengine_tpu_torch.render.camera import Camera
from idkengine_tpu_torch.scene.procedural import cornell_box
from idkengine_tpu_torch.scene.scene_db import SceneDatabase

from test_torch_trace import jax_core  # noqa: F401
from worker_threads import share_cores

share_cores()

REL = 1e-6
BOX_LO, BOX_HI = np.float32([20, 20, 20]), np.float32([535, 530, 540])


@pytest.fixture(scope="module")
def dbs():
    """The Cornell box built by both packages (the port's on the CPU)."""
    from idkengine_tpu.bvh import builder as j_builder

    assert j_builder.native_available()
    port = SceneDatabase(BuildSettings(max_leaf_triangle_count=4))
    port.add_model(cornell_box())
    port.build("cpu")
    ref = JSceneDatabase(JBuildSettings(max_leaf_triangle_count=4))
    ref.add_model(j_cornell())
    ref.build()
    return port, ref


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=REL,
                               atol=REL * 555)


def test_intersect_ray_matches_jax(dbs):
    port, ref = dbs
    rng = np.random.default_rng(0)
    hits = 0
    for _ in range(300):
        o = rng.uniform(BOX_LO, BOX_HI).astype(np.float32)
        d = rng.standard_normal(3).astype(np.float32)
        d /= np.linalg.norm(d)
        got, want = port.intersect_ray(o, d), ref.intersect_ray(o, d)
        assert (got is None) == (want is None)
        if got is not None:
            hits += 1
            assert got == want
        t_max = 50.0
        got, want = port.intersect_ray(o, d, t_max), ref.intersect_ray(o, d, t_max)
        assert got == want
    assert hits > 250
    assert port.intersect_ray([278, 273, -800], [0, 0, -1]) is None


def test_intersect_box_and_sphere_match_jax(dbs):
    port, ref = dbs
    rng = np.random.default_rng(1)
    found = 0
    for _ in range(200):
        c = rng.uniform(0, 555, 3).astype(np.float32)
        half = rng.uniform(1, 80, 3).astype(np.float32)
        got, want = port.intersect_box(c - half, c + half), ref.intersect_box(c - half, c + half)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(np.sort(got), np.sort(want))
        if got.size:
            found += 1
            r = float(rng.uniform(5, 120))
            a = port.blas.sphere_closest_triangle(got, c, r)
            b = ref.blas.sphere_closest_triangle(got, c, r)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a[0], b[0])
                assert a[1:] == b[1:]
    assert found > 50
    assert port.blas.sphere_closest_triangle(np.zeros(0, np.uint32), [0, 0, 0], 1.0) is None


def test_moving_sphere_sweeps_match_jax(dbs):
    port, ref = dbs
    rng = np.random.default_rng(2)
    for _ in range(40):
        p = rng.uniform(BOX_LO + 40, BOX_HI - 40).astype(np.float32)
        v = (rng.standard_normal(3) * 150).astype(np.float32)
        r = float(rng.uniform(5, 30))
        _close(collision.scene_vs_moving_sphere(port, p, v, r),
               j_collision.scene_vs_moving_sphere(ref, p, v, r))
        settings = collision.CollisionSettings(test_steps=2, recursive_steps=3, epsilon=0.01)
        j_settings = j_collision.CollisionSettings(test_steps=2, recursive_steps=3, epsilon=0.01)
        _close(collision.scene_vs_moving_sphere(port, p, v, r, settings),
               j_collision.scene_vs_moving_sphere(ref, p, v, r, j_settings))
    for _ in range(200):
        args = (rng.uniform(-5, 5, 3), rng.uniform(-3, 3, 3), rng.uniform(0.1, 2),
                rng.uniform(-5, 5, 3), rng.uniform(-3, 3, 3), rng.uniform(0.1, 2))
        assert collision.moving_sphere_vs_sphere(*args) == j_collision.moving_sphere_vs_sphere(*args)


def test_camera_physics_and_collision_match_jax(dbs):
    port, ref = dbs
    rng = np.random.default_rng(3)
    cams = [Camera(position=np.float32([278, 273, 100]), yaw=90.0, speed=300.0,
                   collision_radius=25.0),
            JCamera(position=np.float32([278, 273, 100]), yaw=90.0, speed=300.0,
                    collision_radius=25.0)]
    dt = 1.0 / 60.0
    for step in range(120):
        move = rng.integers(-1, 2, 3).astype(np.float32)
        look = tuple(rng.uniform(-3, 3, 2)) if step % 7 == 0 else (0.0, 0.0)
        for cam, db, mod in ((cams[0], port, collision), (cams[1], ref, j_collision)):
            cam.process_inputs(move, dt, look)
            mod.camera_collision(db, cam, dt)
            cam.advance_simulation(dt)
        a, b = cams
        _close(a.position, b.position)
        _close(a.velocity, b.velocity)
        assert a.yaw == b.yaw and a.pitch == b.pitch
    assert BOX_LO[0] - 30 < cams[0].position[0] < BOX_HI[0] + 30


@pytest.mark.parametrize("scene", [False, True])
def test_light_physics_match_jax(dbs, scene):
    port, ref = dbs
    rng = np.random.default_rng(4)
    managers = []
    for db in (port, ref):
        mgr = type(db.lights)()
        for k in range(4):
            pos = np.float32([278, 45, 278]) + np.float32([k * 15.0, k * 5.0, 0.0])
            mgr.add(pos, [1, 1, 1], radius=20.0, velocity=rng.uniform(-50, 50, 3)
                    if db is port else managers[0].lights[k].velocity, has_physics=k != 3)
        managers.append(mgr)
    for _ in range(90):
        if scene:
            collision.light_collisions(port, managers[0], 1.0 / 30.0)
            j_collision.light_collisions(ref, managers[1], 1.0 / 30.0)
        else:
            managers[0].simulate(1.0 / 30.0)
            managers[1].simulate(1.0 / 30.0)
        for a, b in zip(managers[0].lights, managers[1].lights):
            _close(a.position, b.position)
            _close(a.velocity, b.velocity)
    lowest = min(l.position[1] - l.radius for l in managers[0].lights[:3])
    if scene:  # the physics lights fell onto the floor (y = 0) and rest on it
        assert -1.0 < lowest < 1.0
    else:
        assert lowest < -5.0
