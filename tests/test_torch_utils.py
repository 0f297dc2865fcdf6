"""Port vs JAX package: leaf math (RNG, normal compression, ray generation,
intersection, sampling, shading, tonemap) on the same numpy inputs.

Integers must match bit for bit. Floats are held to 1e-6 (absolute, on
values of order one): the two frameworks may sum a 3-vector's products in
another order or round a transcendental function differently in the last
place, and nothing more.
"""
import numpy as np
import pytest
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from idkengine_tpu.ops import intersect as j_isect  # noqa: E402
from idkengine_tpu.render import camera as j_cam  # noqa: E402
from idkengine_tpu.render import sampling as j_smp  # noqa: E402
from idkengine_tpu.render import shading as j_shd  # noqa: E402
from idkengine_tpu.render import tonemap as j_tm  # noqa: E402
from idkengine_tpu.utils import compression as j_comp  # noqa: E402
from idkengine_tpu.utils import mathutil as j_mu  # noqa: E402
from idkengine_tpu.utils import rng as j_rng  # noqa: E402
from idkengine_tpu_torch.ops import intersect as t_isect  # noqa: E402
from idkengine_tpu_torch.render import camera as t_cam  # noqa: E402
from idkengine_tpu_torch.render import sampling as t_smp  # noqa: E402
from idkengine_tpu_torch.render import shading as t_shd  # noqa: E402
from idkengine_tpu_torch.render import tonemap as t_tm  # noqa: E402
from idkengine_tpu_torch.utils import compression as t_comp  # noqa: E402
from idkengine_tpu_torch.utils import mathutil as t_mu  # noqa: E402
from idkengine_tpu_torch.utils import rng as t_rng  # noqa: E402

FLOAT_TOL = 1e-6
# sampled directions go through sin/cos of angles up to 2*pi, whose last-place
# differences between XLA's and torch's math libraries grow by cancellation
# in the basis sums
DIR_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return np.asarray(x)


def _unit(rs, n):
    v = rs.standard_normal((n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


class TestRng:
    @pytest.mark.parametrize("frame", [0, 7, 123456789])
    def test_chain_bit_exact(self, frame):
        pix = np.arange(50_000, dtype=np.uint32)
        sj = j_rng.init_state(jnp.asarray(pix), frame)
        st = t_rng.init_state(_t(pix.astype(np.int64)), frame)
        np.testing.assert_array_equal(_np(sj).astype(np.int64), st.numpy())
        for _ in range(3):
            sj, uj = j_rng.uniform2(sj)
            st, ut = t_rng.uniform2(st)
            np.testing.assert_array_equal(_np(sj).astype(np.int64), st.numpy())
            np.testing.assert_array_equal(_np(uj), ut.numpy())
        sj, uj = j_rng.uniform(sj)
        st, ut = t_rng.uniform(st)
        np.testing.assert_array_equal(_np(uj), ut.numpy())

    def test_hash_full_range(self):
        x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)
        np.testing.assert_array_equal(
            _np(j_rng.pcg_hash(jnp.asarray(x))).astype(np.int64),
            t_rng.pcg_hash(_t(x.astype(np.int64))).numpy())


class TestCompression:
    def test_encoders_bit_exact(self):
        n = _unit(np.random.default_rng(0), 20_000)
        np.testing.assert_array_equal(j_comp.compress_normal(n), t_comp.compress_normal(n))

    def test_decompress_matches_jax(self):
        bits = j_comp.compress_normal(_unit(np.random.default_rng(1), 20_000))
        want = _np(j_comp.decompress_normal(jnp.asarray(bits), jnp))
        got = t_comp.decompress_normal(_t(bits.astype(np.int64))).numpy()
        np.testing.assert_allclose(got, want, atol=FLOAT_TOL, rtol=0)


class TestCamera:
    @pytest.mark.parametrize("lens", [0.0, 0.05])
    def test_generate_rays(self, lens):
        cam_kw = dict(position=np.array([0.3, 3.0, 24.0], np.float32), yaw=-80.0,
                      pitch=5.0, fov_y=65.0, lens_radius=lens)
        w, h = 48, 32
        rs = np.random.default_rng(2)
        jit = rs.random((w * h, 2)).astype(np.float32)
        lens_u = rs.random((w * h, 2)).astype(np.float32)
        oj, dj = j_cam.generate_rays(j_cam.Camera(**cam_kw).ray_params(w, h), w, h,
                                     jnp.asarray(jit), jnp.asarray(lens_u))
        ot, dt = t_cam.generate_rays(t_cam.Camera(**cam_kw).ray_params(w, h), w, h,
                                     _t(jit), _t(lens_u))
        np.testing.assert_allclose(ot.numpy(), _np(oj), atol=FLOAT_TOL, rtol=0)
        np.testing.assert_allclose(dt.numpy(), _np(dj), atol=FLOAT_TOL, rtol=0)


class TestIntersect:
    def test_ray_triangle(self):
        rs = np.random.default_rng(3)
        n = 4096
        o = rs.normal(size=(n, 3)).astype(np.float32) * 2
        d = _unit(rs, n)
        p0 = rs.normal(size=(n, 3)).astype(np.float32)
        e1 = rs.normal(size=(n, 3)).astype(np.float32)
        e2 = rs.normal(size=(n, 3)).astype(np.float32)
        hj, tj, uj, vj = j_isect.ray_triangle(*(jnp.asarray(a) for a in (o, d, p0, e1, e2)))
        ht, tt, ut, vt = t_isect.ray_triangle(*(_t(a) for a in (o, d, p0, e1, e2)))
        agree = _np(hj) == ht.numpy()
        assert agree.mean() >= 0.999
        both = _np(hj) & ht.numpy()
        np.testing.assert_allclose(tt.numpy()[both], _np(tj)[both], rtol=1e-5, atol=FLOAT_TOL)
        np.testing.assert_allclose(ut.numpy()[both], _np(uj)[both], rtol=1e-5, atol=FLOAT_TOL)

    def test_ray_aabb_and_sphere(self):
        rs = np.random.default_rng(4)
        n = 4096
        o = rs.normal(size=(n, 3)).astype(np.float32) * 3
        d = _unit(rs, n)
        inv = (1.0 / d).astype(np.float32)
        lo = np.float32([-1, -0.5, -2])
        hi = np.float32([1, 0.5, 2])
        hj, tj = j_isect.ray_aabb(jnp.asarray(o), jnp.asarray(inv), lo, hi, 10.0)
        ht, tt = t_isect.ray_aabb(_t(o), _t(inv), _t(lo), _t(hi), 10.0)
        np.testing.assert_array_equal(ht.numpy(), _np(hj))
        np.testing.assert_array_equal(tt.numpy(), _np(tj))
        c = np.float32([0.2, 0.1, -0.3])
        sj, sjt = j_isect.ray_sphere(jnp.asarray(o), jnp.asarray(d), jnp.asarray(c), 1.3)
        st, stt = t_isect.ray_sphere(_t(o), _t(d), _t(c), torch.tensor(1.3))
        np.testing.assert_array_equal(st.numpy(), _np(sj))
        m = _np(sj)
        np.testing.assert_allclose(stt.numpy()[m], _np(sjt)[m], rtol=1e-5, atol=1e-5)


class TestShading:
    def test_sampling(self):
        rs = np.random.default_rng(5)
        n = 4096
        nrm = _unit(rs, n)
        u = rs.random((n, 2)).astype(np.float32)
        p = rs.normal(size=(n, 3)).astype(np.float32) * 4
        c = np.float32([0.5, 8.0, -1.0])
        np.testing.assert_allclose(t_smp.cosine_hemisphere(_t(nrm), _t(u)).numpy(),
                                   _np(j_smp.cosine_hemisphere(jnp.asarray(nrm), jnp.asarray(u))),
                                   atol=DIR_TOL, rtol=0)
        dj, pj, _ = j_smp.sphere_light_sample(jnp.asarray(p), jnp.asarray(c), 0.8, jnp.asarray(u))
        dt, pt, _ = t_smp.sphere_light_sample(_t(p), _t(c), torch.tensor(0.8), _t(u))
        np.testing.assert_allclose(dt.numpy(), _np(dj), atol=DIR_TOL, rtol=0)
        # the pdf divides by 1 - cos_max, which cancels for distant lights
        np.testing.assert_allclose(pt.numpy(), _np(pj), rtol=1e-4)

    def test_bsdf(self):
        rs = np.random.default_rng(6)
        n = 4096
        d = _unit(rs, n)
        nrm = _unit(rs, n)
        nrm = np.where((d * nrm).sum(-1, keepdims=True) > 0, -nrm, nrm).astype(np.float32)
        l_dir = _unit(rs, n)
        albedo = rs.random((n, 3)).astype(np.float32)
        met, rough, trans = (rs.random(n).astype(np.float32) for _ in range(3))
        ior = (1.0 + rs.random(n)).astype(np.float32)
        inside = rs.random(n) < 0.3
        u_lobe = rs.random(n).astype(np.float32)
        u_dir = rs.random((n, 2)).astype(np.float32)
        args = (d, nrm, albedo, met, rough, trans, ior, inside, u_lobe, u_dir)
        sj = j_shd.sample_bsdf(*(jnp.asarray(a) for a in args), trans_tint=jnp.asarray(albedo))
        st = t_shd.sample_bsdf(*(_t(a) for a in args), trans_tint=_t(albedo))
        np.testing.assert_array_equal(st.is_specular.numpy(), _np(sj.is_specular))
        np.testing.assert_array_equal(st.is_transmissive.numpy(), _np(sj.is_transmissive))
        np.testing.assert_allclose(st.direction.numpy(), _np(sj.direction), atol=DIR_TOL, rtol=0)
        np.testing.assert_allclose(st.throughput_mul.numpy(), _np(sj.throughput_mul),
                                   atol=FLOAT_TOL, rtol=0)
        gj = j_shd.ggx_brdf(*(jnp.asarray(a) for a in (nrm, -d, l_dir, albedo, met, rough)))
        gt = t_shd.ggx_brdf(*(_t(a) for a in (nrm, -d, l_dir, albedo, met, rough)))
        np.testing.assert_allclose(gt.numpy(), _np(gj), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kw", [{}, {"exposure": 1.0, "saturation": 0.8}, {"agx": False}],
                         ids=["agx", "agx-exposure-sat", "reinhard"])
def test_tonemap(kw):
    img = (np.random.default_rng(7).random((16, 16, 3)) * 4).astype(np.float32)
    want = _np(j_tm.tonemap(jnp.asarray(img), j_tm.TonemapSettings(**kw)))
    got = t_tm.tonemap(_t(img), t_tm.TonemapSettings(**kw)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t_tm.to_uint8(t_tm.tonemap(_t(img))),
                                  j_tm.to_uint8(j_tm.tonemap(jnp.asarray(img))))


def _helper_case(name, rs):
    """(the JAX package's result, the port's) of one helper on seeded inputs."""
    n = 4096
    if name == "pack_r11g11b10":
        v = (rs.random((n, 3)) * 100).astype(np.float32)
        v[:7] = 0.0
        return j_comp.pack_r11g11b10(v), t_comp.pack_r11g11b10(v)
    if name == "unpack_r11g11b10":
        u = j_comp.pack_r11g11b10((rs.random((n, 3)) * 100).astype(np.float32))
        u[:3] = 0
        return (_np(j_comp.unpack_r11g11b10(jnp.asarray(u), jnp)),
                t_comp.unpack_r11g11b10(_t(u.astype(np.int64)), torch).numpy())
    if name == "unpack_r11g11b10 numpy":
        u = j_comp.pack_r11g11b10((rs.random((n, 3)) * 100).astype(np.float32))
        return j_comp.unpack_r11g11b10(u), t_comp.unpack_r11g11b10(u)
    if name == "compress_normal_xp":
        v = rs.standard_normal((n, 3)).astype(np.float32)
        v[:5] = 0.0
        return (_np(j_comp.compress_normal_xp(jnp.asarray(v), jnp)).astype(np.int64),
                t_comp.compress_normal_xp(_t(v), torch).numpy())
    if name == "compress_normal_xp numpy":
        v = _unit(rs, n)
        return j_comp.compress_normal_xp(v), t_comp.compress_normal_xp(v)
    if name == "r2_sequence":
        idx = rs.integers(0, 1 << 20, n)
        return j_mu.r2_sequence(idx), t_mu.r2_sequence(idx)
    if name == "morton_encode":
        p = rs.random((n, 3)) * 1.2 - 0.1
        return j_mu.morton_encode(p), t_mu.morton_encode(p)
    if name == "half_area":
        e = rs.random((n, 3)).astype(np.float32)
        return j_mu.half_area(e), t_mu.half_area(e)
    if name == "triangle_area":
        p = rs.standard_normal((3, n, 3)).astype(np.float32)
        return j_mu.triangle_area(*p), t_mu.triangle_area(*p)
    idx = rs.integers(0, 1 << 16, n).astype(np.int32)
    if name == "r2":
        return _np(j_rng.r2(jnp.asarray(idx))), t_rng.r2(_t(idx)).numpy()
    if name == "r2_rotated":
        rot = rs.random((n, 2)).astype(np.float32)
        return (_np(j_rng.r2_rotated(jnp.asarray(idx), jnp.asarray(rot))),
                t_rng.r2_rotated(_t(idx), _t(rot)).numpy())
    if name == "interleaved_gradient_noise":
        px, py = rs.integers(0, 3840, (2, n)).astype(np.int32)
        return (_np(j_rng.interleaved_gradient_noise(jnp.asarray(px), jnp.asarray(py), 37)),
                t_rng.interleaved_gradient_noise(_t(px), _t(py), 37).numpy())
    assert name == "uniform_sphere"
    u = rs.random((n, 2)).astype(np.float32)
    return _np(j_smp.uniform_sphere(jnp.asarray(u))), t_smp.uniform_sphere(_t(u)).numpy()


@pytest.mark.parametrize("name", [
    "pack_r11g11b10", "unpack_r11g11b10", "unpack_r11g11b10 numpy", "compress_normal_xp",
    "compress_normal_xp numpy", "r2_sequence", "morton_encode", "half_area", "triangle_area",
    "r2", "r2_rotated", "interleaved_gradient_noise", "uniform_sphere"])
def test_helpers_match_jax(name):
    """The helpers the port adds for the JAX package's public names: the
    same dtype and shape; integers bit for bit, floats within FLOAT_TOL
    (uniform_sphere's sin and cos may differ in the last place)."""
    want, got = _helper_case(name, np.random.default_rng(11))
    assert got.shape == want.shape
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want)
    else:
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        np.testing.assert_allclose(got, want, atol=FLOAT_TOL, rtol=0)
