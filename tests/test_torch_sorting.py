"""The port's sorting against the JAX package's: the host utilities
(utils/sorting.py, numpy in both) bit for bit, and the device sorts
(ops/device_sort.py: torch.sort here, XLA sorts there) on seeded keys."""
import numpy as np
import pytest
import torch
from worker_threads import share_cores

share_cores()

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from idkengine_tpu.ops import device_sort as j_device_sort  # noqa: E402
from idkengine_tpu.utils import sorting as j_sorting  # noqa: E402
from idkengine_tpu_torch import utils  # noqa: E402
from idkengine_tpu_torch.ops import device_sort  # noqa: E402
from idkengine_tpu_torch.utils import sorting  # noqa: E402

N = 4096


def _floats(seed):
    """Seeded floats with the awkward ones among them: both zeros, both
    infinities, NaNs of both signs, denormals, the extremes."""
    rs = np.random.RandomState(seed)
    f = (rs.randn(1000) * 10.0 ** rs.randint(-40, 39, 1000)).astype(np.float32)
    tiny = np.finfo(np.float32).tiny
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, tiny, -tiny,
                        tiny / 4, -tiny / 4, 1e-45, -1e-45, np.finfo(np.float32).max,
                        np.finfo(np.float32).min, 1.0, -1.0], np.float32)
    return np.concatenate([f, special, special])[rs.permutation(1000 + 2 * special.size)]


def test_utils_exports_sorting():
    assert utils.sorting is sorting


@pytest.mark.parametrize("seed", [0, 6])
def test_float_to_key_matches_jax(seed):
    f = _floats(seed)
    got = sorting.float_to_key(f)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, j_sorting.float_to_key(f))
    # unsigned key order is float order where the floats are ordered
    finite = ~np.isnan(f)
    ordered = f[finite][np.argsort(got[finite], kind="stable")]
    assert (ordered[1:] >= ordered[:-1]).all()


@pytest.mark.parametrize("seed", [0, 7])
def test_radix_and_argsort_match_jax(seed):
    rs = np.random.RandomState(seed)
    keys = rs.randint(0, 2 ** 32, 1000, dtype=np.uint64).astype(np.uint32)
    keys[::7] = keys[3]  # ties keep their input order
    got = sorting.radix_sort_indices(keys)
    np.testing.assert_array_equal(got, j_sorting.radix_sort_indices(keys))
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))
    f = _floats(seed)
    np.testing.assert_array_equal(sorting.argsort_floats(f), j_sorting.argsort_floats(f))


def test_lower_bound_and_partition_match_jax():
    rs = np.random.RandomState(3)
    arr = np.sort(rs.randint(0, 50, 200)).astype(np.float32)
    for value in (-1.0, 0.0, 17.0, 17.5, 49.0, 60.0):
        assert sorting.sorted_lower_bound(arr, value) == j_sorting.sorted_lower_bound(arr, value)
    vals = rs.randint(0, 100, 300)
    mask = rs.rand(300) < 0.4
    out, pivot = sorting.stable_partition(vals, mask)
    want, want_pivot = j_sorting.stable_partition(vals, mask)
    np.testing.assert_array_equal(out, want)
    assert pivot == want_pivot
    out, pivot = sorting.stable_partition(np.array([5, 1, 4, 2, 3]), np.array([5, 1, 4, 2, 3]) >= 3)
    np.testing.assert_array_equal(out, [5, 4, 3, 1, 2])
    assert pivot == 3


@pytest.mark.parametrize("bits,passes,high", [(9, 2, 18), (9, 2, 31), (6, 3, 24), (11, 1, 20)])
def test_radix_argsort_matches_jax(bits, passes, high):
    """The permutation equals JAX's; key bits above passes*bits do not
    count, and keys equal below them keep their input order."""
    rs = np.random.RandomState(2 + high)
    k = rs.randint(0, 1 << high, N).astype(np.int32)
    k[::5] = k[1]
    got = device_sort.radix_argsort(torch.from_numpy(k), bits=bits, passes=passes)
    assert got.dtype == torch.int32
    want = np.asarray(j_device_sort.radix_argsort(jnp.asarray(k), bits=bits, passes=passes))
    np.testing.assert_array_equal(got.numpy(), want)
    low = k & ((1 << (bits * passes)) - 1)
    np.testing.assert_array_equal(got.numpy(), np.argsort(low, kind="stable"))


def test_sort_rays_by_key_matches_jax():
    """Sorted keys equal JAX's; the payload rows are equal within each group
    of equal keys (ties are in no set order in either package). Columns are
    1-D, as JAX's multi-operand sort takes them."""
    rs = np.random.RandomState(2)
    k = rs.randint(0, 1 << 10, N).astype(np.int32)  # many ties
    v = rs.rand(N, 3).astype(np.float32)
    ids = np.arange(N, dtype=np.int64)
    cols = (k, v[:, 0], v[:, 1], v[:, 2])
    got = device_sort.sort_rays_by_key(torch.from_numpy(k),
                                       tuple(torch.from_numpy(np.ascontiguousarray(c))
                                             for c in cols + (ids,)))
    got_k, got_i = got[0].numpy(), got[4].numpy()
    got_v = torch.stack(got[1:4], dim=1).numpy()
    want = [np.asarray(c) for c in j_device_sort.sort_rays_by_key(
        jnp.asarray(k), tuple(jnp.asarray(c) for c in cols))]
    want_k, want_v = want[0], np.stack(want[1:4], axis=1)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_k, np.sort(k))
    # each payload row travelled with its key
    np.testing.assert_array_equal(got_v, v[got_i])
    np.testing.assert_array_equal(k[got_i], got_k)

    # the same rows in every group of equal keys
    def rows_by_key(keys, rows):
        return rows[np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0], keys))]

    np.testing.assert_array_equal(rows_by_key(got_k, got_v), rows_by_key(want_k, want_v))
