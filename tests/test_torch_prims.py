"""The order of several CTA sums in one step, as the probes' kernels take
them (idkengine_tpu_torch/csrc/bench_prims.cu, d and d2), and the count of
the instructions those sums need (`_probe.cta_sums_needed`).

A numpy model of the kernels' lanes, in float32 (IEEE round to nearest,
no fused multiply-add, as the kernels are built with -fmad=false), holds
each form to `_probe.cta_sum` bit for bit before any card run:
  - the reduce-scatter in each warp: a lane of group g holds the partials
    of the sums g, g ^ 1, ... and each xor round sends half of them, so
    sum g ends in group g's lanes with the butterfly's bits (IEEE addition
    commutes, so a pair's sum has the same bits in both lanes);
  - the slots stored transposed (warp w's at F (w % G) + w / G, G = 32 /
    F) and read F floats a lane, the first rounds folded in registers and
    the last with shuffles in groups of G lanes (d2: F = 4, `quad_slot`
    and `quad_fold`; F = 1 is `cta_sum_read`'s slot a lane).
The planes' magnitudes span 1e-8 to 1e8, so every rounding of the order
shows.
"""
import numpy as np
import pytest
import torch

from idkengine_tpu_torch.tools import _probe, bench_dual, bench_prims
from worker_threads import share_cores

share_cores()

LANES_PER_THREAD = 4


def _planes(n: int, seed: int) -> np.ndarray:
    """n (32, 128) float32 planes, signed, magnitudes 10^U(-8, 8)."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-8.0, 8.0, (n, 32, 128))
    return (np.where(rng.random((n, 32, 128)) < 0.5, -1.0, 1.0) * mag).astype(np.float32)


def _thread_partials(planes: np.ndarray) -> np.ndarray:
    """(n, 1024): thread t's sum of its lanes t, t + 1024, ... in order."""
    lanes = planes.reshape(planes.shape[0], LANES_PER_THREAD, 1024)
    part = lanes[:, 0]
    for j in range(1, LANES_PER_THREAD):
        part = part + lanes[:, j]
    return part


def _shfl_xor(v: np.ndarray, off: int) -> np.ndarray:
    """__shfl_xor_sync over the last axis (a warp's 32 lanes, or a group)."""
    return v[..., np.arange(v.shape[-1]) ^ off]


def _reduce_scatter(part: np.ndarray) -> np.ndarray:
    """(n, 32 warps, 32 lanes) partials -> (32 warps, 32 lanes): the sum
    each lane holds after the kernel's reduce-scatter of n sums, lane l's
    being sum l >> (5 - log2 n)."""
    n = part.shape[0]
    lane = np.arange(32)
    group = lane >> (5 - (n.bit_length() - 1))
    # p[j][w, l]: lane l's partial of the sum group(l) ^ j
    p = [part[group ^ j, :, lane].T for j in range(n)]
    held = n
    for off in (16, 8, 4, 2, 1):
        if held > 1:
            for j in range(held // 2):
                p[j] = p[j] + _shfl_xor(p[j + held // 2], off)
            held //= 2
        else:
            p[0] = p[0] + _shfl_xor(p[0], off)
    return p[0]


def _slot_index(w: int, f: int) -> int:
    g = 32 // f
    return f * (w % g) + w // g


def _slot_fold(slots: np.ndarray, f: int, lanes: int) -> np.ndarray:
    """(32,) transposed slots -> (lanes,) the sum each lane of a group of
    `lanes` (a multiple of G = 32 / f) holds after slot_fold_t<f>."""
    g = 32 // f
    r = np.arange(lanes) % g
    v = [slots[f * r + i] for i in range(f)]  # v[i]: slot r + G i
    h = f // 2
    while h >= 1:
        v = [v[i] + v[i + h] for i in range(h)]
        h //= 2
    s = v[0]
    off = g // 2
    while off >= 1:
        s = s + _shfl_xor(s, off)
        off //= 2
    return s


def _transposed_sums(planes: np.ndarray, f: int) -> np.ndarray:
    """(n, lanes of the group) each sum as every lane of its group holds it
    after the barrier: reduce-scatter, one store a group, slot_fold_t<f>."""
    n = planes.shape[0]
    part = _thread_partials(planes).reshape(n, 32, 32)
    held = _reduce_scatter(part)  # (warps, lanes)
    per = 32 // n  # lanes a group
    slots = np.zeros((n, 32), np.float32)
    for g in range(n):
        for w in range(32):
            got = held[w, g * per:(g + 1) * per]
            assert np.array_equal(got.view(np.uint32), np.full(per, got[0]).view(np.uint32))
            slots[g, _slot_index(w, f)] = got[0]  # the group's first lane stores
    return np.stack([_slot_fold(slots[g], f, per) for g in range(n)])


def _want(planes: np.ndarray) -> np.ndarray:
    return _probe.cta_sum(torch.from_numpy(planes)).numpy()


# n sums in groups of 32 / n lanes, each lane reading f >= n slot floats:
# d's (1, 1) (cta_sum_read) and d2's (4, 4) (quad_fold) among them
@pytest.mark.parametrize("n,f", [(1, 1), (1, 4), (2, 2), (2, 4), (4, 4)])
def test_scatter_and_transposed_slots_keep_cta_sum_order(n, f):
    for seed in range(3):
        planes = _planes(n, seed=100 * n + 10 * f + seed)
        got, want = _transposed_sums(planes, f), _want(planes)
        for g in range(n):
            assert np.array_equal(got[g].view(np.uint32),
                                  np.full(got.shape[1], want[g]).view(np.uint32)), (g, seed)


def test_d2_planes_keep_cta_sum_order():
    """d2's four sums, of acc * (m + 1) with the lane's multipliers: acc * 1
    is acc, so the products are those of the plain version's planes."""
    acc = _planes(1, seed=7)[0]
    planes = np.stack([acc * np.float32(m + 1) for m in range(4)])
    got = _transposed_sums(planes, 4)
    want = _probe.cta_sum(torch.from_numpy(acc)[None] * torch.arange(1, 5).float()[:, None, None])
    assert np.array_equal(got[:, 0].view(np.uint32), want.numpy().view(np.uint32))


@pytest.mark.parametrize("n,rounds", [(1, 5), (2, 5), (4, 6), (8, 9), (32, 31)])
def test_scatter_rounds(n, rounds):
    assert _probe.scatter_rounds(n) == rounds


def test_scatter_rounds_refuse_other_counts():
    for n in (0, 3, 64):
        with pytest.raises(ValueError):
            _probe.scatter_rounds(n)


def test_one_sum_count_is_cta_sum_needed():
    assert _probe.cta_sums_needed(1, 4) == _probe.cta_sum_needed(4)


# One SM's four schedulers share a CTA's 32 warps, 8 each; a scheduler
# issues one warp instruction a clock and completes a quarter of a shuffle
# a clock. Every warp, n sums: 3 adds a thread and sum, `scatter_rounds(n)`
# shuffles and adds, one store, and a multiply a lane and sum (the decay;
# d2 three products and one decay); once a CTA, spread over the 32 warps:
# the slots' load, fold, conversions and row.
@pytest.mark.parametrize("module,variant,cycles,pipe", [
    # one sum: unchanged, 5 shuffles a warp and 5 in one warp of 32 (P4's
    # d1, dp1 and dpd2 in tests/test_torch_tools.py)
    (bench_prims, bench_prims.label("d", 16), 8 * (5 + 5 / 32) / 0.25, "shfl"),
    # d2: 12 + 6 + 16 fp32, 6 shuffles, 1 store; once 1 + 6 + 6 + 4 + 9
    (bench_prims, bench_prims.label("d2", 16), 8 * (34 + 6 + 1 + 26 / 32), "issue"),
    # two chains: 6 + 5 + 8 fp32, 5 shuffles, 1 store; once 1 + 5 + 5 + 2 + 6
    (bench_dual, bench_dual.LABELS["dd2"], 8 * (19 + 5 + 1 + 19 / 32), "issue"),
    # four chains: 12 + 6 + 16 fp32, 6 shuffles, 1 store; once 1 + 6 + 6 + 4 + 12
    (bench_dual, bench_dual.LABELS["dd4"], 8 * (34 + 6 + 1 + 29 / 32), "issue"),
], ids=lambda v: v.split()[0] if isinstance(v, str) else None)
def test_n_sum_bounds(module, variant, cycles, pipe):
    got, by = module.needed_cycles_per_step(variant)
    assert got == pytest.approx(cycles, rel=1e-12) and by == pipe
