"""Probe P4: independent reduce-to-scalar chains in one loop, consumed in
the same step or one step late.
Counterpart: tools/bench_dual.py (`kernel_d1` :57, `kernel_dd` :70,
`kernel_dp` :95).

    python -m idkengine_tpu_torch.tools.bench_dual

`dual_loop(x, kind, iters)` runs `iters` steps over a (32, 128) float32
plane for one of the tool's kernels (`KINDS`: d1, dd2, dd4, dp1, dpd2 =
1, 2 or 4 chains, deferred or not): each chain's packet sum steers its row,
row = (row + (int(sum) & 1) + 1) & 63, and its plane decays by 0.99999. On
the card it launches `csrc/bench_dual.cu`; a CPU tensor takes
`dual_loop_plain`. `out` is the tool's output (the chains' planes added),
`chain["rows"]` each chain's final row. The kernels and the plain version
sum in one order (`_probe.cta_sum`), so the rows agree bit for bit; the
planes are products only and agree with the TPU kernels' bit for bit.
"""
from __future__ import annotations

import sys
from functools import partial

import numpy as np
import torch

from . import _probe

ROWS = 32
ITERS = 8192
KINDS = {"d1": (1, False), "dd2": (2, False), "dd4": (4, False), "dp1": (1, True),
         "dpd2": (2, True)}  # kind -> (chains, deferred)
LABELS = {"d1": "d1   1 chain same-iter", "dd2": "dd2  2 chains same-iter",
          "dd4": "dd4  4 chains same-iter", "dp1": "dp1  1 chain deferred",
          "dpd2": "dpd2 2 chains deferred"}
DECAY = 0.99999
OPS_PER_LANE_STEP = 2  # per chain: one multiply, one add of the sum
LANES_PER_THREAD = ROWS * 128 // _probe.CTA_THREADS
# a chain's step besides its sum (`needed_cycles_per_step`): every lane's
# decay (one multiply), and once a CTA the row: int(s) (one conversion),
# (row + (s & 1) + 1) & 63 (three integer instructions)
DECAY_NEEDED = {"fp32": LANES_PER_THREAD}
ROW_NEEDED = {"conv": 1, "alu": 3}
REPS = 5

_LIB = _probe.Library("bench_dual", {"idk_bench_dual": (4, 3)})
build_kernels = _LIB.build
SOURCE = _LIB.source


def _scales(n: int, device) -> torch.Tensor:
    """Chain k starts at x * (1 + 0.1 k), the Python float rounded once to
    float32 as the tool's weakly typed scalar is (x * 1 is x, as kernel_d1
    starts)."""
    return torch.tensor([1.0 + 0.1 * k for k in range(n)], dtype=torch.float32, device=device)


def dual_loop_plain(x: torch.Tensor, kind: str, iters: int = ITERS) -> _probe.ProbeOut:
    """The plain version: the chains stacked into one (n, 32, 128) tensor,
    one Python loop iteration a step, the sums in the kernel's order."""
    n, defer = KINDS[kind]
    accs = x * _scales(n, x.device)[:, None, None]
    rows = torch.arange(1, n + 1, dtype=torch.int32, device=x.device)
    decay = torch.tensor(DECAY, dtype=torch.float32, device=x.device)
    prev = torch.zeros(n, dtype=torch.float32, device=x.device)
    for _ in range(iters):
        s = prev if defer else _probe.cta_sum(accs)
        rows = (rows + (s.to(torch.int32) & 1) + 1) & 63
        accs = accs * decay
        if defer:
            prev = _probe.cta_sum(accs)
    out = accs[0]
    for k in range(1, n):
        out = out + accs[k]
    return _probe.ProbeOut(out, {"rows": rows}, None)


def dual_loop(x: torch.Tensor, kind: str, iters: int = ITERS) -> _probe.ProbeOut:
    """P4 on a (32, 128) float32 plane: the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    dev = _probe.check("dual_loop", x=(x, (ROWS, 128), torch.float32))
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {tuple(KINDS)}, got {kind!r}")
    _probe.check_iters("dual_loop", iters)
    if dev.type == "cpu":
        return dual_loop_plain(x, kind, iters)
    n, defer = KINDS[kind]
    out = torch.empty_like(x)
    rows = torch.empty(n, dtype=torch.int32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    _LIB("idk_bench_dual", [x, out, rows, cycles], [n, int(defer), iters])
    dual_loop.launches += 1
    return _probe.ProbeOut(out, {"rows": rows}, cycles)


# launch count: the wrapper adds one where it launches its kernel
dual_loop.launches = 0


def reset_launch_counts():
    dual_loop.launches = 0


def make_inputs(device, seed: int = 0) -> torch.Tensor:
    """x as the tool makes it (uniform in [0, 1)), from a seed."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((ROWS, 128)).astype(np.float32)).to(device)


def bound(kind: str, iters: int = ITERS) -> dict:
    """`_probe.bound` of one launch: x read once, out and rows written once."""
    n = KINDS[kind][0]
    return _probe.bound(OPS_PER_LANE_STEP * n * ROWS * 128 * iters, 2 * ROWS * 128 * 4 + 4 * n)


def needed_cycles_per_step(variant: str) -> tuple[float, str]:
    """(cycles, pipe): the one-SM bound of a step of `variant` (a label of
    `variants()`, `LABELS[kind]`) from the instructions the kind's function
    needs (`_probe.needed_cycles`, compute capability
    9.0's rates), whatever the kernel emits: the n chains' CTA sums of
    their 4,096 lanes in `_probe.cta_sum`'s order, in one step
    (`_probe.cta_sums_needed`: 3 adds a thread and chain, one reduce-scatter
    fold a warp, 5 shuffles for one or two chains and 6 for four, one store
    a warp, one fold of the n x 32 slots in one warp), every lane's decay,
    and the row once a CTA (`DECAY_NEEDED`, `ROW_NEEDED`). Deferring the consume changes no
    count. Left out: the loop's counter and branch, the barrier or its
    arrive and wait, and latency (a same-step chain of shuffle rounds,
    barrier and a second fold, which a throughput bound does not see)."""
    kind = {v: k for k, v in LABELS.items()}.get(variant)
    if kind is None:
        raise ValueError(f"variant must be one of {tuple(LABELS.values())}, got {variant!r}")
    n = KINDS[kind][0]
    every, once = _probe.cta_sums_needed(n, LANES_PER_THREAD)
    return _probe.needed_cycles(_probe.merge((every, 1), (DECAY_NEEDED, n)),
                                _probe.merge((once, 1), (ROW_NEEDED, n)))


def variants(device, iters: int = ITERS) -> dict:
    """label -> `_probe.Variant`: each of the tool's kernels at `iters`
    steps on `make_inputs(device)`."""
    x = make_inputs(device)
    return {LABELS[k]: _probe.Variant(partial(dual_loop, x, k, iters),
                                      partial(dual_loop_plain, x, k, iters), bound(k, iters),
                                      iters)
            for k in KINDS}


def variants_at(device, steps: int | None = None) -> dict:
    """Every variant the library launches, at `steps` steps (the tool's
    size where None)."""
    return variants(device, steps or ITERS)


def main(argv=None, device="cuda") -> dict:
    """The tool's five kernels: time and cycles per step on the card (on
    the CPU the plain version runs and nothing is timed)."""
    del argv  # the tool takes no arguments
    return _probe.run_variants(device, variants(device), REPS)


if __name__ == "__main__":
    main(sys.argv[1:])
