"""Probe P3: a packet-wide reduce that steers the next step, four ways.
Counterpart: tools/bench_reduce.py (`make(mode)`, TPU kernel at :21).

    python -m idkengine_tpu_torch.tools.bench_reduce

`reduce_loop(x, mode, iters)` runs `iters` steps over an (8, 128) float32
plane x: eight threshold masks h[k] = x > k, packed as m = OR h[k] << k, a
reduce over every lane (`sum4`: per-child counts > 0; `orroll`: OR of m;
`orroll_max`: OR of m over row 0; `sum1`: the integer sum of m), added to
an int32 accumulator, its low bit fed back as x += (bits & 1) * 1e-6. On
the card it launches `csrc/bench_reduce.cu` (one CTA, one lane a thread;
the source says which CTA-wide mechanism each mode uses); a CPU tensor
takes `reduce_loop_plain`. The result's `out` is the tool's output plane
(the accumulator everywhere), `chain["x"]` the plane after the last step.
"""
from __future__ import annotations

import sys
from functools import partial

import numpy as np
import torch

from . import _probe

ROWS = 8
ITERS = 20000
MODES = ("sum4", "orroll", "orroll_max", "sum1")
# integer and float operations a lane does in one step: 8 compares, 8
# shifts and ORs to pack m, one reduce step, the feedback's and, convert,
# multiply and add
OPS_PER_LANE_STEP = 8 + 16 + 1 + 4
# warp instructions a step of what each mode's function needs, by class
# (`needed_cycles_per_step`): a lane's 8 masks, each a compare that writes a
# mask (FSET) and one LOP3 that places it in m or in its packed count
LANE_NEEDED = {"alu": 16}
# every lane: acc += bits; bit 0 tested, 1e-6 or 0 selected, added to x
FEEDBACK_NEEDED = {"alu": 3, "fp32": 1}
# sum4's four packed counts: four warp sums (REDUX) and one 16-byte store
# of them; after the barrier every warp loads the 32 warps' words (one
# 16-byte load a lane), sums them (four REDUX) and tests each of the eight
# 16-bit halves (8 compares, 2 moves of the predicates into bits)
SUM4_NEEDED = {"shfl": 8, "shared": 2, "alu": 10}
REPS = 5

_LIB = _probe.Library("bench_reduce", {"idk_bench_reduce": (4, 2)})
build_kernels = _LIB.build
SOURCE = _LIB.source


def reduce_loop_plain(x: torch.Tensor, mode: str, iters: int = ITERS) -> _probe.ProbeOut:
    """The plain version: the same steps with PyTorch ops, one Python loop
    iteration a step; the accumulator in int64, wrapped to int32 at the
    end as the kernel's (and the TPU's) int32 adds wrap."""
    dev = x.device
    shifts = torch.tensor([1 << k for k in range(8)], dtype=torch.int64, device=dev)
    ks = torch.arange(8, dtype=torch.float32, device=dev)[:, None, None]
    step = torch.tensor(1e-6, dtype=torch.float32, device=dev)
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(iters):
        h = (x > ks).to(torch.int64)  # (8, ROWS, 128): child k's mask
        if mode == "sum4":
            bits = ((h.sum((1, 2)) > 0).to(torch.int64) * shifts).sum()
        elif mode == "orroll":
            bits = (h.amax((1, 2)) * shifts).sum()
        elif mode == "orroll_max":
            bits = (h[:, 0, :].amax(1) * shifts).sum()
        else:  # sum1: the bits are distinct, so the sum of h[k] << k is m
            bits = (h * shifts[:, None, None]).sum()
        acc = acc + bits
        x = x + (bits & 1).to(torch.float32) * step
    acc32 = ((acc + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)
    return _probe.ProbeOut(acc32.expand(ROWS, 128).contiguous(), {"x": x}, None)


def reduce_loop(x: torch.Tensor, mode: str, iters: int = ITERS) -> _probe.ProbeOut:
    """P3 on an (8, 128) float32 plane: the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    dev = _probe.check("reduce_loop", x=(x, (ROWS, 128), torch.float32))
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    _probe.check_iters("reduce_loop", iters)
    if dev.type == "cpu":
        return reduce_loop_plain(x, mode, iters)
    out = torch.empty((ROWS, 128), dtype=torch.int32, device=dev)
    x_out = torch.empty_like(x)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    _LIB("idk_bench_reduce", [x, out, x_out, cycles], [MODES.index(mode), iters])
    reduce_loop.launches += 1
    return _probe.ProbeOut(out, {"x": x_out}, cycles)


# launch count: the wrapper adds one where it launches its kernel
reduce_loop.launches = 0


def reset_launch_counts():
    reduce_loop.launches = 0


def make_inputs(device, seed: int = 0) -> torch.Tensor:
    """x as the tool makes it (uniform in [0, 8)), from a seed."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((ROWS, 128)) * 8).astype(np.float32)).to(device)


def bound(iters: int = ITERS) -> dict:
    """`_probe.bound` of one launch: x read once, out and x_out written
    once; integer operations counted at the float32 rate."""
    return _probe.bound(OPS_PER_LANE_STEP * ROWS * 128 * iters, 3 * ROWS * 128 * 4 + 8)


def needed_cycles_per_step(mode: str) -> tuple[float, str]:
    """(cycles, pipe): the one-SM bound of a step of `mode` (a label of
    `variants()`) from the instructions the mode's function needs (`_probe.needed_cycles`, compute capability 9.0's
    rates), whatever the kernel emits. Counted: every lane's masks and
    packing (`LANE_NEEDED`; orroll_max's only in the 4 warps of row 0, the
    lanes it reads) and feedback (`FEEDBACK_NEEDED`); the reduce: sum4's
    (`SUM4_NEEDED`); sum1's and orroll's one REDUX and one store a warp,
    then in every warp one load of the 32 slots and one REDUX (every lane
    needs the result: one barrier a step); orroll_max's REDUX and store in
    4 warps, then in every warp one 16-byte load of the 4 words and two
    ORs. Left out: the loop's counter and branch, the barrier itself, and
    latency (a step's chain of compares, REDUX, store, barrier, load and
    REDUX, which a throughput bound does not see)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    lane_share = 4 / _probe.CTA_WARPS if mode == "orroll_max" else 1.0
    parts = [(LANE_NEEDED, lane_share), (FEEDBACK_NEEDED, 1.0)]
    if mode == "sum4":
        parts.append((SUM4_NEEDED, 1.0))
    elif mode == "orroll_max":
        parts += [({"shfl": 1, "shared": 1}, lane_share), ({"shared": 1, "alu": 2}, 1.0)]
    else:
        parts.append(({"shfl": 2, "shared": 2}, 1.0))
    return _probe.needed_cycles(_probe.merge(*parts))


def variants(device, iters: int = ITERS) -> dict:
    """label -> `_probe.Variant`: each mode at `iters` steps on
    `make_inputs(device)`."""
    x = make_inputs(device)
    return {m: _probe.Variant(partial(reduce_loop, x, m, iters),
                              partial(reduce_loop_plain, x, m, iters), bound(iters), iters)
            for m in MODES}


def variants_at(device, steps: int | None = None) -> dict:
    """Every variant the library launches, at `steps` steps (the tool's
    size where None)."""
    return variants(device, steps or ITERS)


def main(argv=None, device="cuda") -> dict:
    """Each mode at the tool's size: time and cycles per step on the card
    (on the CPU the plain version runs and nothing is timed)."""
    del argv  # the tool takes no arguments
    return _probe.run_variants(device, variants(device), REPS)


if __name__ == "__main__":
    main(sys.argv[1:])
