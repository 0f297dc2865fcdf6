"""Probes P5 and P6: the cost of each building block of the traversal loop,
per step of a loop-carried row chain.
Counterpart: tools/bench_prims.py (`main`'s `base_loop` :54 with the bodies
e, a, a2, b, d, d2; `extra()`'s `base_loop` :158 with the body a4).

    python -m idkengine_tpu_torch.tools.bench_prims [K] [extra]

`prims_loop(tab, x, body, k, iters)` runs one of `BODIES` over a (64, 128)
table and a (32, 128) float32 plane; `prims_extra_loop(tab, x, k, iters)`
runs a4, the one body of `extra()` that reaches its kernel (`f`, `f4` and
`g` sit behind `if False` in the tool). On the card both launch
`csrc/bench_prims.cu`; CPU tensors take `prims_loop_plain`. `out` is the
tool's output plane (acc), `chain` the final row and the 256-word scratch.
Each plane is made of float adds and multiplies in the tool's order, and
bit-equal with the TPU kernel's; d and d2 steer the row by sums taken in
the kernels' order (`_probe.cta_sum`).
"""
from __future__ import annotations

import sys
from functools import partial

import numpy as np
import torch

from . import _probe

ROWS = 32
ITERS = 8192
BODIES = ("e", "a", "a2", "b", "d", "d2", "a4")  # index = the kernel's Body
EXTRA = "a4"
DEFAULT_K = 16
UNROLLED = ("a", "a2", "a4")  # the kernel unrolls their K loop at DEFAULT_K
LANES_PER_THREAD = ROWS * 128 // _probe.CTA_THREADS
REPS = 5

_LIB = _probe.Library("bench_prims", {"idk_bench_prims": (6, 3)})
build_kernels = _LIB.build
SOURCE = _LIB.source


def label(body: str, k: int) -> str:
    return {"e": "e  floor (scalar smem chain)", "a": f"a  {k} scalar loads->bcast",
            "a2": f"a2 {k} scalar loads (scalar use)", "b": f"b  row load + {k} lane-gather",
            "d": "d  1x sum->scalar consume", "d2": "d2 4x sum->scalar consume",
            "a4": f"a4 {k} scalar loads over 4 rows"}[body]


def ops_per_lane_step(body: str, k: int) -> int:
    """Float operations a lane does in one step (the scalar chain's own
    operations not counted)."""
    return {"e": 0, "a": k + 1, "a2": 2, "b": k + 1, "d": 2, "d2": 9,
            "a4": 4 * max(k // 4, 1) + 1}[body]


def prims_loop_plain(tab: torch.Tensor, x: torch.Tensor, body: str, k: int = DEFAULT_K,
                     iters: int = ITERS) -> _probe.ProbeOut:
    """The plain version: one Python loop iteration a step, the row a
    Python int (read back from the device only where the data steer it)."""
    dev = x.device
    smem = [0] * 256
    row, acc = 1, x
    half = torch.tensor(0.5, dtype=torch.float32, device=dev)
    decay = torch.tensor(0.99999, dtype=torch.float32, device=dev)
    tiny = torch.tensor(1e-9, dtype=torch.float32, device=dev)
    mults = torch.arange(1, 5, dtype=torch.float32, device=dev)[:, None, None]
    for _ in range(iters):
        if body == "e":
            smem[(row + 1) & 15] = smem[row & 15] + 1
            nxt = row + 1
        elif body in ("a", "b"):  # b gathers the same values as a loads
            for j in range(k):
                acc = acc + tab[row, j]
            acc, nxt = acc * half, row + 1
        elif body == "a2":
            s = torch.zeros((), dtype=torch.float32, device=dev)
            for j in range(k):
                s = s + tab[row, j]
            nxt = row + int(s.item() > 0)
            acc = acc + tiny * s
        elif body == "d":
            nxt = row + (int(_probe.cta_sum(acc).to(torch.int32).item()) & 1) + 1
            acc = acc * decay
        elif body == "d2":
            sums = _probe.cta_sum(acc[None] * mults).to(torch.int32) & 1
            nxt = row + int(sums.sum().item()) + 1
            acc = acc * decay
        else:  # a4
            for r4 in range(4):
                for j in range(max(k // 4, 1)):
                    acc = acc + tab[(row + r4) & 63, j]
            acc, nxt = acc * half, row + 1
        row = nxt & 63
    chain = {"row": torch.tensor([row], dtype=torch.int32, device=dev),
             "smem": torch.tensor(smem, dtype=torch.int32, device=dev)}
    return _probe.ProbeOut(acc, chain, None)


def _run(tab: torch.Tensor, x: torch.Tensor, body: str, k: int, iters: int):
    dev = _probe.check("prims_loop", tab=(tab, (64, 128), torch.float32),
                       x=(x, (ROWS, 128), torch.float32))
    if body not in BODIES:
        raise ValueError(f"body must be one of {BODIES}, got {body!r}")
    if not 1 <= k <= 128:
        raise ValueError(f"k must be in [1, 128] (a table row's lanes), got {k}")
    _probe.check_iters("prims_loop", iters)
    if dev.type == "cpu":
        return prims_loop_plain(tab, x, body, k, iters), False
    out = torch.empty_like(x)
    smem = torch.empty(256, dtype=torch.int32, device=dev)
    row = torch.empty(1, dtype=torch.int32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    _LIB("idk_bench_prims", [tab, x, out, smem, row, cycles], [BODIES.index(body), k, iters])
    return _probe.ProbeOut(out, {"row": row, "smem": smem}, cycles), True


def prims_loop(tab: torch.Tensor, x: torch.Tensor, body: str, k: int = DEFAULT_K,
               iters: int = ITERS) -> _probe.ProbeOut:
    """P5 (`body` one of e, a, a2, b, d, d2): the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if body == EXTRA:
        raise ValueError("a4 is extra()'s body: call prims_extra_loop")
    res, launched = _run(tab, x, body, k, iters)
    prims_loop.launches += launched
    return res


def prims_extra_loop(tab: torch.Tensor, x: torch.Tensor, k: int = DEFAULT_K,
                     iters: int = ITERS) -> _probe.ProbeOut:
    """P6, the body a4: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    res, launched = _run(tab, x, EXTRA, k, iters)
    prims_extra_loop.launches += launched
    return res


# launch counts: each wrapper adds one where it launches its kernel
prims_loop.launches = 0
prims_extra_loop.launches = 0


def reset_launch_counts():
    prims_loop.launches = 0
    prims_extra_loop.launches = 0


def make_inputs(device, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(tab, x) as the tool makes them (tab uniform in [0.5, 1.5), x in
    [0, 1)), from a seed."""
    rng = np.random.default_rng(seed)
    tab = (rng.random((64, 128)) + 0.5).astype(np.float32)
    x = rng.random((ROWS, 128)).astype(np.float32)
    return torch.from_numpy(tab).to(device), torch.from_numpy(x).to(device)


def bound(body: str, k: int = DEFAULT_K, iters: int = ITERS) -> dict:
    """`_probe.bound` of one launch: tab and x read once, out, the row and
    the scratch written once."""
    return _probe.bound(ops_per_lane_step(body, k) * ROWS * 128 * iters,
                        (64 + 2 * ROWS) * 128 * 4 + 257 * 4)


def needed_cycles_per_step(variant: str, k: int = DEFAULT_K) -> tuple[float, str]:
    """(cycles, pipe): the one-SM bound of a step of `variant` (a label of
    `variants()` at K = k, `label(body, k)`) from the instructions the
    body's function needs (`_probe.needed_cycles`, compute capability 9.0's
    rates), at K = k, whatever the kernel emits. Every warp needs the row
    where the row steers its loads (a, a2, b, a4: row + 1 and & 63, 2
    integer instructions; a4's three other rows 2 each); d and d2 steer no
    load, so their row is once a CTA. Counted a warp:
      e   the floor, in one thread: one shared load and one store, 5
          integer instructions (the two indices, v + 1, row + 1, & 63);
      a   ceil(K / 4) 16-byte broadcast loads of the table row, K adds and
          one multiply a lane;
      a2  the same loads, the scalar s in K adds, 1e-9 s, the test s > 0
          and its add to the row, one add a lane (every lane needs s);
      b   ceil(K / 32) row loads a warp from global memory, K shuffles (the
          lane gather), K adds and one multiply a lane;
      d   one CTA sum (`_probe.cta_sums_needed(1, ...)`), one multiply a lane, the
          row: a conversion and three integer instructions;
      d2  four CTA sums of acc * (m + 1) in one step
          (`_probe.cta_sums_needed`: one reduce-scatter of 6 shuffles a
          warp, one store; a multiply a lane for m = 1..3, acc * 1 is acc),
          one multiply a lane, the row: four conversions, four ANDs, three
          adds of the bits, row + t + 1 and & 63 (9);
      a4  four rows of max(K / 4, 1) loads (16 bytes at a time), their
          adds and one multiply a lane.
    Left out: the loop's counter and branch, barriers, and latency (e's
    chain through shared memory; d's and d2's shuffle rounds)."""
    body = {label(b, k): b for b in BODIES}.get(variant)
    if body is None:
        raise ValueError(f"no variant {variant!r} at K = {k}")
    lpt, row = LANES_PER_THREAD, {"alu": 2}  # row + 1, & 63
    loads = -(-k // 4)
    if body == "e":
        return _probe.needed_cycles({"shared": 2, "alu": 5}, warps=1)
    if body == "a":
        return _probe.needed_cycles({"shared": loads, "fp32": (k + 1) * lpt, **row})
    if body == "a2":
        return _probe.needed_cycles({"shared": loads, "fp32": k + 1 + lpt, "alu": 2 + 2})
    if body == "b":
        return _probe.needed_cycles({"memory": -(-k // 32), "shfl": k,
                                     "fp32": (k + 1) * lpt, "alu": 2})
    if body in ("d", "d2"):
        n = 1 if body == "d" else 4
        every, once = _probe.cta_sums_needed(n, lpt)
        return _probe.needed_cycles(
            _probe.merge((every, 1), ({"fp32": lpt}, n)),
            _probe.merge((once, 1), ({"conv": n, "alu": 3 if n == 1 else 9}, 1)))
    per_row = max(k // 4, 1)
    return _probe.needed_cycles({"shared": 4 * -(-per_row // 4), "fp32": (4 * per_row + 1) * lpt,
                                 "alu": 2 + 3 * 2})


def variants(device, iters: int = ITERS, k: int = DEFAULT_K, extra: bool = False) -> dict:
    """label -> `_probe.Variant`: the bodies e, a, a2, b, d, d2 (and, with
    `extra`, a4) at K and `iters` steps on `make_inputs(device)`."""
    tab, x = make_inputs(device)
    out = {}
    for b in BODIES:
        if b == EXTRA and not extra:
            continue
        kernel = (partial(prims_extra_loop, tab, x, k, iters) if b == EXTRA
                  else partial(prims_loop, tab, x, b, k, iters))
        out[label(b, k)] = _probe.Variant(kernel, partial(prims_loop_plain, tab, x, b, k, iters),
                                          bound(b, k, iters), iters)
    return out


def variants_at(device, steps: int | None = None) -> dict:
    """Every variant the library launches (a4 too) at the tool's K, at
    `steps` steps (the tool's size where None)."""
    return variants(device, steps or ITERS, extra=True)


def main(argv=None, device="cuda") -> dict:
    """The tool's bodies at K (argv[0], default 16): e, a, a2, b, d, d2,
    then, with argv[1] == "extra", extra()'s a4, as the tool runs them.
    Time and cycles per step on the card (on the CPU the plain version
    runs and nothing is timed)."""
    argv = list(argv or [])
    k = int(argv[0]) if argv else DEFAULT_K
    extra = len(argv) > 1 and argv[1] == "extra"
    return _probe.run_variants(device, variants(device, ITERS, k, extra), REPS)


if __name__ == "__main__":
    main(sys.argv[1:])
