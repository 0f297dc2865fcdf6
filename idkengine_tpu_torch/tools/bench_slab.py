"""Probe P1: the wide-node traversal step without the traversal: 8 child
slab tests a lane, a packet-wide reduce, stack pushes steered by it.
Counterpart: tools/bench_slab.py (`make(mode, reduce_mode)`, :31).

    python -m idkengine_tpu_torch.tools.bench_slab [rows] [iters]

`slab_loop(tab, ox, oy, oz, dx, dy, dz, mode, reduce, iters)` runs
`iters` steps over (rows, 128) float32 ray planes and a (64, 128) node
table, in f32 or bf16 (`MODES`) with the reduce `sum4`, `sum1` or `none`
(`REDUCES`); bench_slab.cu's header gives the step. On the card it launches
`csrc/bench_slab.cu`; CPU tensors take `slab_loop_plain`. `out` is the
tool's output (acc, which stays 1e30), `chain` the stack, the last step's
four sums and the packed masks of the last 64 steps.
"""
from __future__ import annotations

import sys
from functools import partial

import numpy as np
import torch

from . import _probe

ROWS = 32
ITERS = 4096
MODES = ("f32", "bf16")
REDUCES = ("sum4", "sum1", "none")
ROW_CHOICES = (1, 2, 4, 8, 16, 32, 64)
# float operations a lane does in one step: per child 6 subtracts, 6
# multiplies, 10 min/max, the clamp at 0, two compares and an and (26); 8
# to pack the mask; 2 to update acc
OPS_PER_LANE_STEP = 8 * 26 + 8 + 2
# instructions one slab test needs, by pipe: 6 subtracts and 6 multiplies
# (the float pipe); 11 minima and maxima, one more against t_best and a
# compare (the ALU pipe). A bf16 pair instruction tests two children.
NEEDED = {"fp32": 12, "alu": 13}
REPS = 5

_LIB = _probe.Library("bench_slab", {"idk_bench_slab": (12, 4)})
build_kernels = _LIB.build
SOURCE = _LIB.source


def slab_masks(tab: torch.Tensor, o: torch.Tensor, inv: torch.Tensor, t_best: torch.Tensor,
               i: int, mode: str) -> torch.Tensor:
    """Step i's child hits (8, rows, 128) bool: the slab tests of every lane
    against the 8 boxes of table row i & 63 at lane offset (i & 1) * 64. o
    and inv are (3, rows, 128) in the mode's type, t_best (rows, 128)."""
    off = (i & 1) * 64
    box = tab[i & 63, off:off + 64].reshape(8, 8)[:, :6, None, None]
    if mode == "bf16":
        box = box.to(torch.bfloat16)
    t0 = (box[:, 0] - o[0]) * inv[0]
    t1 = (box[:, 3] - o[0]) * inv[0]
    tn, tf = torch.minimum(t0, t1), torch.maximum(t0, t1)
    for a in (1, 2):
        t0 = (box[:, a] - o[a]) * inv[a]
        t1 = (box[:, a + 3] - o[a]) * inv[a]
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    tn = torch.maximum(tn, torch.zeros((), dtype=tn.dtype, device=tn.device))
    if mode == "bf16":
        return (torch.minimum(tf, t_best) - tn).float() >= 0.0
    return (tf >= tn) & (tn <= t_best)


def slab_loop_plain(tab: torch.Tensor, ox, oy, oz, dx, dy, dz, mode: str, reduce: str,
                    iters: int = ITERS) -> _probe.ProbeOut:
    """The plain version: one Python loop iteration a step, the 8 children
    of a step in one tensor, the stack work in Python ints."""
    dev, rows = ox.device, ox.shape[0]
    o = torch.stack([ox, oy, oz])
    inv = 1.0 / torch.stack([dx, dy, dz])
    if mode == "bf16":
        o, inv = o.to(torch.bfloat16), inv.to(torch.bfloat16)
    words = tab.tolist()
    shifts = torch.tensor([1 << c for c in range(8)], dtype=torch.int64, device=dev)[:, None, None]
    tiny = torch.tensor(1e-9, dtype=torch.float32, device=dev)
    acc = torch.full((rows, 128), 1e30, dtype=torch.float32, device=dev)
    stack = [1] + [0] * 63
    masks = torch.zeros((64, rows, 128), dtype=torch.uint8, device=dev)
    sums = [0, 0, 0, 0]
    for i in range(iters):
        t_best = acc.to(torch.bfloat16) if mode == "bf16" else acc
        h = slab_masks(tab, o, inv, t_best, i, mode).to(torch.int64)
        m = (h * shifts).sum(0)  # the bits are distinct: the sum is the OR
        if i >= iters - 64:
            masks[i & 63] = m.to(torch.uint8)
        met = [int(w) for w in words[i & 63][(i & 1) * 64 + 6:(i & 1) * 64 + 8]]
        sp = stack[0]
        if reduce == "none":
            acc = acc + m.to(torch.float32) * tiny
            if (met[0] + i) & 1 == 0:
                stack[sp & 63] = met[1]
            continue
        if reduce == "sum4":
            c = h.sum((1, 2)).tolist()
            sums = [c[2 * k] + (c[2 * k + 1] << 16) for k in range(4)]
        else:
            sums = [int(m.sum().item()), 0, 0, 0]
        acc = acc + torch.tensor(float(sums[0] & 1), dtype=torch.float32, device=dev) * tiny
        for k in range(2):
            if ((sums[k] >> k) + i) & 1 == 0:
                stack[(sp + k) & 63] = met[k]
    chain = {"stack": torch.tensor(stack, dtype=torch.int32, device=dev),
             "sums": torch.tensor(sums, dtype=torch.int32, device=dev), "masks": masks}
    return _probe.ProbeOut(acc, chain, None)


def slab_loop(tab: torch.Tensor, ox, oy, oz, dx, dy, dz, mode: str, reduce: str,
              iters: int = ITERS) -> _probe.ProbeOut:
    """P1 on (rows, 128) float32 ray planes (rows in ROW_CHOICES) and a
    (64, 128) float32 table: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    rows = ox.shape[0] if ox.dim() == 2 else -1
    if rows not in ROW_CHOICES:
        raise ValueError(f"ray planes must be (rows, 128) with rows in {ROW_CHOICES}, "
                         f"got {tuple(ox.shape)}")
    plane = ((rows, 128), torch.float32)
    dev = _probe.check("slab_loop", tab=(tab, (64, 128), torch.float32), ox=(ox, *plane),
                       oy=(oy, *plane), oz=(oz, *plane), dx=(dx, *plane), dy=(dy, *plane),
                       dz=(dz, *plane))
    if mode not in MODES or reduce not in REDUCES:
        raise ValueError(f"mode must be one of {MODES} and reduce of {REDUCES}, "
                         f"got {mode!r} and {reduce!r}")
    _probe.check_iters("slab_loop", iters)
    if dev.type == "cpu":
        return slab_loop_plain(tab, ox, oy, oz, dx, dy, dz, mode, reduce, iters)
    out = torch.empty_like(ox)
    stack = torch.empty(64, dtype=torch.int32, device=dev)
    sums = torch.empty(4, dtype=torch.int32, device=dev)
    masks = torch.zeros((64, rows, 128), dtype=torch.uint8, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    _LIB("idk_bench_slab", [tab, ox, oy, oz, dx, dy, dz, out, stack, sums, masks, cycles],
         [rows, int(mode == "bf16"), REDUCES.index(reduce), iters])
    slab_loop.launches += 1
    return _probe.ProbeOut(out, {"stack": stack, "sums": sums, "masks": masks}, cycles)


# launch count: the wrapper adds one where it launches its kernel
slab_loop.launches = 0


def reset_launch_counts():
    slab_loop.launches = 0


def make_inputs(device, rows: int = ROWS, seed: int = 0) -> tuple[torch.Tensor, ...]:
    """(tab, ox, oy, oz, dx, dy, dz) as the tool makes them (tab uniform in
    [0.5, 1.5), the rays standard normal), from a seed."""
    rng = np.random.default_rng(seed)
    tab = (rng.random((64, 128)) + 0.5).astype(np.float32)
    rays = [rng.standard_normal((rows, 128)).astype(np.float32) for _ in range(6)]
    return tuple(torch.from_numpy(a).to(device) for a in (tab, *rays))


def bound(rows: int = ROWS, iters: int = ITERS) -> dict:
    """`_probe.bound` of one launch: the table and six ray planes read once;
    out, the stack, the sums and the 64 mask planes written once."""
    lanes = rows * 128
    return _probe.bound(OPS_PER_LANE_STEP * lanes * iters,
                        64 * 128 * 4 + 7 * lanes * 4 + 64 * 4 + 16 + 64 * lanes)


def label(rows: int, mode: str, reduce: str) -> str:
    return f"rows={rows} {mode} reduce={reduce}"


def needed_cycles_per_step(variant: str) -> tuple[float, str]:
    """(cycles, pipe): the one-SM bound of a step of `variant` (a label of
    `variants()`) from the instructions its slab tests need (`NEEDED`; the
    packing of the hits, the reduce and the stack work left out), at
    compute capability 9.0's rates (`sass_count.bound_cycles`), for the
    kernel's CTA at the variant's rows."""
    from .sass_count import bound_cycles

    rows, mode, reduce = variant.split()
    rows, reduce = int(rows.removeprefix("rows=")), reduce.removeprefix("reduce=")
    if variant != label(rows, mode, reduce) or mode not in MODES:
        raise ValueError(f"no variant {variant!r}")
    lpt = rows // 8 if rows > 8 else 1
    tests = lpt * 8 // (2 if mode == "bf16" else 1)  # a thread's test instructions a step
    return bound_cycles({pipe: n * tests for pipe, n in NEEDED.items()}, rows * 128 // lpt // 32)


def variants(device, rows: int = ROWS, iters: int = ITERS) -> dict:
    """label -> `_probe.Variant`: the six variants at `rows` and `iters`
    steps on `make_inputs(device, rows)`."""
    args = make_inputs(device, rows)
    return {label(rows, m, r): _probe.Variant(
                partial(slab_loop, *args, m, r, iters), partial(slab_loop_plain, *args, m, r, iters),
                bound(rows, iters), iters)
            for m in MODES for r in REDUCES}


def variants_at(device, steps: int | None = None) -> dict:
    """Every variant the library launches, at `steps` steps (the tool's
    size where None)."""
    return variants(device, iters=steps or ITERS)


def main(argv=None, device="cuda") -> dict:
    """The six variants at rows (argv[0], default 32) and iters (argv[1],
    default 4096): time and cycles per step on the card (on the CPU the
    plain version runs and nothing is timed)."""
    argv = list(argv or [])
    rows = int(argv[0]) if argv else ROWS
    iters = int(argv[1]) if len(argv) > 1 else ITERS
    return _probe.run_variants(device, variants(device, rows, iters), REPS)


if __name__ == "__main__":
    main(sys.argv[1:])
