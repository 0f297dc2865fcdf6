"""The probes' bounds from their machine code: count the instructions of
each probe kernel's step loop in its SASS, by class, and restate the one-SM
bound of a step from those counts and the per-SM throughput of each class.

    python -m idkengine_tpu_torch.tools.sass_count [probe ...] [--dump DIR]

A probe's first bound (`_probe.bound`) divides the float operations its
source names by 67 TFLOP/s, a rate that counts a fused multiply-add as two
operations; the probes' loops hold no fused multiply-add, and their
min/max and compare instructions issue at half the rate of an add. This
tool reads what the card runs instead: `cuobjdump -sass` of the probe's
library, the loop between the kernel's two clock64() reads, and in it the
instructions every warp issues on every step (those under a forward branch,
taken on some steps only, are left out, so the count stays a lower bound).
Each class's instructions take (warps a scheduler) x (count) / (warp
instructions a scheduler completes a clock) cycles, a warp scheduler
issues one instruction a clock (four schedulers an SM, a CTA's warps
spread over them), and shared and global memory serve the whole SM; the
bound of a step is the largest of those, over the steps a pass of the
loop makes (nvcc unrolls a short step loop by 2 or 4: the add to the
counter that its closing compare reads). The rates are compute capability
9.0's (the CUDA C++ Programming Guide's table of arithmetic instruction
throughput, results a clock an SM): 128 for a float32 add, multiply or
fused multiply-add and for 16-bit pairs (256 halves); 64 for compare,
minimum, maximum and 32-bit integer add, logic, shift and multiply-add;
32 for warp shuffles; 16 for type conversions and the special-function
unit; a shared-memory access, and a local or global one, one warp a
clock. Compares, minima, maxima, selects, integer and logic instructions
and the two-float packing conversion (F2FP) share one pipe (ALU) and are
summed; an integer multiply-add (IMAD, also a move) runs on the fused
multiply-add pipe at half rate, a class of its own; a move (MOV), a
branch and other bookkeeping count only against issue. Where a rate is
taken too low the bound exceeds the measured cycles, and the line says
so. A step loop that holds a loop of its own is reported, not bounded:
its inner trips are not in the machine code.

The count bounds what the compiled loop issues, so it grows with every
instruction the code wastes; each probe is held to the instructions its
function needs instead (its module's `needed_cycles_per_step`), printed
beside it.

On the card each bounded variant runs once more, and its clock64() cycles a
step stand beside the bound; `ms` is the bound at the clock the run
measured (cycles over device time). Every line carries the card's name and
power limit. Needs nvcc's cuobjdump (beside `find_nvcc()`).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from collections import Counter

# warp instructions an SM completes a clock, by class (compute capability
# 9.0; results a clock an SM / 32)
RATES = {"fp32": 4.0, "alu": 2.0, "imad": 2.0, "conv": 0.5, "mufu": 0.5, "shfl": 1.0,
         "shared": 1.0, "memory": 1.0}
ISSUE_PER_CLOCK = 4.0  # four warp schedulers an SM, one instruction a clock each
CLASSES = {
    "fp32": ("FADD", "FMUL", "FFMA", "FADD32I", "FMUL32I", "FFMA32I", "FSWZADD", "HADD2",
             "HMUL2", "HFMA2", "HADD2_32I", "HMUL2_32I", "HFMA2_32I"),
    "alu": ("FMNMX", "FSETP", "FSEL", "FSET", "IMNMX", "ISETP", "HMNMX2", "HSETP2", "HSET2",
            "SEL", "FCHK", "IADD3", "IADD", "IADD32I", "LOP3", "LOP", "LOP32I", "SHF", "SHL",
            "SHR", "LEA", "PRMT", "IABS", "P2R", "R2P", "PLOP3", "VOTE", "BMSK", "SGXT",
            "F2FP", "VIADD", "VIMNMX", "VIADDMNMX", "VHMNMX"),
    "imad": ("IMAD", "IMUL"),
    "conv": ("F2F", "I2F", "F2I", "I2FP", "F2IP", "FRND", "I2I", "POPC", "FLO", "BREV"),
    "mufu": ("MUFU",),
    "shfl": ("SHFL", "REDUX", "MATCH"),
    "shared": ("LDS", "STS", "ATOMS", "LDSM"),
    "memory": ("LDG", "STG", "LDL", "STL", "LD", "ST", "ATOMG", "RED", "LDC"),
}
_OPCLASS = {op: cls for cls, ops in CLASSES.items() for op in ops}

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b")


def opclass(opcode: str) -> str:
    """The class of an opcode with its modifiers (`FMNMX.FTZ`, `LDS.128`);
    a 16-bit pair instruction sent to the tensor pipe (`HFMA2.MMA`) counts
    only against issue."""
    if ".MMA" in opcode:
        return "other"
    return _OPCLASS.get(opcode.split(".")[0], "other")


def functions(sass: str) -> dict:
    """Kernel name (mangled) -> list of (address, predicate, opcode, text)
    in address order, and the label addresses under the key (name, 'labels')."""
    out, name, labels, pending = {}, None, {}, []
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            name = m.group(1)
            out[name], labels = [], {}
            out[(name, "labels")] = labels
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m:
            addr, text = int(m.group(1), 16), m.group(2).strip()
            pred = ""
            if text.startswith("@"):
                pred, text = text.split(None, 1)
            opcode = text.split()[0]
            for lab in pending:
                labels[lab] = addr
            pending = []
            out[name].append((addr, pred, opcode, text))
    return out


def step_loop(instrs: list, labels: dict) -> dict:
    """The loop between the kernel's clock64() reads (the outermost one):
    {'start', 'end', 'counts' (class -> instructions every warp issues a
    pass: none under a forward branch or in an inner loop), 'opcodes'
    (opcode -> the same), 'inner_loops', 'conditional'}. Raises where the
    kernel reads no clock or holds no such loop."""
    clocks = [a for a, _, _, t in instrs if "SR_CLOCKLO" in t]
    if len(clocks) < 2:
        raise ValueError("the kernel reads clock64() fewer than twice")
    lo, hi = clocks[0], clocks[-1]
    branches = []  # (address, target, predicate); a target is a label or an address
    for addr, pred, op, text in instrs:
        m = _TARGET.search(text) if op.startswith("BRA") else None
        if m and (m.group(2) or m.group(1) in labels):
            branches.append((addr, int(m.group(2), 16) if m.group(2) else labels[m.group(1)],
                             pred))
    loops = [(t, a) for a, t, _ in branches if t <= a and lo <= t and a <= hi]
    if not loops:
        raise ValueError("no loop between the clock64() reads")
    start, end = max(loops, key=lambda ta: ta[1] - ta[0])
    skipped = []  # [from, to) spans every warp need not issue on a step
    inner = [(t, a) for t, a in loops if (t, a) != (start, end) and start <= t and a <= end]
    skipped += [(t, a + 1) for t, a in inner]
    for a, t, pred in branches:
        if start <= a < end and a < t <= end + 1:
            skipped.append((a + 1, t))  # a forward branch: the code it jumps over
    counts, opcodes, cond = Counter(), Counter(), 0
    for addr, pred, op, text in instrs:
        if not start <= addr <= end:
            continue
        if any(f <= addr < t for f, t in skipped):
            cond += 1
            continue
        counts[opclass(op)] += 1
        opcodes[op] += 1
    return {"start": start, "end": end, "counts": dict(counts), "opcodes": dict(opcodes),
            "inner_loops": len(inner), "conditional": cond,
            "unroll": unroll_factor(instrs, start, end)}


_REG = re.compile(r"\bU?R\d+\b")
_PRED = re.compile(r"\bU?P[0-6]\b")
_STEP = re.compile(r"^(?:IADD3|VIADD|UIADD3|IADD)\s+(U?R\d+),\s*(U?R\d+)(?:\.reuse)?,\s*(-?0x[0-9a-f]+)")


def _compared(body: list, pred: str) -> set:
    """The registers that the compare setting predicate `pred` reads,
    through a predicate move (PLOP3 from a uniform predicate)."""
    for _, _, op, text in reversed(body):
        operands = text.split(None, 1)[1] if " " in text else ""
        if not operands.startswith(pred + ","):
            continue
        base = op.split(".")[0]
        if base in ("ISETP", "UISETP"):
            return set(_REG.findall(operands))
        if base == "PLOP3":
            sources = [p for p in _PRED.findall(operands)[1:] if p not in ("PT", "UPT")]
            return _compared(body, sources[0]) if sources else set()
        return set()
    return set()


def unroll_factor(instrs: list, start: int, end: int) -> int | None:
    """Steps a pass of the loop [start, end] makes: |c| of the add `Rk = Rk
    + c` to a register that the compare of the loop's closing branch reads,
    or that a register it reads is offset from (`Rj = Rk + c'`: the
    compare tests i + 4 <= iters where the counter holds i + 3). nvcc
    unrolls a short loop body, by 2 or 4, with a remainder loop after it;
    a source loop of groups of steps steps by the group. None where no
    such add is found."""
    body = [(a, p, op, t) for a, p, op, t in instrs if start <= a <= end]
    regs = _compared(body[:-1], body[-1][1].lstrip("@!"))
    for _, _, op, text in body:
        m = _STEP.match(text)
        if m and m.group(1) in regs:
            regs = regs | {m.group(2)}
    for _, _, op, text in body:
        m = _STEP.match(text)
        if m and m.group(1) == m.group(2) and m.group(1) in regs:
            step = int(m.group(3), 16)
            return abs(step - (1 << 32) if step >= 1 << 31 else step)
    return None


def bound_cycles(counts: dict, warps: int) -> tuple[float, str]:
    """(cycles a pass on one SM, what bounds it) for a CTA of `warps` warps
    issuing `counts` (class -> warp instructions a pass) each. The warps
    share the four schedulers, each issuing one instruction a clock and
    owning a quarter of every pipe; shared and global memory are one unit
    an SM."""
    per_scheduler = -(-warps // 4)
    limits = {"issue": per_scheduler * sum(counts.values())}
    for cls, n in counts.items():
        if cls in ("shared", "memory"):
            limits[cls] = warps * n / RATES[cls]
        elif cls in RATES:
            limits[cls] = per_scheduler * n / (RATES[cls] / 4)
    by = max(limits, key=limits.get)
    return limits[by], by


def cuobjdump() -> str:
    from ..ops._build import find_nvcc

    return os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")


def dump(library_path: str) -> str:
    return subprocess.run([cuobjdump(), "-sass", library_path], check=True, capture_output=True,
                          text=True, timeout=300).stdout


def template_args(name: str, kernel: str) -> list[int] | None:
    """The integer and bool template arguments of a mangled instantiation of
    `kernel` (`..._kernelILb0ELi0ELi4EE...` -> [0, 0, 4]); None where the
    name is another kernel's."""
    m = re.search(kernel + r"I((?:L[bi]-?\d+E)+)E", name)
    return [int(x) for x in re.findall(r"L[bi](-?\d+)E", m.group(1))] if m else None


def kernels_by_label(sass: str, kernel: str, labels: dict, warps: int) -> dict:
    """label -> (step loop, warps) for each instantiation of `kernel` whose
    template arguments are a key of `labels` (tuple of ints -> label)."""
    found, fns = {}, functions(sass)
    for name, instrs in fns.items():
        args = None if isinstance(name, tuple) else template_args(name, kernel)
        if args is not None and tuple(args) in labels:
            found[labels[tuple(args)]] = (step_loop(instrs, fns[(name, "labels")]), warps)
    return found


def probe_kernels(probe: str, sass: str) -> dict:
    """The probe's variants at its tool's default size -> (step loop, warps
    a CTA): the instantiation each variant launches. Every probe runs one
    CTA of 1,024 threads (P1 at its default 32 rows: 4 lanes a thread)."""
    from importlib import import_module

    m = import_module(f"{__package__}.{probe}")
    warps = 1024 // 32
    if probe == "bench_slab":
        lpt = m.ROWS // 8 if m.ROWS > 8 else 1
        labels = {(int(mode == "bf16"), m.REDUCES.index(r), lpt): f"rows={m.ROWS} {mode} reduce={r}"
                  for mode in m.MODES for r in m.REDUCES}
        return kernels_by_label(sass, "probe_slab_kernel", labels, warps)
    if probe == "bench_reduce":
        return kernels_by_label(sass, "probe_reduce_kernel",
                                {(i,): mode for i, mode in enumerate(m.MODES)}, warps)
    if probe == "bench_dual":
        return kernels_by_label(sass, "probe_dual_kernel",
                                {(n, int(defer)): m.LABELS[k] for k, (n, defer) in m.KINDS.items()},
                                warps)
    if probe == "bench_prims":
        found = kernels_by_label(sass, "probe_prims_kernel",
                                 {(i, m.DEFAULT_K if b in m.UNROLLED else 0): m.label(b, m.DEFAULT_K)
                                  for i, b in enumerate(m.BODIES)}, warps)
        floor = m.label("e", m.DEFAULT_K)  # body e's loop runs in thread 0 alone
        if floor in found:
            found[floor] = (found[floor][0], 1)
        return found
    lpt = 4096 // 128 // 8  # bench_mxu_leaf at variants()' default 4,096 rays: 32 rows
    return {**kernels_by_label(sass, "probe_vpu_kernel", {(lpt,): "vpu_moller"}, warps),
            **kernels_by_label(sass, "probe_form_kernel", {(lpt,): "mxu_form"}, warps)}


PROBES = ("bench_slab", "bench_mxu_leaf", "bench_reduce", "bench_dual", "bench_prims")


def restate(probe: str, sass_dir: str | None = None) -> dict:
    """label -> dict(counts, opcodes, bound_cycles_per_step, bound_by,
    inner_loops, conditional) for the probe's variants at the tool's
    size, from the SASS of its built library."""
    from importlib import import_module

    module = import_module(f"{__package__}.{probe}")
    path = module.build_kernels()[0]
    sass = dump(path)
    if sass_dir:
        os.makedirs(sass_dir, exist_ok=True)
        with open(os.path.join(sass_dir, f"{probe}.sass"), "w") as f:
            f.write(sass)
    out = {}
    for label, (loop, warps) in probe_kernels(probe, sass).items():
        entry = dict(warps=warps, counts=loop["counts"], opcodes=loop["opcodes"],
                     inner_loops=loop["inner_loops"], conditional=loop["conditional"],
                     steps_a_pass=loop["unroll"])
        if loop["inner_loops"] == 0 and loop["unroll"]:
            cycles, by = bound_cycles(loop["counts"], warps)
            entry.update(bound_cycles_per_step=cycles / loop["unroll"], bound_by=by)
        out[label] = entry
    return out


def main(argv=None) -> dict:
    """Each probe's restated bounds beside its measured cycles a step on
    the card, one line a variant, then one JSON object."""
    import torch

    from . import _probe

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probes", nargs="*", help=f"any of {', '.join(PROBES)} (default: all)")
    ap.add_argument("--dump", help="write each library's SASS into this directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sass_count: no CUDA card")
    card = _probe.card()
    from importlib import import_module

    result = {}
    for probe in args.probes or PROBES:
        if probe not in PROBES:
            raise SystemExit(f"sass_count: no probe {probe!r}; the probes are {PROBES}")
        module = import_module(f"{__package__}.{probe}")
        bounds = restate(probe, args.dump)
        runs = module.variants_at("cuda")
        for label, b in bounds.items():
            if "bound_cycles_per_step" not in b or label not in runs:
                why = (f"the step loop holds {b['inner_loops']} loop(s) of its own"
                       if b["inner_loops"] else "its steps a pass were not found")
                print(f"[{card}] {probe} {label}: {why}, not bounded; warp instructions a "
                      f"pass outside inner loops {b['counts']}", flush=True)
                continue
            run = runs[label]
            ms = _probe.time_ms(run.kernel, 3)
            res = run.kernel()
            steps = run.units
            cycles = int(res.cycles.item()) / steps
            b.update(measured_cycles_per_step=cycles, measured_ms=ms,
                     clock_hz=cycles * steps / (ms * 1e-3), old_one_sm_ms=run.bound["one_sm_ms"])
            b["bound_ms"] = b["bound_cycles_per_step"] * steps / b["clock_hz"] * 1e3
            b["share_of_bound"] = b["bound_cycles_per_step"] / cycles
            needed, by = module.needed_cycles_per_step(label)
            b.update(needed_cycles_per_step=needed, needed_by=by,
                     needed_ms=needed * steps / b["clock_hz"] * 1e3,
                     share_of_needed=needed / cycles)
            print(f"[{card}] {probe} {label}: the instructions its function needs bound a "
                  f"step at {needed:.1f} cycles by {by}, {b['needed_ms']:.4f} ms "
                  f"({b['share_of_needed']:.1%} of the measured cycles)", flush=True)
            note = ("" if b["share_of_bound"] <= 1.0 else
                    "; ABOVE the measured cycles: a class's rate is taken too low")
            print(f"[{card}] {probe} {label}: {cycles:.1f} cycles a step against a bound "
                  f"of {b['bound_cycles_per_step']:.1f} by {b['bound_by']} "
                  f"({b['share_of_bound']:.1%} of it{note}), {ms:.4f} ms against "
                  f"{b['bound_ms']:.4f} ms at {b['clock_hz'] / 1e9:.3f} GHz (the old "
                  f"one-SM bound {b['old_one_sm_ms']:.4f} ms); warp instructions a pass "
                  f"of {b['steps_a_pass']} step(s) {b['counts']}", flush=True)
        result[probe] = bounds
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
