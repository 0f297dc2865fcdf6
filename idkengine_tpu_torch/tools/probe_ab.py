"""Time a probe's kernels built from several sources, in turns, on one
CUDA card, each held to the plain version first.

    python -m idkengine_tpu_torch.tools.probe_ab PROBE LABEL=SOURCE ...
                                                 [--reps N] [--check N ...]

PROBE is one of `sass_count.PROBES` (bench_reduce, bench_dual, ...). Each
SOURCE is a csrc/<PROBE>.cu of this tree's interface (an older copy, for
example `git show <commit>:idkengine_tpu_torch/csrc/bench_dual.cu` with its
probe_common.cuh beside it in one directory under build/), built with the
probes' nvcc flags into build/libidk_probe_ab_<PROBE>_<LABEL>.so; the
compilers run together. While a library runs it stands in the probe
module's `_LIB`, so the module's wrappers launch it.

Each library first runs every variant at each --check step count (default
1 2 3 4 5 256; bench_mxu_leaf: leaf visits) against its plain version on the
card: outputs and chain state equal (bench_mxu_leaf: the slots on 99.9% of
the rays, t within `T_TOL` where they agree); a library that disagrees
fails the run. Then every variant at the tool's size is timed (CUDA-event
mean over --reps launches, default the tool's) for the libraries in the
order given and again in reverse (A B C C B A), beside its clock64()
cycles a step (a tri-visit for bench_mxu_leaf), the clock those imply, and
the bound from the instructions its function needs
(`needed_cycles_per_step`) with the share reached; every line carries the
card's name and power limit. The last line is one JSON object: label ->
variant -> list of {ms, cycles} in turn order, with the needed bounds.
"""
from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from importlib import import_module

from . import _probe

DEFAULT_CHECKS = (1, 2, 3, 4, 5, 256)
SLOT_AGREE = 0.999  # bench_mxu_leaf: slots equal on at least this share of rays


def check(module, got, want, what: str):
    """Raises AssertionError where the kernel's result is not its plain
    version's (a leaf's hits, bench_mxu_leaf's: within its tolerance)."""
    import torch

    if "slot" in want.chain:
        same = got.chain["slot"] == want.chain["slot"]
        share = same.float().mean().item()
        if share < SLOT_AGREE:
            raise AssertionError(f"{what}: slots agree on {share:.6f} of the rays")
        torch.testing.assert_close(got.chain["t"][same], want.chain["t"][same],
                                   **module.T_TOL[what.split()[-1]])
        return
    if not torch.equal(got.out, want.out):
        raise AssertionError(f"{what}: out differs from the plain version")
    for k in want.chain:
        if not torch.equal(got.chain[k], want.chain[k]):
            raise AssertionError(f"{what}: chain[{k!r}] differs from the plain version")


def main(argv=None) -> dict:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probe")
    ap.add_argument("libraries", nargs="+", metavar="LABEL=SOURCE")
    ap.add_argument("--reps", type=int)
    ap.add_argument("--check", type=int, nargs="*", default=list(DEFAULT_CHECKS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_ab: no CUDA card")
    module = import_module(f"{__package__}.{args.probe}")
    card = _probe.card()
    libs = {}
    for spec in args.libraries:
        label, _, path = spec.partition("=")
        libs[label] = _probe.Library(f"probe_ab_{args.probe}_{label}",
                                     module._LIB.entry_points, path)
    with ThreadPoolExecutor(len(libs)) as pool:
        for label, (_, log) in zip(libs, pool.map(lambda lib: lib.build(), libs.values())):
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "error" in line.lower():
                    print(f"# {label}: {line.strip()}", flush=True)
    saved = module._LIB
    dev = torch.device("cuda")
    reps = args.reps or getattr(module, "REPS", 5)
    result = {label: {} for label in libs}
    try:
        for label, lib in libs.items():
            module._LIB = lib
            for steps in args.check:
                for name, v in module.variants_at(dev, steps).items():
                    got = v.kernel()
                    torch.cuda.synchronize()
                    check(module, got, v.plain(), f"{label} {steps} steps {name}")
            print(f"[{card}] {label}: every variant equals its plain version at "
                  f"{args.check} steps", flush=True)
        tool = module.variants_at(dev)
        order = list(libs) + list(reversed(libs))
        for label in order:
            module._LIB = libs[label]
            for name, v in tool.items():
                ms = _probe.time_ms(v.kernel, reps)
                cycles = int(v.kernel().cycles.item()) / v.units
                clock = cycles * v.units / (ms * 1e-3)
                needed, by = module.needed_cycles_per_step(name)
                result[label].setdefault(name, []).append(dict(ms=ms, cycles=cycles))
                print(f"[{card}] {label} {name}: {ms:.4f} ms, {cycles:.1f} cycles a step at "
                      f"{clock / 1e9:.3f} GHz; needed {needed:.1f} cycles by {by} "
                      f"({needed / cycles:.1%} of the cycles"
                      f"{'; ABOVE them: a rate is taken too low' if needed > cycles else ''}), "
                      f"{needed * v.units / clock * 1e3:.4f} ms", flush=True)
    finally:
        module._LIB = saved
    needed = {name: module.needed_cycles_per_step(name) for name in tool}
    print(json.dumps({"card": card, "probe": args.probe, "needed_cycles": needed,
                      "runs": result}))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
