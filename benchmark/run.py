"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload pt-atrium2m --seed 7 --seconds 10 --trace 0

from the root of a checkout that holds the program (`idkengine_tpu_torch`).
Set-up (scene, build, the first frames, which build the CUDA libraries in
the checkout's build/ the first time) counts from this process's start to
the first timed frame; then frames are timed for --seconds; with --trace 1
a few more frames run under torch.profiler and the per-layer metrics are
read from them. The last lines on standard error give each number the
check compared with its limit; the last line on standard output is the
result as one JSON object.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[0] = ROOT  # the checkout, not this folder
    # kernel caches at fixed places inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch-extensions")

    import torch

    from benchmark import harness

    spec, wl, _, _ = harness.cell(args.workload, ROOT)
    chips = int(wl["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  T_START, root=ROOT)
    except ImportError as e:
        print(f"not run: {e}", file=sys.stderr)
        return 4
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
