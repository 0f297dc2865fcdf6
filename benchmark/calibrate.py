"""The readings a cell's check limits are set from, on the card at the
cell's own size: for each seed, one short run of the program checked
against the plain reference (the lower reading), and the reference in the
precision below the stated one put in the program's place (the control,
the upper reading). Every seed in one process; one JSON line a seed.

    python3 benchmark/calibrate.py --workload pt-atrium2m --seconds 2 --seeds 11 12 13
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[0] = ROOT
    from benchmark import harness

    for seed in args.seeds:
        t = time.perf_counter()
        res = harness.run_cell(args.workload, seed, args.seconds, False, t, root=ROOT,
                               control=True)
        line = {"seed": seed, "correct": res["correct"], "frames": res["attempted"],
                **{f"program.{k}": v["value"] for k, v in res["check"].items()},
                **{f"control.{k}": v for k, v in res["control"].items()},
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
