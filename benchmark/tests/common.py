"""Small cells for the CPU: the repository's cells at 48x32 on a 20,000
triangle atrium (a 64x32 sky where the scene has one), a few frames."""
import time

from benchmark import harness

SMALL = {"config": {"width": 48, "height": 32},
         "traffic": {"scene": {"triangles": 20000, "env": [64, 32]}, "trace_frames": 2,
                     "check": {"frames": 3, "pixels": 512}}}


def small_run(seed=11, trace=False, control=False, seconds=0.5, device="cpu", over=None,
              workload="pt-atrium2m"):
    return harness.run_cell(workload, seed, seconds, trace, time.perf_counter(),
                            device=device, overrides=harness.merged(SMALL, over),
                            control=control, log=lambda s: None)
