"""Time a row gather on the card by table width: 2,073,600 random rows
(a 1920x1080 ray batch) out of a 2,755,496-row float32 table (the 2.8M
atrium's triangle slots), as `table[idx]` and as `torch.index_select`.

    python -m idkengine_tpu_torch.tools.gather_widths [width ...]

Not a TPU microbenchmark's port: the path tracer's per-slot attribute
tables (render/pathtracer.py) take their widths from it. PyTorch gathers
rows whose width is a multiple of four floats with a vectorized kernel
whose time on the card does not follow the width. Prints one line a width
with the card's name and power limit. Needs a CUDA card; exits nonzero
without one.
"""
import sys

import torch

from ._probe import card, time_ms

SLOTS, RAYS = 2_755_496, 2_073_600
WIDTHS = (9, 10, 12, 15, 16, 22, 23, 24, 25, 32, 46, 48)
REPS = 20


def main(argv=None):
    if not torch.cuda.is_available():
        print("gather_widths: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    name = card()
    g = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(0, SLOTS, (RAYS,), generator=g, device=dev)
    for w in [int(a) for a in (sys.argv[1:] if argv is None else argv)] or WIDTHS:
        table = torch.randn(SLOTS, w, generator=g, device=dev)
        print(f"# width {w} floats: table[idx] {time_ms(lambda: table[idx], REPS):.3f} ms, "
              f"index_select {time_ms(lambda: torch.index_select(table, 0, idx), REPS):.3f} ms; "
              f"{RAYS} rows of {SLOTS}; on {name}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
