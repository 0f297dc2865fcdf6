"""scatter_roofline: the traced frames' voxelizer scatters' least time (their
bytes over the card's memory rate, scatter.py) over the device time of what
each call launches (the grid's zero fill and the scatter-max kernel), in
percent. Nothing is read where some scatter kernel has no recorded byte
count, or the card has no entry in peaks.json."""
from benchmark.scatter import KERNEL, RANGE, bytes_of


def read(data):
    tl = data.timeline
    if tl is None or not data.peaks:
        return None
    calls = [op for op in tl.ops if any(r.startswith(RANGE) for r in op.ranges)]
    counts = [bytes_of(op.ranges) for op in calls if KERNEL in op.name]
    if not counts or None in counts:
        return None
    least_s = sum(counts) / data.peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / (sum(op.ms for op in calls) / 1e3)
