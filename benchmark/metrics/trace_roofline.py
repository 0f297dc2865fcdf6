"""trace_roofline: the traced frames' trace launches' least time (their
bytes over the card's memory rate, roofline.py, the tables charged by live
rays over the frame's pixels) over their kernel time, in percent. Nothing
is read where the recorded calls do not account for every hand trace
kernel launched, or the card has no entry in peaks.json."""
from benchmark.metrics.trace_ms import hand


def read(data):
    tl, calls = data.timeline, data.trace_calls
    if tl is None or not calls or not data.peaks:
        return None
    kernels = [op for op in tl.ops if hand(op, data.hand_kernels)]
    if not kernels or len(kernels) != sum(1 for c in calls if c.rays > 0):
        return None
    least_s = sum(c.bytes(data.pixels) for c in calls) / data.peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / (sum(op.ms for op in kernels) / 1e3)
