"""pt_textures_ms: device ms a traced frame of the path tracer's materials
and alpha layer: the operations launched inside its ranges pt/textures,
pt/alpha re-traces and pt/shadow alpha rounds, less the hand trace kernels
among them."""
from benchmark.metrics.trace_ms import hand

TEXTURE_RANGES = {"pt/textures", "pt/alpha re-traces", "pt/shadow alpha rounds"}


def read(data):
    tl = data.timeline
    if tl is None:
        return None
    ops = [op for op in tl.ops if op.ranges & TEXTURE_RANGES and not hand(op, data.hand_kernels)]
    return sum(op.ms for op in ops) / tl.frames if ops else None
