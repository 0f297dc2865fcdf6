"""pt_glue_ms: device ms a traced frame of the path tracer's glue
(render/pathtracer.py): every device operation that is neither a hand
trace kernel nor launched inside the texture and alpha ranges."""
from benchmark.metrics.pt_textures_ms import TEXTURE_RANGES
from benchmark.metrics.trace_ms import hand


def read(data):
    tl = data.timeline
    if tl is None:
        return None
    ops = [op for op in tl.ops
           if not hand(op, data.hand_kernels) and not (op.ranges & TEXTURE_RANGES)]
    return sum(op.ms for op in ops) / tl.frames if ops else None
