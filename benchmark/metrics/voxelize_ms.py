"""voxelize_ms: device ms a traced frame of the deferred frame's voxelizer:
the operations launched inside its span deferred/voxelize
(render/pipeline.py: the samples, their shadowed injection, the scatter-max
kernel, the mips and the atlas), less the hand trace kernels among them."""
from benchmark.metrics.trace_ms import hand


def span_ms(data, spans):
    """Device ms a traced frame of the operations launched inside any of
    `spans`, less the hand trace kernels; None where there is none."""
    tl = data.timeline
    if tl is None:
        return None
    ops = [op for op in tl.ops if op.ranges & spans and not hand(op, data.hand_kernels)]
    return sum(op.ms for op in ops) / tl.frames if ops else None


def read(data):
    return span_ms(data, {"deferred/voxelize"})
