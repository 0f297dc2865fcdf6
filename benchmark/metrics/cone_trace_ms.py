"""cone_trace_ms: device ms a traced frame of the deferred frame's
cone-traced GI: the operations launched inside its span deferred/cone trace
(render/vxgi.py VoxelGrid.cone_trace: six cones of ten trilinear mip
samples a pixel, in PyTorch)."""
from benchmark.metrics.voxelize_ms import span_ms


def read(data):
    return span_ms(data, {"deferred/cone trace"})
