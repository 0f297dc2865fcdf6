"""gbuffer_ms: device ms a traced frame of the deferred frame's G-buffer:
the operations launched inside its span deferred/G-buffer (render/gbuffer.py:
the jittered primary rays, the attributes, the velocity), less the hand
trace kernels among them."""
from benchmark.metrics.voxelize_ms import span_ms


def read(data):
    return span_ms(data, {"deferred/G-buffer"})
