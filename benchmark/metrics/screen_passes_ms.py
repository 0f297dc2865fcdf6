"""screen_passes_ms: device ms a traced frame of the deferred frame's image
passes over the whole frame: the operations launched inside its spans
deferred/SSAO, deferred/bloom, deferred/TAA and deferred/tonemap."""
from benchmark.metrics.voxelize_ms import span_ms

SPANS = {"deferred/SSAO", "deferred/bloom", "deferred/TAA", "deferred/tonemap"}


def read(data):
    return span_ms(data, SPANS)
