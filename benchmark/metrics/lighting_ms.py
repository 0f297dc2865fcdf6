"""lighting_ms: device ms a traced frame of the deferred lighting: the
operations launched inside its span deferred/lighting + shadows
(render/deferred.py: per light the shadow ray's sample, GGX, attenuation;
then the cone-traced GI times albedo and AO), less the hand trace kernels
of its shadow rays."""
from benchmark.metrics.voxelize_ms import span_ms


def read(data):
    return span_ms(data, {"deferred/lighting + shadows"})
