"""trace_tris_per_ray: triangles a ray tests in the hand trace kernel,
summed over its call sites (the counters trace_nodes_per_ray reads)."""
from benchmark.metrics.trace_nodes_per_ray import totals


def read(data):
    t = totals(data)
    return None if t is None else t[2] / t[0]
