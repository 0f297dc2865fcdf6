"""trace_nodes_per_ray: 4-wide node records a ray visits in the hand trace
kernel, summed over its call sites: the program's counters
(profiling.report(): rays, nodes, tris a call site), which the counting
kernel fills while a profiler runs, so in the traced frames alone. Nothing
is read where the program keeps no such counters."""
from importlib import import_module

from benchmark.harness import PACKAGE


def totals(data):
    """(rays, nodes, tris) over the call sites, or None."""
    if data.timeline is None:
        return None
    report = getattr(import_module(f"{PACKAGE}.profiling"), "report", None)
    rows = [row for row in (report() if report else {}).values()
            if isinstance(row, dict) and {"rays", "nodes", "tris"} <= set(row)]
    rays = sum(row["rays"] for row in rows)
    if not rays:
        return None
    return rays, sum(row["nodes"] for row in rows), sum(row["tris"] for row in rows)


def read(data):
    t = totals(data)
    return None if t is None else t[1] / t[0]
