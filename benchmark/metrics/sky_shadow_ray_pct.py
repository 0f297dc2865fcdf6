"""sky_shadow_ray_pct: the share of the deferred lighting pass's live shadow
rays cast from pixels with no surface, in percent: the program's own counts
(profiling.shadow_report(): rays, sky_rays), which its lighting pass adds
while a profiler runs, so in the traced frames alone. Nothing is read where
the program keeps no such counts."""
from importlib import import_module

from benchmark.harness import PACKAGE


def read(data):
    if data.timeline is None:
        return None
    report = getattr(import_module(f"{PACKAGE}.profiling"), "shadow_report", None)
    counts = report() if report else {}
    if not counts.get("rays"):
        return None
    return 100.0 * counts["sky_rays"] / counts["rays"]
