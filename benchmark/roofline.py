"""The least time of the program's trace calls, from what each call needs:
its live rays read once (origin, direction, t_max: 28 bytes), its results
written once for every ray (t, slot, u, v: 16 bytes; or one occlusion
byte), and the share of the scene's tables (the 4-wide node records, and
36 bytes a triangle: p0, e1, e2) that its live rays need: the whole tables
for a frame's worth of rays (one a pixel) or more, and for fewer rays the
tables scaled by live rays over pixels. So a frame's rays, split over any
number of calls, are charged the tables once, and a call with no live ray
reads none. The bytes over the card's memory rate (peaks.json) give the
least time.

`record_traces` stands a recorder in for the port's public trace entry
points while the traced frames run: each call's kind, ray count, t_max
(kept, to count live rays once the frames are done) and scene tables.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
from dataclasses import dataclass

import torch

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")
ENTRY_POINTS = {"trace_closest": 16, "trace_any": 1}  # result bytes a ray
RAY_BYTES = 28
TRIANGLE_BYTES = 36


def peaks(device_name: str):
    """The card's published rates ({"hbm_bytes_per_s", ...}), or None."""
    with open(PEAKS) as f:
        return json.load(f).get(device_name)


def table_bytes(scene) -> int:
    return int(scene.bvh4_nodes.numel() * scene.bvh4_nodes.element_size()
               + scene.tri_p0.shape[0] * TRIANGLE_BYTES)


@dataclass
class Call:
    kind: str
    rays: int
    t_max: object  # tensor or number
    tables: int

    def live(self) -> int:
        if isinstance(self.t_max, torch.Tensor):
            n = int((self.t_max > 0).sum())
            return n if self.t_max.numel() > 1 else (self.rays if n else 0)
        return self.rays if self.t_max > 0 else 0

    def bytes(self, pixels: int) -> int:
        """The call's bytes in a frame of `pixels` pixels."""
        live = self.live()
        return (live * RAY_BYTES + self.rays * ENTRY_POINTS[self.kind]
                + self.tables * min(live, pixels) // pixels)


@contextlib.contextmanager
def record_traces(package: str):
    """Record every call of the package's trace entry points (ENTRY_POINTS
    of its ops.packet_trace), wherever the package's modules hold them."""
    from importlib import import_module

    pt = import_module(f"{package}.ops.packet_trace")
    calls = []
    originals = {k: getattr(pt, k) for k in ENTRY_POINTS}

    def recording(kind, fn):
        def run(scene, o, d, t_max, *args, **kw):
            calls.append(Call(kind, int(o.shape[0]), t_max, table_bytes(scene)))
            return fn(scene, o, d, t_max, *args, **kw)
        run.__wrapped__ = fn
        # the entry points count their own launches through their module's
        # name, which the recorder holds for now
        if hasattr(fn, "launches"):
            run.launches = fn.launches
        return run

    patched = []
    for name, mod in list(sys.modules.items()):
        if mod is None or name.split(".")[0] != package:
            continue
        for k, fn in originals.items():
            if getattr(mod, k, None) is fn:
                patched.append((mod, k, fn))
                setattr(mod, k, recording(k, fn))
    try:
        yield calls
    finally:
        for mod, k, fn in patched:
            run = getattr(mod, k)
            if hasattr(fn, "launches") and mod is pt:
                fn.launches = run.launches
            setattr(mod, k, fn)
