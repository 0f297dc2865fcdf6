"""The least time of the program's voxelizer scatter
(`ops.voxel_scatter.scatter_max_dense`: a zero fill of the grid, then the
per-cell max kernel KERNEL): each update's cell id (4 bytes) and its C
values (4 bytes each) read once, and the dense (C, n_cells) float32 grid
written once. Those bytes over the card's memory rate (peaks.json) give the
least time.

`record_scatters` stands a recorder in for that entry point wherever the
program's modules hold it: under a profiler each call runs inside a host
range named RANGE and its byte count, which the timeline ties to what the
call launches; without a profiler the call runs as it is.
"""
from __future__ import annotations

import contextlib
import sys
from importlib import import_module

import torch
from torch.profiler import record_function

KERNEL = "scatter_max_kernel"
RANGE = "benchmark/scatter_max bytes="
ID_BYTES = VALUE_BYTES = 4


def call_bytes(n_updates: int, channels: int, n_cells: int) -> int:
    return n_updates * (ID_BYTES + channels * VALUE_BYTES) + channels * n_cells * VALUE_BYTES


def bytes_of(ranges) -> int | None:
    """The byte count that one of a kernel's host ranges names, or None."""
    found = [int(r[len(RANGE):]) for r in ranges if r.startswith(RANGE)]
    return found[0] if len(found) == 1 else None


@contextlib.contextmanager
def record_scatters(package: str):
    mod = import_module(f"{package}.ops.voxel_scatter")
    fn = mod.scatter_max_dense

    def run(cell, vals, n_cells, *args, **kw):
        if not torch.autograd._profiler_enabled():
            return fn(cell, vals, n_cells, *args, **kw)
        with record_function(RANGE + str(call_bytes(int(cell.shape[0]), int(vals.shape[0]),
                                                    int(n_cells)))):
            return fn(cell, vals, n_cells, *args, **kw)
    # the entry point counts its launches through its module's name, which
    # the recorder holds for now
    run.launches = fn.launches

    patched = [m for name, m in list(sys.modules.items())
               if m is not None and name.split(".")[0] == package
               and getattr(m, "scatter_max_dense", None) is fn]
    for m in patched:
        m.scatter_max_dense = run
    try:
        yield
    finally:
        fn.launches = run.launches
        for m in patched:
            m.scatter_max_dense = fn
