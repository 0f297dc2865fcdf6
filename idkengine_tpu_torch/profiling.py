"""Profiling/tracing hooks. Counterpart: idkengine_tpu/profiling.py.

Role of the reference's GL debug groups + TimerQuery
(ref: BBG/Source/Computing.cs:11-16 named passes, Objects/TimerQuery.cs):
named ranges through `torch.profiler.record_function` plus a lightweight
host-side pass timer that works through the asynchronous launches (it
synchronizes the value's device at scope exit).
"""
from __future__ import annotations

import collections
import contextlib
import os
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .log import get_logger

log = get_logger(__name__)

_timings: dict[str, list] = collections.defaultdict(list)
_trace = None  # (profiler, directory) of start_trace


def _default_dir(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


def _tensors(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)


def synchronize(value):
    """Wait for the work that makes every tensor in `value` (a tensor or a
    nested list, tuple or dict of them): each CUDA device they lie on is
    synchronized once (the role of jax.block_until_ready)."""
    for dev in {t.device for t in _tensors(value) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def pass_scope(name: str, sync_value=None):
    """Named pass scope: a torch.profiler range; if sync_value is given,
    synchronize its device at exit and record the wall time (TimerQuery
    role). sync_value may be a callable that returns the value, for a value
    made inside the scope."""
    with record_function(name):
        t0 = time.perf_counter()
        yield
        if sync_value is not None:
            synchronize(sync_value)
        _timings[name].append((time.perf_counter() - t0) * 1e3)


def _activities():
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def start_trace(log_dir: str | None = None):
    """Begin a torch.profiler trace; stop_trace writes it to `log_dir` as a
    Chrome trace (view in chrome://tracing or Perfetto)."""
    global _trace
    if _trace is not None:
        raise RuntimeError("a trace is already running")
    prof = profile(activities=_activities())
    prof.start()
    _trace = (prof, log_dir or _default_dir("idk_trace"))


def stop_trace() -> str:
    """End the trace of start_trace; returns the trace file's path."""
    global _trace
    if _trace is None:
        raise RuntimeError("no trace is running")
    prof, log_dir = _trace
    _trace = None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


def report() -> dict[str, float]:
    """Mean ms per named pass since the last reset."""
    return {k: sum(v) / max(len(v), 1) for k, v in _timings.items()}


def reset():
    _timings.clear()


def log_report():
    for name, ms in sorted(report().items()):
        log.info("pass %-28s %.2f ms", name, ms)


# ---------------------------------------------------------------------------
# Device-event capture (role of the reference's per-pass TimerQuery tables)
# ---------------------------------------------------------------------------

def bucket(name: str) -> str:
    """The bucket of one device kernel by its name, with the JAX package's
    bucket names. The port's hand kernels (csrc/*.cu, launched through
    ctypes) carry no call-site tag, so a closest-hit trace is not told
    apart as a primary or a bounce: the closest-hit kernels (`trace_kernel`
    and `trace_capped_kernel` with ANY_HIT false, the two-phase kernels)
    go to trace_other, the any-hit ones to nee; PyTorch's elementwise,
    reduction and indexing kernels to xla_glue (the JAX package's name for
    its XLA glue)."""
    n = name.lower()
    if "trace_kernel" in n or "trace_capped_kernel" in n:
        any_hit = "<true" in n or "<(bool)1" in n or "ilb1e" in n  # demangled or mangled
        return "nee" if any_hit else "trace_other"
    if "phase_a" in n or "phase_b" in n or "trace_steps" in n:
        return "trace_other"
    if "scatter_max" in n or "voxel" in n:
        return "voxelize"
    if "sort" in n:
        return "sorts"
    if "memcpy" in n or "memset" in n or "copy" in n:
        return "copies"
    return "xla_glue"


def capture_device_profile(fn) -> dict[str, float]:
    """Run fn() under torch.profiler and return {bucket: ms} of device
    kernel time (`bucket`), with "total_device" their sum, largest first;
    {} where the profiler traced no device kernel (no card)."""
    with profile(activities=_activities()) as prof:
        out = fn()
        synchronize(out)
    events = prof.key_averages()
    # a record_function range shows on the device as a span over its kernels
    # under its own name; the sum takes the kernels alone
    ranges = {e.key for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    by = collections.defaultdict(float)
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CUDA and e.key not in ranges
                and e.self_device_time_total > 0):
            by[bucket(e.key)] += e.self_device_time_total / 1e3
    if not by:
        return {}
    by["total_device"] = sum(by.values())
    return {k: round(v, 1) for k, v in sorted(by.items(), key=lambda kv: -kv[1])}
