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

# the port's hand traversal kernels (csrc/trace.cu, csrc/two_phase.cu): the
# kernels a call-site range buckets
HAND_TRACE_KERNELS = ("trace_kernel", "trace_capped_kernel", "trace_steps_kernel",
                      "two_level_kernel", "two_level_capped_kernel", "phase_a_kernel",
                      "phase_b_kernel")


def call_site_name(any_hit: bool, tag: str = "") -> str:
    """The profiler range of a trace launch tagged `tag` at its call site,
    named as the JAX package names its Pallas tracer's kernel (without its
    plain/steer part): pt_closest_<tag> or pt_any_<tag>, x for no tag."""
    return f"pt_{'any' if any_hit else 'closest'}_{tag or 'x'}"


def call_site(any_hit: bool, tag: str = ""):
    """The range around a trace launch (record_function, about a
    microsecond without a profiler); see call_site_name."""
    return record_function(call_site_name(any_hit, tag))


def _is_call_site(name: str) -> bool:
    return name.startswith(("pt_closest_", "pt_any_"))


def range_bucket(name: str) -> str:
    """The JAX package's bucket of a kernel name (idkengine_tpu/profiling.py,
    capture_device_profile's `bucket`): its Pallas tracers carry the call
    site's tag, pt_closest_*_pri -> primary, *_bnc -> bounce_closest,
    pt_any_*_nee/_env -> nee, other traces -> trace_other. The port applies
    it to the call-site range around a hand kernel."""
    n = name.lower()
    if n.startswith("jit_"):
        return "_parent"
    if "pt_closest" in n:
        if "_pri" in n:
            return "primary"
        if "_bnc" in n:
            return "bounce_closest"
        return "trace_other"
    if "pt_any" in n:
        if "_nee" in n or "_env" in n:
            return "nee"
        return "trace_other"
    if "scatter_max" in n or "voxel" in n:
        return "voxelize"
    if n.startswith("sort") or ".sort" in n or "sort." in n:
        return "sorts"
    if "dynamic-update-slice" in n or ("copy" in n and "fusion" not in n):
        return "copies"
    return "xla_glue"


def bucket(name: str) -> str:
    """The bucket of one device kernel by its name alone, with the JAX
    package's bucket names: a hand trace kernel outside any call-site range
    goes to trace_other (the JAX package's untagged trace, pt_*_x); the
    voxelizer's scatter to voxelize; PyTorch's sort, copy and elementwise,
    reduction and indexing kernels to sorts, copies and xla_glue (the JAX
    package's name for its XLA glue)."""
    n = name.lower()
    if any(k in n for k in HAND_TRACE_KERNELS):
        return "trace_other"
    if "scatter_max" in n or "voxel" in n:
        return "voxelize"
    if "sort" in n:
        return "sorts"
    if "memcpy" in n or "memset" in n or "copy" in n:
        return "copies"
    return "xla_glue"


def _innermost(spans, start, end):
    """The name of the shortest (start, end, name) span holding [start, end]."""
    best = None
    for s0, s1, name in spans:
        if s0 <= start and end <= s1 and (best is None or s1 - s0 < best[1] - best[0]):
            best = (s0, s1, name)
    return None if best is None else best[2]


def attribute(events) -> list[tuple[str, str | None, float]]:
    """(kernel name, call-site range or None, device ms) of each device
    kernel in `events` (torch.profiler's FunctionEvents, or records with
    their name, device_type, id, time_range). A hand trace kernel's range
    is the innermost call-site range (call_site) around the host call that
    launched it (the runtime event with the kernel's correlation id), or,
    where the profiler traced no such call, the innermost call-site span on
    the device around the kernel; other kernels take none. A range's own
    device span is not a kernel and is left out."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ranges = {e.name for e in events if e.device_type == cpu}
    host_sites = [(e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == cpu and _is_call_site(e.name)]
    device_sites = [(e.time_range.start, e.time_range.end, e.name) for e in events
                    if e.device_type == cuda and _is_call_site(e.name)]
    launches = {e.id: e for e in events
                if e.device_type == cpu and "launch" in e.name.lower() and e.id > 0}
    out = []
    for e in events:
        if e.device_type != cuda or e.name in ranges:
            continue
        ms = (e.time_range.end - e.time_range.start) / 1e3
        site = None
        if any(k in e.name for k in HAND_TRACE_KERNELS):
            call = launches.get(e.id)
            if call is not None:
                site = _innermost(host_sites, call.time_range.start, call.time_range.end)
            if site is None:
                site = _innermost(device_sites, e.time_range.start, e.time_range.end)
        out.append((e.name, site, ms))
    return out


def bucket_times(kernels, ndigits: int | None = 1) -> dict[str, float]:
    """{bucket: ms} of attribute's list: a kernel in a call-site range takes
    the range's bucket (range_bucket), any other its name's (bucket); with
    "total_device" their sum, largest first, rounded to `ndigits` (0.1 ms
    as the JAX package rounds; None: unrounded); {} for no kernels."""
    by = collections.defaultdict(float)
    for name, site, ms in kernels:
        by[range_bucket(site) if site is not None else bucket(name)] += ms
    if not by:
        return {}
    by["total_device"] = sum(by.values())
    return {k: v if ndigits is None else round(v, ndigits)
            for k, v in sorted(by.items(), key=lambda kv: -kv[1])}


def profile_kernels(fn) -> list[tuple[str, str | None, float]]:
    """Run fn() under torch.profiler; attribute's list of its device
    kernels ([] where the profiler traced none: no card)."""
    with profile(activities=_activities()) as prof:
        out = fn()
        synchronize(out)
    return attribute(prof.events())


def capture_device_profile(fn) -> dict[str, float]:
    """Run fn() under torch.profiler and return {bucket: ms} of device
    kernel time (bucket_times): each hand trace kernel in the bucket of the
    call site that launched it, as the JAX package buckets its tagged
    Pallas kernels; {} where the profiler traced no device kernel."""
    return bucket_times(profile_kernels(fn))
