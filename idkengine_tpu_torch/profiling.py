"""Profiling/tracing hooks. Counterpart: idkengine_tpu/profiling.py.

Role of the reference's GL debug groups + TimerQuery
(ref: BBG/Source/Computing.cs:11-16 named passes, Objects/TimerQuery.cs).
The port's spans are `torch.profiler.record_function` ranges opened through
`pass_scope`, which records them only while a torch.profiler session is
active (`tracing()`) and is a shared no-op otherwise, so a frame pays one
flag check a span when nobody traces. Recorded spans share the profiler's
clock with the device's kernels and copies, so a trace puts each device
operation, and each idle gap of the device, under the innermost span
around the host work. While tracing, the one-level trace kernel also counts
its work (rays, 4-wide node records visited, triangles tested) per call
site into a small device buffer: `report`, `reset`, `log_report`; and the
deferred lighting pass counts its shadow rays and those cast from pixels
with no surface: `shadow_report`.

The operator's route: `start_trace()`, N frames, `stop_trace()`, then open
the returned Chrome-trace file in Perfetto (ui.perfetto.dev) or
chrome://tracing.
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

_trace = None  # (profiler, directory) of start_trace
_NO_SPAN = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled


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


def tracing() -> bool:
    """Whether a torch.profiler session is active: the condition under
    which record_function records at all."""
    return _profiler_enabled()


def pass_scope(name: str, args=None):
    """The port's span: a record_function range named `name` (with
    str(args) as its args, where given) while tracing(), else a shared
    no-op context."""
    if not _profiler_enabled():
        return _NO_SPAN
    return record_function(name, None if args is None else str(args))


def _activities():
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def start_trace(log_dir: str | None = None):
    """Begin a torch.profiler trace of the host and, with a card, the
    device: every span of the port is recorded until stop_trace, which
    writes it to `log_dir` as a Chrome trace (open it in Perfetto or
    chrome://tracing)."""
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


# ---------------------------------------------------------------------------
# Traversal counters (csrc/trace.cu, trace_kernel with COUNT on)
# ---------------------------------------------------------------------------

COUNTER_FIELDS = ("rays", "nodes", "tris")
MAX_COUNTER_SITES = 64
_counter_rows: dict[str, int] = {}  # call-site range name -> row
_counters: dict[torch.device, torch.Tensor] = {}  # (MAX_COUNTER_SITES, 3) int64 a device


def counter_row(device: torch.device, site: str) -> torch.Tensor:
    """The (3,) int64 counters (COUNTER_FIELDS) of call site `site` (a
    call_site_name) on `device`, where a counting trace launch adds its
    live rays, the 4-wide node records they visited and the triangles they
    tested. Each device's buffer is allocated, zeroed, at its first use."""
    buf = _counters.get(device)
    if buf is None:
        buf = _counters[device] = torch.zeros((MAX_COUNTER_SITES, len(COUNTER_FIELDS)),
                                              dtype=torch.int64, device=device)
    row = _counter_rows.get(site)
    if row is None:
        if len(_counter_rows) == MAX_COUNTER_SITES:
            raise RuntimeError(f"more than {MAX_COUNTER_SITES} counted call sites")
        row = _counter_rows[site] = len(_counter_rows)
    return buf[row]


def report() -> dict[str, dict[str, int]]:
    """{call site: {"rays", "nodes", "tris"}} summed over the devices since
    the last reset, for each site that counted a ray; reading waits for
    each device's counting launches (one synchronize a device)."""
    if not _counters:
        return {}
    total = sum(buf.cpu() for buf in _counters.values()).tolist()
    return {site: dict(zip(COUNTER_FIELDS, total[row])) for site, row in _counter_rows.items()
            if total[row][0]}


def reset():
    """Zero the traversal and shadow-ray counters (their buffers stay
    allocated)."""
    for buf in (*_counters.values(), *_shadow_counts.values()):
        buf.zero_()


def log_report():
    for site, c in sorted(report().items()):
        log.info("%-18s %12d rays %8.2f nodes/ray %8.2f tris/ray", site, c["rays"],
                 c["nodes"] / c["rays"], c["tris"] / c["rays"])


# ---------------------------------------------------------------------------
# Shadow-ray counters (render/deferred.py's lighting pass), apart from the
# traversal rows of `report`
# ---------------------------------------------------------------------------

SHADOW_FIELDS = ("rays", "sky_rays")
_shadow_counts: dict[torch.device, torch.Tensor] = {}  # (2,) int64 a device


def count_shadow_rays(t_max: torch.Tensor, surface: torch.Tensor):
    """While tracing(), and only then: add one shadow trace's live rays
    (t_max > 0) and those among them cast from pixels with no surface
    (`surface` false) to the counts of t_max's device, on the device, with
    no synchronize. Each device's counts are allocated, zeroed, at their
    first use."""
    if not _profiler_enabled():
        return
    buf = _shadow_counts.get(t_max.device)
    if buf is None:
        buf = _shadow_counts[t_max.device] = torch.zeros(len(SHADOW_FIELDS), dtype=torch.int64,
                                                         device=t_max.device)
    live = t_max > 0
    buf += torch.stack([live.sum(), (live & ~surface).sum()])


def shadow_report() -> dict[str, int]:
    """{"rays", "sky_rays"} of the lighting pass's shadow traces, summed over
    the devices since the last reset; {} before any count. Reading waits for
    each device's counts (one synchronize a device)."""
    if not _shadow_counts:
        return {}
    total = sum(buf.cpu() for buf in _shadow_counts.values()).tolist()
    return dict(zip(SHADOW_FIELDS, total))


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
    """The span around a trace launch (as pass_scope's, a shared no-op
    unless tracing()); see call_site_name."""
    if not _profiler_enabled():
        return _NO_SPAN
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
