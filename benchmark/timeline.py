"""From a torch.profiler trace to the device timeline the per-layer readers
read: every device operation (kernel, copy, fill) with the host ranges
(`record_function`) around the call that launched it, the device's busy
time over the traced window, its idle gaps labelled by what the host was
doing, and the breakdown the result line carries.

A device operation is tied to its launch by the profiler's correlation id
(the runtime call's id equals the device event's, also for the port's
ctypes launches, which have no ATen op); its ranges are the host ranges
that hold that call.
"""
from __future__ import annotations

import bisect
import collections
from dataclasses import dataclass, field

FRAME_RANGE = "benchmark/frame"  # the harness's range around each traced frame


@dataclass
class Op:
    name: str
    start: float  # microseconds, the profiler's clock
    end: float
    ranges: set = field(default_factory=set)

    @property
    def ms(self) -> float:
        return (self.end - self.start) / 1e3


@dataclass
class Timeline:
    ops: list  # device operations in the traced window, by start
    frames: int  # frames traced
    window_s: float  # from the first traced frame's start to the last one's end
    busy_s: float  # time in which some device operation ran, within the window
    gaps: list  # (seconds, label) of each idle interval within the window

    def breakdown(self, n=10) -> dict:
        """The device operations that took most time and the longest idle
        gaps by what the host was doing, each summed by name, in seconds."""
        by_op = collections.defaultdict(float)
        for op in self.ops:
            by_op[op.name] += (op.end - op.start) / 1e6
        by_gap = collections.defaultdict(float)
        for s, label in self.gaps:
            by_gap[label] += s
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def _is_range(e) -> bool:
    """A host range (`record_function`), not an operation."""
    return bool(e.is_user_annotation)


def _is_launch(name: str) -> bool:
    n = name.lower()
    return "launch" in n or "memcpy" in n or "memset" in n


def build(events, device_type_cpu, device_type_cuda) -> Timeline:
    """The Timeline of profiler FunctionEvents (prof.events()) around the
    frames the harness ran inside FRAME_RANGE."""
    cpu = [e for e in events if e.device_type == device_type_cpu]
    dev = [e for e in events if e.device_type == device_type_cuda]
    frames = [e for e in cpu if e.name == FRAME_RANGE]
    if not frames:
        raise ValueError("the trace holds no traced frame")
    w0 = min(e.time_range.start for e in frames)
    w1 = max(e.time_range.end for e in frames)
    ranges = [e for e in cpu if _is_range(e)]
    range_names = {e.name for e in ranges}
    launches = {e.id: e for e in cpu if _is_launch(e.name) and e.id > 0}
    ops = []
    for e in dev:
        if e.name in range_names:  # a range's own span on the device
            continue
        s, t = e.time_range.start, e.time_range.end
        if t < w0 or s > w1:
            continue
        call = launches.get(e.id)
        ops.append((e.name, s, t, call.time_range.start if call is not None else None))
    ops.sort(key=lambda x: x[1])
    out = [Op(n, s, t) for n, s, t, _ in ops]
    # ranges around each launch: per range, the launches inside it
    launch_at = sorted((c, i) for i, (_, _, _, c) in enumerate(ops) if c is not None)
    times = [c for c, _ in launch_at]
    for r in ranges:
        lo = bisect.bisect_left(times, r.time_range.start)
        hi = bisect.bisect_right(times, r.time_range.end)
        for _, i in launch_at[lo:hi]:
            out[i].ranges.add(r.name)
    # busy time: the union of the operations' intervals, clipped to the window
    busy, gaps, end = 0.0, [], w0
    for op in out:
        s, t = max(op.start, w0), min(op.end, w1)
        if t <= s:
            continue
        if s > end:
            gaps.append((end, s))
            busy, end = busy + t - s, t
        elif t > end:
            busy, end = busy + t - end, t
    if end < w1:
        gaps.append((end, w1))
    return Timeline(ops=out, frames=len(frames), window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6,
                    gaps=_label_gaps(gaps, cpu, ranges))


def _innermost(events, times):
    """The name of the innermost event (start, end, name) holding each of
    `times` (sorted), or None: one sweep over events by start, with a stack
    of the open ones (host events nest)."""
    events = sorted(events)
    out, stack, i = [], [], 0
    for m in times:
        while i < len(events) and events[i][0] <= m:
            while stack and stack[-1][1] < events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def _label_gaps(gaps, cpu, ranges):
    """(seconds, label) of each gap: the innermost host range and host
    operation running at its middle ("python" where no operation runs)."""
    if not gaps:
        return []
    mids = [0.5 * (s + t) for s, t in gaps]
    order = sorted(range(len(gaps)), key=lambda i: mids[i])
    times = [mids[i] for i in order]
    span = [(e.time_range.start, e.time_range.end, e.name) for e in ranges]
    ops = [(e.time_range.start, e.time_range.end, e.name) for e in cpu if not _is_range(e)]
    in_range = _innermost(span, times)
    in_op = _innermost(ops, times)
    out = [None] * len(gaps)
    for j, i in enumerate(order):
        s, t = gaps[i]
        label = " > ".join(x for x in (in_range[j], in_op[j] or "python") if x)
        out[i] = ((t - s) / 1e6, label)
    return out
