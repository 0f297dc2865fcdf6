"""device_idle_pct: the share of an untraced frame in which no device
operation runs: one less the device's busy time a traced frame (the union
of its operations' intervals, which the profiler's host cost does not
lengthen) over the window's frame time (untraced, as frame_ms)."""


def read(data):
    tl = data.timeline
    if tl is None or not tl.ops or not data.frames or data.window_s <= 0:
        return None
    busy_ms = tl.busy_s * 1e3 / tl.frames
    frame_ms = data.window_s * 1e3 / data.frames
    return 100.0 * (1.0 - busy_ms / frame_ms)
