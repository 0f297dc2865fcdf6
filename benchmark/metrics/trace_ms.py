"""trace_ms: device ms a traced frame of the program's hand traversal
kernels (its profiling.HAND_TRACE_KERNELS, by name)."""


def hand(op, names):
    return any(k in op.name for k in names)


def read(data):
    tl = data.timeline
    if tl is None:
        return None
    ops = [op for op in tl.ops if hand(op, data.hand_kernels)]
    return sum(op.ms for op in ops) / tl.frames if ops else None
