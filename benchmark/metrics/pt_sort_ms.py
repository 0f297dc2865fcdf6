"""pt_sort_ms: device ms a traced frame of the path tracer's ray sort: the
operations launched inside its span pt/sort (render/pathtracer.py: the
sort key, the sort and the permutation of the ray state)."""


def read(data):
    tl = data.timeline
    if tl is None:
        return None
    ops = [op for op in tl.ops if "pt/sort" in op.ranges]
    return sum(op.ms for op in ops) / tl.frames if ops else None
