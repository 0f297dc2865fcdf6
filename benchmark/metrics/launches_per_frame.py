"""launches_per_frame: device operations (kernels, copies, fills) a traced
frame."""


def read(data):
    tl = data.timeline
    return len(tl.ops) / tl.frames if tl is not None and tl.ops else None
