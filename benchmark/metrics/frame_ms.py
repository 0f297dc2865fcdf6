"""frame_ms: the window's wall time over the frames completed in it (host
clock; each frame ends in a synchronize, as a viewer that presents it)."""


def read(data):
    return data.window_s * 1e3 / data.frames if data.frames else None
