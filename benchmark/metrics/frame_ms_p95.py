"""frame_ms_p95: the 95th percentile of every frame time in the window,
each from CUDA events recorded on the device before the frame's first
launch and after its last (numpy's linear interpolation)."""
import numpy as np


def read(data):
    return float(np.percentile(data.frame_ms, 95)) if data.frame_ms else None
