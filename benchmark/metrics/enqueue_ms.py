"""enqueue_ms: host ms from calling the renderer's frame to its return,
the mean over the window's frames (untraced). It holds the frame's
blocking calls, such as the camera's uploads, and every launch."""


def read(data):
    return sum(data.enqueue_ms) / len(data.enqueue_ms) if data.enqueue_ms else None
