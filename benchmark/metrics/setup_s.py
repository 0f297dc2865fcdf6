"""setup_s: from the process's start to the first timed frame: imports,
the card's start, the scene, its build, the renderer, the warm-up frames
(and, on a checkout's first run, the CUDA libraries' build)."""


def read(data):
    return data.setup_s
