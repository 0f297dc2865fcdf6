from . import compression, mathutil, rng, sorting  # noqa: F401
