"""Data parallelism over the ray axis. Counterpart: idkengine_tpu/parallel."""
from .shard import make_mesh, replicate, shard_render  # noqa: F401
