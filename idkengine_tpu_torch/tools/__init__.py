"""Hopper probes: the repository's TPU microbenchmarks (`tools/bench_*.py`,
kernels P1-P6) ported to the card, one module per tool.

Each module runs as `python -m idkengine_tpu_torch.tools.<name> [args]`
with the tool's own arguments and environment variables, builds its CUDA
library from `csrc/<name>.cu` at first use, and prints each variant's
device time (CUDA events) and SM cycles per iteration (`clock64()` read
inside the kernel) beside the card's name and power limit. Every kernel
has a plain PyTorch version in the same module, which CPU tensors take.
"""
