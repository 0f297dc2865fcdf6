"""Device ray-reorder sorts. Counterpart: idkengine_tpu/ops/device_sort.py.

The reference reorders its rays with a GPU counting sort (ref:
Resource/Shaders/PathTracing/CountingSort/**, driven from
PathTracer.cs:273-297 with 2^21 bins). In the JAX package these are XLA
sorts, not Pallas kernels; here they are `torch.sort` calls on the
caller's device. Nothing on a render path calls them: the path tracer sorts
its packed ray state itself (render/pathtracer.py, `pt/sort`).

`sort_rays_by_key` reorders payload columns by a key; `radix_argsort` is
the stable LSD permutation of narrow keys (the reference's radix sort).
"""
from __future__ import annotations

import torch


def sort_rays_by_key(key: torch.Tensor, columns: tuple) -> tuple:
    """The payload columns (each with the key's leading length) reordered
    by one sort of the key; the key itself is not returned. Ties are in no
    set order, as in the JAX package's unstable multi-operand sort."""
    perm = torch.sort(key).indices
    return tuple(torch.index_select(c, 0, perm) for c in columns)


def radix_argsort(keys: torch.Tensor, bits: int = 9, passes: int = 2) -> torch.Tensor:
    """Stable LSD radix argsort of int32 keys: `passes` stable sorts of
    `bits`-bit digits, lowest first, each carrying the keys as the JAX
    package's does. Only the low passes*bits bits order the keys (18 by
    default, the ray sort key's); keys equal there keep their input order.
    Returns int32 indices."""
    idx = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    k = keys
    mask = (1 << bits) - 1
    for p in range(passes):
        order = torch.sort((k >> (p * bits)) & mask, stable=True).indices
        k, idx = k[order], idx[order]
    return idx
