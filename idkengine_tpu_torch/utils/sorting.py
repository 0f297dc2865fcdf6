"""Host sorting and partitioning primitives of the BVH builders.
Counterpart: idkengine_tpu/utils/sorting.py.

Numpy code, as in the JAX package, and bit for bit its results: an
order-preserving float to key mapping, the reference's 11-bit three-pass
LSD radix sort, a sorted lower bound and a stable partition (ref:
IDKEngine/Source/Utils/Algorithms.cs). The C++ core (bvh/cpp) carries the
fast versions; these are the reference versions and the tests' oracles.
"""
from __future__ import annotations

import numpy as np


def float_to_key(f: np.ndarray) -> np.ndarray:
    """Order-preserving float32 -> uint32 (ref: Algorithms.cs:15 FloatToKey):
    the sign bit flipped for positives, every bit for negatives, so that
    unsigned integer order is float order."""
    bits = np.ascontiguousarray(f, dtype=np.float32).view(np.uint32)
    mask = np.where(bits >> 31 == 1, np.uint32(0xFFFFFFFF), np.uint32(0x80000000))
    return bits ^ mask


def radix_sort_indices(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of uint32 keys in the reference's three 11-bit LSD
    passes (ref: Algorithms.cs:45-113), each pass a stable argsort of its
    digit: the oracle of the C++ core's radix_sort_pairs. For speed, use
    argsort_floats."""
    keys = np.asarray(keys, dtype=np.uint32)
    idx = np.arange(keys.shape[0], dtype=np.int64)
    for shift in (0, 11, 22):
        digit = (keys[idx] >> shift) & 0x7FF
        idx = idx[np.argsort(digit, kind="stable")]
    return idx


def argsort_floats(f: np.ndarray) -> np.ndarray:
    """Stable float argsort through the order-preserving keys (one stable
    argsort)."""
    return np.argsort(float_to_key(f), kind="stable")


def sorted_lower_bound(arr: np.ndarray, value) -> int:
    """First index i with arr[i] >= value (ref: Algorithms.cs SortedLowerBound)."""
    return int(np.searchsorted(arr, value, side="left"))


def stable_partition(arr: np.ndarray, mask: np.ndarray) -> tuple[np.ndarray, int]:
    """Elements with mask True first, each group in its own order (ref:
    Algorithms.cs:276-322). Returns (out, pivot)."""
    true_part = arr[mask]
    return np.concatenate([true_part, arr[~mask]]), int(true_part.shape[0])
