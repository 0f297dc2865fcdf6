"""Flatten a built BVH + scene geometry into SoA arrays (numpy, or tensors
on a device). Counterpart: idkengine_tpu/bvh/flatten.py.

`thread_bvh` and `flatten_triangles` are the JAX package's numpy functions,
carried over; `flatten_triangles_device` is its device flatten, in torch on
the build's device, bit-equal to `flatten_triangles`. `bvh2_nodes` (the
binary layout of phase A), `thread_nodes` (the threaded records of the
steps kernel) and `bvh4_nodes` (the 4-wide layout of the trace kernel) add
the CUDA kernels' node tables, derived from the threaded arrays alone so
that any threaded scene (the port's own build or one handed over from the
JAX package) can be traced on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.intersect import cross3, fma
from ..utils import compression as comp
from . import builder as _builder


@dataclass
class FlatBvh:
    """Threaded-BVH arrays (numpy; device upload happens in the ops layer)."""

    node_min: np.ndarray  # (N,3) f32
    node_max: np.ndarray  # (N,3) f32
    node_first: np.ndarray  # (N,) i32 — leaf: first tri slot; interior: -1
    node_count: np.ndarray  # (N,) i32 — 0 for interior
    hit_link: np.ndarray  # (N,) i32 — next node when box hit & interior (DFS child)
    miss_link: np.ndarray  # (N,) i32 — next node when box missed / after leaf (-1 = done)
    order: np.ndarray | None = None  # DFS order: builder node id per threaded node

    def refresh_boxes(self, nodes: np.ndarray):
        """Update node AABBs in place after a refit (topology unchanged)."""
        self.node_min = np.ascontiguousarray(nodes["min"][self.order], np.float32)
        self.node_max = np.ascontiguousarray(nodes["max"][self.order], np.float32)


def thread_bvh(nodes: np.ndarray) -> tuple[FlatBvh, np.ndarray]:
    """Convert builder nodes (structured NODE_DTYPE, root=0, children l/l+1)
    into DFS-ordered threaded arrays.

    Returns (FlatBvh, slot_perm); slot_perm is the identity: leaf slots stay
    in builder order, the slot space the JAX package's tracers share."""
    n = nodes.shape[0]
    order, subtree_end = _builder.tree_thread_links(nodes)

    node_min = np.ascontiguousarray(nodes["min"][order], np.float32)
    node_max = np.ascontiguousarray(nodes["max"][order], np.float32)
    counts = nodes["count"][order].astype(np.int32)
    first_raw = nodes["left_or_first"][order].astype(np.int64)

    hit_link = np.arange(1, n + 1, dtype=np.int32)  # DFS: descend = next node
    miss_link = subtree_end.astype(np.int32)
    miss_link[miss_link == n] = -1
    hit_link[counts > 0] = miss_link[counts > 0]  # leaves: fall through

    leaf_mask = counts > 0
    new_first = np.where(leaf_mask, first_raw, -1).astype(np.int32)
    n_slots = int((first_raw + counts)[leaf_mask].max()) if leaf_mask.any() else 0
    slot_perm = np.arange(n_slots, dtype=np.int64)

    return (
        FlatBvh(node_min=node_min, node_max=node_max, node_first=new_first,
                node_count=counts, hit_link=hit_link, miss_link=miss_link, order=order),
        slot_perm,
    )


@dataclass
class FlatTriangles:
    """Per-leaf-slot triangle SoA: geometry + shading attributes (numpy
    arrays, or tensors on a device from flatten_triangles_device)."""

    p0: np.ndarray  # (T,3) f32
    e1: np.ndarray  # (T,3) f32
    e2: np.ndarray  # (T,3) f32
    n_packed: np.ndarray  # (T,3) u32 octahedral per corner
    uv: np.ndarray  # (T,3,2) f32
    mat: np.ndarray  # (T,) i32
    geom_normal: np.ndarray  # (T,3) f32 — face normal (unit)


def flatten_triangles(
    slot_tri_ids: np.ndarray,
    vertices: np.ndarray,
    indices: np.ndarray,
    normals: np.ndarray,
    uvs: np.ndarray | None,
    tri_material: np.ndarray,
) -> FlatTriangles:
    """Gather per-slot triangle data (slot_tri_ids maps slot -> original tri)."""
    tids = slot_tri_ids.astype(np.int64)
    tri_v = indices[tids]  # (T,3)
    p = vertices[tri_v]  # (T,3,3)
    p0 = p[:, 0]
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    nrm = normals[tri_v]  # (T,3,3)
    n_packed = np.stack(
        [comp.compress_normal(nrm[:, k]) for k in range(3)], axis=1
    ).astype(np.uint32)
    gn = face_normal(torch.from_numpy(np.ascontiguousarray(e1, np.float32)),
                     torch.from_numpy(np.ascontiguousarray(e2, np.float32))).numpy()
    uv = (
        uvs[tri_v].astype(np.float32)
        if uvs is not None
        else np.zeros((tids.shape[0], 3, 2), np.float32)
    )
    return FlatTriangles(
        p0=p0.astype(np.float32),
        e1=e1.astype(np.float32),
        e2=e2.astype(np.float32),
        n_packed=n_packed,
        uv=uv,
        mat=tri_material[tids].astype(np.int32),
        geom_normal=gn.astype(np.float32),
    )


def face_normal(e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """The unit face normal (T,3) of edges e1, e2 (T,3) as the JAX package's
    jitted flatten rounds it on XLA:CPU, bit for bit on any device: its
    cross product's first products fused (cross3), the squares' sum fused,
    a correctly rounded root (ATen's float32 sqrt on the CPU is not, in the
    last place)."""
    g = cross3(e1, e2)
    x, y, z = g.unbind(-1)
    norm = torch.sqrt(fma(z, z, fma(y, y, x * x)).double()).float()
    return g / torch.clamp(norm, min=1e-20)[..., None]


def flatten_triangles_device(
    slot_tri_ids: np.ndarray,
    vertices: np.ndarray,
    indices: np.ndarray,
    normals: np.ndarray,
    uvs: np.ndarray | None,
    tri_material: np.ndarray,
    device="cuda",
) -> FlatTriangles:
    """flatten_triangles on `device` (the card unless the caller asks for
    the CPU): uploads the indexed mesh once (about a third of the
    de-indexed tables' bytes) and gathers, encodes the normals and forms
    the face normals there. Returns a FlatTriangles of tensors on `device`,
    bit-equal field by field to flatten_triangles' arrays (n_packed as
    uint32 values in int64), which SceneArrays.from_flat takes as they are."""
    dev = torch.device(device)

    def put(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(dev)

    tids = put(slot_tri_ids, np.int32).long()
    tri_v = put(indices, np.int32)[tids].long()  # (T,3)
    p = put(vertices, np.float32)[tri_v]  # (T,3,3)
    p0 = p[:, 0]
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    n_packed = comp.compress_normal_t(put(normals, np.float32)[tri_v])  # (T,3)
    uv = (put(uvs, np.float32)[tri_v] if uvs is not None
          else torch.zeros((tids.shape[0], 3, 2), dtype=torch.float32, device=dev))
    return FlatTriangles(p0=p0.contiguous(), e1=e1, e2=e2, n_packed=n_packed, uv=uv,
                         mat=put(tri_material, np.int32)[tids], geom_normal=face_normal(e1, e2))


def bvh2_nodes(node_min: np.ndarray, node_max: np.ndarray,
               node_first: np.ndarray, node_count: np.ndarray,
               miss_link: np.ndarray) -> tuple[np.ndarray, int]:
    """Phase A's binary node layout (csrc/two_phase.cu), from threaded arrays.

    One 32-byte record per node, in the threaded (DFS) order:
        min[3] f32 | right_or_first i32 | max[3] f32 | count i32
    Interior node i has its left child at i+1 (DFS preorder) and its right
    child at the left child's miss link, which is stored in the record.
    Leaves keep [first, first+count) in the SceneArrays slot space.
    Returns ((N,8) int32 records, with the floats bit-cast; tree depth, the
    root counted as 1)."""
    n = node_min.shape[0]
    count = np.asarray(node_count, np.int32)
    interior = count == 0
    left = np.minimum(np.arange(n) + 1, n - 1)
    right_or_first = np.where(interior, miss_link[left], node_first).astype(np.int32)
    rec = np.empty((n, 8), np.int32)
    rec[:, 0:3] = np.ascontiguousarray(node_min, np.float32).view(np.int32)
    rec[:, 3] = right_or_first
    rec[:, 4:7] = np.ascontiguousarray(node_max, np.float32).view(np.int32)
    rec[:, 7] = count
    # depth, level by level (parents precede children in DFS order)
    depth = 0
    level = np.zeros(1, np.int64)
    while level.size:
        depth += 1
        inner = level[interior[level]]
        level = np.concatenate([inner + 1, right_or_first[inner].astype(np.int64)])
    return rec, depth


MIN_LEAF_BITS = 5  # a leaf reference packs (first, count - 1) in 31 bits


def leaf_bits(node_count: np.ndarray) -> int:
    """The fewest bits, at least MIN_LEAF_BITS, that hold `count - 1` of the
    largest leaf: the split of a leaf reference ~(first << bits | count - 1)
    that leaves the most room to `first`."""
    largest = int(np.max(node_count, initial=1))
    return max(MIN_LEAF_BITS, (largest - 1).bit_length())


def leaf_reference(first, count, bits: int):
    """~(first << bits | count - 1), int32: a leaf reference of the wide
    records and the threaded records' leaf word (always < 0). Raises
    ValueError where it does not fit 31 bits: `first + count` above the slot
    space 2^(31 - bits) that the largest leaf leaves."""
    first, count = np.asarray(first, np.int64), np.asarray(count, np.int64)
    _check_slot_space(int(np.max(first + count, initial=0)), int(np.max(count, initial=1)),
                      bits)
    return (~((first << bits) | (count - 1))).astype(np.int32)


def _check_slot_space(end: int, largest: int, bits: int):
    if largest > 1 << bits or end > 1 << (31 - bits):
        raise ValueError(
            f"the BVH's slot space does not fit a leaf reference: leaves of up to {largest} "
            f"triangles take {bits} bits of 31, which leaves room for {1 << (31 - bits)} "
            f"triangle slots, and the slots end at {end}")


def thread_nodes(node_min: np.ndarray, node_max: np.ndarray, node_first: np.ndarray,
                 node_count: np.ndarray, miss_link: np.ndarray, bits: int) -> np.ndarray:
    """The steps kernel's threaded records: one aligned 32-byte record per
    binary node, in the threaded (DFS) order, read as two float4 loads:
        min[3] f32 | miss_link i32 | max[3] f32 | leaf word i32
    The leaf word is 0 for an interior node and leaf_reference(first, count,
    bits) (< 0) for a leaf. The hit link is not stored: an interior node's
    is the next record, a leaf's its miss link (thread_bvh). Boxes are the
    threaded arrays' f32 values bit for bit. Returns (N,8) int32."""
    n = node_min.shape[0]
    count = np.asarray(node_count, np.int32)
    leaf = count > 0
    rec = np.empty((n, 8), np.int32)
    rec[:, 0:3] = np.ascontiguousarray(node_min, np.float32).view(np.int32)
    rec[:, 3] = miss_link
    rec[:, 4:7] = np.ascontiguousarray(node_max, np.float32).view(np.int32)
    rec[:, 7] = 0
    rec[leaf, 7] = leaf_reference(np.asarray(node_first)[leaf], count[leaf], bits)
    return rec


def bvh4_nodes(node_min: np.ndarray, node_max: np.ndarray, node_first: np.ndarray,
               node_count: np.ndarray, miss_link: np.ndarray, bits: int
               ) -> tuple[np.ndarray, int, np.ndarray]:
    """The CUDA trace kernel's 4-wide node layout, collapsed from the binary
    tree of the threaded arrays (in the port's C++ core, bvh_collapse4).

    Each record stands for one binary node (the root, or an interior node
    another record points to) and opens its subtree the usual way: starting
    from that node, the open interior child of largest surface area is
    replaced by its two children until four are open or all are leaves.
    Records are 128 bytes, 32 int32 words, in breadth-first order (root 0):
        words  0-23  children's boxes as six float4s: lo.x[4] hi.x[4]
                     lo.y[4] hi.y[4] lo.z[4] hi.z[4], the binary nodes' f32
                     values bit for bit
        words 24-27  children's references: an interior child's record
                     index (>= 0), or a leaf's leaf_reference(first,
                     count, bits) (< 0), [first, first + count) in the
                     SceneArrays slot space
        word  28     the child count n (1-4): slots n..3 are empty (zero
                     words, never tested)
        words 29-31  zero
    `bits` is the scene's leaf_bits(node_count). Returns ((M,32) int32
    records; depth in records, the root counted as 1; (M,4) int32 binary
    node of each child, -1 where empty). Raises ValueError, as
    leaf_reference, where a leaf does not fit."""
    count = np.asarray(node_count)
    leaf = count > 0
    _check_slot_space(int(np.max((np.asarray(node_first) + count)[leaf], initial=0)),
                      int(np.max(count, initial=1)), bits)
    rec, depth, src = _builder.tree_collapse4(node_min, node_max, node_first, node_count,
                                              miss_link, bits)
    return rec, depth, src.astype(np.int32)
