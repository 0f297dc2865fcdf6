"""Mesh optimization pass (the gltfpack/meshoptimizer role), numpy.
Counterpart: idkengine_tpu/scene/meshopt.py.

The reference optionally runs meshoptimizer over every loaded primitive
(ModelLoader.cs:1695-1805 OptimizeVertexCache/OptimizeVertexFetch,
:1913-1969 the gltfpack preprocess path). Its goals there are raster
vertex-cache hit rate and vertex-fetch locality. A ray-traced renderer has
no raster vertex cache, so the pass keeps only the goals that still matter
and re-targets them:

- **Triangle order = Morton order of centroids.** Downstream, triangle
  slots are laid out in BVH leaf order; a spatially coherent SOURCE order
  makes the builder's sweep partitions touch contiguous index ranges
  (faster host build) and keeps slot ids of nearby geometry close, which
  tightens the per-hit attribute gathers and phase B's leaf gathers
  (ops/two_phase.py).
- **Vertex order = first use by the reordered triangles** (the
  OptimizeVertexFetch analogue): per-frame skinning/refit gathers
  (scene/skinning.py, render/dynamic.py) then walk vertex rows nearly
  monotonically instead of randomly. Unreferenced vertices are dropped.

Both transforms are exact permutations — geometry, attributes, and
material assignment are unchanged.
"""
from __future__ import annotations

import numpy as np

from .model import MeshPrimitive, Model


def _morton3(q: np.ndarray) -> np.ndarray:
    """Interleave 10-bit x,y,z (q: (N,3) uint32 in [0,1024)) to 30-bit
    Morton codes."""
    def part(x):
        x = x.astype(np.uint64)
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    return part(q[:, 0]) | (part(q[:, 1]) << np.uint64(1)) | (
        part(q[:, 2]) << np.uint64(2))


def reorder_triangles_morton(prim: MeshPrimitive) -> np.ndarray:
    """Sort prim.indices rows by the Morton code of the triangle centroid.
    Returns the permutation applied (new row i was old row perm[i])."""
    idx = prim.indices
    if idx.shape[0] <= 2:
        return np.arange(idx.shape[0])
    cen = prim.positions[idx].mean(axis=1)
    lo = cen.min(axis=0)
    ext = np.maximum(cen.max(axis=0) - lo, 1e-12)
    q = np.clip(((cen - lo) / ext * 1023.0), 0, 1023).astype(np.uint32)
    perm = np.argsort(_morton3(q), kind="stable")
    prim.indices = np.ascontiguousarray(idx[perm])
    return perm


def reindex_vertices_first_use(prim: MeshPrimitive) -> np.ndarray:
    """Renumber vertices in first-use order of the index buffer;
    unreferenced vertices are dropped. Returns the old-id order kept
    (new row i was old row order[i])."""
    idx = prim.indices.reshape(-1)
    uniq, first = np.unique(idx, return_index=True)
    order = uniq[np.argsort(first, kind="stable")].astype(np.int64)
    old2new = np.full(prim.positions.shape[0], -1, np.int64)
    old2new[order] = np.arange(order.shape[0])
    remap = lambda a: None if a is None else np.ascontiguousarray(a[order])
    prim.positions = remap(prim.positions)
    prim.normals = remap(prim.normals)
    prim.tangents = remap(prim.tangents)
    prim.uvs = remap(prim.uvs)
    prim.joints = remap(prim.joints)
    prim.weights = remap(prim.weights)
    prim.indices = np.ascontiguousarray(
        old2new[idx].reshape(-1, 3).astype(prim.indices.dtype))
    return order


def optimize_primitive(prim: MeshPrimitive) -> None:
    """Morton triangle reorder + first-use vertex reindex (in place)."""
    reorder_triangles_morton(prim)
    reindex_vertices_first_use(prim)


def optimize_model(model: Model) -> Model:
    """Run the pass over every primitive (in place; returns the model)."""
    for p in model.primitives:
        if p.indices.size:
            optimize_primitive(p)
    return model
