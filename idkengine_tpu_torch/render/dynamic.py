"""Device-side scene dynamics: the level-order BVH refit and the refresh of
every copy of the geometry a scene holds. Counterpart:
idkengine_tpu/render/dynamic.py (`RefitPlan`, `build_refit_plan`,
`DeviceRefitter`).

Replaces the host round trip of SceneDatabase.update() (pull the vertices,
C++ refit, upload everything again). The reference refits on the GPU with
an atomic-lock protocol (ref: BLASRefit/compute.glsl:31-37); this one, as
the JAX package's, precomputes the tree's levels at build time and sweeps
them deepest first: no atomics, no locks, plain PyTorch on the scene's
device (the JAX package computes it in XLA, outside any Pallas kernel).

The JAX refit also refreshes the TPU's packet and wave tables; the port has
none (one whole-scene kernel), so it refreshes every table of SceneArrays
that holds boxes or triangles instead: the threaded arrays' boxes, the box
words of the binary records (`bvh_nodes`) and of the threaded records
(`bvh_thread`), words 0-23 of the 4-wide records (`bvh4_nodes`) gathered
through `bvh4_child` (a fresh collapse would open other children: it
picks by surface area, which the refit changes), the triangle arrays and
`tri_vec`. Topology words, leaf references and child counts stay.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..bvh.flatten import face_normal
from ..ops.trace import SceneArrays
from ..utils.compression import compress_normal_t


@dataclass
class RefitPlan:
    """Static (host-built) index plan for the device refit."""

    slot_tri_v: np.ndarray  # (S,3) vertex ids per slot triangle
    # threaded-BVH leaves: per node, max_leaf slot ids (padded by repeating
    # the first slot; interior rows: slot 0)
    leaf_gather: np.ndarray  # (N, max_leaf)
    is_leaf: np.ndarray  # (N,) bool
    # interior levels, deepest first: (ids (K,), left child (K,), right child (K,))
    levels: list


def build_refit_plan(flat, slot_tri, indices, max_leaf: int) -> RefitPlan:
    """The refit plan of a threaded BVH (bvh.flatten.FlatBvh: DFS order,
    left child i + 1, right child the left child's miss link)."""
    counts = np.asarray(flat.node_count)
    first = np.asarray(flat.node_first).astype(np.int64)
    miss = np.asarray(flat.miss_link).astype(np.int64)
    is_leaf = counts > 0
    # the levels top down (parents precede children in DFS order)
    levels = []
    level = np.zeros(1, np.int64)
    while level.size:
        inner = level[~is_leaf[level]]
        if inner.size:
            left = inner + 1
            levels.append((inner, left, miss[left]))
        level = np.concatenate([inner + 1, miss[inner + 1]])
    levels = [tuple(a.astype(np.int32) for a in lv) for lv in reversed(levels)]
    k = np.arange(max_leaf)
    gather = np.where(is_leaf[:, None],
                      first[:, None] + np.minimum(k[None, :], np.maximum(counts[:, None] - 1, 0)),
                      0)
    slot_tri_v = np.asarray(indices)[np.asarray(slot_tri).astype(np.int64)]
    return RefitPlan(slot_tri_v=slot_tri_v.astype(np.int32), leaf_gather=gather.astype(np.int32),
                     is_leaf=is_leaf, levels=levels)


class DeviceRefitter:
    """Owns the plan's index tensors on the scene's device. `refit` is
    `triangles`, `boxes` and `records` in turn; each may be called (and
    timed) on its own."""

    def __init__(self, plan: RefitPlan, scene: SceneArrays):
        dev = scene.device
        self.plan = plan

        def put(x):
            return torch.as_tensor(np.asarray(x), device=dev).long()

        self._tri_v = put(plan.slot_tri_v)
        self._leaf_gather = put(plan.leaf_gather)
        self._is_leaf = torch.as_tensor(plan.is_leaf, device=dev)[:, None]
        self._levels = [tuple(put(a) for a in lv) for lv in plan.levels]
        child = scene.bvh4_child.long()
        self._wide_src = torch.clamp(child, min=0)  # -1 (empty) must not gather a node
        # words 0-23 as (axis, lo|hi, child): the empty children's words stay
        self._wide_kept = (child >= 0)[:, None, None, :].expand(-1, 3, 2, -1).reshape(-1, 24)

    def triangles(self, verts: torch.Tensor, normals: torch.Tensor) -> dict:
        """The slot triangles of world-space vertices and normals (V,3):
        p0, e1, e2, the unit face normal, the octahedral corner normals and
        the kernels' tri_vec rows; the corners too, for `boxes`."""
        p = verts[self._tri_v]  # (S,3,3)
        e1 = p[:, 1] - p[:, 0]
        e2 = p[:, 2] - p[:, 0]
        nrm = normals[self._tri_v]
        return dict(corners=p, tri_p0=p[:, 0].contiguous(), tri_e1=e1, tri_e2=e2,
                    tri_gn=face_normal(e1, e2), tri_n=compress_normal_t(nrm),
                    tri_vec=torch.cat([p[:, 0], e1, e2, torch.zeros_like(e1)], dim=1))

    def boxes(self, corners: torch.Tensor, scene: SceneArrays):
        """(node_min, node_max) of the threaded nodes: each leaf's box from
        its slots' triangles, then the interior levels, deepest first."""
        lmin = corners.amin(dim=1)[self._leaf_gather].amin(dim=1)  # (N,3)
        lmax = corners.amax(dim=1)[self._leaf_gather].amax(dim=1)
        node_min = torch.where(self._is_leaf, lmin, scene.node_min)
        node_max = torch.where(self._is_leaf, lmax, scene.node_max)
        for ids, lc, rc in self._levels:
            node_min[ids] = torch.minimum(node_min[lc], node_min[rc])
            node_max[ids] = torch.maximum(node_max[lc], node_max[rc])
        return node_min, node_max

    def records(self, scene: SceneArrays, tris: dict, node_min, node_max) -> SceneArrays:
        """A SceneArrays with the new triangles and boxes in every table;
        the input scene is left as it was."""
        lo, hi = node_min.view(torch.int32), node_max.view(torch.int32)
        tables = {}
        for name in ("bvh_nodes", "bvh_thread"):
            rec = getattr(scene, name).clone()
            rec[:, 0:3] = lo
            rec[:, 4:7] = hi
            tables[name] = rec
        wide = scene.bvh4_nodes.clone()
        words = torch.stack([lo[self._wide_src], hi[self._wide_src]], dim=2)  # (M,4,2,3)
        words = words.permute(0, 3, 2, 1).reshape(-1, 24)
        wide[:, :24] = torch.where(self._wide_kept, words, wide[:, :24])
        tri = {k: v for k, v in tris.items() if k != "corners"}
        return replace(scene, node_min=node_min, node_max=node_max, bvh4_nodes=wide, **tables,
                       **tri)

    def refit(self, scene: SceneArrays, verts: torch.Tensor, normals: torch.Tensor
              ) -> SceneArrays:
        """verts/normals: (V,3) tensors in world space on the scene's
        device. Returns the refitted SceneArrays."""
        tris = self.triangles(verts, normals)
        node_min, node_max = self.boxes(tris["corners"], scene)
        return self.records(scene, tris, node_min, node_max)
