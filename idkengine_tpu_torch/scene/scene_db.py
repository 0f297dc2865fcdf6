"""Scene database. Counterpart: idkengine_tpu/scene/scene_db.py (`SceneDatabase`, :80-216).

Owns the added models as concatenated SoA arrays, the merged BLAS, the
lights and the materials, and builds the tensors the path tracer reads
(ref: IDKEngine/Source/ModelManager.cs). The slim form of the JAX class:
static geometry merged into one BLAS, no packet, wave or instance tables;
per-mesh shading overrides (`MeshShading`) as the JAX class keeps them.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from ..bvh.builder import BLAS, BuildSettings
from ..bvh.flatten import flatten_triangles, thread_bvh
from ..ops.trace import SceneArrays
from ..utils import mathutil as mu
from .lights import LightManager
from .materials import MaterialTable
from .model import Model, hoist_static_primitives

log = logging.getLogger(__name__)


@dataclass
class SceneMeta:
    """Host-side metadata about the flattened scene."""

    n_triangles: int = 0
    n_nodes: int = 0
    sah_cost: float = 0.0
    build_ms: float = 0.0
    max_depth: int = 0


@dataclass
class MeshShading:
    """Per-mesh shading overrides applied AFTER material/texture fetch
    (ref: GpuMesh.cs fields consumed by Surface.glsl:85-96
    SurfaceApplyModificatons; e.g. Application.cs:449-457 raises
    EmissiveBias on Sponza's lamp meshes)."""

    emissive_bias: float = 0.0        # emissive += bias * albedo
    normal_map_strength: float = 1.0  # mix(geom normal, mapped normal, s)
    specular_bias: float = 0.0        # metallic += bias (clamped)
    roughness_bias: float = 0.0       # roughness += bias (clamped)
    transmission_bias: float = 0.0    # transmission += bias (clamped)
    ior_bias: float = 0.0             # ior += bias (>= 1)
    absorbance_bias: tuple = (0.0, 0.0, 0.0)
    tint_on_transmissive: bool = True  # KHR_materials_transmission tint

    ROW_DEFAULT = np.array([0, 1, 0, 0, 0, 0, 0, 0, 0, 1], np.float32)

    def row(self) -> np.ndarray:
        a = self.absorbance_bias
        return np.array(
            [self.emissive_bias, self.normal_map_strength,
             self.specular_bias, self.roughness_bias,
             self.transmission_bias, self.ior_bias, a[0], a[1], a[2],
             1.0 if self.tint_on_transmissive else 0.0], np.float32)


class SceneDatabase:
    """Concatenated scene + BVH + lights; produces SceneArrays on a device."""

    def __init__(self, build_settings: BuildSettings | None = None):
        self.build_settings = build_settings or BuildSettings(
            presplit_factor=0.3, max_leaf_triangle_count=12, traversal_cost=4.0
        )
        self.models: list[Model] = []
        self.lights = LightManager()
        self.materials = MaterialTable()
        self.meta = SceneMeta()
        self.blas: BLAS | None = None
        self.device_scene: SceneArrays | None = None
        # per-mesh shading overrides, keyed by placement index (the i-th
        # (model, node, instance, primitive) that build() enumerates)
        self.mesh_shading: dict[int, MeshShading] = {}
        self._n_placements = 0
        self._tri_prim: np.ndarray | None = None  # placement of each triangle
        self._slot_tri: np.ndarray | None = None  # triangle of each slot

    def add_model(self, model: Model, transform: np.ndarray | None = None, hoist: bool = True):
        """Append a model (optionally pre-transformed by a 4x4 root matrix).

        ref: ModelManager.Add (ModelManager.cs:128-216) — array concat with
        index rebasing happens at build()."""
        if hoist:
            model = hoist_static_primitives(model)
        if transform is not None:
            t = np.asarray(transform, np.float32)
            for node in model.nodes:
                if node.parent < 0:
                    tr, q, s = mu.decompose_trs(t @ node.local_matrix())
                    node.translation, node.rotation, node.scale = tr, q, s
        self.models.append(model)

    def build(self, device="cuda") -> SceneArrays:
        """Concatenate all models, build the merged BLAS, thread it, flatten
        the triangles into its slot order and put the arrays on `device`
        (the card unless the caller asks for the CPU)."""
        verts, idx, norms, uvs, tri_mat, tri_prim = [], [], [], [], [], []
        voff = 0
        for model in self.models:
            transforms = model.global_transforms()
            mat_off = self.materials.add_model(model)
            for ni, node in enumerate(model.nodes):
                if not node.mesh_primitives:
                    continue
                m = transforms[ni]
                inst = node.instance_transforms
                mats = [np.eye(4, dtype=np.float32)] if inst is None else list(inst)
                for im in mats:
                    world = m @ im
                    nrm_m = np.linalg.inv(world[:3, :3]).T
                    for pi in node.mesh_primitives:
                        prim = model.primitives[pi]
                        prim.ensure_normals()
                        p = prim.positions @ world[:3, :3].T + world[:3, 3]
                        verts.append(p.astype(np.float32))
                        norms.append(mu.normalize(prim.normals @ nrm_m.T).astype(np.float32))
                        uvs.append(
                            prim.uvs.astype(np.float32)
                            if prim.uvs is not None
                            else np.zeros((p.shape[0], 2), np.float32)
                        )
                        idx.append(prim.indices.astype(np.uint32) + voff)
                        tri_mat.append(
                            np.full(prim.indices.shape[0], prim.material + mat_off, np.int32))
                        tri_prim.append(np.full(prim.indices.shape[0], len(tri_prim), np.int32))
                        voff += p.shape[0]
        if not verts:
            raise ValueError("scene is empty")
        verts = np.concatenate(verts)
        indices = np.concatenate(idx)

        self.blas = BLAS(verts, indices, self.build_settings)
        flat, slot_perm = thread_bvh(self.blas.nodes)
        slot_tri = self.blas.tri_indices[slot_perm]
        self._slot_tri, self._tri_prim = slot_tri, np.concatenate(tri_prim)
        self._n_placements = len(tri_prim)
        ft = flatten_triangles(slot_tri, verts, indices, np.concatenate(norms),
                               np.concatenate(uvs), np.concatenate(tri_mat))
        self.device_scene = SceneArrays.from_flat(
            flat, ft, self.build_settings.max_leaf_triangle_count, device)
        self.meta = SceneMeta(
            n_triangles=int(indices.shape[0]), n_nodes=int(flat.node_min.shape[0]),
            sah_cost=self.blas.sah_cost, build_ms=self.blas.build_ms,
            max_depth=self.device_scene.bvh_depth)
        log.info("scene built: %d tris → %d slots, %d nodes, depth %d, SAH %.1f, %.0f ms",
                 self.meta.n_triangles, slot_tri.shape[0], self.meta.n_nodes,
                 self.meta.max_depth, self.meta.sah_cost, self.meta.build_ms)
        return self.device_scene

    # ------------------------------------------------------------------
    def set_mesh_shading(self, mesh_index: int, **kwargs) -> MeshShading:
        """Set per-mesh shading overrides (ref: GpuMesh EmissiveBias /
        NormalMapStrength / SpecularBias / RoughnessBias / ... edited live
        from Application.cs:449-457 and the Gui). mesh_index indexes the
        placements build() enumerates (one per node x instance x primitive).
        Renderers bake the rows into their tables: one made before this
        call takes them through PathTracer.set_slot_shading."""
        ms = self.mesh_shading.get(mesh_index, MeshShading())
        for k, v in kwargs.items():
            if not hasattr(ms, k):
                raise AttributeError(f"MeshShading has no field {k!r}")
            setattr(ms, k, v)
        self.mesh_shading[mesh_index] = ms
        return ms

    @property
    def n_meshes(self) -> int:
        """Placement count (valid after build())."""
        return self._n_placements

    def slot_shading(self) -> np.ndarray | None:
        """Per-slot (n_slots, 10) override rows in MeshShading.row order,
        following the BVH's slot order, or None when no mesh has overrides
        (the renderers' hot path stays untouched)."""
        if not self.mesh_shading or self._slot_tri is None:
            return None
        table = np.tile(MeshShading.ROW_DEFAULT, (self._n_placements, 1))
        for k, ms in self.mesh_shading.items():
            table[k] = ms.row()
        return table[self._tri_prim[self._slot_tri]]
