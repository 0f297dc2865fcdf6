"""Scene database. Counterpart: idkengine_tpu/scene/scene_db.py (`SceneDatabase`).

Owns the added models as concatenated SoA arrays, the merged BLAS, the
lights and the materials, and builds the tensors the path tracer reads
(ref: IDKEngine/Source/ModelManager.cs). The JAX class without its packet
and wave tables (the port traces one whole-scene table): static geometry
merged into one BLAS; per-mesh shading overrides (`MeshShading`);
animation through `update` (host C++ refit, the reference's fenced
readback) or `update_device` (the vertex transform and the level-order
refit on the scene's device, render/dynamic.py); instanced models with a
BLAS of their own, traced through the two-level path (`instance_set`),
moved with `set_instance_transform` and added after the build with
`add_model_runtime`, neither of which rebuilds geometry.

`update_device` starts from each animated placement's local positions, as
`update` does: the JAX package's starts from the build's world-space
vertices and so applies a placement's build-time transform twice (its
tests animate a node at rest at the identity, where the two agree).
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..bvh.builder import BLAS, TLAS, BuildSettings
from ..bvh.flatten import flatten_triangles, flatten_triangles_device, thread_bvh
from ..ops.trace import InstanceSet, SceneArrays, linear_map
from ..utils import mathutil as mu
from . import animation as anim_mod
from . import skinning as skin_mod
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
    epo: float = 0.0  # BLAS.epo after each build; nan with IDK_EPO=0
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
        # (model, node, primitive, instance matrix, first vertex, end vertex)
        # of each placement build() enumerates
        self._placements: list[tuple] = []
        self._tri_prim: np.ndarray | None = None  # placement of each triangle
        self._slot_tri: np.ndarray | None = None  # triangle of each slot
        # the concatenated triangle space (world space at build time)
        self._verts = self._indices = self._normals = self._uvs = self._tri_mat = None
        self._flat = None
        self._refitter = None
        self.device_vertices: torch.Tensor | None = None  # update_device's last vertices
        # instanced models: their own BLASes, traced two-level
        self._instanced_models: list[Model] = []
        self._instance_list: list[list] = []  # [model index, (4,4) world matrix]
        self._inst_blas: list[BLAS] = []
        self._inst_scene_arrays: list[SceneArrays] = []
        self._inst_slot_off: list[int] = []
        self._inst_attr_srcs: list = []  # FlatTriangles a model, for the attribute tables
        self.tlas: TLAS | None = None

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
        (the card unless the caller asks for the CPU); then the instanced
        models' BLASes, after the static slots."""
        self._device = torch.device(device)
        verts, idx, norms, uvs, tri_mat, tri_prim = [], [], [], [], [], []
        self._placements = []
        voff = 0
        for mi, model in enumerate(self.models):
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
                        self._placements.append((mi, ni, pi, im, voff, voff + p.shape[0]))
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
        self._verts = np.concatenate(verts)
        self._indices = np.concatenate(idx)
        self._normals = np.concatenate(norms)
        self._uvs = np.concatenate(uvs)
        self._tri_mat = np.concatenate(tri_mat)
        self._tri_prim = np.concatenate(tri_prim)

        self.blas = BLAS(self._verts, self._indices, self.build_settings)
        self._flat, slot_perm = thread_bvh(self.blas.nodes)
        self._slot_tri = self.blas.tri_indices[slot_perm]
        self._refitter = None
        self.device_scene = self._upload()
        if self._instanced_models:
            self._inst_blas, self._inst_scene_arrays, self._inst_slot_off = [], [], []
            self._inst_attr_srcs = self._build_instanced(int(self._slot_tri.shape[0]))
            self._refresh_instance_device()
            log.info("instanced: %d models, %d instances (two-level trace)",
                     len(self._instanced_models), len(self._instance_list))
        # quality metrics logged per build like the reference (SAH + EPO,
        # ref: Bvh/BVH.cs:460-469 + BLAS.ComputeGlobalEPO): SAH alone misses
        # node-overlap pathologies; IDK_EPO=0 skips EPO (nan)
        self.meta = SceneMeta(
            n_triangles=int(self._indices.shape[0]), n_nodes=int(self._flat.node_min.shape[0]),
            sah_cost=self.blas.sah_cost,
            epo=self.blas.epo() if os.environ.get("IDK_EPO", "1") != "0" else float("nan"),
            build_ms=self.blas.build_ms, max_depth=self.device_scene.bvh_depth)
        log.info("scene built: %d tris → %d slots, %d nodes, depth %d, SAH %.1f, EPO %.3f, "
                 "%.0f ms", self.meta.n_triangles, self._slot_tri.shape[0], self.meta.n_nodes,
                 self.meta.max_depth, self.meta.sah_cost, self.meta.epo, self.meta.build_ms)
        return self.device_scene

    def _upload(self) -> SceneArrays:
        """The static scene's SceneArrays on the build's device: the indexed
        mesh uploaded once and flattened there (flatten_triangles_device, as
        the JAX package's build, update and refit_host flatten)."""
        ft = flatten_triangles_device(self._slot_tri, self._verts, self._indices, self._normals,
                                      self._uvs, self._tri_mat, device=self._device)
        return SceneArrays.from_flat(self._flat, ft, self.build_settings.max_leaf_triangle_count,
                                     self._device)

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
        return len(self._placements)

    def slot_shading(self) -> np.ndarray | None:
        """Per-slot (n_slots, 10) override rows in MeshShading.row order,
        following the BVH's slot order, or None when no mesh has overrides
        (the renderers' hot path stays untouched)."""
        if not self.mesh_shading or self._slot_tri is None:
            return None
        table = np.tile(MeshShading.ROW_DEFAULT, (len(self._placements), 1))
        for k, ms in self.mesh_shading.items():
            table[k] = ms.row()
        return table[self._tri_prim[self._slot_tri]]

    # ------------------------------------------------------------------
    def _animate(self, model: Model, time: float, animation_index: int) -> np.ndarray:
        """Sample the model's animation into its nodes; its global transforms."""
        anim = model.animations[min(animation_index, len(model.animations) - 1)]
        anim_mod.apply_animation(model, anim, time)
        return anim_mod.update_node_hierarchy(model)

    def update(self, time: float, animation_index: int = 0) -> SceneArrays:
        """Per-frame scene update on the host: sample animations → node
        hierarchy → skinning → vertex refresh → C++ BVH refit → arrays
        uploaded again (ref: ModelManager.Update, ModelManager.cs:236-361,
        whose GPU skinning is read back for a CPU refit). Returns the new
        device SceneArrays (a fresh 4-wide collapse of the refitted tree)."""
        any_dynamic = False
        for mi, model in enumerate(self.models):
            if not model.animations:
                continue
            transforms = self._animate(model, time, animation_index)
            any_dynamic = True
            skinned: dict[int, tuple] = {}
            for mi2, ni, pi, im, v0, v1 in self._placements:
                if mi2 != mi:
                    continue
                node = model.nodes[ni]
                prim = model.primitives[pi]
                if node.skin >= 0 and prim.joints is not None:
                    if pi not in skinned:
                        skinned[pi] = self._skin(model, node, prim, transforms, "cpu")
                    p_local, n_local = (x.numpy() for x in skinned[pi])
                    world = np.eye(4, dtype=np.float32)  # skin is in model space
                else:
                    p_local, n_local = prim.positions, prim.normals
                    world = transforms[ni] @ im
                nrm_m = np.linalg.inv(world[:3, :3]).T
                self._verts[v0:v1] = (p_local @ world[:3, :3].T + world[:3, 3]).astype(np.float32)
                self._normals[v0:v1] = mu.normalize(n_local @ nrm_m.T).astype(np.float32)
        if not any_dynamic:
            return self.device_scene
        self.blas.refit(self._verts)
        self._flat.refresh_boxes(self.blas.nodes)
        self._refitter = None  # the new scene's wide records are collapsed anew
        self.device_scene = self._upload()
        return self.device_scene

    @staticmethod
    def _skin(model: Model, node, prim, transforms, device):
        """(positions, normals) of a skinned primitive in model space, on `device`."""
        jm = torch.as_tensor(skin_mod.joint_matrices(transforms, model.skins[node.skin]),
                             device=device)

        def put(x):
            return torch.as_tensor(np.asarray(x), device=device)

        joints, weights = put(prim.joints.astype(np.int64)), put(prim.weights)
        return (skin_mod.skin_positions(put(prim.positions), joints, weights, jm),
                skin_mod.skin_normals(put(prim.normals), joints, weights, jm))

    # ------------------------------------------------------------------
    def _get_refitter(self):
        """The device refit plan (render/dynamic.py), made once a build, and
        the placements' vertices the device transform starts from: an
        animated model's local positions and normals, the others' world ones."""
        if self._refitter is None:
            from ..render.dynamic import DeviceRefitter, build_refit_plan

            plan = build_refit_plan(self._flat, self._slot_tri, self._indices,
                                    self.build_settings.max_leaf_triangle_count)
            self._refitter = DeviceRefitter(plan, self.device_scene)
            vid = np.zeros(self._verts.shape[0], np.int64)
            local_v, local_n = self._verts.copy(), self._normals.copy()
            for k, (mi, _, pi, _, v0, v1) in enumerate(self._placements):
                vid[v0:v1] = k
                if self.models[mi].animations:
                    prim = self.models[mi].primitives[pi]
                    local_v[v0:v1], local_n[v0:v1] = prim.positions, prim.normals
            dev = self.device_scene.device
            self._placement_of_vertex = torch.as_tensor(vid, device=dev)
            self._verts_local = torch.as_tensor(local_v, device=dev)
            self._normals_local = torch.as_tensor(local_n, device=dev)
        return self._refitter

    def placement_matrices(self, time: float, animation_index: int = 0):
        """Sample the animations at `time`; returns ((P,4,4) placement
        matrices, (P,3,3) their normal matrices, [(first vertex, end vertex,
        skinned positions, skinned normals)] on the scene's device), or None
        when no model is animated. Identity for placements of static
        models and skinned ones."""
        dev = self.device_scene.device
        n_place = len(self._placements)
        mats = np.tile(np.eye(4, dtype=np.float32)[None], (n_place, 1, 1))
        skinned = []
        any_dynamic = False
        for mi, model in enumerate(self.models):
            if not model.animations:
                continue
            transforms = self._animate(model, time, animation_index)
            any_dynamic = True
            for k, (mi2, ni, pi, im, v0, v1) in enumerate(self._placements):
                if mi2 != mi:
                    continue
                node = model.nodes[ni]
                prim = model.primitives[pi]
                if node.skin >= 0 and prim.joints is not None:
                    skinned.append((v0, v1, *self._skin(model, node, prim, transforms, dev)))
                else:
                    mats[k] = transforms[ni] @ im
        if not any_dynamic:
            return None
        nrm = np.linalg.inv(mats[:, :3, :3]).transpose(0, 2, 1).astype(np.float32)
        return torch.as_tensor(mats, device=dev), torch.as_tensor(nrm, device=dev), skinned

    def transform_vertices(self, mats, nrm_mats, skinned):
        """The world-space (vertices, normals) on the scene's device for
        placement_matrices' output."""
        vid = self._placement_of_vertex
        m = mats[vid]
        verts = linear_map(m[:, :3, :3], self._verts_local) + m[:, :3, 3]
        normals = linear_map(nrm_mats[vid], self._normals_local)
        normals = normals / torch.clamp(torch.linalg.vector_norm(normals, dim=-1, keepdim=True),
                                        min=1e-12)
        for v0, v1, sp, sn in skinned:
            verts[v0:v1] = sp
            normals[v0:v1] = sn
        return verts, normals

    def update_device(self, time: float, animation_index: int = 0) -> SceneArrays:
        """Per-frame scene update on the scene's device: the host samples the
        animation transforms (small), the device transforms the vertices,
        refits the BVH level by level and refreshes every table — no
        geometry readback (contrast update(), the reference's fenced
        readback). Returns the refreshed SceneArrays; its vertices stay in
        `device_vertices`."""
        refitter = self._get_refitter()
        sampled = self.placement_matrices(time, animation_index)
        if sampled is None:
            return self.device_scene
        verts, normals = self.transform_vertices(*sampled)
        self.device_vertices = verts
        self.device_scene = refitter.refit(self.device_scene, verts, normals)
        return self.device_scene

    def refit_host(self, new_vertices: np.ndarray) -> SceneArrays:
        """Host refit path: new world-space vertices, C++ BLAS refit, the
        arrays threaded and uploaded again (the per-frame device path is
        update_device)."""
        self._verts = np.ascontiguousarray(new_vertices, np.float32)
        self.blas.refit(self._verts)
        self._flat, slot_perm = thread_bvh(self.blas.nodes)
        self._slot_tri = self.blas.tri_indices[slot_perm]
        self._refitter = None
        self.device_scene = self._upload()
        return self.device_scene

    # ------------------------------------------------------------------
    def intersect_ray(self, origin, direction, t_max=3.4e38):
        """CPU picking/collision ray against the world BLAS of the build
        (ref: BVH.Intersect, Bvh/BVH.cs:162-223): (t, u, v, triangle id) or
        None."""
        if self.blas is None:
            raise ValueError("build the scene database before querying it")
        return self.blas.intersect_ray(origin, direction, t_max)

    def intersect_box(self, box_min, box_max):
        """Triangle ids of the world BLAS's leaves overlapping the box."""
        if self.blas is None:
            raise ValueError("build the scene database before querying it")
        return self.blas.intersect_box(box_min, box_max)

    # ------------------------------------------------------------------
    # Instanced models: own BLAS per model, traced through the two-level
    # path (ref: TLAS.cs + BVH.cs:162-223) — transform updates never
    # rebuild or refit geometry.
    # ------------------------------------------------------------------
    def add_instanced_model(self, model: Model, transforms: np.ndarray) -> int:
        """Register a model drawn at `transforms` ((I,4,4) world matrices)
        through its OWN BLAS (ref: ModelManager BLAS-per-mesh + TLAS over
        instances). Returns the model's id. Call before build()."""
        mi = len(self._instanced_models)
        self._instanced_models.append(model)
        for t in np.asarray(transforms, np.float32).reshape(-1, 4, 4):
            self._instance_list.append([mi, t])
        return mi

    def _build_instanced(self, slot_base: int, models=None) -> list:
        """Build a BLAS and scene arrays for each instanced model (all, or
        `models`), appended to the per-model lists, slots from `slot_base`
        on. Returns their FlatTriangles, the attribute tables' sources."""
        srcs = []
        slot_off = slot_base
        for model in self._instanced_models if models is None else models:
            verts, idx, norms, uvs, tri_mat = [], [], [], [], []
            voff = 0
            mat_off = self.materials.add_model(model)
            transforms = model.global_transforms()
            for ni, node in enumerate(model.nodes):
                for pi in node.mesh_primitives:
                    prim = model.primitives[pi]
                    prim.ensure_normals()
                    m = transforms[ni]
                    nrm_m = np.linalg.inv(m[:3, :3]).T
                    verts.append((prim.positions @ m[:3, :3].T + m[:3, 3]).astype(np.float32))
                    norms.append(mu.normalize(prim.normals @ nrm_m.T).astype(np.float32))
                    uvs.append(prim.uvs.astype(np.float32) if prim.uvs is not None
                               else np.zeros((prim.positions.shape[0], 2), np.float32))
                    idx.append(prim.indices.astype(np.uint32) + voff)
                    tri_mat.append(np.full(prim.indices.shape[0], prim.material + mat_off,
                                           np.int32))
                    voff += prim.positions.shape[0]
            v = np.concatenate(verts)
            ix = np.concatenate(idx)
            blas = BLAS(v, ix, self.build_settings)
            flat, slot_perm = thread_bvh(blas.nodes)
            slot_tri = blas.tri_indices[slot_perm]
            ft = flatten_triangles(slot_tri, v, ix, np.concatenate(norms), np.concatenate(uvs),
                                   np.concatenate(tri_mat))
            self._inst_blas.append(blas)
            self._inst_scene_arrays.append(SceneArrays.from_flat(
                flat, ft, self.build_settings.max_leaf_triangle_count, self._device))
            self._inst_slot_off.append(slot_off)
            srcs.append(ft)
            slot_off += slot_tri.shape[0]
        return srcs

    def add_model_runtime(self, model: Model, transform: np.ndarray | None = None) -> int:
        """Add a model AFTER build() without touching existing geometry
        (ref: Gui.AddModelDialog → ModelManager.Add + BLAS build of only the
        new ranges, ModelManager.cs:128-216): the model gets its own BLAS
        and joins the two-level instance path. Returns its instance id; a
        renderer takes it through a new instance_set()."""
        if self.device_scene is None:
            raise ValueError("build the scene database before adding a model at run time")
        if transform is None:
            transform = np.eye(4, dtype=np.float32)
        mi = len(self._instanced_models)
        self._instanced_models.append(model)
        inst_id = len(self._instance_list)
        self._instance_list.append([mi, np.asarray(transform, np.float32)])
        slot_base = (self._inst_slot_off[-1] + self._inst_scene_arrays[-1].tri_p0.shape[0]
                     if self._inst_slot_off else int(self._slot_tri.shape[0]))
        self._inst_attr_srcs.extend(self._build_instanced(slot_base, [model]))
        self._refresh_instance_device()
        log.info("runtime add: model %d as instance %d (BLAS %d nodes)",
                 mi, inst_id, self._inst_blas[-1].nodes.shape[0])
        return inst_id

    def set_instance_transform(self, instance: int, transform: np.ndarray):
        """Move one instance: updates its matrix, world box and the TLAS —
        geometry untouched (the no-rebuild contract, ref: TLAS.cs role)."""
        self._instance_list[instance][1] = np.asarray(transform, np.float32)
        self._refresh_instance_device()

    def _refresh_instance_device(self):
        """The instances' world->local affines, world boxes (the local root
        box's eight corners, moved) and normal matrices on the scene's
        device, and the TLAS over the static root box and the instances'."""
        invs, boxes, nmats = [], [], []
        for mi, t in self._instance_list:
            blas = self._inst_blas[mi]
            m = np.asarray(t, np.float64)
            invs.append(np.linalg.inv(m)[:3, :4])
            lo = blas.nodes["min"][0].astype(np.float64)
            hi = blas.nodes["max"][0].astype(np.float64)
            corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                                for z in (lo[2], hi[2])])
            wc = corners @ m[:3, :3].T + m[:3, 3]
            boxes.append(np.stack([wc.min(0), wc.max(0)]))
            nmats.append(np.linalg.inv(m[:3, :3]).T)

        def put(x):
            return torch.as_tensor(np.stack(x).astype(np.float32), device=self._device)

        self.instance_inv, self.instance_boxes, self.instance_normal_mat = (
            put(invs), put(boxes), put(nmats))
        aabbs = [np.concatenate([b[0], b[1]]) for b in boxes]
        aabbs.insert(0, np.concatenate([self._flat.node_min[0], self._flat.node_max[0]]))
        self.tlas = TLAS(np.stack(aabbs))

    def instance_set(self) -> InstanceSet | None:
        """InstanceSet for the PathTracer, or None without instances."""
        if not self._instance_list:
            return None
        return InstanceSet(
            scenes=[self._inst_scene_arrays[mi] for mi, _ in self._instance_list],
            inv=self.instance_inv, boxes=self.instance_boxes,
            slot_off=torch.as_tensor([self._inst_slot_off[mi] for mi, _ in self._instance_list],
                                     dtype=torch.int32, device=self._device),
            normal_mat=self.instance_normal_mat)
