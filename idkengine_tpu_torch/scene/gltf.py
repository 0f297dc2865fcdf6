"""glTF 2.0 loader (self-contained: JSON+bin / GLB parsing, no third-party libs).
Counterpart: idkengine_tpu/scene/gltf.py.

Covers the reference loader's feature surface (ref: ModelLoader.cs:30-38
supported-extensions list and :563-622 LoadGltfFromFile): node hierarchy,
animations, skins, materials with KHR_materials_{emissive_strength,volume,
ior,transmission}, KHR_texture_basisu, EXT_mesh_gpu_instancing, normal
generation, and sparse accessors. Texture images decode through the KTX2
parser, or through PIL (PNG/JPG) where it is installed; undecodable images fall back to flat material
factors the way the reference falls back to 4x4 placeholder textures
(ref: ModelLoader.cs:879-906).
"""
from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from ..log import get_logger
from .ktx2 import decode_ktx2
from .model import (
    Animation,
    AnimationChannel,
    AnimationSampler,
    Material,
    MeshPrimitive,
    Model,
    Node,
    Skin,
    Texture,
)

log = get_logger(__name__)

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT2": 4, "MAT3": 9, "MAT4": 16}


class _GltfFile:
    def __init__(self, path: str):
        self.dir = os.path.dirname(os.path.abspath(path))
        with open(path, "rb") as f:
            head = f.read(4)
            f.seek(0)
            if head == b"glTF":  # GLB container
                magic, version, length = struct.unpack("<III", f.read(12))
                self.json = None
                self.bin_chunk = None
                offset = 12
                data = f.read()
                pos = 0
                while pos < len(data):
                    clen, ctype = struct.unpack_from("<II", data, pos)
                    chunk = data[pos + 8 : pos + 8 + clen]
                    if ctype == 0x4E4F534A:  # JSON
                        self.json = json.loads(chunk)
                    elif ctype == 0x004E4942:  # BIN
                        self.bin_chunk = chunk
                    pos += 8 + clen + (-clen % 4) * 0
                    pos += (-clen) % 4
                assert self.json is not None, "GLB missing JSON chunk"
                del offset, magic, version, length
            else:
                self.json = json.load(open(path, encoding="utf-8"))
                self.bin_chunk = None
        self._buffers: dict[int, bytes] = {}

    def buffer(self, i: int) -> bytes:
        if i in self._buffers:
            return self._buffers[i]
        b = self.json["buffers"][i]
        uri = b.get("uri")
        if uri is None:
            data = self.bin_chunk
        elif uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            with open(os.path.join(self.dir, uri), "rb") as f:
                data = f.read()
        self._buffers[i] = data
        return data

    def accessor(self, i: int) -> np.ndarray:
        """Decode accessor i to (count, components) float/int array
        (handles byteStride, normalized, and sparse)."""
        acc = self.json["accessors"][i]
        count = acc["count"]
        ncomp = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        itemsize = np.dtype(dtype).itemsize
        if "bufferView" in acc:
            bv = self.json["bufferViews"][acc["bufferView"]]
            data = self.buffer(bv["buffer"])
            start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = bv.get("byteStride", itemsize * ncomp)
            if stride == itemsize * ncomp:
                arr = np.frombuffer(data, dtype=dtype, count=count * ncomp, offset=start)
                arr = arr.reshape(count, ncomp)
            else:
                raw = np.frombuffer(
                    data, dtype=np.uint8, count=stride * (count - 1) + itemsize * ncomp, offset=start
                )
                arr = np.lib.stride_tricks.as_strided(
                    raw.view(dtype),
                    shape=(count, ncomp),
                    strides=(stride, itemsize),
                    writeable=False,
                ).copy()
        else:
            arr = np.zeros((count, ncomp), dtype=dtype)
        if "sparse" in acc:
            sp = acc["sparse"]
            n = sp["count"]
            idt = _COMPONENT_DTYPES[sp["indices"]["componentType"]]
            ibv = self.json["bufferViews"][sp["indices"]["bufferView"]]
            ioff = ibv.get("byteOffset", 0) + sp["indices"].get("byteOffset", 0)
            sidx = np.frombuffer(self.buffer(ibv["buffer"]), dtype=idt, count=n, offset=ioff)
            vbv = self.json["bufferViews"][sp["values"]["bufferView"]]
            voff = vbv.get("byteOffset", 0) + sp["values"].get("byteOffset", 0)
            svals = np.frombuffer(
                self.buffer(vbv["buffer"]), dtype=dtype, count=n * ncomp, offset=voff
            ).reshape(n, ncomp)
            arr = arr.copy()
            arr[sidx] = svals
        if acc.get("normalized") and np.issubdtype(dtype, np.integer):
            info = np.iinfo(dtype)
            arr = arr.astype(np.float32) / float(info.max)
            if info.min < 0:
                arr = np.maximum(arr, -1.0)
        return arr

    def image_bytes(self, i: int) -> tuple[bytes, str]:
        img = self.json["images"][i]
        if "uri" in img:
            uri = img["uri"]
            if uri.startswith("data:"):
                return base64.b64decode(uri.split(",", 1)[1]), img.get("mimeType", "")
            with open(os.path.join(self.dir, uri), "rb") as f:
                return f.read(), uri.rsplit(".", 1)[-1].lower()
        bv = self.json["bufferViews"][img["bufferView"]]
        data = self.buffer(bv["buffer"])
        start = bv.get("byteOffset", 0)
        return data[start : start + bv["byteLength"]], img.get("mimeType", "")


def decode_texture_bytes(raw: bytes, hint: str) -> np.ndarray | None:
    """Public texture decode entry (async IO path, scene/async_io.py)."""
    return _decode_image(raw, hint)


def apply_channel_layout(img: np.ndarray | None,
                         layout: str | None) -> np.ndarray | None:
    """Normalize an IDK_BC5_normal_metallicRoughness payload to the
    standard glTF channel layout.

    The extension packs normal X / metalness in R and normal Y / roughness
    in A so engines can transcode to BC5_RG
    (ref: glTF-Extensions/IDK_BC5_normal_metallicRoughness/README.md:27-40;
    consumed at ModelLoader.cs:601-610 + 966-994 — the reference
    normalizes with GL swizzles so shaders always read metallic from R and
    roughness from G, Surface.glsl:61-66). Here the decoded RGBA8 pixels
    are rewritten once at load so the samplers stay branch-free:

      bc5_normal: R=X, G=Y(from A), B=reconstructed Z, A=255
      bc5_mr:     G=roughness(from A), B=metalness(from R)  (glTF layout)
    """
    if img is None or layout is None:
        return img
    out = np.array(img, copy=True)
    if layout == "bc5_normal":
        x = img[..., 0].astype(np.float32) * (2.0 / 255.0) - 1.0
        y = img[..., 3].astype(np.float32) * (2.0 / 255.0) - 1.0
        z = np.sqrt(np.maximum(1.0 - x * x - y * y, 0.0))
        out[..., 1] = img[..., 3]
        out[..., 2] = np.round((z * 0.5 + 0.5) * 255.0).astype(np.uint8)
        out[..., 3] = 255
    elif layout == "bc5_mr":
        out[..., 1] = img[..., 3]  # roughness ← A
        out[..., 2] = img[..., 0]  # metalness ← R
        out[..., 0] = 255
        out[..., 3] = 255
    else:
        raise ValueError(f"unknown channel layout {layout!r}")
    return out


def _decode_image(raw: bytes, hint: str) -> np.ndarray | None:
    """bytes → (H,W,4) uint8 or None."""
    if raw[:12].startswith(b"\xabKTX 20\xbb") or hint.endswith("ktx2"):
        return decode_ktx2(raw)
    try:
        import io

        from PIL import Image

        img = Image.open(io.BytesIO(raw)).convert("RGBA")
        return np.asarray(img)
    except Exception:
        return None


def _load_material(m: dict) -> Material:
    mat = Material(name=m.get("name", ""))
    pbr = m.get("pbrMetallicRoughness", {})
    mat.base_color = np.asarray(pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32)
    mat.metallic = float(pbr.get("metallicFactor", 1.0))
    mat.roughness = float(pbr.get("roughnessFactor", 1.0))
    if "baseColorTexture" in pbr:
        mat.base_color_texture = pbr["baseColorTexture"]["index"]
    if "metallicRoughnessTexture" in pbr:
        mat.metallic_roughness_texture = pbr["metallicRoughnessTexture"]["index"]
    if "normalTexture" in m:
        mat.normal_texture = m["normalTexture"]["index"]
    if "occlusionTexture" in m:
        mat.occlusion_texture = m["occlusionTexture"]["index"]
    emissive = np.asarray(m.get("emissiveFactor", [0, 0, 0]), np.float32)
    if "emissiveTexture" in m:
        mat.emissive_texture = m["emissiveTexture"]["index"]
    alpha_mode = m.get("alphaMode", "OPAQUE")
    mat.alpha_cutoff = (
        -1.0 if alpha_mode == "OPAQUE" else (0.0 if alpha_mode == "BLEND" else float(m.get("alphaCutoff", 0.5)))
    )
    mat.double_sided = bool(m.get("doubleSided", False))
    ext = m.get("extensions", {})
    strength = float(ext.get("KHR_materials_emissive_strength", {}).get("emissiveStrength", 1.0))
    mat.emissive = emissive * strength
    mat.ior = float(ext.get("KHR_materials_ior", {}).get("ior", 1.5))
    mat.transmission = float(
        ext.get("KHR_materials_transmission", {}).get("transmissionFactor", 0.0)
    )
    vol = ext.get("KHR_materials_volume")
    if vol:
        # Beer–Lambert absorbance from attenuation color/distance
        # (ref: ModelLoader.cs:1565-1628 absorbance math)
        att_color = np.asarray(vol.get("attenuationColor", [1, 1, 1]), np.float32)
        att_dist = float(vol.get("attenuationDistance", np.inf))
        if att_dist > 0 and np.isfinite(att_dist):
            mat.absorbance = (-np.log(np.maximum(att_color, 1e-4)) / att_dist).astype(np.float32)
    return mat


def load_gltf(path: str, load_textures: bool = True,
              defer_textures: bool = False,
              optimize: bool = True) -> Model:
    """Load a .gltf/.glb file into the engine Model representation.

    defer_textures=True reads texture bytes but skips decoding — each
    Texture carries source_bytes for a background decode
    (ref: ModelLoader's async texture tasks; see scene/async_io.py).
    optimize=True runs the meshopt pass (scene/meshopt.py — the
    reference's gltfpack/OptimizeVertexCache role, ModelLoader.cs:
    1695-1805): Morton triangle reorder + first-use vertex reindex."""
    gf = _GltfFile(path)
    g = gf.json
    model = Model(name=os.path.basename(path))

    # --- materials -------------------------------------------------------
    for m in g.get("materials", []):
        model.materials.append(_load_material(m))
    if not model.materials:
        model.materials.append(Material(name="default"))

    # --- textures (glTF texture -> image id; KHR_texture_basisu source) --
    uses_bc5 = ("IDK_BC5_normal_metallicRoughness"
                in g.get("extensionsUsed", []))
    if ("KHR_texture_basisu" in g.get("extensionsUsed", [])
            and not uses_bc5):
        # ref: ModelLoader.cs:601-608 warns about the quality loss
        log.warning(
            "%s uses KHR_texture_basisu without "
            "IDK_BC5_normal_metallicRoughness: normal/metallicRoughness "
            "textures keep the lower-quality differential encoding",
            model.name)
    if load_textures:
        img_cache: dict[int, np.ndarray | None] = {}
        srgb_targets = set()
        normal_targets = set()
        mr_targets = set()
        for mi, m in enumerate(g.get("materials", [])):
            pbr = m.get("pbrMetallicRoughness", {})
            if "baseColorTexture" in pbr:
                srgb_targets.add(pbr["baseColorTexture"]["index"])
            if "emissiveTexture" in m:
                srgb_targets.add(m["emissiveTexture"]["index"])
            if "normalTexture" in m:
                normal_targets.add(m["normalTexture"]["index"])
            if "metallicRoughnessTexture" in pbr:
                mr_targets.add(pbr["metallicRoughnessTexture"]["index"])
        for ti, tex in enumerate(g.get("textures", [])):
            src = tex.get("source")
            ext = tex.get("extensions", {})
            basisu = "KHR_texture_basisu" in ext
            if basisu:
                src = ext["KHR_texture_basisu"]["source"]
            # IDK_BC5 semantics apply to BasisU-sourced normal/MR textures
            # (ref: ModelLoader.cs:966-994 — only KTX2 payloads transcode
            # to BC5_RG; PNG fallbacks keep standard channels)
            layout = None
            if uses_bc5 and basisu:
                if ti in normal_targets:
                    layout = "bc5_normal"
                elif ti in mr_targets:
                    layout = "bc5_mr"
            data = None
            raw_bytes = None
            cache_key = (src, layout)
            if src is not None:
                if cache_key not in img_cache:
                    try:
                        raw, hint = gf.image_bytes(src)
                        if defer_textures:
                            img_cache[cache_key] = (None, raw, hint)
                        else:
                            img_cache[cache_key] = (
                                apply_channel_layout(
                                    _decode_image(raw, hint), layout),
                                None, hint)
                    except Exception as e:  # missing file etc.
                        log.warning("texture %d image %s undecodable: %s", ti, src, e)
                        img_cache[cache_key] = (None, None, "")
                data, raw_bytes, hint2 = img_cache[cache_key]
            t = Texture(name=str(src) if raw_bytes is None else
                        f"{src}.{hint2}", data=data,
                        is_srgb=ti in srgb_targets,
                        channel_layout=layout)
            if raw_bytes is not None:
                t.source_bytes = raw_bytes
                t.name = hint2  # decode hint travels in the name
            model.textures.append(t)

    # --- mesh primitives -------------------------------------------------
    prim_map: dict[int, list[int]] = {}
    for mi, mesh in enumerate(g.get("meshes", [])):
        prim_map[mi] = []
        for prim in mesh["primitives"]:
            if prim.get("mode", 4) != 4:
                log.warning("skipping non-triangle primitive (mode=%s)", prim.get("mode"))
                continue
            attrs = prim["attributes"]
            positions = gf.accessor(attrs["POSITION"]).astype(np.float32)
            if "indices" in prim:
                indices = gf.accessor(prim["indices"]).astype(np.uint32).reshape(-1, 3)
            else:
                indices = np.arange(positions.shape[0], dtype=np.uint32).reshape(-1, 3)
            p = MeshPrimitive(
                positions=positions,
                indices=indices,
                material=prim.get("material", 0),
            )
            if "NORMAL" in attrs:
                p.normals = gf.accessor(attrs["NORMAL"]).astype(np.float32)
            if "TANGENT" in attrs:
                p.tangents = gf.accessor(attrs["TANGENT"]).astype(np.float32)
            if "TEXCOORD_0" in attrs:
                p.uvs = gf.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
            if "JOINTS_0" in attrs:
                p.joints = gf.accessor(attrs["JOINTS_0"]).astype(np.uint16)
            if "WEIGHTS_0" in attrs:
                w = gf.accessor(attrs["WEIGHTS_0"]).astype(np.float32)
                s = w.sum(axis=-1, keepdims=True)
                p.weights = np.where(s > 0, w / np.maximum(s, 1e-8), w)
            p.ensure_normals()
            prim_map[mi].append(len(model.primitives))
            model.primitives.append(p)

    # --- nodes (re-ordered parent-before-child) ---------------------------
    gnodes = g.get("nodes", [])
    scene = g.get("scenes", [{}])[g.get("scene", 0)]
    roots = scene.get("nodes", list(range(len(gnodes))))
    order: list[int] = []
    parent_of = {r: -1 for r in roots}
    stack = list(reversed(roots))
    seen = set()
    while stack:
        gi = stack.pop()
        if gi in seen:
            continue
        seen.add(gi)
        order.append(gi)
        for c in gnodes[gi].get("children", []):
            parent_of[c] = gi
            stack.append(c)
    remap = {gi: i for i, gi in enumerate(order)}

    for gi in order:
        gn = gnodes[gi]
        node = Node(name=gn.get("name", f"node{gi}"))
        node.parent = remap.get(parent_of.get(gi, -1), -1)
        if "matrix" in gn:
            from ..utils.mathutil import decompose_trs

            m = np.asarray(gn["matrix"], np.float32).reshape(4, 4).T  # column-major in file
            t, q, s = decompose_trs(m)
            node.translation, node.rotation, node.scale = t, q, s
        else:
            node.translation = np.asarray(gn.get("translation", [0, 0, 0]), np.float32)
            node.rotation = np.asarray(gn.get("rotation", [0, 0, 0, 1]), np.float32)
            node.scale = np.asarray(gn.get("scale", [1, 1, 1]), np.float32)
        if "mesh" in gn:
            node.mesh_primitives = list(prim_map.get(gn["mesh"], []))
        node.skin = gn.get("skin", -1)
        inst = gn.get("extensions", {}).get("EXT_mesh_gpu_instancing")
        if inst:
            attrs = inst.get("attributes", {})
            n_inst = None
            tr = rot = sc = None
            if "TRANSLATION" in attrs:
                tr = gf.accessor(attrs["TRANSLATION"]).astype(np.float32)
                n_inst = tr.shape[0]
            if "ROTATION" in attrs:
                rot = gf.accessor(attrs["ROTATION"]).astype(np.float32)
                n_inst = rot.shape[0]
            if "SCALE" in attrs:
                sc = gf.accessor(attrs["SCALE"]).astype(np.float32)
                n_inst = sc.shape[0]
            if n_inst:
                from ..utils.mathutil import trs_matrix

                tr = tr if tr is not None else np.zeros((n_inst, 3), np.float32)
                rot = rot if rot is not None else np.tile([0, 0, 0, 1.0], (n_inst, 1)).astype(np.float32)
                sc = sc if sc is not None else np.ones((n_inst, 3), np.float32)
                node.instance_transforms = trs_matrix(tr, rot, sc)
        model.nodes.append(node)
        if node.parent < 0:
            model.root_nodes.append(remap[gi])
        else:
            model.nodes[node.parent].children.append(remap[gi])

    # --- animations --------------------------------------------------------
    for ga in g.get("animations", []):
        samplers = []
        for s in ga.get("samplers", []):
            times = gf.accessor(s["input"]).reshape(-1).astype(np.float32)
            values = gf.accessor(s["output"]).astype(np.float32)
            samplers.append(AnimationSampler(times, values, s.get("interpolation", "LINEAR")))
        channels = []
        for c in ga.get("channels", []):
            tgt = c["target"]
            if "node" not in tgt or tgt["node"] not in remap:
                continue
            channels.append(
                AnimationChannel(remap[tgt["node"]], tgt["path"], samplers[c["sampler"]])
            )
        model.animations.append(Animation(ga.get("name", f"anim{len(model.animations)}"), channels))

    # --- skins --------------------------------------------------------------
    for gs in g.get("skins", []):
        joints = np.asarray([remap[j] for j in gs["joints"]], np.int32)
        if "inverseBindMatrices" in gs:
            ibm = gf.accessor(gs["inverseBindMatrices"]).reshape(-1, 4, 4).transpose(0, 2, 1)
        else:
            ibm = np.tile(np.eye(4, dtype=np.float32), (len(joints), 1, 1))
        model.skins.append(
            Skin(joints=joints, inverse_bind_matrices=ibm.astype(np.float32),
                 skeleton=remap.get(gs.get("skeleton", -1), -1))
        )

    if optimize:
        from .meshopt import optimize_model
        optimize_model(model)

    log.info(
        "loaded %s: %d nodes, %d prims, %d tris, %d materials, %d anims",
        model.name, len(model.nodes), len(model.primitives),
        model.triangle_count(), len(model.materials), len(model.animations),
    )
    return model
