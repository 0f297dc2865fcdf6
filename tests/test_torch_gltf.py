"""The port's glTF loader and meshopt pass against the JAX package's, on
files written here.

`scene_json` builds one asset that takes every branch of `load_gltf`: a
node tree in `matrix` and TRS form with a node outside the scene; an
interleaved (byteStride) vertex view, normalized integer UVs, a sparse
accessor, uint16 and uint32 indices, a primitive without indices and
normals (normals generated), a lines primitive (skipped); materials with
the three alpha modes and KHR_materials_emissive_strength / ior /
transmission / volume; KTX2 textures (raw and zlib RGBA8, R8) by buffer
view and by URI, two through KHR_texture_basisu under
IDK_BC5_normal_metallicRoughness (a normal and a metal-roughness target);
a skin with inverse bind matrices; EXT_mesh_gpu_instancing; LINEAR, STEP
and CUBICSPLINE samplers. It is written as a `.gltf` with an external
`.bin`, as a `.glb`, and as a `.gltf` with data-URI buffers. Both loaders
must give equal models, every array bit for bit with its dtype, with the
meshopt pass on and off and with deferred textures; the meshopt
permutations are equal too. PNG textures need Pillow on both sides.
"""
import base64
import dataclasses
import io
import json
import struct
import zlib

import numpy as np
import pytest

from idkengine_tpu.scene import gltf as j_gltf
from idkengine_tpu.scene import meshopt as j_meshopt
from idkengine_tpu.scene.model import MeshPrimitive as JMeshPrimitive
from idkengine_tpu_torch.scene import gltf, meshopt
from idkengine_tpu_torch.scene.model import MeshPrimitive

from test_torch_ktx2 import ktx2_bytes
from worker_threads import share_cores

share_cores()


class Buffer:
    """The binary buffer, its views and its accessors of an asset."""

    def __init__(self):
        self.data = bytearray()
        self.views, self.accessors = [], []

    def view(self, raw: bytes, stride=None) -> int:
        self.data += bytes(-len(self.data) % 4)
        v = {"buffer": 0, "byteOffset": len(self.data), "byteLength": len(raw)}
        if stride:
            v["byteStride"] = stride
        self.data += raw
        self.views.append(v)
        return len(self.views) - 1

    def accessor(self, arr, ctype, kind, view=None, offset=0, count=None, **extra) -> int:
        arr = np.ascontiguousarray(arr)
        if view is None:
            view = self.view(arr.tobytes())
        a = {"bufferView": view, "componentType": ctype, "type": kind,
             "count": int(count if count is not None else arr.shape[0]), **extra}
        if offset:
            a["byteOffset"] = offset
        self.accessors.append(a)
        return len(self.accessors) - 1


def rgba_ktx2(rs, w, h, zlib_scheme=False):
    raw = rs.randint(0, 256, (h, w, 4)).astype(np.uint8).tobytes()
    if zlib_scheme:
        return ktx2_bytes(37, w, h, [zlib.compress(raw)], scheme=3, uncomp=[len(raw)])
    return ktx2_bytes(43, w, h, [raw])


def scene_json(rs, with_png=False):
    """(the asset's JSON without buffers, its binary buffer, the external
    files its image URIs name)."""
    buf = Buffer()
    # mesh 0: interleaved position + normal, normalized uint16 UVs, tangents,
    # uint16 indices, on a 6x6 grid
    n = 6
    gx, gz = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n))
    pos = np.stack([gx, 0.1 * rs.rand(n, n), gz], -1).reshape(-1, 3).astype(np.float32)
    nrm = np.tile(np.float32([0, 1, 0]), (n * n, 1))
    inter = np.concatenate([pos, nrm], 1).astype(np.float32)
    iv = buf.view(inter.tobytes(), stride=24)
    a_pos = buf.accessor(pos, 5126, "VEC3", view=iv, count=n * n,
                         min=pos.min(0).tolist(), max=pos.max(0).tolist())
    a_nrm = buf.accessor(nrm, 5126, "VEC3", view=iv, offset=12, count=n * n)
    uv16 = rs.randint(0, 65536, (n * n, 2)).astype(np.uint16)
    a_uv = buf.accessor(uv16, 5123, "VEC2", normalized=True)
    tan = np.tile(np.float32([1, 0, 0, 1]), (n * n, 1))
    a_tan = buf.accessor(tan, 5126, "VEC4")
    quads = [(r * n + c, r * n + c + 1, (r + 1) * n + c + 1, (r + 1) * n + c)
             for r in range(n - 1) for c in range(n - 1)]
    idx = np.array([[a, b, cc] for a, b, cc, d in quads] + [[a, cc, d] for a, b, cc, d in quads],
                   np.uint16)
    idx = idx[rs.permutation(idx.shape[0])]
    a_idx = buf.accessor(idx.reshape(-1), 5123, "SCALAR")
    # a primitive without indices or normals, its positions sparse over zeros
    tri = rs.rand(9, 3).astype(np.float32)
    sp_idx = np.array([0, 2, 3, 4, 5, 6, 7, 8], np.uint8)
    sp_val = tri[sp_idx]
    a_soup = len(buf.accessors)
    buf.accessors.append({"componentType": 5126, "type": "VEC3", "count": 9, "sparse": {
        "count": len(sp_idx),
        "indices": {"bufferView": buf.view(sp_idx.tobytes()), "componentType": 5121},
        "values": {"bufferView": buf.view(sp_val.tobytes())}}})
    # mesh 1: skinned, uint32 indices, uint8 joints, weights that do not sum to 1
    sk_pos = (rs.rand(12, 3) * 2 - 1).astype(np.float32)
    a_skp = buf.accessor(sk_pos, 5126, "VEC3")
    a_skn = buf.accessor(rs.randn(12, 3).astype(np.float32), 5126, "VEC3")
    a_j = buf.accessor(rs.randint(0, 2, (12, 4)).astype(np.uint8), 5121, "VEC4")
    w = rs.rand(12, 4).astype(np.float32)
    w[0] = 0.0
    a_w = buf.accessor(w, 5126, "VEC4")
    a_ski = buf.accessor(rs.randint(0, 12, (10, 3)).astype(np.uint32).reshape(-1), 5125,
                         "SCALAR")
    ibm = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    ibm[1, 3, :3] = [0.5, -1.0, 0.25]  # column-major: a translation
    a_ibm = buf.accessor(ibm.reshape(2, 16), 5126, "MAT4")
    # mesh 2: the instanced quad and its instances
    a_q = buf.accessor(np.float32([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]]), 5126, "VEC3")
    a_qi = buf.accessor(np.uint32([0, 1, 2, 0, 2, 3]), 5125, "SCALAR")
    k = 5
    q = rs.randn(k, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    a_it = buf.accessor(rs.randn(k, 3).astype(np.float32), 5126, "VEC3")
    a_ir = buf.accessor(q, 5126, "VEC4")
    a_is = buf.accessor((0.5 + rs.rand(k, 3)).astype(np.float32), 5126, "VEC3")
    # samplers: LINEAR translation, STEP rotation, CUBICSPLINE scale, weights
    times = np.float32([0.0, 0.5, 1.25, 2.0])
    a_t = buf.accessor(times, 5126, "SCALAR")
    a_tr = buf.accessor(rs.randn(4, 3).astype(np.float32), 5126, "VEC3")
    rq = rs.randn(4, 4).astype(np.float32)
    a_rot = buf.accessor(rq / np.linalg.norm(rq, axis=1, keepdims=True), 5126, "VEC4")
    a_cs = buf.accessor((1 + 0.1 * rs.randn(12, 3)).astype(np.float32), 5126, "VEC3")
    # images: two in buffer views, two by URI, the BasisU sources in views
    files = {"tex_r8.ktx2": ktx2_bytes(9, 8, 4, [rs.randint(0, 256, 32).astype(np.uint8)
                                                   .tobytes()])}
    images = [{"bufferView": buf.view(rgba_ktx2(rs, 16, 8)), "mimeType": "image/ktx2"},
              {"bufferView": buf.view(rgba_ktx2(rs, 8, 8, True)), "mimeType": "image/ktx2"},
              {"bufferView": buf.view(rgba_ktx2(rs, 4, 4)), "mimeType": "image/ktx2"},
              {"uri": "tex_r8.ktx2"},
              {"uri": "missing.ktx2"}]
    if with_png:
        from PIL import Image

        b = io.BytesIO()
        Image.fromarray(rs.randint(0, 256, (8, 8, 3)).astype(np.uint8)).save(b, format="PNG")
        images.append({"bufferView": buf.view(b.getvalue()), "mimeType": "image/png"})
        b = io.BytesIO()
        Image.fromarray(rs.randint(0, 256, (4, 6, 4)).astype(np.uint8)).save(b, format="PNG")
        files["tex.png"] = b.getvalue()
        images.append({"uri": "tex.png"})
    textures = [{"source": 0}, {"extensions": {"KHR_texture_basisu": {"source": 1}}},
                {"extensions": {"KHR_texture_basisu": {"source": 2}}}, {"source": 3},
                {"source": 4}, {"source": 0}]
    if with_png:
        textures += [{"source": 5}, {"source": 6}]
    materials = [
        {"name": "textured", "pbrMetallicRoughness": {
            "baseColorFactor": [0.9, 0.8, 0.7, 1.0], "metallicFactor": 0.3,
            "roughnessFactor": 0.6, "baseColorTexture": {"index": 0},
            "metallicRoughnessTexture": {"index": 1}},
         "normalTexture": {"index": 2}, "occlusionTexture": {"index": 3},
         "emissiveTexture": {"index": 5}, "emissiveFactor": [0.5, 0.25, 0.1],
         "alphaMode": "MASK", "alphaCutoff": 0.3, "doubleSided": True,
         "extensions": {"KHR_materials_emissive_strength": {"emissiveStrength": 2.5},
                        "KHR_materials_ior": {"ior": 1.33},
                        "KHR_materials_transmission": {"transmissionFactor": 0.4},
                        "KHR_materials_volume": {"attenuationColor": [0.9, 0.5, 0.1],
                                                 "attenuationDistance": 2.0}}},
        {"name": "blend", "alphaMode": "BLEND",
         "pbrMetallicRoughness": {"baseColorFactor": [0.2, 0.4, 0.6, 0.5],
                                  "baseColorTexture": {"index": 4}},
         "extensions": {"KHR_materials_volume": {"attenuationColor": [0.5, 0.5, 0.5]}}},
        {"name": "mask default", "alphaMode": "MASK"},
        {},
    ]
    if with_png:
        materials.append({"name": "png", "pbrMetallicRoughness": {
            "baseColorTexture": {"index": 6}, "metallicRoughnessTexture": {"index": 7}}})
    meshes = [
        {"primitives": [
            {"attributes": {"POSITION": a_pos, "NORMAL": a_nrm, "TEXCOORD_0": a_uv,
                            "TANGENT": a_tan}, "indices": a_idx, "material": 0},
            {"attributes": {"POSITION": a_soup}, "material": 1},
            {"attributes": {"POSITION": a_pos}, "indices": a_idx, "mode": 1}]},
        {"primitives": [{"attributes": {"POSITION": a_skp, "NORMAL": a_skn, "JOINTS_0": a_j,
                                        "WEIGHTS_0": a_w}, "indices": a_ski,
                         "material": 4 if with_png else 2}]},
        {"primitives": [{"attributes": {"POSITION": a_q}, "indices": a_qi, "material": 3}]},
    ]
    m = np.eye(4, dtype=np.float32)
    c, s_ = np.cos(0.3), np.sin(0.3)
    m[:3, :3] = np.float32([[c, 0, s_], [0, 1, 0], [-s_, 0, c]]) * 1.5
    m[:3, 3] = [1.0, 2.0, -0.5]
    nodes = [
        {"name": "root", "translation": [0.1, 0.2, 0.3], "rotation": [0, 0.3826834, 0, 0.9238795],
         "scale": [1, 2, 1], "children": [1, 2]},
        {"name": "grid", "matrix": m.T.reshape(-1).tolist(), "mesh": 0},
        {"name": "skinned", "mesh": 1, "skin": 0, "children": [3]},
        {"name": "joint0", "translation": [0, 1, 0], "children": [4]},
        {"name": "joint1", "rotation": [0.0, 0.0, 0.0998334, 0.9950042]},
        {"name": "instanced", "mesh": 2, "extensions": {"EXT_mesh_gpu_instancing": {
            "attributes": {"TRANSLATION": a_it, "ROTATION": a_ir, "SCALE": a_is}}}},
        {"name": "outside the scene", "mesh": 2},
    ]
    g = {
        "asset": {"version": "2.0"},
        "extensionsUsed": ["KHR_texture_basisu", "IDK_BC5_normal_metallicRoughness",
                           "EXT_mesh_gpu_instancing", "KHR_materials_volume"],
        "scene": 0, "scenes": [{"nodes": [0, 5]}],
        "nodes": nodes, "meshes": meshes, "materials": materials, "textures": textures,
        "images": images, "accessors": buf.accessors, "bufferViews": buf.views,
        "skins": [{"joints": [3, 4], "inverseBindMatrices": a_ibm, "skeleton": 2}],
        "animations": [
            {"name": "walk", "samplers": [
                {"input": a_t, "output": a_tr},
                {"input": a_t, "output": a_rot, "interpolation": "STEP"},
                {"input": a_t, "output": a_cs, "interpolation": "CUBICSPLINE"}],
             "channels": [
                 {"sampler": 0, "target": {"node": 0, "path": "translation"}},
                 {"sampler": 1, "target": {"node": 4, "path": "rotation"}},
                 {"sampler": 2, "target": {"node": 1, "path": "scale"}},
                 {"sampler": 0, "target": {"node": 6, "path": "translation"}}]},
            {"samplers": [{"input": a_t, "output": a_tr}],
             "channels": [{"sampler": 0, "target": {"node": 2, "path": "translation"}}]}],
    }
    return g, bytes(buf.data), files


def write_asset(tmp_path, g, data, files, form):
    """The asset as a .gltf with an external .bin, a .glb, or a .gltf whose
    buffer is a data URI; returns its path."""
    for name, raw in files.items():
        (tmp_path / name).write_bytes(raw)
    g = json.loads(json.dumps(g))
    if form == "glb":
        g["buffers"] = [{"byteLength": len(data)}]
        js = json.dumps(g).encode()
        js += b" " * (-len(js) % 4)
        body = data + bytes(-len(data) % 4)
        out = struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(body))
        out += struct.pack("<II", len(js), 0x4E4F534A) + js
        out += struct.pack("<II", len(body), 0x004E4942) + body
        path = tmp_path / "asset.glb"
        path.write_bytes(out)
        return str(path)
    if form == "gltf":
        (tmp_path / "asset.bin").write_bytes(data)
        g["buffers"] = [{"byteLength": len(data), "uri": "asset.bin"}]
    else:
        uri = "data:application/octet-stream;base64," + base64.b64encode(data).decode()
        g["buffers"] = [{"byteLength": len(data), "uri": uri}]
    path = tmp_path / "asset.gltf"
    path.write_text(json.dumps(g))
    return str(path)


def assert_same(a, b, where="model"):
    """Equal dataclass trees: arrays bit for bit with their dtype, bytes,
    numbers and strings equal."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
        for k in ("source_bytes",):  # set on instances, not a field
            if hasattr(a, k) or hasattr(b, k):
                assert getattr(a, k, None) == getattr(b, k, None), f"{where}.{k}"
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize("form", ["gltf", "glb", "datauri"])
@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("defer", [False, True])
def test_load_gltf_matches_jax(tmp_path, form, optimize, defer):
    g, data, files = scene_json(np.random.RandomState(0))
    path = write_asset(tmp_path, g, data, files, form)
    got = gltf.load_gltf(path, optimize=optimize, defer_textures=defer)
    want = j_gltf.load_gltf(path, optimize=optimize, defer_textures=defer)
    assert_same(got, want)
    # the asset's features arrived
    assert len(got.primitives) == 4 and len(got.skins) == 1 and len(got.animations) == 2
    assert got.nodes[[n.name for n in got.nodes].index("instanced")].instance_transforms.shape \
        == (5, 4, 4)
    layouts = [t.channel_layout for t in got.textures]
    assert "bc5_normal" in layouts and "bc5_mr" in layouts
    if defer:
        assert all(t.data is None for t in got.textures)
        assert sum(t.source_bytes is not None for t in got.textures) == 5
    else:
        assert sum(t.data is not None for t in got.textures) == 5  # the missing file is None
    assert got.materials[1].alpha_cutoff == 0.0 and got.materials[2].alpha_cutoff == 0.5


def test_load_gltf_without_textures_matches_jax(tmp_path):
    g, data, files = scene_json(np.random.RandomState(1))
    path = write_asset(tmp_path, g, data, files, "glb")
    got = gltf.load_gltf(path, load_textures=False)
    assert_same(got, j_gltf.load_gltf(path, load_textures=False))
    assert got.textures == []


def test_load_gltf_png_textures_match_jax(tmp_path):
    pytest.importorskip("PIL")
    g, data, files = scene_json(np.random.RandomState(2), with_png=True)
    path = write_asset(tmp_path, g, data, files, "gltf")
    for defer in (False, True):
        got = gltf.load_gltf(path, defer_textures=defer)
        assert_same(got, j_gltf.load_gltf(path, defer_textures=defer))
    got = gltf.load_gltf(path)
    assert got.textures[6].data.shape == (8, 8, 4) and got.textures[7].data.shape == (4, 6, 4)


@pytest.mark.parametrize("layout", [None, "bc5_normal", "bc5_mr"])
def test_channel_layout_and_texture_decode_match_jax(layout):
    rs = np.random.RandomState(3)
    img = rs.randint(0, 256, (7, 5, 4)).astype(np.uint8)
    assert_same(gltf.apply_channel_layout(img, layout), j_gltf.apply_channel_layout(img, layout))
    raw = rgba_ktx2(rs, 8, 4, True)
    assert_same(gltf.decode_texture_bytes(raw, "ktx2"), j_gltf.decode_texture_bytes(raw, "ktx2"))
    assert gltf.decode_texture_bytes(b"junk", "png") is None
    assert j_gltf.decode_texture_bytes(b"junk", "png") is None


def _prims(rs, nv, nt):
    p = rs.rand(nv, 3).astype(np.float32) * 10
    idx = rs.randint(0, nv, (nt, 3)).astype(np.uint32)
    extra = dict(normals=rs.randn(nv, 3).astype(np.float32), uvs=rs.rand(nv, 2).astype(np.float32),
                 joints=rs.randint(0, 4, (nv, 4)).astype(np.uint16),
                 weights=rs.rand(nv, 4).astype(np.float32),
                 tangents=rs.randn(nv, 4).astype(np.float32))
    return (MeshPrimitive(positions=p.copy(), indices=idx.copy(), material=2, **extra),
            JMeshPrimitive(positions=p.copy(), indices=idx.copy(), material=2,
                           **{k: v.copy() for k, v in extra.items()}))


@pytest.mark.parametrize("nv,nt", [(500, 800), (60, 2), (100, 20)])
def test_meshopt_permutations_match_jax(nv, nt):
    rs = np.random.RandomState(nv)
    a, b = _prims(rs, nv, nt)
    np.testing.assert_array_equal(meshopt.reorder_triangles_morton(a),
                                  j_meshopt.reorder_triangles_morton(b))
    np.testing.assert_array_equal(meshopt.reindex_vertices_first_use(a),
                                  j_meshopt.reindex_vertices_first_use(b))
    assert_same(a, b, "primitive")
    codes = np.random.RandomState(1).randint(0, 1024, (64, 3)).astype(np.uint32)
    np.testing.assert_array_equal(meshopt._morton3(codes), j_meshopt._morton3(codes))
