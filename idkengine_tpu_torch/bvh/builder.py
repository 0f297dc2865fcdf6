"""ctypes wrapper of the native BVH core. Counterpart: idkengine_tpu/bvh/builder.py.

The library is compiled from the port's own copy of the C++ core
(`cpp/bvh.cpp` beside this module, byte for byte the JAX package's
`bvh/cpp/bvh.cpp`) with the flags of that package's Makefile, into the
repository's ignored `build/` directory. There is no numpy fallback builder:
without a C++ compiler the build raises.

A BLAS keeps its native tree for `refit` (the C++ `blas_refit`), for its
quality metric `epo` (the C++ `blas_epo`) and for the
host queries of picking and collision (`intersect_ray`, `intersect_box`,
`sphere_closest_triangle`: the C++ `blas_intersect_ray`,
`blas_intersect_box`, `sphere_vs_triangles`; no numpy versions); `TLAS`
builds the instance tree with the C++ `tlas_build`. `refit_nodes_numpy`
and `tlas_nodes_numpy` are their numpy versions.

Node layout (32 B):
    min[3] f32 | left_or_first u32 | max[3] f32 | count u32
interior: left child index, right = left + 1, count == 0
leaf:     [first, first+count) range into tri_indices (original triangle ids)
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from dataclasses import dataclass

import numpy as np

from ..ops._build import build_shared_library

BVH_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp", "bvh.cpp")
# CXXFLAGS of the JAX package's bvh/cpp/Makefile
CXX_COMMAND = ["g++", "-O3", "-march=native", "-ffast-math", "-std=c++17",
               "-fPIC", "-shared", "-Wall", "-pthread"]

NODE_DTYPE = np.dtype(
    {
        "names": ["min", "left_or_first", "max", "count"],
        "formats": [("<f4", (3,)), "<u4", ("<f4", (3,)), "<u4"],
        "offsets": [0, 12, 16, 28],
        "itemsize": 32,
    }
)

_lib = None


class _BlasView(ctypes.Structure):
    _fields_ = [
        ("nodes", ctypes.c_void_p),
        ("node_count", ctypes.c_uint32),
        ("tri_indices", ctypes.c_void_p),
        ("tri_index_count", ctypes.c_uint32),
        ("parents", ctypes.c_void_p),
        ("max_depth", ctypes.c_uint32),
        ("sah_cost", ctypes.c_float),
        ("build_ms", ctypes.c_double),
    ]


def build_library() -> str:
    """Compile the BVH core if needed; returns the library path."""
    path, _log = build_shared_library("libidk_bvh.so", [BVH_SOURCE], CXX_COMMAND)
    return path


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_library())
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.blas_build.restype = ctypes.c_void_p
    lib.blas_build.argtypes = [
        f32p, ctypes.c_uint32, u32p, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_float, ctypes.c_float,
    ]
    lib.blas_view.restype = None
    lib.blas_view.argtypes = [ctypes.c_void_p, ctypes.POINTER(_BlasView)]
    lib.blas_destroy.restype = None
    lib.blas_destroy.argtypes = [ctypes.c_void_p]
    lib.blas_refit.restype = None
    lib.blas_refit.argtypes = [ctypes.c_void_p, f32p, u32p]
    lib.tlas_build.restype = ctypes.c_void_p
    lib.tlas_build.argtypes = [f32p, ctypes.c_uint32, ctypes.c_uint32]
    lib.blas_intersect_ray.restype = ctypes.c_int
    lib.blas_intersect_ray.argtypes = [ctypes.c_void_p, f32p, u32p, f32p, f32p, ctypes.c_float,
                                       f32p, f32p, f32p, u32p]
    lib.blas_intersect_box.restype = ctypes.c_uint32
    lib.blas_intersect_box.argtypes = [ctypes.c_void_p, f32p, f32p, u32p, ctypes.c_uint32]
    lib.sphere_vs_triangles.restype = ctypes.c_int
    lib.sphere_vs_triangles.argtypes = [f32p, u32p, u32p, ctypes.c_uint32, f32p, ctypes.c_float,
                                        f32p, f32p]
    lib.blas_epo.restype = ctypes.c_float
    lib.blas_epo.argtypes = [ctypes.c_void_p, f32p, u32p, ctypes.c_uint32, ctypes.c_uint32]
    lib.bvh_thread_links.restype = None
    lib.bvh_thread_links.argtypes = [ctypes.c_void_p, ctypes.c_uint32, i64p, i64p]
    lib.bvh_collapse4.restype = ctypes.c_int64
    lib.bvh_collapse4.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_uint32] * 2 + [
        ctypes.c_void_p, i64p, ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return lib


def native_available() -> bool:
    """Whether the C++ core builds and loads here (g++ present). The port
    has no fallback builder: without it a BLAS raises."""
    try:
        _load()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def tree_thread_links(nodes: np.ndarray):
    """(order, subtree_end) of the DFS preorder — see flatten.thread_bvh."""
    lib = _load()
    nodes = np.ascontiguousarray(nodes)
    n = nodes.shape[0]
    order = np.empty(n, np.int64)
    send = np.empty(n, np.int64)
    lib.bvh_thread_links(nodes.ctypes.data, np.uint32(n), _i64p(order), _i64p(send))
    return order, send


def tree_collapse4(node_min, node_max, node_first, node_count, miss_link,
                   leaf_bits: int) -> tuple[np.ndarray, int, np.ndarray]:
    """(records (M,32) int32, depth, (M,4) int64 binary node of each child)
    of the 4-wide collapse, or ValueError where a leaf reference does not
    fit 31 bits — see flatten.bvh4_nodes."""
    lib = _load()
    arrays = [*(np.ascontiguousarray(x, np.float32) for x in (node_min, node_max)),
              *(np.ascontiguousarray(x, np.int32) for x in (node_first, node_count, miss_link))]
    n = arrays[0].shape[0]
    cap = int((arrays[3] == 0).sum()) + 1
    rec = np.empty((cap, 32), np.int32)
    src = np.empty((cap, 4), np.int64)
    depth = ctypes.c_int32()
    m = lib.bvh_collapse4(*(a.ctypes.data for a in arrays), np.uint32(n), np.uint32(leaf_bits),
                          rec.ctypes.data, _i64p(src), ctypes.byref(depth))
    if m < 0:
        raise ValueError(f"the BVH's slot space does not fit a leaf reference: leaves hold at "
                         f"most {1 << leaf_bits} triangles and slots end below "
                         f"{1 << (31 - leaf_bits)}")
    return rec[:m], int(depth.value), src[:m]


@dataclass
class BuildSettings:
    """ref: BLAS.cs BuildSettings:31-48."""

    max_leaf_triangle_count: int = 4
    traversal_cost: float = 1.2
    presplit_factor: float = 0.0  # 0.3 is the reference's tuned default


class BLAS:
    """Bottom-level acceleration structure over one mesh's triangles. Keeps
    the native tree for `refit`; the node arrays are copies of it."""

    def __init__(self, vertices: np.ndarray, indices: np.ndarray,
                 settings: BuildSettings | None = None):
        self.settings = settings or BuildSettings()
        self.vertices = np.ascontiguousarray(vertices, dtype=np.float32).reshape(-1, 3)
        self.indices = np.ascontiguousarray(indices, dtype=np.uint32).reshape(-1, 3)
        lib = _load()
        self._handle = lib.blas_build(
            _f32p(self.vertices), np.uint32(self.vertices.shape[0]),
            _u32p(self.indices), np.uint32(self.indices.shape[0]),
            np.uint32(self.settings.max_leaf_triangle_count),
            np.float32(self.settings.traversal_cost),
            np.float32(self.settings.presplit_factor),
        )
        view = self._sync_from_native()
        self.tri_indices = _copy(view.tri_indices, 4 * view.tri_index_count, np.uint32)
        self.max_depth = int(view.max_depth)
        self.sah_cost = float(view.sah_cost)
        self.build_ms = float(view.build_ms)

    def _sync_from_native(self) -> _BlasView:
        view = _BlasView()
        _load().blas_view(self._handle, ctypes.byref(view))
        self.nodes = _copy(view.nodes, 32 * view.node_count, NODE_DTYPE)
        return view

    def refit(self, vertices: np.ndarray):
        """Bottom-up AABB refit after vertex animation (ref: BLAS.cs:276-293),
        in the C++ core; the topology and `build_ms` stay. `refit_nodes_numpy`
        is its numpy version."""
        self.vertices = np.ascontiguousarray(vertices, dtype=np.float32).reshape(-1, 3)
        _load().blas_refit(self._handle, _f32p(self.vertices), _u32p(self.indices))
        self._sync_from_native()

    def epo(self, max_nodes: int = 8192) -> float:
        """Global EPO quality metric (ref: BLAS.cs ComputeGlobalEPO:536-627,
        Aila et al. 2013): area of geometry overlapping node boxes outside
        their own subtrees, normalized by total triangle area. Exact for
        trees up to max_nodes nodes, a strided estimate above; the C++
        core's `blas_epo` on the host, its worker threads summed in a fixed
        order."""
        return float(_load().blas_epo(
            self._handle, _f32p(self.vertices), _u32p(self.indices),
            np.uint32(self.indices.shape[0]), np.uint32(max_nodes)))

    # -- host queries (picking, collision), in the C++ core ---------------
    def intersect_ray(self, origin, direction, t_max=3.4e38):
        """Closest hit: (t, u, v, triangle id) or None (ref: BLAS.cs:313-386)."""
        origin = np.ascontiguousarray(origin, dtype=np.float32)
        direction = np.ascontiguousarray(direction, dtype=np.float32)
        t, u, v = ctypes.c_float(), ctypes.c_float(), ctypes.c_float()
        tri = ctypes.c_uint32()
        hit = _load().blas_intersect_ray(
            self._handle, _f32p(self.vertices), _u32p(self.indices), _f32p(origin),
            _f32p(direction), np.float32(t_max), ctypes.byref(t), ctypes.byref(u),
            ctypes.byref(v), ctypes.byref(tri))
        if not hit:
            return None
        return (t.value, u.value, v.value, int(tri.value))

    def intersect_box(self, box_min, box_max, cap: int = 65536) -> np.ndarray:
        """Triangle ids in leaves overlapping the AABB, at most `cap` (ref:
        BLAS.cs:388-439)."""
        box_min = np.ascontiguousarray(box_min, dtype=np.float32)
        box_max = np.ascontiguousarray(box_max, dtype=np.float32)
        out = np.empty(cap, dtype=np.uint32)
        n = _load().blas_intersect_box(self._handle, _f32p(box_min), _f32p(box_max), _u32p(out),
                                       np.uint32(cap))
        return out[:n]

    def sphere_closest_triangle(self, candidate_tris, center, radius):
        """The closest point within `radius` of `center` on the candidate
        triangles: (closest point, distance, index into the candidates), or
        None (collision path, ref: Intersections.cs:38-94)."""
        candidate_tris = np.ascontiguousarray(candidate_tris, dtype=np.uint32)
        if not candidate_tris.size:
            return None
        center = np.ascontiguousarray(center, dtype=np.float32)
        closest = np.empty(3, dtype=np.float32)
        dist = ctypes.c_float()
        i = _load().sphere_vs_triangles(
            _f32p(self.vertices), _u32p(self.indices), _u32p(candidate_tris),
            np.uint32(candidate_tris.size), _f32p(center), np.float32(radius), _f32p(closest),
            ctypes.byref(dist))
        if i < 0:
            return None
        return closest, dist.value, int(i)

    def __del__(self):
        if _lib is not None and getattr(self, "_handle", None):
            _lib.blas_destroy(self._handle)
            self._handle = None


class TLAS:
    """Top-level BVH over instance world AABBs via PLOC (ref: Source/Bvh/TLAS.cs),
    in the C++ core; `tlas_nodes_numpy` is a median-split tree of the same
    layout (the JAX package's fallback)."""

    def __init__(self, instance_aabbs: np.ndarray, search_radius: int = 15):
        """instance_aabbs: (N, 6) [min xyz, max xyz]."""
        aabbs = np.ascontiguousarray(instance_aabbs, dtype=np.float32).reshape(-1, 6)
        self.n_instances = aabbs.shape[0]
        lib = _load()
        handle = lib.tlas_build(_f32p(aabbs), np.uint32(aabbs.shape[0]), np.uint32(search_radius))
        try:
            view = _BlasView()
            lib.blas_view(handle, ctypes.byref(view))
            self.nodes = _copy(view.nodes, 32 * view.node_count, NODE_DTYPE)
        finally:
            lib.blas_destroy(handle)


def _copy(ptr, nbytes, dtype):
    if nbytes == 0 or not ptr:
        return np.empty(0, dtype=dtype)
    return np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)), (nbytes,)
    ).view(dtype).copy()


def tlas_nodes_numpy(aabbs: np.ndarray) -> np.ndarray:
    """Median-split TLAS with the NODE_DTYPE layout (the JAX package's
    `_tlas_fallback`): a leaf per instance, `left_or_first` its index."""
    aabbs = np.asarray(aabbs, np.float32).reshape(-1, 6)
    n = aabbs.shape[0]
    if n == 0:
        return np.zeros(1, dtype=NODE_DTYPE)
    cent = 0.5 * (aabbs[:, :3] + aabbs[:, 3:])
    nodes: list = [None]
    work = [(0, np.arange(n, dtype=np.int64))]
    while work:
        ni, ids = work.pop()
        lo = aabbs[ids, :3].min(axis=0)
        hi = aabbs[ids, 3:].max(axis=0)
        if len(ids) == 1:
            nodes[ni] = (lo, int(ids[0]), hi, 1)
            continue
        axis = int(np.argmax(hi - lo))
        ids = ids[np.argsort(cent[ids, axis], kind="stable")]
        mid = len(ids) // 2
        left = len(nodes)
        nodes += [None, None]
        nodes[ni] = (lo, left, hi, 0)
        work.append((left + 1, ids[mid:]))
        work.append((left, ids[:mid]))
    arr = np.zeros(len(nodes), dtype=NODE_DTYPE)
    for i, (lo, lof, hi, cnt) in enumerate(nodes):
        arr[i]["min"], arr[i]["max"] = lo, hi
        arr[i]["left_or_first"], arr[i]["count"] = lof, cnt
    return arr


def refit_nodes_numpy(nodes, tri_indices, vertices, indices):
    """BLAS.refit in numpy, in place on `nodes` (children follow their
    parents, so one sweep from the last node up)."""
    p = vertices[indices]  # (T,3,3)
    tmin, tmax = p.min(axis=1), p.max(axis=1)
    for i in range(nodes.shape[0] - 1, -1, -1):
        c = int(nodes["count"][i])
        lof = int(nodes["left_or_first"][i])
        if c > 0:
            tids = tri_indices[lof:lof + c]
            nodes["min"][i] = tmin[tids].min(axis=0)
            nodes["max"][i] = tmax[tids].max(axis=0)
        else:
            nodes["min"][i] = np.minimum(nodes["min"][lof], nodes["min"][lof + 1])
            nodes["max"][i] = np.maximum(nodes["max"][lof], nodes["max"][lof + 1])
