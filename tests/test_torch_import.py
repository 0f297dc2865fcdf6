"""The port stands apart from the JAX package: importing it loads no jax,
no module of it imports jax or idkengine_tpu, every source it compiles lies
inside it, and its entry points run on the card unless asked otherwise."""
import ast
import glob
import inspect
import os
import re
import subprocess
import sys

import pytest
import torch

import idkengine_tpu_torch
from idkengine_tpu_torch.bvh import builder
from idkengine_tpu_torch.engine import Engine
from idkengine_tpu_torch.ops import packet_trace, two_phase, voxel_scatter
from idkengine_tpu_torch.parallel import dryrun, shard
from idkengine_tpu_torch.render import DeferredPipeline, PathTracer, PathTracerPipeline
from idkengine_tpu_torch.render.shadowmap import PointShadowManager, build_point_shadow
from idkengine_tpu_torch.render.vxgi import VoxelGrid
from idkengine_tpu_torch.scene.scene_db import SceneDatabase
from idkengine_tpu_torch.tools import (_probe, bench_dual, bench_mxu_leaf, bench_prims,
                                       bench_reduce, bench_slab)
from worker_threads import share_cores

share_cores()

PROBES = (bench_slab, bench_mxu_leaf, bench_reduce, bench_dual, bench_prims)

PKG = os.path.dirname(idkengine_tpu_torch.__file__)
REPO = os.path.dirname(PKG)


def test_import_leaves_jax_out():
    code = ("import sys, idkengine_tpu_torch\n"
            "import idkengine_tpu_torch.render, idkengine_tpu_torch.render.tonemap\n"
            "import idkengine_tpu_torch.render.pipeline, idkengine_tpu_torch.render.vxgi\n"
            "import idkengine_tpu_torch.scene.scene_db, idkengine_tpu_torch.ops.packet_trace\n"
            "import idkengine_tpu_torch.ops.voxel_scatter, idkengine_tpu_torch.bvh.builder\n"
            "import idkengine_tpu_torch.ops.two_phase, idkengine_tpu_torch.render.debug_view\n"
            "import idkengine_tpu_torch.render.denoise\n"
            "import idkengine_tpu_torch.tools.bench_slab, idkengine_tpu_torch.tools.bench_mxu_leaf\n"
            "import idkengine_tpu_torch.tools.bench_reduce, idkengine_tpu_torch.tools.bench_dual\n"
            "import idkengine_tpu_torch.tools.bench_prims, idkengine_tpu_torch.collision\n"
            "import idkengine_tpu_torch.render.shadowmap, idkengine_tpu_torch.render.volumetric\n"
            "import idkengine_tpu_torch.render.oit, idkengine_tpu_torch.render.ssr\n"
            "import idkengine_tpu_torch.render.upscale, idkengine_tpu_torch.render.adaptive\n"
            "import idkengine_tpu_torch.render.dynamic, idkengine_tpu_torch.scene.animation\n"
            "import idkengine_tpu_torch.scene.skinning, idkengine_tpu_torch.log\n"
            "import idkengine_tpu_torch.scene.ktx2, idkengine_tpu_torch.scene.basisu\n"
            "import idkengine_tpu_torch.scene.meshopt, idkengine_tpu_torch.scene.gltf\n"
            "import idkengine_tpu_torch.scene.async_io, idkengine_tpu_torch.recorder\n"
            "import idkengine_tpu_torch.profiling, idkengine_tpu_torch.engine\n"
            "import idkengine_tpu_torch.viewer, idkengine_tpu_torch.parallel\n"
            "import idkengine_tpu_torch.parallel.shard, idkengine_tpu_torch.parallel.dryrun\n"
            "import idkengine_tpu_torch.ops.device_sort, idkengine_tpu_torch.utils.sorting\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'idkengine_tpu')]\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=REPO, timeout=120)


def test_chip_smoke_leaves_jax_out():
    code = ("import sys, chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'idkengine_tpu')]\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=REPO, timeout=120)


def test_no_module_imports_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|idkengine_tpu)(\.|\s|$)", re.M)
    offenders = []
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    if pat.search(fh.read()):
                        offenders.append(f)
    assert not offenders


def test_compiled_sources_lie_inside_the_port():
    sources = [builder.BVH_SOURCE, packet_trace.TRACE_SOURCE, packet_trace.TRACE_HEADER,
               two_phase.TWO_PHASE_SOURCE, voxel_scatter.VOXEL_SCATTER_SOURCE,
               _probe.HEADER, *(m.SOURCE for m in PROBES), *glob.glob(os.path.join(PKG, "csrc", "*"))]
    pkg = os.path.realpath(PKG) + os.sep
    for src in sources:
        assert os.path.isfile(src), src
        assert os.path.realpath(src).startswith(pkg), src
    # every kernel source in csrc/ is one that a wrapper builds or includes
    assert sorted(glob.glob(os.path.join(PKG, "csrc", "*"))) == sorted(
        [packet_trace.TRACE_SOURCE, packet_trace.TRACE_HEADER, two_phase.TWO_PHASE_SOURCE,
         voxel_scatter.VOXEL_SCATTER_SOURCE, _probe.HEADER, *(m.SOURCE for m in PROBES)])
    # the five probe sources, one per tool
    assert sorted(os.path.basename(m.SOURCE) for m in PROBES) == [
        "bench_dual.cu", "bench_mxu_leaf.cu", "bench_prims.cu", "bench_reduce.cu", "bench_slab.cu"]


def test_entry_points_default_to_the_card():
    for fn, name in ((SceneDatabase.build, "device"), (PathTracer.__init__, "device"),
                     (DeferredPipeline.__init__, "device"), (VoxelGrid.__init__, "device"),
                     (PathTracerPipeline.__init__, "device"), (build_point_shadow, "device"),
                     (PointShadowManager.__init__, "device"), (Engine.__init__, "device")):
        assert inspect.signature(fn).parameters[name].default == "cuda", fn
    for probe in PROBES:
        assert inspect.signature(probe.main).parameters["device"].default == "cuda", probe
    # the mesh of the sharded tracer and of the dry run: the cards unless asked
    for fn in (shard.make_mesh, dryrun.dryrun_multichip, dryrun.build_small_pt,
               dryrun.build_nontoy_pt):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_default_mesh_takes_no_cpu():
    """make_mesh on a machine without enough cards raises, and so do
    dryrun_multichip and a pipeline sharded on the card through it: nothing
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    for call in (lambda: shard.make_mesh(), lambda: shard.make_mesh(2),
                 lambda: dryrun.dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="CUDA devices"):
            call()


def test_every_module_has_a_counterpart():
    """Each module file of the JAX package has one in the port."""
    jax_pkg = os.path.join(REPO, "idkengine_tpu")
    missing = []
    for root, _dirs, files in os.walk(jax_pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), jax_pkg)
                if not os.path.isfile(os.path.join(PKG, rel)):
                    missing.append(rel)
    assert not missing, missing


# JAX package names the port leaves out by design (ROADMAP §3, "Settled"),
# each with its reason
_TPU_SEGMENTS = ("TPU packet, segment, wave, rebin and VMEM machinery: the port traces one "
                 "whole-scene 4-wide table with a hand CUDA kernel")
_PYTREE = "a JAX pytree method: tensors need no registration"
_NUMPY_FALLBACK = ("the builder's numpy fallback: the port has no fallback, the C++ core runs "
                   "or the call raises")
_STEERED = ("steered two-phase form: tests/test_torch_two_phase_steered.py maps it to the "
            "port's whole-table two_phase_closest / two_phase_any")
LEFT_OUT = {
    **{f"ops/packet_trace.py::{n}": _TPU_SEGMENTS for n in (
        "PacketScene", "PacketTables", "WaveSet", "build_packet_tables",
        "build_packet_tables_segmented", "packet_trace_any", "packet_trace_any_rebin",
        "packet_trace_any_steered", "packet_trace_any_waves", "packet_trace_closest",
        "packet_trace_closest_rebin", "packet_trace_closest_steered",
        "packet_trace_closest_waves", "packet_vmem_estimate", "segment_wave_key")},
    **{f"bvh/builder.py::{n}": _TPU_SEGMENTS for n in (
        "tree_collapse_leaves", "tree_collapse_wide", "tree_segment_roots",
        "tree_subtree_extract")},
    "ops/two_phase.py::phase_a_steered": _TPU_SEGMENTS,
    "scene/scene_db.py::SceneDatabase.wave_set": _TPU_SEGMENTS,
    **{f"ops/trace.py::{c}.{m}": _PYTREE for c in ("SceneArrays", "InstanceSet")
       for m in ("tree_flatten", "tree_unflatten")},
    **{f"bvh/builder.py::{n}": _NUMPY_FALLBACK for n in (
        "compute_global_sah", "intersect_ray_numpy", "intersect_box_numpy",
        "closest_point_on_triangle", "sphere_closest_triangle_numpy")},
    "render/pathtracer.py::tile_swizzle": ("the TPU packets' tile swizzle of the ray order: "
                                           "settled, ROADMAP §3 (the port traces in pixel "
                                           "order)"),
    "ops/two_phase.py::two_phase_closest_steered": _STEERED,
    "ops/two_phase.py::two_phase_any_steered": _STEERED,
}


def _public_names(path: str) -> dict:
    """{name: None for a function or other binding, or the set of names in
    the class body (with its bases' in the same module) for a class} of a
    module's top level, read with ast."""
    tree = ast.parse(open(path).read())
    names, bases = {}, {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names[node.name] = None
        elif isinstance(node, ast.ClassDef):
            body = set()
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    body.add(m.name)
                elif isinstance(m, ast.Assign):
                    body |= {t.id for t in m.targets if isinstance(t, ast.Name)}
                elif isinstance(m, ast.AnnAssign) and isinstance(m.target, ast.Name):
                    body.add(m.target.id)
            names[node.name] = body
            bases[node.name] = [b.id for b in node.bases if isinstance(b, ast.Name)]
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.setdefault(t.id, None)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                names.setdefault((a.asname or a.name).split(".")[0], None)
    for cls, base_names in bases.items():
        for b in base_names:
            if isinstance(names.get(b), set):
                names[cls] |= names[b]
    return names


def _jax_public(path: str):
    """(name, [public method names] or None) of a JAX module's public
    top-level functions and classes."""
    for node in ast.parse(open(path).read()).body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) \
                or node.name.startswith("_"):
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, None
        elif isinstance(node, ast.ClassDef):
            yield node.name, [m.name for m in node.body
                              if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                              and not m.name.startswith("_")]


def test_every_public_name_has_a_counterpart():
    """Each public top-level function and class of every JAX module, and
    each public method of its classes, exists under the same name in the
    port's counterpart module, but for LEFT_OUT (each with its reason).
    Both packages are read with ast; neither is imported."""
    jax_pkg = os.path.join(REPO, "idkengine_tpu")
    missing, left_out = [], set()
    for root, _dirs, files in os.walk(jax_pkg):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, f), jax_pkg)
            port = _public_names(os.path.join(PKG, rel))
            for name, methods in _jax_public(os.path.join(root, f)):
                key = f"{rel}::{name}"
                if key in LEFT_OUT:
                    left_out.add(key)
                    continue
                if name not in port:
                    missing.append(key)
                    continue
                for m in methods or ():
                    if f"{key}.{m}" in LEFT_OUT:
                        left_out.add(f"{key}.{m}")
                    elif m not in (port[name] or ()):
                        missing.append(f"{key}.{m}")
    assert not missing, missing
    # every entry of the list leaves out a name the JAX package has, with a reason
    assert left_out == set(LEFT_OUT), set(LEFT_OUT) - left_out
    assert all(len(reason) > 20 for reason in LEFT_OUT.values())
