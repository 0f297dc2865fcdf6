"""The port stands apart from the JAX package: importing it loads no jax,
no module of it imports jax or idkengine_tpu, every source it compiles lies
inside it, and its entry points run on the card unless asked otherwise."""
import glob
import inspect
import os
import re
import subprocess
import sys

import idkengine_tpu_torch
from idkengine_tpu_torch.bvh import builder
from idkengine_tpu_torch.engine import Engine
from idkengine_tpu_torch.ops import packet_trace, two_phase, voxel_scatter
from idkengine_tpu_torch.render import DeferredPipeline, PathTracer, PathTracerPipeline
from idkengine_tpu_torch.render.shadowmap import PointShadowManager, build_point_shadow
from idkengine_tpu_torch.render.vxgi import VoxelGrid
from idkengine_tpu_torch.scene.scene_db import SceneDatabase
from idkengine_tpu_torch.tools import (_probe, bench_dual, bench_mxu_leaf, bench_prims,
                                       bench_reduce, bench_slab)

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
            "import idkengine_tpu_torch.viewer\n"
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
