"""The import rules: the plain reference loads nothing of the program, and
a run fails on any module of JAX or of the JAX package (top-level names
compared whole: the port's name begins with the JAX package's)."""
import subprocess
import sys
import types

from benchmark import harness

REFERENCE_ALONE = """
import sys, torch
sys.path.insert(0, {root!r})
from benchmark.reference import path_tracer as ref
from benchmark.scenes import atrium
from benchmark.scenes.common import Light
scene = atrium.generate({{"triangles": 5000}}, 1)
scene.lights = [Light((0.0, 10.5, 0.0), (40.0, 38.0, 35.0), 0.8)]
cfg = {{"width": 16, "height": 8, "settings": {{"ray_depth": 2, "russian_roulette": False}}}}
pose = [0.0, 3.0, 23.0, -90.0, 0.0]
out = ref.values(cfg, {{"camera": {{"fov_y": 65.0}}}}, scene, [(pose, 0)],
                 torch.arange(0, 128, 7), "cpu")
assert out.shape == (1, 19, 3) and bool(torch.isfinite(out).all())
tops = {{m.split(".")[0] for m in sys.modules}}
print(sorted(tops & {{"idkengine_tpu_torch", "idkengine_tpu", "jax", "jaxlib", "flax"}}))
"""


def test_reference_loads_nothing_of_the_program():
    p = subprocess.run([sys.executable, "-c", REFERENCE_ALONE.format(root=harness.ROOT)],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_banned_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "idkengine_tpu_torch_fake", types.ModuleType("x"))
    assert "idkengine_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "idkengine_tpu.render", types.ModuleType("x"))
    assert "idkengine_tpu" in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert "jax" in harness.banned_modules()
