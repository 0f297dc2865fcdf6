"""Animation sampling: keyframe interpolation applied to scene-graph nodes.
Counterpart: idkengine_tpu/scene/animation.py, carried over as numpy code.

Re-expression of the reference's animation update
(ref: ModelManager.UpdateNodeAnimations, ModelManager.cs:514-592):
STEP and LINEAR samplers (slerp for rotations); CUBICSPLINE falls back to
LINEAR over the spline vertices (the reference doesn't support cubic either,
ModelLoader.cs:1458-1563).
"""
from __future__ import annotations

import numpy as np

from ..utils import mathutil as mu
from .model import Animation, AnimationSampler, Model


def sample(sampler: AnimationSampler, t: float) -> np.ndarray:
    """Sample one channel at time t (clamped to the keyframe range)."""
    times = sampler.times
    values = sampler.values
    if sampler.interpolation == "CUBICSPLINE":
        # values are (in_tangent, value, out_tangent) triplets; use values
        values = values.reshape(times.shape[0], 3, -1)[:, 1, :]
    if len(times) == 0:
        raise ValueError("empty animation sampler")
    if t <= times[0]:
        return values[0]
    if t >= times[-1]:
        return values[-1]
    i = int(np.searchsorted(times, t, side="right")) - 1
    if sampler.interpolation == "STEP":
        return values[i]
    t0, t1 = float(times[i]), float(times[i + 1])
    f = (t - t0) / max(t1 - t0, 1e-8)
    v0, v1 = values[i], values[i + 1]
    if v0.shape[-1] == 4:  # rotation quaternion → slerp
        return mu.quat_slerp(v0, v1, f)
    return (v0 * (1.0 - f) + v1 * f).astype(np.float32)


def apply_animation(model: Model, animation: Animation, t: float, loop: bool = True):
    """Write sampled TRS into the model's nodes (host-side, tiny N)."""
    if loop and animation.duration > 0:
        t = t % animation.duration
    for ch in animation.channels:
        node = model.nodes[ch.node]
        v = sample(ch.sampler, t)
        if ch.path == "translation":
            node.translation = np.asarray(v, np.float32).reshape(3)
        elif ch.path == "rotation":
            q = np.asarray(v, np.float32).reshape(4)
            node.rotation = q / max(np.linalg.norm(q), 1e-8)
        elif ch.path == "scale":
            node.scale = np.asarray(v, np.float32).reshape(3)
        # "weights" (morph targets) unsupported — reference also skips them


def update_node_hierarchy(model: Model) -> np.ndarray:
    """Recompute global transforms after animation
    (ref: ModelManager.UpdateNodeHierarchy:482-512)."""
    return model.global_transforms()
