"""Engine: the application-level orchestrator (headless).
Counterpart: idkengine_tpu/engine.py.

Role of the reference's Application + GameWindowBase (ref: Source/
Application.cs + Windowing/GameWindowBase.cs): owns the scene database, the
camera, both render pipelines with a runtime mode switch, fixed-step update
sub-stepping, the frame-state recorder, and entity picking. The reference's
ImGui surface (Gui.cs) is a settings panel; here the same settings are
dataclasses + a JSON config file (SURVEY.md §7 step 10).

The pipelines run on `device`, the card unless the caller asks for the
CPU; the database must have been built there. In path-tracer mode `render`
swaps the database's current scene (after `update_device`) and its
instance set into the tracer when the accumulation is dirty; the tracer
keeps its build-time attribute tables, as the JAX package's does.
`load_config` reads a file of either package's `save_config`: fields that
this package's settings lack are ignored.
"""
from __future__ import annotations

import enum
import json
from dataclasses import asdict, dataclass, field

import numpy as np

from . import collision as collision_mod
from .log import get_logger
from .profiling import pass_scope
from .recorder import StateRecorder
from .render.camera import Camera
from .render.pathtracer import PathTracerSettings
from .render.pipeline import (
    DeferredPipeline,
    DeferredSettings2,
    PathTracerPipeline,
    PtPipelineSettings,
)
from .scene.scene_db import SceneDatabase

log = get_logger(__name__)

MAX_UPDATE_DT = 1.0 / 5.0  # ref: GameWindowBase fixed-step cap (:171-194)
UPDATE_RATE = 60.0


class RenderMode(enum.Enum):
    RASTERIZER = "rasterizer"  # the deferred pipeline (ref mode name kept)
    PATH_TRACER = "path_tracer"


@dataclass
class EngineSettings:
    width: int = 1024
    height: int = 576
    mode: RenderMode = RenderMode.PATH_TRACER
    deferred: DeferredSettings2 = field(default_factory=DeferredSettings2)
    pt: PathTracerSettings = field(default_factory=PathTracerSettings)
    pt_pipeline: PtPipelineSettings = field(default_factory=PtPipelineSettings)
    camera_collision: bool = True
    light_physics: bool = False


class Engine:
    """Owns everything; drives update/render ticks."""

    def __init__(self, scene_db: SceneDatabase, settings: EngineSettings | None = None,
                 env_map=None, *, device="cuda"):
        self.device = device
        self.db = scene_db
        self.settings = settings or EngineSettings()
        self.camera = Camera()
        self.recorder = StateRecorder()
        self.env_map = env_map
        self.animation_time = 0.0
        self.frame_index = 0
        self._pipelines: dict = {}
        self._accum_dirty = True
        self._last_cam_state = None

    # ------------------------------------------------------------------
    def _pipeline(self):
        mode = self.settings.mode
        if mode not in self._pipelines:
            if mode == RenderMode.PATH_TRACER:
                self._pipelines[mode] = PathTracerPipeline(
                    self.db, self.settings.width, self.settings.height,
                    self.settings.pt, self.settings.pt_pipeline, env_map=self.env_map,
                    device=self.device,
                )
            else:
                self._pipelines[mode] = DeferredPipeline(
                    self.db, self.settings.width, self.settings.height,
                    self.settings.deferred, device=self.device,
                )
        return self._pipelines[mode]

    def set_mode(self, mode: RenderMode):
        """Runtime Rasterizer↔PathTracer switch (ref: Application mode request)."""
        self.settings.mode = mode

    def set_option(self, path: str, value):
        """Live settings toggle — the reference Gui's role (Gui.cs exposes
        every settings knob with accumulation-reset semantics). `path` is a
        dotted path into the EngineSettings tree ('deferred.use_taa',
        'pt_pipeline.output', 'pt.ray_depth'); returns the previous value.
        The affected pipeline is rebuilt lazily on the next frame (scene/
        BVH state is untouched), matching the reference's reset-on-change."""
        import dataclasses

        parts = path.split(".")
        chain = [self.settings]
        for p in parts[:-1]:
            chain.append(getattr(chain[-1], p))
        leaf = chain[-1]
        if not hasattr(leaf, parts[-1]):
            raise AttributeError(f"no setting {path!r}")
        prev = getattr(leaf, parts[-1])
        try:
            setattr(leaf, parts[-1], value)
        except dataclasses.FrozenInstanceError:
            # frozen leaves (e.g. PathTracerSettings doubles as a jit key):
            # rebuild the frozen node and re-attach it to its parent
            new_leaf = dataclasses.replace(leaf, **{parts[-1]: value})
            setattr(chain[-2], parts[-2] if len(parts) > 1 else path,
                    new_leaf)
        root = parts[0]
        if root == "deferred":
            self._pipelines.pop(RenderMode.RASTERIZER, None)
        if root in ("pt", "pt_pipeline"):
            self._pipelines.pop(RenderMode.PATH_TRACER, None)
        if root == "mode":
            pass  # plain field, no pipeline invalidation needed
        self._accum_dirty = True
        log.info("set %s: %s -> %s", path, prev, value)
        return prev

    def toggle_option(self, path: str) -> bool:
        """Flip a boolean setting; returns the NEW value."""
        parts = path.split(".")
        obj = self.settings
        for p in parts[:-1]:
            obj = getattr(obj, p)
        cur = getattr(obj, parts[-1])
        self.set_option(path, not cur)
        return not cur

    def add_model_runtime(self, model, transform=None) -> int:
        """Drop a model into the running scene (ref: OnFilesDrop →
        Gui.AddModelDialog → ModelManager.Add): only the new model's BLAS
        is built; pipelines rebuild their bindings on the next frame (the
        reference recreates its SSBOs + resets accumulation the same way)."""
        inst = self.db.add_model_runtime(model, transform)
        self._pipelines.clear()
        self._accum_dirty = True
        return inst

    # ------------------------------------------------------------------
    def update(self, dt: float, move=np.zeros(3), look=(0.0, 0.0)):
        """Fixed-step update with sub-stepping (ref: GameWindowBase loop +
        Application.OnUpdate): input → camera physics → collision → light
        physics → scene animation."""
        dt = min(dt, MAX_UPDATE_DT)
        steps = max(int(np.ceil(dt * UPDATE_RATE)), 1)
        sub = dt / steps
        for _ in range(steps):
            self.camera.process_inputs(np.asarray(move, np.float32), sub, look)
            look = (0.0, 0.0)
            if self.settings.camera_collision and self.db.blas is not None:
                collision_mod.camera_collision(self.db, self.camera, sub)
            else:
                self.camera.position = self.camera.position + self.camera.velocity * sub
            self.camera.advance_simulation(sub)
            if self.settings.light_physics:
                collision_mod.light_collisions(self.db, self.db.lights, sub)
        self.animation_time += dt
        if any(m.animations for m in self.db.models):
            # device-side refit by default (render/dynamic.py — no geometry
            # readback); IDK_HOST_REFIT=1 forces the C++ host path
            import os as _os

            if _os.environ.get("IDK_HOST_REFIT"):
                self.db.update(self.animation_time)
            else:
                self.db.update_device(self.animation_time)
            self._accum_dirty = True

        # PT accumulation reset on camera movement (ref: Application.cs:209-213)
        cam_state = (tuple(self.camera.position.tolist()), self.camera.yaw, self.camera.pitch)
        if cam_state != self._last_cam_state:
            self._accum_dirty = True
            self._last_cam_state = cam_state

    # ------------------------------------------------------------------
    def render(self):
        """One frame; returns the (H,W,3) float [0,1] tonemapped image, a
        tensor on the engine's device."""
        pipe = self._pipeline()
        if self.settings.mode == RenderMode.PATH_TRACER:
            if self._accum_dirty:
                pipe.reset_accumulation()
                pipe.pt.scene = self.db.device_scene
                pipe.pt.instances = self.db.instance_set()
                self._accum_dirty = False
            out = pipe.render_frame(self.camera)
        else:
            out = pipe.render_frame(self.camera)
        self.frame_index += 1
        return out

    # ------------------------------------------------------------------
    def pick_entity(self, px: float, py: float):
        """CPU ray picking (ref: Gui entity selection via CPU BVH ray) against
        the database's world BLAS: (t, u, v, triangle id) or None."""
        w, h = self.settings.width, self.settings.height
        params = self.camera.ray_params(w, h)
        u = (px + 0.5) / w * 2 - 1
        v = 1 - (py + 0.5) / h * 2
        d = (
            np.asarray(params["forward"])
            + u * np.asarray(params["right"])
            + v * np.asarray(params["up"])
        )
        d = d / np.linalg.norm(d)
        return self.db.intersect_ray(self.camera.position, d.astype(np.float32))

    # ------------------------------------------------------------------
    def run_headless(self, n_frames: int, dt: float = 1.0 / 60.0, on_frame=None):
        """Offline frame loop (the windowless Run()); each iteration runs in
        the span engine/frame (args: the iteration), the path-traced mode's
        pt/frame inside it. Time frames with a profiler (profiling.start_trace)
        or with a synchronize in on_frame: the launches return before the
        card is done."""
        for i in range(n_frames):
            with pass_scope("engine/frame", i):
                self.update(dt)
                img = self.render()
                if on_frame is not None:
                    on_frame(i, img)
        return self.frame_index


def save_config(settings: EngineSettings, path: str):
    """Settings → JSON (the config-file replacement for the reference GUI:
    every widget in Gui.cs maps to a field somewhere in this tree)."""

    def enc(o):
        if isinstance(o, enum.Enum):
            return o.value
        if isinstance(o, tuple):
            return list(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        return str(o)

    with open(path, "w") as f:
        json.dump(asdict(settings), f, indent=2, default=enc)


def _restore_dataclass(obj, raw: dict):
    """Recursively rebuild a (possibly frozen, possibly nested) dataclass
    from its JSON dict, coercing enums/tuples/ndarrays back to the field's
    current type. Unknown keys are ignored (forward compatibility)."""
    import dataclasses

    kwargs = {}
    for f in dataclasses.fields(obj):
        if f.name not in raw:
            continue
        cur = getattr(obj, f.name)
        v = raw[f.name]
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            kwargs[f.name] = _restore_dataclass(cur, v)
        elif isinstance(cur, enum.Enum):
            kwargs[f.name] = type(cur)(v)
        elif isinstance(cur, tuple):
            kwargs[f.name] = tuple(v)
        elif isinstance(cur, np.ndarray):
            kwargs[f.name] = np.asarray(v, cur.dtype)
        elif isinstance(cur, bool):
            kwargs[f.name] = bool(v)
        elif isinstance(cur, (int, float, str)) and not isinstance(v, (dict, list)):
            kwargs[f.name] = type(cur)(v)
        elif cur is None:
            # Optional fields (current value None) can't be type-coerced —
            # assign the raw JSON value so they still round-trip
            kwargs[f.name] = v
    import dataclasses as _dc

    return _dc.replace(obj, **kwargs)


def load_config(path: str) -> EngineSettings:
    """Restore the FULL settings tree (engine + both pipelines + post)."""
    with open(path) as f:
        raw = json.load(f)
    return _restore_dataclass(EngineSettings(), raw)
