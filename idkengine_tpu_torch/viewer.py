"""Interactive viewer: a minimal window + input surface over the Engine.
Counterpart: idkengine_tpu/viewer.py.

Role of the reference's GameWindowBase/Keyboard/Mouse layer (ref:
Source/Windowing/GameWindowBase.cs:167-195 frame loop + Keyboard.cs /
Mouse.cs polled snapshots). The engine itself is headless-first (SURVEY.md
§7 step 10); this shim gives it a window when a display exists: tkinter
canvas presentation, WASD+QE movement, arrow-key look, click picking —
the input surface Application.OnUpdate reads (Application.cs:294-395).

Zero hard GUI dependencies: tkinter ships with CPython; the PhotoImage is
fed PPM bytes directly (no PIL required). Use run_viewer(engine) from any
script; falls back with a clear error when no display is available.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .log import get_logger

log = get_logger(__name__)

_KEY_MOVE = {
    "w": (0, 0, 1), "s": (0, 0, -1), "a": (-1, 0, 0), "d": (1, 0, 0),
    "e": (0, 1, 0), "q": (0, -1, 0),
}
LOOK_SPEED = 2.5  # degrees per frame held


def ppm_bytes(img, scale: int = 1) -> bytes:
    """(H,W,3) float [0,1] image (an array, or a tensor on any device: it is
    read back to the host) -> binary PPM bytes, each pixel repeated `scale`
    times on both axes."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    u8 = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    if scale != 1:
        u8 = u8.repeat(scale, 0).repeat(scale, 1)
    h, w = u8.shape[:2]
    return b"P6 %d %d 255 " % (w, h) + u8.tobytes()


class Viewer:
    """Owns the window + polled input snapshots (Keyboard/Mouse role)."""

    def __init__(self, engine, scale: int = 1, title: str = "idkengine_tpu_torch"):
        import tkinter as tk

        self.engine = engine
        self.scale = scale
        self.root = tk.Tk()
        self.root.title(title)
        w = engine.settings.width * scale
        h = engine.settings.height * scale
        self.canvas = tk.Canvas(self.root, width=w, height=h,
                                highlightthickness=0)
        self.canvas.pack()
        self.photo = tk.PhotoImage(width=w, height=h)
        self.canvas.create_image(0, 0, image=self.photo, anchor="nw")
        self._down: set[str] = set()
        self._look = [0.0, 0.0]
        self.root.bind("<KeyPress>", self._on_press)
        self.root.bind("<KeyRelease>", self._on_release)
        self.canvas.bind("<Button-1>", self._on_click)
        self._running = True
        self.root.protocol("WM_DELETE_WINDOW", self.stop)
        self.picked = None

    # Live settings surface — the reference Gui's toggle role (Gui.cs):
    # number keys flip the active pipeline's passes, m switches the render
    # mode, o cycles the PT output selector, F5/F9 save/load the config.
    # Every toggle goes through Engine.set_option (accumulation reset +
    # lazy pipeline rebuild, like the reference's reset-on-change).
    _TOGGLES = {
        "1": ("deferred.use_taa", "pt_pipeline.use_bloom"),
        "2": ("deferred.use_bloom", "pt_pipeline.adaptive_rate"),
        "3": ("deferred.use_ssao", None),
        "4": ("deferred.use_ssr", None),
        "5": ("deferred.use_vxgi", None),
        "6": ("deferred.use_volumetric", None),
        "7": ("deferred.use_oit", None),
    }
    _PT_OUTPUTS = ("denoised", "noisy", "albedo", "normal")

    def _handle_toggle(self, k: str) -> bool:
        from .engine import RenderMode, load_config, save_config

        eng = self.engine
        is_pt = eng.settings.mode == RenderMode.PATH_TRACER
        if k == "m":
            eng.set_mode(RenderMode.RASTERIZER if is_pt
                         else RenderMode.PATH_TRACER)
            log.info("mode -> %s", eng.settings.mode.value)
            return True
        if k == "o" and is_pt:
            cur = eng.settings.pt_pipeline.output
            nxt = self._PT_OUTPUTS[
                (self._PT_OUTPUTS.index(cur) + 1) % len(self._PT_OUTPUTS)
                if cur in self._PT_OUTPUTS else 0]
            eng.set_option("pt_pipeline.output", nxt)
            return True
        if k == "f5":
            save_config(eng.settings, "viewer_config.json")
            log.info("config saved -> viewer_config.json")
            return True
        if k == "f9":
            try:
                eng.settings = load_config("viewer_config.json")
                eng._pipelines.clear()
                eng._accum_dirty = True
                log.info("config loaded")
            except FileNotFoundError:
                log.warning("no viewer_config.json to load")
            return True
        if k in self._TOGGLES:
            path = self._TOGGLES[k][1 if is_pt else 0]
            if path is not None:
                self.engine.toggle_option(path)
            return True
        return False

    # -- input snapshots (ref: Keyboard.cs/Mouse.cs polled state) ---------
    def _on_press(self, ev):
        k = ev.keysym.lower()
        self._down.add(k)
        if k == "escape":
            self.stop()
            return
        self._handle_toggle(k)

    def _on_release(self, ev):
        self._down.discard(ev.keysym.lower())

    def _on_click(self, ev):
        self.picked = self.engine.pick_entity(ev.x / self.scale,
                                              ev.y / self.scale)
        log.info("picked: %s", self.picked)

    def poll_input(self):
        move = np.zeros(3, np.float32)
        for k in self._down & set(_KEY_MOVE):
            move += np.asarray(_KEY_MOVE[k], np.float32)
        look = (
            LOOK_SPEED * (("right" in self._down) - ("left" in self._down)),
            LOOK_SPEED * (("up" in self._down) - ("down" in self._down)),
        )
        return move, look

    # -- presentation ------------------------------------------------------
    def present(self, img) -> None:
        """(H,W,3) float [0,1] -> window, via PPM bytes (ppm_bytes)."""
        self.photo.configure(data=ppm_bytes(img, self.scale))

    def stop(self):
        self._running = False

    # -- frame loop (ref: GameWindowBase.Run :167-195) --------------------
    def run(self, max_frames: int | None = None):
        last = time.time()
        n = 0
        while self._running:
            now = time.time()
            dt = now - last
            last = now
            move, look = self.poll_input()
            self.engine.update(dt, move=move, look=look)
            img = self.engine.render()
            self.present(img)
            self.root.title(
                f"idkengine_tpu_torch — {dt * 1e3:.0f} ms")
            self.root.update()
            n += 1
            if max_frames is not None and n >= max_frames:
                break
        return n


def run_viewer(engine, scale: int = 1, max_frames: int | None = None) -> int:
    """Open a window over the engine; returns frames presented.

    Raises tkinter.TclError when no display is available (headless boxes
    keep using Engine.run_headless)."""
    v = Viewer(engine, scale=scale)
    try:
        return v.run(max_frames=max_frames)
    finally:
        try:
            v.root.destroy()
        except Exception:
            pass
