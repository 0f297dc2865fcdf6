"""Frame-state recorder: record/replay camera paths, save/load, video dump.
Counterpart: idkengine_tpu/recorder.py (the same little-endian file layout).

Role of the reference's StateRecorder<T> + FrameState
(ref: Source/StateRecorder.cs:28-96, Source/FrameState.cs:8-17,
Application.cs:664-743): binary record/replay of camera + animation time,
frame-exact replay for offline rendering and per-pixel regression oracles.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

MAGIC = b"IDKTPU\x00\x01"


@dataclass
class FrameState:
    """One recorded frame (ref: FrameState.cs — camera + animation time)."""

    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    yaw: float = 0.0
    pitch: float = 0.0
    fov_y: float = 60.0
    animation_time: float = 0.0

    def pack(self) -> bytes:
        return struct.pack(
            "<3f4f", *self.position.tolist(), self.yaw, self.pitch, self.fov_y,
            self.animation_time,
        )

    @staticmethod
    def unpack(data: bytes) -> "FrameState":
        vals = struct.unpack("<3f4f", data)
        return FrameState(
            position=np.asarray(vals[:3], np.float32),
            yaw=vals[3], pitch=vals[4], fov_y=vals[5], animation_time=vals[6],
        )

    SIZE = 28


class StateRecorder:
    """Record/replay of FrameStates (ref: StateRecorder.cs Record/Replay)."""

    def __init__(self):
        self.frames: list[FrameState] = []
        self.replay_index = 0

    # -- record -----------------------------------------------------------
    def record(self, camera, animation_time: float = 0.0):
        self.frames.append(
            FrameState(
                position=np.asarray(camera.position, np.float32).copy(),
                yaw=float(camera.yaw),
                pitch=float(camera.pitch),
                fov_y=float(camera.fov_y),
                animation_time=animation_time,
            )
        )

    # -- replay -----------------------------------------------------------
    def replay(self, camera) -> FrameState | None:
        """Apply the next recorded frame to the camera; None when done."""
        if self.replay_index >= len(self.frames):
            return None
        fs = self.frames[self.replay_index]
        self.replay_index += 1
        camera.position = fs.position.copy()
        camera.yaw = fs.yaw
        camera.pitch = fs.pitch
        camera.fov_y = fs.fov_y
        return fs

    def rewind(self):
        self.replay_index = 0

    # -- io (ref: StateRecorder SaveToFile/Load, .frd files) ---------------
    def save(self, path: str):
        with open(path, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<I", len(self.frames)))
            for fs in self.frames:
                f.write(fs.pack())

    @staticmethod
    def load(path: str) -> "StateRecorder":
        rec = StateRecorder()
        with open(path, "rb") as f:
            assert f.read(8) == MAGIC, "not an idkengine_tpu recording"
            (n,) = struct.unpack("<I", f.read(4))
            for _ in range(n):
                rec.frames.append(FrameState.unpack(f.read(FrameState.SIZE)))
        return rec


def render_replay(recorder: StateRecorder, camera, render_fn, out_dir: str,
                  spp: int = 1, fmt: str = "frame_{:05d}.png"):
    """Offline replay → numbered PNG frames (ffmpeg-ready, the reference's
    video-dump flow at Application.cs:664-743).

    render_fn(camera, frame_state) must return an (H,W,3) uint8 image (an
    array, or a tensor on any device: it is read back to the host). Needs
    Pillow, as the JAX package's does."""
    import os

    import torch
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    recorder.rewind()
    i = 0
    while True:
        fs = recorder.replay(camera)
        if fs is None:
            break
        img = render_fn(camera, fs)
        if isinstance(img, torch.Tensor):
            img = img.detach().cpu().numpy()
        Image.fromarray(np.asarray(img)).save(os.path.join(out_dir, fmt.format(i)))
        i += 1
    return i
