"""Asynchronous asset IO: background texture decode + amortized upload.
Counterpart: idkengine_tpu/scene/async_io.py.

Role of the reference's async texture pipeline (ref: ModelLoader.cs
LoadGLTextureAsync :1001-1108 — Task.Run decode -> staging upload on the
main thread — plus Source/MainThreadQueue.cs: a "lazy" queue draining ONE
item per frame to amortize upload stutter, pumped at Application.cs:140).

Design: worker threads decode (the KTX2 and BasisU decoders, or PIL where it
is installed) while the frame loop renders with factor fallbacks; each
finished decode enqueues an atlas-layer refresh that the engine applies one
per frame: one layer written in place on the tracer's atlas, on the
atlas's own device (a new layer grows the atlas).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

from ..log import get_logger

log = get_logger(__name__)


class MainThreadQueue:
    """Two-lane action queue (ref: MainThreadQueue.cs:10-31): `lazy` drains
    one item per pump (amortized uploads), `hasty` drains fully."""

    def __init__(self):
        self._lazy: queue.SimpleQueue = queue.SimpleQueue()
        self._hasty: queue.SimpleQueue = queue.SimpleQueue()

    def add_lazy(self, fn: Callable[[], None]):
        self._lazy.put(fn)

    def add_hasty(self, fn: Callable[[], None]):
        self._hasty.put(fn)

    def pump(self):
        """One frame's drain: all hasty items + at most one lazy item."""
        while True:
            try:
                self._hasty.get_nowait()()
            except queue.Empty:
                break
        try:
            self._lazy.get_nowait()()
        except queue.Empty:
            pass

    def pending(self) -> int:
        return self._lazy.qsize() + self._hasty.qsize()


class AsyncTextureLoader:
    """Decode textures on worker threads; completed decodes enqueue
    main-thread finishers (atlas layer updates)."""

    def __init__(self, main_queue: MainThreadQueue, workers: int = 2):
        self.queue = main_queue
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="idk-tex")
        self._outstanding = 0
        self._lock = threading.Lock()

    def submit(self, decode_fn: Callable[[], object],
               finish_fn: Callable[[object], None]):
        """decode_fn runs on a worker; finish_fn(result) runs on the main
        thread at a later pump (lazy lane)."""
        with self._lock:
            self._outstanding += 1

        def work():
            try:
                result = decode_fn()
            except Exception as e:  # decode failures fall back silently
                log.warning("async texture decode failed: %s", e)
                result = None

            def finish():
                with self._lock:
                    self._outstanding -= 1
                if result is not None:
                    finish_fn(result)

            self.queue.add_lazy(finish)

        self._pool.submit(work)

    @property
    def outstanding(self) -> int:
        with self._lock:
            return self._outstanding

    def wait_all(self, pump: bool = True, timeout: float = 60.0):
        """Drain everything (tests/offline renders)."""
        import time

        t0 = time.time()
        self._pool.shutdown(wait=True)
        self._pool = ThreadPoolExecutor(max_workers=2,
                                        thread_name_prefix="idk-tex")
        while self.outstanding and time.time() - t0 < timeout:
            if pump:
                self.queue.pump()
            else:
                time.sleep(0.01)


def attach_async_textures(db, model, loader: AsyncTextureLoader,
                          mat_offset: int, pt=None):
    """Schedule decodes for a model whose textures were loaded lazily
    (gltf load_gltf(defer_textures=True)). On completion each texture lands
    in the material atlas and, when `pt` (a render.PathTracer) is given, in
    the tracer's device atlas: the layer is written in place, or appended
    where it is new, and the tracer takes the materials' new layer indices
    and the texture paths they turn on from its next frame
    (PathTracer.adopt_texture_layers)."""
    from .gltf import apply_channel_layout, decode_texture_bytes

    for ti, tex in enumerate(model.textures):
        if tex.data is not None or not getattr(tex, "source_bytes", None):
            continue

        def mk(ti=ti, tex=tex):
            def decode():
                # late decodes honor IDK_BC5 channel semantics too
                return apply_channel_layout(
                    decode_texture_bytes(tex.source_bytes, tex.name),
                    getattr(tex, "channel_layout", None))

            def finish(img):
                tex.data = img
                table = db.materials
                layer = table.adopt_texture(model, mat_offset, ti, tex)
                if pt is not None and layer >= 0:
                    pt.adopt_texture_layers(table.atlas_layer, layer, table.layer_arrays())

            return decode, finish

        loader.submit(*mk())
