"""Data parallelism over the ray axis: a frame's pixels, or a ray batch,
split into contiguous ranges over a list of devices.
Counterpart: idkengine_tpu/parallel/shard.py.

The wavefront ray batch is the big dimension (SURVEY.md §5): each shard
renders or traces its range on its device against a replica of the scene,
BVH, materials and lights, with no communication per bounce; the one
collective is the gather of the outputs onto the mesh's first device
(`torch.cat`). One process drives every device, as the JAX package's
single controller does; a mesh may list a device more than once (the
counterpart of XLA's virtual host devices), and its shards then share one
replica and run one after another. Launches on distinct cards overlap as
far as nothing inside a shard's sample waits for its card.

Sharding does not change the math: every ray is keyed, generated and traced
as in the whole batch, so a sharded frame equals the unsharded one pixel
for pixel where each device computes as the unsharded one's does.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
from dataclasses import dataclass
from functools import partial

import torch
from torch.profiler import record_function

from ..ops.packet_trace import trace_any, trace_closest
from ..ops.trace import Hit


def _device(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh over the ray axis: `devices` in shard order, an
    entry may repeat."""

    devices: tuple
    axis: str = "rays"

    def __post_init__(self):
        devices = tuple(_device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    def __len__(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, axis: str = "rays", device="cuda") -> Mesh:
    """1-D mesh over the ray axis: the first n_devices visible cards (all of
    them for None) with device "cuda", n_devices entries of the CPU (one for
    None) with "cpu". Raises where fewer cards are visible."""
    kind = torch.device(device).type
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices must be at least 1, got {n_devices}")
    if kind == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = count if n_devices is None else n_devices
        if n < 1 or n > count:
            raise RuntimeError(f"need {max(n, 1)} CUDA devices, {count} visible")
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)
    if kind == "cpu":
        return Mesh((torch.device("cpu"),) * (1 if n_devices is None else n_devices), axis)
    raise ValueError(f"no mesh of {device!r} devices")


def _on(dev: torch.device):
    """The launches of a shard go to its card (the CUDA libraries launch on
    the current device)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _move(tree, dev: torch.device, old: dict, new: dict):
    """`tree` with each tensor on `dev`: dicts, lists, tuples (named ones
    too) and dataclasses are walked, other leaves kept. A tensor already
    copied (in `old`, keyed by id, unchanged since: same object and version)
    is not copied again; every copy made or kept lands in `new`."""
    if isinstance(tree, torch.Tensor):
        if tree.device == dev:
            return tree
        key = id(tree)
        hit = new.get(key) or old.get(key)
        if hit is not None and hit[0] is tree and hit[1] == tree._version:
            out = hit[2]
        else:
            out = tree.to(dev)
        new[key] = (tree, tree._version, out)
        return out
    if isinstance(tree, dict):
        return {k: _move(v, dev, old, new) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_move(v, dev, old, new) for v in tree]
    if isinstance(tree, tuple):
        items = [_move(v, dev, old, new) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = copy.copy(tree)
        for f in dataclasses.fields(tree):
            object.__setattr__(out, f.name, _move(getattr(tree, f.name), dev, old, new))
        return out
    return tree


def replicate(mesh: Mesh, tree) -> list:
    """`tree` on every device of the mesh: one entry a mesh position, one
    copy a distinct device (repeated entries share it; the tree itself
    where it already lies there)."""
    copies: dict = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = _move(tree, dev, {}, {})
    return [copies[dev] for dev in mesh.devices]


def shard_ranges(n: int, parts: int) -> list[tuple[int, int]]:
    """Contiguous (start, stop) ranges of n items over at most `parts`
    shards, each at least one item, the first n % parts one longer."""
    parts = max(1, min(parts, n))
    base, extra = divmod(n, parts)
    out, start = [], 0
    for i in range(parts):
        stop = start + base + (i < extra)
        out.append((start, stop))
        start = stop
    return out


def shard_rays(mesh: Mesh, tree) -> list:
    """The tensors of `tree`, all (R, ...), cut into contiguous slices of
    their leading axis, slice i on mesh.devices[i] (at most R shards)."""
    leaves = [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]
    if not leaves:
        raise ValueError("no tensor to shard")
    out = []
    for dev, (a, b) in zip(mesh.devices, shard_ranges(leaves[0].shape[0], len(mesh))):
        part = _map(tree, lambda t, a=a, b=b: t[a:b])
        out.append(_move(part, dev, {}, {}))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_map(v, fn) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return tree


class _Replicas:
    """A path tracer's replicas, one a device: the tracer itself on its own
    device, elsewhere a shallow copy whose DEVICE_STATE lies on that device.
    Made anew from the tracer before each sample, so that a new scene or
    instance set, new settings, set_slot_shading or adopt_texture_layers
    reach every replica; a tensor unchanged since the last sample is not
    copied again."""

    def __init__(self, pt):
        self.pt = pt
        self._copies: dict = {}

    def on(self, devices) -> list:
        made: dict = {}
        for dev in devices:
            if dev not in made:
                made[dev] = self._replica(dev)
        return [made[dev] for dev in devices]

    def _replica(self, dev: torch.device):
        pt = self.pt
        if dev == pt.device:
            return pt
        old, new = self._copies.get(dev, {}), {}
        rep = copy.copy(pt)
        rep.device = dev
        for name in pt.DEVICE_STATE:
            setattr(rep, name, _move(getattr(pt, name), dev, old, new))
        self._copies[dev] = new  # copies of tensors the tracer no longer holds go
        return rep


def shard_render(mesh: Mesh, pt):
    """The sample step of PathTracer `pt` over the mesh:
    fn(cam_params, frame, rate_depth=None) -> (radiance, albedo, normal,
    depth, rays traced), the outputs of pt._render_sample for the whole
    frame in pixel order, gathered on mesh.devices[0]. Shard i renders
    pixel range i of shard_ranges(W*H, len(mesh)) on mesh.devices[i]; its
    time is the profiler range `shard/<i>`, the gather's `shard/gather`."""
    replicas = _Replicas(pt)

    def fn(cam_params, frame, rate_depth=None):
        ranges = shard_ranges(pt.width * pt.height, len(mesh))
        devices = mesh.devices[:len(ranges)]
        outs = []
        for i, (dev, rep, rng) in enumerate(zip(devices, replicas.on(devices), ranges)):
            with _on(dev), record_function(f"shard/{i}"):
                outs.append(rep._render_sample(cam_params, frame, rate_depth, pixels=rng))
        dev0 = mesh.devices[0]
        with record_function("shard/gather"):
            gathered = [torch.cat([o[k].to(dev0) for o in outs]) for k in range(4)]
            rays = sum(o[4].to(dev0) for o in outs)
        return (*gathered, rays)

    return fn


class ShardedPathTracer:
    """A PathTracer whose samples run over a mesh (shard_render).

        pt = PathTracer(...)
        spt = ShardedPathTracer(pt, make_mesh())
        img = spt.render_frame(camera)

    It renders as pt.render_frame does (spp_per_frame samples, the running
    mean and the luminance second moment, env NEE, the bounce budget, tiles,
    the step cap, instances) and accumulates into pt, on pt's device; any
    other attribute is pt's, read and written through the wrapper (the
    pipelines read settings, accumulated_samples, _last_aovs through it, the
    Engine swaps the scene through it)."""

    _OWN = ("pt", "mesh", "_fn")

    def __init__(self, pt, mesh: Mesh):
        object.__setattr__(self, "pt", pt)
        object.__setattr__(self, "mesh", mesh)
        object.__setattr__(self, "_fn", shard_render(mesh, pt))

    def __getattr__(self, name):
        return getattr(self.pt, name)

    def __setattr__(self, name, value):
        if name in self._OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(self.pt, name, value)

    def _sample(self, cam_params, frame, rate_depth=None):
        out = self._fn(cam_params, frame, rate_depth)
        return tuple(x.to(self.pt.device) for x in out)

    def render_frame(self, camera, rate_depth=None) -> torch.Tensor:
        return self.pt._render_frame(self._sample, camera, rate_depth)


# ---------------------------------------------------------------------------
# The trace kernels over the mesh. The JAX package runs its steered Pallas
# trace under shard_map, its segment tables replicated; the port's
# whole-scene kernel replaces the steering (ROADMAP), so each shard runs
# trace_closest / trace_any (the trace kernel on a card, the plain walk on
# the CPU) on its slice of the rays against a replica of the scene, tagged
# spmd as the JAX package tags its sharded launches.
# ---------------------------------------------------------------------------

def _sharded_trace(mesh: Mesh, scene, trace, gather):
    replicas = dict(zip(mesh.devices, replicate(mesh, scene)))

    def fn(o, d, t_max):
        r = o.shape[0]
        t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device).expand(r)
        outs = []
        for dev, (so, sd, st) in zip(mesh.devices, shard_rays(mesh, (o, d, t_max))):
            with _on(dev):
                outs.append(trace(replicas[dev], so.contiguous(), sd.contiguous(),
                                  st.contiguous()))
        return gather(outs, mesh.devices[0])

    return fn


def shard_packet_closest(mesh: Mesh, scene):
    """Closest hits over the mesh: fn(o, d, t_max) -> Hit of the whole
    batch on mesh.devices[0], each shard at least one ray."""
    def gather(outs, dev0):
        return Hit(*(torch.cat([f.to(dev0) for f in fields]) for fields in zip(*outs)))

    return _sharded_trace(mesh, scene, partial(trace_closest, tag="spmd"), gather)


def shard_packet_any(mesh: Mesh, scene):
    """Occlusion over the mesh: fn(o, d, t_max) -> bool (R,) on
    mesh.devices[0]."""
    def gather(outs, dev0):
        return torch.cat([x.to(dev0) for x in outs])

    return _sharded_trace(mesh, scene, partial(trace_any, tag="spmd"), gather)
