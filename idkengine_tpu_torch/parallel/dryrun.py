"""The multi-device dry run: one sharded sample of a non-toy scene held to
the single-device sample, then the sharded trace held to the unsharded one.
Counterpart: `dryrun_multichip` and its scenes in the repository's
__graft_entry__.py.

    from idkengine_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(8, device="cpu", small=True)   # eight CPU shards
    dryrun_multichip(mesh=Mesh(("cuda:0",) * 4))     # four shards on one card
"""
from __future__ import annotations

import numpy as np
import torch

from ..bvh.builder import BuildSettings
from ..ops.packet_trace import trace_any, trace_closest
from ..render import Camera, PathTracer, PathTracerSettings
from ..scene.model import Material, MeshPrimitive, Model, Node
from ..scene.procedural import atrium, cornell_box, make_uv_sphere
from ..scene.scene_db import SceneDatabase
from .shard import Mesh, make_mesh, shard_packet_any, shard_packet_closest, shard_render

RMSE_MAX = 1e-5  # the JAX package's bound on sharded against single-device
NONTOY_BUILD = dict(max_leaf_triangle_count=12, traversal_cost=4.0)
PACKET_TRIS = 60_000  # the packet dry run's atrium
PACKET_RAYS_A_SHARD = 8 * 128 * 2  # the JAX dry run's rows x lanes x 2 packets


def build_small_pt(width=64, height=64, device="cuda"):
    """The Cornell box (no emissive quad, one sphere light), depth 3, no
    sky: the compile-check scene of __graft_entry__.py."""
    db = SceneDatabase()
    db.add_model(cornell_box(emissive_quad=False))
    scene = db.build(device)
    db.lights.add([278, 480, 279.5], [6, 6, 6], radius=45.0)
    cam = Camera(position=np.array([278, 273, -800], np.float32), yaw=90.0, fov_y=38.0)
    pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), width, height,
                    PathTracerSettings(ray_depth=3, sky_strength=0.0, use_packet_tracer=False),
                    device=device)
    return pt, cam


def build_nontoy_pt(width=256, height=256, device="cuda"):
    """A 110k-triangle atrium plus two instanced spheres (the two-level
    traces) at 256x256, depth 2: a six-figure ray count a sample."""
    pos, idx = make_uv_sphere([0.0, 0.0, 0.0], 1.2, n_lat=8, n_lon=12)
    prim = MeshPrimitive(positions=pos.astype(np.float32), indices=idx.astype(np.uint32),
                         material=0)
    prim.ensure_normals()
    inst = Model(primitives=[prim], nodes=[Node(mesh_primitives=[0])],
                 materials=[Material(name="inst",
                                     base_color=np.array([0.9, 0.2, 0.2, 1], np.float32))])
    inst.root_nodes.append(0)

    def at(t):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = t
        return m

    db = SceneDatabase(BuildSettings(**NONTOY_BUILD))
    db.add_model(atrium(110_000))
    db.add_instanced_model(inst, np.stack([at([-4.0, 2.0, 6.0]), at([4.0, 3.0, -6.0])]))
    scene = db.build(device)
    db.lights.add([0.0, 8.0, 0.0], [30.0, 30.0, 30.0], radius=0.5)
    cam = Camera(position=np.array([0, 3, 24], np.float32), yaw=-90.0, fov_y=65.0)
    pt = PathTracer(scene, db.materials.soa(), db.lights.soa(), width, height,
                    PathTracerSettings(ray_depth=2, sky_strength=0.4, use_packet_tracer=False),
                    instances=db.instance_set(), inst_attr_srcs=db._inst_attr_srcs,
                    device=device)
    return pt, cam


def packet_rays(scene, n_rays: int, seed: int = 11):
    """Seeded rays from inside the scene's box in random directions, no
    t_max: (o, d, t_max) on the scene's device."""
    rng = np.random.default_rng(seed)
    lo, hi = scene.node_min[0].cpu().numpy(), scene.node_max[0].cpu().numpy()
    o = (lo + rng.random((n_rays, 3)) * (hi - lo)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dev = scene.device
    return (torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
            torch.full((n_rays,), 3.4e38, device=dev))


def check_sharded_traces(mesh: Mesh, scene, o, d, t_max) -> dict:
    """shard_packet_closest and shard_packet_any on one batch against the
    unsharded traces; raises unless t, slot, u, v and occlusion are
    bit-equal (the rays on the scene's device). The any-hit rays end at
    1.5x their closest hit (1e3 on a miss). Returns the counts of hits and
    occluded rays."""
    ref = trace_closest(scene, o, d, t_max)
    hit = shard_packet_closest(mesh, scene)(o, d, t_max)
    for k in ("t", "slot", "u", "v"):
        if not torch.equal(getattr(hit, k).to(o.device), getattr(ref, k)):
            raise AssertionError(f"sharded closest trace: {k} differs from the unsharded trace")
    t_any = torch.where(ref.slot >= 0, ref.t * 1.5, 1e3)
    occ = shard_packet_any(mesh, scene)(o, d, t_any).to(o.device)
    if not torch.equal(occ, trace_any(scene, o, d, t_any)):
        raise AssertionError("sharded any-hit trace: occlusion differs from the unsharded trace")
    return dict(rays=o.shape[0], hits=int((ref.slot >= 0).sum()), occluded=int(occ.sum()))


def dryrun_multichip(n_devices: int | None = None, *, mesh: Mesh | None = None,
                     device="cuda", small: bool = False) -> dict:
    """One sample of the non-toy scene (the Cornell box at 128 x n for
    `small`) sharded over the mesh (make_mesh(n_devices, device=device)
    unless one is given), held to the single-device sample at RMSE <=
    RMSE_MAX; then, unless small, the sharded traces on seeded rays from
    inside a 60k-triangle atrium's box, bit-equal to the unsharded traces.
    Prints one summary line; returns its numbers."""
    mesh = make_mesh(n_devices, device=device) if mesh is None else mesh
    n = len(mesh)
    dev0 = mesh.devices[0]
    pt, cam = build_small_pt(128, n, device=dev0) if small else build_nontoy_pt(device=dev0)
    cam_params = cam.ray_params(pt.width, pt.height)
    radiance, _, _, _, rays = shard_render(mesh, pt)(cam_params, 0)
    if tuple(radiance.shape) != (pt.width * pt.height, 3) or not float(rays) > 0:
        raise AssertionError(f"sharded sample: radiance {tuple(radiance.shape)}, {rays} rays")
    ref = pt._render_sample(cam_params, 0)[0]
    rmse = float(torch.sqrt(torch.mean((radiance - ref) ** 2)))
    differ = int((radiance != ref).any(dim=-1).sum())
    if not rmse <= RMSE_MAX:
        raise AssertionError(f"sharded render diverged: RMSE {rmse}")
    out = dict(devices=[str(d) for d in mesh.devices], rays=float(rays), rmse=rmse,
               pixels_differ=differ, instanced=pt.instances is not None)
    msg = (f"dryrun_multichip OK: {n} shards on {', '.join(sorted(set(out['devices'])))}, "
           f"radiance {tuple(radiance.shape)}, {float(rays):.0f} rays traced (instanced "
           f"two-level path: {out['instanced']}), sharded-vs-single RMSE {rmse:.2e}, "
           f"{differ} pixels differ")
    if not small:
        db = SceneDatabase(BuildSettings(**NONTOY_BUILD))
        db.add_model(atrium(PACKET_TRIS))
        scene = db.build(dev0)
        packet = check_sharded_traces(mesh, scene, *packet_rays(scene, n * PACKET_RAYS_A_SHARD))
        out["packet"] = packet
        msg += (f"; sharded trace kernels OK ({packet['rays']} rays, {packet['hits']} hits, "
                f"{packet['occluded']} occluded, bit-exact)")
    print(msg)
    return out
