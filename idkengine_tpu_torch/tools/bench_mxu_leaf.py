"""Probe P2: a leaf's ray-triangle tests as full Moller-Trumbore per
triangle (`vpu_moller`) or as one bilinear form of 10 ray features and 4T
triangle features (`mxu_form`).
Counterpart: tools/bench_mxu_leaf.py (`kernel_vpu` :92, `kernel_mxu` :129).

    IDK_MXU_R=4096 IDK_MXU_T=32 IDK_MXU_VISITS=256 \\
        python -m idkengine_tpu_torch.tools.bench_mxu_leaf

Both return, for R rays as (R/128, 128) float32 planes over V leaf visits
of T triangles, the tool's output t_best + slot, with `chain["t"]` and
`chain["slot"]` (-1 for a miss) apart. `vpu_moller` reads `leaf9`
(V * nrow9, 128), 14 triangles (p0, e1, e2) a row; `mxu_form` reads
`gfeat` (V, 10, 128). On the card they launch `csrc/bench_mxu_leaf.cu`;
CPU tensors take the plain versions. `make_inputs` builds the tool's
arrays, from its own seed.
"""
from __future__ import annotations

import os
import sys
from functools import partial

import numpy as np
import torch

from . import _probe

R, N_TRI, N_VISITS = 4096, 32, 256  # the tool's default rays, triangles a leaf, leaf visits
TPR = 14  # triangles in one leaf9 row: each triangle's 9 floats stay in one row
ROW_CHOICES = (1, 2, 4, 8, 16, 32, 64)
# float operations per ray and triangle: Moller-Trumbore as the tool writes
# it (cross products 9, det 5, the guarded reciprocal 3, s 3, u 6, q 9, v 6,
# t 6, the checks and the update 13); the form (10-term dot products, 4 of
# them as 40 fused multiply-adds = 80, the sign checks 12, the division and
# the argmin 3)
VPU_OPS, FORM_OPS = 60, 95
# warp instructions a ray and triangle of what each kernel's function needs,
# by class (`needed_cycles_per_step`). vpu_moller: the float operations of
# :108-123 (the cross product d x e2 9, det 5, s 3, u 6, q 9, v 6, t 6,
# u + v 1) and the reciprocal of det (MUFU.RCP and 4 float instructions of
# its IEEE refinement); on the ALU pipe |det| > 1e-12 and its select, the
# six tests and their conjunction (2), the division's range check, the
# update's two selects. mxu_form: four 10-term dot products (one multiply,
# nine fused multiply-adds each), udet + vdet, t = tdet / det as above; on
# the ALU pipe six tests, their four equalities with det > 0 and the
# conjunction (3), the range check, the select of t, the argmin's compare
# and two selects.
RAY_TRI_NEEDED = {"vpu_moller": {"fp32": 45 + 4, "mufu": 1, "alu": 2 + 6 + 2 + 1 + 2},
                  "mxu_form": {"fp32": 40 + 1 + 4, "mufu": 1, "alu": 6 + 3 + 1 + 1 + 3}}
# a warp's loads of one triangle from shared memory, 16 bytes at a time:
# vpu_moller's 9 floats (36 bytes: 3 loads); mxu_form's 40 features, read 4
# adjacent triangles at a time (10 loads a triangle)
TRI_LOADS_NEEDED = {"vpu_moller": 3, "mxu_form": 10}
MISS_T = 1e30  # t_best of a ray that hits nothing
# a kernel's t against its plain version's where their slots agree:
# vpu_moller repeats the plain version's roundings; mxu_form's FFMA rounds
# each of the 10 terms once where the plain version rounds twice, an error
# of a few ulp of the terms (of order 1), which the division by det carries
# into t as an absolute error, so small t are held absolutely
T_TOL = {"vpu_moller": dict(rtol=1e-6, atol=0.0), "mxu_form": dict(rtol=1e-5, atol=1e-5)}

_LIB = _probe.Library("bench_mxu_leaf", {"idk_mxu_vpu": (11, 3), "idk_mxu_form": (11, 3)})
build_kernels = _LIB.build
SOURCE = _LIB.source


def nrow9(n_tri: int) -> int:
    return (n_tri + TPR - 1) // TPR


def make_inputs(device, r: int = R, n_tri: int = N_TRI, n_visits: int = N_VISITS,
                seed: int = 0) -> dict:
    """The tool's arrays (bench_mxu_leaf.py:54-90, from default_rng(seed)):
    `leaf9`, `gfeat` and the ray planes `ox`..`dz`."""
    rng = np.random.default_rng(seed)
    o_np = rng.uniform(-1, 1, (r, 3)).astype(np.float32)
    d_np = rng.standard_normal((r, 3)).astype(np.float32)
    d_np /= np.linalg.norm(d_np, axis=-1, keepdims=True)
    p0 = rng.uniform(-1, 1, (n_visits, n_tri, 3)).astype(np.float32)
    e1 = rng.uniform(-0.5, 0.5, (n_visits, n_tri, 3)).astype(np.float32)
    e2 = rng.uniform(-0.5, 0.5, (n_visits, n_tri, 3)).astype(np.float32)
    nr = nrow9(n_tri)
    leaf9 = np.zeros((n_visits * nr, 128), np.float32)
    tri = np.concatenate([p0, e1, e2], axis=-1)
    for k in range(nr):
        sub = tri[:, k * TPR:(k + 1) * TPR].reshape(n_visits, -1)
        leaf9[k::nr, :sub.shape[1]] = sub
    n = np.cross(e1, e2)
    t = n_tri
    g = np.zeros((n_visits, 10, 4 * t), np.float32)
    g[:, 0:3, 0:t] = -np.swapaxes(n, 1, 2)
    g[:, 0:3, t:2 * t] = -np.swapaxes(np.cross(e2, p0), 1, 2)
    g[:, 6:9, t:2 * t] = np.swapaxes(e2, 1, 2)
    g[:, 0:3, 2 * t:3 * t] = -np.swapaxes(np.cross(p0, e1), 1, 2)
    g[:, 6:9, 2 * t:3 * t] = -np.swapaxes(e1, 1, 2)
    g[:, 3:6, 3 * t:4 * t] = np.swapaxes(n, 1, 2)
    g[:, 9, 3 * t:4 * t] = -np.sum(p0 * n, axis=-1)
    gfeat = np.zeros((n_visits, 10, 128), np.float32)
    gfeat[:, :, :4 * t] = g
    rows = r // 128
    arrays = dict(leaf9=leaf9, gfeat=gfeat,
                  **{k: o_np[:, i].reshape(rows, 128) for i, k in enumerate(("ox", "oy", "oz"))},
                  **{k: d_np[:, i].reshape(rows, 128) for i, k in enumerate(("dx", "dy", "dz"))})
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(device) for k, a in arrays.items()}


def _closest(t_best, slot, tt, vi, n_tri):
    """One visit's per-ray argmin over its T triangles (lowest triangle
    among equal minima), taken where strictly below t_best."""
    tmin, kmin = tt.min(1)
    better = tmin < t_best
    return torch.where(better, tmin, t_best), torch.where(better, vi * n_tri + kmin, slot)


def _result(t_best, slot, shape):
    t_best, slot = t_best.reshape(shape), slot.reshape(shape).to(torch.int32)
    return _probe.ProbeOut(t_best + slot.to(torch.float32), {"t": t_best, "slot": slot}, None)


def vpu_moller_plain(leaf9, ox, oy, oz, dx, dy, dz, n_tri: int, n_visits: int) -> _probe.ProbeOut:
    """The plain vpu_moller: each visit's T triangles at once, the tests in
    the tool's operation order. A sequential strict `tt < t_best` over the
    triangles keeps the first of equal minima, as the argmin here does."""
    dev = ox.device
    kk = torch.arange(n_tri, device=dev)
    rows = torch.arange(n_visits, device=dev)[:, None] * nrow9(n_tri) + kk // TPR
    cols = ((kk % TPR) * 9)[:, None] + torch.arange(9, device=dev)
    tri = leaf9[rows[..., None], cols]  # (V, T, 9)
    q = [a.reshape(-1, 1) for a in (ox, oy, oz, dx, dy, dz)]
    qox, qoy, qoz, qdx, qdy, qdz = q
    t_best = torch.full((q[0].shape[0],), MISS_T, dtype=torch.float32, device=dev)
    slot = torch.full_like(t_best, -1, dtype=torch.int64)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for vi in range(n_visits):
        p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = tri[vi].unbind(1)
        pvx = qdy * e2z - qdz * e2y
        pvy = qdz * e2x - qdx * e2z
        pvz = qdx * e2y - qdy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, zero)
        sx, sy, sz = qox - p0x, qoy - p0y, qoz - p0z
        uu = (sx * pvx + sy * pvy + sz * pvz) * inv_det
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        vv = (qdx * qx + qdy * qy + qdz * qz) * inv_det
        tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ok = (uu >= 0.0) & (uu <= 1.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > 0.0)
        t_best, slot = _closest(t_best, slot, torch.where(ok, tt, torch.inf), vi, n_tri)
    return _result(t_best, slot, ox.shape)


def mxu_form_plain(gfeat, ox, oy, oz, dx, dy, dz, n_tri: int, n_visits: int) -> _probe.ProbeOut:
    """The plain mxu_form: the 10-term dot products as multiplies and adds
    in feature order, then the tool's sign checks and argmin."""
    dev = ox.device
    qox, qoy, qoz, qdx, qdy, qdz = (a.reshape(-1) for a in (ox, oy, oz, dx, dy, dz))
    feats = [qdx, qdy, qdz, qox, qoy, qoz, qoy * qdz - qoz * qdy, qoz * qdx - qox * qdz,
             qox * qdy - qoy * qdx, torch.ones_like(qox)]
    t_best = torch.full_like(qox, MISS_T)
    slot = torch.full_like(qox, -1, dtype=torch.int64)
    one = torch.ones((), dtype=torch.float32, device=dev)
    t = n_tri
    for vi in range(n_visits):
        g = gfeat[vi, :, :4 * t]
        out = feats[0][:, None] * g[0]
        for j in range(1, 10):
            out = out + feats[j][:, None] * g[j]
        det, udet, vdet, tdet = out[:, :t], out[:, t:2 * t], out[:, 2 * t:3 * t], out[:, 3 * t:]
        pos = det > 0.0
        ok = (((udet > 0.0) == pos) & ((vdet > 0.0) == pos) & ((udet + vdet < det) == pos)
              & ((tdet > 0.0) == pos) & (det.abs() > 1e-12))
        tt = torch.where(ok, tdet / torch.where(ok, det, one), MISS_T)
        t_best, slot = _closest(t_best, slot, tt, vi, n_tri)
    return _result(t_best, slot, ox.shape)


def _check(what, table, table_shape, rays, n_tri, n_visits):
    rows = rays[0].shape[0] if rays[0].dim() == 2 else -1
    if rows not in ROW_CHOICES:
        raise ValueError(f"{what}: ray planes must be (rows, 128) with rows in {ROW_CHOICES}, "
                         f"got {tuple(rays[0].shape)}")
    if not 1 <= n_tri <= 32 or n_visits < 1:
        raise ValueError(f"{what}: need 1 <= n_tri <= 32 and n_visits >= 1, "
                         f"got {n_tri} and {n_visits}")
    plane = ((rows, 128), torch.float32)
    return _probe.check(what, table=(table, table_shape, torch.float32),
                        **{k: (a, *plane) for k, a in zip(("ox", "oy", "oz", "dx", "dy", "dz"),
                                                          rays)}), rows


def _launch(fn, table, rays, rows, n_tri, n_visits):
    out = torch.empty_like(rays[0])
    t = torch.empty_like(rays[0])
    slot = torch.empty(rays[0].shape, dtype=torch.int32, device=out.device)
    cycles = torch.zeros(1, dtype=torch.int64, device=out.device)
    _LIB(fn, [table, *rays, out, t, slot, cycles], [rows, n_tri, n_visits])
    return _probe.ProbeOut(out, {"t": t, "slot": slot}, cycles)


def vpu_moller(leaf9, ox, oy, oz, dx, dy, dz, n_tri: int, n_visits: int) -> _probe.ProbeOut:
    """P2's vector kernel: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    rays = (ox, oy, oz, dx, dy, dz)
    dev, rows = _check("vpu_moller", leaf9, (n_visits * nrow9(n_tri), 128), rays, n_tri, n_visits)
    if dev.type == "cpu":
        return vpu_moller_plain(leaf9, *rays, n_tri, n_visits)
    res = _launch("idk_mxu_vpu", leaf9, rays, rows, n_tri, n_visits)
    vpu_moller.launches += 1
    return res


def mxu_form(gfeat, ox, oy, oz, dx, dy, dz, n_tri: int, n_visits: int) -> _probe.ProbeOut:
    """P2's bilinear-form kernel: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    rays = (ox, oy, oz, dx, dy, dz)
    dev, rows = _check("mxu_form", gfeat, (n_visits, 10, 128), rays, n_tri, n_visits)
    if dev.type == "cpu":
        return mxu_form_plain(gfeat, *rays, n_tri, n_visits)
    res = _launch("idk_mxu_form", gfeat, rays, rows, n_tri, n_visits)
    mxu_form.launches += 1
    return res


# launch counts: each wrapper adds one where it launches its kernel
vpu_moller.launches = 0
mxu_form.launches = 0


def reset_launch_counts():
    vpu_moller.launches = 0
    mxu_form.launches = 0


def agreement(a: torch.Tensor, b: torch.Tensor) -> float:
    """The tool's cross-check (:220-224): the share of rays whose outputs
    are close at rtol 1e-3, atol 1e-2."""
    return float(np.isclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-3, atol=1e-2).mean())


def bound(kind: str, r: int = R, n_tri: int = N_TRI, n_visits: int = N_VISITS) -> dict:
    """`_probe.bound` of one launch: the table and the six ray planes read
    once, out, t and slot written once."""
    table = n_visits * nrow9(n_tri) * 128 if kind == "vpu_moller" else n_visits * 10 * 128
    ops = (VPU_OPS if kind == "vpu_moller" else FORM_OPS) * r * n_tri * n_visits
    return _probe.bound(ops, table * 4 + 6 * r * 4 + 3 * r * 4 + 8)


def needed_cycles_per_step(kind: str, r: int = R, n_tri: int = N_TRI) -> tuple[float, str]:
    """(cycles, pipe): the one-SM bound of one triangle visit (one triangle
    against every ray, the tool's unit) of `kind` (a label of `variants()`)
    from the instructions the kind's
    function needs (`RAY_TRI_NEEDED` for each of a thread's rays,
    `TRI_LOADS_NEEDED` a warp; `_probe.needed_cycles`, compute capability
    9.0's rates), for the kernel's CTA at r rays. mxu_form's per-visit merge
    of the argmin into t_best (a compare and two selects a ray) is spread
    over the visit's n_tri triangles. Left out: the staging of the tables
    into shared memory (once per 16 or 8 visits), loop counters and
    addresses."""
    if kind not in RAY_TRI_NEEDED:
        raise ValueError(f"kind must be vpu_moller or mxu_form, got {kind!r}")
    rows = r // 128
    lpt = rows // 8 if rows > 8 else 1
    parts = [(RAY_TRI_NEEDED[kind], lpt), ({"shared": TRI_LOADS_NEEDED[kind]}, 1)]
    if kind == "mxu_form":
        parts.append(({"alu": 3}, lpt / n_tri))
    return _probe.needed_cycles(_probe.merge(*parts), warps=rows * 128 // lpt // 32)


def variants(device, r: int = R, n_tri: int = N_TRI, n_visits: int = N_VISITS) -> dict:
    """kind -> `_probe.Variant`: vpu_moller and mxu_form on
    `make_inputs(device, r, n_tri, n_visits)`."""
    x = make_inputs(device, r, n_tri, n_visits)
    rays = [x[k] for k in ("ox", "oy", "oz", "dx", "dy", "dz")]
    return {kind: _probe.Variant(partial(fn, x[table], *rays, n_tri, n_visits),
                                 partial(plain, x[table], *rays, n_tri, n_visits),
                                 bound(kind, r, n_tri, n_visits), n_tri * n_visits)
            for kind, fn, plain, table in (("vpu_moller", vpu_moller, vpu_moller_plain, "leaf9"),
                                           ("mxu_form", mxu_form, mxu_form_plain, "gfeat"))}


def variants_at(device, steps: int | None = None) -> dict:
    """Both kernels at `steps` leaf visits (the tool's size where None)."""
    return variants(device, n_visits=steps or N_VISITS)


def main(argv=None, device="cuda") -> dict:
    """Both kernels at IDK_MXU_R rays (default 4096), IDK_MXU_T triangles
    a leaf (32) and IDK_MXU_VISITS visits (256), IDK_BENCH_REPS launches
    timed (20): time and cycles per triangle visit on the card, then the
    two kernels' agreement (on the CPU the plain versions run and nothing
    is timed)."""
    del argv  # the tool reads its sizes from the environment
    r = int(os.environ.get("IDK_MXU_R", R))
    n_tri = int(os.environ.get("IDK_MXU_T", N_TRI))
    n_visits = int(os.environ.get("IDK_MXU_VISITS", N_VISITS))
    reps = int(os.environ.get("IDK_BENCH_REPS", 20))
    if r % 128 or not n_tri <= 32:
        raise ValueError(f"IDK_MXU_R must be a multiple of 128 and IDK_MXU_T at most 32, "
                         f"got {r} and {n_tri}")
    results = _probe.run_variants(device, variants(device, r, n_tri, n_visits), reps,
                                  unit="tri-visit")
    a, b = (v["result"].out for v in results.values())
    share = agreement(a, b)
    print(f"agreement at R={r} T={n_tri} V={n_visits}: {share:.4f} (the form's rounding "
          f"differs on edge-grazing pairs)", flush=True)
    results["agreement"] = share
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
