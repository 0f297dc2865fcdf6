"""The Hopper probes' plain versions (idkengine_tpu_torch/tools/) against
the TPU microbenchmarks' own Pallas kernels (tools/bench_*.py, P1-P6), run
in interpret mode on the CPU.

The tools are not edited: while a tool's main() (or extra()) runs, a
stand-in for `pl.pallas_call` records each kernel body and its keyword
arguments and returns zeros (for bench_mxu_leaf, whose main cannot finish
without a TPU profile, the two bodies come from main's frame at the first
call). Each test then runs a recorded kernel with interpret=True on its
own seeded inputs, at the tool's sizes and iteration counts, and holds the
port's plain version to it:
  - int32 outputs (P3) equal;
  - float outputs of P1, P3-P6 bit-equal: the kernels do elementwise float
    multiplies and adds in the tool's order, so no rounding differs;
  - P2 vpu_moller: the same slots where either hits, t within 1e-6 of the
    JAX kernel's (XLA may round one product differently: 1 ulp seen);
  - P2 mxu_form: the outputs within rtol 1e-5, tighter than the tool's own
    rtol 1e-3, atol 1e-2 (XLA's dot sums in another order; 2e-7 seen).
P1's output is 1e30 everywhere (its 1e-9 steps vanish), so its chain (the
stack, the last step's sums, the last 64 steps' masks) is also held to a
numpy rendering of the slab test of tools/bench_slab.py:45-70 written here.
"""
import contextlib
import importlib.util
import inspect
import os
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from idkengine_tpu_torch.tools import (bench_dual, bench_mxu_leaf, bench_prims, bench_reduce,
                                       bench_slab)
from worker_threads import share_cores

share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PALLAS_CALL = pl.pallas_call
SLAB_ROWS = 8
SLAB_ITERS = 4096  # the tool's default
SLAB_CHAIN_ITERS = 192  # every table row at both offsets, three times
MXU_SIZES = dict(IDK_MXU_R="256", IDK_MXU_T="32", IDK_MXU_VISITS="8")


@contextlib.contextmanager
def _patched(argv=None, env=None, pallas_call=None):
    """sys.argv, os.environ and pl.pallas_call replaced for the block."""
    saved = sys.argv, dict(os.environ), list(sys.path)
    if argv is not None:
        sys.argv = argv
    os.environ.update(env or {})
    if pallas_call is not None:
        pl.pallas_call = pallas_call
    try:
        yield
    finally:
        pl.pallas_call = PALLAS_CALL
        sys.argv = saved[0]
        os.environ.clear()
        os.environ.update(saved[1])
        sys.path[:] = saved[2]


def _tool(name):
    """tools/<name>.py as a module (importing it may set environment
    variables and sys.path; both are restored)."""
    spec = importlib.util.spec_from_file_location(f"_tpu_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    with _patched():
        spec.loader.exec_module(module)
    return module


def _record(fn, argv):
    """The (kernel, keyword arguments) of every pallas_call that fn makes,
    each answered with zeros of its output shape."""
    calls = []

    def recording(kernel, **kw):
        calls.append((kernel, kw))
        shape = kw["out_shape"]
        return lambda *args: jnp.zeros(shape.shape, shape.dtype)

    with _patched(argv=argv, pallas_call=recording):
        fn()
    return calls


def _interpret(call, *arrays):
    kernel, kw = call
    return np.asarray(PALLAS_CALL(kernel, **kw, interpret=True)(*map(jnp.asarray, arrays)))


@pytest.fixture(scope="module")
def kernels():
    """Each tool's recorded kernels, keyed by the port's variant names."""
    out = {}
    out["reduce"] = dict(zip(bench_reduce.MODES, _record(_tool("bench_reduce").main, ["x"])))
    out["dual"] = dict(zip(bench_dual.KINDS, _record(_tool("bench_dual").main, ["x"])))
    prims = _tool("bench_prims")
    calls = _record(prims.main, ["x"]) + _record(prims.extra, ["x", "16", "extra"])
    out["prims"] = dict(zip(bench_prims.BODIES, calls))
    calls = _record(_tool("bench_slab").main, ["x", str(SLAB_ROWS), str(SLAB_ITERS)])
    out["slab"] = dict(zip([(m, r) for m in bench_slab.MODES for r in bench_slab.REDUCES], calls))
    return out


@pytest.mark.parametrize("mode", bench_reduce.MODES)
def test_reduce_matches_tool(kernels, mode):
    x = bench_reduce.make_inputs("cpu", seed=1)
    want = _interpret(kernels["reduce"][mode], x.numpy())
    got = bench_reduce.reduce_loop(x, mode, bench_reduce.ITERS)
    assert got.out.dtype == torch.int32 and got.cycles is None
    np.testing.assert_array_equal(got.out.numpy(), want)
    # each step fed (bits & 1) * 1e-6 into x; sum4's and the ORs' bit 0 is
    # set every step (x > 0 on some lane)
    assert (got.chain["x"] >= x).all()
    if mode != "sum1":
        assert (got.chain["x"] > x).all()


@pytest.mark.parametrize("kind", list(bench_dual.KINDS))
def test_dual_matches_tool(kernels, kind):
    x = bench_dual.make_inputs("cpu", seed=2)
    tab = np.zeros((64, 128), np.float32)  # the TPU kernels take it and read none of it
    want = _interpret(kernels["dual"][kind], tab, x.numpy())
    got = bench_dual.dual_loop(x, kind, bench_dual.ITERS)
    np.testing.assert_array_equal(got.out.numpy(), want)
    rows = got.chain["rows"].numpy()
    assert rows.shape == (bench_dual.KINDS[kind][0],) and ((rows >= 0) & (rows < 64)).all()


@pytest.mark.parametrize("body", bench_prims.BODIES)
def test_prims_matches_tool(kernels, body):
    tab, x = bench_prims.make_inputs("cpu", seed=3)
    want = _interpret(kernels["prims"][body], tab.numpy(), x.numpy())
    run = bench_prims.prims_extra_loop if body == bench_prims.EXTRA else (
        lambda *a: bench_prims.prims_loop(*a[:2], body, *a[2:]))
    got = run(tab, x, bench_prims.DEFAULT_K, bench_prims.ITERS)
    np.testing.assert_array_equal(got.out.numpy(), want)
    row, smem = int(got.chain["row"][0]), got.chain["smem"].tolist()
    if body in ("e", "a", "b", "a2", "a4"):  # rows step by one (tab > 0.5: a2's s > 0)
        assert row == (1 + bench_prims.ITERS) & 63
    if body == "e":  # 8192 increments along 16 words, each word one more than the last
        assert smem[16:] == [0] * 240 and sum(smem[:16]) > 0
        assert all((smem[(j + 1) & 15] - smem[j & 15]) in (1, -15) for j in range(1, 16))
    else:
        assert smem == [0] * 256


def _np_slab_chain(tab, rays, mode, reduce, iters):
    """A numpy rendering of one P1 launch (tools/bench_slab.py:45-70 for
    each child, :89-134 for the reduce and the pushes), in the mode's type
    (bfloat16 through ml_dtypes). Returns (stack, last sums, masks of the
    last 64 steps)."""
    dt = ml_dtypes.bfloat16 if mode == "bf16" else np.float32
    ox, oy, oz, dx, dy, dz = rays
    ox, oy, oz = ox.astype(dt), oy.astype(dt), oz.astype(dt)
    ix, iy, iz = ((np.float32(1.0) / d).astype(dt) for d in (dx, dy, dz))
    acc = np.full(ox.shape, 1e30, np.float32)
    stack, sums = [1] + [0] * 63, [0, 0, 0, 0]
    masks = np.zeros((64, *ox.shape), np.uint8)
    for i in range(iters):
        row, off = i & 63, (i & 1) * 64
        t_best = acc.astype(dt)
        hs, mets = [], []
        for ch in range(8):
            b = tab[row, off + 8 * ch:off + 8 * ch + 8]
            bx0, by0, bz0, bx1, by1, bz1 = b[:6].astype(dt)
            t0, t1 = (bx0 - ox) * ix, (bx1 - ox) * ix
            tn, tf = np.minimum(t0, t1), np.maximum(t0, t1)
            t0, t1 = (by0 - oy) * iy, (by1 - oy) * iy
            tn, tf = np.maximum(tn, np.minimum(t0, t1)), np.minimum(tf, np.maximum(t0, t1))
            t0, t1 = (bz0 - oz) * iz, (bz1 - oz) * iz
            tn, tf = np.maximum(tn, np.minimum(t0, t1)), np.minimum(tf, np.maximum(t0, t1))
            tn = np.maximum(tn, dt(0.0))
            if mode == "bf16":
                hit = (np.minimum(tf, t_best) - tn).astype(np.float32) >= 0.0
            else:
                hit = (tf >= tn) & (tn <= t_best)
            hs.append(hit.astype(np.int64))
            mets += [int(b[6]), int(b[7])]
        m = sum(h << ch for ch, h in enumerate(hs))
        if i >= iters - 64:
            masks[row] = m
        sp = stack[0]
        if reduce == "none":
            acc = acc + m.astype(np.float32) * np.float32(1e-9)
            if (mets[0] + i) & 1 == 0:
                stack[sp & 63] = mets[1]
            continue
        if reduce == "sum4":
            sums = [int(np.sum(hs[2 * k] + (hs[2 * k + 1] << 16))) for k in range(4)]
        else:
            sums = [int(np.sum(m)), 0, 0, 0]
        acc = acc + np.float32(sums[0] & 1) * np.float32(1e-9)
        for k in range(2):
            if ((sums[k] >> k) + i) & 1 == 0:
                stack[(sp + k) & 63] = mets[k]
    return stack, sums, masks


@pytest.mark.parametrize("mode", bench_slab.MODES)
@pytest.mark.parametrize("reduce", bench_slab.REDUCES)
def test_slab_matches_tool(kernels, mode, reduce):
    args = bench_slab.make_inputs("cpu", SLAB_ROWS, seed=4)
    want = _interpret(kernels["slab"][(mode, reduce)], *(a.numpy() for a in args))
    got = bench_slab.slab_loop(*args, mode, reduce, SLAB_ITERS)
    np.testing.assert_array_equal(got.out.numpy(), want)
    assert (want == np.float32(1e30)).all()  # why the chain is held below

    got = bench_slab.slab_loop(*args, mode, reduce, SLAB_CHAIN_ITERS)
    stack, sums, masks = _np_slab_chain(args[0].numpy(), [a.numpy() for a in args[1:]], mode,
                                        reduce, SLAB_CHAIN_ITERS)
    assert got.chain["stack"].tolist() == stack
    assert got.chain["sums"].tolist() == sums
    np.testing.assert_array_equal(got.chain["masks"].numpy(), masks)
    assert 0 < masks.mean() < 255  # some children hit, some miss


def _mxu_main_frame():
    """bench_mxu_leaf's main() run until its first pallas_call: main's
    locals (the kernel bodies and their inputs) and that call's keywords."""
    class Stop(Exception):
        pass

    found = {}

    def grab(kernel, **kw):
        frame = inspect.currentframe()
        while frame.f_code.co_name != "main":
            frame = frame.f_back
        found.update(frame.f_locals, call_kw=kw)
        raise Stop

    tool = _tool("bench_mxu_leaf")
    with _patched(env=MXU_SIZES, pallas_call=grab), pytest.raises(Stop):
        tool.main()
    return found


@pytest.mark.parametrize("kind", ["vpu_moller", "mxu_form"])
def test_mxu_leaf_matches_tool(kind):
    frame = _mxu_main_frame()
    r, n_tri, n_visits = frame["R"], frame["T"], frame["V"]
    x = bench_mxu_leaf.make_inputs("cpu", r, n_tri, n_visits, seed=0)
    for k in ("leaf9", "gfeat", "ox", "oy", "oz", "dx", "dy", "dz"):  # the tool's own arrays
        np.testing.assert_array_equal(x[k].numpy(), np.asarray(frame[k]))
    rays = [x[k] for k in ("ox", "oy", "oz", "dx", "dy", "dz")]
    table = x["leaf9"] if kind == "vpu_moller" else x["gfeat"]
    body = frame["kernel_vpu"] if kind == "vpu_moller" else frame["kernel_mxu"]
    want = _interpret((body, frame["call_kw"]), table.numpy(), *(a.numpy() for a in rays))
    got = getattr(bench_mxu_leaf, kind)(table, *rays, n_tri, n_visits)
    slot = got.chain["slot"].numpy()
    hit = slot >= 0
    assert 0.05 < hit.mean() < 0.95
    np.testing.assert_array_equal(hit, want < 1e29)
    if kind == "vpu_moller":
        # out = t + slot in float32: t back from the JAX output, up to that add's rounding
        t_want = want.astype(np.float64) - slot
        np.testing.assert_allclose(t_want[hit], got.chain["t"].numpy()[hit], rtol=1e-6,
                                   atol=float(np.spacing(want[hit]).max()))
        np.testing.assert_array_equal(np.rint(t_want - got.chain["t"].numpy())[hit], 0)
    else:
        np.testing.assert_allclose(got.out.numpy(), want, rtol=1e-5, atol=0)


def test_mxu_leaf_kernels_agree_on_cpu():
    """The tool's own cross-check, on the plain versions: the form and the
    full test agree on the rays and the slots."""
    x = bench_mxu_leaf.make_inputs("cpu", 256, 32, 8)
    rays = [x[k] for k in ("ox", "oy", "oz", "dx", "dy", "dz")]
    a = bench_mxu_leaf.vpu_moller(x["leaf9"], *rays, 32, 8)
    b = bench_mxu_leaf.mxu_form(x["gfeat"], *rays, 32, 8)
    assert bench_mxu_leaf.agreement(a.out, b.out) >= 0.99
    assert (a.chain["slot"] == b.chain["slot"]).float().mean() >= 0.99


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor runs the plain version and launches nothing."""
    counts = (bench_reduce.reduce_loop, bench_dual.dual_loop, bench_prims.prims_loop,
              bench_prims.prims_extra_loop, bench_slab.slab_loop, bench_mxu_leaf.vpu_moller,
              bench_mxu_leaf.mxu_form)
    before = [f.launches for f in counts]
    bench_reduce.reduce_loop(bench_reduce.make_inputs("cpu"), "sum1", 3)
    bench_dual.dual_loop(bench_dual.make_inputs("cpu"), "dd2", 3)
    tab, x = bench_prims.make_inputs("cpu")
    bench_prims.prims_loop(tab, x, "d2", 4, 3)
    bench_prims.prims_extra_loop(tab, x, 4, 3)
    bench_slab.slab_loop(*bench_slab.make_inputs("cpu", 1), "bf16", "sum4", 3)
    m = bench_mxu_leaf.make_inputs("cpu", 128, 3, 2)
    rays = [m[k] for k in ("ox", "oy", "oz", "dx", "dy", "dz")]
    bench_mxu_leaf.vpu_moller(m["leaf9"], *rays, 3, 2)
    bench_mxu_leaf.mxu_form(m["gfeat"], *rays, 3, 2)
    assert [f.launches for f in counts] == before


def test_probes_refuse_bad_inputs():
    x = bench_reduce.make_inputs("cpu")
    with pytest.raises(ValueError):
        bench_reduce.reduce_loop(x, "sum2")
    with pytest.raises(TypeError):
        bench_reduce.reduce_loop(x.double(), "sum1")
    with pytest.raises(ValueError):
        bench_reduce.reduce_loop(x, "sum1", 0)
    with pytest.raises(ValueError):
        bench_dual.dual_loop(bench_dual.make_inputs("cpu").t().contiguous().t(), "d1")
    tab, x = bench_prims.make_inputs("cpu")
    with pytest.raises(ValueError):
        bench_prims.prims_loop(tab[:32], x, "a")
    with pytest.raises(ValueError):
        bench_prims.prims_loop(tab, x, "a", 129)
    with pytest.raises(ValueError):
        bench_prims.prims_loop(tab, x, "a4")
    args = bench_slab.make_inputs("cpu", 3)
    with pytest.raises(ValueError):
        bench_slab.slab_loop(*args, "f32", "sum4")
    m = bench_mxu_leaf.make_inputs("cpu", 128, 3, 2)
    rays = [m[k] for k in ("ox", "oy", "oz", "dx", "dy", "dz")]
    with pytest.raises(ValueError):
        bench_mxu_leaf.vpu_moller(m["leaf9"], *rays, 33, 2)
    with pytest.raises(ValueError):
        bench_mxu_leaf.mxu_form(m["gfeat"], *rays, 3, 3)


def test_mains_run_the_plain_versions_on_cpu(capsys):
    res = bench_slab.main(["4", "70"], device="cpu")
    assert len(res) == 6
    with _patched(env=dict(IDK_MXU_R="128", IDK_MXU_T="20", IDK_MXU_VISITS="3")):
        res = bench_mxu_leaf.main(device="cpu")
    assert 0.9 <= res["agreement"] <= 1.0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 9 and all(line.startswith("[cpu, not timed]") for line in lines[:8])


@pytest.mark.parametrize("module,kwargs,labels", [
    (bench_slab, dict(rows=1, iters=3), 6),
    (bench_mxu_leaf, dict(r=128, n_tri=3, n_visits=2), 2),
    (bench_reduce, dict(iters=3), 4),
    (bench_dual, dict(iters=3), 5),
    (bench_prims, dict(iters=3, k=4, extra=True), 7),
], ids=lambda v: getattr(v, "__name__", "").rsplit(".", 1)[-1] or None)
def test_variants_pair_each_wrapper_with_its_plain_version(module, kwargs, labels):
    """`variants()` (what each main and the card checks run): every label's
    wrapper and plain version on the same inputs, with its launch's bound."""
    variants = module.variants("cpu", **kwargs)
    assert len(variants) == labels
    for label, v in variants.items():
        got, want = v.kernel(), v.plain()
        assert torch.equal(got.out, want.out), label
        assert got.chain.keys() == want.chain.keys()
        for k in want.chain:
            assert torch.equal(got.chain[k], want.chain[k]), (label, k)
        assert v.bound["bound_ms"] > 0 and v.bound["bound_by"] in ("bytes", "operations")


# One SM's four schedulers share a CTA's 32 warps, 8 each; a scheduler
# issues one warp instruction a clock and completes a quarter of the SM's
# rate of each class a clock: 1 float add (fp32), 0.5 ALU, 0.25 shuffles.
@pytest.mark.parametrize("module,variant,cycles,pipe", [
    # P1 at 32 rows: 32 slab tests a thread, 13 ALU instructions each (a
    # bf16 pair instruction tests two children)
    (bench_slab, "rows=32 f32 reduce=sum4", 8 * 32 * 13 / 0.5, "alu"),
    (bench_slab, "rows=32 bf16 reduce=none", 8 * 16 * 13 / 0.5, "alu"),
    # P3 sum4: 16 compares and placements, 3 of feedback, 10 for the halves
    # a warp: 8 x 29 ALU instructions at 0.5 a clock
    (bench_reduce, "sum4", 8 * (16 + 3 + 10) / 0.5, "alu"),
    # P3 orroll_max: masks in 4 of 32 warps (16 x 4 / 32), feedback 3, ORs 2
    (bench_reduce, "orroll_max", 8 * (16 * 4 / 32 + 3 + 2) / 0.5, "alu"),
    # P4 d1 and dp1: 5 shuffles a warp, 5 more in one warp of 32
    (bench_dual, bench_dual.LABELS["d1"], 8 * (5 + 5 / 32) / 0.25, "shfl"),
    (bench_dual, bench_dual.LABELS["dp1"], 8 * (5 + 5 / 32) / 0.25, "shfl"),
    # P4 dpd2: two sums in one reduce-scatter (`_probe.cta_sums_needed`):
    # 6 + 5 + 8 fp32, 5 shuffles, 1 store a warp; once 1 + 5 + 5 + 2 + 6
    (bench_dual, bench_dual.LABELS["dpd2"], 8 * (19 + 5 + 1 + 19 / 32), "issue"),
    # P6 a4: 4 16-byte loads, 4 x 4 adds and a multiply on each of 4 lanes,
    # 8 integer instructions: 80 a warp, issued one a clock
    (bench_prims, bench_prims.label("a4", 16), 8 * (4 + (16 + 1) * 4 + 8), "issue"),
    # P2 vpu_moller: 63 instructions a ray on 4 rays a thread, 3 loads a warp
    (bench_mxu_leaf, "vpu_moller", 8 * (4 * (49 + 1 + 13) + 3), "issue"),
], ids=lambda v: v.split()[0] if isinstance(v, str) else None)
def test_needed_bounds_match_hand_counts(module, variant, cycles, pipe):
    got, by = module.needed_cycles_per_step(variant)
    assert got == pytest.approx(cycles, rel=1e-12) and by == pipe


def test_needed_bounds_need_no_library(monkeypatch):
    """Every variant's needed bound comes from counts alone: with no nvcc
    and no way to build, every probe's variants still have one."""
    from idkengine_tpu_torch.ops import _build
    from idkengine_tpu_torch.tools import _probe

    def refuse(*args, **kwargs):
        raise AssertionError("a needed bound tried to build or find nvcc")

    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "find_nvcc", refuse)
    monkeypatch.setattr(_probe, "find_nvcc", refuse)
    monkeypatch.setattr(_probe, "build_shared_library", refuse)
    sizes = {bench_mxu_leaf: dict(r=128, n_tri=2, n_visits=2), bench_prims: dict(extra=True)}
    for module in (bench_slab, bench_mxu_leaf, bench_reduce, bench_dual, bench_prims):
        name = module.__name__.rsplit(".", 1)[-1]
        labels = module.variants("cpu", **sizes.get(module, {}))
        for label in labels:
            cycles, by = module.needed_cycles_per_step(label)
            assert 0 < cycles < 1e5 and by in ("issue", "fp32", "alu", "shfl", "shared",
                                              "memory", "conv", "mufu"), (name, label)


@pytest.mark.parametrize("counter,compared,steps", [
    ("IADD3 R5, R5, 0x2, RZ", "R5", 2),  # the compare reads the counter
    ("IADD3 R5, R5, 0x4, RZ", "R4", 4),  # ... or i + 4 where the counter holds i + 3
], ids=["counter", "offset"])
def test_sass_steps_a_pass(counter, compared, steps):
    """`sass_count.unroll_factor` finds the steps a pass of a step loop makes
    from the add to the counter that the closing branch's compare reads,
    also through a register offset from it (as nvcc emits a loop that
    steps by a group of four)."""
    from idkengine_tpu_torch.tools import sass_count

    instrs = [(0x10, "", "FADD", "FADD R1, R1, R2"),
              (0x20, "", "IADD3", "IADD3 R4, R5.reuse, 0x1, RZ"),
              (0x30, "", "IADD3", counter),
              (0x40, "", "ISETP.GE.AND", f"ISETP.GE.AND P0, PT, {compared}, UR7, PT"),
              (0x50, "@!P0", "BRA", "BRA 0x10")]
    assert sass_count.unroll_factor(instrs, 0x10, 0x50) == steps
