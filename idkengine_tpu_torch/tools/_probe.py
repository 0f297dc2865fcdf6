"""What the probes share: building and calling a probe's CUDA library,
checking tensors before a launch, timing launches, naming the card, and
the reduce order that the kernels and their plain versions both follow."""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Callable, NamedTuple

import torch

from ..ops._build import CSRC_DIR, build_shared_library, find_nvcc

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores (data sheet)
SMS = 132  # streaming multiprocessors of an H100 SXM; each probe runs on one
CTA_THREADS = 1024  # one CTA holds one TPU packet


class ProbeOut(NamedTuple):
    """A probe's result: the TPU tool's output plane, the state of its
    scalar chain (named tensors the plain version also returns), and the
    SM cycles the kernel's loop took (a (1,) int64 tensor; None from the
    plain version)."""
    out: torch.Tensor
    chain: dict
    cycles: torch.Tensor | None


class Variant(NamedTuple):
    """One variant of a probe on inputs made from a seed: `kernel()` calls
    its wrapper (the kernel for CUDA tensors), `plain()` its plain version
    on the same inputs, `bound` is `bound()` of one launch, and `units` the
    units of work a launch does, that its clock64() cycles are counted in
    (steps; bench_mxu_leaf: triangle visits)."""
    kernel: Callable[[], ProbeOut]
    plain: Callable[[], ProbeOut]
    bound: dict
    units: int


def source(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


HEADER = os.path.join(CSRC_DIR, "probe_common.cuh")  # included by every probe source


class Library:
    """A probe's CUDA library, built into build/ and loaded at its first
    call. Every entry point takes device pointers, then ints, then the
    stream, and returns cudaGetLastError(). `path` builds another source
    of the same interface (its probe_common.cuh beside it) into
    build/libidk_<name>.so."""

    def __init__(self, name: str, entry_points: dict[str, tuple[int, int]],
                 path: str | None = None):
        self.name = name
        self.source = path or source(name)
        self.header = os.path.join(os.path.dirname(os.path.abspath(self.source)),
                                   os.path.basename(HEADER))
        self.entry_points = entry_points  # C name -> (pointers, ints)
        self._lib = None

    def build(self) -> tuple[str, str]:
        """Compile the source if needed. Returns (library path, compiler
        output with ptxas register counts; empty when current)."""
        return build_shared_library(f"libidk_{self.name}.so", [self.source],
                                    [find_nvcc(), *NVCC_FLAGS], headers=(self.header,))

    def __call__(self, fn: str, pointers: list[torch.Tensor], ints: list[int]):
        if self._lib is None:
            lib = ctypes.CDLL(self.build()[0])
            for entry, (n_ptr, n_int) in self.entry_points.items():
                f = getattr(lib, entry)
                f.restype = ctypes.c_int
                f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
            self._lib = lib
        stream = torch.cuda.current_stream(pointers[0].device).cuda_stream
        err = getattr(self._lib, fn)(*(ctypes.c_void_p(t.data_ptr()) for t in pointers), *ints,
                                     ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")


def check(what: str, **tensors) -> torch.device:
    """Each keyword is (tensor, shape, dtype). Raises ValueError unless all
    lie on one CPU or CUDA device with the shape and are contiguous, and
    TypeError on another dtype. Returns the device."""
    devs = {t.device for t, _, _ in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"{what}: inputs must share one device, got {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {dev}")
    for name, (t, shape, dtype) in tensors.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} must be {tuple(shape)}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    return dev


def check_iters(what: str, iters: int):
    if not 1 <= iters < 2 ** 31:
        raise ValueError(f"{what}: iters must be in [1, 2^31), got {iters}")


def fold(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two) by halving: first half plus
    second half, as a `__shfl_xor_sync` butterfly adds (16, 8, 4, 2, 1)."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def cta_sum(v: torch.Tensor) -> torch.Tensor:
    """The kernels' float32 sum of each (..., rows, 128) plane over one CTA
    of 1024 threads: thread t holds flat lanes t, t + 1024, ... and adds
    them in that order; each warp folds its 32 threads' partials; every
    warp then folds the 32 warps' sums read from shared memory."""
    lead = v.shape[:-2]
    lanes = v.reshape(*lead, -1, CTA_THREADS)
    part = lanes[..., 0, :]
    for j in range(1, lanes.shape[-2]):
        part = part + lanes[..., j, :]
    return fold(fold(part.reshape(*lead, 32, 32)))


def bound(ops: float, nbytes: float) -> dict:
    """The least time the card could take for a launch: the larger of its
    operations over the float32 rate and its bytes (each input read once,
    each output written once) over the memory rate; beside it the same
    work's time on the one SM a probe runs on (132 times as long)."""
    ops_ms, bytes_ms = ops / F32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    ms = max(ops_ms, bytes_ms)
    return dict(bound_ms=ms, bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                one_sm_ms=ms * SMS)


CTA_WARPS = CTA_THREADS // 32


def needed_cycles(every_warp: dict, once: dict | None = None,
                  warps: int = CTA_WARPS) -> tuple[float, str]:
    """(cycles, what bounds it): the one-SM bound of a step whose function
    needs `every_warp` (class -> warp instructions that each of the CTA's
    `warps` warps issues) and `once` (class -> warp instructions that one
    warp issues for the whole CTA, such as the fold of the warps' slots),
    at compute capability 9.0's rates (`sass_count.bound_cycles`). The
    once-a-CTA work is spread evenly over the warps, so the bound stays a
    lower one."""
    from .sass_count import bound_cycles

    counts = dict(every_warp)
    for cls, n in (once or {}).items():
        counts[cls] = counts.get(cls, 0) + n / warps
    return bound_cycles(counts, warps)


def cta_sum_needed(lanes_per_thread: int) -> tuple[dict, dict]:
    """(every warp, once a CTA): the warp instructions of one float32 CTA sum
    in `cta_sum`'s order. Each thread adds its lanes (lanes - 1 adds); each
    warp folds its 32 partials in a 5-round butterfly (5 shuffles, 5 adds)
    and one lane stores the warp's sum; one warp loads the 32 slots and
    folds them the same way (the order fixes a butterfly; a transpose of
    the partials through shared memory is not counted)."""
    return ({"fp32": lanes_per_thread - 1 + 5, "shfl": 5, "shared": 1},
            {"shared": 1, "shfl": 5, "fp32": 5})


def scatter_rounds(n: int) -> int:
    """Shuffles (and adds) a lane makes to fold n sums over a warp's 32 lanes
    in a reduce-scatter: each xor round (16, 8, 4, 2, 1) sends half of the
    sums a lane still holds, or the one it holds, and keeps the other half,
    so after round r a lane holds max(n / 2^(r+1), 1) of them. IEEE addition
    commutes, so a pair's sum has the same bits in both lanes, and each sum
    ends with the butterfly's bits in the lanes that keep it. 5 for n = 1
    and 2, 6 for n = 4."""
    if n < 1 or n > 32 or n & (n - 1):
        raise ValueError(f"n must be a power of two in [1, 32], got {n}")
    rounds, held = 0, n
    for _ in range(5):
        rounds += max(held // 2, 1)
        held = max(held // 2, 1)
    return rounds


def cta_sums_needed(n: int, lanes_per_thread: int) -> tuple[dict, dict]:
    """(every warp, once a CTA): the warp instructions of n float32 CTA sums
    in one step, each in `cta_sum`'s order. Each thread adds its lanes of
    each plane (n (lanes - 1) adds); each warp folds its n partials in one
    reduce-scatter (`scatter_rounds(n)` shuffles and adds) and stores the n
    sums with one instruction (one lane of each group that holds a sum); one
    warp loads the n x 32 slots (n to a lane, 16 bytes a load) and folds them
    the same way. n = 1 is `cta_sum_needed`. The slots read transposed (the
    first rounds in registers) trade the fold's shuffles for adds; the
    once-a-CTA part is a 32nd of a warp's and is counted as the butterfly."""
    f = scatter_rounds(n)
    return ({"fp32": n * (lanes_per_thread - 1) + f, "shfl": f, "shared": 1},
            {"shared": -(-n // 4), "shfl": f, "fp32": f})


def merge(*parts: tuple[dict, float]) -> dict:
    """Class -> count of the parts (counts, multiplier) added."""
    out = {}
    for counts, times in parts:
        for cls, n in counts.items():
            out[cls] = out.get(cls, 0) + n * times
    return out


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches (CUDA events), after one
    warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run_variants(device, variants: dict, reps: int, unit: str = "iter") -> dict:
    """Runs each variant's kernel (label -> Variant). On the card:
    its device time over reps launches and the SM cycles per unit of work
    (`Variant.units` of them in one launch) that its last launch read with
    clock64(), printed beside the card's name and power limit. On the CPU
    the plain version runs once and nothing is timed. Returns label ->
    dict(ms, cycles_per_<unit>, units, bound, result)."""
    cuda = torch.device(device).type == "cuda"
    card_name = card() if cuda else "cpu, not timed"
    results = {}
    for label, variant in variants.items():
        fn = variant.kernel
        if not cuda:
            res = fn()
            print(f"[{card_name}] {label}: out {float(res.out.flatten()[0]):.6g}", flush=True)
            results[label] = dict(bound=variant.bound, result=res)
            continue
        ms = time_ms(fn, reps)
        res = fn()
        cyc = int(res.cycles.item()) / variant.units
        print(f"[{card_name}] {label}: {ms:.4f} ms -> {cyc:.1f} cyc/{unit} "
              f"(out {float(res.out.flatten()[0]):.6g})", flush=True)
        results[label] = {"ms": ms, f"cycles_per_{unit}": cyc, "units": variant.units,
                          "bound": variant.bound, "result": res}
    return results
