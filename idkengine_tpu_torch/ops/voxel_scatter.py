"""Dense per-cell max-scatter: the voxelizer's `imageAtomicMax`.
Counterpart: idkengine_tpu/ops/voxel_scatter.py (`scatter_max_dense`, TPU kernel K3).

`scatter_max_dense(cell, vals, n_cells, bf16)` lands every update's values in
a zero-filled dense (C, n_cells) grid with a per-cell max (ref:
Resource/Shaders/VXGI/Voxelize/fragment.glsl:68-80). On the card it launches
the CUDA kernel `csrc/voxel_scatter.cu`: one thread per update and an
integer `atomicMax` per channel, exact because non-negative floats order like
their bit patterns. The TPU kernel's sort + segmented scan + one-hot matmul
design exists only because the TPU has no atomics, and is not carried over.

A CUDA tensor reaches the kernel or the call raises; the plain version
(`scatter_max_dense_plain`, the JAX package's XLA oracle) runs only for
tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import os

import torch

from ._build import CSRC_DIR, build_shared_library, find_nvcc

VOXEL_SCATTER_SOURCE = os.path.join(CSRC_DIR, "voxel_scatter.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def build_kernels() -> tuple[str, str]:
    """Compile csrc/voxel_scatter.cu if needed. Returns (library path,
    compiler output with ptxas register counts; empty when current)."""
    return build_shared_library("libidk_voxel_scatter.so", [VOXEL_SCATTER_SOURCE],
                                [find_nvcc(), *NVCC_FLAGS])


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_kernels()[0])
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.idk_scatter_max.restype = ci
        lib.idk_scatter_max.argtypes = [vp, vp, vp, ci, ci, cll, ci, vp]
        _lib = lib
    return _lib


def _check_shapes(cell: torch.Tensor, vals: torch.Tensor, n_cells: int):
    if cell.dim() != 1 or vals.dim() != 2 or vals.shape[1] != cell.shape[0]:
        raise ValueError(f"cell must be (N,) and vals (C,N), got {tuple(cell.shape)} "
                         f"and {tuple(vals.shape)}")
    if n_cells < 0:
        raise ValueError(f"n_cells must be >= 0, got {n_cells}")


def scatter_max_dense_plain(cell: torch.Tensor, vals: torch.Tensor, n_cells: int,
                            bf16: bool = False) -> torch.Tensor:
    """The plain version: `zeros((C, n_cells)).scatter_reduce_(1, cell, vals,
    "amax")` with cells outside [0, n_cells) dropped; with bf16 the result
    is rounded to bfloat16 (nearest even) and returned as float32."""
    _check_shapes(cell, vals, n_cells)
    keep = (cell >= 0) & (cell < n_cells)
    cell, vals = cell[keep].long(), vals[:, keep].float()
    out = torch.zeros((vals.shape[0], n_cells), dtype=torch.float32, device=vals.device)
    out.scatter_reduce_(1, cell.expand(vals.shape[0], -1), vals, "amax")
    if bf16:
        out = out.to(torch.bfloat16).to(torch.float32)
    return out


def scatter_max_dense(cell: torch.Tensor, vals: torch.Tensor, n_cells: int,
                      bf16: bool = False) -> torch.Tensor:
    """Per-cell MAX of non-negative values into a dense (C, n_cells) float32
    grid that starts at zero. cell: (N,) int32; vals: (C, N) float32.
    Cells outside [0, n_cells) are dropped. bf16 rounds each value to
    bfloat16 (the reference's rgba16f voxel precision); rounding is
    monotone, so this equals rounding the max."""
    devs = {cell.device, vals.device}
    if len(devs) != 1:
        raise ValueError(f"cell and vals must share one device, got {sorted(map(str, devs))}")
    if cell.device.type == "cpu":
        return scatter_max_dense_plain(cell, vals, n_cells, bf16)
    if cell.device.type != "cuda":
        raise ValueError(f"no scatter kernel for device {cell.device}")
    _check_shapes(cell, vals, n_cells)
    if cell.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(f"cell must be int32 and vals float32, got {cell.dtype} and {vals.dtype}")
    if not (cell.is_contiguous() and vals.is_contiguous()):
        raise ValueError("cell and vals must be contiguous")
    nch, n = vals.shape
    if n >= 2 ** 31 or nch >= 2 ** 31:
        raise ValueError(f"at most 2^31-1 updates and channels, got {n} and {nch}")
    out = torch.zeros((nch, n_cells), dtype=torch.float32, device=vals.device)
    if n and nch and n_cells:
        _launch(cell, vals, out, bf16)
        scatter_max_dense.launches += 1
    return out


def _launch(cell: torch.Tensor, vals: torch.Tensor, out: torch.Tensor, bf16: bool):
    """The kernel alone, into `out` (C, n_cells) on the current stream, for
    checked, non-empty CUDA inputs."""
    nch, n = vals.shape
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    err = _load().idk_scatter_max(
        ctypes.c_void_p(cell.data_ptr()), ctypes.c_void_p(vals.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), n, nch, out.shape[1], int(bf16),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"scatter_max_dense kernel launch failed: CUDA error {err}")


# launch count: the wrapper adds one where it launches its kernel
scatter_max_dense.launches = 0


def reset_launch_counts():
    scatter_max_dense.launches = 0
