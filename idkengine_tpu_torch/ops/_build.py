"""Builds the port's native libraries from the repository's sources.

Each library is compiled on first use into the ignored `build/` directory at
the repository root and loaded with ctypes. A build is redone when any source,
or header it includes, is newer than the library. Compilation goes to a
per-process temporary file that is renamed into place, so concurrent test
workers never load a half-written library.
"""
from __future__ import annotations

import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(_PKG_DIR)
BUILD_DIR = os.path.join(REPO_DIR, "build")
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
COMPILE_TIMEOUT_S = 900


def build_shared_library(name: str, sources: list[str], command: list[str],
                         headers: tuple[str, ...] = ()) -> tuple[str, str]:
    """Compile `sources` with `command` into BUILD_DIR/name unless a copy
    newer than every source and included header exists. Returns (library
    path, compiler output; empty when the library was already built).
    Raises RuntimeError when the compiler fails."""
    out = os.path.join(BUILD_DIR, name)
    newest = max(os.path.getmtime(s) for s in (*sources, *headers))
    if os.path.exists(out) and os.path.getmtime(out) >= newest:
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([*command, "-o", tmp, *sources], capture_output=True,
                          text=True, timeout=COMPILE_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {name} failed ({' '.join(command)}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def find_nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then the toolkit's
    default install prefix. Raises RuntimeError when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA trace kernel cannot be built")
