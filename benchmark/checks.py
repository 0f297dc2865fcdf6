"""What decides `correct`: frames of the window and pixels in them, drawn
from the seed, compared with the plain reference.

A checked pixel mismatches where some channel of the program's linear
radiance lies farther from the reference's than `pixel_rtol` times the
larger of 1 and the reference's value, or is not a number. The numbers
compared, each against its limit in limits/<cell>.json:

- mismatch_pct: the share of checked pixels, over all checked frames, that
  mismatch, in percent.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


def streams(seed: int, n: int):
    """n independent numpy generators of the seed (any whole number)."""
    return [np.random.default_rng(s) for s in np.random.SeedSequence(abs(int(seed))).spawn(n)]


def pick_frames(rng, n_done: int, k: int) -> list:
    """k frame positions in the window: the last one and k-1 others drawn
    from the seed."""
    if n_done < 1:
        return []
    others = rng.choice(n_done - 1, size=min(k - 1, n_done - 1), replace=False) if n_done > 1 \
        else np.zeros(0, np.int64)
    return sorted({int(i) for i in others} | {n_done - 1})


def pick_pixels(rng, n_pixels: int, k: int) -> np.ndarray:
    return np.sort(rng.choice(n_pixels, size=min(k, n_pixels), replace=False)).astype(np.int64)


def load_limits(cell: str, root: str) -> dict:
    with open(os.path.join(root, "benchmark", "limits", f"{cell}.json")) as f:
        return json.load(f)


def mismatch(prog: torch.Tensor, ref: torch.Tensor, rtol: float) -> torch.Tensor:
    """(F, P) bool: pixels of prog (F,P,3) that mismatch ref (F,P,3)."""
    prog, ref = prog.double().cpu(), ref.double().cpu()
    ok = (prog - ref).abs() <= rtol * torch.clamp(ref.abs(), min=1.0)
    return ~ok.all(-1)


def numbers(prog, ref, rtol) -> dict:
    bad = mismatch(prog, ref, rtol)
    return {"mismatch_pct": float(bad.double().mean() * 100.0)}


def judge(found: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) of numbers against their limits;
    a number above its limit, or missing, fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = found.get(name)
        out[name] = {"value": v, "limit": limit}
        ok = ok and v is not None and np.isfinite(v) and v <= limit
    return ok, out
