"""The reference's own textures and surface tables, worked out from the
scene data as the renderer states them (imports nothing of the program):

- each texture resized to 512x512 by Pillow's bilinear filter (RGBA
  premultiplied, two separable passes, 22-bit fixed-point weights), sRGB
  colours raised to 2.2 into linear bytes, and packed with its 2x2 box mip
  chain (7 levels) into a (512, 1024, 4) strip;
- the strip sampled bilinearly at one level, or trilinearly across two at a
  ray cone's level of detail;
- each triangle's tangent frame from its UV derivatives (a fallback frame
  where they are degenerate), stored as octahedral snorm16 like the
  normals, and its UV density (texture units a world unit).
"""
from __future__ import annotations

import numpy as np
import torch

from .tracer import cross, fma

SIZE = 512
MIPS = 7
_BITS = 22


def _coeffs(in_size, out_size):
    scale = float(in_size) / out_size
    fs = max(scale, 1.0)
    support = 1.0 * fs
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)
    w = np.maximum(1.0 - np.abs((x[None, :] + xmin[:, None] - center[:, None] + 0.5)
                                * (1.0 / fs)), 0.0)
    w = np.where(x[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros((out_size, 1))
    for k in range(ksize):  # summed one by one, in order
        ww[:, 0] += w[:, k]
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    return xmin, np.trunc(np.where(w < 0, -0.5, 0.5) + w * (1 << _BITS)).astype(np.int64)


def _pass(img, out_size, axis):
    xmin, k = _coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_BITS - 1), np.int64)
    for j in range(k.shape[1]):
        acc += src[np.minimum(xmin + j, src.shape[0] - 1)] * k[:, j, None, None]
    return np.moveaxis(np.clip(acc >> _BITS, 0, 255).astype(np.uint8), 0, axis)


def resize(rgba, size):
    """(H,W,4) uint8 to (size,size,4), Pillow's BILINEAR on RGBA."""
    if rgba.shape[:2] == (size, size):
        return rgba.copy()
    a = rgba[..., 3:4].astype(np.uint32)
    tmp = rgba[..., :3].astype(np.uint32) * a + 128
    x = rgba.copy()
    x[..., :3] = (((tmp >> 8) + tmp) >> 8).astype(np.uint8)
    if x.shape[1] != size:
        x = _pass(x, size, 1)
    if x.shape[0] != size:
        x = _pass(x, size, 0)
    a = x[..., 3:4].astype(np.int64)
    c = x[..., :3].astype(np.int64)
    out = x.copy()
    out[..., :3] = np.where((a == 0) | (a == 255), c, np.clip((255 * c) // np.maximum(a, 1), 0,
                                                               255)).astype(np.uint8)
    return out


def strip(texture) -> np.ndarray:
    """(SIZE, 2*SIZE, 4) uint8: level 0 on the left; level k at x in
    [S, S + S/2^k), rows from S - 2*(S >> k)."""
    arr = resize(np.asarray(texture.data, np.uint8), SIZE)
    if texture.srgb:
        f = (arr[..., :3].astype(np.float32) / 255.0) ** 2.2
        arr = arr.copy()
        arr[..., :3] = np.clip(f * 255.0, 0, 255).astype(np.uint8)
    out = np.zeros((SIZE, 2 * SIZE, 4), np.uint8)
    out[:, :SIZE] = arr
    cur = arr.astype(np.uint16)
    for k in range(1, MIPS):
        cur = (cur[0::2, 0::2].astype(np.uint32) + cur[0::2, 1::2] + cur[1::2, 0::2]
               + cur[1::2, 1::2] + 2) // 4
        sk = SIZE >> k
        out[SIZE - 2 * sk:SIZE - sk, SIZE:SIZE + sk] = cur.astype(np.uint8)
        cur = cur.astype(np.uint16)
    return out


def mix(a, b, t):
    return fma(a, 1.0 - t, b * t)


def sample(strips, tex, uv, lod=None, dtype=torch.float32):
    """RGBA in [0,1] (R,4) of texture indices tex (R,) (ones where < 0) at
    uv (R,2): bilinear at level 0, or with lod (R,) trilinear."""
    size = strips.shape[1]
    t = torch.clamp(tex, min=0).long()
    flat = strips.reshape(-1, 4)

    def tap(k):
        scale = torch.full_like(k, size) >> k
        off_x = torch.where(k == 0, 0, size)
        off_y = torch.where(k == 0, 0, size - 2 * scale)
        top = (scale - 1).to(dtype)
        u = (uv[..., 0] % 1.0) * top
        v = (uv[..., 1] % 1.0) * top
        # indices clamped into the level, as a gather clamps them (also where
        # a lower precision makes a coordinate not a number)
        x0 = torch.clamp(torch.minimum(torch.clamp(torch.floor(u), min=0).long(), scale - 1), min=0)
        y0 = torch.clamp(torch.minimum(torch.clamp(torch.floor(v), min=0).long(), scale - 1), min=0)
        x1, y1 = torch.minimum(x0 + 1, scale - 1), torch.minimum(y0 + 1, scale - 1)
        fx, fy = (u - x0)[..., None], (v - y0)[..., None]
        row = t * size + off_y
        c = [flat[(row + yy) * (2 * size) + off_x + xx].to(dtype)
             for yy, xx in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))]
        return mix(mix(c[0], c[1], fx), mix(c[2], c[3], fx), fy)

    if lod is None:
        c = tap(torch.zeros_like(t))
    else:
        lc = torch.clamp(torch.nan_to_num(lod), 0.0, MIPS - 1.0)
        k0 = torch.floor(lc).long()
        k1 = torch.clamp(k0 + 1, max=MIPS - 1)
        c = mix(tap(k0), tap(k1), (lc - k0)[..., None])
    c = c / 255.0
    return torch.where(tex[..., None] >= 0, c, torch.ones_like(c))


def tangent_frames(uv3, e1, e2, gn):
    """Per triangle: tangent, bitangent (T,3) from corner UVs (T,3,2) and
    edges, and the UV density (T,)."""
    du1 = uv3[:, 1] - uv3[:, 0]
    du2 = uv3[:, 2] - uv3[:, 0]
    det = fma(du1[:, 0], du2[:, 1], -(du2[:, 0] * du1[:, 1]))
    ok = det.abs() > 1e-12
    rdet = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)[:, None]
    tan = fma(e1, du2[:, 1:2], -(e2 * du1[:, 1:2])) * rdet
    bit = fma(e2, du1[:, 0:1], -(e1 * du2[:, 0:1])) * rdet
    axis = torch.where(gn[:, :1].abs() < 0.9, gn.new_tensor([[1.0, 0.0, 0.0]]),
                       gn.new_tensor([[0.0, 1.0, 0.0]]))
    fb = cross(gn, axis)
    norm = torch.linalg.vector_norm
    tl = norm(tan, dim=-1, keepdim=True)
    tan = torch.where((tl > 1e-12) & ok[:, None], tan / torch.clamp(tl, min=1e-12), fb)
    bl = norm(bit, dim=-1, keepdim=True)
    bit = torch.where((bl > 1e-12) & ok[:, None], bit / torch.clamp(bl, min=1e-12), cross(gn, fb))
    uv_area = 0.5 * det.abs()
    world = 0.5 * norm(cross(e1, e2), dim=-1)
    density = torch.sqrt((uv_area / torch.clamp(world, min=1e-20)).double()).float()
    return tan, bit, density
