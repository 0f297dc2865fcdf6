"""Radiance .hdr (RGBE) loader — minimal self-contained parser (numpy).
Counterpart: idkengine_tpu/scene/hdr.py.

Role of the reference's stb_image HDR path feeding the skybox
(ref: Source/ImageLoader.cs + SkyBoxManager equirect input). Supports the
common RLE-encoded 32-bit_rle_rgbe format.
"""
from __future__ import annotations

import numpy as np


def load_hdr(path: str) -> np.ndarray:
    """Returns (H, W, 3) float32 linear radiance."""
    with open(path, "rb") as f:
        data = f.read()
    # header
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance HDR file")
    pos = 0
    width = height = None
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line.startswith(b"-Y"):
            parts = line.split()
            height = int(parts[1])
            width = int(parts[3])
            break
        # skip header lines (FORMAT=, comments, blank)
    assert width and height
    rgbe = np.zeros((height, width, 4), np.uint8)
    for y in range(height):
        # scanline header
        if (
            width >= 8
            and width < 32768
            and data[pos] == 2
            and data[pos + 1] == 2
            and ((data[pos + 2] << 8) | data[pos + 3]) == width
        ):
            pos += 4
            # adaptive RLE per channel
            for c in range(4):
                x = 0
                while x < width:
                    count = data[pos]
                    pos += 1
                    if count > 128:  # run
                        rgbe[y, x : x + count - 128, c] = data[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x : x + count, c] = np.frombuffer(
                            data, np.uint8, count, pos
                        )
                        pos += count
                        x += count
        else:
            # flat (possibly old-style RLE, unsupported run marker 1,1,1)
            row = np.frombuffer(data, np.uint8, width * 4, pos).reshape(width, 4)
            rgbe[y] = row
            pos += width * 4
    mantissa = rgbe[..., :3].astype(np.float32)
    exp = rgbe[..., 3].astype(np.int32) - 136  # 128 bias + 8 mantissa shift
    scale = np.exp2(exp.astype(np.float32))[..., None]
    out = mantissa * scale
    out[rgbe[..., 3] == 0] = 0.0
    return out.astype(np.float32)


def _rle_channel(row: np.ndarray) -> bytes:
    """One channel of a scanline in new-style RLE: runs of at least 4
    equal bytes as (128 + n, value), the rest as (n, n literals)."""
    out, x, n = bytearray(), 0, row.shape[0]
    while x < n:
        run = 1
        while x + run < n and run < 127 and row[x + run] == row[x]:
            run += 1
        if run >= 4:
            out += bytes((128 + run, int(row[x])))
            x += run
            continue
        lit = x
        while lit < n and lit - x < 128:
            if lit + 3 < n and row[lit] == row[lit + 1] == row[lit + 2] == row[lit + 3]:
                break
            lit += 1
        out += bytes((lit - x,)) + row[x:lit].tobytes()
        x = lit
    return bytes(out)


def save_hdr(path: str, img: np.ndarray, rle: bool = False) -> None:
    """Write (H, W, 3) linear radiance as a Radiance .hdr file: flat RGBE
    scanlines, or new-style RLE ones (widths 8..32767) with `rle`."""
    img = np.maximum(np.asarray(img, np.float32), 0.0)
    height, width = img.shape[:2]
    m = img.max(axis=-1)
    mant, e = np.frexp(m)
    scale = np.where(m > 1e-32, mant * 256.0 / np.where(m > 1e-32, m, 1.0), 0.0)
    rgbe = np.zeros((height, width, 4), np.uint8)
    rgbe[..., :3] = np.minimum(img * scale[..., None], 255.0).astype(np.uint8)
    rgbe[..., 3] = np.where(m > 1e-32, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {height} +X {width}\n".encode())
        if not rle:
            f.write(rgbe.tobytes())
            return
        if not 8 <= width < 32768:
            raise ValueError(f"RLE scanlines need 8 <= width < 32768, got {width}")
        for y in range(height):
            f.write(bytes((2, 2, width >> 8, width & 0xFF)))
            for c in range(4):
                f.write(_rle_channel(rgbe[y, :, c]))
