"""KTX2 container parsing (numpy). Counterpart: idkengine_tpu/scene/ktx2.py.

Ref role: Source/Ktx2Texture.cs + libktx.

Parses the KTX2 header/level index and decodes what is feasible without the
native BasisU transcoder: raw uncompressed formats, zlib-supercompressed
payloads, and zstd-supercompressed ones when the `zstandard` module is
present (None without it). BasisLZ/ETC1S payloads go through the numpy
transcoder (scene/basisu.py); UASTC and other formats return None, and
callers fall back to flat material factors, matching the reference's
missing-texture fallback behavior (ModelLoader.cs:879-906).
"""
from __future__ import annotations

import struct

import numpy as np

from ..log import get_logger

log = get_logger(__name__)

_IDENTIFIER = b"\xabKTX 20\xbb\r\n\x1a\n"

# vkFormat values we can decode directly
_VK_R8G8B8A8_UNORM = 37
_VK_R8G8B8A8_SRGB = 43
_VK_R8G8B8_UNORM = 23
_VK_R8G8B8_SRGB = 29
_VK_R8_UNORM = 9
_VK_R8G8_UNORM = 16


def parse_header(data: bytes) -> dict:
    if data[:12] != _IDENTIFIER:
        raise ValueError("not a KTX2 file")
    (
        vk_format, type_size, w, h, depth, layers, faces, levels, scheme,
    ) = struct.unpack_from("<9I", data, 12)
    (
        dfd_off, dfd_len, kvd_off, kvd_len, sgd_off, sgd_len,
    ) = struct.unpack_from("<IIIIQQ", data, 48)
    level_index = []
    off = 80
    for _ in range(max(levels, 1)):
        byte_off, byte_len, uncomp_len = struct.unpack_from("<QQQ", data, off)
        level_index.append((byte_off, byte_len, uncomp_len))
        off += 24
    return {
        "vk_format": vk_format,
        "type_size": type_size,
        "width": w,
        "height": max(h, 1),
        "depth": depth,
        "layers": layers,
        "faces": faces,
        "levels": max(levels, 1),
        "supercompression": scheme,  # 0=none 1=BasisLZ 2=zstd 3=zlib
        "level_index": level_index,
        "sgd": (sgd_off, sgd_len),
    }


def _decompress(payload: bytes, scheme: int, uncomp_len: int) -> bytes | None:
    if scheme == 0:
        return payload
    if scheme == 2:
        try:
            import zstandard

            return zstandard.ZstdDecompressor().decompress(payload, max_output_size=uncomp_len)
        except ImportError:
            return None
    if scheme == 3:
        import zlib

        return zlib.decompress(payload)
    return None  # BasisLZ needs the ETC1S transcoder


def decode_ktx2(data: bytes) -> np.ndarray | None:
    """Decode mip level 0 to (H, W, 4) uint8, or None if unsupported.

    BasisLZ/ETC1S payloads route through the pure-Python transcoder
    (scene/basisu.py), capped at the atlas-relevant mip size."""
    try:
        hdr = parse_header(data)
    except Exception as e:
        log.warning("KTX2 parse failed: %s", e)
        return None
    if hdr["supercompression"] == 1:  # BasisLZ (ETC1S)
        from . import basisu
        from .materials import ATLAS_SIZE

        return basisu.transcode_ktx2(data, max_size=ATLAS_SIZE)
    off, blen, ulen = hdr["level_index"][0]
    payload = _decompress(data[off : off + blen], hdr["supercompression"], ulen)
    if payload is None:
        log.debug(
            "KTX2 unsupported supercompression %d",
            hdr["supercompression"],
        )
        return None
    w, h = hdr["width"], hdr["height"]
    fmt = hdr["vk_format"]
    if fmt in (_VK_R8G8B8A8_UNORM, _VK_R8G8B8A8_SRGB):
        return np.frombuffer(payload, np.uint8, w * h * 4).reshape(h, w, 4).copy()
    if fmt in (_VK_R8G8B8_UNORM, _VK_R8G8B8_SRGB):
        rgb = np.frombuffer(payload, np.uint8, w * h * 3).reshape(h, w, 3)
        return np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], axis=-1)
    if fmt == _VK_R8_UNORM:
        r = np.frombuffer(payload, np.uint8, w * h).reshape(h, w, 1)
        return np.concatenate([r, r, r, np.full((h, w, 1), 255, np.uint8)], axis=-1)
    if fmt == _VK_R8G8_UNORM:
        rg = np.frombuffer(payload, np.uint8, w * h * 2).reshape(h, w, 2)
        z = np.zeros((h, w, 1), np.uint8)
        return np.concatenate([rg, z, np.full((h, w, 1), 255, np.uint8)], axis=-1)
    log.debug("KTX2 vkFormat %d not decodable without BasisU transcoder", fmt)
    return None
