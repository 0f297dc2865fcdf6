"""Material table (numpy): SoA material factors and the texture atlas.
Counterpart: idkengine_tpu/scene/materials.py.

Role of the reference's bindless material textures (ref: GpuTypes/
GpuMaterial.cs:12-19, five texture slots a material): every decoded
texture is resized to one fixed-size RGBA8 layer and packed, with its
box-filtered mip chain, into one atlas array (LAYERS, SIZE, 2*SIZE, 4)
that the renderers sample by gathers. A material without a decodable
texture keeps layer -1 and renders factor-only.

The JAX package resizes with Pillow's bilinear filter; the port does the
same resize in numpy (`resize_bilinear`), bit for bit, so that it needs no
Pillow: RGBA is filtered premultiplied, in two separable passes
(horizontal, then vertical) of a triangle filter that widens with the
scale when downscaling, with 22-bit fixed-point coefficients and each
pass rounded and clipped to 8 bits.
"""
from __future__ import annotations

import numpy as np

from .model import Material, Model

ATLAS_SIZE = 512  # each layer is SIZE x SIZE RGBA8
ATLAS_MIPS = 7  # mip levels packed per layer (512 .. 8)
LAYER_KEYS = ("base_layer", "mr_layer", "emissive_layer", "normal_layer")

_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed-point coefficients


def _filter_coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's bilinear coefficients from `in_size` to `out_size` samples:
    (first input sample (out,), fixed-point weights (out, ksize) int64),
    zero past each output's span."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    # C casts to int (toward zero), then clamps
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)
    w = np.maximum(1.0 - np.abs((x[None, :] + xmin[:, None] - center[:, None] + 0.5)
                                * (1.0 / filterscale)), 0.0)
    w = np.where(x[None, :] < xmax[:, None], w, 0.0)
    # Pillow adds the weights one by one, in order; numpy's row sum may
    # round otherwise
    ww = np.zeros((out_size, 1))
    for k in range(ksize):
        ww[:, 0] += w[:, k]
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    fixed = np.trunc(np.where(w < 0, -0.5, 0.5) + w * (1 << _PRECISION_BITS)).astype(np.int64)
    return xmin, fixed


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One separable pass of Pillow's 8-bit resampler along `axis` (0 rows,
    1 columns) of an (H, W, C) uint8 image."""
    xmin, k = _filter_coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)  # (N, M, C)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for j in range(k.shape[1]):
        idx = np.minimum(xmin + j, src.shape[0] - 1)  # weight 0 past the span
        acc += src[idx] * k[:, j, None, None]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _premultiply(rgba: np.ndarray) -> np.ndarray:
    """Pillow's RGBA -> RGBa: each colour times alpha / 255, rounded."""
    a = rgba[..., 3:4].astype(np.uint32)
    tmp = rgba[..., :3].astype(np.uint32) * a + 128
    out = rgba.copy()
    out[..., :3] = (((tmp >> 8) + tmp) >> 8).astype(np.uint8)
    return out


def _unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """Pillow's RGBa -> RGBA: each colour times 255 / alpha, truncated and
    clipped; alpha 0 and 255 leave the colour as it is."""
    a = rgba[..., 3:4].astype(np.int64)
    c = rgba[..., :3].astype(np.int64)
    div = np.clip((255 * c) // np.maximum(a, 1), 0, 255)
    out = rgba.copy()
    out[..., :3] = np.where((a == 0) | (a == 255), c, div).astype(np.uint8)
    return out


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """`np.asarray(Image.fromarray(img).resize((width, height),
    Image.BILINEAR))` without Pillow, for uint8 images (H, W), (H, W, 3)
    or (H, W, 4) (RGBA filtered premultiplied)."""
    img = np.asarray(img, np.uint8)
    if img.shape[:2] == (height, width):
        return img.copy()
    flat = img.ndim == 2
    x = img[..., None] if flat else img
    rgba = x.shape[-1] == 4
    if rgba:
        x = _premultiply(x)
    if x.shape[1] != width:
        x = _resample_axis(x, width, 1)
    if x.shape[0] != height:
        x = _resample_axis(x, height, 0)
    if rgba:
        x = _unpremultiply(x)
    return x[..., 0] if flat else x


def _build_mip_strip(layer: np.ndarray) -> np.ndarray:
    """Pack a (S,S,4) uint8 layer + its box-filtered mip chain into a
    (S, 2S, 4) strip: mip0 on the left half; mip k>=1 at x in [S, S+S/2^k),
    y offset S - 2*(S>>k) (ref: the reference transcodes full BC mip
    chains, ModelLoader.cs:922-1111)."""
    s = layer.shape[0]
    strip = np.zeros((s, 2 * s, 4), np.uint8)
    strip[:, :s] = layer
    cur = layer.astype(np.uint16)
    for k in range(1, ATLAS_MIPS):
        cur = (
            cur[0::2, 0::2].astype(np.uint32) + cur[0::2, 1::2]
            + cur[1::2, 0::2] + cur[1::2, 1::2] + 2
        ) // 4
        sk = s >> k
        y0 = s - 2 * sk
        strip[y0:y0 + sk, s:s + sk] = cur.astype(np.uint8)
        cur = cur.astype(np.uint16)
    return strip


class MaterialTable:
    """Accumulates materials from all models into SoA arrays."""

    def __init__(self):
        self.base_color: list[np.ndarray] = []
        self.emissive: list[np.ndarray] = []
        self.metallic: list[float] = []
        self.roughness: list[float] = []
        self.ior: list[float] = []
        self.transmission: list[float] = []
        self.absorbance: list[np.ndarray] = []
        self.alpha_cutoff: list[float] = []
        self.base_layer: list[int] = []  # atlas layer for base color (-1 none)
        self.mr_layer: list[int] = []
        self.emissive_layer: list[int] = []
        self.normal_layer: list[int] = []
        self._atlas_layers: list[np.ndarray] = []

    def _add_texture(self, tex) -> int:
        if tex is None or tex.data is None:
            return -1
        arr = resize_bilinear(tex.data, ATLAS_SIZE, ATLAS_SIZE)
        if tex.is_srgb:
            # linearize once at load; the renderers sample linear values
            f = (arr[..., :3].astype(np.float32) / 255.0) ** 2.2
            arr = arr.copy()
            arr[..., :3] = np.clip(f * 255.0, 0, 255).astype(np.uint8)
        self._atlas_layers.append(arr)
        return len(self._atlas_layers) - 1

    def add_model(self, model: Model) -> int:
        """Append model materials; returns the material index offset."""
        offset = len(self.base_color)
        tex_layer_cache: dict[int, int] = {}

        def layer_for(ti: int) -> int:
            if ti < 0 or ti >= len(model.textures):
                return -1
            if ti not in tex_layer_cache:
                tex_layer_cache[ti] = self._add_texture(model.textures[ti])
            return tex_layer_cache[ti]

        for m in model.materials:
            self.base_color.append(np.asarray(m.base_color, np.float32))
            self.emissive.append(np.asarray(m.emissive, np.float32))
            self.metallic.append(float(m.metallic))
            self.roughness.append(float(m.roughness))
            self.ior.append(float(m.ior))
            self.transmission.append(float(m.transmission))
            self.absorbance.append(np.asarray(m.absorbance, np.float32))
            self.alpha_cutoff.append(float(m.alpha_cutoff))
            self.base_layer.append(layer_for(m.base_color_texture))
            self.mr_layer.append(layer_for(m.metallic_roughness_texture))
            self.emissive_layer.append(layer_for(m.emissive_texture))
            self.normal_layer.append(layer_for(m.normal_texture))
        return offset

    def adopt_texture(self, model: Model, mat_offset: int, ti: int, tex) -> int:
        """Late-arriving texture (async decode finished): pack it into the
        atlas and point every material slot that references texture `ti` at
        the new layer. Returns the layer id (-1 on decode failure)."""
        layer = self._add_texture(tex)
        if layer < 0:
            return -1
        for mi, m in enumerate(model.materials):
            g = mat_offset + mi
            if g >= len(self.base_color):
                continue
            if m.base_color_texture == ti:
                self.base_layer[g] = layer
            if m.metallic_roughness_texture == ti:
                self.mr_layer[g] = layer
            if m.emissive_texture == ti:
                self.emissive_layer[g] = layer
            if m.normal_texture == ti:
                self.normal_layer[g] = layer
        return layer

    def atlas_layer(self, layer: int) -> np.ndarray:
        """One packed atlas layer incl. its mip strip (SIZE, 2*SIZE, 4)."""
        return _build_mip_strip(self._atlas_layers[layer])

    def layer_arrays(self) -> dict[str, np.ndarray]:
        """The texture layers of every material and the fields the renderers'
        texture gates read (base colour, alpha cutoff), without the atlas."""
        return {"base_color": np.stack(self.base_color),
                "alpha_cutoff": np.asarray(self.alpha_cutoff, np.float32),
                **{k: np.asarray(getattr(self, k), np.int32) for k in LAYER_KEYS}}

    def soa(self) -> dict[str, np.ndarray]:
        if not self.base_color:
            model = Model()
            model.materials = [Material(name="default")]
            self.add_model(model)
        atlas = (
            np.stack([_build_mip_strip(a) for a in self._atlas_layers])
            if self._atlas_layers
            else np.zeros((1, ATLAS_SIZE, 2 * ATLAS_SIZE, 4), np.uint8)
        )
        return {
            "base_color": np.stack(self.base_color),
            "emissive": np.stack(self.emissive),
            "metallic": np.asarray(self.metallic, np.float32),
            "roughness": np.asarray(self.roughness, np.float32),
            "ior": np.asarray(self.ior, np.float32),
            "transmission": np.asarray(self.transmission, np.float32),
            "absorbance": np.stack(self.absorbance),
            "alpha_cutoff": np.asarray(self.alpha_cutoff, np.float32),
            "base_layer": np.asarray(self.base_layer, np.int32),
            "mr_layer": np.asarray(self.mr_layer, np.int32),
            "emissive_layer": np.asarray(self.emissive_layer, np.int32),
            "normal_layer": np.asarray(self.normal_layer, np.int32),
            "atlas": atlas,
        }
