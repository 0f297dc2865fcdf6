"""Wavefront path tracer over the ray megabatch.
Counterpart: idkengine_tpu/render/pathtracer.py (`PathTracerSettings`, `PathTracer`).

Every pixel's ray keeps a fixed place in a batch of W*H rays; dead rays
carry t_max < 0 and leave traversal at once (ref: Source/Render/
PathTracer.cs + Resource/Shaders/PathTracing/**). Per bounce: optional ray
sort, closest-hit trace, light spheres, hit attribute fetch, next-event
estimation with an any-hit shadow trace, BSDF sampling, Russian roulette;
then accumulation.

Image semantics are those of the JAX package's path without the packet
tracer: launch order is pixel order, each ray picks its NEE light from its
own RNG state, and shadow rays are not re-sorted. With `do_ray_sorting` the
whole ray state, RNG state included, is permuted by the octant+Morton key
and stays sorted; radiance returns to pixel order at the end, so sorting
changes the traversal order and never the image.

With `use_two_phase` every closest-hit and shadow trace goes through the
two-phase traversal (ops/two_phase.py), as the JAX package routes it
(pathtracer.py:614-646); the image is the one-phase image up to equal-t
ties.

Materials are those of the JAX package: factors times the texture atlas
(base colour, metal-roughness, emissive; trilinear across the mip strip at
the ray-cone LOD), tangent-space normal maps, the stochastic alpha test
(MASK and BLEND, `alpha_rounds` re-traces past discarded surfaces, alpha
shadows), per-mesh shading overrides (`slot_shading`), an equirect
environment map as the sky and next-event estimation toward it through an
alias table (render/envsample.py), and a per-pixel bounce budget
(`render_frame(rate_depth=...)`). Texture sampling, the sky lookup and the
alias draws are PyTorch; every trace goes through the entry points above.
`tile_size` splits each closest-hit trace into launches of that many rays
(where the batch is a multiple of it, after the sort permutation, as the
JAX package's `_trace_maybe_tiled` does); the image is the untiled one.
`max_trace_steps` caps every one-phase trace at that many steps of the
stackless binary walk, as the JAX package's XLA traces take it (the capped
kernels on the card); the two-phase route takes no cap, as in the JAX
package. With `instances` (an InstanceSet) every trace is two-level
(ops/packet_trace.py: the static scene, then each instance in its own
space), as the JAX package routes it: `tile_size` and `use_two_phase` are
not used, `max_trace_steps` caps each of the traces; the instanced
models' slots follow the static slots in all three attribute tables
(`inst_attr_srcs`, their FlatTriangles), and shading turns an instance
hit's local-space normals and tangent frame by its normal matrix.

Every stage of a frame runs in a span (profiling.pass_scope, recorded only
while a profiler traces): pt/frame (args: the frame index) holds
pt/raygen (with pt/camera upload), one pt/bounce a bounce (args: its
index) and pt/accumulate; a bounce holds pt/sort, pt/closest (the trace's
call site and pt/alpha re-traces), pt/lights, pt/shade (twice: before and
after next-event estimation; pt/textures inside), pt/nee and pt/env nee.
No device operation of a frame lies directly under pt/frame or pt/bounce.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial

import numpy as np
import torch

from ..ops.intersect import cross3, fma, ray_sphere
from ..ops.packet_trace import (trace_any, trace_any_two_level, trace_closest,
                                trace_closest_two_level)
from ..ops.two_phase import two_phase_any, two_phase_closest
from ..ops.trace import Hit, InstanceSet, SceneArrays, linear_map
from ..profiling import pass_scope
from ..scene.materials import ATLAS_MIPS, LAYER_KEYS
from ..scene.scene_db import MeshShading
from ..utils import rng
from ..utils.compression import compress_normal_t, decompress_normal
from . import envsample, sampling, shading
from .camera import Camera, generate_rays

# Per-slot attributes: the channels of the JAX package's pack in three
# tables, each gathered by a row per hit only where a scene reads it. The
# base table holds what every hit reads (face normal, corner normals,
# material factors); the surface table what the alpha test and texture
# lookups read (corner UVs, material id, alpha factor and cutoff); the
# extended table what textures, normal maps and per-mesh overrides read
# besides (tangent frame, UV density, the overrides in MeshShading.row
# order). No table is a multiple of four floats wide: PyTorch gathers such
# rows with a vectorized kernel that is several times slower on the card
# (gather_widths.py). uint32 bit patterns (octahedral normals, tangents,
# bitangents) are kept as two exact u16 halves in float32.
_GN, _N_LO, _N_HI, _ALBEDO, _EMISSIVE = 0, 3, 6, 9, 12
_METALLIC, _ROUGH, _TRANS, _IOR, _ABSORB = 15, 16, 17, 18, 19
BASE_CH = 22
_UV, _MAT, _ALPHA, _CUTOFF = 0, 6, 7, 8
SURF_CH = 9
_TAN_LO, _TAN_HI, _BIT_LO, _BIT_HI, _UVDEN, _SHADE = 0, 1, 2, 3, 4, 5
EXT_CH = 15
# the JAX package's channel order as columns of [base | surface | extended]
_S, _X = BASE_CH, BASE_CH + SURF_CH
JAX_ORDER = ([_S + _UV + k for k in range(6)] + [_GN + k for k in range(3)]
             + [_N_LO + k for k in range(3)] + list(range(_ALBEDO, BASE_CH))
             + [_S + _MAT, _X + _TAN_LO, _X + _BIT_LO, _S + _ALPHA, _S + _CUTOFF, _X + _UVDEN]
             + [_N_HI + k for k in range(3)] + [_X + _TAN_HI, _X + _BIT_HI]
             + [_X + _SHADE + k for k in range(10)])

_DEAD_KEY = 0x7FFFFFFF
_NO_MAX_STEPS = 1 << 30


@dataclass(frozen=True)
class PathTracerSettings:
    """ref: PathTracer.cs settings block (:12-140). Same fields as the JAX
    package's settings."""

    ray_depth: int = 5
    spp_per_frame: int = 1
    russian_roulette: bool = True
    rr_min_bounce: int = 2
    nee: bool = True  # next-event estimation toward sphere lights
    use_packet_tracer: bool = True  # traversal kernel on the card (always)
    use_two_phase: bool = False  # traces through ops/two_phase.py
    do_ray_sorting: bool = False
    tile_size: int = 0  # 0 = whole batch in one traversal
    light_spheres: bool = True
    sky_zenith: tuple = (0.45, 0.65, 1.0)
    sky_horizon: tuple = (0.9, 0.9, 0.95)
    sky_strength: float = 1.0
    use_env_map: bool = False
    # NEE toward bright env texels via an alias table (render/envsample.py);
    # when on, NEE owns the diffuse direct env term and BSDF env hits count
    # only on delta-like paths (the same split as sphere lights)
    env_nee: bool = False
    max_trace_steps: int = _NO_MAX_STEPS  # the default: no cap
    # texture LOD bias added to the ray-cone mip level (negative = sharper;
    # ref: TAAResolve.cs:76-80)
    mip_bias: float = 0.0


def _trace_closest_tiled(scene, o, d, t_max, tile: int = 0, max_steps=None,
                         tag: str = "") -> Hit:
    """trace_closest in launches of `tile` rays where the batch is larger
    than a tile and a multiple of it (the JAX package's
    `_trace_maybe_tiled`), else in one; `max_steps` caps each ray's walk;
    `tag` is the call site's."""
    r = o.shape[0]
    if not (tile and r > tile and r % tile == 0):
        return trace_closest(scene, o, d, t_max, max_steps=max_steps, tag=tag)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device).expand(r)
    parts = [trace_closest(scene, o[i:i + tile], d[i:i + tile], t_max[i:i + tile].contiguous(),
                           max_steps=max_steps, tag=tag) for i in range(0, r, tile)]
    return Hit(*(torch.cat(k) for k in zip(*parts)))


def _normalize(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)


# Interpolations rounded as XLA:CPU rounds the JAX package's: of a sum of
# products it fuses the first product into each addition (a*b + c*d is
# fma(a, b, c*d)). Where a texture coordinate lands next to a texel or
# wrap boundary, one rounding more or less picks another texel.
def _bary(c0, c1, c2, w, u, v):
    """c0*w + c1*u + c2*v."""
    return fma(c2, v, fma(c0, w, c1 * u))


def _mix(a, b, t):
    """a*(1-t) + b*t."""
    return fma(a, 1.0 - t, b * t)


def _advance(t):
    """How far an alpha re-trace moves its origin past a discarded hit at
    t: t * (1 + 1e-5) + 1e-4, fused as XLA:CPU fuses it (the origin moves
    by fma(d, advance, o) too)."""
    return fma(t, torch.full_like(t, 1.0 + 1e-5), torch.full_like(t, 1e-4))


def sample_atlas(atlas, layer, uv, lod=None):
    """Bilinear (or, with `lod`, trilinear across the packed mip strip of
    scene/materials._build_mip_strip) sample of the RGBA8 atlas
    (L, S, 2S, 4) uint8. layer (R,) int, uv (R,2), lod (R,). Returns (R,4)
    float in [0,1]; layer < 0 returns ones (factor-only materials).
    Counterpart: the JAX package's pathtracer._sample_atlas, its blends
    rounded as its path tracer's jit rounds them."""
    size = atlas.shape[1]
    has_mips = atlas.shape[2] == 2 * size
    l = torch.clamp(layer, min=0).long()
    flat = atlas.reshape(-1, 4)

    def tap(k):
        """One bilinear tap at mip level k (R,) int64."""
        scale = torch.full_like(k, size) >> k
        off_x = torch.where(k == 0, 0, size)
        off_y = torch.where(k == 0, 0, size - 2 * scale)
        top = (scale - 1).to(torch.float32)
        u = (uv[..., 0] % 1.0) * top
        v = (uv[..., 1] % 1.0) * top
        # an XLA gather clamps its indices; so do these
        x0 = torch.clamp(torch.floor(u), min=0).long()
        y0 = torch.clamp(torch.floor(v), min=0).long()
        x0, y0 = torch.minimum(x0, scale - 1), torch.minimum(y0, scale - 1)
        x1 = torch.minimum(x0 + 1, scale - 1)
        y1 = torch.minimum(y0 + 1, scale - 1)
        fx = (u - x0)[..., None]
        fy = (v - y0)[..., None]
        row = l * size + off_y
        c00 = flat[(row + y0) * (2 * size) + off_x + x0].to(torch.float32)
        c01 = flat[(row + y0) * (2 * size) + off_x + x1].to(torch.float32)
        c10 = flat[(row + y1) * (2 * size) + off_x + x0].to(torch.float32)
        c11 = flat[(row + y1) * (2 * size) + off_x + x1].to(torch.float32)
        return _mix(_mix(c00, c01, fx), _mix(c10, c11, fx), fy)

    if lod is None or not has_mips:
        c = tap(torch.zeros_like(l))
    else:
        lodc = torch.clamp(torch.nan_to_num(lod), 0.0, ATLAS_MIPS - 1.0)
        k0 = torch.floor(lodc).long()
        k1 = torch.clamp(k0 + 1, max=ATLAS_MIPS - 1)
        f = (lodc - k0)[..., None]
        c = _mix(tap(k0), tap(k1), f)
    c = c / 255.0
    return torch.where(layer[..., None] >= 0, c, torch.ones_like(c))


def _uv_derivatives(uv3):
    """Corner UV differences du1, du2 (T,2) of (T,3,2) corner UVs and their
    determinant (T,), rounded as XLA:CPU rounds the JAX package's jit."""
    du1 = uv3[:, 1] - uv3[:, 0]
    du2 = uv3[:, 2] - uv3[:, 0]
    return du1, du2, fma(du1[:, 0], du2[:, 1], -(du2[:, 0] * du1[:, 1]))


def uv_density(uv3, e1, e2):
    """Texture UV units per world unit of each triangle (T,): the root of
    its UV area over its world area, which turns a ray cone's world
    footprint into texels. uv3 (T,3,2) corner UVs, e1, e2 (T,3) edges."""
    uv_area = 0.5 * _uv_derivatives(uv3)[2].abs()
    world_area = 0.5 * torch.linalg.vector_norm(cross3(e1, e2), dim=-1)
    # a correctly rounded root, as XLA's (ATen's float32 sqrt on the CPU is
    # not, in the last place)
    return torch.sqrt((uv_area / torch.clamp(world_area, min=1e-20)).double()).float()


def scene_triangles(scene: SceneArrays) -> dict:
    """The triangle tensors an attribute table is packed from."""
    return dict(uv=scene.tri_uv, gn=scene.tri_gn, n=scene.tri_n, mat=scene.tri_mat,
                e1=scene.tri_e1, e2=scene.tri_e2)


def flat_triangles(ft, device) -> dict:
    """scene_triangles of an instanced model's FlatTriangles (numpy)."""
    def put(x, dtype=np.float32):
        return torch.as_tensor(np.asarray(x, dtype), device=device)

    return dict(uv=put(ft.uv), gn=put(ft.geom_normal), n=put(ft.n_packed, np.int64),
                mat=put(ft.mat, np.int32), e1=put(ft.e1), e2=put(ft.e2))


def _morton_spread(v):
    # interleave 8 bits with 2-bit gaps
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


class PathTracer:
    """Owns the device buffers and the sample step; accumulates frames.

    Equivalent in role to PathTracer.cs + PathTracerPipeline.cs."""

    # the device state _render_sample reads; a sharded tracer holds a copy
    # of it on each other device (parallel/shard.py)
    DEVICE_STATE = ("scene", "instances", "lights", "mats", "env_map", "_env_tables",
                    "_attr_base", "_attr_surf", "_attr_ext", "_sky_zenith", "_sky_horizon")

    def __init__(self, scene: SceneArrays, materials: dict, lights: dict,
                 width: int, height: int, settings: PathTracerSettings | None = None,
                 env_map=None, instances=None, inst_attr_srcs=None, slot_shading=None, *,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if scene.device != self.device:
            raise ValueError(f"scene is on {scene.device}, the tracer on {self.device}")
        if instances is not None:
            if not isinstance(instances, InstanceSet):
                raise TypeError(f"instances must be an InstanceSet, got {type(instances).__name__}")
            if any(s.device != self.device for s in instances.scenes):
                raise ValueError(f"the instances' scenes must lie on {self.device}")

        self._use_settings(settings or PathTracerSettings())
        self.scene = scene
        self.width = width
        self.height = height
        self.n_lights = int(lights.get("count", 0))
        self.lights = {k: torch.as_tensor(np.asarray(lights[k], np.float32), device=self.device)
                       for k in ("pos", "radius", "radiance")}
        self.mats = {k: torch.as_tensor(np.asarray(materials[k]), device=self.device).long()
                     for k in LAYER_KEYS if k in materials}
        if "atlas" in materials:
            self.mats["atlas"] = torch.as_tensor(np.asarray(materials["atlas"], np.uint8),
                                                 device=self.device)
        self.env_map = (None if env_map is None else
                        torch.as_tensor(np.asarray(env_map, np.float32), device=self.device))
        # alias tables for env NEE: built once per map, only when the
        # settings can use them (render_frame builds them if they are
        # switched on later)
        self._env_tables = None
        if env_map is not None and self.settings.use_env_map and self.settings.env_nee:
            self._env_tables = envsample.EnvSampler(env_map, device=self.device).tables
        self._set_feature_gates(materials)
        # stochastic re-traces past alpha-discarded surfaces
        self.alpha_rounds = 2
        # instanced models' slots follow the static slots (the slot offsets
        # of the InstanceSet point there); their frames are local-space
        tris = [scene_triangles(scene)] + [flat_triangles(src, self.device)
                                           for src in (inst_attr_srcs or [])]
        tables = [self._pack_attr(t, materials, slot_shading if i == 0 else None)
                  for i, t in enumerate(tris)]
        self._attr_base, self._attr_surf, self._attr_ext = (
            torch.cat(part) if len(tables) > 1 else part[0] for part in zip(*tables))
        self.instances = instances
        self._has_mesh_shading = self._shading_differs(slot_shading)
        n_px = height * width
        self.accum = torch.zeros((n_px, 3), device=self.device)
        # running mean of per-sample luminance^2 (per-pixel variance)
        self.accum_lum2 = torch.zeros((n_px,), device=self.device)
        self.accumulated_samples = 0
        self._frame = 0
        self.last_rays_traced = torch.zeros((), device=self.device)

    def _set_feature_gates(self, materials: dict):
        """Static feature gates: the hot path stays untouched for scenes
        without textures, alpha-tested or normal-mapped materials."""
        layers = {k: np.asarray(materials.get(k, [-1])) for k in LAYER_KEYS}
        self._has_textures = bool(any(np.any(layers[k] >= 0) for k in
                                      ("base_layer", "mr_layer", "emissive_layer")))
        cutoffs = np.asarray(materials.get("alpha_cutoff", [-1.0]))
        alphas = np.asarray(materials["base_color"])[:, 3]
        self._has_alpha = bool(np.any((cutoffs >= 0.0)
                                      & ((alphas < 1.0) | (layers["base_layer"] >= 0))))
        self._has_normal_maps = bool(np.any(layers["normal_layer"] >= 0))

    def adopt_texture_layers(self, atlas_layer, layer: int, materials: dict):
        """A texture decoded after construction (scene/async_io.py): atlas
        layer `layer` (`atlas_layer(i)` gives layer i's mip strip) is written
        in place on the atlas's device, or appended where it is new; the
        materials' layer indices (MaterialTable.layer_arrays) replace the
        tracer's, and the gates follow them from the next frame on. The JAX
        tracer turns on only its texture gate here, so its late normal maps
        and texture alpha stay off; the port's frame is the eager load's."""
        atlas = self.mats["atlas"]
        if layer < atlas.shape[0]:
            atlas[layer] = torch.as_tensor(atlas_layer(layer), device=atlas.device)
        else:
            new = np.stack([atlas_layer(i) for i in range(atlas.shape[0], layer + 1)])
            self.mats["atlas"] = torch.cat([atlas, torch.as_tensor(new, device=atlas.device)])
        for k in LAYER_KEYS:
            self.mats[k] = torch.as_tensor(materials[k], device=self.device).long()
        self._set_feature_gates(materials)

    @staticmethod
    def _shading_differs(slot_shading) -> bool:
        return bool(slot_shading is not None
                    and np.any(np.asarray(slot_shading, np.float32) != MeshShading.ROW_DEFAULT))

    def attr_table(self) -> torch.Tensor:
        """The (T, 46) per-slot attributes in the JAX package's channel order."""
        tables = (self._attr_base, self._attr_surf, self._attr_ext)
        return torch.cat(tables, dim=1)[:, JAX_ORDER]

    def _pack_attr(self, tri: dict, materials: dict, slot_shading):
        """The base, surface and extended per-slot tables, made on the device
        from triangle tensors (scene_triangles; JAX: `_pack_attr_dev`): the tangent frame
        from the UV derivatives, flat per triangle (the reference
        interpolates authored vertex tangents, Surface.glsl:96-118), with a
        fallback frame where the UVs are degenerate, and the UV density
        (texture UV units per world unit) that turns the ray cone's world
        footprint into texels."""
        dev = self.device
        m = {k: torch.as_tensor(np.asarray(materials[k], np.float32), device=dev)
             for k in ("base_color", "emissive", "metallic", "roughness",
                       "transmission", "ior", "absorbance")}
        mat_f = torch.cat([m["base_color"][:, :3], m["emissive"], m["metallic"][:, None],
                           m["roughness"][:, None], m["transmission"][:, None],
                           m["ior"][:, None], m["absorbance"]], dim=-1)  # (M,13)
        n_mat = mat_f.shape[0]
        cutoffs = torch.as_tensor(np.asarray(materials.get("alpha_cutoff", np.full(n_mat, -1.0)),
                                             np.float32), device=dev)
        mat = tri["mat"].long()
        gn, e1, e2 = tri["gn"], tri["e1"], tri["e2"]
        # rounded as XLA:CPU rounds the JAX package's jitted pack: its
        # two-product differences and cross products fused (fma, cross3),
        # its norms as vector_norm's
        norm = partial(torch.linalg.vector_norm, dim=-1, keepdim=True)
        uv3 = tri["uv"]
        du1, du2, det = _uv_derivatives(uv3)
        ok = det.abs() > 1e-12
        rdet = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)[:, None]
        tan = fma(e1, du2[:, 1:2], -(e2 * du1[:, 1:2])) * rdet
        bit = fma(e2, du1[:, 0:1], -(e1 * du2[:, 0:1])) * rdet
        axis = torch.where(gn[:, :1].abs() < 0.9, gn.new_tensor([[1.0, 0.0, 0.0]]),
                           gn.new_tensor([[0.0, 1.0, 0.0]]))
        fb = cross3(gn, axis)
        tl = norm(tan)
        tan = torch.where((tl > 1e-12) & ok[:, None], tan / torch.clamp(tl, min=1e-12), fb)
        bl = norm(bit)
        bit = torch.where((bl > 1e-12) & ok[:, None], bit / torch.clamp(bl, min=1e-12),
                          cross3(gn, fb))
        tan_u, bit_u = compress_normal_t(tan), compress_normal_t(bit)
        uvden = uv_density(uv3, e1, e2)
        n_u = tri["n"]
        shade = (torch.as_tensor(MeshShading.ROW_DEFAULT, device=dev).expand(mat.shape[0], 10)
                 if slot_shading is None
                 else torch.as_tensor(np.asarray(slot_shading, np.float32), device=dev))

        def col(a):
            return a.to(torch.float32)[:, None]

        base = torch.cat([gn, (n_u & 0xFFFF).to(torch.float32), (n_u >> 16).to(torch.float32),
                          mat_f[mat]], dim=-1)
        surf = torch.cat([uv3.reshape(-1, 6), col(mat), col(m["base_color"][:, 3][mat]),
                          col(cutoffs[mat])], dim=-1)
        ext = torch.cat([col(tan_u & 0xFFFF), col(tan_u >> 16), col(bit_u & 0xFFFF),
                         col(bit_u >> 16), col(uvden), shade], dim=-1)
        return base.contiguous(), surf.contiguous(), ext.contiguous()

    # -- settings with reset semantics (ref: PathTracer.cs setters) -------
    def _use_settings(self, settings: PathTracerSettings):
        self.settings = settings
        # sky colours as device vectors, made once (not per bounce)
        self._sky_zenith = torch.tensor(settings.sky_zenith, device=self.device)
        self._sky_horizon = torch.tensor(settings.sky_horizon, device=self.device)

    def set_settings(self, **kw):
        self._use_settings(replace(self.settings, **kw))
        self.reset_accumulation()

    def reset_accumulation(self):
        """ref: PathTracer ResetAccumulation on camera/scene change."""
        self.accum.zero_()
        self.accum_lum2.zero_()
        self.accumulated_samples = 0

    def set_slot_shading(self, slot_shading):
        """Live per-mesh override update: rewrite the shading channels in
        place (the reference edits GpuMesh fields from the Gui and
        re-uploads the mesh buffer). slot_shading: (n_slots, 10)
        MeshShading rows."""
        rows = torch.as_tensor(np.asarray(slot_shading, np.float32), device=self.device)
        self._attr_ext[:rows.shape[0], _SHADE:_SHADE + 10] = rows
        self._has_mesh_shading = self._shading_differs(slot_shading)
        self.reset_accumulation()

    # ----------------------------------------------------------------
    def _sky(self, d):
        s = self.settings
        if s.use_env_map and self.env_map is not None:
            # bilinear equirect lookup (the reference samples its skybox
            # with hardware bilinear); phi wraps, theta clamps at the poles
            env = self.env_map
            h, w = env.shape[0], env.shape[1]
            theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
            phi = torch.atan2(d[..., 2], d[..., 0])
            fx = (phi / (2 * np.pi) + 0.5) * w - 0.5
            fy = torch.clamp(theta / np.pi * h - 0.5, 0.0, h - 1.0)
            x0 = torch.floor(fx).long()
            y0 = torch.floor(fy).long()
            tx = (fx - x0)[..., None]
            ty = (fy - y0)[..., None]
            x0 = torch.remainder(x0, w)
            x1 = torch.remainder(x0 + 1, w)
            y1 = torch.clamp(y0 + 1, max=h - 1)
            flat = env.reshape(-1, 3)
            top = _mix(flat[y0 * w + x0], flat[y0 * w + x1], tx)
            bot = _mix(flat[y1 * w + x0], flat[y1 * w + x1], tx)
            return _mix(top, bot, ty) * s.sky_strength
        t = torch.clamp(d[..., 1] * 0.5 + 0.5, 0.0, 1.0)[..., None]
        return (self._sky_horizon * (1.0 - t) + self._sky_zenith * t) * s.sky_strength

    def _ray_sort_key(self, o, d, alive):
        """Direction octant (3 bits) << 24 | Morton cell of the origin; dead
        rays sort last."""
        scene_lo = self.scene.node_min[0]
        scene_ext = self.scene.node_max[0] - scene_lo
        q = torch.clamp((o - scene_lo) / torch.clamp(scene_ext, min=1e-6) * 256.0,
                        0.0, 255.0).to(torch.int64)
        cell = ((_morton_spread(q[:, 0]) << 2) | (_morton_spread(q[:, 1]) << 1)
                | _morton_spread(q[:, 2]))
        pos = (d >= 0).to(torch.int64)
        octant = pos[:, 0] + 2 * pos[:, 1] + 4 * pos[:, 2]
        return torch.where(alive, (octant << 24) | cell, _DEAD_KEY)

    # -- alpha test (ref: FirstHit/compute.glsl:141-146,
    # ShadowsRayTraced/compute.glsl:96-117) -----------------------------
    def _alpha_keep(self, hit, state):
        """Stochastic alpha test at each ray's hit: MASK materials keep where
        alpha >= cutoff, BLEND keeps with probability alpha, OPAQUE always
        keeps. Draws one uniform for every ray."""
        su = torch.index_select(self._attr_surf, 0, torch.clamp(hit.slot, min=0).long())
        wb = 1.0 - hit.u - hit.v
        uv = torch.stack([_bary(su[:, 0], su[:, 2], su[:, 4], wb, hit.u, hit.v),
                          _bary(su[:, 1], su[:, 3], su[:, 5], wb, hit.u, hit.v)], -1)
        a = su[:, _ALPHA]
        cut = su[:, _CUTOFF]
        if self._has_textures:
            layer = self.mats["base_layer"][su[:, _MAT].long()]
            a = a * sample_atlas(self.mats["atlas"], layer, uv)[:, 3]
        state, u_a = rng.uniform(state)
        keep = torch.where(cut < 0.0, True, torch.where(cut > 0.0, a >= cut, u_a < a))
        return state, keep

    def _closest_alpha(self, closest, state, o, d, t_max, tag: str):
        """Closest hit with up to alpha_rounds stochastic re-traces past
        alpha-discarded surfaces; t stays measured from o. A hit kept in an
        earlier round is never re-tested (re-rolling a BLEND keep each round
        would make alpha=a surfaces behave like a^alpha_rounds). Rays that
        are not re-traced go to the trace dead (t_max = -1). `closest`
        returns (Hit, instance id or None); so does this, with the hit.
        The first trace carries the call site's `tag`, the re-traces
        tag + "a", as the JAX package tags them."""
        hit, inst = closest(self.scene, o, d, t_max, tag=tag)
        if not self._has_alpha:
            return state, hit, inst
        t_base = torch.zeros_like(t_max)
        o_cur = o
        settled = torch.zeros(t_max.shape, dtype=torch.bool, device=o.device)
        with pass_scope("pt/alpha re-traces"):
            for _ in range(self.alpha_rounds):
                state, keep = self._alpha_keep(hit, state)
                has = hit.slot >= 0
                redo = has & ~keep & ~settled
                settled = settled | (has & keep)
                adv = _advance(hit.t)
                o_cur = torch.where(redo[..., None], fma(d, adv[..., None], o_cur), o_cur)
                t_base = torch.where(redo, t_base + adv, t_base)
                tm_rel = torch.where(redo, t_max - t_base, -1.0)
                h2, i2 = closest(self.scene, o_cur.contiguous(), d, tm_rel, tag=tag + "a")
                hit = Hit(*(torch.where(redo, new, old) for new, old in zip(h2, hit)))
                if inst is not None:
                    inst = torch.where(redo, i2, inst)
        return state, hit._replace(t=t_base + hit.t), inst

    def _shadow_occluded(self, closest, occluded, state, o, d, t_max, tag: str):
        """Occlusion with alpha transparency: alpha_rounds closest traces,
        each passing the surfaces the alpha test discards, then a
        conservative any-hit tail for anything still blocking. Without
        alpha one any-hit trace tagged `tag`; with it every trace tagged
        tag + "a", as the JAX package tags them."""
        if not self._has_alpha:
            return state, occluded(self.scene, o, d, t_max, tag=tag)
        occ = torch.zeros(t_max.shape, dtype=torch.bool, device=o.device)
        t_base = torch.zeros_like(t_max)
        o_cur = o
        active = t_max > 0.0
        with pass_scope("pt/shadow alpha rounds"):
            for _ in range(self.alpha_rounds):
                tm_rel = torch.where(active, t_max - t_base, -1.0)
                h, _ = closest(self.scene, o_cur.contiguous(), d, tm_rel, tag=tag + "a")
                hitm = active & (h.slot >= 0)
                state, keep = self._alpha_keep(h, state)
                occ = occ | (hitm & keep)
                active = hitm & ~keep
                adv = _advance(h.t)
                o_cur = torch.where(active[..., None], fma(d, adv[..., None], o_cur), o_cur)
                t_base = torch.where(active, t_base + adv, t_base)
        tm_rel = torch.where(active, t_max - t_base, -1.0)
        return state, occ | occluded(self.scene, o_cur.contiguous(), d, tm_rel, tag=tag + "a")

    def _trace_functions(self):
        """(closest, occluded) of this tracer's settings, each called as
        fn(scene, o, d, t_max, tag=...) with the call site's tag: closest
        returns (Hit, instance id or None), occluded a bool per ray."""
        s = self.settings
        cap = None if s.max_trace_steps == _NO_MAX_STEPS else s.max_trace_steps
        iset = self.instances
        if iset is not None:
            def closest(scene, o, d, t_max, tag):
                return trace_closest_two_level(scene, iset.scenes, iset.inv, iset.boxes, o, d,
                                               t_max, slot_off=iset.slot_off, max_steps=cap,
                                               tag=tag)

            def occluded(scene, o, d, t_max, tag):
                return trace_any_two_level(scene, iset.scenes, iset.inv, iset.boxes, o, d, t_max,
                                           max_steps=cap, tag=tag)
            return closest, occluded
        one, occluded = trace_closest, trace_any
        if s.use_two_phase:
            one, occluded = two_phase_closest, two_phase_any
        elif s.tile_size or cap is not None:
            one = partial(_trace_closest_tiled, tile=s.tile_size, max_steps=cap)
            occluded = partial(trace_any, max_steps=cap)

        def closest(scene, o, d, t_max, tag):
            return one(scene, o, d, t_max, tag=tag), None
        return closest, occluded

    def _render_sample(self, cam_params: dict, frame: int, rate_depth=None, pixels=None):
        """One sample of the frame: (radiance, albedo, normal, depth) in
        pixel order and the rays traced (a device scalar). `pixels`
        (start, stop) renders only that range of pixel indices, each ray
        keyed, generated and traced as in the whole frame (a shard,
        parallel/shard.py); rate_depth is the whole frame's."""
        s = self.settings
        w, h = self.width, self.height
        p0, p1 = (0, w * h) if pixels is None else pixels
        r = p1 - p0
        dev = self.device
        lights, mats = self.lights, self.mats
        use_surf = self._has_textures or self._has_normal_maps
        use_ext = use_surf or self._has_mesh_shading
        closest, occluded_fn = self._trace_functions()
        env_tables = self._env_tables

        with pass_scope("pt/raygen"):
            pixel_of = torch.arange(p0, p1, device=dev)  # ray i belongs to pixel pixel_of[i]
            state = rng.init_state(pixel_of, frame)
            # subpixel jitter + thin lens
            state, u_pix = rng.uniform2(state)
            state, u_lens = rng.uniform2(state)
            o, d = generate_rays(cam_params, w, h, u_pix, u_lens, fused=True, pixels=pixel_of)

            radiance = torch.zeros((r, 3), device=dev)
            throughput = torch.ones((r, 3), device=dev)
            alive = torch.ones(r, dtype=torch.bool, device=dev)
            inside = torch.zeros(r, dtype=torch.bool, device=dev)
            # last bounce was delta-like (primary/specular/transmissive): BSDF
            # light hits count only then, NEE covers the diffuse paths
            last_delta = torch.ones(r, dtype=torch.bool, device=dev)
            aov_albedo = torch.zeros((r, 3), device=dev)
            aov_normal = torch.zeros((r, 3), device=dev)
            aov_depth = torch.zeros(r, device=dev)
            rays_traced = torch.zeros((), dtype=torch.int64, device=dev)
            # ray-cone footprint for the texture LOD: one pixel wide at the
            # camera, widened by the distance travelled and by roughness at
            # each bounce (tracked for textured scenes only)
            track_cone = self._has_textures
            if track_cone:
                with pass_scope("pt/camera upload"):
                    up = torch.as_tensor(cam_params["up"], dtype=torch.float32, device=dev)
                t_acc = torch.zeros(r, device=dev)
                spread = (2.0 * torch.linalg.vector_norm(up) / h).expand(r).clone()
            # per-pixel bounce budget (the adaptive classifier's output)
            rd = (None if rate_depth is None else
                  torch.as_tensor(rate_depth).reshape(w * h)[p0:p1].to(dev, torch.int64))
            # with env NEE on, NEE owns the diffuse direct env term
            env_owns = s.env_nee and env_tables is not None

        for bounce in range(s.ray_depth):
            with pass_scope("pt/bounce", bounce):
                if s.do_ray_sorting and bounce > 0:
                    # permute the whole ray state once; it stays sorted, and
                    # the RNG state, cone and bounce budget travel with their ray
                    with pass_scope("pt/sort"):
                        perm = torch.sort(self._ray_sort_key(o, d, alive)).indices
                        fcols = [o, d, radiance, throughput]
                        if track_cone:
                            fcols += [t_acc[:, None], spread[:, None]]
                        fstate = torch.cat(fcols, dim=1)[perm]
                        o, d = fstate[:, 0:3].contiguous(), fstate[:, 3:6].contiguous()
                        radiance, throughput = fstate[:, 6:9], fstate[:, 9:12]
                        if track_cone:
                            t_acc, spread = fstate[:, 12], fstate[:, 13]
                        flags = (alive.long() | (inside.long() << 1) | (last_delta.long() << 2))
                        icols = [state, pixel_of, flags] + ([] if rd is None else [rd])
                        istate = torch.stack(icols, dim=1)[perm]
                        state, pixel_of, flags = istate[:, 0], istate[:, 1], istate[:, 2]
                        if rd is not None:
                            rd = istate[:, 3]
                        alive, inside, last_delta = ((flags & 1) != 0, (flags & 2) != 0,
                                                     (flags & 4) != 0)
                with pass_scope("pt/closest"):
                    rays_traced = rays_traced + alive.sum()
                    t_max = torch.where(alive, 3.4e38, -1.0)
                    state, hit, hit_inst = self._closest_alpha(closest, state, o, d, t_max,
                                                               "pri" if bounce == 0 else "bnc")

                # analytic light spheres (ref: BVHIntersect.glsl:189-203 traces
                # lights before the BLAS)
                with pass_scope("pt/lights"):
                    light_t = torch.full((r,), 3.4e38, device=dev)
                    light_id = torch.full((r,), -1, dtype=torch.int64, device=dev)
                    if s.light_spheres:
                        for li in range(self.n_lights):
                            lh, lt = ray_sphere(o, d, lights["pos"][li], lights["radius"][li])
                            closer = lh & (lt < light_t)
                            light_t = torch.where(closer, lt, light_t)
                            light_id = torch.where(closer, li, light_id)

                    hit_tri = alive & (hit.slot >= 0) & (hit.t < light_t)
                    hit_light = alive & (light_id >= 0) & ~hit_tri
                    miss = alive & ~hit_tri & ~hit_light

                    # miss: sky (with env NEE only on delta-like paths)
                    sky_mask = (miss & last_delta) if env_owns else miss
                    radiance = radiance + torch.where(sky_mask[..., None],
                                                      throughput * self._sky(d), 0.0)
                    # light hit: emitted radiance; with NEE on only delta-like paths
                    # collect it (NEE owns the diffuse direct term)
                    if s.light_spheres and self.n_lights > 0:
                        l_emit = lights["radiance"][torch.clamp(light_id, min=0)]
                        count_hit = hit_light & (last_delta | (not s.nee))
                        radiance = radiance + torch.where(count_hit[..., None],
                                                          throughput * l_emit, 0.0)

                with pass_scope("pt/shade"):
                    # surface hit: one row gather of the packed slot attributes
                    slot = torch.clamp(hit.slot, min=0).long()
                    u_b, v_b = hit.u, hit.v
                    w_b = 1.0 - u_b - v_b
                    af = torch.index_select(self._attr_base, 0, slot)
                    su = torch.index_select(self._attr_surf, 0, slot) if use_surf else None
                    ax = torch.index_select(self._attr_ext, 0, slot) if use_ext else None

                    def bits(a, lo, hi, n=1):
                        return (a[:, hi:hi + n].long() << 16) | a[:, lo:lo + n].long()

                    n_c = decompress_normal(bits(af, _N_LO, _N_HI, 3))  # (R,3 corners,3)
                    ns = _normalize(_bary(n_c[:, 0], n_c[:, 1], n_c[:, 2], w_b[..., None],
                                          u_b[..., None], v_b[..., None]))
                    gn = af[:, _GN:_GN + 3]
                    if hit_inst is not None:
                        # an instance's attributes are local-space: turn them by its
                        # normal matrix (ref: the TLAS path's normals to world space)
                        nm_i = self.instances.normal_mat[torch.clamp(hit_inst, min=0).long()]
                        rot = (hit_inst >= 0)[..., None]
                        gn = torch.where(rot, _normalize(linear_map(nm_i, gn)), gn)
                        ns = torch.where(rot, _normalize(linear_map(nm_i, ns)), ns)
                    # face-forward against the incoming ray
                    gn = torch.where(((gn * d).sum(-1) > 0.0)[..., None], -gn, gn)
                    ns = torch.where((ns * gn).sum(-1, keepdim=True) < 0.0, -ns, ns)

                    if use_surf:
                        uv = torch.stack([_bary(su[:, 0], su[:, 2], su[:, 4], w_b, u_b, v_b),
                                          _bary(su[:, 1], su[:, 3], su[:, 5], w_b, u_b, v_b)], -1)
                        mat_id = su[:, _MAT].long()
                    lod = None
                    if track_cone:
                        # ray-cone LOD: world footprint -> UV texels through the
                        # triangle's UV density, log2 to a mip level (ref: TAA
                        # recommends a LOD bias, TAAResolve.cs:76-80)
                        texel = (spread * (t_acc + hit.t) * ax[:, _UVDEN]
                                 * float(mats["atlas"].shape[1]))
                        lod = torch.log2(torch.clamp(texel, min=1.0)) + s.mip_bias
                    if self._has_normal_maps:
                        # tangent-space normal mapping (ref: Surface.glsl:96-118):
                        # TBN from the per-triangle UV frame, re-orthogonalised
                        # against the interpolated shading normal
                        with pass_scope("pt/textures"):
                            nl = mats["normal_layer"][mat_id]
                            tan = decompress_normal(bits(ax, _TAN_LO, _TAN_HI))[:, 0]
                            bit = decompress_normal(bits(ax, _BIT_LO, _BIT_HI))[:, 0]
                            if hit_inst is not None:
                                tan = torch.where(rot, linear_map(nm_i, tan), tan)
                                bit = torch.where(rot, linear_map(nm_i, bit), bit)
                            tan = _normalize(tan - ns * (tan * ns).sum(-1, keepdim=True))
                            bit = _normalize(bit - ns * (bit * ns).sum(-1, keepdim=True))
                            ntan = sample_atlas(mats["atlas"], nl, uv, lod)[:, :3] * 2.0 - 1.0
                            pert = _normalize(tan * ntan[:, 0:1] + bit * ntan[:, 1:2]
                                              + ns * torch.clamp(ntan[:, 2:3], min=0.05))
                            pert = torch.where((pert * gn).sum(-1, keepdim=True) < 0.0, -pert, pert)
                            if self._has_mesh_shading:
                                # per-mesh NormalMapStrength: lerp back toward the
                                # interpolated normal (ref: FirstHit/compute.glsl:153)
                                pert = _normalize(ns + (pert - ns) * ax[:, _SHADE + 1:_SHADE + 2])
                            ns = torch.where((nl >= 0)[..., None], pert, ns)

                    albedo = af[:, _ALBEDO:_ALBEDO + 3]
                    emissive = af[:, _EMISSIVE:_EMISSIVE + 3]
                    metallic = af[:, _METALLIC]
                    roughness = af[:, _ROUGH]
                    transmission = af[:, _TRANS]
                    ior = af[:, _IOR]
                    absorb = af[:, _ABSORB:_ABSORB + 3]
                    if self._has_textures:
                        with pass_scope("pt/textures"):
                            atlas = mats["atlas"]
                            base, mr, em = (sample_atlas(atlas, mats[k][mat_id], uv, lod) for k in
                                            ("base_layer", "mr_layer", "emissive_layer"))
                            albedo = albedo * base[:, :3]
                            metallic = metallic * mr[:, 2]
                            roughness = roughness * mr[:, 1]
                            emissive = emissive * em[:, :3]
                    tint_on_trans = None
                    if self._has_mesh_shading:
                        # per-mesh overrides after texturing (ref: Surface.glsl:85-96
                        # SurfaceApplyModificatons)
                        sh = ax[:, _SHADE:_SHADE + 10]
                        emissive = fma(sh[:, 0:1], albedo, emissive)
                        metallic = torch.clamp(metallic + sh[:, 2], 0.0, 1.0)
                        roughness = torch.clamp(roughness + sh[:, 3], 0.0, 1.0)
                        transmission = torch.clamp(transmission + sh[:, 4], 0.0, 1.0)
                        ior = torch.clamp(ior + sh[:, 5], min=1.0)
                        absorb = torch.clamp(absorb + sh[:, 6:9], min=0.0)
                        tint_on_trans = sh[:, 9] > 0.5

                    if bounce == 0:
                        aov_albedo = torch.where(hit_tri[..., None], albedo, aov_albedo)
                        aov_normal = torch.where(hit_tri[..., None], ns, aov_normal)
                        aov_depth = torch.where(hit_tri, hit.t, aov_depth)

                    # Beer–Lambert absorbance through the medium
                    # (ref: FirstHit/compute.glsl:179-183)
                    seg = torch.clamp(hit.t, max=1e30)
                    att = torch.exp(-absorb * torch.where(inside, seg, 0.0)[..., None])
                    throughput = torch.where(hit_tri[..., None], throughput * att, throughput)
                    radiance = radiance + torch.where(hit_tri[..., None], throughput * emissive,
                                                      0.0)

                    hp_point = o + d * hit.t[..., None]
                    eps_o = 1e-4 * torch.clamp(torch.linalg.vector_norm(hp_point, dim=-1), min=1.0)

                # next-event estimation: one light per ray, one shadow ray
                # (solid-angle sampling, ref: Sampling.glsl + ShadowsRayTraced)
                if s.nee and s.light_spheres and self.n_lights > 0:
                    with pass_scope("pt/nee"):
                        state, u_pick = rng.uniform(state)
                        li = torch.clamp((u_pick * self.n_lights).long(), max=self.n_lights - 1)
                        l_pos = lights["pos"][li]
                        l_rad = lights["radius"][li]
                        l_emit = lights["radiance"][li]
                        state, u_l = rng.uniform2(state)
                        ldir, lpdf, _ = sampling.sphere_light_sample(hp_point, l_pos, l_rad, u_l)
                        cos_s = torch.clamp((ns * ldir).sum(-1), min=0.0)
                        # distance to the sphere surface along ldir
                        sh_hit, sh_t = ray_sphere(hp_point, ldir, l_pos, l_rad)
                        do_nee = hit_tri & (cos_s > 0.0) & sh_hit
                        rays_traced = rays_traced + do_nee.sum()
                        sh_tmax = torch.where(do_nee, sh_t - 2.0 * eps_o, -1.0)
                        sh_o = hp_point + gn * eps_o[..., None]
                        state, occluded = self._shadow_occluded(
                            closest, occluded_fn, state, sh_o.contiguous(), ldir.contiguous(),
                            sh_tmax, "nee")
                        # full GGX BRDF (diffuse + rough specular); near-delta
                        # specular and transmission are left to BSDF sampling
                        brdf_cos = shading.ggx_brdf(ns, -d, ldir, albedo, metallic, roughness)
                        brdf_cos = brdf_cos * (1.0 - transmission)[..., None]
                        contrib = (throughput * brdf_cos * l_emit
                                   / torch.clamp(lpdf, min=1e-8)[..., None] * float(self.n_lights))
                        radiance = radiance + torch.where((do_nee & ~occluded)[..., None], contrib,
                                                          0.0)

                # next-event estimation toward the environment map: the alias
                # table draws a bright texel and a shadow ray (unbounded) tests
                # the sky's visibility
                if s.nee and env_owns:
                    with pass_scope("pt/env nee"):
                        state, u_e1 = rng.uniform(state)
                        state, u_e2 = rng.uniform(state)
                        state, u_ej = rng.uniform2(state)
                        edir, epdf = envsample.sample(env_tables, u_e1, u_e2, u_ej)
                        cos_e = torch.clamp((ns * edir).sum(-1), min=0.0)
                        do_enee = hit_tri & (cos_e > 0.0) & (epdf > 0.0)
                        e_tmax = torch.where(do_enee, 3.4e38, -1.0)
                        rays_traced = rays_traced + do_enee.sum()
                        e_o = (hp_point + gn * eps_o[..., None]).contiguous()
                        state, occluded_e = self._shadow_occluded(closest, occluded_fn, state, e_o,
                                                                  edir.contiguous(), e_tmax, "env")
                        brdf_e = shading.ggx_brdf(ns, -d, edir, albedo, metallic, roughness)
                        brdf_e = brdf_e * (1.0 - transmission)[..., None]
                        contrib_e = (throughput * brdf_e * self._sky(edir)
                                     / torch.clamp(epdf, min=1e-8)[..., None])
                        radiance = radiance + torch.where((do_enee & ~occluded_e)[..., None],
                                                          contrib_e, 0.0)

                with pass_scope("pt/shade"):
                    state, u_lobe = rng.uniform(state)
                    state, u_dir = rng.uniform2(state)
                    # transmission tint (ref: Shading.glsl:136-144): albedo when
                    # entering or volumetric, unless the mesh's TintOnTransmissive
                    # flag clears it
                    wants_tint = (absorb > 0.0).any(dim=-1) | ~inside
                    if tint_on_trans is not None:
                        wants_tint = wants_tint & tint_on_trans
                    trans_tint = torch.where(wants_tint[..., None], albedo, 1.0)
                    surf = shading.sample_bsdf(d, ns, albedo, metallic, roughness, transmission,
                                               ior, inside, u_lobe, u_dir, trans_tint=trans_tint)
                    side = torch.where(surf.is_transmissive[..., None], -gn, gn)
                    o = torch.where(hit_tri[..., None], hp_point + side * eps_o[..., None], o)
                    d = torch.where(hit_tri[..., None], surf.direction, d)
                    throughput = torch.where(hit_tri[..., None], throughput * surf.throughput_mul,
                                             throughput)
                    inside = torch.where(hit_tri & surf.is_transmissive, ~inside, inside)
                    if track_cone:
                        t_acc = t_acc + torch.where(hit_tri, hit.t, 0.0)
                        spread = spread + torch.where(hit_tri, 0.35 * roughness, 0.0)
                    # delta-like only when the specular lobe is mirror-sharp; rough
                    # specular is covered by the NEE GGX term
                    last_delta = (surf.is_specular & (roughness < 0.15)) | surf.is_transmissive
                    alive = hit_tri

                    # russian roulette (ref: include/RussianRoulette.glsl)
                    if s.russian_roulette and bounce >= s.rr_min_bounce:
                        p = torch.clamp(throughput.amax(dim=-1), 0.02, 1.0)
                        state, u_rr = rng.uniform(state)
                        throughput = throughput / p[..., None]
                        alive = alive & (u_rr < p)
                    # the bounce budget of the next bounce
                    if rd is not None and bounce + 1 < s.ray_depth:
                        alive = alive & (bounce + 1 < rd)

        if s.do_ray_sorting and s.ray_depth > 1:
            with pass_scope("pt/accumulate"):
                # back to pixel order
                radiance = torch.empty_like(radiance).index_copy_(0, pixel_of - p0, radiance)
        return radiance, aov_albedo, aov_normal, aov_depth, rays_traced

    # ----------------------------------------------------------------
    def render_frame(self, camera: Camera, rate_depth=None) -> torch.Tensor:
        """Trace spp_per_frame samples and fold them into the running average
        (ref: FinalDraw/compute.glsl accumulation). Returns image().

        rate_depth: optional (H*W,) int per-pixel bounce budget, in pixel
        order (the adaptive classifier's output)."""
        return self._render_frame(self._render_sample, camera, rate_depth)

    def _render_frame(self, sample, camera: Camera, rate_depth=None) -> torch.Tensor:
        """render_frame with `sample` in the place of _render_sample (same
        arguments and outputs; the sharded sample of parallel/shard.py)."""
        s = self.settings
        if (s.use_env_map and s.env_nee and self.env_map is not None
                and self._env_tables is None):
            # settings switched on after construction (set_settings)
            self._env_tables = envsample.EnvSampler(self.env_map.cpu().numpy(),
                                                    device=self.device).tables
        cam_params = camera.ray_params(self.width, self.height)
        with pass_scope("pt/frame", self._frame):
            for _ in range(s.spp_per_frame):
                radiance, alb, nrm, dep, nrays = sample(cam_params, self._frame, rate_depth)
                with pass_scope("pt/accumulate"):
                    n = self.accumulated_samples
                    self.accum = (self.accum * n + radiance) / (n + 1)
                    lum = (radiance[:, 0] * 0.2126 + radiance[:, 1] * 0.7152
                           + radiance[:, 2] * 0.0722)
                    self.accum_lum2 = (self.accum_lum2 * n + lum * lum) / (n + 1)
                    self.accumulated_samples = n + 1
                    self._frame += 1
                    self._last_aovs = (alb, nrm, dep)
                    # rays traced (closest + shadow) by the frame's last
                    # sample; a device scalar, float() to read
                    self.last_rays_traced = nrays.float()
        return self.image()

    def image(self) -> torch.Tensor:
        """(H,W,3) accumulated linear radiance."""
        return self.accum.reshape(self.height, self.width, 3)

    def variance(self) -> torch.Tensor:
        """(H,W) per-pixel variance of the accumulated MEAN luminance:
        (E[l^2] - E[l]^2) / n."""
        n = max(self.accumulated_samples, 1)
        mean_l = self.accum[:, 0] * 0.2126 + self.accum[:, 1] * 0.7152 + self.accum[:, 2] * 0.0722
        v = torch.clamp(self.accum_lum2 - mean_l * mean_l, min=0.0) / n
        return v.reshape(self.height, self.width)
