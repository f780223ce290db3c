"""Materials and shading: the fragment-stage equivalent as tensor ops.

Torch twin of the JAX package's ``render/material.py``. The frame's
products are vertex tensors, so "shading" is a function over the grid mesh
producing per-vertex colours, which a rasterizer consumes downstream. The
pieces mirror the reference:

* :func:`surface_normals_from_heights` — central-difference normals with
  the per-face TBN (attachments.wgsl:51-107), from the tile height grids.
* :func:`default_color` — the reference's default material
  (attachments.wgsl:109-113: grey = height * 0.5).
* :func:`pbr_lighting` — bevy_pbr's Filament direct lighting for
  directional, point and spot lights (:func:`lambert_lighting` is the older
  stand-in).
* :func:`shade` — material + optional lighting + debug overlays (the
  pipeline-flag specialization of terrain_material.rs:174-227).

Custom materials are plain callables ``fn(ctx: ShadeContext) -> colors``.
A planar :class:`StandardMaterial` over :func:`albedo_material` runs inside
the mesh kernel instead (``ops/kernels.mesh_fused_shaded``, selected by
``render/pipeline.py``); everything here is plain PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from bevy_terrain_tpu_torch.ops.meshgen import GridMeshOutput
from bevy_terrain_tpu_torch.ops.params import FrameUniforms, StaticTerrainConfig
from bevy_terrain_tpu_torch.ops.refinement import RefinementOutput

# reference debug.wgsl:8-19
_INDEX_COLORS = np.array(
    [
        [1.0, 0.0, 0.0, 1.0],
        [0.0, 1.0, 0.0, 1.0],
        [0.0, 0.0, 1.0, 1.0],
        [1.0, 1.0, 0.0, 1.0],
        [1.0, 0.0, 1.0, 1.0],
        [0.0, 1.0, 1.0, 1.0],
    ],
    np.float32,
)

_FACE_UP = np.array(
    [
        [0.0, 1.0, 0.0],
        [0.0, 1.0, 0.0],
        [0.0, 0.0, -1.0],
        [0.0, 0.0, -1.0],
        [-1.0, 0.0, 0.0],
        [-1.0, 0.0, 0.0],
    ],
    np.float32,
)


def _const(a, like: torch.Tensor) -> torch.Tensor:
    """A float32 numpy constant on ``like``'s device."""
    return torch.as_tensor(np.asarray(a, np.float32), device=like.device)


@dataclasses.dataclass
class ShadeContext:
    """Everything a material sees (the fragment stage's inputs)."""

    mesh: GridMeshOutput
    tiles: RefinementOutput
    normals: torch.Tensor  # (F, G+1, G+1, 3) shading normals
    uniforms: FrameUniforms
    cfg: StaticTerrainConfig
    # attachment 0's texture size (attachments[0].size in the reference's
    # show_pixels, debug.wgsl:111-119)
    texture_size: int = 512
    # extra attachments sampled at the frame's morphed vertex uvs
    # (fragment.wgsl's sample_attachmentN / planar.wgsl sample_albedo):
    # {attachment_index: (F, G+1, G+1, C) f32 in [0, 1]}, filled by the frame
    # stage when set_shading(..., sample_attachments=(i, ...)) names them
    attachment_samples: Optional[dict] = None


def _grid_tiles(ctx: ShadeContext):
    """The tile list broadcast to the vertex grid: (side, lod, xy)."""
    F, G = ctx.cfg.tile_capacity, ctx.cfg.grid_size
    t = ctx.tiles
    side = t.tile_side[:F, None, None].expand(F, G + 1, G + 1)
    lod = t.tile_lod[:F, None, None].clamp(min=0).expand(F, G + 1, G + 1)
    xy = t.tile_xy[:F, None, None, :].expand(F, G + 1, G + 1, 2)
    return side, lod, xy


def _vertex_lookup(ctx: ShadeContext):
    """Per-vertex blend + atlas-tile lookup (fragment_info, fragment.wgsl:
    35-49) — shared by the data-lod and pixel debug views. Returns
    (blend_lod, blend_ratio, a_lod, a_xy, a_uv)."""
    from bevy_terrain_tpu_torch.ops import coords

    cfg = ctx.cfg
    side, lod, xy = _grid_tiles(ctx)
    view_distance = torch.linalg.vector_norm(
        ctx.mesh.positions - ctx.uniforms.view_world_position, dim=-1)
    blend_lod, blend_ratio = coords.compute_blend(view_distance, ctx.uniforms, cfg)
    if cfg.tile_tree_lod:
        _, a_lod, a_xy, a_uv = coords.lookup_best(
            ctx.uniforms.entries, ctx.uniforms.origins, side, lod, xy, ctx.mesh.uvs, cfg)
    else:
        _, a_lod, a_xy, a_uv = coords.lookup_tile(
            ctx.uniforms.entries, side, lod, xy, ctx.mesh.uvs, blend_lod, cfg)
    return blend_lod, blend_ratio, a_lod, a_xy, a_uv


def index_color(index: torch.Tensor) -> torch.Tensor:
    """debug.wgsl:8-19: palette colour mixed 20% toward grey."""
    c = _const(_INDEX_COLORS, index)[(index % 6).long()]
    return c + (0.6 - c) * 0.2


def surface_normals_from_heights(mesh: GridMeshOutput, tiles: RefinementOutput,
                                 uniforms: FrameUniforms, cfg: StaticTerrainConfig):
    """Central-difference surface normals on the vertex grid with the
    per-face TBN (attachments.wgsl:51-107).

    The reference taps 4 extra texels per fragment; on the grid layout the
    height differences come from the neighbouring vertices (spacing =
    tile_size / grid_size), clamped at tile edges.
    """
    F, G = cfg.tile_capacity, cfg.grid_size
    h = mesh.heights  # (F, G+1, G+1)

    def diff(dim):
        n = h.shape[dim]
        lo = torch.cat([h.narrow(dim, 0, 1), h.narrow(dim, 0, n - 1)], dim=dim)
        hi = torch.cat([h.narrow(dim, 1, n - 1), h.narrow(dim, n - 1, 1)], dim=dim)
        return hi - lo

    # world-space spacing between adjacent grid vertices
    lod = tiles.tile_lod[:F].clamp(min=0).to(torch.float32)
    if cfg.spherical:
        side_length = float(np.float32(np.pi / 4.0)) * uniforms.terrain_scale
    else:
        side_length = 2.0 * uniforms.terrain_scale
    spacing = (side_length / torch.exp2(lod) / G)[:, None, None]
    dh_du = diff(2) / (2.0 * spacing)
    dh_dv = diff(1) / (2.0 * spacing)

    if cfg.spherical:
        normal = mesh.normals
        face_up = _const(_FACE_UP, h)[tiles.tile_side[:F].long()][:, None, None, :]
        tangent = torch.linalg.cross(face_up.expand(normal.shape), normal)
        tangent = tangent / torch.clamp(
            torch.linalg.vector_norm(tangent, dim=-1, keepdim=True), min=1e-8)
        bitangent = torch.linalg.cross(normal, tangent)
    else:
        shape = mesh.normals.shape
        tangent = _const([1, 0, 0], h).expand(shape)
        bitangent = _const([0, 0, 1], h).expand(shape)
        normal = _const([0, 1, 0], h).expand(shape)
    n = -dh_du[..., None] * tangent - dh_dv[..., None] * bitangent + normal
    return n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-8)


def default_color(ctx: ShadeContext):
    """Reference default material: grey from height (attachments.wgsl:109-113)."""
    u = ctx.uniforms
    hn = (ctx.mesh.heights - u.min_height) / torch.clamp(u.max_height - u.min_height, min=1e-8)
    g = hn * 0.5
    return torch.stack([g, g, g, torch.ones_like(g)], dim=-1)


def lambert_lighting(colors, normals, light_direction=(0.4, 0.8, 0.45)):
    """Directional diffuse (kept for API compatibility; the default
    lighting stage is :func:`pbr_lighting`)."""
    light = np.asarray(light_direction, np.float32)
    light = light / np.linalg.norm(light)
    ndotl = torch.clamp(torch.sum(normals * _const(light, normals), dim=-1), 0.0, 1.0)
    lit = colors[..., :3] * (0.15 + 0.85 * ndotl[..., None])
    return torch.cat([lit, colors[..., 3:]], dim=-1)


# -- PBR lighting stage ------------------------------------------------------
#
# The reference composes bevy_pbr per pixel: fragment.wgsl:52-63 fills a
# PbrInput (base_color, perceptual_roughness = 1.0, reflectance = 0.0, N,
# V) and calls apply_pbr_lighting. bevy_pbr's direct-light model is the
# Filament metallic/roughness BRDF (pbr_lighting.wgsl: D_GGX,
# V_SmithGGXCorrelated, F_Schlick, Fd_Burley); the functions below are that
# model as batched tensor ops over the vertex grid. Tone mapping / camera
# exposure stay with the consuming rasterizer.


@dataclasses.dataclass(frozen=True)
class DirectionalLight:
    """A bevy DirectionalLight equivalent (direction TOWARD the scene;
    ``illuminance`` folds the light colour to linear [0, 1] scale).

    ``shadow`` is the slot where bevy_pbr multiplies in its shadow-map
    term: a callable ``fn(positions) -> (..., 1)`` factor in [0, 1] over
    world positions, supplied by the consuming renderer.
    """

    direction: tuple = (-0.4, -0.8, -0.45)
    color: tuple = (1.0, 1.0, 1.0)
    illuminance: float = 1.0
    shadow: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class PointLight:
    """bevy PointLight equivalent: omni light at ``position`` with
    Filament inverse-square distance attenuation windowed by ``range``
    (``saturate(1 - (d^2/range^2)^2)^2 / max(d^2, 1e-4)``). ``intensity`` is
    pre-folded to linear [0, 1] scale like DirectionalLight.illuminance."""

    position: tuple = (0.0, 0.0, 0.0)
    color: tuple = (1.0, 1.0, 1.0)
    intensity: float = 1.0
    range: float = 20.0
    shadow: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class SpotLight:
    """bevy SpotLight equivalent: a PointLight restricted to a cone. The
    cosine of the angle to ``direction`` is remapped by ``1/(cos_inner -
    cos_outer)``, saturated, then squared (angles in radians)."""

    position: tuple = (0.0, 0.0, 0.0)
    direction: tuple = (0.0, -1.0, 0.0)
    color: tuple = (1.0, 1.0, 1.0)
    intensity: float = 1.0
    range: float = 20.0
    inner_angle: float = 0.4
    outer_angle: float = 0.6
    shadow: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class StandardMaterial:
    """bevy_pbr StandardMaterial equivalent: a metallic/roughness surface
    over any base-colour source (``base_color``: ``fn(ctx) -> (F, G+1, G+1,
    4)``, default the reference grey-height).

    Defaults match the reference terrain fragment's PbrInput
    (fragment.wgsl:54-56: perceptual_roughness 1.0, reflectance 0.0).
    ``opaque_base_color``: the albedo's alpha is never read (the reference's
    examples never read it); the fused kernel then samples 3 channels and
    alpha comes out 1.
    """

    base_color: Optional[Callable] = None
    perceptual_roughness: float = 1.0
    metallic: float = 0.0
    reflectance: float = 0.0
    emissive: tuple = (0.0, 0.0, 0.0)
    lights: tuple = (DirectionalLight(),)
    ambient: tuple = (0.05, 0.05, 0.05)
    opaque_base_color: bool = False

    def __call__(self, ctx: ShadeContext):
        return (self.base_color or default_color)(ctx)


def _f_schlick(f0, f90, voh):
    return f0 + (f90 - f0) * torch.pow(1.0 - voh, 5.0)


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def _normalize(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-8)


def pbr_lighting(colors, normals, positions, view_world_position,
                 perceptual_roughness: float = 1.0, metallic: float = 0.0,
                 reflectance: float = 0.0, emissive=(0.0, 0.0, 0.0),
                 lights=(DirectionalLight(),), ambient=(0.05, 0.05, 0.05)):
    """Filament/bevy_pbr direct lighting for any mix of directional, point
    and spot lights: GGX specular (D_GGX * V_SmithGGXCorrelated *
    F_Schlick) + Burley diffuse per light, windowed inverse-square
    attenuation for point and spot lights, each light's optional ``shadow``
    hook multiplying its contribution, plus a flat ambient term on the
    diffuse colour. All colours linear [0, 1]."""
    base = colors[..., :3]
    alpha = colors[..., 3:]
    # pbr_functions.wgsl: calculate_diffuse_color / calculate_F0
    diffuse_color = base * (1.0 - metallic)
    f0 = 0.16 * reflectance * reflectance * (1.0 - metallic) + base * metallic
    # roughness.wgsl: clamp + perceptual -> alpha
    pr = float(np.clip(perceptual_roughness, 0.089, 1.0))
    roughness = pr * pr

    n = normals
    v = _normalize(view_world_position - positions)
    nov = torch.clamp(_dot(n, v), min=1e-4)

    out = _const(emissive, base) * torch.ones_like(base)
    for light in lights:
        if isinstance(light, (PointLight, SpotLight)):
            to_light = _const(light.position, base) - positions
            dist_sq = torch.clamp(_dot(to_light, to_light), min=1e-4)
            l = to_light / torch.sqrt(dist_sq)
            inv_range_sq = float(np.float32(1.0 / (light.range * light.range)))
            window = torch.clamp(1.0 - torch.square(dist_sq * inv_range_sq), 0.0, 1.0)
            atten = torch.square(window) / dist_sq
            if isinstance(light, SpotLight):
                sd = np.asarray(light.direction, np.float32)
                sd = sd / np.linalg.norm(sd)
                cos_outer = float(np.float32(np.cos(light.outer_angle)))
                spot_scale = float(np.float32(
                    1.0 / max(np.cos(light.inner_angle) - np.cos(light.outer_angle), 1e-4)))
                cos_angle = _dot(-l, _const(sd, base))
                spot = torch.clamp((cos_angle - cos_outer) * spot_scale, 0.0, 1.0)
                atten = atten * torch.square(spot)
            lc = np.asarray(light.color, np.float32) * np.float32(light.intensity)
            radiance = _const(lc, base) * atten
        else:
            d = np.asarray(light.direction, np.float32)
            l = _const(-d / np.linalg.norm(d), base)  # direction to the light
            lc = np.asarray(light.color, np.float32) * np.float32(light.illuminance)
            radiance = _const(lc, base)
        h = _normalize(l + v)
        nol = torch.clamp(_dot(n, l), 0.0, 1.0)
        noh = torch.clamp(_dot(n, h), 0.0, 1.0)
        loh = torch.clamp(_dot(h, l), 0.0, 1.0)

        # D_GGX (pbr_lighting.wgsl)
        a2 = roughness * roughness
        f = noh * noh * (a2 - 1.0) + 1.0
        d_ggx = a2 / torch.clamp(float(np.float32(np.pi)) * f * f, min=1e-8)
        # V_SmithGGXCorrelated
        lambda_v = nol * torch.sqrt((nov - a2 * nov) * nov + a2)
        lambda_l = nov * torch.sqrt((nol - a2 * nol) * nol + a2)
        v_smith = 0.5 / torch.clamp(lambda_v + lambda_l, min=1e-8)
        # F_Schlick with bevy's f90 = saturate(50 * 0.33 * sum(f0))
        f90 = torch.clamp(torch.sum(f0 * float(np.float32(50.0 * 0.33)), dim=-1, keepdim=True),
                          0.0, 1.0)
        fresnel = _f_schlick(f0, f90, loh)
        specular = d_ggx * v_smith * fresnel
        # Fd_Burley
        fd90 = 0.5 + 2.0 * roughness * loh * loh
        light_scatter = _f_schlick(1.0, fd90, nol)
        view_scatter = _f_schlick(1.0, fd90, nov)
        fd = light_scatter * view_scatter * float(np.float32(1.0 / np.pi))
        diffuse = diffuse_color * fd

        contrib = (diffuse + specular) * radiance * nol
        if getattr(light, "shadow", None) is not None:
            # the fetched shadow factor multiplies the whole contribution
            contrib = contrib * torch.clamp(light.shadow(positions), 0.0, 1.0)
        out = out + contrib
    out = out + diffuse_color * _const(ambient, base)
    return torch.cat([out, alpha], dim=-1)


def kernel_shade_spec(material: "StandardMaterial", alb_max: float):
    """The material of the IN-KERNEL fragment stage (kernels.mesh_fused_shaded,
    packed by kernels.pack_shade_spec): roughness, metallic, reflectance,
    emissive, ambient, the light list and the albedo's max value. None when
    the material needs the staged path (a per-light shadow hook)."""
    if not isinstance(material, StandardMaterial):
        return None
    lights = []
    for l in material.lights:
        if getattr(l, "shadow", None) is not None:
            return None
        if isinstance(l, SpotLight):
            lights.append(("spot", tuple(l.position), tuple(l.direction), tuple(l.color),
                           float(l.intensity), float(l.range), float(l.inner_angle),
                           float(l.outer_angle)))
        elif isinstance(l, PointLight):
            lights.append(("point", tuple(l.position), tuple(l.color), float(l.intensity),
                           float(l.range)))
        else:
            lights.append(("dir", tuple(l.direction), tuple(l.color), float(l.illuminance)))
    return (
        float(material.perceptual_roughness),
        float(material.metallic),
        float(material.reflectance),
        tuple(float(e) for e in material.emissive),
        tuple(float(a) for a in material.ambient),
        tuple(lights),
        float(alb_max),
    )


# the planar example's gradient2.png equivalent: a deep-water -> shallows ->
# grass -> rock -> snow ramp
DEFAULT_GRADIENT = np.array(
    [
        [0.02, 0.09, 0.28, 1.0],
        [0.05, 0.24, 0.45, 1.0],
        [0.22, 0.48, 0.35, 1.0],
        [0.38, 0.52, 0.26, 1.0],
        [0.52, 0.47, 0.30, 1.0],
        [0.55, 0.42, 0.32, 1.0],
        [0.58, 0.55, 0.52, 1.0],
        [0.78, 0.78, 0.80, 1.0],
        [0.95, 0.95, 0.97, 1.0],
    ],
    np.float32,
)


def gradient_material(gradient=None, exponent: float = 0.9):
    """The planar example's default material: a 1-D gradient texture
    sampled at ``pow(height, 0.9)`` (reference planar.wgsl sample_color).

    ``gradient``: (N, 4) float32 LUT in [0, 1]; linear-filtered,
    clamp-to-edge.
    """
    lut = np.asarray(DEFAULT_GRADIENT if gradient is None else gradient, np.float32)

    def material(ctx: ShadeContext):
        u = ctx.uniforms
        hn = torch.clamp(
            (ctx.mesh.heights - u.min_height)
            / torch.clamp(u.max_height - u.min_height, min=1e-8), 0.0, 1.0)
        x = torch.pow(hn, exponent) * (lut.shape[0] - 1)
        i0 = torch.clamp(torch.floor(x).to(torch.int32), 0, lut.shape[0] - 2)
        t = (x - i0.to(torch.float32))[..., None]
        table = _const(lut, hn)
        return table[i0.long()] * (1.0 - t) + table[i0.long() + 1] * t

    return material


class _AlbedoMaterial:
    """Callable base-colour source reading a sampled attachment (see
    :func:`albedo_material`). Carries ``attachment_index`` so the pipeline
    can recognise the packed-albedo path and fuse the material stage into
    the mesh kernel."""

    def __init__(self, attachment_index: int):
        self.attachment_index = attachment_index

    def __call__(self, ctx: ShadeContext):
        idx = self.attachment_index
        if not ctx.attachment_samples or idx not in ctx.attachment_samples:
            raise ValueError(f"albedo_material needs set_shading(sample_attachments="
                             f"({idx},)) so the frame stage samples it")
        c = ctx.attachment_samples[idx]
        if c.shape[-1] >= 4:
            return c[..., :4]
        pad = torch.ones(c.shape[:-1] + (4 - c.shape[-1],), dtype=c.dtype, device=c.device)
        return torch.cat([c, pad], dim=-1)

    def __hash__(self):
        return hash(("_AlbedoMaterial", self.attachment_index))

    def __eq__(self, other):
        return (isinstance(other, _AlbedoMaterial)
                and other.attachment_index == self.attachment_index)


def albedo_material(attachment_index: int = 1):
    """The planar example's ALBEDO branch: colour straight from the albedo
    attachment sampled at the morphed vertex uvs (planar.wgsl sample_albedo,
    attachments.wgsl:26-43). Needs ``Terrain.set_shading(material=...,
    sample_attachments=(attachment_index,))``; under a StandardMaterial the
    whole material stage runs in the mesh kernel (render/pipeline.py)."""
    return _AlbedoMaterial(attachment_index)


def show_geometry_lod(ctx: ShadeContext):
    """LOD checkerboard debug view with the reference's two red/green
    invariant checks (debug.wgsl:27-34, 56-94)."""
    cfg = ctx.cfg
    F, G = cfg.tile_capacity, cfg.grid_size
    lod = ctx.tiles.tile_lod[:F].clamp(min=0)
    xy = ctx.tiles.tile_xy[:F]
    color = index_color(lod)
    dark = ((xy[:, 0] + xy[:, 1]) % 2) == 0
    color = torch.where(dark[:, None], color * 0.5, color)
    if cfg.spherical:
        side_c = index_color(ctx.tiles.tile_side[:F])
        color = color + (side_c - color) * 0.3
    colors = color[:, None, None, :].expand(F, G + 1, G + 1, 4)

    # invariant overlays (debug.wgsl:80-92): per-vertex morph target lod
    view_distance = torch.linalg.vector_norm(
        ctx.mesh.positions - ctx.uniforms.view_world_position, dim=-1)
    target_lod = torch.log2(
        2.0 * ctx.uniforms.morph_distance / torch.clamp(view_distance, min=1e-6))
    lod_f = lod.to(torch.float32)[:, None, None]
    # "same tile overlaps two morph zones -> increase morph distance" (red)
    red = torch.clamp(target_lod, min=0.0) < lod_f - 1.0 + ctx.uniforms.morph_range
    # "tile has insufficient LOD -> increase morph tolerance" (green)
    green = torch.floor(target_lod) > lod_f
    colors = torch.where(red[..., None], _const([1, 0, 0, 1], colors), colors)
    return torch.where(green[..., None], _const([0, 1, 0, 1], colors), colors)


def show_uv(ctx: ShadeContext):
    """SHOW_UV debug view (fragment.wgsl:82-84)."""
    uv = ctx.mesh.uvs
    return torch.cat([uv, torch.zeros_like(uv[..., :1]), torch.ones_like(uv[..., :1])], dim=-1)


def show_normals(ctx: ShadeContext):
    """SHOW_NORMALS debug view (fragment.wgsl:85-87)."""
    return torch.cat([ctx.normals * 0.5 + 0.5, torch.ones_like(ctx.normals[..., :1])], dim=-1)


def show_tile_tree(ctx: ShadeContext):
    """Tile-tree debug view (debug.wgsl:95-109): checkerboard of the
    best-loaded lookup + window outlines from the tree uv."""
    from bevy_terrain_tpu_torch.ops import coords

    side, lod, xy = _grid_tiles(ctx)
    _, a_lod, a_xy, a_uv = coords.lookup_best(
        ctx.uniforms.entries, ctx.uniforms.origins, side, lod, xy, ctx.mesh.uvs, ctx.cfg)
    color = index_color(a_lod.clamp(min=0))
    dark = ((a_xy[..., 0] + a_xy[..., 1]) % 2) == 0
    color = torch.where(dark[..., None], color * 0.5, color)
    # window outlines (debug.wgsl:21-25) on the best lookup's uv
    thickness = 0.015
    inside = torch.all((a_uv > thickness) & (a_uv < 1.0 - thickness), dim=-1)
    return torch.where(inside[..., None], color, torch.full_like(color, 0.1))


def show_data_lod(ctx: ShadeContext):
    """SHOW_DATA_LOD view (debug.wgsl:37-54): checkerboard of the DATA lod
    actually sampled, crossfaded toward the parent by the blend ratio,
    darkened near the transition, side-tinted on spheres."""
    blend_lod, blend_ratio, a_lod, a_xy, _ = _vertex_lookup(ctx)
    a_lod = a_lod.clamp(min=0)
    if ctx.cfg.tile_tree_lod:  # debug.wgsl:38-42 #ifdef TILE_TREE_LOD
        ratio = torch.zeros_like(blend_ratio)
    else:
        ratio = torch.where(blend_lod == a_lod, blend_ratio, 0.0)
    # checker_color (debug.wgsl:27-34)
    color = index_color(a_lod)
    parent_color = index_color((a_lod - 1).clamp(min=0))
    dark = ((a_xy[..., 0] + a_xy[..., 1]) % 2) == 0
    pdark = (((a_xy[..., 0] >> 1) + (a_xy[..., 1] >> 1)) % 2) == 0
    color = torch.where(dark[..., None], color * 0.5, color)
    parent_color = torch.where(pdark[..., None], parent_color * 0.5, parent_color)
    color = color + (parent_color - color) * ratio[..., None]
    near = (ratio > 0.95) & (blend_lod == a_lod)
    color = torch.where(near[..., None], color * 0.2, color)
    if ctx.cfg.spherical:
        F = ctx.cfg.tile_capacity
        side_c = index_color(ctx.tiles.tile_side[:F])[:, None, None, :]
        color = color + (side_c.expand(color.shape) - color) * 0.3
    return color


def show_pixels(ctx: ShadeContext):
    """SHOW_PIXELS checkerboard of 4x4 atlas texel blocks
    (debug.wgsl:111-119); composed as a 50% overlay (fragment.wgsl:79-81)."""
    _, _, _, _, a_uv = _vertex_lookup(ctx)
    pixel = a_uv * (ctx.texture_size / 4.0)
    is_even = ((pixel[..., 0].to(torch.int32) + pixel[..., 1].to(torch.int32)) % 2) == 0
    grey = torch.where(is_even, 0.5, 0.1).to(torch.float32)[..., None]
    return torch.cat([grey.expand(grey.shape[:-1] + (3,)), torch.ones_like(grey)], dim=-1)


def wireframe_overlay(ctx: ShadeContext, colors):
    """Wireframe stand-in for the reference's polygon-mode toggle
    (terrain_material.rs:299-303): tile-border vertices darken strongly,
    every other vertex lightly."""
    G = ctx.cfg.grid_size
    i = np.arange(G + 1)
    edge_axis = ((i == 0) | (i == G)).astype(np.float32)
    edge = np.maximum.outer(edge_axis, edge_axis)  # tile border mask
    w = _const(0.25 + 0.75 * edge, colors)[None, :, :, None]
    return torch.cat([colors[..., :3] * (1.0 - 0.55 * w), colors[..., 3:]], dim=-1)


DEBUG_VIEWS = {
    "geometry_lod": show_geometry_lod,
    "data_lod": show_data_lod,
    "uv": show_uv,
    "normals": show_normals,
    "tile_tree": show_tile_tree,
    "pixels": show_pixels,  # composed as a 50% overlay in shade()
}


def shade(mesh: GridMeshOutput, tiles: RefinementOutput, uniforms: FrameUniforms,
          cfg: StaticTerrainConfig, material: Optional[Callable] = None,
          lighting: bool = True, debug_view=None, texture_size: int = 512,
          wireframe: bool = False, attachment_samples: Optional[dict] = None):
    """Fragment-stage composition (fragment.wgsl:95-113): material colour,
    PBR lighting, optional debug overlay. Returns (F, G+1, G+1, 4).

    ``lighting=True`` applies :func:`pbr_lighting`, with the material's
    parameters when ``material`` is a :class:`StandardMaterial`, else with
    the reference fragment's default PbrInput. ``debug_view="pixels"`` is a
    50% overlay composed after the replacing views (fragment.wgsl:69-81).
    """
    normals = surface_normals_from_heights(mesh, tiles, uniforms, cfg)
    ctx = ShadeContext(mesh=mesh, tiles=tiles, normals=normals, uniforms=uniforms, cfg=cfg,
                       texture_size=texture_size, attachment_samples=attachment_samples)
    colors = (material or default_color)(ctx)
    if lighting:
        params = {}
        if isinstance(material, StandardMaterial):
            params = dict(perceptual_roughness=material.perceptual_roughness,
                          metallic=material.metallic, reflectance=material.reflectance,
                          emissive=material.emissive, lights=material.lights,
                          ambient=material.ambient)
        colors = pbr_lighting(colors, normals, mesh.positions, uniforms.view_world_position,
                              **params)
    views = (debug_view,) if isinstance(debug_view, (str, type(None))) else debug_view
    for view in views:
        if view == "pixels":
            colors = colors + (show_pixels(ctx) - colors) * 0.5
        elif view is not None:
            colors = DEBUG_VIEWS[view](ctx)
    if wireframe:
        colors = wireframe_overlay(ctx, colors)
    return torch.where(mesh.tile_mask[:, None, None, None], colors, 0.0)
