"""Atlas texture sampling as explicit gathers — torch twin of the JAX
package's ``ops/sampling.py`` (attachments.wgsl).

The per-vertex mesh path and the device-side queries sample attachment
slabs, one ``(atlas_size, H, W, C)`` tensor per mip in the attachment's
native integer dtype (terrain_data/tile_atlas.py); normalisation to f32
happens here (the unorm semantics of the reference's texture formats), as
do the border-inset uv transform and clamp-to-edge.

:func:`query_heights` and :func:`query_attachment` are the host sampling
API's chain (terrain_data/sampling_api.py) batched over world positions on
the slab's device: plain torch ops (gathers), no hand-written kernel, as in
the JAX package. World-scale products are written out elementwise in f32 (no
matmul call, whose precision a TF32 switch lowers), and every 3-vector norm
as ``sqrt(x*x + y*y + z*z)``.
"""

from __future__ import annotations

import numpy as np
import torch

from bevy_terrain_tpu_torch.math.coordinate import (
    FACE_UV_DEN, FACE_UV_NUM, pick_cube_face, sigmoid_warp_forward,
)
from bevy_terrain_tpu_torch.ops import coords
from bevy_terrain_tpu_torch.ops.params import FrameUniforms, StaticTerrainConfig


def attachment_uv(uv, scale: float, offset: float):
    """Border-inset uv (attachments.wgsl:7-10)."""
    return uv * scale + offset


def slab_texels(slab: torch.Tensor, a, y, x) -> torch.Tensor:
    """``slab[a, y, x]`` as f32 (..., C). A uint16 slab is gathered through
    its int16 view, which every torch indexing kernel takes, and the sign
    bits are masked back."""
    if slab.dtype == torch.uint16:
        return (slab.view(torch.int16)[a, y, x].to(torch.int32) & 0xFFFF).to(torch.float32)
    return slab[a, y, x].to(torch.float32)


def sample_bilinear(slab: torch.Tensor, atlas_index, uv, max_value: float):
    """Bilinear clamp-to-edge sample of an atlas slab at mip 0.

    ``slab``: (A, H, W, C) integer tensor; ``atlas_index``: (...,) int32
    (-1 is invalid and returns 0, mirroring tile_atlas.rs:250-251); ``uv``:
    (..., 2) f32, already border-inset. Returns (..., C) f32 in [0, 1].
    """
    H, W = slab.shape[1], slab.shape[2]
    # pixel-centre convention of GPU samplers: uv * size - 0.5
    px = uv[..., 0] * W - 0.5
    py = uv[..., 1] * H - 0.5
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = (px - x0)[..., None]
    fy = (py - y0)[..., None]
    x0i = x0.to(torch.int32).clamp(0, W - 1).long()
    y0i = y0.to(torch.int32).clamp(0, H - 1).long()
    x1i = (x0i + 1).clamp(0, W - 1)
    y1i = (y0i + 1).clamp(0, H - 1)

    valid = (atlas_index >= 0)[..., None]
    a = atlas_index.clamp(min=0).long()

    v00 = slab_texels(slab, a, y0i, x0i)
    v10 = slab_texels(slab, a, y0i, x1i)
    v01 = slab_texels(slab, a, y1i, x0i)
    v11 = slab_texels(slab, a, y1i, x1i)

    top = v00 + (v10 - v00) * fx
    bot = v01 + (v11 - v01) * fx
    value = (top + (bot - top) * fy) / max_value
    return torch.where(valid, value, torch.zeros((), dtype=value.dtype, device=value.device))


def sample_height(slab, atlas_index, uv, uniforms: FrameUniforms, scale: float, offset: float):
    """Height sample: attachment 0, rescaled to [min_height, max_height]
    (attachments.wgsl:45-49)."""
    a_uv = attachment_uv(uv, scale, offset)
    h = sample_bilinear(slab, atlas_index, a_uv, 65535.0)[..., 0]
    return uniforms.min_height + (uniforms.max_height - uniforms.min_height) * h


def sample_trilinear(slabs, atlas_index, uv, mip_level, max_value: float):
    """Trilinear sample across a mip chain.

    ``slabs`` is a list of per-mip (A, H>>m, W>>m, C) tensors; ``mip_level``
    is a fractional f32 (...,). Implements textureSampleGrad's mip blend
    (attachments.wgsl:17, the SAMPLE_GRAD path).
    """
    n_mips = len(slabs)
    if n_mips == 1:
        return sample_bilinear(slabs[0], atlas_index, uv, max_value)
    level = mip_level.clamp(0.0, n_mips - 1.000001)
    lo = torch.floor(level).to(torch.int32)
    frac = (level - lo.to(torch.float32))[..., None]
    hi = (lo + 1).clamp(max=n_mips - 1)
    # gather both adjacent mips for every lane, select by level
    result_lo = torch.zeros(uv.shape[:-1] + (slabs[0].shape[-1],), dtype=torch.float32,
                            device=uv.device)
    result_hi = torch.zeros_like(result_lo)
    for m in range(n_mips):
        s = sample_bilinear(slabs[m], atlas_index, uv, max_value)
        result_lo = torch.where((lo == m)[..., None], s, result_lo)
        result_hi = torch.where((hi == m)[..., None], s, result_hi)
    return result_lo + (result_hi - result_lo) * frac


def mip_level_from_grad(uv_dx, uv_dy, texture_size: int):
    """Isotropic mip selection from uv screen derivatives (the GPU
    textureSampleGrad rule): level = log2(max gradient footprint)."""
    dx = uv_dx * texture_size
    dy = uv_dy * texture_size
    rho2 = torch.maximum(torch.sum(dx * dx, dim=-1), torch.sum(dy * dy, dim=-1))
    return 0.5 * torch.log2(rho2.clamp(min=1e-12))


# Per-side "up" used to build the cube-face TBN (attachments.wgsl:55-64).
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


def sample_normal(slab, atlas_index, side, lod, uv, vertex_normal, uniforms: FrameUniforms,
                  cfg: StaticTerrainConfig, scale: float, offset: float, texture_size: int):
    """Central-difference surface normal from 4 height taps with the
    per-face TBN (attachments.wgsl:51-107)."""
    a_uv = attachment_uv(uv, scale, offset)
    off = 0.5 / texture_size

    def tap(du, dv):
        h = sample_bilinear(slab, atlas_index, a_uv + _const([du, dv], a_uv), 65535.0)[..., 0]
        return uniforms.min_height + (uniforms.max_height - uniforms.min_height) * h

    left = tap(-off, 0.0)
    up = tap(0.0, -off)
    right = tap(off, 0.0)
    down = tap(0.0, off)

    if cfg.spherical:
        face_up = _const(_FACE_UP, uv)[side.long()]  # (..., 3)
        normal = vertex_normal / coords.norm3(vertex_normal)[..., None]
        tangent = torch.linalg.cross(face_up, normal)
        bitangent = torch.linalg.cross(normal, tangent)
        side_length = float(np.float32(3.14159265359 / 4.0)) * uniforms.terrain_scale
    else:
        tangent = _const([1.0, 0.0, 0.0], uv).expand(vertex_normal.shape)
        bitangent = _const([0.0, 0.0, 1.0], uv).expand(vertex_normal.shape)
        normal = _const([0.0, 1.0, 0.0], uv).expand(vertex_normal.shape)
        side_length = uniforms.terrain_scale

    pixels_per_side = float(texture_size) * torch.exp2(lod.to(torch.float32))
    distance_between_samples = side_length / pixels_per_side

    surface = torch.stack(
        [left - right, down - up, distance_between_samples.expand(left.shape)], dim=-1)
    surface = surface / coords.norm3(surface)[..., None]
    world = (tangent * surface[..., 0:1] + bitangent * surface[..., 1:2]
             + normal * surface[..., 2:3])
    return world / coords.norm3(world)[..., None]


def _query_locate(uniforms: FrameUniforms, cfg: StaticTerrainConfig, positions):
    """World query points (N, 3) f32 -> (side, blend_lod, blend_ratio, xy,
    frac).

    The shared front half of the host sampling chain
    (terrain_data/mod.rs:267-281): world-to-local, cube face pick + sigmoid
    warp (spherical), surface projection at the approximate height,
    blend(lod, ratio) from view distance, and the tree coordinate at the
    blend lod.
    """
    m = uniforms.world_from_local
    # inv(m3) = normal_matrix.T (normal_matrix is inv(m3).T by definition)
    m3inv = uniforms.normal_matrix.T
    rel = positions - m[:, 3]
    local = coords._apply_mat3(m3inv, rel)  # (N, 3) local coordinates

    if cfg.spherical:
        unit = local / coords.norm3(local)[..., None]
        side = pick_cube_face(unit, xp=torch)
        num = coords.take_side_rows(_const(FACE_UV_NUM, unit), side, cfg.side_count)  # (N, 2, 3)
        den = coords.take_side_rows(_const(FACE_UV_DEN, unit), side, cfg.side_count)  # (N, 3)
        # 0 / +-1 tables: each sum has one non-zero term and is exact
        numer = torch.sum(num * unit[:, None, :], dim=-1)
        denom = torch.sum(den * unit, dim=-1)[:, None]
        uv = sigmoid_warp_forward(numer / denom, xp=torch)
        surf_local = unit
        normal = coords.normal_local_to_world(unit, uniforms.normal_matrix, True)
    else:
        side = torch.zeros(positions.shape[:1], dtype=torch.int32, device=positions.device)
        uv = torch.stack([local[:, 0] + 0.5, local[:, 2] + 0.5], dim=-1).clamp(0.0, 1.0)
        surf_local = torch.stack(
            [local[:, 0], torch.zeros_like(local[:, 0]), local[:, 2]], dim=-1)
        normal = coords.normal_local_to_world(surf_local, uniforms.normal_matrix, False)

    # surface point at the approximate height (mod.rs:272-276)
    surface = coords.position_local_to_world(surf_local, m)
    surface = surface + uniforms.approximate_height * normal
    dist = coords.norm3(surface - uniforms.view_world_position)
    blend_lod, blend_ratio = coords.compute_blend(dist, uniforms, cfg)

    count = coords.tile_count(blend_lod)
    scaled = torch.minimum(uv * count[:, None], count[:, None] - 1e-6)
    xy = scaled.to(torch.int32)
    frac = scaled - xy.to(torch.float32)
    return side, blend_lod, blend_ratio, xy, frac


def query_attachment(slab, uniforms: FrameUniforms, cfg: StaticTerrainConfig, positions,
                     attachment_scale: float, attachment_offset: float, max_value: float):
    """Batched device-side attachment queries at world positions.

    ``sample_attachment`` (terrain_data/mod.rs:267-295) as tensor ops over
    ``positions`` (N, 3) f32 on the slab's device: locate
    (:func:`_query_locate`), tile-tree lookup at the blend lod and the
    coarser lod, bilinear sample of ``slab`` (mip 0), blend lerp. Returns
    (N, C) normalised values in [0, 1].
    """
    side, blend_lod, blend_ratio, xy, frac = _query_locate(uniforms, cfg, positions)

    def tap(lod_offset):
        idx, _, _, auv = coords.lookup_tile(
            uniforms.entries, side, blend_lod, xy, frac, blend_lod, cfg, lod_offset=lod_offset)
        a_uv = attachment_uv(auv, attachment_scale, attachment_offset)
        return sample_bilinear(slab, idx, a_uv, max_value)

    value = tap(0)
    if cfg.blend:
        value2 = tap(1)
        ratio = blend_ratio[:, None]
        value = torch.where(ratio > 0.0, value + (value2 - value) * ratio, value)
    return value


def query_heights(height_slab, uniforms: FrameUniforms, cfg: StaticTerrainConfig, positions,
                  attachment_scale: float, attachment_offset: float):
    """Batched device-side terrain height queries at world positions: the
    host sampling API (terrain_data/mod.rs:267-307,
    terrain_data/sampling_api.py) over (N, 3) query points in one pass, the
    hook for collision, physics and placement services that need thousands
    of heights per tick without a host round trip per point. Chain parity
    with the host API: surface projection, blend(lod, ratio) from view
    distance, tile-tree lookup at the blend lod, bilinear mip-0 sample, lerp
    toward the coarser lod. Returns (N,) f32 heights (world units)."""
    h = query_attachment(height_slab, uniforms, cfg, positions, attachment_scale,
                         attachment_offset, 65535.0)[:, 0]
    return uniforms.min_height + (uniforms.max_height - uniforms.min_height) * h
