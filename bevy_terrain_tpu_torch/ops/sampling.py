"""Atlas texture sampling as explicit gathers — torch twin of the bilinear
part of the JAX package's ``ops/sampling.py`` (attachments.wgsl).

The per-vertex mesh path samples attachment slabs, one ``(atlas_size, H, W,
C)`` tensor per mip in the attachment's native integer dtype
(terrain_data/tile_atlas.py); normalisation to f32 happens here (the unorm
semantics of the reference's texture formats), as do the border-inset uv
transform and clamp-to-edge.
"""

from __future__ import annotations

import torch

from bevy_terrain_tpu_torch.ops.params import FrameUniforms


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
