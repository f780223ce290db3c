"""CDLOD-morphed terrain mesh generation around the fused mesh kernels —
torch twin of the fused path of the JAX package's ``ops/meshgen.py``.

:func:`generate_mesh_fused` plans the frame's patch fetches
(patch_sampling.plan_patch_batch), packs the kernel's per-tile and frame
scalars, and runs :func:`kernels.mesh_fused_planar` (planar frames),
:func:`kernels.mesh_fused_spherical` (cube-sphere frames, with the Taylor
high-precision path), or for a planar frame with a packed albedo
:func:`kernels.mesh_fused_albedo` (the albedo fused in) or
:func:`kernels.mesh_fused_shaded` (albedo and PBR shade fused in). Its
``raw`` product is (Fp, C, 17, 17) f32 in the sorted tile order, on the
(row = v, column = u) vertex grid: the 6 planar channels [height, pos x,
pos y, pos z, morphed u, morphed v], or 9 for spheres, which add [normal
x, normal y, normal z]; a planar frame with an albedo adds its C channels
after those 6 (raw texel values, or the shaded linear colour).
:func:`fused_to_grid` is a view of it as a :class:`GridMeshOutput`, and
:func:`fused_albedo_to_grid` one of the colour channels.
"""

from __future__ import annotations

import dataclasses

import torch

from bevy_terrain_tpu_torch.ops import coords, kernels
from bevy_terrain_tpu_torch.ops import patch_sampling as ps
from bevy_terrain_tpu_torch.ops.params import FrameUniforms, StaticTerrainConfig
from bevy_terrain_tpu_torch.ops.refinement import RefinementOutput


@dataclasses.dataclass
class GridMeshOutput:
    """Frame mesh: one (G+1)x(G+1) vertex grid per tile (rows = v)."""

    positions: torch.Tensor  # (F, G+1, G+1, 3) f32 world positions
    normals: torch.Tensor  # (F, G+1, G+1, 3) f32 geometric normals
    uvs: torch.Tensor  # (F, G+1, G+1, 2) f32 morphed tile-space uv
    heights: torch.Tensor  # (F, G+1, G+1) f32
    tile_mask: torch.Tensor  # (F,) bool


def check_fused_config(cfg: StaticTerrainConfig) -> None:
    """Raise for a frame configuration the ported fused path does not cover."""
    if cfg.spherical != cfg.high_precision:
        raise NotImplementedError(
            "the fused mesh kernels run planar frames without the Taylor "
            "high-precision path and spherical frames with it")
    if cfg.grid_size != 16:
        raise NotImplementedError(
            f"the fused mesh kernel needs grid_size 16, got {cfg.grid_size}")


def mesh_kernel(cfg: StaticTerrainConfig, albedo_channels: int = 0, shaded: bool = False):
    """The mesh kernel's wrapper for the frame configuration (and a fused
    albedo of ``albedo_channels`` channels, ``shaded`` or not)."""
    if albedo_channels:
        return kernels.mesh_fused_shaded if shaded else kernels.mesh_fused_albedo
    return kernels.mesh_fused_spherical if cfg.spherical else kernels.mesh_fused_planar


def _side_transforms(uniforms: FrameUniforms, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(6, 9) world (WM) and normal (NM) matrices composed with each side's
    cube placement, row-major. The side matrices are signed permutations,
    so each entry is one product by +-1 plus zeros: exact, written as
    elementwise sums (no matmul, whose f32 precision a TF32 flag lowers)."""
    mats = coords.side_mats(device)  # (6, 3, 3)

    def compose(m):  # m (3, 3) -> (6, 3, 3) = m @ mats[s]
        return (m[None, :, 0:1] * mats[:, 0:1, :] + m[None, :, 1:2] * mats[:, 1:2, :]
                + m[None, :, 2:3] * mats[:, 2:3, :])

    return (compose(uniforms.world_from_local[:, :3]).reshape(6, 9),
            compose(uniforms.normal_matrix).reshape(6, 9))


def fused_kernel_args(tiles: RefinementOutput, block_array: torch.Tensor,
                      uniforms: FrameUniforms, cfg: StaticTerrainConfig, plan,
                      max_value: float, albedo_blocks=None, albedo_channels: int = 0,
                      albedo_bits: int = 0, shade_spec=None, albedo_fast: bool = True,
                      albedo_combined: bool = False):
    """Plan the patch fetches and pack the mesh kernel's arguments.

    With ``albedo_channels`` (a planar frame) the kernel also samples the
    first ``albedo_channels`` channels of ``albedo_bits`` bits of the packed
    ``albedo_blocks`` (same plan as the heights), or of rows 32:64 of
    ``albedo_combined`` (N, 64, 128) blocks; ``albedo_fast`` takes the bf16
    resample for 8-bit channels. ``shade_spec`` (a
    material.kernel_shade_spec, or its kernels.pack_shade_spec buffer)
    shades the albedo in the kernel.

    Returns (sorted_tiles, PatchBatch, args) where ``args`` is the argument
    tuple of the frame's kernel (:func:`mesh_kernel`) and of its plain
    version.
    """
    check_fused_config(cfg)
    if albedo_channels and cfg.spherical:
        raise NotImplementedError(
            "the fused albedo runs on planar frames; the spherical kernel's albedo "
            "variant is not ported yet")
    F = cfg.tile_capacity
    tiles, batch = ps.plan_patch_batch(tiles, uniforms, cfg, plan, block_array.shape[0])
    Fp = batch.ids.shape[0]
    dev = block_array.device
    f32 = torch.float32

    def pad(x):
        return torch.cat([x, torch.zeros(Fp - F, dtype=x.dtype, device=dev)]) if Fp > F else x

    live = (torch.arange(Fp, dtype=torch.int32, device=dev) < tiles.tile_count).to(f32)
    lod = pad(tiles.tile_lod[:F].clamp(min=0))
    xy = torch.stack([pad(tiles.tile_xy[:F, 0]), pad(tiles.tile_xy[:F, 1])], dim=-1)
    cols = [live, lod.to(f32), xy[:, 0].to(f32), xy[:, 1].to(f32)]
    fs = kernels.pack_mesh_scalars(uniforms, cfg, max_value)
    count = tiles.tile_count.reshape(1).to(torch.int32)
    if not cfg.spherical:
        tile_params = torch.stack(cols, dim=-1).contiguous()
        args = (block_array, batch.ids, batch.geom, tile_params, fs, count)
        if albedo_channels:
            shade = ()
            if shade_spec is not None:
                shade = (shade_spec if isinstance(shade_spec, torch.Tensor)
                         else kernels.pack_shade_spec(shade_spec, dev),)
            args += (albedo_blocks, albedo_channels, albedo_bits, *shade,
                     albedo_fast and albedo_bits <= 8, albedo_combined)
        return tiles, batch, args

    # per-tile Taylor rows, origin anchor and side-composed transforms, in
    # the JAX kernel's column order (kernels.SPH_PARAMS)
    side = pad(tiles.tile_side[:F])
    t = uniforms.taylor
    cols.append(side.to(f32))
    for table in (t.c, t.c_s, t.c_t, t.c_ss, t.c_st, t.c_tt):
        rows3 = coords.take_side_rows(table, side, cfg.side_count)
        cols += [rows3[:, 0], rows3[:, 1], rows3[:, 2]]
    oxy = coords.take_side_rows(t.origin_xy, side, cfg.side_count)
    ouv = coords.take_side_rows(t.origin_uv, side, cfg.side_count)
    cols += [oxy[:, 0].to(f32), oxy[:, 1].to(f32), ouv[:, 0], ouv[:, 1]]
    wm6, nm6 = _side_transforms(uniforms, dev)
    wm = coords.take_side_rows(wm6, side, cfg.side_count)  # (Fp, 9)
    nm = coords.take_side_rows(nm6, side, cfg.side_count)
    cols += [wm[:, r] for r in range(9)]
    cols += [nm[:, r] for r in range(9)]
    tile_params = torch.stack(cols, dim=-1).contiguous()

    # conservative high-precision flag per 64-tile step: a vertex can be
    # inside the precision threshold only if its tile's closest point (the
    # refinement's subdivision coordinate) is within threshold + an f32
    # noise margin; the kernel takes the Taylor near field only on steps
    # with such a live tile (JAX meshgen.py:338-361)
    T = kernels.TILES_PER_STEP
    steps = Fp // T
    live_steps = tiles.tile_count > torch.arange(steps, dtype=torch.int32, device=dev) * T
    sub_uv = coords.compute_subdivision_coordinate(side, lod, xy, t, cfg.origin_lod,
                                                   cfg.side_count)
    dmin = coords.approximate_view_distance(side, lod, xy, sub_uv, uniforms, cfg)
    margin = 1.0 + 4e-6 * torch.max(torch.abs(uniforms.view_world_position))
    tile_hp = (dmin < uniforms.precision_threshold_distance * 1.05 + margin) & (live > 0.0)
    hp_any = tile_hp.reshape(steps, T).any(dim=1)
    hp_steps = torch.where(live_steps, torch.where(hp_any, 2, 1), 0).to(torch.int32)
    args = (block_array, batch.ids, batch.geom, tile_params, fs, hp_steps, count,
            cfg.origin_lod, cfg.ellipsoidal)
    return tiles, batch, args


def generate_mesh_fused(tiles: RefinementOutput, block_array: torch.Tensor,
                        uniforms: FrameUniforms, cfg: StaticTerrainConfig, plan,
                        max_value: float, albedo_blocks=None, albedo_channels: int = 0,
                        albedo_bits: int = 0, shade_spec=None, albedo_fast: bool = True,
                        albedo_combined: bool = False):
    """The whole mesh stage in one kernel launch.

    Planar, or spherical with the Taylor high-precision path; grid_size 16,
    per-vertex blend (the kernel's crossfade). The albedo arguments are
    :func:`fused_kernel_args`'s. Returns (raw, sorted_tiles): ``raw`` is
    (Fp, 6 + C or 9, 17, 17) f32 (see the module docstring); its rows pair
    with ``sorted_tiles``, the tile list reordered by atlas quad id (a tile
    list is a set, so any deterministic order is valid).
    """
    tiles, _, args = fused_kernel_args(
        tiles, block_array, uniforms, cfg, plan, max_value, albedo_blocks, albedo_channels,
        albedo_bits, shade_spec, albedo_fast, albedo_combined)
    return mesh_kernel(cfg, albedo_channels, shade_spec is not None)(*args), tiles


def fused_to_grid(raw: torch.Tensor, tiles: RefinementOutput,
                  cfg: StaticTerrainConfig) -> GridMeshOutput:
    """View the fused kernel's product as a GridMeshOutput: slices, plus the
    kernel's unit normals for spheres or the constant planar up normal (the
    JAX package's fused_to_grid)."""
    check_fused_config(cfg)
    F = cfg.tile_capacity
    G = cfg.grid_size
    r = raw[:F]
    if cfg.spherical:
        normals = r[:, 6:9].permute(0, 2, 3, 1)
    else:
        up = torch.zeros(3, dtype=torch.float32, device=raw.device)
        up[1] = 1.0
        normals = up.expand(F, G + 1, G + 1, 3)
    return GridMeshOutput(
        positions=r[:, 1:4].permute(0, 2, 3, 1),
        normals=normals,
        uvs=r[:, 4:6].permute(0, 2, 3, 1),
        heights=r[:, 0],
        tile_mask=torch.arange(F, dtype=torch.int32, device=raw.device) < tiles.tile_count,
    )


def fused_albedo_to_grid(raw: torch.Tensor, cfg: StaticTerrainConfig, channels: int,
                         max_value: float) -> torch.Tensor:
    """The fused kernel's trailing ``channels`` colour channels as (F, G+1,
    G+1, C) f32, divided by ``max_value`` (the JAX package's
    fused_albedo_to_grid)."""
    F = cfg.tile_capacity
    return raw[:F, raw.shape[1] - channels:].permute(0, 2, 3, 1) / max_value
