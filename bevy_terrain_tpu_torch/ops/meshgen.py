"""CDLOD-morphed terrain mesh generation — torch twin of the JAX package's
``ops/meshgen.py``: the fused path (one mesh kernel), the staged grid path
(:func:`generate_mesh_grid`: the half-grid kernel or the staged half-grid
functions, then the per-vertex geometry in torch ops) and the per-vertex
path (:func:`generate_mesh`: bilinear gathers from the attachment slab).

:func:`generate_mesh_fused` plans the frame's patch fetches
(patch_sampling.plan_patch_batch), packs the kernel's per-tile and frame
scalars, and runs :func:`kernels.mesh_fused_planar` (planar frames),
:func:`kernels.mesh_fused_spherical` (cube-sphere frames, with the Taylor
high-precision path), or with a packed albedo
:func:`kernels.mesh_fused_albedo` (planar, the albedo fused in),
:func:`kernels.mesh_fused_shaded` (planar, albedo and PBR shade fused in)
or :func:`kernels.mesh_fused_spherical_albedo` (a sphere's albedo). Its
``raw`` product is (Fp, C, 17, 17) f32 in the sorted tile order, on the
(row = v, column = u) vertex grid: the 6 planar channels [height, pos x,
pos y, pos z, morphed u, morphed v], or 9 for spheres, which add [normal
x, normal y, normal z]; an albedo adds its C channels after those (raw
texel values, or on a planar frame the shaded linear colour).
:func:`fused_to_grid` is a view of it as a :class:`GridMeshOutput`, and
:func:`fused_albedo_to_grid` one of the colour channels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bevy_terrain_tpu_torch.ops import coords, kernels, sampling
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


@dataclasses.dataclass
class MeshOutput:
    """Per-vertex-path frame mesh, in the reference's degenerate-strip
    vertex order (functions.wgsl:64-71), V = vertices_per_tile."""

    positions: torch.Tensor  # (F, V, 3) f32 world positions
    normals: torch.Tensor  # (F, V, 3) f32 world normals (geometric, pre-height)
    uvs: torch.Tensor  # (F, V, 2) f32 morphed tile-space uv
    heights: torch.Tensor  # (F, V) f32 sampled terrain height
    tile_mask: torch.Tensor  # (F,) bool: lanes below tile_count


def vertex_grid_uv(cfg: StaticTerrainConfig, device="cpu") -> torch.Tensor:
    """Per-vertex grid uv table of the strip order (functions.wgsl:64-71),
    (V, 2) f32."""
    vid = torch.arange(cfg.vertices_per_tile, dtype=torch.int32, device=device)
    return coords.compute_tile_uv(vid, cfg)


def grid_to_strip_order(grid_values, cfg: StaticTerrainConfig) -> np.ndarray:
    """Expand (F, G+1, G+1, ...) grid values to the reference's
    degenerate-strip vertex order, on the host (a comparison utility)."""
    uv = vertex_grid_uv(cfg).numpy()
    ix = np.round(uv[:, 0] * cfg.grid_size).astype(int)
    iy = np.round(uv[:, 1] * cfg.grid_size).astype(int)
    vals = grid_values.cpu().numpy() if isinstance(grid_values, torch.Tensor) else np.asarray(
        grid_values)
    return vals[:, iy, ix]


def _vertex_geometry(side, lod, xy, tile_uv, uniforms: FrameUniforms,
                     cfg: StaticTerrainConfig, planar_componentwise: bool):
    """The per-vertex geometry both staged paths share (vertex.wgsl:30-71):
    the approximate view distance (the Taylor distance inside the precision
    threshold), the CDLOD morph, and the morphed world position and normal
    (in the near field the Taylor position and the unmorphed normal).
    ``planar_componentwise``: a planar frame without the Taylor path takes
    the componentwise distance of refinement and the per-tile lookup (the
    grid path), not the world-position chain (the per-vertex path).
    ``side``, ``lod`` (..., V), ``xy``, ``tile_uv`` (..., V, 2). Returns
    (view_distance, morphed_uv, morph_world, morph_normal)."""
    hp = None
    if cfg.spherical or cfg.high_precision or not planar_componentwise:
        local = coords.compute_local_position(side, lod, xy, tile_uv, cfg.spherical)
        world = coords.position_local_to_world(local, uniforms.world_from_local)
        normal = coords.normal_local_to_world(local, uniforms.normal_matrix, cfg.spherical)
        view_distance = coords.norm3(
            world + uniforms.approximate_height * normal - uniforms.view_world_position)
    else:
        view_distance = coords.planar_view_distance(lod, xy, tile_uv, uniforms)
    if cfg.high_precision:
        relative = coords.compute_relative_position(
            side, lod, xy, tile_uv, uniforms.taylor, cfg.origin_lod, cfg.side_count)
        hp_distance = coords.norm3(relative + uniforms.approximate_height * normal)
        hp = view_distance < uniforms.precision_threshold_distance
        view_distance = torch.where(hp, hp_distance, view_distance)

    morphed_uv = coords.compute_morph(lod, tile_uv, view_distance, uniforms, cfg)

    morph_local = coords.compute_local_position(side, lod, xy, morphed_uv, cfg.spherical)
    morph_world = coords.position_local_to_world(morph_local, uniforms.world_from_local)
    morph_normal = coords.normal_local_to_world(morph_local, uniforms.normal_matrix,
                                                cfg.spherical)
    if cfg.high_precision:
        hp_relative = coords.compute_relative_position(
            side, lod, xy, morphed_uv, uniforms.taylor, cfg.origin_lod, cfg.side_count)
        hp_world = uniforms.view_world_position + hp_relative
        morph_world = torch.where(hp[..., None], hp_world, morph_world)
        morph_normal = torch.where(hp[..., None], normal, morph_normal)
    return view_distance, morphed_uv, morph_world, morph_normal


def generate_mesh_grid(tiles: RefinementOutput, block_array: torch.Tensor,
                       uniforms: FrameUniforms, cfg: StaticTerrainConfig, plan,
                       max_value: float, assume_sorted: bool = False, fetch_fn=None,
                       n_blocks: int | None = None):
    """The staged mesh stage on the (G+1)^2 grid layout, for every frame
    configuration (any grid size; planar or spherical, with or without the
    Taylor high-precision path): the JAX package's generate_mesh_grid.

    The half-grid heights come from :func:`kernels.fetch_resample_cached`
    at grid size 16 (one launch per frame), else from the staged functions
    (patch_sampling.fetch_patches, halfgrid_resample). ``fetch_fn(block_array,
    ids) -> (F, 64, 64) f32`` replaces ``fetch_patches`` and takes the staged
    functions at every grid size: the hook of the sharded-atlas fetch
    (parallel/sharded_atlas.py), where ``block_array`` is the shards and the
    ids are global (pass the global ``n_blocks``, else
    ``block_array.shape[0]`` is taken). The blend toward the
    coarser data lod is the half-grid's, at the tile-centre ratio; with
    ``cfg.blend_per_vertex`` the plain half-grid and its 1-2-1 smoothed
    copy are both interpolated and mixed by the per-vertex ratio. Morph,
    positions and normals are torch ops on a flat (F, (G+1)^2) layout.

    Returns (GridMeshOutput, sorted_tiles): the tile list reordered by atlas
    quad id, the order of the mesh rows (a tile list is a set, so any
    deterministic order is valid). Pair the mesh with the returned tiles.
    """
    F = cfg.tile_capacity
    G = cfg.grid_size
    tiles, batch = ps.plan_patch_batch(
        tiles, uniforms, cfg, plan, n_blocks if n_blocks is not None else block_array.shape[0],
        assume_sorted=assume_sorted)
    dev = block_array.device
    t_side = tiles.tile_side[:F]
    t_lod = tiles.tile_lod[:F].clamp(min=0)
    t_xy = tiles.tile_xy[:F]

    per_vertex = cfg.blend and cfg.blend_per_vertex
    if G == 16 and fetch_fn is None:
        count = tiles.tile_count.reshape(1).to(torch.int32)
        h_mix = kernels.fetch_resample_cached(block_array, batch.ids, batch.geom, count)[:F]
        h_mix = h_mix / max_value
    else:
        patch = (fetch_fn or ps.fetch_patches)(block_array, batch.ids[:F, None])
        h_mix = ps.halfgrid_resample(
            patch, batch.geom[:F, 0:2], batch.geom[:F, 2], cfg,
            ratio=batch.geom[:F, 4] if (cfg.blend and not per_vertex) else None,
        ) / max_value
        h_mix = ps.permute_halfgrid(h_mix * batch.geom[:F, 3][:, None, None])
    if per_vertex:
        h_coarse = ps.smooth_halfgrid_permuted(h_mix)

    NV = (G + 1) * (G + 1)
    g = torch.arange(G + 1, dtype=torch.float32, device=dev) / G
    guv = torch.stack(torch.meshgrid(g, g, indexing="xy"), dim=-1)  # (G+1, G+1, 2)
    tile_uv = guv.reshape(1, NV, 2).expand(F, NV, 2)
    side = t_side[:, None].expand(F, NV)
    lod_b = t_lod[:, None].expand(F, NV)
    xy = t_xy[:, None, :].expand(F, NV, 2)
    view_distance, morphed_uv, morph_world, morph_normal = _vertex_geometry(
        side, lod_b, xy, tile_uv, uniforms, cfg, planar_componentwise=True)

    morphed_grid = morphed_uv.reshape(F, G + 1, G + 1, 2)
    h_norm = ps.vertex_values_from_halfgrid(h_mix, morphed_grid, cfg).reshape(F, NV)
    if per_vertex:
        _, v_ratio = coords.compute_blend(view_distance, uniforms, cfg)
        h_coarse_v = ps.vertex_values_from_halfgrid(h_coarse, morphed_grid, cfg).reshape(F, NV)
        h_norm = h_norm + (h_coarse_v - h_norm) * v_ratio
    height = uniforms.min_height + (uniforms.max_height - uniforms.min_height) * h_norm
    positions = morph_world + height[..., None] * morph_normal

    tile_mask = torch.arange(F, dtype=torch.int32, device=dev) < tiles.tile_count
    mask = tile_mask[:, None]

    def grid(x, ch=None):
        return x.reshape((F, G + 1, G + 1) + ((ch,) if ch else ()))

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    mesh = GridMeshOutput(
        positions=grid(torch.where(mask[..., None], positions, zero), 3),
        normals=grid(torch.where(mask[..., None], morph_normal, zero), 3),
        uvs=grid(torch.where(mask[..., None], morphed_uv, zero), 2),
        heights=grid(torch.where(mask, height, zero)),
        tile_mask=tile_mask,
    )
    return mesh, tiles


def generate_mesh(tiles: RefinementOutput, height_slab: torch.Tensor,
                  uniforms: FrameUniforms, cfg: StaticTerrainConfig,
                  attachment_scale: float, attachment_offset: float) -> MeshOutput:
    """The per-vertex mesh stage (vertex.wgsl:30-98): per (tile, vertex) the
    morphed world position and a bilinear height gathered from
    ``height_slab``, attachment 0's mip-0 slab (A, H, W, 1) uint16, blended
    between two atlas lods. The path of a height attachment too small for
    the patch plan; it runs no hand-written kernel (the JAX package's
    generate_mesh runs none either)."""
    F = cfg.tile_capacity
    V = cfg.vertices_per_tile
    dev = height_slab.device
    side = tiles.tile_side[:F, None].expand(F, V)
    lod_b = tiles.tile_lod[:F, None].clamp(min=0).expand(F, V)
    xy = tiles.tile_xy[:F, None, :].expand(F, V, 2)
    tile_uv = vertex_grid_uv(cfg, dev)[None].expand(F, V, 2)
    view_distance, morphed_uv, morph_world, morph_normal = _vertex_geometry(
        side, lod_b, xy, tile_uv, uniforms, cfg, planar_componentwise=False)

    # height sample with blend between two atlas lods (vertex.wgsl:85-98)
    blend_lod, blend_ratio = coords.compute_blend(view_distance, uniforms, cfg)
    a_idx, _, _, a_uv = coords.lookup_tile(
        uniforms.entries, side, lod_b, xy, morphed_uv, blend_lod, cfg, lod_offset=0)
    height = sampling.sample_height(height_slab, a_idx, a_uv, uniforms, attachment_scale,
                                    attachment_offset)
    if cfg.blend:
        a_idx2, _, _, a_uv2 = coords.lookup_tile(
            uniforms.entries, side, lod_b, xy, morphed_uv, blend_lod, cfg, lod_offset=1)
        height2 = sampling.sample_height(height_slab, a_idx2, a_uv2, uniforms,
                                         attachment_scale, attachment_offset)
        height = torch.where(blend_ratio > 0.0, height + (height2 - height) * blend_ratio,
                             height)
    positions = morph_world + height[..., None] * morph_normal

    tile_mask = torch.arange(F, dtype=torch.int32, device=dev) < tiles.tile_count
    mask3 = tile_mask[:, None, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return MeshOutput(
        positions=torch.where(mask3, positions, zero),
        normals=torch.where(mask3, morph_normal, zero),
        uvs=torch.where(mask3, morphed_uv, zero),
        heights=torch.where(tile_mask[:, None], height, zero),
        tile_mask=tile_mask,
    )


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
    if albedo_channels and cfg.spherical:
        if shaded:
            raise NotImplementedError(
                "the in-kernel shade is planar (its normals are a planar central "
                "difference): shade a sphere with render/material.shade")
        return kernels.mesh_fused_spherical_albedo
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

    With ``albedo_channels`` the kernel also samples the
    first ``albedo_channels`` channels of ``albedo_bits`` bits of the packed
    ``albedo_blocks`` (same plan as the heights), or of rows 32:64 of
    ``albedo_combined`` (N, 64, 128) blocks; ``albedo_fast`` takes the bf16
    resample for 8-bit channels. ``shade_spec`` (a
    material.kernel_shade_spec, or its kernels.pack_shade_spec buffer)
    shades the albedo in the kernel (planar frames only).

    Returns (sorted_tiles, PatchBatch, args) where ``args`` is the argument
    tuple of the frame's kernel (:func:`mesh_kernel`) and of its plain
    version.
    """
    check_fused_config(cfg)
    mesh_kernel(cfg, albedo_channels, shade_spec is not None)  # raises for a shaded sphere
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
    if albedo_channels:
        args += (albedo_blocks, albedo_channels, albedo_bits,
                 albedo_fast and albedo_bits <= 8, albedo_combined)
    return tiles, batch, args


def generate_mesh_fused(tiles: RefinementOutput, block_array: torch.Tensor,
                        uniforms: FrameUniforms, cfg: StaticTerrainConfig, plan,
                        max_value: float, albedo_blocks=None, albedo_channels: int = 0,
                        albedo_bits: int = 0, shade_spec=None, albedo_fast: bool = True,
                        albedo_combined: bool = False, ablate: frozenset = frozenset()):
    """The whole mesh stage in one kernel launch.

    Planar, or spherical with the Taylor high-precision path; grid_size 16,
    per-vertex blend (the kernel's crossfade). The albedo arguments are
    :func:`fused_kernel_args`'s. ``ablate`` (the JAX function's; a
    measurement harness) names kernel pieces to remove: those the frame's
    kernel reads (ops/kernels.py MESH_ABLATE, SPHERE_ABLATE, ALBEDO_ABLATE),
    any other raises ValueError. Returns (raw, sorted_tiles): ``raw`` is
    (Fp, 6 + C or 9 + C, 17, 17) f32 (see the module docstring); its rows pair
    with ``sorted_tiles``, the tile list reordered by atlas quad id (a tile
    list is a set, so any deterministic order is valid).
    """
    tiles, _, args = fused_kernel_args(
        tiles, block_array, uniforms, cfg, plan, max_value, albedo_blocks, albedo_channels,
        albedo_bits, shade_spec, albedo_fast, albedo_combined)
    kernel = mesh_kernel(cfg, albedo_channels, shade_spec is not None)
    return kernel(*args, ablate=frozenset(ablate)), tiles


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
    """The fused kernel's trailing ``channels`` colour channels (after the
    6 planar or 9 spherical mesh channels of ``raw``) as (F, G+1, G+1, C)
    f32, divided by ``max_value`` (the JAX package's
    fused_albedo_to_grid)."""
    F = cfg.tile_capacity
    return raw[:F, raw.shape[1] - channels:].permute(0, 2, 3, 1) / max_value
