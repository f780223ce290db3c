"""Static config and per-frame uniforms for the device stage.

The counterpart of the JAX package's ``ops/params.py``:

* :class:`StaticTerrainConfig` — shapes, counts and pipeline flags, a plain
  frozen dataclass (identical fields to the JAX package's).
* :func:`pack_frame_uniforms` — the numpy host packer: ALL per-frame
  uniforms in ONE int32 blob (f32 section bitcast), so a frame costs one
  host-to-device copy.
* :class:`FrameUniforms` / :class:`TaylorParams` — dataclasses of torch
  tensors, rebuilt on the device from the blob by
  :func:`unpack_frame_uniforms` (slices and one ``.view(torch.float32)``
  bitcast; no host round trip). :func:`make_frame_uniforms` goes from the
  host state to them in one call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class StaticTerrainConfig:
    """Static frame-stage parameters.

    Counts/flags from TerrainConfig + TerrainViewConfig
    (reference terrain.rs:27-49, terrain_view.rs:19-64) plus the debug/render
    flags that specialize shaders (terrain_material.rs:73-97). Same fields
    and defaults as the JAX package's config, so one value configures both.
    """

    spherical: bool
    side_count: int
    lod_count: int
    tree_size: int
    grid_size: int
    refinement_count: int
    queue_capacity: int
    tile_capacity: int
    origin_lod: int
    attachment_count: int = 1
    ellipsoidal: bool = False
    morph: bool = True
    blend: bool = True
    blend_per_vertex: bool = False
    high_precision: bool = False
    sample_grad: bool = True
    tile_tree_lod: bool = False
    culling: bool = False
    test1: bool = False
    test2: bool = False
    test3: bool = False
    pallas_sampling: bool = False

    @property
    def vertices_per_row(self) -> int:
        # reference terrain_view_bind_group.rs:84
        return 2 * (self.grid_size + 2)

    @property
    def vertices_per_tile(self) -> int:
        # reference terrain_view_bind_group.rs:85
        return self.grid_size * self.vertices_per_row


@dataclasses.dataclass
class TaylorParams:
    """Device-side TerrainModelApproximation (reference terrain_model.rs:228-259)."""

    origin_xy: torch.Tensor  # (6, 2) i32
    origin_uv: torch.Tensor  # (6, 2) f32
    c: torch.Tensor  # (6, 3) f32
    c_s: torch.Tensor  # (6, 3) f32
    c_t: torch.Tensor  # (6, 3) f32
    c_ss: torch.Tensor  # (6, 3) f32
    c_st: torch.Tensor  # (6, 3) f32
    c_tt: torch.Tensor  # (6, 3) f32


@dataclasses.dataclass
class FrameUniforms:
    """Per-frame dynamic inputs to the frame step (one view); scalars are
    0-d tensors. Field meanings as in the JAX package's FrameUniforms."""

    view_world_position: torch.Tensor  # (3,) f32
    approximate_height: torch.Tensor  # () f32
    world_from_local: torch.Tensor  # (3, 4) f32 affine
    normal_matrix: torch.Tensor  # (3, 3) f32 = (M^-1)^T upper 3x3
    min_height: torch.Tensor
    max_height: torch.Tensor
    terrain_scale: torch.Tensor
    morph_distance: torch.Tensor
    blend_distance: torch.Tensor
    load_distance: torch.Tensor
    subdivision_distance: torch.Tensor
    precision_threshold_distance: torch.Tensor
    morph_range: torch.Tensor
    blend_range: torch.Tensor
    taylor: TaylorParams
    origins: torch.Tensor  # (sides, lods, 2) i32
    entries: torch.Tensor  # (sides, lods, tree, tree, 2) i32
    view_tile_int: torch.Tensor  # (sides, lods, 2) i32
    view_tile_frac: torch.Tensor  # (sides, lods, 2) f32
    culling_planes: torch.Tensor  # (5, 4) f32


def pack_frame_uniforms(
    model,
    view_world_position,
    approx,
    origins: np.ndarray,
    entries: np.ndarray,
    view_tile_int: np.ndarray,
    view_tile_frac: np.ndarray,
    view_config,
    view_proj: np.ndarray | None = None,
) -> np.ndarray:
    """Pack all per-frame uniforms into ONE host int32 blob.

    Layout (identical to the JAX package's blob, bit for bit): an f32
    section of :func:`packed_f32_count` words bitcast to int32, then the
    int32 section (Taylor origin_xy, origins, view_tile_int, entries).
    """
    scale = model.scale
    m = np.asarray(model.world_from_local, np.float64)
    normal_matrix = np.linalg.inv(m[:3, :3]).T
    S, L = origins.shape[0], origins.shape[1]
    nf = packed_f32_count(S, L)
    ni = 12 + 2 * (S * L * 2) + entries.size
    blob = np.empty(nf + ni, np.int32)
    f32 = blob[:nf].view(np.float32)
    o = 0

    def put(values, n):
        nonlocal o
        f32[o:o + n] = values
        o += n

    put(np.asarray(view_world_position, np.float32), 3)
    f32[3:14] = (
        approx.approximate_height,
        model.min_height,
        model.max_height,
        scale,
        view_config.morph_distance * scale,
        view_config.blend_distance * scale,
        view_config.load_distance * scale,
        view_config.morph_distance * scale * (1.0 + view_config.subdivision_tolerance),
        view_config.precision_threshold_distance * scale,
        view_config.morph_range,
        view_config.blend_range,
    )
    o = 14
    put(m[:3, :4].ravel(), 12)
    put(normal_matrix.ravel(), 9)
    put(approx.origin_uv.ravel(), 12)
    for coeff in (approx.c, approx.c_s, approx.c_t, approx.c_ss, approx.c_st,
                  approx.c_tt):
        put(coeff.ravel(), 18)
    put(np.asarray(view_tile_frac).reshape(-1), S * L * 2)
    put(_planes_of(view_proj).ravel(), 20)
    assert o == nf, (o, nf)
    i32 = blob[nf:]
    i32[0:12] = approx.origin_xy.ravel()
    p = 12
    for arr in (origins, view_tile_int, entries):
        flat = np.asarray(arr).reshape(-1)
        i32[p:p + flat.size] = flat
        p += flat.size
    return blob


def _planes_of(view_proj) -> np.ndarray:
    """Frustum planes from an optional camera projection (accept-all when
    absent — culling then never rejects, matching the reference's shipped
    default-planes state, culling_bind_group.rs:47-55)."""
    from bevy_terrain_tpu_torch.math import frustum

    if view_proj is None:
        return frustum.accept_all_planes()
    return frustum.frustum_planes(view_proj)


def packed_f32_count(side_count: int, lod_count: int) -> int:
    """Length of the f32 section inside the packed uniform blob."""
    return 3 + 11 + 12 + 9 + 12 + 6 * 18 + side_count * lod_count * 2 + 20


def unpack_frame_uniforms(blob: torch.Tensor, side_count: int, lod_count: int,
                          tree_size: int) -> FrameUniforms:
    """Rebuild FrameUniforms from the packed int32 blob, on the blob's
    device. Every field is a view into the blob (int32 fields stay int32,
    the f32 section is reinterpreted, not converted)."""
    if blob.dtype != torch.int32 or blob.dim() != 1:
        raise ValueError(f"blob must be 1-d int32, got {blob.dtype} {tuple(blob.shape)}")
    nf = packed_f32_count(side_count, lod_count)
    f32 = blob[:nf].view(torch.float32)
    i32 = blob[nf:]
    o = 0

    def take_f(n, shape=None):
        nonlocal o
        v = f32[o:o + n]
        o += n
        return v.reshape(shape) if shape else v

    view_world_position = take_f(3)
    s = take_f(11)
    world_from_local = take_f(12, (3, 4))
    normal_matrix = take_f(9, (3, 3))
    origin_uv = take_f(12, (6, 2))
    c = take_f(18, (6, 3))
    c_s = take_f(18, (6, 3))
    c_t = take_f(18, (6, 3))
    c_ss = take_f(18, (6, 3))
    c_st = take_f(18, (6, 3))
    c_tt = take_f(18, (6, 3))
    SL2 = side_count * lod_count * 2
    view_tile_frac = take_f(SL2, (side_count, lod_count, 2))
    culling_planes = take_f(20, (5, 4))

    p = 0

    def take_i(n, shape):
        nonlocal p
        v = i32[p:p + n]
        p += n
        return v.reshape(shape)

    origin_xy = take_i(12, (6, 2))
    origins = take_i(SL2, (side_count, lod_count, 2))
    view_tile_int = take_i(SL2, (side_count, lod_count, 2))
    entries = take_i(
        side_count * lod_count * tree_size * tree_size * 2,
        (side_count, lod_count, tree_size, tree_size, 2),
    )

    return FrameUniforms(
        view_world_position=view_world_position,
        approximate_height=s[0],
        world_from_local=world_from_local,
        normal_matrix=normal_matrix,
        min_height=s[1],
        max_height=s[2],
        terrain_scale=s[3],
        morph_distance=s[4],
        blend_distance=s[5],
        load_distance=s[6],
        subdivision_distance=s[7],
        precision_threshold_distance=s[8],
        morph_range=s[9],
        blend_range=s[10],
        taylor=TaylorParams(
            origin_xy=origin_xy, origin_uv=origin_uv, c=c, c_s=c_s, c_t=c_t,
            c_ss=c_ss, c_st=c_st, c_tt=c_tt,
        ),
        origins=origins,
        entries=entries,
        view_tile_int=view_tile_int,
        view_tile_frac=view_tile_frac,
        culling_planes=culling_planes,
    )


def make_frame_uniforms(
    model,
    view_world_position,
    approx,
    origins: np.ndarray,
    entries: np.ndarray,
    view_tile_int: np.ndarray,
    view_tile_frac: np.ndarray,
    view_config,
    view_proj: np.ndarray | None = None,
    device="cuda",
) -> FrameUniforms:
    """Assemble FrameUniforms on ``device`` (the card unless the caller asks
    for the CPU) from host-side f64 state (the JAX package's
    make_frame_uniforms): the packed blob, one host-to-device copy, unpacked
    there. Each value rounds from f64 to f32 once, as in the JAX function."""
    blob = pack_frame_uniforms(model, view_world_position, approx, origins, entries,
                               view_tile_int, view_tile_frac, view_config, view_proj)
    S, L, T = entries.shape[0], entries.shape[1], entries.shape[2]
    return unpack_frame_uniforms(torch.from_numpy(blob).to(device), S, L, T)
