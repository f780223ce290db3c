"""Hand-written CUDA kernels of the frame hot path, with their plain versions.

The counterpart of the JAX package's ``ops/pallas_kernels.py``. Each kernel
here has three parts:

* the wrapper (:func:`mesh_fused_planar`): on a CUDA tensor it launches the
  kernel from ``csrc/`` on the current stream, or raises; on a CPU tensor
  it calls the plain version. It counts its kernel launches in a plain
  integer attribute (``mesh_fused_planar.launches``);
* the plain PyTorch version (:func:`mesh_fused_planar_reference`), the same
  function batched over tiles, used by the CPU tests and as the yardstick
  on the card;
* the build: ``nvcc`` compiles ``csrc/*.cu`` for sm_90a into a shared
  library with a plain C interface under ``build/kernels/`` (keyed by a
  hash of the sources and flags), at first use, loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from bevy_terrain_tpu_torch.math.coordinate import C_SQR
from bevy_terrain_tpu_torch.ops.params import FrameUniforms, StaticTerrainConfig

GV = 17  # vertices per tile axis (grid_size 16)
K = 33  # half-grid points per axis
P = 64  # patch extent in texels
OUT_CH = 6  # [height, pos x, pos y, pos z, morphed u, morphed v]
FS_LEN = 48
TILES_PER_STEP = 64  # the high-precision flag covers 64 tiles (the JAX kernel's step)

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

# The JAX kernel's ``ablate`` names (a measurement harness: each removes a
# named piece of the fused mesh kernels, to attribute their time by timed
# variants; csrc/mesh_fused.cu says what each removes) and their bits in the
# CUDA kernels' compile-time mask.
ABLATE_BITS = {"no_taylor": 1, "reuse_far": 2, "no_smooth": 4, "no_phase_a": 8,
               "alb_no_unpack": 16, "alb_no_dots": 32, "alb_no_store": 64,
               "alb_no_interp": 128}
# the names each kernel reads (those the JAX kernel body reads on the variant)
MESH_ABLATE = frozenset({"no_smooth", "no_phase_a"})
SPHERE_ABLATE = MESH_ABLATE | {"no_taylor", "reuse_far"}
ALBEDO_ABLATE = frozenset({"alb_no_unpack", "alb_no_dots", "alb_no_store", "alb_no_interp"})
# the pieces that turn the albedo's bf16 fast path off, as in the JAX kernel
ALBEDO_EXACT_ABLATE = frozenset({"alb_no_unpack", "alb_no_dots", "alb_no_store"})
# the pairs the JAX package's ablation tools time, instantiated beside the
# single names (no other combination has a CUDA instance)
ABLATE_PAIRS = (frozenset({"reuse_far", "no_taylor"}), frozenset({"alb_no_dots", "alb_no_store"}))


def ablation_masks(names: frozenset) -> frozenset:
    """The masks with a CUDA instance for a kernel reading ``names``: each
    name alone and each of :data:`ABLATE_PAIRS` within ``names``."""
    sets = [frozenset({n}) for n in names] + [p for p in ABLATE_PAIRS if p <= names]
    return frozenset(sum(ABLATE_BITS[n] for n in s) for s in sets)


def ablation_mask(ablate, names: frozenset, kernel: str) -> int:
    """The mask of the ``ablate`` names for a kernel reading ``names``;
    raises ValueError on any other name."""
    ablate = frozenset(ablate)
    other = ablate - names
    if other:
        raise ValueError(f"{kernel} reads no ablate name {sorted(other)} "
                         f"(it reads {sorted(names)})")
    return sum(ABLATE_BITS[n] for n in ablate)


def ablate_label(ablate) -> str:
    """A variant's name: its ablate names joined by '+', or 'full'."""
    return "+".join(sorted(ablate)) or "full"


def pack_mesh_scalars(uniforms: FrameUniforms, cfg: StaticTerrainConfig,
                      max_value: float) -> torch.Tensor:
    """(48,) f32 frame scalars for the mesh kernel, laid out as the JAX
    package's pack_mesh_scalars: 0:12 world_from_local, 12:15 planar
    distance base, 15:18 up normal, 18:30 morph/blend/height scalars,
    30:39 normal_matrix, 39:42 view position, 42 1/radius, 43/44 log2 of
    the morph/blend distance bases, 45 precision threshold squared,
    46 terrain scale, 47 zero."""
    m = uniforms.world_from_local  # (3, 4)
    n = uniforms.normal_matrix[:, 1]
    n = n / torch.linalg.vector_norm(n)
    base = m[:, 3] + uniforms.approximate_height * n - uniforms.view_world_position
    dev = m.device

    def f32(x):  # a device scalar without a host-to-device copy
        return torch.full((), x, dtype=torch.float32, device=dev)

    scalars = torch.stack([
        2.0 * uniforms.morph_distance,  # 18
        uniforms.morph_range,  # 19
        uniforms.blend_distance,  # 20
        uniforms.blend_range,  # 21
        uniforms.min_height,  # 22
        (uniforms.max_height - uniforms.min_height) / max_value,  # 23
        f32(1.0 if cfg.morph else 0.0),  # 24
        f32(1.0 if cfg.blend else 0.0),  # 25
        f32(float(np.float32(cfg.lod_count) - np.float32(0.00001))),  # 26
        uniforms.precision_threshold_distance,  # 27
        f32(2.0 ** -cfg.origin_lod),  # 28
        uniforms.approximate_height,  # 29
    ])
    return torch.cat([
        m.reshape(12), base, n, scalars,
        uniforms.normal_matrix.reshape(9),  # 30:39
        uniforms.view_world_position,  # 39:42
        (1.0 / torch.linalg.vector_norm(m[:, 0]))[None],  # 42
        torch.log2(2.0 * uniforms.morph_distance)[None],  # 43
        torch.log2(uniforms.blend_distance)[None],  # 44
        (uniforms.precision_threshold_distance
         * uniforms.precision_threshold_distance)[None],  # 45
        uniforms.terrain_scale.reshape(1),  # 46
        torch.zeros(1, dtype=torch.float32, device=dev),  # 47
    ]).to(torch.float32)


# ---------------------------------------------------------------------------
# Planar fused mesh kernel
# ---------------------------------------------------------------------------


def _check_mesh_args(block_array, ids, geom, tile_params, fs, tile_count,
                     n_params: int = 4, quad_rows: int = 32) -> int:
    n = ids.shape[0] if ids.dim() == 1 else -1
    return _check_args(block_array, ids, geom, tile_count, quad_rows, (
        (tile_params, torch.float32, (n, n_params), "tile_params"),
        (fs, torch.float32, (FS_LEN,), "fs"),
    ))


def _check_tensors(block_array, quad_rows: int, more) -> None:
    """Check the quads of a kernel call and ``more`` (tensor, dtype, shape,
    name) entries: one device, dtypes, shapes, contiguity, alignment."""
    dev = block_array.device
    checks = (
        (block_array, torch.int32, (block_array.shape[0], quad_rows, 128), "block_array"),
        *more,
    )
    for x, dtype, shape, name in checks:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, block_array on {dev}")
        if x.dtype != dtype or tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and block_array.data_ptr() % 16:
        raise ValueError("block_array must be 16-byte aligned")


def _check_args(block_array, ids, geom, tile_count, quad_rows: int, more) -> int:
    """Check the quads, ids, geom and tile_count of a kernel call and
    ``more`` (tensor, dtype, shape, name) entries (:func:`_check_tensors`).
    Returns the tile count n."""
    dev = block_array.device
    if ids.dim() != 1:
        raise ValueError("ids must be 1-d")
    n = ids.shape[0]
    _check_tensors(block_array, quad_rows, (
        (ids, torch.int32, (n,), "ids"),
        (geom, torch.float32, (n, 8), "geom"),
        *more,
    ))
    if (tile_count.device != dev or tile_count.dtype != torch.int32
            or tile_count.numel() != 1):
        raise ValueError("tile_count must be one int32 on the blocks' device")
    return n


def mesh_fused_planar(block_array: torch.Tensor, ids: torch.Tensor,
                      geom: torch.Tensor, tile_params: torch.Tensor,
                      fs: torch.Tensor, tile_count: torch.Tensor,
                      ablate: frozenset = frozenset()) -> torch.Tensor:
    """The planar vertex stage of one frame: quad fetch, mean-centred tent
    resample to the 33x33 half-grid, 1-2-1 smoothing for the coarser data
    lod, CDLOD morph, 3x3 window interpolation, per-vertex blend, heights
    and world positions.

    Args:
      block_array: (N, 32, 128) int32 row-interleaved block quads.
      ids: (Fp,) int32 quad id per tile (PatchBatch.ids, sorted order).
      geom: (Fp, 8) f32 PatchBatch.geom [p0x, p0y, dp, valid, ratio, 0, 0, 0].
      tile_params: (Fp, 4) f32 [live, lod, x, y] per tile.
      fs: (48,) f32 frame scalars (:func:`pack_mesh_scalars`).
      tile_count: int32 tensor of one element on the same device; tiles at
        index >= tile_count come out as zeros.
      ablate: names of kernel pieces to remove (the JAX kernel's ``ablate``;
        a measurement harness): ``no_smooth``, ``no_phase_a``
        (csrc/mesh_fused.cu). Empty: the production kernel. An ablated
        call on the card launches an instance of the ablation library
        (:func:`build_ablation_library`), counted in
        ``mesh_fused_planar.ablated_launches`` by :func:`ablate_label`.

    Returns (Fp, 6, 17, 17) f32: per tile, channels [height, pos x, pos y,
    pos z, morphed u, morphed v] on the (row = v, column = u) vertex grid.

    On a CUDA tensor this launches ``csrc/mesh_fused.cu`` (and raises if it
    cannot); on a CPU tensor it returns the plain version.
    """
    n = _check_mesh_args(block_array, ids, geom, tile_params, fs, tile_count)
    mask = ablation_mask(ablate, MESH_ABLATE, "mesh_fused_planar")
    if block_array.device.type == "cpu":
        return mesh_fused_planar_reference(block_array, ids, geom, tile_params, fs,
                                           tile_count, ablate)
    out = torch.empty((n, OUT_CH, GV, GV), dtype=torch.float32, device=block_array.device)
    if n == 0:
        return out
    _launch(mesh_fused_planar, block_array.device, "mesh_fused_planar_launch",
            block_array.data_ptr(), block_array.shape[0], ids.data_ptr(), geom.data_ptr(),
            tile_params.data_ptr(), fs.data_ptr(), tile_count.data_ptr(), out.data_ptr(), n,
            MESH_WAVES, ablate=(ablate, mask, MESH_ABLATE))
    return out


mesh_fused_planar.launches = 0
mesh_fused_planar.ablated_launches = {}


def _smooth_matrix(device) -> torch.Tensor:
    """(33, 33) 1-2-1 smoothing with duplicated boundary rows."""
    A = np.zeros((K, K), np.float32)
    for i in range(K):
        A[i, max(i - 1, 0)] += 0.25
        A[i, i] += 0.5
        A[i, min(i + 1, K - 1)] += 0.25
    return torch.from_numpy(A).to(device)


def _patch(quads: torch.Tensor) -> torch.Tensor:
    """(n, 32, 128) quads -> (n, 64, 64) patches in natural texel order."""
    return torch.cat([quads[:, :, :P], quads[:, :, P:]], dim=1)


def _tents(geom, koff: float = 0.0):
    """The x and y tent weights of each tile's 33 half-grid positions
    clip(p0 + (k + koff) * dp, 0, 63) over the 64 patch texels: (wx, wy),
    (n, 33, 64) each, in geom's dtype."""
    dt, dev = geom.dtype, geom.device
    k = torch.arange(K, dtype=dt, device=dev) + koff
    r = torch.arange(P, dtype=dt, device=dev)
    dp = geom[:, 2:3]

    def tents(p0):
        p = (p0[:, None] + k[None, :] * dp).clamp(0.0, P - 1.0)
        return (1.0 - torch.abs(p[..., None] - r)).clamp(min=0.0)

    return tents(geom[:, 0]), tents(geom[:, 1])


def _centred_halfgrid(block_array, ids, geom):
    """The tent resample of each tile's mean-centred quad to the 33x33
    half-grid: (Hc (n, 33, 33) natural order, before the mean is added
    back; the patch means c (n, 1, 1)), in geom's dtype."""
    dt = geom.dtype
    patch = _patch(block_array[ids.long()].to(dt))  # (n, 64, 64)
    c = patch.mean(dim=(1, 2))[:, None, None]
    wx, wy = _tents(geom)
    rows = torch.einsum("nkr,nrc->nkc", wy, patch - c)
    return torch.einsum("nkc,nlc->nkl", rows, wx), c


def _halfgrids(block_array, ids, geom, ablate=frozenset()):
    """Phases 1-3 of both mesh kernels, batched over tiles: the mean-centred
    tent resample of each tile's quad to the 33x33 half-grid, H, and its
    1-2-1 smoothed copy, Hs (both (n, 33, 33), natural order), in geom's
    dtype. ``ablate``: with ``no_phase_a`` H is zeros (the CUDA kernel's
    half-grids, zeroed once, never written); with ``no_smooth`` Hs is None
    (no smoothing pass)."""
    if "no_phase_a" in ablate:
        H = torch.zeros((ids.shape[0], K, K), dtype=geom.dtype, device=block_array.device)
    else:
        Hc, c = _centred_halfgrid(block_array, ids, geom)
        H = Hc + c
    if "no_smooth" in ablate:
        return H, None
    A = _smooth_matrix(block_array.device).to(geom.dtype)
    Hs = torch.einsum("nkl,ml->nkm", torch.einsum("ij,njl->nil", A, H), A)
    return H, Hs


def unpack(words: torch.Tensor, c: int, bits: int) -> torch.Tensor:
    """Channel ``c`` of packed int32 words (``bits`` per channel, channel c
    in bits [c * bits, (c + 1) * bits)); ``bits`` 0 is the raw word. The
    mask after torch's arithmetic shift makes it a logical one."""
    if bits == 0:
        return words
    return (words >> (bits * c)) & ((1 << bits) - 1)


def _channel_halfgrids(words, geom, channels: int, bits: int, fast: bool,
                       ablate=frozenset()):
    """The 33x33 half-grids of ``channels`` packed channels of each tile's
    quad of words (n, 32, 128), resampled with the tile's tents: (n, C, 33,
    33) raw texel values in geom's dtype.

    Exact (``fast`` False): per channel the mean-centred f32 resample, the
    mean an exact integer sum. Fast (the JAX kernel's bf16 MXU path): tent
    weights rounded to bf16, no centring, the y contraction summed in f32
    and rounded to bf16, then the x contraction in f32.

    ``ablate`` (csrc/mesh_fused.cu; the first three albedo names take the
    exact path): ``no_phase_a``: zeros;
    ``alb_no_unpack``: every channel the raw signed word; ``alb_no_dots``:
    each grid its mean plus its mean; ``alb_no_store``: the channels'
    mean-centred resamples summed into channel 0, the others zeros."""
    dt = geom.dtype
    if "no_phase_a" in ablate:
        return torch.zeros((words.shape[0], channels, K, K), dtype=dt, device=words.device)
    fast = fast and not ALBEDO_EXACT_ABLATE & frozenset(ablate)
    if "alb_no_unpack" in ablate:
        bits = 0
    q = _patch(words)
    wx, wy = _tents(geom)
    if fast:
        wx, wy = (w.to(torch.bfloat16).to(dt) for w in (wx, wy))
    grids = []
    for c in range(channels):
        t = unpack(q, c, bits)
        tf = t.to(dt)
        if fast:
            rows = torch.einsum("nkr,nrc->nkc", wy, tf).to(torch.bfloat16).to(dt)
            grids.append(torch.einsum("nkc,nlc->nkl", rows, wx))
        else:
            total = t.sum(dim=(1, 2), dtype=torch.int64).to(torch.float64)
            m = (total / (P * P)).to(dt)[:, None, None]
            if "alb_no_dots" in ablate:
                centred = m.expand(-1, K, K)
            else:
                rows = torch.einsum("nkr,nrc->nkc", wy, tf - m)
                centred = torch.einsum("nkc,nlc->nkl", rows, wx)
            grids.append(centred if "alb_no_store" in ablate else centred + m)
    if "alb_no_store" in ablate:
        out = torch.zeros((q.shape[0], channels, K, K), dtype=dt, device=q.device)
        out[:, 0] = sum(grids[1:], grids[0])
        return out
    return torch.stack(grids, dim=1)


def _vertex_grid(device, dtype):
    """Vertex indices and uvs: (gi (17,), i (1, 17, 1) rows = v,
    j (1, 1, 17) columns = u, u, v)."""
    gi = torch.arange(GV, device=device)
    i = gi.view(1, GV, 1)
    j = gi.view(1, 1, GV)
    u = j.to(dtype) * (1.0 / (GV - 1.0))
    v = i.to(dtype) * (1.0 / (GV - 1.0))
    return gi, i, j, u, v


def _window(mu, mv, gi, i, j):
    """The 3x3 tent window at per-vertex uvs (mu, mv), (n, 17, 17) each.
    Returns ``interp9(S)``: the window applied to half-grids S (n, 33, 33),
    (n, 17, 17) values."""
    dt = mu.dtype
    lxw = mu * (2.0 * (GV - 1.0)) - (2 * j - 2).clamp(min=0).to(dt)
    lyw = mv * (2.0 * (GV - 1.0)) - (2 * i - 2).clamp(min=0).to(dt)
    wyb = [(1.0 - torch.abs(lyw - b)).clamp(min=0.0) for b in range(3)]
    wxa = [(1.0 - torch.abs(lxw - a)).clamp(min=0.0) for a in range(3)]

    def tap(idx, b):  # natural half-grid index of window tap b of vertex idx
        return torch.where(idx == 0, 0, 2 * idx - 2 + b)

    def interp9(S):
        h = torch.zeros((S.shape[0], GV, GV), dtype=dt, device=S.device)
        for b in range(3):
            rows_b = S[:, tap(gi, b)]  # (n, 17, 33)
            for a in range(3):
                h = h + wyb[b] * wxa[a] * rows_b[:, :, tap(gi, a)]
        return h

    return interp9


def _morph_window_height(H, Hs, lodf, log2_dist, valid, live, fs, gi, i, j, u, v):
    """The per-vertex stage both kernels share: CDLOD morph toward the even
    grid, 3x3 tent window of the fine and smoothed half-grids at the
    morphed uv, per-vertex blend, height (``Hs`` None: the smoothed height
    is the fine one). Returns (height, mu, mv, interp9), ``interp9`` the
    window at the morphed uv (:func:`_window`)."""
    dt = H.dtype
    target_lod = fs[43] - log2_dist
    mr = ((lodf + fs[19] - target_lod) * (1.0 / fs[19])).clamp(0.0, 1.0)
    mr = torch.where(lodf == 0.0, 0.0, mr) * fs[24]
    even_u = (j & ~1).to(dt) * (1.0 / (GV - 1.0))
    even_v = (i & ~1).to(dt) * (1.0 / (GV - 1.0))
    mu = u + (even_u - u) * mr
    mv = v + (even_v - v) * mr
    interp9 = _window(mu, mv, gi, i, j)

    h_fine = interp9(H)
    h_smooth = h_fine if Hs is None else interp9(Hs)

    btarget = torch.minimum(fs[44] - log2_dist, fs[26])
    blod = btarget.clamp(min=0.0).to(torch.int32).to(dt)
    bratio = torch.where(
        blod == 0.0, 0.0, ((blod + fs[21] - btarget) * (1.0 / fs[21])).clamp(0.0, 1.0)
    ) * fs[25]
    h_norm = (h_fine + (h_smooth - h_fine) * bratio) * valid
    height = (fs[22] + fs[23] * h_norm) * live
    return height, mu, mv, interp9


def _dead_to_zero(out, tile_count):
    n = out.shape[0]
    alive = torch.arange(n, device=out.device) < tile_count.reshape(())
    return torch.where(alive.view(n, 1, 1, 1), out, 0.0)


class _PlanarStage(NamedTuple):
    """The planar kernel's per-vertex values, (n, 17, 17) each (``valid``,
    ``live`` and ``lodf`` (n, 1, 1)), before the live and dead-tile masks
    of the output."""

    height: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    mu: torch.Tensor
    mv: torch.Tensor
    interp9: Callable
    valid: torch.Tensor
    live: torch.Tensor
    lodf: torch.Tensor

    def mesh_rows(self) -> torch.Tensor:
        """(n, 6, 17, 17): [height, pos x, pos y, pos z, morphed u, morphed v]."""
        live = self.live
        return torch.stack([self.height, self.px * live, self.py * live, self.pz * live,
                            self.mu * live, self.mv * live], dim=1)


def _planar_stage(block_array, ids, geom, tile_params, fs, ablate=frozenset()) -> _PlanarStage:
    n = ids.shape[0]
    H, Hs = _halfgrids(block_array, ids, geom, ablate)
    gi, i, j, u, v = _vertex_grid(block_array.device, geom.dtype)
    live, lodf, xf, yf = (tile_params[:, s].view(n, 1, 1) for s in range(4))
    valid = geom[:, 3].view(n, 1, 1)
    inv_count = torch.exp2(-lodf)

    lx = (xf + u) * inv_count - 0.5
    lz = (yf + v) * inv_count - 0.5
    dx = fs[0] * lx + fs[2] * lz + fs[12]
    dy = fs[4] * lx + fs[6] * lz + fs[13]
    dz = fs[8] * lx + fs[10] * lz + fs[14]
    d2 = dx * dx + dy * dy + dz * dz
    log2_dist = 0.5 * torch.log2(d2)
    height, mu, mv, interp9 = _morph_window_height(H, Hs, lodf, log2_dist, valid, live, fs,
                                                   gi, i, j, u, v)

    mlx = (xf + mu) * inv_count - 0.5
    mlz = (yf + mv) * inv_count - 0.5
    px = fs[0] * mlx + fs[2] * mlz + fs[3] + height * fs[15]
    py = fs[4] * mlx + fs[6] * mlz + fs[7] + height * fs[16]
    pz = fs[8] * mlx + fs[10] * mlz + fs[11] + height * fs[17]
    return _PlanarStage(height, px, py, pz, mu, mv, interp9, valid, live, lodf)


def mesh_fused_planar_reference(block_array: torch.Tensor, ids: torch.Tensor,
                                geom: torch.Tensor, tile_params: torch.Tensor,
                                fs: torch.Tensor, tile_count: torch.Tensor,
                                ablate: frozenset = frozenset()) -> torch.Tensor:
    """Plain PyTorch version of :func:`mesh_fused_planar` (same arguments,
    same result), batched over tiles on any device."""
    ablation_mask(ablate, MESH_ABLATE, "mesh_fused_planar")
    stage = _planar_stage(block_array, ids, geom, tile_params, fs, ablate)
    return _dead_to_zero(stage.mesh_rows(), tile_count)


# ---------------------------------------------------------------------------
# Spherical fused mesh kernel (cube sphere / ellipsoid, Taylor near field)
# ---------------------------------------------------------------------------

# tile_params columns of the spherical kernel (meshgen.fused_kernel_args):
# [live, lod, x, y, side, Taylor c c_s c_t c_ss c_st c_tt (xyz each),
#  origin_xy (2), origin_uv (2), WM (3x3 row-major), NM (3x3 row-major)]
SPH_PARAMS = 45
_TAYLOR, _OXY, _OUV, _WM, _NM = 5, 23, 25, 27, 36
SPH_CH = 9  # [height, pos xyz, morphed uv, normal xyz]


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x) as two correctly rounded f32 ops: the CUDA kernel's
    ``1.0f / sqrtf(x)`` (not ``rsqrtf``, which is within 2 ulp only)."""
    return torch.sqrt(x).reciprocal()


def _check_spherical_args(block_array, ids, geom, tile_params, fs, hp_steps, tile_count,
                          origin_lod) -> int:
    n = _check_mesh_args(block_array, ids, geom, tile_params, fs, tile_count, SPH_PARAMS)
    _check_step_args(n, hp_steps, block_array.device, origin_lod)
    return n


def _check_step_args(n: int, hp_steps, device, origin_lod) -> None:
    """The spherical kernels' step flags and Taylor origin lod."""
    if n % TILES_PER_STEP:
        raise ValueError(f"the tile count {n} is not a multiple of {TILES_PER_STEP}")
    if (hp_steps.device != device or hp_steps.dtype != torch.int32
            or tuple(hp_steps.shape) != (n // TILES_PER_STEP,) or not hp_steps.is_contiguous()):
        raise ValueError(f"hp_steps: want int32 ({n // TILES_PER_STEP},) on the blocks' "
                         f"device, got {hp_steps.dtype} {tuple(hp_steps.shape)}")
    if not 0 <= origin_lod < 31:
        raise ValueError(f"origin_lod {origin_lod} out of range")


def mesh_fused_spherical(block_array: torch.Tensor, ids: torch.Tensor, geom: torch.Tensor,
                         tile_params: torch.Tensor, fs: torch.Tensor, hp_steps: torch.Tensor,
                         tile_count: torch.Tensor, origin_lod: int, ellipsoidal: bool,
                         ablate: frozenset = frozenset()) -> torch.Tensor:
    """The spherical vertex stage of one frame: the planar kernel's quad
    fetch, resample, smoothing, morph, window and blend, with cube-sphere
    world positions and unit normals, and on high-precision steps the
    Taylor view-relative position near the view.

    Args:
      block_array, ids, geom, fs, tile_count: as :func:`mesh_fused_planar`.
      tile_params: (Fp, 45) f32 per tile, columns as :data:`SPH_PARAMS`
        documents (meshgen.fused_kernel_args builds it).
      hp_steps: (Fp / 64,) int32 flag per 64-tile step: 0 dead, 1 live,
        2 live and possibly inside the precision threshold (the Taylor
        near field is taken only on steps flagged 2).
      origin_lod: the Taylor origin lod (``fs[28]`` is ``2^-origin_lod``).
      ellipsoidal: normals from the normal matrix (NM columns) instead of
        the sphere's position / radius.
      ablate: as :func:`mesh_fused_planar`'s, and ``no_taylor``,
        ``reuse_far``.

    Returns (Fp, 9, 17, 17) f32: per tile, channels [height, pos x, pos y,
    pos z, morphed u, morphed v, normal x, normal y, normal z].

    On a CUDA tensor this launches ``csrc/mesh_fused.cu`` (and raises if it
    cannot); on a CPU tensor it returns the plain version.
    """
    n = _check_spherical_args(block_array, ids, geom, tile_params, fs, hp_steps, tile_count,
                              origin_lod)
    mask = ablation_mask(ablate, SPHERE_ABLATE, "mesh_fused_spherical")
    if block_array.device.type == "cpu":
        return mesh_fused_spherical_reference(block_array, ids, geom, tile_params, fs,
                                              hp_steps, tile_count, origin_lod, ellipsoidal,
                                              ablate)
    out = torch.empty((n, SPH_CH, GV, GV), dtype=torch.float32, device=block_array.device)
    if n == 0:
        return out
    _launch(mesh_fused_spherical, block_array.device, "mesh_fused_spherical_launch",
            block_array.data_ptr(), block_array.shape[0], ids.data_ptr(), geom.data_ptr(),
            tile_params.data_ptr(), fs.data_ptr(), hp_steps.data_ptr(), tile_count.data_ptr(),
            out.data_ptr(), n, int(origin_lod), int(bool(ellipsoidal)), MESH_WAVES,
            ablate=(ablate, mask, SPHERE_ABLATE))
    return out


mesh_fused_spherical.launches = 0
mesh_fused_spherical.ablated_launches = {}


def mesh_fused_spherical_reference(block_array: torch.Tensor, ids: torch.Tensor,
                                   geom: torch.Tensor, tile_params: torch.Tensor,
                                   fs: torch.Tensor, hp_steps: torch.Tensor,
                                   tile_count: torch.Tensor, origin_lod: int,
                                   ellipsoidal: bool,
                                   ablate: frozenset = frozenset()) -> torch.Tensor:
    """Plain PyTorch version of :func:`mesh_fused_spherical` (same
    arguments, same result), batched over tiles on any device, in the
    kernel's operation order. It computes in the dtype of ``geom``,
    ``tile_params`` and ``fs``: float32 is the kernel's function; float64
    evaluates the same arithmetic nearly exactly (the tests' referee)."""
    ablation_mask(ablate, SPHERE_ABLATE, "mesh_fused_spherical")
    rows, _, _, _ = _spherical_stage(block_array, ids, geom, tile_params, fs, hp_steps,
                                     origin_lod, ellipsoidal, ablate)
    return _dead_to_zero(rows, tile_count)


def _spherical_stage(block_array, ids, geom, tile_params, fs, hp_steps, origin_lod,
                     ellipsoidal, ablate=frozenset()):
    """The spherical kernel's per-vertex stage, batched over tiles: (the
    nine mesh rows (n, 9, 17, 17) before the dead-tile mask, ``interp9``
    the 3x3 window at the morphed uv (:func:`_window`), ``valid`` and
    ``live`` (n, 1, 1)). ``ablate``: ``no_taylor``: no vertex takes the
    near field; ``reuse_far``: the unmorphed position and normal."""
    n = ids.shape[0]
    dev = block_array.device
    dt, i32 = geom.dtype, torch.int32
    H, Hs = _halfgrids(block_array, ids, geom, ablate)
    gi, i, j, u, v = _vertex_grid(dev, dt)

    def col(c):
        return tile_params[:, c].view(n, 1, 1)

    live, lodf, xf, yf = col(0), col(1), col(2), col(3)
    valid = geom[:, 3].view(n, 1, 1)
    inv_count = torch.exp2(-lodf)
    wm = [col(_WM + r) for r in range(9)]
    nm = [col(_NM + r) for r in range(9)]

    def far_geom(uu, vv):
        """Cube-sphere world position + unit world normal at tile uv."""
        wxp = 2.0 * ((xf + uu) * inv_count) - 1.0
        wyp = 2.0 * ((yf + vv) * inv_count) - 1.0
        # the warp constant as the JAX kernel rounds it: f32(C_SQR) and
        # f32(1 + C_SQR), each rounded once from the double
        pxs = wxp * rsqrt((1.0 + C_SQR) - C_SQR * wxp * wxp)
        pys = wyp * rsqrt((1.0 + C_SQR) - C_SQR * wyp * wyp)
        inv_n = rsqrt(1.0 + pxs * pxs + pys * pys)
        pxn = pxs * inv_n
        pyn = pys * inv_n
        sx = wm[0] * pxn + wm[1] * pyn + wm[2] * inv_n
        sy = wm[3] * pxn + wm[4] * pyn + wm[5] * inv_n
        sz = wm[6] * pxn + wm[7] * pyn + wm[8] * inv_n
        w = (sx + fs[3], sy + fs[7], sz + fs[11])
        if ellipsoidal:
            nx = nm[0] * pxs + nm[1] * pys + nm[2]
            ny = nm[3] * pxs + nm[4] * pys + nm[5]
            nz = nm[6] * pxs + nm[7] * pys + nm[8]
            ninv = rsqrt(nx * nx + ny * ny + nz * nz)
            return w, (nx * ninv, ny * ninv, nz * ninv)
        return w, (sx * fs[42], sy * fs[42], sz * fs[42])

    xi, yi, lodi = xf.to(i32), yf.to(i32), lodf.to(i32)
    down = (lodi - origin_lod).clamp(min=0)
    up = (origin_lod - lodi).clamp(min=0)
    is_dn = lodi >= origin_lod
    scale_dn = torch.exp2(-down.to(dt))
    scale_up = torch.exp2(up.to(dt))
    oxy = (col(_OXY).to(i32), col(_OXY + 1).to(i32))
    ouv = (col(_OUV), col(_OUV + 1))
    taylor = [col(_TAYLOR + r) for r in range(18)]

    def taylor_rel(uu, vv):
        """Taylor view-relative position: re-anchor at origin_lod with exact
        integer cancellation, then the second-order polynomial."""
        st = []
        for a, (ci, cc) in enumerate(((xi, uu), (yi, vv))):
            o_dn = ci >> down
            ou_dn = ((ci & ((1 << down) - 1)).to(dt) + cc) * scale_dn
            su = cc * scale_up
            fu = torch.floor(su)
            o_up = (ci << up) + fu.to(i32)
            oi = torch.where(is_dn, o_dn, o_up)
            ou = torch.where(is_dn, ou_dn, su - fu)
            st.append(((oi - oxy[a]).to(dt) + (ou - ouv[a])) * fs[28])
        s, t = st
        return tuple(
            taylor[c] + taylor[3 + c] * s + taylor[6 + c] * t + taylor[9 + c] * s * s
            + taylor[12 + c] * s * t + taylor[15 + c] * t * t
            for c in range(3)
        )

    hp_on = (hp_steps == 2).repeat_interleave(TILES_PER_STEP).view(n, 1, 1)
    (wx0, wy0, wz0), (nx0, ny0, nz0) = far_geom(u, v)
    dwx = wx0 + fs[29] * nx0 - fs[39]
    dwy = wy0 + fs[29] * ny0 - fs[40]
    dwz = wz0 + fs[29] * nz0 - fs[41]
    d2_w0 = dwx * dwx + dwy * dwy + dwz * dwz
    rx0, ry0, rz0 = taylor_rel(u, v)
    dhx = rx0 + fs[29] * nx0
    dhy = ry0 + fs[29] * ny0
    dhz = rz0 + fs[29] * nz0
    near = (d2_w0 < fs[45]) & hp_on
    if "no_taylor" in ablate:
        near = torch.zeros_like(near)
    d2 = torch.where(near, dhx * dhx + dhy * dhy + dhz * dhz, d2_w0)
    log2_dist = 0.5 * torch.log2(d2)
    height, mu, mv, interp9 = _morph_window_height(H, Hs, lodf, log2_dist, valid, live, fs,
                                                   gi, i, j, u, v)

    if "reuse_far" in ablate:
        nx_f, ny_f, nz_f = nx0, ny0, nz0
        px = wx0 + height * nx_f
        py = wy0 + height * ny_f
        pz = wz0 + height * nz_f
    else:
        (wxm, wym, wzm), (nxm, nym, nzm) = far_geom(mu, mv)
        rxm, rym, rzm = taylor_rel(mu, mv)
        nx_f = torch.where(near, nx0, nxm)
        ny_f = torch.where(near, ny0, nym)
        nz_f = torch.where(near, nz0, nzm)
        px = torch.where(near, fs[39] + rxm, wxm) + height * nx_f
        py = torch.where(near, fs[40] + rym, wym) + height * ny_f
        pz = torch.where(near, fs[41] + rzm, wzm) + height * nz_f

    rows = torch.stack([height, px * live, py * live, pz * live, mu * live, mv * live,
                        nx_f * live, ny_f * live, nz_f * live], dim=1)
    return rows, interp9, valid, live


# ---------------------------------------------------------------------------
# Material kernels: packed albedo (K3), in-kernel PBR shade (K4), and the
# attachment samplers (K5)
# ---------------------------------------------------------------------------

MAX_CHANNELS = 4  # packed channels per int32 word
# The grids of the mesh kernels (K1, K2), of the material mesh kernels (K3,
# K3s, K4) and of the attachment samplers (K5), in waves of the blocks the
# card holds at once: each block walks an equal run of consecutive tiles in
# the plan's order and keeps the quads it holds while the tile ids repeat.
# Launch constants, read at each launch, chosen from timed variants on the
# H100 (PERF.md, chip_smoke.py's waves sweep); any value gives the same
# output bits.
MESH_WAVES = 1
MATERIAL_WAVES = 1
SAMPLER_WAVES = 1
SHADE_HEADER = 16  # floats before the light records of a material buffer
LIGHT_STRIDE = 16  # floats per light record
_LIGHT_KINDS = {"dir": 0, "point": 1, "spot": 2}


def pack_shade_spec(spec, device) -> torch.Tensor:
    """The in-kernel material (render/material.kernel_shade_spec: roughness,
    metallic, reflectance, emissive, ambient, lights, albedo max value) as
    the f32 buffer ``csrc/mesh_fused.cu`` reads.

    Header: [1 / alb_max, 1 - metallic, metallic, 0.16 reflectance^2
    (1 - metallic), a2, a2 - 1, 2 roughness, light count, emissive rgb,
    ambient rgb, 0, 0]; then per light [kind (0 directional, 1 point,
    2 spot), direction to the light (directional) or position, radiance
    rgb, 1 / range^2, unit spot axis, cos(outer), 1 / (cos(inner) -
    cos(outer)), 0, 0, 0]. Each constant is computed as the JAX kernel
    computes it: in float64 from the Python values (numpy float32 for the
    light directions and radiances) and rounded once to float32."""
    pr_f, metallic, reflectance, emissive, ambient, lights, alb_max = spec
    pr = float(np.clip(pr_f, 0.089, 1.0))
    rough = pr * pr
    a2 = rough * rough
    buf = np.zeros(SHADE_HEADER + LIGHT_STRIDE * len(lights), np.float32)
    buf[:8] = (1.0 / alb_max, 1.0 - metallic, metallic,
               0.16 * reflectance * reflectance * (1.0 - metallic), a2, a2 - 1.0,
               2.0 * rough, len(lights))
    buf[8:11] = emissive
    buf[11:14] = ambient
    for k, light in enumerate(lights):
        rec = buf[SHADE_HEADER + k * LIGHT_STRIDE:SHADE_HEADER + (k + 1) * LIGHT_STRIDE]
        kind = light[0]
        rec[0] = _LIGHT_KINDS[kind]
        if kind == "dir":
            _, d3, c3, illum = light
            d = np.asarray(d3, np.float32)
            rec[1:4] = -d / np.linalg.norm(d)
            rec[4:7] = np.asarray(c3, np.float32) * np.float32(illum)
            continue
        if kind == "spot":
            _, p3, d3, c3, inten, rng, inner, outer = light
            sd = np.asarray(d3, np.float32)
            rec[8:11] = sd / np.linalg.norm(sd)
            rec[11] = np.cos(outer)
            rec[12] = 1.0 / max(np.cos(inner) - np.cos(outer), 1e-4)
        else:
            _, p3, c3, inten, rng = light
        rec[1:4] = p3
        rec[4:7] = np.asarray(c3, np.float32) * np.float32(inten)
        rec[7] = 1.0 / (rng * rng)
    return torch.from_numpy(buf).to(device)


def _pow5(x):
    x2 = x * x
    return x2 * x2 * x


def pbr_shade_reference(shade, cols, height, px, py, pz, fs, lodf):
    """The in-kernel fragment stage (pallas_kernels.py _kernel_pbr_shade),
    batched over tiles in the kernel's operation order: the plain version
    of :func:`mesh_fused_shaded`'s shade phase. ``shade`` is the
    :func:`pack_shade_spec` buffer, ``cols`` the raw albedo channels (3 or
    4 of (n, 17, 17)), ``height`` and positions (n, 17, 17), ``lodf`` the
    tiles' lods (n, 1, 1). Returns the linear RGBA (or RGB) channels,
    unmasked."""
    s = [float(x) for x in shade.detach().cpu().numpy()]
    inv_max, one_m, metallic, f0c, a2, a2m1, two_rough, n_lights = s[:8]

    # normals from the tile's heights, one-sided at the tile edge
    spacing = (2.0 * fs[46]) * torch.exp2(-lodf) * (1.0 / (GV - 1.0))
    hi_u = torch.cat([height[:, :, 1:], height[:, :, -1:]], dim=2)
    lo_u = torch.cat([height[:, :, :1], height[:, :, :-1]], dim=2)
    hi_v = torch.cat([height[:, 1:], height[:, -1:]], dim=1)
    lo_v = torch.cat([height[:, :1], height[:, :-1]], dim=1)
    dh_du = (hi_u - lo_u) / (2.0 * spacing)
    dh_dv = (hi_v - lo_v) / (2.0 * spacing)
    ninv = 1.0 / torch.clamp(torch.sqrt(dh_du * dh_du + 1.0 + dh_dv * dh_dv), min=1e-8)
    nx, ny, nz = -dh_du * ninv, ninv, -dh_dv * ninv

    base = [cols[c] * inv_max for c in range(3)]
    alpha = cols[3] * inv_max if len(cols) > 3 else torch.ones_like(base[0])
    dc = [b * one_m for b in base]
    f0 = [f0c + b * metallic for b in base]
    vx, vy, vz = fs[39] - px, fs[40] - py, fs[41] - pz
    vinv = 1.0 / torch.clamp(torch.sqrt(vx * vx + vy * vy + vz * vz), min=1e-8)
    vx, vy, vz = vx * vinv, vy * vinv, vz * vinv
    nov = torch.clamp(nx * vx + ny * vy + nz * vz, min=1e-4)
    f90 = torch.clamp((f0[0] + f0[1] + f0[2]) * 16.5, 0.0, 1.0)
    pi_f, inv_pi_f = float(np.float32(np.pi)), float(np.float32(1.0 / np.pi))

    out = [torch.full_like(base[0], s[8 + c]) for c in range(3)]
    for k in range(int(n_lights)):
        rec = s[SHADE_HEADER + k * LIGHT_STRIDE:SHADE_HEADER + (k + 1) * LIGHT_STRIDE]
        kind = int(rec[0])
        atten = None
        if kind == 0:
            lx, ly, lz = rec[1], rec[2], rec[3]
        else:
            tx, ty, tz = rec[1] - px, rec[2] - py, rec[3] - pz
            d2l = torch.clamp(tx * tx + ty * ty + tz * tz, min=1e-4)
            dinv = 1.0 / torch.sqrt(d2l)
            lx, ly, lz = tx * dinv, ty * dinv, tz * dinv
            q = d2l * rec[7]
            window = torch.clamp(1.0 - q * q, 0.0, 1.0)
            atten = window * window / d2l
            if kind == 2:
                cos_a = -(lx * rec[8] + ly * rec[9] + lz * rec[10])
                sc = torch.clamp((cos_a - rec[11]) * rec[12], 0.0, 1.0)
                atten = atten * (sc * sc)
        hx, hy, hz = lx + vx, ly + vy, lz + vz
        hinv = 1.0 / torch.clamp(torch.sqrt(hx * hx + hy * hy + hz * hz), min=1e-8)
        hx, hy, hz = hx * hinv, hy * hinv, hz * hinv
        nol = torch.clamp(nx * lx + ny * ly + nz * lz, 0.0, 1.0)
        noh = torch.clamp(nx * hx + ny * hy + nz * hz, 0.0, 1.0)
        loh = torch.clamp(hx * lx + hy * ly + hz * lz, 0.0, 1.0)
        f = noh * noh * a2m1 + 1.0
        d_ggx = a2 / torch.clamp(pi_f * f * f, min=1e-8)
        lambda_v = nol * torch.sqrt((nov - a2 * nov) * nov + a2)
        lambda_l = nov * torch.sqrt((nol - a2 * nol) * nol + a2)
        v_smith = 0.5 / torch.clamp(lambda_v + lambda_l, min=1e-8)
        om = _pow5(1.0 - loh)
        fd90 = 0.5 + two_rough * loh * loh
        light_scatter = 1.0 + (fd90 - 1.0) * _pow5(1.0 - nol)
        view_scatter = 1.0 + (fd90 - 1.0) * _pow5(1.0 - nov)
        fd = light_scatter * view_scatter * inv_pi_f
        for c in range(3):
            fresnel = f0[c] + (f90 - f0[c]) * om
            spec = d_ggx * v_smith * fresnel
            contrib = (dc[c] * fd + spec) * rec[4 + c] * nol
            if atten is not None:
                contrib = contrib * atten
            out[c] = out[c] + contrib
    for c in range(3):
        out[c] = out[c] + dc[c] * s[11 + c]
    return [out[0], out[1], out[2], alpha][:len(cols)]


def _check_material_args(block_array, ids, geom, tile_params, fs, tile_count, albedo_blocks,
                         channels: int, bits: int, combined: bool, shade=None,
                         n_params: int = 4) -> int:
    n = _check_mesh_args(block_array, ids, geom, tile_params, fs, tile_count, n_params,
                         quad_rows=64 if combined else 32)
    if not (1 <= channels <= MAX_CHANNELS and bits in (8, 16) and channels * bits <= 32):
        raise ValueError(f"{channels} channels of {bits} bits do not pack into an int32 word")
    if combined != (albedo_blocks is None):
        raise ValueError("pass albedo_blocks, or combined (N, 64, 128) blocks, not both")
    extra = [] if combined else [(albedo_blocks, torch.int32, "albedo_blocks")]
    if shade is not None:
        extra.append((shade, torch.float32, "shade"))
        if shade.dim() != 1 or shade.numel() < SHADE_HEADER:
            raise ValueError("shade must be a pack_shade_spec buffer")
    for x, dtype, name in extra:
        if x.device != block_array.device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {dtype} tensor on {block_array.device}")
    if not combined:
        if tuple(albedo_blocks.shape) != tuple(block_array.shape):
            raise ValueError(f"albedo_blocks {tuple(albedo_blocks.shape)} do not pair with "
                             f"the height blocks {tuple(block_array.shape)}")
        if albedo_blocks.device.type == "cuda" and albedo_blocks.data_ptr() % 16:
            raise ValueError("albedo_blocks must be 16-byte aligned")
    return n


def _mesh_material(wrapper, block_array, ids, geom, tile_params, fs, tile_count,
                   albedo_blocks, channels, bits, fast, combined, shade, ablate):
    """K3 (``shade`` None) and K4: check, then the plain version on the CPU
    or the kernel on the card."""
    n = _check_material_args(block_array, ids, geom, tile_params, fs, tile_count,
                             albedo_blocks, channels, bits, combined, shade)
    names = MESH_ABLATE | ALBEDO_ABLATE
    mask = ablation_mask(ablate, names, wrapper.__name__)
    fast = bool(fast) and bits <= 8 and not ALBEDO_EXACT_ABLATE & frozenset(ablate)
    if block_array.device.type == "cpu":
        return _mesh_material_reference(block_array, ids, geom, tile_params, fs, tile_count,
                                        albedo_blocks, channels, bits, fast, combined, shade,
                                        ablate)
    out = torch.empty((n, OUT_CH + channels, GV, GV), dtype=torch.float32,
                      device=block_array.device)
    if n == 0:
        return out
    _launch(wrapper, block_array.device, "mesh_fused_material_launch",
            block_array.data_ptr(), block_array.shape[0], ids.data_ptr(), geom.data_ptr(),
            tile_params.data_ptr(), fs.data_ptr(), tile_count.data_ptr(),
            None if combined else albedo_blocks.data_ptr(), channels, bits, int(fast),
            int(combined), None if shade is None else shade.data_ptr(), out.data_ptr(), n,
            MATERIAL_WAVES, ablate=(ablate, mask, names))
    return out


def mesh_fused_albedo(block_array: torch.Tensor, ids: torch.Tensor, geom: torch.Tensor,
                      tile_params: torch.Tensor, fs: torch.Tensor, tile_count: torch.Tensor,
                      albedo_blocks: torch.Tensor | None, channels: int, bits: int,
                      fast: bool = True, combined: bool = False,
                      ablate: frozenset = frozenset()) -> torch.Tensor:
    """The planar vertex stage (:func:`mesh_fused_planar`) with a packed
    albedo fused in (the JAX kernel's ``albedo_channels``): per tile the
    albedo quad of the same quad id, resampled with the height's tents and
    read at the morphed uv through the height's window weights.

    Args:
      block_array, ids, geom, tile_params, fs, tile_count: as
        :func:`mesh_fused_planar`; with ``combined`` the blocks are (N, 64,
        128): heights in rows 0:32, the packed albedo in rows 32:64.
      albedo_blocks: (N, 32, 128) int32 packed albedo quads (same plan as
        the heights), or None with ``combined``.
      channels, bits: the first ``channels`` channels of ``bits`` bits each
        (channel c in bits [c * bits, (c + 1) * bits)); 3 skips the alpha.
      fast: the bf16 resample for channels of 8 bits (16-bit channels are
        always exact).
      ablate: as :func:`mesh_fused_planar`'s, and ``alb_no_unpack``,
        ``alb_no_dots``, ``alb_no_store``, ``alb_no_interp``
        (csrc/mesh_fused.cu). The first three take the exact path, as in
        the JAX kernel.

    Returns (Fp, 6 + C, 17, 17) f32: the six mesh channels, bit-identical to
    :func:`mesh_fused_planar`'s, then C channels of raw texel values x valid
    x live.
    """
    return _mesh_material(mesh_fused_albedo, block_array, ids, geom, tile_params, fs,
                          tile_count, albedo_blocks, channels, bits, fast, combined, None,
                          ablate)


mesh_fused_albedo.launches = 0
mesh_fused_albedo.ablated_launches = {}


def mesh_fused_shaded(block_array: torch.Tensor, ids: torch.Tensor, geom: torch.Tensor,
                      tile_params: torch.Tensor, fs: torch.Tensor, tile_count: torch.Tensor,
                      albedo_blocks: torch.Tensor | None, channels: int, bits: int,
                      shade: torch.Tensor, fast: bool = True,
                      combined: bool = False, ablate: frozenset = frozenset()) -> torch.Tensor:
    """:func:`mesh_fused_albedo` with the fragment stage on the albedo
    (the JAX kernel's ``shade``): central-difference normals over the tile's
    heights, Filament GGX + Smith + Schlick + Burley for every light of the
    material buffer ``shade`` (:func:`pack_shade_spec`), emissive and
    ambient. Returns (Fp, 6 + C, 17, 17): the mesh channels, then linear RGBA
    (C = 4) or RGB (C = 3) x valid x live. ``ablate``: as
    :func:`mesh_fused_albedo`'s."""
    return _mesh_material(mesh_fused_shaded, block_array, ids, geom, tile_params, fs,
                          tile_count, albedo_blocks, channels, bits, fast, combined, shade,
                          ablate)


mesh_fused_shaded.launches = 0
mesh_fused_shaded.ablated_launches = {}


def _albedo_cols(A, interp9, ablate):
    """The albedo channels at the vertices from their half-grids A (n, C,
    33, 33): the window at the morphed uv, or with ``alb_no_interp`` the
    half-grid point (tap(i, 2), tap(j, 1)) under each vertex."""
    if "alb_no_interp" not in ablate:
        return [interp9(A[:, c]) for c in range(A.shape[1])]
    gi = torch.arange(GV, device=A.device)
    rows, cols = 2 * gi, (2 * gi - 1).clamp(min=0)
    return [A[:, c][:, rows][:, :, cols] for c in range(A.shape[1])]


def _mesh_material_reference(block_array, ids, geom, tile_params, fs, tile_count,
                             albedo_blocks, channels, bits, fast, combined, shade,
                             ablate=frozenset()):
    ablation_mask(ablate, MESH_ABLATE | ALBEDO_ABLATE, "the material kernel")
    heights = block_array[:, :32] if combined else block_array
    words = (block_array[:, 32:] if combined else albedo_blocks)[ids.long()]
    stage = _planar_stage(heights, ids, geom, tile_params, fs, ablate)
    A = _channel_halfgrids(words, geom, channels, bits, fast and bits <= 8, ablate)
    cols = _albedo_cols(A, stage.interp9, ablate)
    if shade is not None:
        cols = pbr_shade_reference(shade, cols, stage.height, stage.px, stage.py, stage.pz,
                                    fs, stage.lodf)
    rows = [c * stage.valid * stage.live for c in cols]
    out = torch.cat([stage.mesh_rows(), torch.stack(rows, dim=1)], dim=1)
    return _dead_to_zero(out, tile_count)


def mesh_fused_albedo_reference(block_array, ids, geom, tile_params, fs, tile_count,
                                albedo_blocks, channels: int, bits: int, fast: bool = True,
                                combined: bool = False,
                                ablate: frozenset = frozenset()) -> torch.Tensor:
    """Plain PyTorch version of :func:`mesh_fused_albedo` (same arguments,
    same result), batched over tiles on any device."""
    return _mesh_material_reference(block_array, ids, geom, tile_params, fs, tile_count,
                                    albedo_blocks, channels, bits, fast, combined, None,
                                    ablate)


def mesh_fused_shaded_reference(block_array, ids, geom, tile_params, fs, tile_count,
                                albedo_blocks, channels: int, bits: int, shade,
                                fast: bool = True, combined: bool = False,
                                ablate: frozenset = frozenset()) -> torch.Tensor:
    """Plain PyTorch version of :func:`mesh_fused_shaded` (same arguments,
    same result), batched over tiles on any device."""
    return _mesh_material_reference(block_array, ids, geom, tile_params, fs, tile_count,
                                    albedo_blocks, channels, bits, fast, combined, shade,
                                    ablate)


def mesh_fused_spherical_albedo(block_array: torch.Tensor, ids: torch.Tensor,
                                geom: torch.Tensor, tile_params: torch.Tensor,
                                fs: torch.Tensor, hp_steps: torch.Tensor,
                                tile_count: torch.Tensor, origin_lod: int, ellipsoidal: bool,
                                albedo_blocks: torch.Tensor | None, channels: int, bits: int,
                                fast: bool = True, combined: bool = False,
                                ablate: frozenset = frozenset()) -> torch.Tensor:
    """The spherical vertex stage (:func:`mesh_fused_spherical`) with a
    packed albedo fused in (the JAX kernel's ``spherical=True`` with
    ``albedo_channels``): per tile the albedo quad of the same quad id,
    resampled with the height's tents and read at the morphed uv through
    the height's window weights. In the Taylor near field the normal is the
    unmorphed one; the albedo is read at the morphed uv all the same.

    Args:
      block_array, ids, geom, tile_params, fs, hp_steps, tile_count,
        origin_lod, ellipsoidal: as :func:`mesh_fused_spherical`; with
        ``combined`` the blocks are (N, 64, 128): heights in rows 0:32, the
        packed albedo in rows 32:64.
      albedo_blocks, channels, bits, fast, combined: as
        :func:`mesh_fused_albedo`.
      ablate: :func:`mesh_fused_spherical`'s names and
        :func:`mesh_fused_albedo`'s.

    Returns (Fp, 9 + C, 17, 17) f32: the nine mesh channels, bit-identical
    to :func:`mesh_fused_spherical`'s, then C channels of raw texel values
    x valid x live.

    On a CUDA tensor this launches ``csrc/mesh_fused.cu`` (and raises if it
    cannot); on a CPU tensor it returns the plain version.
    """
    n = _check_material_args(block_array, ids, geom, tile_params, fs, tile_count,
                             albedo_blocks, channels, bits, combined, n_params=SPH_PARAMS)
    _check_step_args(n, hp_steps, block_array.device, origin_lod)
    names = SPHERE_ABLATE | ALBEDO_ABLATE
    mask = ablation_mask(ablate, names, "mesh_fused_spherical_albedo")
    fast = bool(fast) and bits <= 8 and not ALBEDO_EXACT_ABLATE & frozenset(ablate)
    if block_array.device.type == "cpu":
        return mesh_fused_spherical_albedo_reference(
            block_array, ids, geom, tile_params, fs, hp_steps, tile_count, origin_lod,
            ellipsoidal, albedo_blocks, channels, bits, fast, combined, ablate)
    out = torch.empty((n, SPH_CH + channels, GV, GV), dtype=torch.float32,
                      device=block_array.device)
    if n == 0:
        return out
    _launch(mesh_fused_spherical_albedo, block_array.device,
            "mesh_fused_spherical_albedo_launch", block_array.data_ptr(),
            block_array.shape[0], ids.data_ptr(), geom.data_ptr(), tile_params.data_ptr(),
            fs.data_ptr(), hp_steps.data_ptr(), tile_count.data_ptr(),
            None if combined else albedo_blocks.data_ptr(), channels, bits, int(fast),
            int(combined), out.data_ptr(), n, int(origin_lod), int(bool(ellipsoidal)),
            MATERIAL_WAVES, ablate=(ablate, mask, names))
    return out


mesh_fused_spherical_albedo.launches = 0
mesh_fused_spherical_albedo.ablated_launches = {}


def mesh_fused_spherical_albedo_reference(block_array, ids, geom, tile_params, fs, hp_steps,
                                          tile_count, origin_lod: int, ellipsoidal: bool,
                                          albedo_blocks, channels: int, bits: int,
                                          fast: bool = True, combined: bool = False,
                                          ablate: frozenset = frozenset()) -> torch.Tensor:
    """Plain PyTorch version of :func:`mesh_fused_spherical_albedo` (same
    arguments, same result), batched over tiles on any device: the
    spherical plain version's mesh rows, then the albedo half-grids
    (:func:`_channel_halfgrids`) through its window at the morphed uv."""
    ablation_mask(ablate, SPHERE_ABLATE | ALBEDO_ABLATE, "mesh_fused_spherical_albedo")
    heights = block_array[:, :32] if combined else block_array
    words = (block_array[:, 32:] if combined else albedo_blocks)[ids.long()]
    rows, interp9, valid, live = _spherical_stage(heights, ids, geom, tile_params, fs,
                                                  hp_steps, origin_lod, ellipsoidal, ablate)
    A = _channel_halfgrids(words, geom, channels, bits, bool(fast) and bits <= 8, ablate)
    cols = torch.stack([c * valid * live for c in _albedo_cols(A, interp9, ablate)], dim=1)
    return _dead_to_zero(torch.cat([rows, cols], dim=1), tile_count)


def _check_attach_args(block_array, ids, geom, uvs, tile_count, channels, bits) -> int:
    n = ids.shape[0] if ids.dim() == 1 else -1
    n = _check_args(block_array, ids, geom, tile_count, 32,
                    ((uvs, torch.float32, (n, 2, GV, GV), "uvs"),))
    if not (1 <= channels <= MAX_CHANNELS and (bits == 0 and channels == 1 or bits in (8, 16))
            and channels * max(bits, 1) <= 32):
        raise ValueError(f"{channels} channels of {bits} bits do not pack into an int32 word")
    return n


def _attach(wrapper, block_array, ids, geom, uvs, tile_count, channels, bits):
    n = _check_attach_args(block_array, ids, geom, uvs, tile_count, channels, bits)
    if block_array.device.type == "cpu":
        return _attach_reference(block_array, ids, geom, uvs, tile_count, channels, bits)
    out = torch.empty((n, channels, GV, GV), dtype=torch.float32, device=block_array.device)
    if n == 0:
        return out
    _launch(wrapper, block_array.device, "attach_sample_launch", block_array.data_ptr(),
            block_array.shape[0], ids.data_ptr(), geom.data_ptr(), uvs.data_ptr(),
            tile_count.data_ptr(), channels, bits, out.data_ptr(), n, SAMPLER_WAVES)
    return out


def attach_sample_fused(block_array: torch.Tensor, ids: torch.Tensor, geom: torch.Tensor,
                        uvs: torch.Tensor, tile_count: torch.Tensor) -> torch.Tensor:
    """Sample one raw attachment channel at given vertex uvs: per tile the
    quad fetch, the mean-centred tent resample to the 33x33 half-grid, the
    3x3 window at the uvs, x valid (the JAX kernel attach_sample_fused).

    Args:
      block_array: (N, 32, 128) int32 quads, one raw channel per word.
      ids, geom, tile_count: the attachment's PatchBatch ids and geom (the
        frame's tile order) and the live tile count; tiles at index >=
        tile_count come out as zeros.
      uvs: (Fp, 2, 17, 17) f32 [u, v] per vertex on the (row = v, column
        = u) grid.

    Returns (Fp, 1, 17, 17) f32 raw texel values (the caller normalises).
    """
    return _attach(attach_sample_fused, block_array, ids, geom, uvs, tile_count, 1, 0)


attach_sample_fused.launches = 0


def attach_sample_fused_packed(block_array: torch.Tensor, ids: torch.Tensor,
                               geom: torch.Tensor, uvs: torch.Tensor, tile_count: torch.Tensor,
                               channels: int, bits: int) -> torch.Tensor:
    """:func:`attach_sample_fused` for ``channels`` channels of ``bits`` bits
    packed into each word (Rgba8: 4 x 8, Rg16: 2 x 16), from one quad fetch.
    Returns (Fp, C, 17, 17) f32 raw texel values."""
    if bits not in (8, 16):
        raise ValueError(f"packed channels have 8 or 16 bits, not {bits}")
    return _attach(attach_sample_fused_packed, block_array, ids, geom, uvs, tile_count,
                   channels, bits)


attach_sample_fused_packed.launches = 0


def _attach_reference(block_array, ids, geom, uvs, tile_count, channels, bits):
    A = _channel_halfgrids(block_array[ids.long()], geom, channels, bits, False)
    gi, i, j, _, _ = _vertex_grid(block_array.device, geom.dtype)
    interp9 = _window(uvs[:, 0], uvs[:, 1], gi, i, j)
    valid = geom[:, 3].view(-1, 1, 1)
    out = torch.stack([interp9(A[:, c]) * valid for c in range(channels)], dim=1)
    return _dead_to_zero(out, tile_count)


def attach_sample_fused_reference(block_array, ids, geom, uvs, tile_count) -> torch.Tensor:
    """Plain PyTorch version of :func:`attach_sample_fused` (same arguments,
    same result), batched over tiles on any device."""
    return _attach_reference(block_array, ids, geom, uvs, tile_count, 1, 0)


def attach_sample_fused_packed_reference(block_array, ids, geom, uvs, tile_count,
                                         channels: int, bits: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`attach_sample_fused_packed`."""
    return _attach_reference(block_array, ids, geom, uvs, tile_count, channels, bits)


# ---------------------------------------------------------------------------
# Half-grid kernels of the staged mesh path: fetch_resample_cached (K6) and
# fetch_resample (K7)
# ---------------------------------------------------------------------------

# evens-first half-grid order [0, 2, .., 32, 1, 3, .., 31]: the order K6
# writes and patch_sampling.vertex_values_from_halfgrid reads
HALFGRID_PERM = np.concatenate([np.arange(0, K, 2), np.arange(1, K, 2)])
# The grid of the half-grid kernels (K6, K7) in waves of the blocks the card
# holds at once, as MESH_WAVES is for K1 / K2: a launch constant, read at
# each launch; any value gives the same output bits.
HALFGRID_WAVES = 1
# Floats of K7's packed weight rows per axis (csrc/fetch_resample.cu
# MAX_SUPPORT): the supports of the 33 rows of one axis hold at most this
# many texels (fetch_resample_support).
HALFGRID_MAX_SUPPORT = 2 * (P - 1) + 2 * K


def fetch_resample_cached(block_array: torch.Tensor, ids: torch.Tensor, geom: torch.Tensor,
                          tile_count: torch.Tensor) -> torch.Tensor:
    """The half-grid of every tile of a frame: quad fetch, tent resample of
    the mean-centred 64x64 patch at the 33x33 positions clip(p0 + k * dp,
    0, 63), the two-sided value blend ``B H B^T`` toward the coarser data
    lod (``B = I + ratio (A - I)``, A the 1-2-1 smoothing with duplicated
    boundary rows), the mean back, x valid (the JAX kernel
    fetch_resample_cached).

    Args:
      block_array: (N, 32, 128) int32 row-interleaved block quads.
      ids: (Fp,) int32 quad id per tile (PatchBatch.ids, sorted order).
      geom: (Fp, 8) f32 PatchBatch.geom [p0x, p0y, dp, valid, ratio, 0, 0, 0].
      tile_count: int32 tensor of one element on the same device; tiles at
        index >= tile_count come out as zeros (their ``valid`` is 0 in a
        PatchBatch anyway).

    Returns (Fp, 33, 33) f32 at raw texel scale, rows and columns in
    evens-first order (:data:`HALFGRID_PERM`).

    All sums are f32, as in the JAX kernel's interpret mode; on the TPU the
    JAX kernel runs its dots in bf16 passes, so this is the more exact of
    the two. On a CUDA tensor this launches ``csrc/fetch_resample.cu`` (and
    raises if it cannot); on a CPU tensor it returns the plain version.
    """
    n = _check_args(block_array, ids, geom, tile_count, 32, ())
    if block_array.device.type == "cpu":
        return fetch_resample_cached_reference(block_array, ids, geom, tile_count)
    out = torch.empty((n, K, K), dtype=torch.float32, device=block_array.device)
    if n == 0:
        return out
    _launch(fetch_resample_cached, block_array.device, "fetch_resample_cached_launch",
            block_array.data_ptr(), block_array.shape[0], ids.data_ptr(), geom.data_ptr(),
            tile_count.data_ptr(), out.data_ptr(), n, HALFGRID_WAVES)
    return out


fetch_resample_cached.launches = 0


def fetch_resample_cached_reference(block_array: torch.Tensor, ids: torch.Tensor,
                                    geom: torch.Tensor,
                                    tile_count: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fetch_resample_cached` (same
    arguments, same result), batched over tiles on any device, in the
    kernel's operation order: blend along rows, then along columns."""
    n = ids.shape[0]
    Hc, c = _centred_halfgrid(block_array, ids, geom)
    A = _smooth_matrix(block_array.device).to(geom.dtype)
    ratio = geom[:, 4].view(n, 1, 1)
    X = Hc + ratio * (torch.einsum("ij,njl->nil", A, Hc) - Hc)
    Y = X + ratio * (torch.einsum("nkl,ml->nkm", X, A) - X)
    out = (Y + c) * geom[:, 3].view(n, 1, 1)
    out = out[:, HALFGRID_PERM][:, :, HALFGRID_PERM]
    alive = torch.arange(n, device=out.device) < tile_count.reshape(())
    return torch.where(alive.view(n, 1, 1), out, 0.0)


def fetch_resample(block_array: torch.Tensor, ids: torch.Tensor,
                   geom: torch.Tensor) -> torch.Tensor:
    """The half-grid of every tile, with the blend folded into the resample
    weights: quad fetch, then ``wy @ patch @ wx^T`` with each tent weight
    row crossfaded by the tile's ratio toward its 1-2-1 form ``0.25 t(p -
    dp) + 0.5 t(p) + 0.25 t(p + dp)`` (the boundary rows keep ``t(p)``), x
    valid; no mean subtraction (the JAX kernel fetch_resample). One launch
    for any number of tiles.

    Args:
      block_array: (N, 32, 128) int32 row-interleaved block quads.
      ids: (F, 4) int32 flat block indices (tl, tr, bl, br) per tile; the
        quad holds all four, so only column 0 drives the fetch.
      geom: (F, 8) f32 [p0x, p0y, dp, valid, ratio, 0, 0, 0] per tile.

    Returns (F, 33, 33) f32 at raw texel scale, in natural order.

    All sums are f32 (see :func:`fetch_resample_cached`). On a CUDA tensor
    this launches ``csrc/fetch_resample.cu`` (and raises if it cannot); on a
    CPU tensor it returns the plain version.
    """
    if ids.dim() != 2:
        raise ValueError("ids must be (F, 4)")
    n = ids.shape[0]
    _check_tensors(block_array, 32, (
        (ids, torch.int32, (n, 4), "ids"),
        (geom, torch.float32, (n, 8), "geom"),
    ))
    if block_array.device.type == "cpu":
        return fetch_resample_reference(block_array, ids, geom)
    out = torch.empty((n, K, K), dtype=torch.float32, device=block_array.device)
    if n == 0:
        return out
    _launch(fetch_resample, block_array.device, "fetch_resample_launch",
            block_array.data_ptr(), block_array.shape[0], ids.data_ptr(), geom.data_ptr(),
            out.data_ptr(), n, HALFGRID_WAVES)
    return out


fetch_resample.launches = 0


def fetch_resample_reference(block_array: torch.Tensor, ids: torch.Tensor,
                             geom: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fetch_resample` (same arguments, same
    result), batched over tiles on any device."""
    n = ids.shape[0]
    patch = _patch(block_array[ids[:, 0].long()].to(geom.dtype))
    wx, wy = fetch_resample_weights(geom)
    rows = torch.einsum("nkr,nrc->nkc", wy, patch)
    return torch.einsum("nkc,nlc->nkl", rows, wx) * geom[:, 3].view(n, 1, 1)


def fetch_resample_weights(geom: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The crossfaded tent weight rows of :func:`fetch_resample`: (wx, wy),
    each (F, 33, 64), row k of an axis ``t(p) + (w2 - t(p)) * ratio`` with
    ``w2 = 0.25 t(p - dp) + 0.5 t(p) + 0.25 t(p + dp)`` (the boundary rows
    keep ``t(p)``)."""
    n = geom.shape[0]
    w = _tents(geom)
    wm = _tents(geom, -1.0)
    wp = _tents(geom, 1.0)
    k = torch.arange(K, device=geom.device).view(1, K, 1)
    ratio = geom[:, 4].view(n, 1, 1)

    def blend(w, wm, wp):
        w2 = (0.25 * torch.where(k == 0, w, wm) + 0.5 * w
              + 0.25 * torch.where(k == K - 1, w, wp))
        return w + (w2 - w) * ratio

    wx, wy = (blend(*axis) for axis in zip(w, wm, wp))
    return wx, wy


def fetch_resample_support(geom: torch.Tensor):
    """Where K7's weight rows can be non-zero, as ``csrc/fetch_resample.cu``
    forms them: row k of an axis covers the texels ``[lo, hi]`` under the
    clipped tent centres of rows k - 1 .. k + 1 (the boundary rows their
    own), and the rows pass covers the columns ``[c0, c1]`` that the x rows
    reach (rows 0 and 32 hold the ends: the positions are monotone in k).

    Args:
      geom: (F, 8) f32 [p0x, p0y, dp, ...] per tile.

    Returns (lo, hi, cols): lo and hi (F, 2, 33) int64 over [x, y], cols
    (F, 2) int64 [c0, c1].
    """
    k = torch.arange(K, dtype=geom.dtype, device=geom.device)
    dp = geom[:, 2:3]

    def axis(p0):
        pa = (p0[:, None] + (k - 1.0).clamp(min=0.0) * dp).clamp(0.0, P - 1.0)
        pb = (p0[:, None] + (k + 1.0).clamp(max=K - 1.0) * dp).clamp(0.0, P - 1.0)
        lo = torch.minimum(pa, pb).floor().long()
        hi = (torch.maximum(pa, pb).floor().long() + 1).clamp(max=P - 1)
        return lo, hi

    (lox, hix), (loy, hiy) = axis(geom[:, 0]), axis(geom[:, 1])
    cols = torch.stack([torch.minimum(lox[:, 0], lox[:, -1]),
                        torch.maximum(hix[:, 0], hix[:, -1])], dim=1)
    return torch.stack([lox, loy], dim=1), torch.stack([hix, hiy], dim=1), cols


# ---------------------------------------------------------------------------
# Build (nvcc -> shared library with a C interface -> ctypes)
# ---------------------------------------------------------------------------

_LIB = None
_ABLATION_LIB = None
# the ablation library's translation units: csrc/mesh_fused.cu once per group
# of instances (csrc/mesh_fused.cu MESH_ABLATION), each in its own nvcc
ABLATION_GROUPS = 6


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    home = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    for cand in (shutil.which("nvcc"), home):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("CUDA kernels need nvcc (the CUDA toolkit): none on PATH "
                       "or under CUDA_HOME")


def build_library(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into ``build/kernels/kernels_<hash>.so`` unless a
    library built from the same sources, headers and flags is already there.
    Each source compiles in its own ``nvcc`` process, all started together;
    one more call links them."""
    return _build("kernels", [(s, ()) for s in sorted(_CSRC.glob("*.cu"))], verbose)


def build_ablation_library(verbose: bool = False) -> Path:
    """Compile the ablated instances of the fused mesh kernels (the masks of
    :func:`ablation_masks`; csrc/mesh_fused.cu under ``MESH_ABLATION``) into
    ``build/kernels/ablation_<hash>.so``, a library of their own: the
    production library's build and time do not grow. Built at the first
    ablated call; :data:`ABLATION_GROUPS` nvcc processes, started together."""
    src = _CSRC / "mesh_fused.cu"
    return _build("ablation", [(src, (f"-DMESH_ABLATION={g}",))
                               for g in range(1, ABLATION_GROUPS + 1)], verbose)


def _build(prefix: str, units, verbose: bool) -> Path:
    """Compile ``units`` ((source, extra flags) each, one nvcc each, all
    started together) and link them into ``build/kernels/<prefix>_<hash>.so``
    (hash of the flags, the units and every csrc/*.cu* file), unless it is
    there."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    if prefix != "kernels":  # the production hash stays that of earlier trees
        h.update(repr([(s.name, extra) for s, extra in units]).encode())
    for s in sorted(_CSRC.glob("*.cu*")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = _BUILD_DIR / f"{prefix}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / f"{s.stem}_{i}.o" for i, (s, _) in enumerate(units)]
        procs = [
            subprocess.Popen(
                [nvcc, *compile_flags, *extra, *(["-Xptxas", "-v"] if verbose else []), "-c",
                 "-o", str(o), str(s)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for (s, extra), o in zip(units, objs)
        ]
        errs = [p.communicate()[1] for p in procs]  # drains both pipes, then waits
        logs = [(s.name + "".join(f" {e}" for e in extra), p.returncode, err)
                for (s, extra), p, err in zip(units, procs, errs)]
        failed = [(name, rc, err) for name, rc, err in logs if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{err}" for name, rc, err in failed))
        if verbose:
            for name, _, err in logs:
                print(f"{name}:\n{err}", end="")
        tmp = Path(tmpdir) / out.name
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def _launch(wrapper, device, entry: str, *args, ablate=None) -> None:
    """Call the library's ``entry`` with ``args`` and the current stream of
    ``device``; raise if the launch failed, else count it on ``wrapper``.

    ``ablate`` (names, mask, the names the kernel reads) with a mask: the
    ablation library's instance of that mask instead (``entry`` with
    ``_ablate_launch`` for ``_launch``, the mask before the stream), counted
    in ``wrapper.ablated_launches`` under :func:`ablate_label`; raises
    ValueError for a mask without an instance (:func:`ablation_masks`)."""
    names, mask, readable = ablate if ablate is not None else ((), 0, frozenset())
    if mask:
        if mask not in ablation_masks(readable):
            raise ValueError(f"{wrapper.__name__}: no CUDA instance for ablate "
                             f"{sorted(names)} (single names and {[sorted(p) for p in ABLATE_PAIRS]})")
        lib, entry, args = _ablation_library(), entry.replace("_launch", "_ablate_launch"), \
            (*args, mask)
    else:
        lib = _library()
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: cudaError {rc}")
    if mask:
        label = ablate_label(names)
        wrapper.ablated_launches[label] = wrapper.ablated_launches.get(label, 0) + 1
    else:
        wrapper.launches += 1


_VP, _INT = ctypes.c_void_p, ctypes.c_int
# the mesh kernels' launch entries and their arguments before the stream
_MESH_ENTRIES = {
    "mesh_fused_planar_launch": [_VP, ctypes.c_longlong, _VP, _VP, _VP, _VP, _VP, _VP, _INT,
                                 _INT],
    "mesh_fused_spherical_launch": [_VP, ctypes.c_longlong, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                    _INT, _INT, _INT, _INT],
    "mesh_fused_material_launch": [_VP, ctypes.c_longlong, _VP, _VP, _VP, _VP, _VP, _VP, _INT,
                                   _INT, _INT, _INT, _VP, _VP, _INT, _INT],
    "mesh_fused_spherical_albedo_launch": [_VP, ctypes.c_longlong, _VP, _VP, _VP, _VP, _VP,
                                           _VP, _VP, _INT, _INT, _INT, _INT, _VP, _INT, _INT,
                                           _INT, _INT],
}


def _ablation_library() -> ctypes.CDLL:
    """The ablation library (:func:`build_ablation_library`), built at first
    use: each mesh entry as ``*_ablate_launch``, the mask before the stream."""
    global _ABLATION_LIB
    if _ABLATION_LIB is None:
        lib = ctypes.CDLL(str(build_ablation_library()))
        for entry, args in _MESH_ENTRIES.items():
            fn = getattr(lib, entry.replace("_launch", "_ablate_launch"))
            fn.argtypes = [*args, _INT, _VP]
            fn.restype = _INT
        _ABLATION_LIB = lib
    return _ABLATION_LIB


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        vp = ctypes.c_void_p
        for entry, args in _MESH_ENTRIES.items():
            getattr(lib, entry).argtypes = [*args, _VP]
            getattr(lib, entry).restype = _INT
        lib.attach_sample_launch.argtypes = [
            vp, ctypes.c_longlong, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int, vp,
            ctypes.c_int, ctypes.c_int, vp,
        ]
        lib.attach_sample_launch.restype = ctypes.c_int
        lib.fetch_resample_cached_launch.argtypes = [
            vp, ctypes.c_longlong, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int, vp,
        ]
        lib.fetch_resample_cached_launch.restype = ctypes.c_int
        lib.fetch_resample_launch.argtypes = [
            vp, ctypes.c_longlong, vp, vp, vp, ctypes.c_int, ctypes.c_int, vp,
        ]
        lib.fetch_resample_launch.restype = ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.kernel_occupancy.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                                         ip, ip, ip, ip, ip]
        lib.kernel_occupancy.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def kernel_occupancy() -> list[dict]:
    """Every kernel instance of the library on the current card: its name,
    blocks of 320 threads per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    at its dynamic shared memory), registers per thread, static and dynamic
    shared memory and local (spill) bytes per thread."""
    lib = _library()
    rows = []
    while True:
        name = ctypes.create_string_buffer(64)
        vals = [ctypes.c_int() for _ in range(5)]
        rc = lib.kernel_occupancy(len(rows), name, len(name), *map(ctypes.byref, vals))
        if rc == -1:
            return rows
        if rc != 0:
            raise RuntimeError(f"kernel_occupancy({len(rows)}) failed: cudaError {rc}")
        rows.append(dict(zip(("blocks_per_sm", "registers", "static_smem", "dynamic_smem",
                              "local_bytes"), (v.value for v in vals)),
                         name=name.value.decode()))
