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
                     n_params: int = 4) -> int:
    dev = block_array.device
    n = ids.shape[0] if ids.dim() == 1 else -1
    checks = (
        (block_array, torch.int32, (block_array.shape[0], 32, 128), "block_array"),
        (ids, torch.int32, (n,), "ids"),
        (geom, torch.float32, (n, 8), "geom"),
        (tile_params, torch.float32, (n, n_params), "tile_params"),
        (fs, torch.float32, (FS_LEN,), "fs"),
    )
    for x, dtype, shape, name in checks:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, block_array on {dev}")
        if x.dtype != dtype or tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (tile_count.device != dev or tile_count.dtype != torch.int32
            or tile_count.numel() != 1):
        raise ValueError("tile_count must be one int32 on the blocks' device")
    if n < 0:
        raise ValueError("ids must be 1-d")
    return n


def mesh_fused_planar(block_array: torch.Tensor, ids: torch.Tensor,
                      geom: torch.Tensor, tile_params: torch.Tensor,
                      fs: torch.Tensor, tile_count: torch.Tensor) -> torch.Tensor:
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

    Returns (Fp, 6, 17, 17) f32: per tile, channels [height, pos x, pos y,
    pos z, morphed u, morphed v] on the (row = v, column = u) vertex grid.

    On a CUDA tensor this launches ``csrc/mesh_fused.cu`` (and raises if it
    cannot); on a CPU tensor it returns the plain version.
    """
    n = _check_mesh_args(block_array, ids, geom, tile_params, fs, tile_count)
    if block_array.device.type == "cpu":
        return mesh_fused_planar_reference(block_array, ids, geom, tile_params, fs,
                                           tile_count)
    if block_array.device.type != "cuda":
        raise ValueError(f"unsupported device {block_array.device}")
    if block_array.data_ptr() % 16:
        raise ValueError("block_array must be 16-byte aligned")
    out = torch.empty((n, OUT_CH, GV, GV), dtype=torch.float32, device=block_array.device)
    if n == 0:
        return out
    lib = _library()
    with torch.cuda.device(block_array.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mesh_fused_planar_launch(
            block_array.data_ptr(), block_array.shape[0], ids.data_ptr(),
            geom.data_ptr(), tile_params.data_ptr(), fs.data_ptr(),
            tile_count.data_ptr(), out.data_ptr(), n, stream,
        )
    if rc != 0:
        raise RuntimeError(f"mesh_fused_planar launch failed: cudaError {rc}")
    mesh_fused_planar.launches += 1
    return out


mesh_fused_planar.launches = 0


def _smooth_matrix(device) -> torch.Tensor:
    """(33, 33) 1-2-1 smoothing with duplicated boundary rows."""
    A = np.zeros((K, K), np.float32)
    for i in range(K):
        A[i, max(i - 1, 0)] += 0.25
        A[i, i] += 0.5
        A[i, min(i + 1, K - 1)] += 0.25
    return torch.from_numpy(A).to(device)


def _halfgrids(block_array, ids, geom):
    """Phases 1-3 of both mesh kernels, batched over tiles: the mean-centred
    tent resample of each tile's quad to the 33x33 half-grid, H, and its
    1-2-1 smoothed copy, Hs (both (n, 33, 33), natural order), in geom's
    dtype."""
    dev = block_array.device
    dt = geom.dtype
    q = block_array[ids.long()].to(dt)  # (n, 32, 128)
    patch = torch.cat([q[:, :, :P], q[:, :, P:]], dim=1)  # (n, 64, 64)
    c = patch.mean(dim=(1, 2))[:, None, None]

    k = torch.arange(K, dtype=dt, device=dev)
    r = torch.arange(P, dtype=dt, device=dev)
    dp = geom[:, 2:3]

    def tents(p0):  # (n, K, P)
        p = (p0[:, None] + k[None, :] * dp).clamp(0.0, P - 1.0)
        return (1.0 - torch.abs(p[..., None] - r)).clamp(min=0.0)

    wx, wy = tents(geom[:, 0]), tents(geom[:, 1])
    rows = torch.einsum("nkr,nrc->nkc", wy, patch - c)
    H = torch.einsum("nkc,nlc->nkl", rows, wx) + c  # (n, 33, 33) natural order
    A = _smooth_matrix(dev).to(dt)
    Hs = torch.einsum("nkl,ml->nkm", torch.einsum("ij,njl->nil", A, H), A)
    return H, Hs


def _vertex_grid(device, dtype):
    """Vertex indices and uvs: (gi (17,), i (1, 17, 1) rows = v,
    j (1, 1, 17) columns = u, u, v)."""
    gi = torch.arange(GV, device=device)
    i = gi.view(1, GV, 1)
    j = gi.view(1, 1, GV)
    u = j.to(dtype) * (1.0 / (GV - 1.0))
    v = i.to(dtype) * (1.0 / (GV - 1.0))
    return gi, i, j, u, v


def _morph_window_height(H, Hs, lodf, log2_dist, valid, live, fs, gi, i, j, u, v):
    """The per-vertex stage both kernels share: CDLOD morph toward the even
    grid, 3x3 tent window of the fine and smoothed half-grids at the
    morphed uv, per-vertex blend, height. Returns (height, mu, mv)."""
    n = H.shape[0]
    dt = H.dtype
    target_lod = fs[43] - log2_dist
    mr = ((lodf + fs[19] - target_lod) * (1.0 / fs[19])).clamp(0.0, 1.0)
    mr = torch.where(lodf == 0.0, 0.0, mr) * fs[24]
    even_u = (j & ~1).to(dt) * (1.0 / (GV - 1.0))
    even_v = (i & ~1).to(dt) * (1.0 / (GV - 1.0))
    mu = u + (even_u - u) * mr
    mv = v + (even_v - v) * mr

    lxw = mu * (2.0 * (GV - 1.0)) - (2 * j - 2).clamp(min=0).to(dt)
    lyw = mv * (2.0 * (GV - 1.0)) - (2 * i - 2).clamp(min=0).to(dt)
    wyb = [(1.0 - torch.abs(lyw - b)).clamp(min=0.0) for b in range(3)]
    wxa = [(1.0 - torch.abs(lxw - a)).clamp(min=0.0) for a in range(3)]

    def tap(idx, b):  # natural half-grid index of window tap b of vertex idx
        return torch.where(idx == 0, 0, 2 * idx - 2 + b)

    def interp9(S):
        h = torch.zeros((n, GV, GV), dtype=dt, device=H.device)
        for b in range(3):
            rows_b = S[:, tap(gi, b)]  # (n, 17, 33)
            for a in range(3):
                h = h + wyb[b] * wxa[a] * rows_b[:, :, tap(gi, a)]
        return h

    h_fine = interp9(H)
    h_smooth = interp9(Hs)

    btarget = torch.minimum(fs[44] - log2_dist, fs[26])
    blod = btarget.clamp(min=0.0).to(torch.int32).to(dt)
    bratio = torch.where(
        blod == 0.0, 0.0, ((blod + fs[21] - btarget) * (1.0 / fs[21])).clamp(0.0, 1.0)
    ) * fs[25]
    h_norm = (h_fine + (h_smooth - h_fine) * bratio) * valid
    height = (fs[22] + fs[23] * h_norm) * live
    return height, mu, mv


def _dead_to_zero(out, tile_count):
    n = out.shape[0]
    alive = torch.arange(n, device=out.device) < tile_count.reshape(())
    return torch.where(alive.view(n, 1, 1, 1), out, 0.0)


def mesh_fused_planar_reference(block_array: torch.Tensor, ids: torch.Tensor,
                                geom: torch.Tensor, tile_params: torch.Tensor,
                                fs: torch.Tensor, tile_count: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`mesh_fused_planar` (same arguments,
    same result), batched over tiles on any device."""
    n = ids.shape[0]
    H, Hs = _halfgrids(block_array, ids, geom)
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
    height, mu, mv = _morph_window_height(H, Hs, lodf, log2_dist, valid, live, fs,
                                          gi, i, j, u, v)

    mlx = (xf + mu) * inv_count - 0.5
    mlz = (yf + mv) * inv_count - 0.5
    px = fs[0] * mlx + fs[2] * mlz + fs[3] + height * fs[15]
    py = fs[4] * mlx + fs[6] * mlz + fs[7] + height * fs[16]
    pz = fs[8] * mlx + fs[10] * mlz + fs[11] + height * fs[17]

    out = torch.stack([height, px * live, py * live, pz * live, mu * live, mv * live], dim=1)
    return _dead_to_zero(out, tile_count)


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
    if n % TILES_PER_STEP:
        raise ValueError(f"the tile count {n} is not a multiple of {TILES_PER_STEP}")
    if (hp_steps.device != block_array.device or hp_steps.dtype != torch.int32
            or tuple(hp_steps.shape) != (n // TILES_PER_STEP,) or not hp_steps.is_contiguous()):
        raise ValueError(f"hp_steps: want int32 ({n // TILES_PER_STEP},) on the blocks' "
                         f"device, got {hp_steps.dtype} {tuple(hp_steps.shape)}")
    if not 0 <= origin_lod < 31:
        raise ValueError(f"origin_lod {origin_lod} out of range")
    return n


def mesh_fused_spherical(block_array: torch.Tensor, ids: torch.Tensor, geom: torch.Tensor,
                         tile_params: torch.Tensor, fs: torch.Tensor, hp_steps: torch.Tensor,
                         tile_count: torch.Tensor, origin_lod: int,
                         ellipsoidal: bool) -> torch.Tensor:
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

    Returns (Fp, 9, 17, 17) f32: per tile, channels [height, pos x, pos y,
    pos z, morphed u, morphed v, normal x, normal y, normal z].

    On a CUDA tensor this launches ``csrc/mesh_fused.cu`` (and raises if it
    cannot); on a CPU tensor it returns the plain version.
    """
    n = _check_spherical_args(block_array, ids, geom, tile_params, fs, hp_steps, tile_count,
                              origin_lod)
    if block_array.device.type == "cpu":
        return mesh_fused_spherical_reference(block_array, ids, geom, tile_params, fs,
                                              hp_steps, tile_count, origin_lod, ellipsoidal)
    if block_array.device.type != "cuda":
        raise ValueError(f"unsupported device {block_array.device}")
    if block_array.data_ptr() % 16:
        raise ValueError("block_array must be 16-byte aligned")
    out = torch.empty((n, SPH_CH, GV, GV), dtype=torch.float32, device=block_array.device)
    if n == 0:
        return out
    lib = _library()
    with torch.cuda.device(block_array.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mesh_fused_spherical_launch(
            block_array.data_ptr(), block_array.shape[0], ids.data_ptr(),
            geom.data_ptr(), tile_params.data_ptr(), fs.data_ptr(), hp_steps.data_ptr(),
            tile_count.data_ptr(), out.data_ptr(), n, int(origin_lod), int(bool(ellipsoidal)),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"mesh_fused_spherical launch failed: cudaError {rc}")
    mesh_fused_spherical.launches += 1
    return out


mesh_fused_spherical.launches = 0


def mesh_fused_spherical_reference(block_array: torch.Tensor, ids: torch.Tensor,
                                   geom: torch.Tensor, tile_params: torch.Tensor,
                                   fs: torch.Tensor, hp_steps: torch.Tensor,
                                   tile_count: torch.Tensor, origin_lod: int,
                                   ellipsoidal: bool) -> torch.Tensor:
    """Plain PyTorch version of :func:`mesh_fused_spherical` (same
    arguments, same result), batched over tiles on any device, in the
    kernel's operation order. It computes in the dtype of ``geom``,
    ``tile_params`` and ``fs``: float32 is the kernel's function; float64
    evaluates the same arithmetic nearly exactly (the tests' referee)."""
    n = ids.shape[0]
    dev = block_array.device
    dt, i32 = geom.dtype, torch.int32
    H, Hs = _halfgrids(block_array, ids, geom)
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
    d2 = torch.where(near, dhx * dhx + dhy * dhy + dhz * dhz, d2_w0)
    log2_dist = 0.5 * torch.log2(d2)
    height, mu, mv = _morph_window_height(H, Hs, lodf, log2_dist, valid, live, fs,
                                          gi, i, j, u, v)

    (wxm, wym, wzm), (nxm, nym, nzm) = far_geom(mu, mv)
    rxm, rym, rzm = taylor_rel(mu, mv)
    nx_f = torch.where(near, nx0, nxm)
    ny_f = torch.where(near, ny0, nym)
    nz_f = torch.where(near, nz0, nzm)
    px = torch.where(near, fs[39] + rxm, wxm) + height * nx_f
    py = torch.where(near, fs[40] + rym, wym) + height * ny_f
    pz = torch.where(near, fs[41] + rzm, wzm) + height * nz_f

    out = torch.stack([height, px * live, py * live, pz * live, mu * live, mv * live,
                       nx_f * live, ny_f * live, nz_f * live], dim=1)
    return _dead_to_zero(out, tile_count)


# ---------------------------------------------------------------------------
# Build (nvcc -> shared library with a C interface -> ctypes)
# ---------------------------------------------------------------------------

_LIB = None


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
    library built from the same sources and flags is already there."""
    sources = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = _BUILD_DIR / f"kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)
    return out


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        vp = ctypes.c_void_p
        lib.mesh_fused_planar_launch.argtypes = [
            vp, ctypes.c_longlong, vp, vp, vp, vp, vp, vp, ctypes.c_int, vp,
        ]
        lib.mesh_fused_planar_launch.restype = ctypes.c_int
        lib.mesh_fused_spherical_launch.argtypes = [
            vp, ctypes.c_longlong, vp, vp, vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, vp,
        ]
        lib.mesh_fused_spherical_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB
