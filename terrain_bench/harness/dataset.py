"""Seeded terrain datasets, made on the device and written in the layout
the port streams: ``{root}/{path}/data/{name}/{side}_{lod}_{x}_{y}.bin``
(raw little-endian texels, border included) and ``{root}/{path}/config.tc``.

The writer is a frozen copy of the port's ``utils/synthetic.py`` (texel
centres clamped to the side, the cube-sphere warp, truncation to the
format, channel 0 of a multi-channel payload kept above 0, the nodata
sentinel); the fields are this file's own: sums of plane waves with
directions and phases drawn from the seed, their frequencies and amplitudes
fixed by the configuration, so every seed gives terrain of the same
roughness. Fields are evaluated in float64 on the device, a batch of tiles
at a time, then written by the host.

A configuration's dataset lives in ``terrain_bench/_cache/<config>/``, one
seed at a time: ``seed.json`` names the seed and the field's parameters and
is written last, so a dataset whose marker matches is whole.
"""

from __future__ import annotations

import hashlib
import json
import math
import shutil
import struct
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from reference.geometry import C_SQR, SIDE

FORMATS = {"R16": (1, np.uint16, 65535.0), "Rgba8": (4, np.uint8, 255.0)}
BATCH = 32  # tiles evaluated per device call


def waves(spec: dict, seed: int, tag: int, dims: int) -> dict:
    """The plane waves of one field: per octave ``spec["waves"]`` waves of
    frequency ``f0 * lacunarity**k`` (cycles across the side, or per
    radian on a sphere) and amplitude ``a0 * gain**k``, their directions
    and phases drawn from ``seed``. ``tag`` separates the fields of one
    dataset."""
    rng = np.random.default_rng([int(seed), int(tag)])
    n_oct, per = int(spec["octaves"]), int(spec["waves"])
    k = np.repeat(np.arange(n_oct), per)
    freq = spec["f0"] * spec["lacunarity"] ** k
    amp = spec["a0"] * spec["gain"] ** k / per
    if dims == 2:
        ang = rng.uniform(0.0, 2.0 * np.pi, k.size)
        dirs = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    else:
        dirs = rng.normal(size=(k.size, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    phase = rng.uniform(0.0, 2.0 * np.pi, k.size)
    return {"freq": freq, "amp": amp, "dirs": dirs, "phase": phase}


def field(w: dict, x: torch.Tensor, base: float, scale: float) -> torch.Tensor:
    """``base + scale * sum_k amp_k sin(2 pi freq_k (dir_k . x) + phase_k)``
    over points ``x`` (..., D), float64."""
    dev = x.device
    dirs = torch.as_tensor(w["dirs"], dtype=torch.float64, device=dev)
    freq = torch.as_tensor(w["freq"], dtype=torch.float64, device=dev)
    amp = torch.as_tensor(w["amp"], dtype=torch.float64, device=dev)
    phase = torch.as_tensor(w["phase"], dtype=torch.float64, device=dev)
    out = torch.full(x.shape[:-1], float(base), dtype=torch.float64, device=dev)
    for i in range(dirs.shape[0]):
        arg = 2.0 * math.pi * freq[i] * (x * dirs[i]).sum(-1) + phase[i]
        out += scale * amp[i] * torch.sin(arg)
    return out


def texel_uv(coords: list, texture_size: int, border: int, dev) -> torch.Tensor:
    """(B, S, S, 2) side uv of each tile's texel centres, border texels
    included, clamped to the side (``utils/synthetic._texel_uv``; row = v)."""
    center = texture_size - 2 * border
    tu = (torch.arange(texture_size, dtype=torch.float64, device=dev) - border + 0.5) / center
    xs = torch.tensor([c.x for c in coords], dtype=torch.float64, device=dev)
    ys = torch.tensor([c.y for c in coords], dtype=torch.float64, device=dev)
    count = torch.tensor([1 << c.lod for c in coords], dtype=torch.float64, device=dev)
    u = ((xs[:, None] + tu[None]) / count[:, None]).clamp(0.0, 1.0)
    v = ((ys[:, None] + tu[None]) / count[:, None]).clamp(0.0, 1.0)
    S = texture_size
    return torch.stack([u[:, None, :].expand(-1, S, S), v[:, :, None].expand(-1, S, S)], dim=-1)


def sphere_position(sides: list, uv: torch.Tensor) -> torch.Tensor:
    """(B, S, S, 3) unit cube-sphere positions of side uvs: the inverse
    sigmoid warp and the side's cube placement
    (``math/coordinate.local_position_from_side_uv``)."""
    w = (uv - 0.5) / 0.5
    p = w / torch.sqrt(1.0 + C_SQR - C_SQR * w * w)
    mats = torch.as_tensor(SIDE[np.asarray(sides)], dtype=torch.float64,
                           device=uv.device)
    homo = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    cube = torch.einsum("bij,bhwj->bhwi", mats, homo)
    return cube / torch.linalg.vector_norm(cube, dim=-1, keepdim=True)


def tile_fields(cfg: dict, att: dict, coords: list, params: dict, dev) -> torch.Tensor:
    """(B, S, S, C) values in [0, 1] of attachment ``att`` over the tiles."""
    uv = texel_uv(coords, att["texture_size"], att["border_size"], dev)
    x = uv if cfg["model"]["kind"] == "planar" else sphere_position([c.side for c in coords], uv)
    spec = cfg["dataset"]
    if att["format"] == "R16":
        h = field(params["height"], x, 0.5, 1.0)
        return h.clamp(spec["height_floor"], 1.0)[..., None]
    base = spec["albedo"]["base"]
    rgb = [field(params[f"albedo{c}"], x, base[c], 1.0) for c in range(3)]
    rgba = torch.stack(rgb + [torch.ones_like(rgb[0])], dim=-1)
    return rgba.clamp(0.0, 1.0)


def payload(values: torch.Tensor, fmt: str) -> np.ndarray:
    """Values in [0, 1] -> the format's texels, truncated as
    ``utils/synthetic._to_payload`` does; channel 0 of a multi-channel
    payload kept above 0 (0 is the nodata sentinel)."""
    channels, dtype, maxv = FORMATS[fmt]
    t = (values * maxv).to(torch.int32)
    if channels > 1:
        t[..., 0] = t[..., 0].clamp(min=1)
    return t.cpu().numpy().astype(dtype)


class Tile(NamedTuple):
    side: int
    lod: int
    x: int
    y: int

    def __str__(self) -> str:
        return f"{self.side}_{self.lod}_{self.x}_{self.y}"


def all_tiles(cfg: dict) -> list:
    sides = 1 if cfg["model"]["kind"] == "planar" else 6
    return [Tile(s, lod, x, y) for s in range(sides)
            for lod in range(cfg["data_lod_count"])
            for y in range(1 << lod) for x in range(1 << lod)]


def params_of(cfg: dict, seed: int) -> dict:
    dims = 2 if cfg["model"]["kind"] == "planar" else 3
    spec = cfg["dataset"]
    out = {"height": waves(spec["height"], seed, 0, dims)}
    for c in range(3):
        out[f"albedo{c}"] = waves(spec["albedo"], seed, 1 + c, dims)
    return out


def write(cfg: dict, seed: int, root: Path, dev) -> int:
    """Write the configuration's whole dataset for ``seed`` under ``root``;
    returns the bytes written."""
    tiles = all_tiles(cfg)
    params = params_of(cfg, seed)
    written = 0
    for att in cfg["attachments"]:
        data = root / cfg["name"] / "data" / att["name"]
        data.mkdir(parents=True, exist_ok=True)
        for i in range(0, len(tiles), BATCH):
            chunk = tiles[i:i + BATCH]
            texels = payload(tile_fields(cfg, att, chunk, params, dev), att["format"])
            for c, t in zip(chunk, texels):
                raw = np.ascontiguousarray(t).astype(t.dtype.newbyteorder("<")).tobytes()
                (data / f"{c}.bin").write_bytes(raw)
                written += len(raw)
    (root / cfg["name"] / "config.tc").write_bytes(tile_manifest(sorted(tiles)))
    return written


def _varint(value: int) -> bytes:
    """bevy_terrain's manifest integers (bincode's varint): below 251 one
    byte, else a marker byte (251: u16, 252: u32) and the little-endian
    value."""
    if value < 251:
        return bytes([value])
    if value < 1 << 16:
        return b"\xfb" + struct.pack("<H", value)
    return b"\xfc" + struct.pack("<I", value)


def tile_manifest(tiles: list) -> bytes:
    """The ``config.tc`` manifest: the tile count, then (side, lod, x, y)
    of each tile."""
    out = bytearray(_varint(len(tiles)))
    for t in tiles:
        for v in t:
            out += _varint(v)
    return bytes(out)


def marker(cfg: dict, seed: int) -> dict:
    spec = {k: cfg[k] for k in ("model", "data_lod_count", "attachments", "dataset")}
    digest = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()).hexdigest()
    return {"seed": int(seed), "spec": digest}


def ensure(cfg: dict, seed: int, cache: Path, dev) -> tuple[Path, int]:
    """The dataset root (the port's ``assets_root``) holding ``cfg``'s dataset
    for ``seed``, written first unless the cache holds it; returns (root,
    bytes written)."""
    want = marker(cfg, seed)
    mark = cache / "seed.json"
    if mark.exists() and json.loads(mark.read_text()) == want:
        return cache, 0
    if cache.exists():
        shutil.rmtree(cache)
    cache.mkdir(parents=True)
    n = write(cfg, seed, cache, torch.device(dev))
    mark.write_text(json.dumps(want))
    return cache, n
