"""A cell shrunk to a size the CPU runs in seconds, for the tests: the
configuration's and traffic's own files with small tiles, few lods, a
short morph distance (few tiles, so the small image's bins hold every
triangle), a small image and a short path."""

from __future__ import annotations

import time
from pathlib import Path
from types import SimpleNamespace

from harness import manifest

H = manifest.HOME


def planar() -> tuple:
    cfg = manifest.load_json(H / "configs" / "planar_8k_lit.json")
    tr = manifest.load_json(H / "traffic" / "aerial_1080p.json")
    cfg["model"]["side_m"] = 1000.0
    cfg.update(lod_count=2, data_lod_count=2, atlas_slots=16)
    for a in cfg["attachments"]:
        a.update(texture_size=128, mip_level_count=2)
    cfg["view"].update(tile_capacity=1024, queue_capacity=1024, morph_distance=4.0)
    tr["size"] = [192, 108]
    tr["raster"]["bin_cap"] = 4096
    tr["path"].update(positions=4, start_m=-300.0, end_m=100.0, lateral_m=50.0,
                      altitude_m=[600.0, 350.0])
    tr["visit_stride"] = 3
    tr["check"]["frames"] = 2
    return cfg, tr


def planet() -> tuple:
    cfg = manifest.load_json(H / "configs" / "earth_lit.json")
    tr = manifest.load_json(H / "traffic" / "descent_1024.json")
    cfg.update(lod_count=3, data_lod_count=1, atlas_slots=16)
    for a in cfg["attachments"]:
        a.update(texture_size=128, mip_level_count=2)
    cfg["view"].update(tile_capacity=2048, queue_capacity=2048, morph_distance=2.0)
    tr["size"] = [96, 96]
    tr["raster"]["bin_cap"] = 4096
    tr["path"].update(positions=2, altitude_m=[2000000.0, 1000000.0])
    tr["visit_stride"] = 1
    tr["check"]["frames"] = 2
    return cfg, tr


def ctx(cfg: dict, tr: dict, cache: Path, seed: int = 7, seconds: float = 3.0,
        control: bool = False) -> SimpleNamespace:
    """A run's context on the CPU. The program's view takes the per-vertex
    blend, the blend its fused kernels compute on the card (on the CPU the
    program runs its staged path, whose default blend is per tile)."""
    return SimpleNamespace(config=cfg, traffic=tr, seed=seed, seconds=seconds, trace=False,
                           device="cpu", cache=cache / cfg["name"],
                           t0=time.perf_counter(), control=control,
                           program_overrides={"blend_per_vertex": True})
