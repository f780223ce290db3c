"""Reproduce the committed golden fixtures (tests/goldens/*.npz) on the port.

Twin of tools/make_goldens.py. The same cases, built on the port alone:

* node selection: three pure-refinement frames (a planar overview, a
  planar ground view, a sphere approach at 3 km), capacity and queue 32768,
  every slot reporting its root tile at atlas slot 0; the emitted tile set
  sorted lexicographically;
* ``mesh_planar_streamed``: a synthetic 3-lod planar dataset streamed to
  quiescence through the port's ``Terrain`` (per-vertex blend), then the
  settled frame meshed by the staged path (``meshgen.generate_mesh_grid``,
  the path the goldens were captured on) and captured in strip order,
  positions relative to the view;
* ``mesh_spherical_streamed``: the flagship Earth frame (13 geometry lods
  over 3 data lods of six analytic faces, preprocessed on the host path,
  a 60-degree culled camera at 60 km, the Taylor path) the same way; its
  full node list and the deep subset (lod >= 10, the first 192 tiles).

``--out DIR`` (default: a temporary directory) receives the ``.npz``
files; nothing is written under tests/. ``--check`` holds them to
tests/goldens/ (read as data): node lists exactly, meshes at
:data:`MESH_TOL` (the planar frame at tests/test_goldens.py's CPU
tolerance, the Earth frame at f32 ulps). The frames run on the card
unless ``--cpu``.

Usage: python tools_torch/make_goldens.py [--cpu] [--out DIR] [--check]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

GOLDEN_DIR = Path(__file__).resolve().parent.parent / "tests" / "goldens"
# (heights, positions) per mesh case: the planar frame at tests/test_goldens.py's
# CPU tolerance. Its spherical CPU tolerance (1e-3 m, 1e-2 m) is the JAX
# package regenerating its own bits; the port's staged path rounds in another
# op order, and at the Earth frame one f32 ulp is 4.9e-4 m of a 7 km height
# and 0.5 m of a 6.4e6 m world position (the relative positions are
# differences of f32 world positions). The spherical case is held to 4 ulps
# of the 9 km height range and 2 ulps at the radius (measured on the CPU:
# 1.95e-3 m and 1.0 m)
MESH_TOL = {"mesh_planar_streamed": (1e-3, 1e-3), "mesh_spherical_streamed": (4e-3, 1.0)}
NODE_CASES = ("nodes_planar_overview", "nodes_planar_ground", "nodes_sphere_approach")


def node_selection_cases():
    """Pure-refinement cases: (name, model, view, lods)."""
    from bevy_terrain_tpu_torch.math import TerrainModel

    planar = TerrainModel.planar(np.array([0.0, -100.0, 0.0]), 1000.0, 0.0, 250.0)
    sphere = TerrainModel.sphere(np.zeros(3), 6.4e6, 0.0, 9000.0)
    anchor = np.array([0.35, 0.2, 0.91])
    return [
        ("nodes_planar_overview", planar, np.array([100.0, 50.0, -200.0]), 8),
        ("nodes_planar_ground", planar, np.array([-380.0, -70.0, 310.0]), 8),
        ("nodes_sphere_approach", sphere,
         sphere.position_local_to_world(anchor / np.linalg.norm(anchor), 3000.0), 8),
    ]


def build_frame(model, view, lods: int, device, capacity: int = 32768, queue: int = 32768):
    """(cfg, uniforms) of an unculled frame whose slots all report the
    root tile at atlas slot 0 (the JAX tests' build_frame)."""
    import torch

    from bevy_terrain_tpu_torch.config import TerrainViewConfig
    from bevy_terrain_tpu_torch.math import TerrainModelApproximation
    from bevy_terrain_tpu_torch.ops import tile_tree
    from bevy_terrain_tpu_torch.ops.params import (
        StaticTerrainConfig, pack_frame_uniforms, unpack_frame_uniforms,
    )

    vc = TerrainViewConfig(tile_capacity=capacity)
    cfg = StaticTerrainConfig(
        spherical=model.is_spherical, side_count=model.side_count, lod_count=lods,
        tree_size=vc.tree_size, grid_size=vc.grid_size, refinement_count=vc.refinement_count,
        tile_capacity=capacity, origin_lod=vc.origin_lod, queue_capacity=queue)
    origins, vt_int, vt_frac = tile_tree.compute_view_anchors(model, view, lods, vc.tree_size)
    approx = TerrainModelApproximation.compute(
        model, view, vc.origin_lod, (model.min_height + model.max_height) / 2)
    entries = np.zeros((model.side_count, lods, vc.tree_size, vc.tree_size, 2), np.int32)
    blob = pack_frame_uniforms(model, view, approx, origins, entries, vt_int, vt_frac, vc)
    u = unpack_frame_uniforms(torch.from_numpy(blob).to(device), model.side_count, lods,
                              vc.tree_size)
    return cfg, u


def sorted_nodes(tiles, n: int) -> tuple[np.ndarray, np.ndarray]:
    """((n, 4) int32 [side, lod, x, y] of the first n tiles sorted, the
    order that sorts them): a tile list is a set."""
    import torch

    nodes = torch.stack([tiles.tile_side[:n], tiles.tile_lod[:n], tiles.tile_xy[:n, 0],
                         tiles.tile_xy[:n, 1]], dim=-1).cpu().numpy().astype(np.int32)
    order = np.lexsort(nodes.T[::-1])
    return nodes[order], order


def refine_nodes(model, view, lods: int, device) -> np.ndarray:
    from bevy_terrain_tpu_torch.ops import refinement

    cfg, u = build_frame(model, view, lods, device)
    tiles = refinement.refine_tiles(u, cfg)
    if int(tiles.overflow):
        raise AssertionError("node selection frame overflows")
    return sorted_nodes(tiles, int(tiles.tile_count))[0]


def _capture_streamed(terrain, view, view_proj=None):
    """Stream to quiescence, then mesh the settled frame by the staged path
    and capture (sorted nodes, strip heights, strip positions relative to
    the view)."""
    import torch

    from bevy_terrain_tpu_torch.ops import meshgen, refinement
    from bevy_terrain_tpu_torch.ops.params import unpack_frame_uniforms

    vps = {"cam": view_proj} if view_proj is not None else None
    for _ in range(60):
        terrain.update({"cam": view}, vps)
        if not terrain.atlas.state.to_load and not any(
                a.loading for a in terrain.atlas.attachments):
            break
        time.sleep(0.01)
    out = terrain.update({"cam": view}, vps)["cam"]
    if out.overflow:
        raise AssertionError("golden frame overflows")
    cfg = terrain._static_cfgs["cam"]
    height = terrain.atlas.attachments[0]
    blob = torch.from_numpy(terrain.last_uniform_blob("cam")).to(terrain.device)
    u = unpack_frame_uniforms(blob, cfg.side_count, cfg.lod_count, cfg.tree_size)
    mesh, tiles = meshgen.generate_mesh_grid(refinement.refine_tiles(u, cfg),
                                             height.block_array, u, cfg, height.patch_plan,
                                             height.config.format.max_value)
    n = int(tiles.tile_count)
    nodes, order = sorted_nodes(tiles, n)
    heights = meshgen.grid_to_strip_order(mesh.heights, cfg)[:n][order]
    positions = meshgen.grid_to_strip_order(mesh.positions, cfg)[:n][order]
    relative = positions - np.asarray(view, np.float64)
    return nodes, heights.astype(np.float32), relative.astype(np.float32)


def mesh_case(tmp_root, device):
    """The streamed planar frame: (sorted nodes, strip heights, relative
    positions)."""
    from bevy_terrain_tpu_torch import (
        AttachmentConfig, Terrain, TerrainConfig, TerrainModel, TerrainViewConfig,
    )
    from bevy_terrain_tpu_torch.utils.synthetic import generate_planar_dataset

    att = AttachmentConfig(name="height", texture_size=512, border_size=2, mip_level_count=4)
    generate_planar_dataset("terrains/golden", 3, att, root=str(tmp_root))
    config = TerrainConfig(
        lod_count=3, model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
        atlas_size=128, path="terrains/golden", attachments=(att,), assets_root=str(tmp_root),
    )
    terrain = Terrain(config, device=device)
    terrain.add_view(
        "cam", TerrainViewConfig(tile_capacity=512, morph_distance=4.0, blend_distance=1.5),
        queue_capacity=2048, blend_per_vertex=True,
    )
    return _capture_streamed(terrain, np.array([-120.0, 90.0, 160.0]))


def mesh_spherical_case(tmp_root, device):
    """The streamed flagship Earth frame (preprocessed on the host path):
    (sorted nodes, strip heights, relative positions)."""
    from bevy_terrain_tpu_torch import (
        AttachmentConfig, Preprocessor, SphericalDataset, Terrain, TerrainConfig,
        TerrainModel, TerrainViewConfig,
    )
    from bevy_terrain_tpu_torch.math.coordinate import local_position_from_side_uv
    from bevy_terrain_tpu_torch.math.frustum import view_projection
    from bevy_terrain_tpu_torch.terrain_data import TileAtlas
    from examples_torch import sources

    radius = 6.371e6
    att = AttachmentConfig(name="height", texture_size=512, border_size=2, mip_level_count=4)
    config = TerrainConfig(
        lod_count=13, model=TerrainModel.sphere(np.zeros(3), radius, 0.0, 9000.0),
        atlas_size=512, path="terrains/golden_sph", attachments=(att,),
        assets_root=str(tmp_root),
    )
    n = 256
    uv = (np.arange(n) + 0.5) / n
    uu, vv = np.meshgrid(uv, uv, indexing="xy")
    grid_uv = np.stack([uu, vv], axis=-1)
    src = Path(tmp_root) / "src"
    src.mkdir(parents=True, exist_ok=True)
    faces = {}  # the 16-bit PNGs of the JAX tool, as they read back
    for side in range(6):
        p = local_position_from_side_uv(side, grid_uv)
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        h = np.clip(0.45 + 0.25 * np.sin(3 * x + 1) * np.cos(4 * y)
                    + 0.18 * np.sin(5 * z + 2), 0.02, 1.0)
        path = src / f"face{side}.png"
        faces[str(path)] = sources.height_source(h, path)
    atlas = TileAtlas(config, device)
    Preprocessor(atlas, loader=sources.loader(faces), device=False).clear_attachment(
        0).preprocess_spherical(
        SphericalDataset(attachment_index=0, paths=list(faces), lod_range=range(0, 3))
    ).run(verbose=False)

    terrain = Terrain(config, device=device)
    terrain.add_view("cam", TerrainViewConfig(tile_capacity=2048), queue_capacity=2048,
                     culling=True, blend_per_vertex=True)
    view = np.array([0.0, 0.0, radius + 60_000.0])
    vp = view_projection(view, view * 0.5, np.pi / 3, 16 / 9)
    return _capture_streamed(terrain, view, view_proj=vp)


def spherical_deep_subset(nodes, heights, positions, min_lod=10, cap=192):
    """The committed buffer subset: the first ``cap`` tiles (in sorted node
    order) with geometry lod >= ``min_lod``."""
    idx = np.nonzero(nodes[:, 1] >= min_lod)[0][:cap]
    return nodes[idx], heights[idx], positions[idx]


def write(out_dir: Path, device) -> list:
    """Every golden into ``out_dir``; returns the files written."""
    out_dir.mkdir(parents=True, exist_ok=True)
    files = []
    for name, model, view, lods in node_selection_cases():
        nodes = refine_nodes(model, view, lods, device)
        np.savez_compressed(out_dir / f"{name}.npz", nodes=nodes)
        files.append(out_dir / f"{name}.npz")
        print(f"{name}: {len(nodes)} nodes")
    with tempfile.TemporaryDirectory() as tmp:
        nodes, heights, positions = mesh_case(Path(tmp), device)
    np.savez_compressed(out_dir / "mesh_planar_streamed.npz", nodes=nodes, heights=heights,
                        positions=positions)
    files.append(out_dir / "mesh_planar_streamed.npz")
    print(f"mesh_planar_streamed: {len(nodes)} tiles, strip {heights.shape}")
    with tempfile.TemporaryDirectory() as tmp:
        nodes, heights, positions = mesh_spherical_case(Path(tmp), device)
    dn, dh, dp = spherical_deep_subset(nodes, heights, positions)
    np.savez_compressed(out_dir / "mesh_spherical_streamed.npz", nodes=nodes, deep_nodes=dn,
                        deep_heights=dh, deep_positions=dp)
    files.append(out_dir / "mesh_spherical_streamed.npz")
    print(f"mesh_spherical_streamed: {len(nodes)} tiles ({len(dn)} deep kept), "
          f"strip {dh.shape}")
    return files


def compare(out_dir: Path, golden_dir: Path = GOLDEN_DIR) -> dict:
    """Hold ``out_dir``'s goldens to ``golden_dir``'s (the base files, read
    as data): node lists exactly, meshes at :data:`MESH_TOL`. Returns
    {case: max |error| per mesh array, or 0 for a node case}; raises on
    the first difference."""
    result = {}
    for name in NODE_CASES:
        got = np.load(out_dir / f"{name}.npz")["nodes"]
        want = np.load(golden_dir / f"{name}.npz")["nodes"]
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"{name}: {len(got)} nodes, the golden {len(want)}; "
                                 "the lists differ")
        result[name] = {"nodes": len(got)}
    for name, (h_tol, p_tol) in MESH_TOL.items():
        got, want = np.load(out_dir / f"{name}.npz"), np.load(golden_dir / f"{name}.npz")
        row = {}
        for key in want.files:
            if key.endswith("nodes"):
                if not np.array_equal(got[key], want[key]):
                    raise AssertionError(f"{name}: {key} differ from the golden")
                row[key] = len(want[key])
                continue
            tol = h_tol if "heights" in key else p_tol
            err = float(np.abs(got[key].astype(np.float64) - want[key]).max())
            row[key] = err
            if not err <= tol:
                raise AssertionError(f"{name}: {key} {err:.3e} from the golden (tol {tol:.0e})")
        result[name] = row
        print(f"{name}: " + ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                                       for k, v in row.items()))
    print(f"check OK: {len(result)} goldens of {golden_dir} reproduced")
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", metavar="DIR", help="where the .npz go (default: a temporary "
                    "directory, removed after --check)")
    ap.add_argument("--check", action="store_true",
                    help="hold the written goldens to tests/goldens/")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(args.out) if args.out else Path(tmp)
        if out.resolve() == GOLDEN_DIR.resolve():
            raise SystemExit("make_goldens: the committed goldens are read, never written")
        write(out, device)
        return compare(out) if args.check else {"out": str(out)}


if __name__ == "__main__":
    main()
