"""Rust-interchange verification kit on the port.

Twin of tools/rust_interchange.py. The "bit-comparable vs the Rust
reference" check goes through the ON-DISK INTERCHANGE both engines share:
``assets/{path}/config.tc`` (bincode-2 varint, reference
src/formats/mod.rs:8-36) and raw ``.bin`` tile payloads (reference
src/terrain_data/tile_atlas.rs:77-149). Here the port makes every artifact:

1. ``--emit DIR`` writes the deterministic fixture:
   * ``source/height.png``: the 1024^2 16-bit source of f64 polynomial
     arithmetic (``utils/synthetic.interchange_source``), written where PIL
     imports; without PIL it is named "not made" and not written;
   * ``assets/terrains/interchange/``: the port's ``Preprocessor`` output
     (host path, the native runtime) for the reference-shaped config
     (``utils/synthetic.INTERCHANGE``), the source handed over in memory;
   * ``requests_pose{i}.csv``: the port's request scan
     (``terrain_data/tile_tree.TileTree.compute_requests``: the native
     runtime, or numpy with ``BT_DISABLE_NATIVE=1``) for three fixed
     camera poses from fresh state, plus the pose0 -> pose1 transition
     request / release lists;
   * ``replay_interchange.rs``: the cargo-side test body;
   * ``MANIFEST.json``: sha256 of every artifact.
2. ``--check`` emits into a temporary directory and holds every hash to the
   committed ``tools/interchange_expected.json`` (read as data): it prints
   how many it reproduced and names any it could not make; an artifact it
   made that differs fails the check.
3. ``--freeze PATH`` writes the current emit's hashes to PATH (never to the
   committed file).
4. ``--compare-tc A B`` / ``--compare-tiles DIRA DIRB`` diff a Rust-made
   dataset against the port's: config.tc as tile SETS (the reference
   serializes a HashSet), .bin payloads per texel with an lsb histogram.

The atlas has 32 slots (the JAX tool's 1024 would hold 1.8 GB of blocks;
no artifact depends on the slot count). The atlas lives on the card unless
``--cpu``.

Usage: python tools_torch/rust_interchange.py [--cpu] (--emit DIR | --check |
       --freeze PATH | --compare-tc A B | --compare-tiles DIRA DIRB)
"""

from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

EXPECTED = Path(__file__).resolve().parent.parent / "tools" / "interchange_expected.json"
SOURCE_PNG = "source/height.png"
POSES = [
    (120.0, -40.0, -200.0),
    (-380.0, -70.0, 310.0),
    (10.0, 150.0, 20.0),
]


def _sha(p: Path) -> str:
    return hashlib.sha256(p.read_bytes()).hexdigest()


def write_png(source: np.ndarray, path: Path) -> bool:
    """The 16-bit PNG of ``source`` at ``path``; False where PIL is absent."""
    try:
        from PIL import Image
    except ImportError:
        return False
    Image.fromarray(source).save(path)
    return True


def emit(outdir: Path, device: str = "cuda", verbose: bool = True) -> tuple[dict, list]:
    """Write the fixture into ``outdir``; returns (manifest {artifact:
    sha256}, the artifacts not made)."""
    from bevy_terrain_tpu_torch import (
        AttachmentConfig, AttachmentFormat, PreprocessDataset, Preprocessor, TerrainConfig,
        TerrainModel, TerrainViewConfig,
    )
    from bevy_terrain_tpu_torch.terrain_data import TileAtlas
    from bevy_terrain_tpu_torch.terrain_data.tile_tree import TileTree
    from bevy_terrain_tpu_torch.utils.synthetic import INTERCHANGE as KIT, interchange_source

    outdir = Path(outdir)
    if outdir.exists():
        shutil.rmtree(outdir)
    (outdir / "source").mkdir(parents=True)
    source = interchange_source(KIT["source_size"])
    not_made = [] if write_png(source, outdir / SOURCE_PNG) else [SOURCE_PNG]
    # what load_source_image returns for the 16-bit PNG
    loaded = source[..., None].astype(np.float32) / 65535.0

    config = TerrainConfig(
        lod_count=KIT["lod_count"],
        model=TerrainModel.planar(np.zeros(3), KIT["terrain_size"], 0.0, KIT["height"]),
        atlas_size=32, path=KIT["path"], assets_root=str(outdir / "assets"),
    ).add_attachment(AttachmentConfig(
        name="height", texture_size=KIT["texture_size"], border_size=KIT["border_size"],
        mip_level_count=KIT["mip_count"], format=AttachmentFormat.R16))
    atlas = TileAtlas(config, device)
    # host path: the integer-exact native / numpy pipeline
    Preprocessor(atlas, loader=lambda path, cfg: loaded, device=False).clear_attachment(
        0).preprocess_tile(PreprocessDataset(
            attachment_index=0, path=str(outdir / SOURCE_PNG),
            lod_range=range(0, KIT["lod_count"]))).run(verbose=False)

    # request-scan captures: fresh tree per pose + pose0 -> pose1 deltas
    def fmt(tiles):
        rows = sorted((t.side, t.lod, t.x, t.y) for t in tiles)
        return "".join(f"{s},{l},{x},{y}\n" for s, l, x, y in rows)

    vc = TerrainViewConfig()
    for i, pose in enumerate(POSES):
        tree = TileTree(atlas, vc)
        tree.compute_requests(np.asarray(pose, np.float64))
        (outdir / f"requests_pose{i}.csv").write_text("side,lod,x,y\n" + fmt(tree.requested_tiles))
    tree = TileTree(atlas, vc)
    tree.compute_requests(np.asarray(POSES[0], np.float64))
    tree.compute_requests(np.asarray(POSES[1], np.float64))
    (outdir / "transition_requested.csv").write_text("side,lod,x,y\n" + fmt(tree.requested_tiles))
    (outdir / "transition_released.csv").write_text("side,lod,x,y\n" + fmt(tree.released_tiles))

    (outdir / "replay_interchange.rs").write_text(rust_replay_test())

    manifest = {}
    for p in sorted(outdir.rglob("*")):
        if p.is_file() and p.name != "MANIFEST.json":
            manifest[str(p.relative_to(outdir))] = _sha(p)
    (outdir / "MANIFEST.json").write_text(json.dumps(manifest, indent=1))
    if verbose:
        print(f"emitted {len(manifest)} artifacts ({len(atlas.state.existing_tiles)} tiles) "
              f"-> {outdir}" + (f"; not made: {not_made}" if not_made else ""))
    return manifest, not_made


def rust_replay_test() -> str:
    """The cargo-side test body, pinned to the fixture constants above.
    Appended to the reference's src/terrain_data/tile_tree.rs (it needs
    crate-private TileTree::update); see PARITY.md."""
    from bevy_terrain_tpu_torch.utils.synthetic import INTERCHANGE as KIT

    poses = ",\n        ".join(
        f"DVec3::new({p[0]:.1f}, {p[1]:.1f}, {p[2]:.1f})" for p in POSES
    )
    return f"""\
// Appended to bevy_terrain's src/terrain_data/tile_tree.rs (cargo test
// replay_interchange -- --nocapture). Fixture: rust_interchange.py --emit.
#[cfg(test)]
mod replay_interchange {{
    use super::*;
    use crate::math::TerrainModel;
    use crate::terrain_data::{{AttachmentConfig, AttachmentFormat, TileAtlas}};
    use crate::terrain::TerrainConfig;
    use crate::terrain_view::TerrainViewConfig;
    use bevy::math::DVec3;
    use std::fs;

    const POSES: [DVec3; {len(POSES)}] = [
        {poses},
    ];

    fn write(path: &str, tiles: &mut Vec<TileCoordinate>) {{
        tiles.sort_by_key(|t| (t.side, t.lod, t.x, t.y));
        let mut s = String::from("side,lod,x,y\\n");
        for t in tiles {{
            s += &format!("{{}},{{}},{{}},{{}}\\n", t.side, t.lod, t.x, t.y);
        }}
        fs::write(path, s).unwrap();
    }}

    #[test]
    fn replay_interchange() {{
        // run from the crate root with the emitted fixture's assets/
        // symlinked or copied to ./assets (config.tc + data/height/)
        let config = TerrainConfig {{
            lod_count: {KIT['lod_count']},
            model: TerrainModel::planar(DVec3::ZERO, {KIT['terrain_size']:.1f}, 0.0, {KIT['height']:.1f}),
            atlas_size: 1024,
            path: "{KIT['path']}".to_string(),
            attachments: vec![],
        }}
        .add_attachment(AttachmentConfig {{
            name: "height".to_string(),
            texture_size: {KIT['texture_size']},
            border_size: {KIT['border_size']},
            mip_level_count: {KIT['mip_count']},
            format: AttachmentFormat::R16,
        }});
        let atlas = TileAtlas::new(&config);
        let view_config = TerrainViewConfig::default();
        for (i, pose) in POSES.iter().enumerate() {{
            let mut tree = TileTree::new(&atlas, &view_config);
            tree.update(*pose, &atlas);
            write(&format!("requests_pose{{i}}.csv"), &mut tree.requested_tiles.clone());
        }}
        let mut tree = TileTree::new(&atlas, &view_config);
        tree.update(POSES[0], &atlas);
        tree.requested_tiles.clear();
        tree.released_tiles.clear();
        tree.update(POSES[1], &atlas);
        write("transition_requested.csv", &mut tree.requested_tiles.clone());
        write("transition_released.csv", &mut tree.released_tiles.clone());
        // diff the five CSVs against the emitted fixture's: integer tile
        // lists must match EXACTLY (both sides compute f64 host math).
    }}
}}
"""


def compare_tc(a: Path, b: Path) -> int:
    from bevy_terrain_tpu_torch.formats.tc import TC

    ta = {(t.side, t.lod, t.x, t.y) for t in TC.decode(Path(a).read_bytes()).tiles}
    tb = {(t.side, t.lod, t.x, t.y) for t in TC.decode(Path(b).read_bytes()).tiles}
    only_a, only_b = sorted(ta - tb), sorted(tb - ta)
    print(f"{a}: {len(ta)} tiles; {b}: {len(tb)} tiles; "
          f"only-in-a {len(only_a)}, only-in-b {len(only_b)}")
    for t in only_a[:20]:
        print("  only in a:", t)
    for t in only_b[:20]:
        print("  only in b:", t)
    return 0 if not only_a and not only_b else 1


def compare_tiles(da: Path, db: Path, dtype=np.uint16) -> int:
    """Per-texel diff of matching .bin payloads with an lsb histogram."""
    names_a = {p.name for p in Path(da).glob("*.bin")}
    names_b = {p.name for p in Path(db).glob("*.bin")}
    if names_a != names_b:
        print(f"tile SET differs: only-in-a {sorted(names_a - names_b)[:10]} "
              f"only-in-b {sorted(names_b - names_a)[:10]}")
        return 1
    worst, hist = 0, {}
    for name in sorted(names_a):
        va = np.fromfile(Path(da) / name, dtype=dtype).astype(np.int64)
        vb = np.fromfile(Path(db) / name, dtype=dtype).astype(np.int64)
        if va.shape != vb.shape:
            print(f"{name}: SIZE differs {va.shape} vs {vb.shape}")
            return 1
        d = np.abs(va - vb)
        worst = max(worst, int(d.max()))
        for lsb, count in zip(*np.unique(d[d > 0], return_counts=True)):
            hist[int(lsb)] = hist.get(int(lsb), 0) + int(count)
    total = sum(hist.values())
    print(f"{len(names_a)} tiles compared; differing texels {total}; "
          f"max lsb diff {worst}; histogram {dict(sorted(hist.items())[:8])}")
    # byte-exact is the expectation for the port's host and device paths;
    # vs the Rust GPU pipeline, half-texel quantization ties may flip 1 lsb
    return 0 if worst <= 1 else 1


def check(device: str = "cuda") -> dict:
    """Emit into a temporary directory and hold every hash to the committed
    expectation. Returns {"reproduced", "expected", "not_made", "differ"};
    raises when an artifact made differs or one expected is neither made
    nor named."""
    with tempfile.TemporaryDirectory() as tmp:
        manifest, not_made = emit(Path(tmp) / "kit", device, verbose=False)
    want = json.loads(EXPECTED.read_text())
    differ = sorted(k for k in set(want) | set(manifest)
                    if k not in not_made and want.get(k) != manifest.get(k))
    reproduced = sum(1 for k in want if manifest.get(k) == want[k])
    result = {"reproduced": reproduced, "expected": len(want), "not_made": not_made,
              "differ": differ}
    if differ:
        print(f"DETERMINISM BROKEN: {len(differ)} artifacts differ:")
        for k in differ[:20]:
            print(f"  {k}: want {want.get(k, '<missing>')[:16]} "
                  f"got {manifest.get(k, '<missing>')[:16]}")
        raise AssertionError(f"interchange fixture: {len(differ)} artifacts differ")
    print(f"check OK: {reproduced} of {len(want)} committed hashes reproduced"
          + (f"; not made here: {not_made}" if not_made else ""))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--emit", metavar="DIR")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--freeze", metavar="PATH")
    ap.add_argument("--compare-tc", nargs=2, metavar=("A", "B"))
    ap.add_argument("--compare-tiles", nargs=2, metavar=("DIRA", "DIRB"))
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    if args.compare_tc:
        return compare_tc(*map(Path, args.compare_tc))
    if args.compare_tiles:
        return compare_tiles(*map(Path, args.compare_tiles))
    if args.emit:
        return emit(Path(args.emit), device)[0]
    if args.freeze:
        with tempfile.TemporaryDirectory() as tmp:
            manifest, not_made = emit(Path(tmp) / "kit", device, verbose=False)
        Path(args.freeze).write_text(json.dumps(manifest, indent=1))
        print(f"froze {len(manifest)} hashes -> {args.freeze}"
              + (f"; not made: {not_made}" if not_made else ""))
        return manifest
    if args.check:
        return check(device)
    ap.print_help()
    return None


if __name__ == "__main__":
    result = main()
    sys.exit(result if isinstance(result, int) else 0)
