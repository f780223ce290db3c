"""Full-material frame measurement.

Twin of tools/material_frame_bench.py on the port. One call = refinement ->
planar mesh kernel -> 4-channel albedo fetch at the morphed vertex uvs ->
PBR shade, and the variants with the albedo (and the shade) inside the
mesh kernel, on the bench.py 8k^2 planar scene at capacity 4096
(tools_torch/scenes.py). The kernels each variant runs on the card:

  mesh-only, + fused_to_grid      mesh_fused_planar (K1)
  RGBA x4 planar                  K1 + attach_sample_fused (K5a) per channel
  RGBA packed, PBR shade = full   K1 + attach_sample_fused_packed (K5b)
  RGBA x4 grad-4-tap              K1 + the staged sampler (torch ops)
  MERGED mesh+RGBA, MERGED + PBR  mesh_fused_albedo (K3)
  ONE-KERNEL material, + 1-DMA,   mesh_fused_shaded (K4)
  opaque

Rows are device time on the card (``utils/timing.device_time_ms``); with
``--cpu``, the least host wall of a few calls on the CPU.

Usage: python tools_torch/material_frame_bench.py [--cpu]
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else "cuda"
    on_card = device == "cuda"
    # (the JAX tool's jax_compilation_cache_dir and block_format() have no
    # counterpart: the port has one block layout)

    from bevy_terrain_tpu_torch.ops import meshgen, refinement
    from bevy_terrain_tpu_torch.ops.meshgen import fused_albedo_to_grid
    from bevy_terrain_tpu_torch.ops.patch_sampling import (
        sample_attachment_vertices, sample_attachment_vertices_grad,
    )
    from bevy_terrain_tpu_torch.render.material import (
        StandardMaterial, albedo_material, kernel_shade_spec, shade,
    )
    from tools_torch.scenes import build_scene, time_ms

    cfg, plan, blocks, u1, _ = build_scene(device=device)
    # 4 albedo channels (Rgba8), same plan. Production stores them PACKED
    # (one int32 word per texel, TileAtlas block_packed): one quad fetch
    # serves all four; the 4-array layout is kept for the comparison row.
    # (uint8 draws from default_rng(7): the JAX tool draws int64, other
    # values of the same distribution)
    rng = np.random.default_rng(7)
    albedo_chans = [
        rng.integers(0, 256, tuple(blocks.shape), dtype=np.uint8).astype(np.uint32)
        for _ in range(4)
    ]
    albedo_blocks = tuple(
        torch.from_numpy(c.view(np.int32)).to(device) for c in albedo_chans
    )
    packed_np = albedo_chans[0].copy()
    for c in range(1, 4):
        packed_np |= albedo_chans[c] << (8 * c)
    del albedo_chans
    albedo_packed = torch.from_numpy(packed_np.view(np.int32)).to(device)
    material = StandardMaterial(base_color=albedo_material(1))

    def fused(block_array, u, **kw):
        tiles = refinement.refine_tiles(u, cfg)
        return meshgen.generate_mesh_fused(tiles, block_array, u, cfg, plan, 65535.0, **kw)

    def mesh_only(block_array, u):
        raw, tiles = fused(block_array, u)
        return tiles.tile_count, raw

    def mesh_grid(block_array, u):
        raw, tiles = fused(block_array, u)
        mesh = meshgen.fused_to_grid(raw, tiles, cfg)
        return tiles.tile_count, mesh.positions

    def mesh_rgba(block_array, ab, u):
        raw, tiles = fused(block_array, u)
        mesh = meshgen.fused_to_grid(raw, tiles, cfg)
        rgba = sample_attachment_vertices(
            list(ab), tiles, mesh.uvs, u, cfg, plan, 255.0
        )
        return tiles.tile_count, rgba

    def mesh_rgba_packed(block_array, ap, u):
        raw, tiles = fused(block_array, u)
        mesh = meshgen.fused_to_grid(raw, tiles, cfg)
        rgba = sample_attachment_vertices(
            [ap], tiles, mesh.uvs, u, cfg, plan, 255.0,
            packed_channels=4, packed_bits=8,
        )
        return tiles.tile_count, rgba

    def mesh_rgba_grad(block_array, ab, u):
        raw, tiles = fused(block_array, u)
        mesh = meshgen.fused_to_grid(raw, tiles, cfg)
        rgba = sample_attachment_vertices_grad(
            list(ab), tiles, mesh.uvs, mesh, u, cfg, plan, 255.0, taps=4
        )
        return tiles.tile_count, rgba

    def full(block_array, ap, u):
        raw, tiles = fused(block_array, u)
        mesh = meshgen.fused_to_grid(raw, tiles, cfg)
        rgba = sample_attachment_vertices(
            [ap], tiles, mesh.uvs, u, cfg, plan, 255.0,
            packed_channels=4, packed_bits=8,
        )
        colors = shade(
            mesh, tiles, u, cfg, material=material, lighting=True,
            attachment_samples={1: rgba},
        )
        return tiles.tile_count, colors

    def merged(block_array, ap, u):
        # mesh + packed RGBA in ONE kernel (shared quad fetch, tents,
        # window weights), then PBR shade
        raw, tiles = fused(block_array, u, albedo_blocks=ap, albedo_channels=4,
                           albedo_bits=8)
        mesh = meshgen.fused_to_grid(raw, tiles, cfg)
        rgba = fused_albedo_to_grid(raw, cfg, 4, 255.0)
        return tiles.tile_count, rgba, mesh

    def merged_full(block_array, ap, u):
        raw, tiles = fused(block_array, u, albedo_blocks=ap, albedo_channels=4,
                           albedo_bits=8)
        mesh = meshgen.fused_to_grid(raw, tiles, cfg)
        rgba = fused_albedo_to_grid(raw, cfg, 4, 255.0)
        colors = shade(
            mesh, tiles, u, cfg, material=material, lighting=True,
            attachment_samples={1: rgba},
        )
        return tiles.tile_count, colors

    # combined block store: heights rows 0:32, packed albedo rows 32:64 —
    # ONE 32 KB quad fetch per tile serves the whole material frame
    combined_blocks = torch.cat([blocks, albedo_packed], dim=1)

    shade_spec = kernel_shade_spec(material, 255.0)

    def merged_combined_shaded(cb, u):
        raw, tiles = fused(cb, u, albedo_channels=4, albedo_bits=8, albedo_combined=True,
                           shade_spec=shade_spec)
        return tiles.tile_count, raw

    def merged_combined_opaque(cb, u):
        # opaque material: alpha never read -> 3-channel unpack/resample
        raw, tiles = fused(cb, u, albedo_channels=3, albedo_bits=8, albedo_combined=True,
                           shade_spec=shade_spec)
        return tiles.tile_count, raw

    def merged_shaded(block_array, ap, u):
        # the ENTIRE material frame in one kernel: mesh + packed RGBA +
        # in-kernel PBR (raw layout out; grid views extract lazily)
        raw, tiles = fused(block_array, u, albedo_blocks=ap, albedo_channels=4, albedo_bits=8,
                           shade_spec=shade_spec)
        return tiles.tile_count, raw

    c0, _ = mesh_only(blocks, u1)
    c1, colors = full(blocks, albedo_packed, u1)
    # packed parity vs planar at the same uvs (production stores packed)
    rp = mesh_rgba_packed(blocks, albedo_packed, u1)[1]
    rq = mesh_rgba(blocks, albedo_blocks, u1)[1]
    perr = float((rp - rq).abs().max())
    # merged-kernel parity: its fused colors vs the standalone packed
    # sampler at the same morphed uvs, live tiles only
    cm, rm, _ = merged(blocks, albedo_packed, u1)
    nlive = int(cm)
    merr = float((rm[:nlive] - rp[:nlive]).abs().max())
    _, cfull = merged_full(blocks, albedo_packed, u1)
    # in-kernel shade parity vs the staged shade, live tiles only
    cs, raw_s = merged_shaded(blocks, albedo_packed, u1)
    cc, raw_cb = merged_combined_shaded(combined_blocks, u1)
    cerr = float((raw_cb - raw_s).abs().max())
    co, raw_op = merged_combined_opaque(combined_blocks, u1)
    # opaque parity: RGB rows match the 4-channel run's RGB rows
    base_rows = raw_op.shape[1] - 3
    oerr = float((raw_op[:, base_rows:] - raw_s[:, base_rows:base_rows + 3]).abs().max())
    assert int(co) == int(cs)
    shaded_grid = fused_albedo_to_grid(raw_s, cfg, 4, 1.0)
    serr = float((shaded_grid[:nlive] - cfull[:nlive]).abs().max())
    assert int(c0) == int(c1) == nlive == int(cs) == int(cc)

    def t(fn, *args, label):
        return time_ms(fn, *args, label=label, on_card=on_card)[0]

    t_mesh = t(mesh_only, blocks, u1, label="mat_mesh")
    t_grid = t(mesh_grid, blocks, u1, label="mat_grid")
    t_rgba = t(mesh_rgba, blocks, albedo_blocks, u1, label="mat_rgba")
    t_pack = t(mesh_rgba_packed, blocks, albedo_packed, u1, label="mat_pack")
    t_grad = t(mesh_rgba_grad, blocks, albedo_blocks, u1, label="mat_grad")
    t_full = t(full, blocks, albedo_packed, u1, label="mat_full")
    t_merged = t(merged, blocks, albedo_packed, u1, label="mat_merged")
    t_mfull = t(merged_full, blocks, albedo_packed, u1, label="mat_merged_full")
    t_mshade = t(merged_shaded, blocks, albedo_packed, u1, label="mat_merged_shaded")
    t_mcomb = t(merged_combined_shaded, combined_blocks, u1, label="mat_merged_combined")
    t_mopaq = t(merged_combined_opaque, combined_blocks, u1, label="mat_merged_opaque")
    what = "device" if on_card else "CPU wall"
    print(
        f"timing: {what} time per call\n"
        f"mesh-only frame:        {t_mesh * 1e3:7.1f} us ({int(c0)} tiles)\n"
        f"+ fused_to_grid:        {t_grid * 1e3:7.1f} us "
        f"(+{(t_grid - t_mesh) * 1e3:.1f})\n"
        f"  [RGBA x4 planar:      {t_rgba * 1e3:7.1f} us "
        f"(+{(t_rgba - t_grid) * 1e3:.1f}; legacy 4-pass layout)]\n"
        f"+ RGBA packed fetch:    {t_pack * 1e3:7.1f} us "
        f"(+{(t_pack - t_grid) * 1e3:.1f}; one fetch serves 4 channels, "
        f"parity {perr:.2e})\n"
        f"  [RGBA x4 grad-4-tap:  {t_grad * 1e3:7.1f} us "
        f"(+{(t_grad - t_grid) * 1e3:.1f} vs mesh; SAMPLE_GRAD option)]\n"
        f"+ PBR shade = full:     {t_full * 1e3:7.1f} us "
        f"(+{(t_full - t_pack) * 1e3:.1f})\n"
        f"MERGED mesh+RGBA:       {t_merged * 1e3:7.1f} us "
        f"(one kernel; parity vs packed {merr:.2e})\n"
        f"MERGED + PBR = full:    {t_mfull * 1e3:7.1f} us\n"
        f"ONE-KERNEL material:    {t_mshade * 1e3:7.1f} us "
        f"(in-kernel PBR; parity vs staged shade {serr:.2e}) "
        f"(capacity {cfg.tile_capacity})\n"
        f"ONE-KERNEL + 1-DMA:     {t_mcomb * 1e3:7.1f} us "
        f"(combined height+albedo blocks, one 32 KB fetch/tile; "
        f"parity vs two-stream {cerr:.2e})\n"
        f"ONE-KERNEL opaque:      {t_mopaq * 1e3:7.1f} us "
        f"(opaque_base_color: 3-channel unpack, alpha pinned 1; "
        f"RGB parity {oerr:.2e})"
    )
    return {"tiles": nlive, "timing": what, "ms": {
        "mesh_only": t_mesh, "mesh_grid": t_grid, "rgba_planar": t_rgba,
        "rgba_packed": t_pack, "rgba_grad": t_grad, "full": t_full, "merged": t_merged,
        "merged_full": t_mfull, "merged_shaded": t_mshade,
        "merged_combined": t_mcomb, "merged_opaque": t_mopaq},
        "parity": {"packed": perr, "merged": merr, "shade": serr, "combined": cerr,
                   "opaque": oerr}}


if __name__ == "__main__":
    main()
