#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (bevy_terrain_tpu_torch) on one card.

    python3 chip_smoke.py

1. Builds every CUDA kernel from ``bevy_terrain_tpu_torch/csrc`` and
   prints each kernel's registers and shared memory (``ptxas -v``) and its
   blocks per SM on this card (the library's ``kernel_occupancy`` query);
   fails if K1, K6 or K7 holds fewer than 4 blocks per SM or K2 fewer than 3.
   Then builds the native host runtime (``native/terrain_runtime.cpp``,
   g++) and prints a ``native:`` line: ``uname -m``, ``g++ --version``, the
   flags, the build seconds, the hash of source and flags, the card.
2. Planar kernel phase, at the frame's real shapes (the bench.py scene: 8k^2
   planar terrain, 5 lods, tile capacity 4096, culled camera, a 1024-slot
   random atlas): refinement and patch plan on the card against the same
   on the CPU, then the kernel against its plain PyTorch version on the
   same inputs, and both timed with CUDA events; then timed on grids of 1,
   2, 4 and 8 waves of resident blocks in turns, its output bit-equal at
   each.
3. Spherical kernel phase, on the Earth scene (tools/earth_frame_bench.py:
   a 6.371e6 m cube sphere, 13 geometry lods over 3 data lods, capacity
   2048, a culled camera at 60 km, a 512-slot random atlas), for the sphere,
   for the WGS84-like ellipsoid and for the sphere at 3 km (the Taylor near
   field): refinement and plan on the card against the CPU (only
   subdivision-threshold ties may differ), the spherical kernel against its
   plain version, timings (on the sphere at 60 km also the waves sweep, as
   in phase 2). On each of the three frames also the spherical
   material kernel phase: ``mesh_fused_spherical_albedo`` (K3s: fast, exact,
   opaque and combined blocks) on a 512-slot random packed Rgba8 albedo of
   the height's plan against its plain version, its mesh channels against
   K2's output (bit for bit) and its colours against the packed sampler at
   the kernel's own morphed uvs, timed and bounded.
4. Material kernel phase, at the bench.py frame with a 1024-slot random
   packed Rgba8 albedo of the height's plan: the albedo kernel (fast,
   exact, opaque and combined blocks), the shaded kernel (directional,
   point and spot lights; fast and exact albedo) and the attachment
   samplers (Rgba8, Rg16 and one raw channel), each against its plain
   version, timed and bounded; then K4, K3, K5b and K5a timed on grids of 1, 2,
   4 and 8 waves of resident blocks in turns, the outputs bit-equal at each.
5. Half-grid kernel phase, at the bench.py frame: ``fetch_resample_cached``
   (K6) against its plain version with the plan's tile-centre ratio and
   with ``blend_per_vertex``; ``fetch_resample`` (K7) against its plain
   version on the inputs of tools/fetch_kernel_sweep.py (4096 random quads,
   8192 tiles) and, re-ordered, against K6 on the bench frame; the staged
   half-grid functions against K6; each kernel timed and bounded (K7's
   per-tile fetch floor printed beside its bound), and K6 on the bench
   frame and K7 on the sweep inputs timed on grids of 1, 2, 4 and 8 waves
   of resident blocks in turns, the outputs bit-equal at each. Then the
   staged mesh (``meshgen.generate_mesh_grid``) against the fused mesh
   kernel on the same tiles.
6. Native path (``native_path``), first of the paths: the deep streaming
   flythrough (tools_torch/flythrough_bench.py's scene, 120 frames) and the
   sphere main path's planet (20 frames at 60 km, 20 at 3 km) through
   ``Terrain.update`` with tile loads in step, and the preprocess host
   path on the bench geometry's height (341 R16 tiles) and the interchange
   fixture: run here with the native runtime, then twice in a child process
   with ``BT_DISABLE_NATIVE=1`` (the numpy paths; ``python3 chip_smoke.py
   --native-child DIR``), then here again. Every frame's sha256 (sorted
   requested and released keys, entries, packed blob, ``raw_mesh``) and
   every file written must be equal in the four runs, the fixture's 22
   committed sha256 reproduced; each native entry point the path uses must
   have run (``native.counts()``). ``native:`` lines give the host
   prologue (scan; residency + IO; adjust, height, Taylor, pack) apart from
   the device stage, per run in turns, medians and spreads on the host
   clock; the preprocess tiles/s in turns. Then ``ops/tile_tree.py``'s
   device twin of the scan on the card against its f64 host twin on each
   scene's last frame: tile_xy equal, masks agreeing on over 99% of slots.
7. Main paths: a synthetic 8k^2 planar dataset; a synthetic six-side
   planet, fused (the Taylor path) and then staged (``add_view(...,
   high_precision=False)``: ``generate_mesh_grid``, K6 once per frame and no
   mesh kernel), the two stages timed in turns; the planet with a
   synthetic Rgba8 albedo lit by a StandardMaterial (a planet's material is
   staged: K2 + the packed sampler every frame, no in-kernel material), the
   stage timed in turns with the height-only one, then the unlit albedo and
   the albedo in the mesh kernel (K3s) through
   ``meshgen.generate_mesh_fused``; the 8k^2 dataset with an
   Rgba8 albedo lit by a StandardMaterial (then opaque, the staged unlit
   albedo, the albedo in the mesh kernel through
   ``meshgen.generate_mesh_fused``, one attachment grid, and an albedo with
   border 1, whose plan is not the height's: the staged sampler, no sampler
   kernel); a terrain of 32^2 height tiles, too small for the patch plan
   (the per-vertex path: no kernel at all); and ``kernels.fetch_resample``
   called as the sweep tool calls it. Each is streamed through
   ``Terrain(config).update`` on the card until quiescent; every frame must
   go through its kernels (launch counts, set to 0 just before each path
   and read just after), the output must be finite, in range and match the
   plain version; a torch.profiler pass breaks each device stage's time
   down by kernel. The planar dataset, height-only and with its lit
   albedo, is also streamed on the kernel-free path (``add_view(...,
   pallas_sampling=False)`` on the card, the per-vertex blend of the fused
   kernel: the JAX package's XLA path, in torch ops): no kernel may launch,
   the frame is held per tile to the default one within the fused-vs-staged
   yardsticks (the lit colours within 2/255), and ``Terrain._device_stage``
   is timed in turns with the default's (CUDA-event spans and profiler
   kernel time; ``pallas_sampling:`` lines with the card's name and power
   limit); its launches, all 0, are the kernels line's
   ``pallas_sampling_off_launches`` (its ``launches`` stay the main paths').
8. Query path, on the streamed planar terrain and on the planet with its
   albedo: ``Terrain.query_heights`` / ``query_attachment`` on 65 536
   seeded world points, the card against the same ops on the CPU and
   against the host sampling API on 256 of them, timed; no kernel launches.
9. Adaptive capacity path, on the planar terrain: a fly-in and two
   teleports over the capacity ladder against the same path at the fixed
   capacity: no frame drops geometry, the teleport re-dispatches its frame,
   the settled frames are equal.
10. Raster path (``render/raster.py``: torch ops and the scan kernel
   ``csrc/raster_scan.cu``), on two main paths' terrains after one more
   counted frame: the material frame (K4 in the frame) at 1920x1080 under
   the bench camera with tools/raster_bench.py's knobs, through
   ``Terrain.render_image`` per-pixel textured PBR (one scan launch), with
   ``pixel_texturing=False`` and a debug view (one packed sampler launch
   each, ``sample_attachment_grid``), then its binning over bin caps 512 to
   8192 up to the first that drops nothing (tools_torch/raster_ablation.py)
   and the scan at that cap; the spherical main path's planet (K2 in the
   frame) at 1024^2 with the first bin cap that drops nothing, the disc
   without holes. Each render is checked, timed (CUDA events; the
   profiler's device time, op count and rasterize_grid's three phases;
   ``raster:`` lines with the card's name and power limit) and held to the
   same ``render_view`` on the CPU fed the card's frame products, at half
   the width and height. On each frame, at its knobs and at the bench
   cells' (bin_px 16, bin_cap 512, chunk 16), the scan kernel against the
   torch scan on the same table: ``digest:`` lines of both and their
   equality, both times, the kernel's bound and the live share of the
   table's slots (``scan:`` lines).
11. Preprocess path (``preprocess/``, ``ops/preprocess*.py``: torch ops and
   numpy, no kernel of its own), after the main paths, every source made in
   numpy from a seed and handed over by ``loader=`` (no PIL): the
   interchange fixture (its hashes in tools/interchange_expected.json,
   read as data) on ``TileAtlas(config, "cuda")``
   (host, the device path that ``device=None`` must select with the full
   read-back, its two probe times printed, and the delta read-back; host
   and delta reproduce the committed sha256); the bench geometry (an 8192^2
   R16 height source and a 4096^2 Rgba8 albedo, lods 0-4 of 512^2: 341
   tiles each) and six 2048^2 planet faces (lods 0-2, 126 tiles, cross-face
   stitched), each on the host and on the card, every tile of the full
   device path held to the JAX package's yardstick (1 unit, under 2% of
   texels); the device-made datasets streamed through
   ``Terrain(config).update``: the planar one under the bench camera (K1
   every frame, the last frame against its plain version, heights against
   the analytic field), then lit by the smoke StandardMaterial over the
   preprocessed albedo (K4 every frame), the planet at 60 km (K2 every
   frame). One ``preprocess:`` line per run: tiles/s, per-phase ms (CUDA
   events on the card's phases, the host clock for the rest), H2D and D2H
   bytes, device memory peak, the card's name and power limit. The
   interchange fixture also runs with ``batch_tiles=3`` (3-tile chunks: the
   default's bytes), and ``device=None`` must decide by the device type
   alone (no transfer probe consulted).
12. Entry points path (``entry_points_path``), after the preprocess path:
   each example twin (examples_torch/: preprocess_planar, minimal, planar,
   preprocess_spherical, spherical, render_capture, in one assets directory)
   and each frame tool twin (tools_torch/: refine_bench, earth_frame_bench,
   flythrough_bench with ``--device-time``, material_frame_bench,
   raster_bench) called in-process through its ``main(argv)`` at the JAX
   defaults, then ``bevy_terrain_tpu_torch.entry.entry()``; the launch
   counts set to 0 before each call and read after it against the kernels
   the call must launch and those it must not (``ENTRY_POINTS``; entry()
   and the preprocess and refinement twins none), the preprocess twins on
   the device path, the flythrough with no overflow frame and its tiles
   loaded. One ``entry:`` line per call: wall seconds, launches, the
   call's own numbers.
13. Multi-view path (``multi_view_path``, ``parallel/``), last: four
   distinct unculled cameras over a synthetic 8k^2 planar dataset through
   one ``MultiViewTerrain`` (capacity 4096): K1 exactly once per view per
   frame and nothing else, each view's tiles and mesh of the same sha256 as
   a ``Terrain`` stepping the same views over the same atlas, the device
   memory peak against one block store, the ``update`` wall per view count
   in turns with that ``Terrain``, device kernel time and kernels a frame;
   the block store in 4 shards (the staged path with the sharded fetch: no
   kernel launch, each view within 2e-2 m of the replicated frame per
   tile); one rank of an NCCL group (``multi_card_path(1)``, spawned by
   ``parallel.launch``) over the same dataset at the production shape (a
   1024-slot atlas, capacity 4096), replicated (K1 once a frame) and
   sharded (the all-gather + reduce-scatter exchange, no kernel), its view
   sha256-equal to the one-process ``MultiViewTerrain``, its walls, device
   time and step audit printed (``multi_card:`` lines), then the group dry
   run with the production-shape audit; the rank's launches over its whole
   run are the kernels line's ``multi_card_launches`` (its ``launches``
   stay the main path's own); two views (60 km, 20 km) over the
   synthetic planet (K2 once per
   view, bit-equal); ``multi_view_frame_step`` with 4 distinct spherical
   cameras (no kernel); then ``entry.dryrun_multichip(4)`` and the tool
   twins multi_view_bench, fetch_kernel_sweep, census_frame, earth_census
   and preprocess_compute_bench at the JAX defaults, launches counted
   (``MV_TOOLS``), one ``entry:`` line each; ``multi_view:`` lines.
14. Ablation path (``ablation_path``), last: builds the ablation library
   (``kernels.build_ablation_library``: the mesh kernels' ablated instances,
   ``csrc/mesh_fused.cu`` under ``MESH_ABLATION``, six ``nvcc`` processes),
   prints each instance's registers, shared memory and spills (``ptxas
   -v``) and its instructions and cp.async copies (``cuobjdump -sass``;
   each must still copy its quads); then each variant of
   tools_torch/earth_kernel_ablation.py through K2 on its Earth frame
   (streamed, 1512 tiles) and of tools_torch/material_kernel_ablation.py
   through K3 and K4 on the bench frame (with K1's ``no_smooth`` and
   ``no_phase_a``, also run on K1), each against its plain version with the
   same ``ablate``, timed L2 warm and flushed, with its delta against the
   production kernel and the card's name and power limit; and the two
   tools' own rows (``generate_mesh_fused`` per variant). Then
   ``study_tools_path``: raster_ablation's cap sweep and stages on the
   bench frame, rust_interchange's check (committed hashes reproduced),
   make_goldens into a temporary directory held to tests/goldens/, and
   morph_gating_analysis's counts. Each ablated instance launched is a row
   of the kernels line (``wrapper[variant]``, its launches counted in the
   path, its bound the full kernel's on the same inputs).

Every kernel call of phases 2-5 prints the sha256 of its inputs and of its
output (``digest:`` lines): two trees built in one call are compared by
them, bit for bit. ``python3 chip_smoke.py --kernel-phases`` runs phases
1-5 only and prints their results without the result line; a copy of this
script placed in an older tree runs that tree's kernels the same way.
``python3 chip_smoke.py --ablation`` runs phase 1 and the ablation path
only (no result line). ``python3 chip_smoke.py --multi-card N`` runs phase 1
and the multi-card path on N cards (one rank each; raises with fewer
visible): the planar views replicated and sharded and the group dry run,
then, with N >= 2, the planet's two views on two cards, every view held to
the one-process class on card 0; a ``multi_card`` JSON line (the ranks'
launches, each rank's over its whole run), then the result line.

Exits non-zero (and prints no result line) when there is no CUDA card or
any check fails. The last line of stdout is the JSON result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from bevy_terrain_tpu_torch.utils.timing import (
    cold_ms, cuda_ms, device_breakdown, device_events, device_ms, device_time_ms,
)
from tools_torch.fetch_kernel_sweep import sweep_inputs  # K7's inputs, as its tool builds them
from tools_torch.scenes import (  # the bench.py frame, as the frame tools build it
    BORDER, LOD_COUNT, SIDE, TEXTURE_SIZE, bench_frame, bench_scene,
)

ROOT = Path(__file__).resolve().parent

# (wrapper name in ops.kernels, route, source, the TPU kernel it replaces)
KERNELS = [
    ("mesh_fused_planar", "cuda", "bevy_terrain_tpu_torch/csrc/mesh_fused.cu",
     "bevy_terrain_tpu/ops/pallas_kernels.py:1135"),
    ("mesh_fused_spherical", "cuda", "bevy_terrain_tpu_torch/csrc/mesh_fused.cu",
     "bevy_terrain_tpu/ops/pallas_kernels.py:1135"),
    ("mesh_fused_albedo", "cuda", "bevy_terrain_tpu_torch/csrc/mesh_fused.cu",
     "bevy_terrain_tpu/ops/pallas_kernels.py:1135"),
    ("mesh_fused_shaded", "cuda", "bevy_terrain_tpu_torch/csrc/mesh_fused.cu",
     "bevy_terrain_tpu/ops/pallas_kernels.py:374"),
    ("mesh_fused_spherical_albedo", "cuda", "bevy_terrain_tpu_torch/csrc/mesh_fused.cu",
     "bevy_terrain_tpu/ops/pallas_kernels.py:1135"),
    ("attach_sample_fused", "cuda", "bevy_terrain_tpu_torch/csrc/attach_sample.cu",
     "bevy_terrain_tpu/ops/pallas_kernels.py:1552"),
    ("attach_sample_fused_packed", "cuda", "bevy_terrain_tpu_torch/csrc/attach_sample.cu",
     "bevy_terrain_tpu/ops/pallas_kernels.py:1608"),
    ("fetch_resample_cached", "cuda", "bevy_terrain_tpu_torch/csrc/fetch_resample.cu",
     "bevy_terrain_tpu/ops/pallas_kernels.py:230"),
    ("fetch_resample", "cuda", "bevy_terrain_tpu_torch/csrc/fetch_resample.cu",
     "bevy_terrain_tpu/ops/pallas_kernels.py:1296"),
]
# kernel vs plain version: both f32, differing in summation order and libm
# ulps; positions reach 8 km, where one f32 ulp is ~0.5 mm
TOL_POS = 5e-3  # m, heights and positions
TOL_UV = 1e-5
# spherical kernel vs plain version, same inputs, same op order per vertex:
# heights differ by the resample's summation order (cuBLAS dots against the
# kernel's 2-tap sums) over a 9 km range; an absolute world position at
# 6.4e6 m rounds to 0.5 m steps, so a height ulp can move it by one step
TOL_SPH_H = 2e-2  # m
TOL_SPH_POS = TOL_SPH_H + 1.0  # m: the height tolerance plus two f32 ulps at 6.4e6 m
TOL_SPH_UV = 1e-6
TOL_SPH_N = 1e-6
TOL_UNIT = 1e-5  # |normal| - 1
# material kernels vs their plain versions, colours in [0, 1] (texel / max
# value, or shaded linear colour): the exact resample differs by the
# summation order only; the fast path rounds its y sums to bf16, where one
# step is up to 1/255 of an 8-bit texel. The shaded colours also carry the
# mesh heights' kernel-vs-plain gap through the normals (2.4e-4 over the
# exact albedo on one H100), so the whole kernel is held to 1e-3 over the
# exact albedo and its shade phase alone, on the kernel's own mesh rows,
# to 1e-4
TOL_ALB_EXACT = 1e-5
TOL_ALB_FAST = 2.0 / 255.0
TOL_SHADED_EXACT = 1e-3
TOL_SHADE_EXACT = 1e-4
# half-grid kernels vs their plain versions, in raw texel units on values up
# to 65535 (0.05 is 8e-7 of full scale): all sums f32 on both sides (the TPU
# kernels ran their dots in bf16 passes), differing in summation order (the
# plain versions' dense products against the kernels' sums over each row's
# support) and, for K6, in the patch mean (an exact integer sum in the
# kernel, a float mean in the plain version). The same bound holds K7,
# re-ordered evens-first, to K6 (weights crossfaded against values blended)
TOL_HALFGRID = 0.05
# staged mesh vs fused mesh kernel on the same tiles: the JAX package's
# fused-vs-staged yardsticks (tests/test_fused_mesh.py:95-97)
TOL_STAGED_POS, TOL_STAGED_UV = 2e-2, 1e-6

# device-side queries, heights in m: the card against the same torch ops on
# the CPU (both f32; libm's log2 in the blend ratio and the f32 face uv at
# 6.4e6 m are what can differ), and against the f64 host sampling API point
# by point (the CPU parity tests measure 6.5e-5 m planar, 1.0e-3 m on a
# planet); colours in [0, 1]
TOL_QUERY = {"planar": (1e-3, 1e-2), "planet": (5e-2, 1e-1)}
TOL_QUERY_COLOR = (1e-5, 2.0 / 255.0)
QUERY_POINTS = 65536  # what one physics or placement tick asks


# the Earth scene (tools/earth_frame_bench.py, tools/make_goldens.py::mesh_spherical_case)
RADIUS, SPH_LODS, SPH_DATA_LODS, SPH_ATLAS, SPH_CAPACITY = 6.371e6, 13, 3, 512, 2048
SPH_VIEW = (0.0, 0.0, RADIUS + 60_000.0)
# spherical kernel phase cases: (model, camera altitude m). At 60 km no
# vertex is inside the precision threshold (R / 1000); at 3 km the last
# steps are high-precision and the kernel takes the Taylor near field (the
# frame then overflows its 2048 slots, which the kernel check does not mind)
SPH_CASES = (("sphere", 60_000.0), ("ellipsoid", 60_000.0), ("sphere", 3_000.0))

# one H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM bytes/s and
# f32 operations/s outside the tensor cores
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
QUAD_BYTES = 32 * 128 * 4
GV2 = 17 * 17
# f32 operations counted from csrc/mesh_fused.cu (a sqrt, a division, a
# log2 or an exp2 counted as one): per live tile the 33x33 tent resample
# (40 each) and the two 1-2-1 passes (5 each); per vertex the shared morph,
# window and blend chain (120) plus the planar distance and position (52),
# or the two cube-sphere evaluations, the world distance and the outputs
# (132, +38 with the ellipsoid's normal-matrix path), plus the two Taylor
# chains and the near-field distance on high-precision steps (121)
OPS_TILE = 33 * 33 * 40 + 2 * 33 * 33 * 5
OPS_VERTEX = {"planar": 172, "sphere": 252, "ellipsoid": 290}
OPS_VERTEX_HP = 121
# material kernels, counted from csrc/mesh_fused.cu and csrc/attach_sample.cu
# the same way: per live tile and channel, the unpack and resample of the
# 33x33 half-grid (27 each) and, on the exact path, the integer channel sum
# (3 per texel); per vertex and channel, the 3x3 window (29); per vertex,
# the samplers' window weights (22) and the shade's normal, view and
# ambient terms (60) plus per light its BRDF (110; point +25, spot +35)
OPS_ALB_HALF = 33 * 33 * 27
OPS_ALB_SUM = 64 * 64 * 3
OPS_ALB_VERTEX = 29
OPS_ATTACH_VERTEX = 22
OPS_SHADE_VERTEX = 60
OPS_SHADE_LIGHT = {"dir": 110, "point": 135, "spot": 145}
# half-grid kernels, counted from csrc/fetch_resample.cu the same way. K6 per
# live tile: the 33x33 tent resample (40 each), the two blend passes (a
# 1-2-1 tap and the crossfade, 8 each), the mean back and x valid (2). K7
# per tile: 2 x 33 x 64 crossfaded weights (three clipped tents, their 1-2-1
# form and the crossfade: 32 each), then a multiply and an add per texel of
# each weight row's support in the two contractions (counted from this
# run's geometry: k7_support), x valid
OPS_K6_TILE = 33 * 33 * (40 + 8 + 8 + 2)
OPS_K7_WEIGHTS = 2 * 33 * 64 * 32


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float) -> dict:
    """The least time for ``nbytes`` moved and ``ops`` f32 operations."""
    bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    print(f"  bound: {nbytes / 1e6:.2f} MB -> {bytes_ms:.4f} ms, {ops / 1e9:.3f} GFLOP "
          f"-> {ops_ms:.4f} ms")
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def tensor_bytes(*tensors) -> int:
    import torch

    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def mesh_bound(args, n_unique: int, channels: int, live: int, live_hp: int,
               kind: str) -> dict:
    """The least time the card could take for one mesh kernel call on these
    inputs: each input read once (the frame's unique quads, not the whole
    atlas, and the per-tile and frame arrays), each output written once
    (all Fp rows, dead ones as zeros), against the f32 operations that the
    live tiles need."""
    nbytes = (n_unique * QUAD_BYTES + tensor_bytes(*args[1:])
              + args[1].shape[0] * channels * GV2 * 4)
    ops = live * (OPS_TILE + GV2 * OPS_VERTEX[kind]) + live_hp * GV2 * OPS_VERTEX_HP
    return bound(nbytes, ops)


_SHA_MEMO: dict = {}


def tensor_sha(x) -> str:
    """sha256 of a tensor's dtype, shape and bytes (of a plain argument's
    repr). A tensor is hashed once while the memo holds it; each phase
    clears the memo when it frees its tensors."""
    import torch

    if not isinstance(x, torch.Tensor):
        return hashlib.sha256(repr(x).encode()).hexdigest()
    key = (x.data_ptr(), tuple(x.shape), x.dtype, x._version)
    if key not in _SHA_MEMO:
        h = hashlib.sha256(f"{x.dtype} {tuple(x.shape)}".encode())
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
        _SHA_MEMO[key] = (h.hexdigest(), x)  # the reference keeps the address taken
    return _SHA_MEMO[key][0]


def digest(label: str, inputs, output) -> None:
    """Print the sha256 of a kernel call's inputs (a digest of their
    digests) and of its output: two builds on the same inputs are compared
    by these lines, bit for bit."""
    h = hashlib.sha256()
    for x in inputs:
        h.update(tensor_sha(x).encode())
    print(f"digest: {label}: inputs {h.hexdigest()} output {tensor_sha(output)}")


def compare(got, want, what: str) -> float:
    """Max |got - want| over heights+positions, with the uv channels held to
    their own tolerance; raises if either is over. Returns the former."""
    err = (got - want).abs()
    pos = float(err[:, :4].max())
    uv = float(err[:, 4:].max())
    print(f"{what}: max |kernel - plain| heights/positions {pos:.3e} m, uvs {uv:.3e}")
    if not (pos <= TOL_POS and uv <= TOL_UV):
        raise AssertionError(f"{what}: kernel disagrees with the plain version "
                             f"({pos} > {TOL_POS} or {uv} > {TOL_UV})")
    return pos


def compare_spherical(got, want, what: str) -> float:
    """Spherical channels held to their tolerances; returns the max
    |kernel - plain| over heights and positions (m)."""
    err = (got - want).abs()
    errs = {"heights": float(err[:, 0].max()), "positions": float(err[:, 1:4].max()),
            "uvs": float(err[:, 4:6].max()), "normals": float(err[:, 6:9].max())}
    tols = {"heights": TOL_SPH_H, "positions": TOL_SPH_POS, "uvs": TOL_SPH_UV,
            "normals": TOL_SPH_N}
    print(f"{what}: max |kernel - plain| " + ", ".join(
        f"{k} {v:.3e} (tol {tols[k]:.0e})" for k, v in errs.items()))
    over = [k for k in errs if not errs[k] <= tols[k]]
    if over:
        raise AssertionError(f"{what}: kernel disagrees with the plain version on {over}")
    return max(errs["heights"], errs["positions"])


def kernel_phase(results: dict) -> None:
    import numpy as np
    import torch

    from bevy_terrain_tpu_torch.ops import kernels, meshgen, refinement
    from bevy_terrain_tpu_torch.ops.params import unpack_frame_uniforms

    cfg, vc, blob, plan, rng = bench_frame()
    n_blocks = 1024 * plan.total_blocks_per_slot
    t0 = time.perf_counter()
    blocks = torch.from_numpy(
        rng.integers(0, 65535, (n_blocks, 32, 128)).astype(np.int32)).cuda()
    print(f"kernel phase: block array {tuple(blocks.shape)} int32 "
          f"({blocks.numel() * 4 / 2**30:.2f} GiB) on the card in "
          f"{time.perf_counter() - t0:.1f} s")

    def plan_frame(device, block_array):
        u = unpack_frame_uniforms(torch.from_numpy(blob).to(device), 1, LOD_COUNT,
                                  vc.tree_size)
        tiles = refinement.refine_tiles(u, cfg)
        return meshgen.fused_kernel_args(tiles, block_array, u, cfg, plan, 65535.0)

    tiles, batch, args = plan_frame("cuda", blocks)
    ctiles, cbatch, _ = plan_frame("cpu", torch.empty((n_blocks, 32, 128), dtype=torch.int32))
    n = int(tiles.tile_count)
    for field in ("tile_side", "tile_lod", "tile_xy", "tile_count", "overflow"):
        if not torch.equal(getattr(tiles, field).cpu(), getattr(ctiles, field)):
            raise AssertionError(f"refinement on the card differs from the CPU: {field}")
    if not torch.equal(batch.ids.cpu(), cbatch.ids):
        raise AssertionError("patch plan on the card differs from the CPU: ids")
    geom_err = float((batch.geom.cpu() - cbatch.geom).abs().max())
    print(f"kernel phase: {n} tiles (capacity {cfg.tile_capacity}), overflow "
          f"{int(tiles.overflow)}, {int(batch.n_unique)} unique quads; tile list equals "
          f"the CPU's, patch geometry within {geom_err:.1e}")
    if n == 0 or int(tiles.overflow) != 0:
        raise AssertionError("kernel phase frame is empty or overflows")

    got = kernels.mesh_fused_planar(*args)
    torch.cuda.synchronize()
    digest("mesh_fused_planar (bench frame)", args, got)
    want = kernels.mesh_fused_planar_reference(*args)
    err = compare(got, want, "mesh_fused_planar")

    # timings: back to back on the device (the frame's quads stay in the
    # 50 MB L2), and with L2 flushed before each launch (a 256 MB write)
    ms = device_ms(lambda: kernels.mesh_fused_planar(*args))
    plain_ms = device_ms(lambda: kernels.mesh_fused_planar_reference(*args))
    flushed_ms = cold_ms(lambda: kernels.mesh_fused_planar(*args))
    frame_ms = cuda_ms(lambda: plan_frame("cuda", blocks), n=20)
    print(f"kernel phase: mesh_fused_planar {ms:.4f} ms (device, L2 warm), {flushed_ms:.4f} ms "
          f"(L2 flushed); plain PyTorch version {plain_ms:.4f} ms (device); "
          f"refine + patch plan {frame_ms:.4f} ms (CUDA events, stream span)")
    bound = mesh_bound(args, int(batch.n_unique), kernels.OUT_CH, n, 0, "planar")
    results["mesh_fused_planar"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound,
                                        library_ms=None)
    if hasattr(kernels, "MESH_WAVES"):  # not in the trees before it
        waves_sweep({"mesh_fused_planar, bench frame": (
            "MESH_WAVES", "mesh_fused_planar", kernels.mesh_fused_planar, args)}, n)
    del blocks, args, got, want
    _SHA_MEMO.clear()
    torch.cuda.empty_cache()


# -- spherical kernel phase ---------------------------------------------------


def sphere_model(kind: str):
    """The Earth sphere, or the WGS84-like ellipsoid of models.earth_ellipsoid."""
    import numpy as np

    from bevy_terrain_tpu_torch.math import TerrainModel

    if kind == "sphere":
        return TerrainModel.sphere(np.zeros(3), RADIUS, 0.0, 9000.0)
    return TerrainModel.ellipsoid(np.zeros(3), 6_378_137.0, 6_356_752.3, -11_000.0, 9000.0)


def sphere_view(model, altitude: float = 60_000.0):
    """(camera at ``altitude`` above the surface point under SPH_VIEW, its
    60-degree view-projection toward the planet's centre)."""
    import numpy as np

    from bevy_terrain_tpu_torch.math import frustum

    view = model.surface_position(np.array(SPH_VIEW), altitude)
    return view, frustum.view_projection(view, view * 0.5, np.pi / 3, 16 / 9)


def tie_flips(card_nodes: set, cpu_nodes: set, uniforms, cfg) -> tuple[int, float]:
    """Where the card's and the CPU's tile lists differ, every difference
    must be a flipped subdivision of a tile whose subdivision margin sits in
    the planet-scale f32 envelope (|d / t - 1| < 5e-3, the JAX package's
    test_goldens.py tie check), or a child of one. Returns (differing
    nodes, largest margin); raises on a structural difference."""
    import torch

    from bevy_terrain_tpu_torch.ops import coords

    def children(n):
        s, lod, x, y = n
        return {(s, lod + 1, 2 * x + dx, 2 * y + dy) for dx in (0, 1) for dy in (0, 1)}

    diff = card_nodes ^ cpu_nodes
    flipped = []
    for n in sorted(diff):
        other = cpu_nodes if n in card_nodes else card_nodes
        if children(n) <= other:
            flipped.append(n)
    for n in sorted(diff):
        s, lod, x, y = n
        if n not in flipped and (s, lod - 1, x // 2, y // 2) not in flipped:
            raise AssertionError(f"card and CPU tile lists differ structurally at {n}")
    margin = 0.0
    if flipped:
        t = torch.tensor(flipped, dtype=torch.int32)
        side, lod, xy = t[:, 0], t[:, 1], t[:, 2:4].contiguous()
        uv = coords.compute_subdivision_coordinate(side, lod, xy, uniforms.taylor,
                                                   cfg.origin_lod, cfg.side_count)
        dist = coords.approximate_view_distance(side, lod, xy, uv, uniforms, cfg)
        thresh = uniforms.subdivision_distance / coords.tile_count(lod)
        margin = float((dist.double() / thresh.double() - 1.0).abs().max())
        if margin >= 5e-3:
            raise AssertionError(f"a card/CPU tile flip is not a threshold tie ({margin})")
    return len(diff), margin


def sphere_kernel_phase(results: dict) -> None:
    import numpy as np
    import torch

    from bevy_terrain_tpu_torch.config import TerrainViewConfig
    from bevy_terrain_tpu_torch.math import TerrainModelApproximation
    from bevy_terrain_tpu_torch.ops import kernels, meshgen, patch_sampling, refinement
    from bevy_terrain_tpu_torch.ops import tile_tree
    from bevy_terrain_tpu_torch.ops.params import (
        StaticTerrainConfig, pack_frame_uniforms, unpack_frame_uniforms,
    )

    vc = TerrainViewConfig(tile_capacity=SPH_CAPACITY)
    plan = patch_sampling.make_patch_plan(TEXTURE_SIZE, 4, BORDER)
    n_blocks = SPH_ATLAS * plan.total_blocks_per_slot
    rng = np.random.default_rng(1)
    blocks = torch.from_numpy(
        rng.integers(0, 65535, (n_blocks, 32, 128)).astype(np.int32)).cuda()
    # the spherical material kernel phase's albedo: 512 slots of random
    # packed Rgba8 words with the height's plan (default_rng(8))
    albedo = torch.from_numpy(np.random.default_rng(8).integers(
        0, 1 << 32, (n_blocks, 32, 128), dtype=np.uint32).view(np.int32)).cuda()
    combined = torch.cat([blocks, albedo], dim=1)
    errs, alb_errs = [], []
    for kind, altitude in SPH_CASES:
        what = f"{kind} at {altitude / 1e3:g} km"
        model = sphere_model(kind)
        view, view_proj = sphere_view(model, altitude)
        cfg = StaticTerrainConfig(
            spherical=True, side_count=6, lod_count=SPH_LODS, tree_size=vc.tree_size,
            grid_size=vc.grid_size, refinement_count=vc.refinement_count,
            queue_capacity=2048, tile_capacity=SPH_CAPACITY, origin_lod=vc.origin_lod,
            high_precision=True, ellipsoidal=kind == "ellipsoid", culling=True,
        )
        origins, vt_int, vt_frac = tile_tree.compute_view_anchors(model, view, SPH_LODS,
                                                                  vc.tree_size)
        approx = TerrainModelApproximation.compute(model, view, vc.origin_lod, 4500.0)
        # fully streamed state over 3 data lods (test_fused_mesh.py:124-126)
        entries = np.zeros((6, SPH_LODS, vc.tree_size, vc.tree_size, 2), np.int32)
        entries[..., 0] = rng.integers(0, SPH_ATLAS, entries.shape[:-1])
        entries[..., 1] = np.minimum(np.arange(SPH_LODS), SPH_DATA_LODS - 1)[None, :, None, None]
        blob = pack_frame_uniforms(model, view, approx, origins, entries, vt_int, vt_frac, vc,
                                   view_proj=view_proj)

        def plan_frame(device, block_array, blob=blob, cfg=cfg):
            u = unpack_frame_uniforms(torch.from_numpy(blob).to(device), 6, SPH_LODS,
                                      vc.tree_size)
            tiles = refinement.refine_tiles(u, cfg)
            return (u, *meshgen.fused_kernel_args(tiles, block_array, u, cfg, plan,
                                                  65535.0))

        u, tiles, batch, args = plan_frame("cuda", blocks)
        cu, ctiles, cbatch, _ = plan_frame(
            "cpu", torch.empty((n_blocks, 32, 128), dtype=torch.int32))
        n, cn = int(tiles.tile_count), int(ctiles.tile_count)

        def nodes(t, count):
            return {tuple(r) for r in torch.stack(
                [t.tile_side[:count], t.tile_lod[:count], t.tile_xy[:count, 0],
                 t.tile_xy[:count, 1]], dim=-1).cpu().tolist()}

        n_diff, margin = tie_flips(nodes(tiles, n), nodes(ctiles, cn), cu, cfg)
        same_plan = n_diff == 0 and torch.equal(batch.ids.cpu(), cbatch.ids)
        if n_diff == 0 and not same_plan:
            raise AssertionError(f"{what}: patch plan on the card differs from the CPU")
        live_hp = int(((args[5] == 2).repeat_interleave(kernels.TILES_PER_STEP)
                       & (torch.arange(args[1].shape[0], device="cuda") < n)).sum())
        print(f"sphere kernel phase ({what}): {n} tiles (capacity {SPH_CAPACITY}; CPU {cn}), "
              f"overflow {int(tiles.overflow)}, {int(batch.n_unique)} unique quads, "
              f"{live_hp} tiles on high-precision steps; {n_diff} nodes differ from the "
              f"CPU's (threshold ties, largest margin {margin:.2e}); patch plan "
              f"{'equals' if same_plan else 'follows'} the CPU's")
        if n <= 100 or (altitude == SPH_CASES[0][1] and int(tiles.overflow) != 0):
            raise AssertionError(f"{what}: spherical kernel phase frame is small or overflows")
        if altitude < SPH_CASES[0][1] and live_hp == 0:
            raise AssertionError(f"{what}: no high-precision step")

        got = kernels.mesh_fused_spherical(*args)
        torch.cuda.synchronize()
        digest(f"mesh_fused_spherical ({what})", args, got)
        want = kernels.mesh_fused_spherical_reference(*args)
        errs.append(compare_spherical(got, want, f"mesh_fused_spherical ({what})"))
        norm = torch.linalg.vector_norm(got[:n, 6:9].double(), dim=1)
        if float((norm - 1.0).abs().max()) > TOL_UNIT:
            raise AssertionError(f"{what}: kernel normals are not unit length")
        if got[n:].any():
            raise AssertionError(f"{what}: tiles past tile_count are not zero")

        ms = device_ms(lambda: kernels.mesh_fused_spherical(*args))
        plain_ms = device_ms(lambda: kernels.mesh_fused_spherical_reference(*args))
        flushed_ms = cold_ms(lambda: kernels.mesh_fused_spherical(*args))
        frame_ms = cuda_ms(lambda: plan_frame("cuda", blocks), n=10)
        print(f"sphere kernel phase ({what}): mesh_fused_spherical {ms:.4f} ms (device, L2 "
              f"warm), {flushed_ms:.4f} ms (L2 flushed); plain PyTorch version "
              f"{plain_ms:.4f} ms (device); unpack + refine + patch plan {frame_ms:.4f} ms "
              f"(CUDA events, stream span)")
        bound = mesh_bound(args, int(batch.n_unique), kernels.SPH_CH, n, live_hp, kind)
        if (kind, altitude) == SPH_CASES[0]:
            results["mesh_fused_spherical"] = dict(ms=ms, plain_ms=plain_ms, **bound,
                                                   library_ms=None)
            if hasattr(kernels, "MESH_WAVES"):  # not in the trees before it
                waves_sweep({f"mesh_fused_spherical, {what}": (
                    "MESH_WAVES", "mesh_fused_spherical (sphere)", kernels.mesh_fused_spherical,
                    args)}, n)
        row, err = sphere_albedo_case(what, kind, args, got, albedo, combined, u, tiles, batch,
                                      cfg, plan, n, live_hp)
        alb_errs.append(err)
        if (kind, altitude) == SPH_CASES[0]:
            results["mesh_fused_spherical_albedo"] = row
        del args, got, want
    results["mesh_fused_spherical"]["max_abs_err"] = max(errs)
    results["mesh_fused_spherical_albedo"]["max_abs_err"] = max(alb_errs)
    del blocks, albedo, combined
    _SHA_MEMO.clear()
    torch.cuda.empty_cache()


def sphere_albedo_case(what, kind, args, k2, albedo, combined, u, tiles, batch, cfg, plan,
                       n: int, live_hp: int):
    """The spherical material kernel phase on one Earth frame: K3s (fast,
    exact, opaque, combined blocks) against its plain version on the
    spherical kernel phase's inputs ``args`` and a random packed Rgba8
    albedo; its mesh channels against K2's output ``k2``; its colours
    against the packed sampler (K5b) at the kernel's own morphed uvs; timed
    and bounded. Returns (the fast form's result row, the largest colour
    gap to the plain version over the forms, of full scale)."""
    import torch

    from bevy_terrain_tpu_torch.ops import kernels, patch_sampling

    wrapper, plain = (kernels.mesh_fused_spherical_albedo,
                      kernels.mesh_fused_spherical_albedo_reference)
    n_unique, Fp, C0 = int(batch.n_unique), args[1].shape[0], kernels.SPH_CH
    # K5b at the attachment plan (the frame's row order) and K2's morphed uvs
    _, abatch = patch_sampling.plan_patch_batch(tiles, u, cfg, plan, albedo.shape[0],
                                                assume_sorted=True)
    geom = abatch.geom.clone()
    geom[:, 4] = 0.0
    sargs = (albedo, abatch.ids, geom, k2[:, 4:6].contiguous(), args[6], 4, 8)
    sampled = kernels.attach_sample_fused_packed(*sargs)
    digest(f"attach_sample_fused_packed ({what}, at K2's uvs)", sargs, sampled)
    # (args, channels, fast)
    forms = {
        "fast": ((*args, albedo, 4, 8, True, False), 4, True),
        "exact": ((*args, albedo, 4, 8, False, False), 4, False),
        "opaque": ((*args, albedo, 3, 8, True, False), 3, True),
        "combined": ((combined, *args[1:], None, 4, 8, True, True), 4, True),
    }
    worst, row = 0.0, None
    for form, (fargs, channels, fast) in forms.items():
        got = wrapper(*fargs)
        torch.cuda.synchronize()
        digest(f"mesh_fused_spherical_albedo ({what}, {form})", fargs, got)
        want = plain(*fargs)
        if got.shape != (Fp, C0 + channels, 17, 17) or not torch.equal(got[:, :C0], k2):
            raise AssertionError(f"{what} ({form}): the mesh channels differ from "
                                 f"mesh_fused_spherical's")
        err = float((got[:, C0:] - want[:, C0:]).abs().max()) / 255.0
        gap = float((got[:, C0:] - sampled[:, :channels]).abs().max()) / 255.0
        tol = TOL_ALB_FAST if fast else TOL_ALB_EXACT
        if not (err <= tol and gap <= tol and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{what} ({form}): colours off the plain version ({err}) or "
                                 f"the packed sampler ({gap}), tol {tol}")
        if got[n:].any() or not got[:n, C0:].any():
            raise AssertionError(f"{what} ({form}): dead tiles not zero, or no colour")
        ms = device_ms(lambda: wrapper(*fargs))
        flushed_ms = cold_ms(lambda: wrapper(*fargs))
        plain_ms = device_ms(lambda: plain(*fargs), n=5)
        print(f"mesh_fused_spherical_albedo ({what}, {form}): max |kernel - plain| {err:.3e} "
              f"of full scale (tol {tol:.1e}), vs attach_sample_fused_packed at the kernel's "
              f"uvs {gap:.3e}; mesh channels equal mesh_fused_spherical's; {ms:.4f} ms "
              f"(device, L2 warm), {flushed_ms:.4f} ms (L2 flushed); plain PyTorch version "
              f"{plain_ms:.4f} ms (device)")
        # unique height and albedo quads, the per-tile and frame arrays,
        # the output; K2's operations plus the albedo's
        nbytes = (2 * n_unique * QUAD_BYTES + tensor_bytes(*args[1:7])
                  + Fp * (C0 + channels) * GV2 * 4)
        ops = (n * (OPS_TILE + GV2 * OPS_VERTEX[kind]) + live_hp * GV2 * OPS_VERTEX_HP
               + n * channels * (OPS_ALB_HALF + (0 if fast else OPS_ALB_SUM)
                                 + GV2 * OPS_ALB_VERTEX))
        b = bound(nbytes, ops)
        worst = max(worst, err)
        if form == "fast":  # meshgen.generate_mesh_fused's default
            row = dict(ms=ms, plain_ms=plain_ms, **b, library_ms=None)
        del got, want
    return row, worst


# -- material kernel phase ----------------------------------------------------


def smoke_material(material_module, **kw):
    """The smoke runs' StandardMaterial: the albedo attachment under a
    directional, a point and a spot light over the bench frame's terrain."""
    m = material_module
    return m.StandardMaterial(
        base_color=m.albedo_material(1), perceptual_roughness=0.6, metallic=0.2,
        reflectance=0.4,
        lights=(
            m.DirectionalLight(direction=(-0.3, -0.8, -0.5), color=(1.0, 0.9, 0.8),
                               illuminance=0.9),
            m.PointLight(position=(400.0, 300.0, -100.0), range=3000.0, intensity=0.5),
            m.SpotLight(position=(240.0, 400.0, -160.0), direction=(0.3, -1.0, 0.1),
                        range=4000.0, intensity=0.7, inner_angle=0.3, outer_angle=0.7),
        ), **kw)


def material_kernel_phase(results: dict) -> None:
    """K3, K4 and K5 at the bench.py frame, on its random height blocks and a
    1024-slot random packed Rgba8 albedo of the same plan (default_rng(7):
    uniform 32-bit words, four uniform bytes)."""
    import numpy as np
    import torch

    from bevy_terrain_tpu_torch.ops import kernels, meshgen, patch_sampling, refinement
    from bevy_terrain_tpu_torch.ops.params import unpack_frame_uniforms
    from bevy_terrain_tpu_torch.render import material

    cfg, vc, blob, plan, rng = bench_frame()
    n_blocks = 1024 * plan.total_blocks_per_slot
    t0 = time.perf_counter()
    blocks = torch.from_numpy(
        rng.integers(0, 65535, (n_blocks, 32, 128)).astype(np.int32)).cuda()
    albedo = torch.from_numpy(np.random.default_rng(7).integers(
        0, 1 << 32, (n_blocks, 32, 128), dtype=np.uint32).view(np.int32)).cuda()
    combined = torch.cat([blocks, albedo], dim=1)
    print(f"material kernel phase: height, packed Rgba8 albedo and combined (N, 64, 128) "
          f"block arrays on the card in {time.perf_counter() - t0:.1f} s")
    u = unpack_frame_uniforms(torch.from_numpy(blob).cuda(), 1, LOD_COUNT, vc.tree_size)
    tiles, batch, base = meshgen.fused_kernel_args(refinement.refine_tiles(u, cfg), blocks, u,
                                                   cfg, plan, 65535.0)
    n, n_unique, Fp = int(tiles.tile_count), int(batch.n_unique), base[1].shape[0]
    k1 = kernels.mesh_fused_planar(*base)
    smat = smoke_material(material)
    spec = material.kernel_shade_spec(smat, 255.0)
    shade = kernels.pack_shade_spec(spec, "cuda")
    light_ops = sum(OPS_SHADE_LIGHT[light[0]] for light in spec[5])
    print(f"material kernel phase: {n} tiles, {n_unique} unique quads; material "
          f"{len(spec[5])} lights")

    # (wrapper, plain version, args, channels, fast, shaded)
    k3 = kernels.mesh_fused_albedo, kernels.mesh_fused_albedo_reference
    k4 = kernels.mesh_fused_shaded, kernels.mesh_fused_shaded_reference
    forms = {
        "albedo fast": (*k3, (*base, albedo, 4, 8, True, False), 4, True, False),
        "albedo exact": (*k3, (*base, albedo, 4, 8, False, False), 4, False, False),
        "albedo opaque": (*k3, (*base, albedo, 3, 8, True, False), 3, True, False),
        "albedo combined": (*k3, (combined, *base[1:], None, 4, 8, True, True), 4, True, False),
        "shaded fast": (*k4, (*base, albedo, 4, 8, shade, True, False), 4, True, True),
        "shaded exact": (*k4, (*base, albedo, 4, 8, shade, False, False), 4, False, True),
    }
    errs: dict = {}
    plain_albedo = {}  # fast -> the plain version's raw albedo rows
    valid_live = (base[2][:, 3] * base[3][:, 0]).view(-1, 1, 1, 1)
    for what, (wrapper, plain, args, channels, fast, shaded) in forms.items():
        got = wrapper(*args)
        torch.cuda.synchronize()
        digest(f"{wrapper.__name__} ({what})", args, got)
        want = plain(*args)
        if not torch.equal(got[:, :kernels.OUT_CH], k1):
            raise AssertionError(f"{what}: the mesh rows differ from mesh_fused_planar's")
        scale = 1.0 if shaded else 255.0
        err = float((got[:, kernels.OUT_CH:] - want[:, kernels.OUT_CH:]).abs().max()) / scale
        tol = TOL_ALB_FAST if fast else TOL_SHADED_EXACT if shaded else TOL_ALB_EXACT
        detail = ""
        if shaded:
            # the shade phase alone: the plain shade of the plain albedo on
            # the kernel's own mesh rows (the plain version's heights differ
            # from the kernel's by the resample's summation order, which
            # the normals of the finest tiles amplify)
            ref = torch.stack(kernels.pbr_shade_reference(
                shade, list(plain_albedo[fast].unbind(1)), got[:, 0], got[:, 1], got[:, 2],
                got[:, 3], base[4], base[3][:, 1].view(-1, 1, 1)), dim=1) * valid_live
            ref[n:] = 0.0
            own = float((got[:, kernels.OUT_CH:] - ref).abs().max())
            detail = (f"; on the kernel's own mesh rows {own:.3e} (tol "
                      f"{TOL_SHADE_EXACT:.0e})")
            if not own <= TOL_SHADE_EXACT:
                raise AssertionError(f"{what}: the shade disagrees with the plain version on "
                                     f"the kernel's mesh rows ({own} > {TOL_SHADE_EXACT})")
        else:
            plain_albedo.setdefault(fast, want[:, kernels.OUT_CH:])
        if not (err <= tol and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{what}: kernel disagrees with the plain version ({err} > "
                                 f"{tol})")
        if got[n:].any():
            raise AssertionError(f"{what}: tiles past tile_count are not zero")
        ms = device_ms(lambda: wrapper(*args))
        flushed_ms = cold_ms(lambda: wrapper(*args))
        plain_ms = device_ms(lambda: plain(*args))
        print(f"{wrapper.__name__} ({what}): max |kernel - plain| {err:.3e} of full scale "
              f"(tol {tol:.1e}){detail}; mesh rows equal mesh_fused_planar's; {ms:.4f} ms (device, "
              f"L2 warm), {flushed_ms:.4f} ms (L2 flushed); plain PyTorch version "
              f"{plain_ms:.4f} ms (device)")
        # unique height and albedo quads, the per-tile and frame arrays,
        # the output; the mesh ops plus the albedo's and the shade's
        nbytes = (2 * n_unique * QUAD_BYTES + tensor_bytes(*args[1:6])
                  + (tensor_bytes(shade) if shaded else 0)
                  + Fp * (kernels.OUT_CH + channels) * GV2 * 4)
        ops = (n * (OPS_TILE + GV2 * OPS_VERTEX["planar"])
               + n * channels * (OPS_ALB_HALF + (0 if fast else OPS_ALB_SUM)
                                 + GV2 * OPS_ALB_VERTEX)
               + (n * GV2 * (OPS_SHADE_VERTEX + light_ops) if shaded else 0))
        row = dict(ms=ms, plain_ms=plain_ms, **bound(nbytes, ops), library_ms=None)
        name = wrapper.__name__
        errs[name] = max(errs.get(name, 0.0), err)
        # the main path's forms (meshgen.generate_mesh_fused's default fast albedo)
        if what in ("albedo fast", "shaded fast"):
            results[name] = row
        del got, want

    del plain_albedo
    # the samplers at the attachment plan (the frame's row order) and the
    # kernel's own morphed uvs, crossfade column zero
    _, abatch = patch_sampling.plan_patch_batch(tiles, u, cfg, plan, n_blocks,
                                                assume_sorted=True)
    geom = abatch.geom.clone()
    geom[:, 4] = 0.0
    uvs = k1[:, 4:6].contiguous()
    call = (abatch.ids, geom, uvs, base[5])
    samplers = {
        "Rgba8": (kernels.attach_sample_fused_packed, kernels.attach_sample_fused_packed_reference,
                  (albedo, *call, 4, 8), 4, 255.0),
        "Rg16": (kernels.attach_sample_fused_packed, kernels.attach_sample_fused_packed_reference,
                 (albedo, *call, 2, 16), 2, 65535.0),
        "height": (kernels.attach_sample_fused, kernels.attach_sample_fused_reference,
                   (blocks, *call), 1, 65535.0),
    }
    for what, (wrapper, plain, args, channels, full) in samplers.items():
        got = wrapper(*args)
        torch.cuda.synchronize()
        digest(f"{wrapper.__name__} ({what})", args, got)
        want = plain(*args)
        err = float((got - want).abs().max()) / full
        if not (err <= TOL_ALB_EXACT and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{wrapper.__name__} ({what}): kernel disagrees with the "
                                 f"plain version ({err} > {TOL_ALB_EXACT})")
        if got[n:].any():
            raise AssertionError(f"{what}: tiles past tile_count are not zero")
        ms = device_ms(lambda: wrapper(*args))
        flushed_ms = cold_ms(lambda: wrapper(*args))
        plain_ms = device_ms(lambda: plain(*args))
        print(f"{wrapper.__name__} ({what}): max |kernel - plain| {err:.3e} of full scale "
              f"(tol {TOL_ALB_EXACT:.0e}); {ms:.4f} ms (device, L2 warm), {flushed_ms:.4f} ms "
              f"(L2 flushed); plain PyTorch version {plain_ms:.4f} ms (device)")
        nbytes = (n_unique * QUAD_BYTES + tensor_bytes(*args[1:5])
                  + Fp * channels * GV2 * 4)
        ops = n * (channels * (OPS_ALB_HALF + OPS_ALB_SUM + GV2 * OPS_ALB_VERTEX)
                   + GV2 * OPS_ATTACH_VERTEX)
        row = dict(ms=ms, plain_ms=plain_ms, **bound(nbytes, ops), library_ms=None)
        name = wrapper.__name__
        errs[name] = max(errs.get(name, 0.0), err)
        if what in ("Rgba8", "height"):
            results[name] = row
        del got, want
    if hasattr(kernels, "MATERIAL_WAVES"):  # not in the trees before it
        waves_sweep({
            "mesh_fused_shaded, shaded fast": ("MATERIAL_WAVES", "mesh_fused_shaded",
                                               *forms["shaded fast"][:3:2]),
            "mesh_fused_albedo, albedo fast": ("MATERIAL_WAVES", "mesh_fused_albedo",
                                               *forms["albedo fast"][:3:2]),
            "attach_sample_fused_packed, Rgba8": ("SAMPLER_WAVES", "attach_sample_fused[_packed]",
                                                  *samplers["Rgba8"][:3:2]),
            "attach_sample_fused, height": ("SAMPLER_WAVES", "attach_sample_fused[_packed]",
                                            *samplers["height"][:3:2]),
        }, n)
    for name, err in errs.items():
        results[name]["max_abs_err"] = err
    del blocks, albedo, combined, base, k1
    _SHA_MEMO.clear()
    torch.cuda.empty_cache()


def waves_sweep(runs: dict, live: int) -> None:
    """Each run-of-tiles kernel (name: (the kernels module's waves constant,
    the kernel instance's name in ``kernel_occupancy()``, wrapper, args)) on
    grids of 1, 2, 4 and 8 waves of the blocks the card holds at once, in
    turns (1 2 4 8 8 4 2 1; device time, L2 warm), its output bit-equal at
    each; the constant is restored after. ``live`` tiles split over the grid
    give the tiles per block."""
    import torch

    from bevy_terrain_tpu_torch.ops import kernels

    occupancy = {r["name"]: r["blocks_per_sm"] for r in kernels.kernel_occupancy()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for what, (attr, instance, wrapper, args) in runs.items():
        per_wave = sms * occupancy[instance]
        saved = getattr(kernels, attr)
        base = wrapper(*args)
        times: dict = {}
        try:
            for w in (1, 2, 4, 8, 8, 4, 2, 1):
                setattr(kernels, attr, w)
                if not torch.equal(wrapper(*args), base):
                    raise AssertionError(f"{what}: {w} waves change the output")
                times.setdefault(w, []).append(device_ms(lambda: wrapper(*args)))
        finally:
            setattr(kernels, attr, saved)
        print(f"waves ({what}; in use {saved}; {per_wave} blocks a wave): " + ", ".join(
            f"{w} ({live / (w * per_wave):.2f} tiles a block): {a:.4f} / {b:.4f} ms"
            for w, (a, b) in sorted(times.items())))


# -- half-grid kernel phase ------------------------------------------------------


def k7_support(geom):
    """The texels under the 33 crossfaded weight rows of each axis, summed
    over rows and tiles: (x, y). Row k's support spans the texels under the
    tent centres of rows k - 1 .. k + 1 (kernels.fetch_resample_support, the
    mirror of csrc/fetch_resample.cu's supports)."""
    from bevy_terrain_tpu_torch.ops import kernels

    lo, hi, _ = kernels.fetch_resample_support(geom)
    x, y = (hi - lo + 1).sum(dim=(0, 2)).tolist()
    return float(x), float(y)


def hold(err: float, tol: float, what: str) -> float:
    if not err <= tol:
        raise AssertionError(f"{what}: {err} > {tol}")
    return err


def halfgrid_kernel_phase(results: dict) -> None:
    """K6 and K7 against their plain versions and against each other, and
    the staged mesh against the fused mesh kernel, at the bench.py frame
    (its random height blocks); K7 also on the sweep tool's inputs."""
    import numpy as np
    import torch

    from bevy_terrain_tpu_torch.ops import kernels, meshgen, refinement
    from bevy_terrain_tpu_torch.ops import patch_sampling as ps
    from bevy_terrain_tpu_torch.ops.params import unpack_frame_uniforms

    cfg, vc, blob, plan, rng = bench_frame()
    n_blocks = 1024 * plan.total_blocks_per_slot
    blocks = torch.from_numpy(
        rng.integers(0, 65535, (n_blocks, 32, 128)).astype(np.int32)).cuda()
    u = unpack_frame_uniforms(torch.from_numpy(blob).cuda(), 1, LOD_COUNT, vc.tree_size)
    refined = refinement.refine_tiles(u, cfg)
    k6, k6_plain = kernels.fetch_resample_cached, kernels.fetch_resample_cached_reference
    k7, k7_plain = kernels.fetch_resample, kernels.fetch_resample_reference
    err6 = err7 = 0.0
    for per_vertex in (False, True):
        what = "blend per vertex" if per_vertex else "tile-centre ratio"
        tiles, batch = ps.plan_patch_batch(
            refined, u, dataclasses.replace(cfg, blend_per_vertex=per_vertex), plan, n_blocks)
        n, n_unique, Fp = int(tiles.tile_count), int(batch.n_unique), batch.ids.shape[0]
        geom = batch.geom
        args = (blocks, batch.ids, geom, tiles.tile_count.reshape(1).to(torch.int32))
        got = k6(*args)
        torch.cuda.synchronize()
        digest(f"fetch_resample_cached ({what})", args, got)
        err = float((got - k6_plain(*args)).abs().max())
        ratio_max = float(geom[:n, 4].max())
        if (ratio_max > 0.0) == per_vertex:
            raise AssertionError(f"{what}: the plan's ratio column reaches {ratio_max}")
        invalid = geom[:n, 3] == 0.0
        if got[n:].any() or got[:n][invalid].any() or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: dead or invalid tiles are not zero, or not finite")
        # K7 on the same plan, re-ordered evens-first, is K6 (K7 knows no
        # tile_count: dead rows have valid = 0 in a plan)
        ids4 = batch.ids[:, None].expand(-1, 4).contiguous()
        half7 = k7(blocks, ids4, geom)
        digest(f"fetch_resample (bench frame plan, {what})", (blocks, ids4, geom), half7)
        both = float((ps.permute_halfgrid(half7) - got).abs().max())
        # the staged functions (the half-grid of another grid size), at this one
        valid = geom[:, 3].view(-1, 1, 1)
        staged = ps.permute_halfgrid(ps.halfgrid_resample(
            ps.fetch_patches(blocks, batch.ids[:, None]), geom[:, 0:2], geom[:, 2], cfg,
            ratio=geom[:, 4]) * valid)
        staged[n:] = 0.0
        fallback = float((staged - got).abs().max())
        print(f"fetch_resample_cached ({what}): {n} tiles of {Fp}, {n_unique} unique quads, "
              f"{int(invalid.sum())} without data, ratio up to {ratio_max:.3f}, values up to "
              f"{float(got.max()):.0f}; max |kernel - plain| {err:.3e}, |permute(K7) - K6| "
              f"{both:.3e}, |staged functions - K6| {fallback:.3e} raw texel units (tol "
              f"{TOL_HALFGRID})")
        err6 = max(err6, hold(err, TOL_HALFGRID, f"K6 vs plain ({what})"))
        err7 = max(err7, hold(both, TOL_HALFGRID, f"permute(K7) vs K6 ({what})"))
        hold(fallback, TOL_HALFGRID, f"staged half-grid functions vs K6 ({what})")
        if not per_vertex:  # the staged pipeline's default blend
            ms, flushed = device_ms(lambda: k6(*args)), cold_ms(lambda: k6(*args))
            plain_ms = device_ms(lambda: k6_plain(*args))
            print(f"fetch_resample_cached: {ms:.4f} ms (device, L2 warm), {flushed:.4f} ms (L2 "
                  f"flushed); plain PyTorch version {plain_ms:.4f} ms (device)")
            nbytes = n_unique * QUAD_BYTES + tensor_bytes(*args[1:]) + Fp * 33 * 33 * 4
            results["fetch_resample_cached"] = dict(
                ms=ms, plain_ms=plain_ms, **bound(nbytes, n * OPS_K6_TILE), library_ms=None)
            waves_sweep({"fetch_resample_cached, bench frame": (
                "HALFGRID_WAVES", "fetch_resample_cached", k6, args)}, n)
        del got, staged
    results["fetch_resample_cached"]["max_abs_err"] = err6

    # the staged mesh against the fused mesh kernel on the same tiles (the
    # kernel's blend is per vertex)
    cfg_v = dataclasses.replace(cfg, blend_per_vertex=True)
    mesh, stiles = meshgen.generate_mesh_grid(refined, blocks, u, cfg_v, plan, 65535.0)
    raw, ftiles = meshgen.generate_mesh_fused(refined, blocks, u, cfg_v, plan, 65535.0)
    fused = meshgen.fused_to_grid(raw, ftiles, cfg_v)
    for field in ("tile_side", "tile_lod", "tile_xy", "tile_count"):
        if not torch.equal(getattr(stiles, field), getattr(ftiles, field)):
            raise AssertionError(f"staged and fused tile lists differ: {field}")
    gaps = {f: float((getattr(mesh, f) - getattr(fused, f)).abs().max())
            for f in ("heights", "positions", "uvs")}
    print("staged mesh vs fused mesh kernel (bench frame, blend per vertex): max |staged - "
          "fused| " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + f" (tol {TOL_STAGED_POS} m, uvs {TOL_STAGED_UV})")
    hold(max(gaps["heights"], gaps["positions"]), TOL_STAGED_POS, "staged vs fused mesh")
    hold(gaps["uvs"], TOL_STAGED_UV, "staged vs fused uvs")
    del blocks, mesh, raw, fused, half7
    _SHA_MEMO.clear()
    torch.cuda.empty_cache()

    # K7 on the sweep tool's inputs
    sblocks, sids, sgeom = sweep_inputs()
    got = k7(sblocks, sids, sgeom)
    torch.cuda.synchronize()
    digest("fetch_resample (sweep inputs)", (sblocks, sids, sgeom), got)
    err = float((got - k7_plain(sblocks, sids, sgeom)).abs().max())
    n_unique = int(torch.unique(sids[:, 0]).numel())
    print(f"fetch_resample (sweep inputs): {sids.shape[0]} tiles, {n_unique} unique quads of "
          f"{sblocks.shape[0]}, values up to {float(got.max()):.0f}; max |kernel - plain| "
          f"{err:.3e} raw texel units (tol {TOL_HALFGRID})")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("fetch_resample: not finite")
    err7 = max(err7, hold(err, TOL_HALFGRID, "K7 vs plain (sweep inputs)"))
    ms, flushed = device_ms(lambda: k7(sblocks, sids, sgeom)), cold_ms(
        lambda: k7(sblocks, sids, sgeom))
    plain_ms = device_ms(lambda: k7_plain(sblocks, sids, sgeom), n=5)
    print(f"fetch_resample: {ms:.4f} ms (device, L2 warm), {flushed:.4f} ms (L2 flushed); "
          f"plain PyTorch version {plain_ms:.4f} ms (device)")
    F = sids.shape[0]
    sx, sy = k7_support(sgeom)
    nbytes = n_unique * QUAD_BYTES + tensor_bytes(sids, sgeom) + F * 33 * 33 * 4
    ops = F * (OPS_K7_WEIGHTS + 33 * 33) + 2 * (64 * sy + 33 * sx)
    results["fetch_resample"] = dict(max_abs_err=err7, ms=ms, plain_ms=plain_ms,
                                     **bound(nbytes, ops), library_ms=None)
    # a second floor, not the bound: every tile's quad fetched on its own
    # (the sweep's random ids repeat few quads, and its block array is over
    # the 50 MB L2)
    print(f"  per-tile fetch floor (not the bound): {F} x {QUAD_BYTES} B = "
          f"{F * QUAD_BYTES / 1e6:.2f} MB -> {F * QUAD_BYTES / PEAK_BYTES * 1e3:.4f} ms; the "
          f"bound counts the {n_unique} unique quads")
    waves_sweep({"fetch_resample, sweep inputs": (
        "HALFGRID_WAVES", "fetch_resample", k7, (sblocks, sids, sgeom))}, F)
    del sblocks, got
    _SHA_MEMO.clear()
    torch.cuda.empty_cache()


def sweep_path() -> int:
    """``kernels.fetch_resample`` as its one caller drives it, the sweep tool
    of the JAX package (tools/fetch_kernel_sweep.py): one call for all 8192
    tiles, a few times. Returns the launches."""
    import torch

    from bevy_terrain_tpu_torch.ops import kernels

    blocks, ids, geom = sweep_inputs()
    reset_counts()
    calls = 5
    for _ in range(calls):
        out = kernels.fetch_resample(blocks, ids, geom)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"sweep path: {calls} calls of fetch_resample on {ids.shape[0]} tiles, launches "
          f"{counts}; values in [{float(out.min()):.1f}, {float(out.max()):.1f}]")
    if counts["fetch_resample"] != calls or any(
            v for k, v in counts.items() if k != "fetch_resample"):
        raise AssertionError("the sweep did not launch fetch_resample once per call, and "
                             "nothing else")
    # a crossfaded tent resample is a convex mix of the quad's texels
    if not (bool(torch.isfinite(out).all()) and 0.0 <= float(out.min())
            and float(out.max()) <= 30000.0 and float(out.std()) > 1000.0):
        raise AssertionError("the sweep's half-grids are not finite texel mixes")
    return counts["fetch_resample"]


# -- main paths ----------------------------------------------------------------


def reset_counts() -> None:
    from bevy_terrain_tpu_torch.ops import kernels

    for name, *_ in KERNELS:
        getattr(kernels, name).launches = 0


def read_counts() -> dict:
    from bevy_terrain_tpu_torch.ops import kernels

    return {name: getattr(kernels, name).launches for name, *_ in KERNELS}


def stream(terrain, view, view_proj, kernel_name, what: str, absent=(), timed: int = 30,
           also=()):
    """Stream ``terrain`` to quiescence, then ``timed`` timed frames. The
    launch counts are set to 0 just before and read just after; every frame
    must have launched ``kernel_name`` (None: no kernel at all) and each
    kernel in ``also`` once, and none the kernels in ``absent``. Returns
    (last output, frames, update walls in s)."""
    import torch

    reset_counts()
    frames = 0
    t0 = time.perf_counter()
    for i in range(300):
        terrain.update({"cam": view}, {"cam": view_proj})
        frames += 1
        if i > 3 and not terrain.atlas.state.to_load and not any(
            a.loading for a in terrain.atlas.attachments
        ):
            break
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    walls = []
    for _ in range(timed):
        t0 = time.perf_counter()
        out = terrain.update({"cam": view}, {"cam": view_proj})["cam"]
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        frames += 1
    counts = read_counts()
    print(f"{what}: streamed to quiescence in {stream_s:.1f} s; {frames} frames, "
          f"launches {counts}")
    if kernel_name is None:
        absent = tuple(counts)
    for k in () if kernel_name is None else (kernel_name, *also):
        if counts[k] != frames:
            raise AssertionError(f"{k} launched {counts[k]} times in {frames} frames")
    if any(counts[k] for k in absent):
        raise AssertionError(f"{what}: {', '.join(absent)} must not launch")
    return out, frames, walls


def stage_timing(terrain, what: str, n: int, hmin: float, hmax: float, walls) -> None:
    cfg = terrain._static_cfgs["cam"]
    height = terrain.atlas.attachments[0]
    blob = terrain._last_blobs["cam"]
    fused = {}
    m = terrain._fused_material
    if m is not None:  # the material stage in the kernel, as Terrain.update runs it
        fused = dict(albedo_blocks=terrain.atlas.attachments[m.index].block_array,
                     albedo_channels=m.channels, albedo_bits=m.bits, shade_spec=m.shade)

    def device_stage():
        terrain.frame_step(height.block_array, blob, cfg, height.patch_plan,
                           height.config.format.max_value, **fused)

    stage_ms = cuda_ms(device_stage, n=20)
    print(f"{what}: {n} tiles, heights [{hmin:.2f}, {hmax:.2f}] m; update "
          f"{statistics.median(walls) * 1e3:.3f} ms median wall (host prologue + "
          f"device stage + sync); unpack + refine + plan + mesh {stage_ms:.4f} ms "
          f"(CUDA events, stream span)")
    if fused:
        # the same terrain's stage without the material, in turns with it
        def mesh_stage():
            terrain.frame_step(height.block_array, blob, cfg, height.patch_plan,
                               height.config.format.max_value)

        turns = [cuda_ms(f, n=10) for f in (mesh_stage, device_stage, device_stage, mesh_stage)]
        print(f"{what}: stage span in turns, height-only / material / material / height-only: "
              + " / ".join(f"{t:.4f}" for t in turns) + " ms")
    profile_stage(device_stage, what)


def rows_by_key(out):
    """(rows of the live tiles ordered by (side, lod, x, y), the sorted
    keys): two frames' tile lists compared as sets, row by row."""
    import torch

    t, live = out.tiles, out.tile_count
    key = ((t.tile_side[:live].long() << 50) | (t.tile_lod[:live].long() << 40)
           | (t.tile_xy[:live, 0].long() << 20) | t.tile_xy[:live, 1].long())
    return torch.argsort(key), key.sort().values


def kernel_free_path(config, default, default_out, view, view_proj, what: str,
                     off_counts: dict, shading=None) -> None:
    """The kernel-free path on the card: the dataset and camera of
    ``default`` (a terrain streamed on its default path, the hand kernels)
    through ``add_view(..., pallas_sampling=False)`` on ``"cuda"``, the JAX
    package's XLA path in torch ops, with the fused kernel's blend (per
    vertex) so that both frames compute one function. No kernel may launch
    in any frame; the frame is held to the default one per tile within the
    fused-vs-staged yardsticks (and the lit colours within the fast
    albedo's); the device stage (``Terrain._device_stage``: mesh and
    material) is timed in turns with the default's, as CUDA-event spans and
    as profiler kernel time. Adds the path's launches to ``off_counts``."""
    import torch

    from bevy_terrain_tpu_torch import Terrain

    kwhat = f"{what}, pallas_sampling=False"
    dcfg = default._static_cfgs["cam"]
    terrain = Terrain(config, device="cuda")
    terrain.add_view("cam", default.view_configs["cam"], queue_capacity=dcfg.queue_capacity,
                     culling=dcfg.culling, blend_per_vertex=True, pallas_sampling=False)
    if shading:
        terrain.set_shading(**shading)
    out, frames, walls = stream(terrain, view, view_proj, None, kwhat, timed=10)
    launched = read_counts()
    for k, v in launched.items():
        off_counts[k] = off_counts.get(k, 0) + v
    cfg = terrain._static_cfgs["cam"]
    if cfg.pallas_sampling or terrain.use_fused(cfg) or out.raw_mesh is not None:
        raise AssertionError(f"{kwhat}: the frame took the fused path")
    n = out.tile_count
    (rows, keys), (drows, dkeys) = rows_by_key(out), rows_by_key(default_out)
    if n <= 0 or out.overflow != 0 or not torch.equal(keys, dkeys):
        raise AssertionError(f"{kwhat}: {n} tiles, overflow {out.overflow}, or another tile "
                             f"set than the default frame's {default_out.tile_count}")
    gaps = {f: float((getattr(out.mesh, f)[:n][rows]
                      - getattr(default_out.mesh, f)[:n][drows]).abs().max())
            for f in ("heights", "positions", "uvs")}
    hold(max(gaps["heights"], gaps["positions"]), TOL_STAGED_POS, f"{kwhat}: the mesh")
    hold(gaps["uvs"], TOL_STAGED_UV, f"{kwhat}: the uvs")
    if shading:
        colors = out.colors[:n][rows]
        if not bool(torch.isfinite(out.colors).all()):
            raise AssertionError(f"{kwhat}: non-finite colours")
        gaps["colours"] = float((colors - default_out.colors[:n][drows]).abs().max())
        hold(gaps["colours"], TOL_ALB_FAST, f"{kwhat}: the lit colours")

    def stage(t):
        blob, c = t._last_blobs["cam"], t._static_cfgs["cam"]
        return lambda: t._device_stage(blob, c)

    on, off = stage(default), stage(terrain)
    turns = [cuda_ms(f, n=10) for f in (on, off, off, on)]
    kernel_ms = {"default": device_time_ms(on, label=what),
                 "off": device_time_ms(off, label=kwhat)}
    print(f"pallas_sampling: {what}: off: {n} tiles, {sum(launched.values())} kernel "
          f"launches in {frames} frames; device stage span in turns, default / off / off / "
          f"default: " + " / ".join(f"{t:.4f}" for t in turns) + " ms (CUDA events); "
          f"device kernel time default {kernel_ms['default']:.4f} ms, off "
          f"{kernel_ms['off']:.4f} ms (profiler); update wall median off "
          f"{statistics.median(walls) * 1e3:.3f} ms; max |off - default| " + ", ".join(
              f"{k} {v:.3e}" for k, v in gaps.items()) + f"; {card_line()}")
    profile_stage(off, kwhat)


def main_path_phase(off_counts: dict) -> int:
    """The bench scene over a synthetic 8k^2 planar dataset through
    ``Terrain(config, device="cuda")``: K1 every frame; then the kernel-free
    path on the same dataset (:func:`kernel_free_path`, its launches added
    to ``off_counts``). Returns K1's launches on the main path."""
    import torch

    from bevy_terrain_tpu_torch import Terrain
    from bevy_terrain_tpu_torch.config import AttachmentConfig, TerrainConfig, TerrainViewConfig
    from bevy_terrain_tpu_torch.ops import kernels
    from bevy_terrain_tpu_torch.utils.synthetic import generate_planar_dataset

    model, vc, view, view_proj = bench_scene()
    att = AttachmentConfig(name="height", texture_size=TEXTURE_SIZE, border_size=BORDER,
                           mip_level_count=4)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        tiles = generate_planar_dataset("smoke", LOD_COUNT, att, root=tmp)
        print(f"main path: wrote {len(tiles)} tiles of {TEXTURE_SIZE}^2 R16 "
              f"(lods 0-{LOD_COUNT - 1}) in {time.perf_counter() - t0:.1f} s")
        config = TerrainConfig(lod_count=LOD_COUNT, model=model, atlas_size=1024,
                               path="smoke", attachments=(att,), assets_root=tmp)
        terrain = Terrain(config, device="cuda")
        terrain.add_view("cam", TerrainViewConfig(tile_capacity=vc.tile_capacity),
                         queue_capacity=1024, culling=True)
        out, launches, walls = stream(terrain, view, view_proj, "mesh_fused_planar",
                                      "main path")

        n = out.tile_count
        if n <= 0 or out.overflow != 0:
            raise AssertionError(f"main path frame: tile_count {n}, overflow {out.overflow}")
        mesh = out.mesh
        for field in ("heights", "positions", "uvs"):
            if not bool(torch.isfinite(getattr(mesh, field)).all()):
                raise AssertionError(f"non-finite {field}")
        h = mesh.heights[:n]
        hmin, hmax = float(h.min()), float(h.max())
        if not (model.min_height <= hmin and hmax <= model.max_height):
            raise AssertionError(f"heights [{hmin}, {hmax}] outside the model's range")
        compare(out.raw_mesh, kernels.mesh_fused_planar_reference(*out.mesh_inputs),
                "main path last frame")
        stage_timing(terrain, "main path", n, hmin, hmax, walls)
        kernel_free_path(config, terrain, out, view, view_proj, "main path", off_counts)
        query_path(terrain, "planar")
        adaptive_capacity_path(terrain, view)
        return launches



def query_points(kind: str, model, n: int):
    """``n`` seeded world positions (default_rng(11)): over the planar
    terrain up to its height range, or around the planet camera's nadir
    (across the neighbouring cube faces) up to 20 km above the sphere."""
    import numpy as np

    rng = np.random.default_rng(11)
    if kind == "planet":
        d = rng.normal(size=(n, 3)) * np.array([0.6, 0.6, 0.2]) + np.array([0.0, 0.0, 1.0])
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return d * (RADIUS + rng.uniform(0.0, 20_000.0, (n, 1)))
    return np.stack([rng.uniform(-0.48, 0.48, n) * SIDE, rng.uniform(0.0, 250.0, n),
                     rng.uniform(-0.48, 0.48, n) * SIDE], axis=-1)


def query_path(terrain, kind: str, albedo_index=None) -> None:
    """The query path on a streamed terrain: ``Terrain.query_heights`` (and
    ``query_attachment`` of ``albedo_index``) on QUERY_POINTS seeded world
    points against the view's last uniforms, which stay on the card. Held to
    the same torch ops on the CPU (the blob and the slab copied over) and,
    on 256 of the points, to the f64 host sampling API; timed per call
    (queued back to back, the stream span of one call, and the device kernel
    time from the profiler). No kernel of csrc/ may launch."""
    import numpy as np
    import torch

    from bevy_terrain_tpu_torch.ops import sampling
    from bevy_terrain_tpu_torch.ops.params import unpack_frame_uniforms
    from bevy_terrain_tpu_torch.terrain_data.sampling_api import sample_attachment, sample_height

    what = f"query path ({kind})"
    model = terrain.config.model
    pts = query_points(kind, model, QUERY_POINTS)
    pts_dev = torch.from_numpy(pts.astype(np.float32)).cuda()
    reset_counts()
    got = terrain.query_heights("cam", pts)  # numpy in, a tensor on the card out
    torch.cuda.synchronize()
    if got.device.type != "cuda" or got.shape != (QUERY_POINTS,) or not torch.equal(
            got, terrain.query_heights("cam", pts_dev)):
        raise AssertionError(f"{what}: heights {tuple(got.shape)} on {got.device}")
    cfg = terrain._static_cfgs["cam"]
    cu = unpack_frame_uniforms(terrain._last_blobs["cam"].cpu(), cfg.side_count,
                               cfg.lod_count, cfg.tree_size)
    tree = terrain.tile_trees["cam"]
    sub = np.random.default_rng(12).choice(QUERY_POINTS, 256, replace=False)
    tol_cpu, tol_host = TOL_QUERY[kind]

    height = terrain.atlas.attachments[0]
    want = sampling.query_heights(height.slabs[0].cpu(), cu, cfg, pts_dev.cpu(),
                                  height.config.scale, height.config.offset)
    err_cpu = float((got.cpu() - want).abs().max())
    host = np.array([sample_height(tree, terrain.atlas, pts[i]) for i in sub])
    err_host = float(np.abs(got.cpu().numpy()[sub] - host).max())
    # a query is a chain of small torch ops: queued back to back the host's
    # launches set the pace, so the device's share comes from the profiler
    ms = device_ms(lambda: terrain.query_heights("cam", pts_dev))
    span = cuda_ms(lambda: terrain.query_heights("cam", pts_dev), n=10)
    hmin, hmax = float(got.min()), float(got.max())
    print(f"{what}: query_heights on {QUERY_POINTS} points, heights [{hmin:.2f}, {hmax:.2f}] "
          f"m; max |card - CPU| {err_cpu:.3e} m (tol {tol_cpu:.0e}), |card - host sampling "
          f"API| on {len(sub)} points {err_host:.3e} m (tol {tol_host:.0e}); {ms:.4f} ms "
          f"per call queued back to back, {span:.4f} ms stream span of one call")
    profile_stage(lambda: terrain.query_heights("cam", pts_dev), f"{what}, query_heights")
    if not (bool(torch.isfinite(got).all()) and model.min_height <= hmin
            and hmax <= model.max_height
            and float(got.std()) > 0.02 * (model.max_height - model.min_height)):
        raise AssertionError(f"{what}: heights not finite, out of range or flat")
    hold(err_cpu, tol_cpu, f"{what}: card vs CPU heights")
    hold(err_host, tol_host, f"{what}: card vs host sampling API heights")

    if albedo_index is not None:
        att = terrain.atlas.attachments[albedo_index]
        colors = terrain.query_attachment("cam", pts_dev, albedo_index)
        torch.cuda.synchronize()
        want = sampling.query_attachment(att.slabs[0].cpu(), cu, cfg, pts_dev.cpu(),
                                         att.config.scale, att.config.offset,
                                         att.config.format.max_value)
        cerr_cpu = float((colors.cpu() - want).abs().max())
        host = np.array([sample_attachment(tree, terrain.atlas, albedo_index, pts[i])
                         for i in sub])
        cerr_host = float(np.abs(colors.cpu().numpy()[sub] - host).max())
        cms = device_ms(lambda: terrain.query_attachment("cam", pts_dev, albedo_index))
        print(f"{what}: query_attachment {tuple(colors.shape)}, colours in "
              f"[{float(colors.min()):.4f}, {float(colors.max()):.4f}]; max |card - CPU| "
              f"{cerr_cpu:.3e} (tol {TOL_QUERY_COLOR[0]:.0e}), |card - host sampling API| "
              f"{cerr_host:.3e} (tol {TOL_QUERY_COLOR[1]:.1e}); {cms:.4f} ms per call queued "
              f"back to back")
        if colors.shape != (QUERY_POINTS, 4) or not float(colors[:, 0].min()) > 0.0:
            raise AssertionError(f"{what}: colours {tuple(colors.shape)} or an empty channel 0")
        hold(cerr_cpu, TOL_QUERY_COLOR[0], f"{what}: card vs CPU colours")
        hold(cerr_host, TOL_QUERY_COLOR[1], f"{what}: card vs host sampling API colours")
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"{what}: a query launched a kernel: {counts}")


def adaptive_capacity_path(terrain, view) -> None:
    """Adaptive capacity on the streamed planar terrain: a fly-in from 6 km
    above the bench camera down to it, a teleport away (3 km off, 5 km up)
    and a teleport back. The path runs once at the fixed capacity and once
    over the default ladder (1024 / 2048 / 4096); at each camera the terrain
    is updated until no tile is loading. Every update of the adaptive pass
    must report overflow 0, the teleport back must re-dispatch its frame,
    and each camera's settled frame must equal the fixed-capacity one (tile
    list and mesh, bit for bit)."""
    import numpy as np
    import torch

    from bevy_terrain_tpu_torch.math import frustum

    what = "adaptive capacity path"
    cameras = [view + np.array([0.0, h, 0.0]) for h in (6000.0, 3000.0, 1500.0, 700.0, 300.0,
                                                         0.0)]
    cameras += [view + np.array([3000.0, 5000.0, -2000.0]), view]

    def proj(pos):
        target = pos + np.array([1000.0, -40.0 - 0.8 * (pos[1] - view[1]), 300.0])
        return frustum.view_projection(pos, target, np.pi / 3, 16 / 9)

    def fly(adaptive: bool):
        frames, overflows, rungs = [], 0, []
        for pos in cameras:
            for i in range(60):
                out = terrain.update({"cam": pos}, {"cam": proj(pos)})["cam"]
                overflows += out.overflow
                if adaptive:
                    rungs.append(terrain.frame_inputs("cam")[1].tile_capacity)
                if i > 0 and not terrain.atlas.state.to_load and not any(
                        a.loading for a in terrain.atlas.attachments):
                    break
            n = out.tile_count
            frames.append((n, out.tiles.tile_lod[:n].clone(), out.tiles.tile_xy[:n].clone(),
                           out.raw_mesh[:n].clone()))
        return frames, overflows, rungs

    fixed, fixed_overflows, _ = fly(False)
    capacity = terrain.view_configs["cam"].tile_capacity
    terrain.enable_adaptive_capacity("cam")
    reset_counts()
    try:
        before = (terrain.overflow_checks, terrain.overflow_redispatches)
        adapted, overflows, rungs = fly(True)
        checks = terrain.overflow_checks - before[0]
        redispatches = terrain.overflow_redispatches - before[1]
        ladder = terrain._adaptive["cam"]["ladder"]
    finally:
        terrain.disable_adaptive_capacity("cam")
    torch.cuda.synchronize()
    counts = read_counts()
    updates = len(rungs)
    print(f"{what}: {len(cameras)} cameras, {updates} updates over the ladder {ladder}; tiles "
          f"per camera {[f[0] for f in adapted]}; rungs taken {sorted(set(rungs))} "
          f"({[rungs.count(r) for r in sorted(set(rungs))]} updates); {checks} overflow checks, "
          f"{redispatches} same-frame re-dispatches; overflow over all updates {overflows} "
          f"(fixed capacity {fixed_overflows}); mesh kernel launches "
          f"{counts['mesh_fused_planar']}")
    if overflows or fixed_overflows:
        raise AssertionError(f"{what}: a frame dropped geometry")
    if redispatches < 1 or len(set(rungs)) < 2 or min(rungs) >= capacity:
        raise AssertionError(f"{what}: the ladder was not walked, or no re-dispatch")
    if counts["mesh_fused_planar"] != updates + redispatches:
        raise AssertionError(f"{what}: {counts['mesh_fused_planar']} mesh launches for "
                             f"{updates} updates and {redispatches} re-dispatches")
    for i, (a, f) in enumerate(zip(adapted, fixed)):
        if a[0] != f[0] or not all(torch.equal(x, y) for x, y in zip(a[1:], f[1:])):
            raise AssertionError(f"{what}: camera {i}'s frame differs from the fixed-capacity "
                                 f"one")
    print(f"{what}: every camera's settled frame equals the fixed-capacity one (tile list "
          f"and mesh rows, bit for bit)")


def check_sphere_mesh(mesh, n: int, model, what: str):
    """Finite output, heights in the model's range, unit normals. Returns
    the height range."""
    import torch

    for field in ("heights", "positions", "uvs", "normals"):
        if not bool(torch.isfinite(getattr(mesh, field)[:n]).all()):
            raise AssertionError(f"{what}: non-finite {field}")
    h = mesh.heights[:n]
    hmin, hmax = float(h.min()), float(h.max())
    if not (model.min_height <= hmin and hmax <= model.max_height):
        raise AssertionError(f"{what}: heights [{hmin}, {hmax}] outside the model's range")
    norm = torch.linalg.vector_norm(mesh.normals[:n].double(), dim=-1)
    unit_err = float((norm - 1.0).abs().max())
    if unit_err > TOL_UNIT:
        raise AssertionError(f"{what}: normals off unit length by {unit_err}")
    return hmin, hmax


def sphere_main_path_phase() -> dict:
    """A synthetic six-side planet (3 data lods of 512^2 R16 tiles) streamed
    through ``Terrain(config)`` (the card by default) under the Earth
    scene's camera: with the Taylor path (the fused spherical kernel), then
    with ``high_precision=False`` (the staged mesh, ``generate_mesh_grid``:
    the half-grid kernel once per frame and no mesh kernel). Returns the
    launches of each path's kernel."""
    import torch

    from bevy_terrain_tpu_torch import Terrain
    from bevy_terrain_tpu_torch.config import AttachmentConfig, TerrainConfig, TerrainViewConfig
    from bevy_terrain_tpu_torch.ops import kernels
    from bevy_terrain_tpu_torch.utils.synthetic import generate_spherical_dataset

    model = sphere_model("sphere")
    view, view_proj = sphere_view(model)
    att = AttachmentConfig(name="height", texture_size=TEXTURE_SIZE, border_size=BORDER,
                           mip_level_count=4)
    what = "sphere main path"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sphere_") as tmp:
        t0 = time.perf_counter()
        tiles = generate_spherical_dataset("smoke_sphere", SPH_DATA_LODS, att, root=tmp)
        print(f"{what}: wrote {len(tiles)} tiles of {TEXTURE_SIZE}^2 R16 on 6 sides (lods "
              f"0-{SPH_DATA_LODS - 1}) in {time.perf_counter() - t0:.1f} s")
        config = TerrainConfig(lod_count=SPH_LODS, model=model, atlas_size=SPH_ATLAS,
                               path="smoke_sphere", attachments=(att,), assets_root=tmp)

        def planet(**view_kw):
            terrain = Terrain(config)
            if terrain.device.type != "cuda":
                raise AssertionError(f"Terrain(config) runs on {terrain.device}, not the card")
            terrain.add_view("cam", TerrainViewConfig(tile_capacity=SPH_CAPACITY),
                             queue_capacity=2048, culling=True, **view_kw)
            return terrain

        terrain = planet()
        out, launches, walls = stream(terrain, view, view_proj, "mesh_fused_spherical", what,
                                      absent=("fetch_resample_cached",))
        n = out.tile_count
        if n <= 100 or out.overflow != 0:
            raise AssertionError(f"{what} frame: tile_count {n}, overflow {out.overflow}")
        hmin, hmax = check_sphere_mesh(out.mesh, n, model, what)
        compare_spherical(out.raw_mesh,
                          kernels.mesh_fused_spherical_reference(*out.mesh_inputs),
                          f"{what} last frame")
        stage_timing(terrain, what, n, hmin, hmax, walls)
        planet_raster_path(terrain, view, view_proj, card_line())

        # the staged path: the same planet without the Taylor path
        swhat = "staged main path"
        staged = planet(high_precision=False)
        mesh_kernels = tuple(k for k, *_ in KERNELS if k.startswith("mesh_fused"))
        sout, staged_launches, swalls = stream(staged, view, view_proj,
                                               "fetch_resample_cached", swhat,
                                               absent=mesh_kernels)
        sn = sout.tile_count
        if sn <= 100 or sout.overflow != 0 or sout.raw_mesh is not None:
            raise AssertionError(f"{swhat} frame: tile_count {sn}, overflow {sout.overflow}, "
                                 f"or a raw tensor on the staged path")
        shmin, shmax = check_sphere_mesh(sout.mesh, sn, model, swhat)

        def staged_step():
            cfg, height = staged._static_cfgs["cam"], staged.atlas.attachments[0]
            return staged.frame_step(height.block_array, staged._last_blobs["cam"], cfg,
                                     height.patch_plan, height.config.format.max_value)

        # the same stage with the half-grid from K6's plain version
        wrapper = kernels.fetch_resample_cached
        kernels.fetch_resample_cached = kernels.fetch_resample_cached_reference
        try:
            _, plain, _, _ = staged_step()
        finally:
            kernels.fetch_resample_cached = wrapper
        errs = {f: float((getattr(sout.mesh, f) - getattr(plain, f)).abs().max())
                for f in ("heights", "positions", "uvs", "normals")}
        tols = {"heights": TOL_SPH_H, "positions": TOL_SPH_POS, "uvs": TOL_SPH_UV,
                "normals": TOL_SPH_N}
        print(f"{swhat} last frame: max |kernel - plain| " + ", ".join(
            f"{k} {v:.3e} (tol {tols[k]:.0e})" for k, v in errs.items()))
        for f in errs:
            hold(errs[f], tols[f], f"{swhat}: {f} with K6 against its plain version")
        # the two paths on the same planet, tile by tile where the lists agree
        same = (sn == n and all(torch.equal(getattr(sout.tiles, f)[:n], getattr(out.tiles, f)[:n])
                                for f in ("tile_side", "tile_lod", "tile_xy")))
        if same:
            gap = {f: float((getattr(sout.mesh, f)[:n] - getattr(out.mesh, f)[:n]).abs().max())
                   for f in ("heights", "positions", "uvs", "normals")}
            print(f"{swhat} vs sphere main path (same {n} tiles): max |staged - fused| "
                  + ", ".join(f"{k} {v:.3e}" for k, v in gap.items()))
        else:
            print(f"{swhat}: {sn} tiles against the fused path's {n}; lists differ, meshes "
                  f"not compared")
        stage_timing(staged, swhat, sn, shmin, shmax, swalls)

        def fused_step():
            cfg, height = terrain._static_cfgs["cam"], terrain.atlas.attachments[0]
            return terrain.frame_step(height.block_array, terrain._last_blobs["cam"], cfg,
                                      height.patch_plan, height.config.format.max_value)

        turns = [cuda_ms(f, n=10) for f in (fused_step, staged_step, staged_step, fused_step)]
        print(f"{swhat}: stage span in turns, fused / staged / staged / fused: "
              + " / ".join(f"{t:.4f}" for t in turns) + " ms")
        return {"mesh_fused_spherical": launches, "fetch_resample_cached": staged_launches}


def sphere_material_main_path_phase() -> dict:
    """The spherical material main path: the six-side planet of the sphere
    main path plus a synthetic Rgba8 albedo of the height's plan (a colour
    field of the unit cube-sphere position), lit by a StandardMaterial under
    the Earth scene's camera. A planet's material is staged in both
    packages: every frame must go through ``mesh_fused_spherical`` (K2) and
    ``attach_sample_fused_packed`` (K5b), then ``render/material.shade`` on
    the kernel's sphere normals, and never through an in-kernel material.
    The last frame is held to the same stage with the two kernels' plain
    versions; the stage's span is timed in turns with the height-only
    spherical stage. Then the unlit albedo, the frame's mesh with the
    albedo sampled in the kernel through ``meshgen.generate_mesh_fused``
    (K3s) against the pipeline's colours, and the query path on the
    planet. Returns K3s's launches."""
    import torch

    from bevy_terrain_tpu_torch import Terrain
    from bevy_terrain_tpu_torch.config import (
        AttachmentConfig, AttachmentFormat, TerrainConfig, TerrainViewConfig,
    )
    from bevy_terrain_tpu_torch.ops import kernels, meshgen, refinement
    from bevy_terrain_tpu_torch.render import material
    from bevy_terrain_tpu_torch.utils.synthetic import generate_spherical_dataset

    model = sphere_model("sphere")
    view, view_proj = sphere_view(model)
    kw = dict(texture_size=TEXTURE_SIZE, border_size=BORDER, mip_level_count=4)
    atts = (AttachmentConfig(name="height", **kw),
            AttachmentConfig(name="albedo", format=AttachmentFormat.RGBA8, **kw))
    what = "sphere material main path"
    # the sun over the camera's side of the planet
    lit = material.StandardMaterial(
        base_color=material.albedo_material(1), perceptual_roughness=0.7, metallic=0.1,
        reflectance=0.3,
        lights=(material.DirectionalLight(direction=(-0.3, -0.2, -0.9), color=(1.0, 0.95, 0.9),
                                          illuminance=0.9),))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sphere_material_") as tmp:
        t0 = time.perf_counter()
        tiles = [generate_spherical_dataset("smoke_sphere", SPH_DATA_LODS, att, root=tmp)
                 for att in atts]
        print(f"{what}: wrote {len(tiles[0])} tiles each of {TEXTURE_SIZE}^2 R16 height and "
              f"Rgba8 albedo on 6 sides (lods 0-{SPH_DATA_LODS - 1}) in "
              f"{time.perf_counter() - t0:.1f} s")
        config = TerrainConfig(lod_count=SPH_LODS, model=model, atlas_size=SPH_ATLAS,
                               path="smoke_sphere", attachments=atts, assets_root=tmp)
        terrain = Terrain(config)
        if terrain.device.type != "cuda":
            raise AssertionError(f"Terrain(config) runs on {terrain.device}, not the card")
        terrain.add_view("cam", TerrainViewConfig(tile_capacity=SPH_CAPACITY),
                         queue_capacity=2048, culling=True)
        terrain.set_shading(lit, sample_attachments=(1,))
        # on a planar frame this material would run in the mesh kernel; on
        # a planet the pipeline stages it all the same
        if terrain._fused_material is None:
            raise AssertionError(f"{what}: the material no longer qualifies for the "
                                 f"in-kernel shade of a planar frame")
        staged = ("mesh_fused_spherical", "attach_sample_fused_packed")
        others = tuple(k for k, *_ in KERNELS if k not in staged)
        out, frames, walls = stream(terrain, view, view_proj, staged[0], what, absent=others,
                                    timed=20, also=staged[1:])
        n, F = out.tile_count, SPH_CAPACITY
        if n <= 100 or out.overflow != 0 or out.raw_mesh.shape[1] != kernels.SPH_CH:
            raise AssertionError(f"{what} frame: tile_count {n}, overflow {out.overflow}, raw "
                                 f"{tuple(out.raw_mesh.shape)}")
        hmin, hmax = check_sphere_mesh(out.mesh, n, model, what)
        colors = out.colors
        if colors.shape != (F, 17, 17, 4) or not bool(torch.isfinite(colors).all()):
            raise AssertionError(f"{what}: colours {tuple(colors.shape)} or not finite")
        cfg, blob = terrain._static_cfgs["cam"], terrain._last_blobs["cam"]
        height, albedo = terrain.atlas.attachments

        def material_stage():
            return terrain._device_stage(blob, cfg)

        def mesh_stage():
            return terrain.frame_step(height.block_array, blob, cfg, height.patch_plan,
                                      height.config.format.max_value)

        # the same stage with K2's and K5b's plain versions
        wrappers = {k: getattr(kernels, k) for k in staged}
        for k in staged:
            setattr(kernels, k, getattr(kernels, k + "_reference"))
        try:
            plain = material_stage()
        finally:
            for k, w in wrappers.items():
                setattr(kernels, k, w)
        rgb = colors[:n, ..., :3]
        err = float((colors - plain.colors).abs().max())
        # lit colours carry the kernel-vs-plain height gap (2e-3 m over
        # tens of metres of vertex spacing) through the normals
        print(f"{what}: {n} tiles, heights [{hmin:.2f}, {hmax:.2f}] m, linear RGB in "
              f"[{float(rgb.min()):.4f}, {float(rgb.max()):.4f}] (mean {float(rgb.mean()):.4f}), "
              f"alpha [{float(colors[:n, ..., 3].min()):.4f}, "
              f"{float(colors[:n, ..., 3].max()):.4f}]; max |kernels - plain versions| colours "
              f"{err:.3e} (tol {TOL_SHADE_EXACT:.0e}); update "
              f"{statistics.median(walls) * 1e3:.3f} ms median wall")
        if not (err <= TOL_SHADE_EXACT and float(rgb.mean()) > 0.02 and not colors[n:].any()):
            raise AssertionError(f"{what}: lit colours disagree with the plain versions, are "
                                 f"dark, or dead tiles are not zero")
        compare_spherical(out.raw_mesh, kernels.mesh_fused_spherical_reference(
            *out.mesh_inputs), f"{what} last frame mesh")
        turns = [cuda_ms(f, n=10) for f in (mesh_stage, material_stage, material_stage,
                                            mesh_stage)]
        print(f"{what}: stage span in turns, height-only / material / material / height-only: "
              + " / ".join(f"{t:.4f}" for t in turns) + " ms (CUDA events, stream span)")
        profile_stage(material_stage, what)

        # the unlit albedo: the colours are the sampler's values
        terrain.set_shading(material.albedo_material(1), lighting=False,
                            sample_attachments=(1,))
        reset_counts()
        count = 5
        for _ in range(count):
            out = terrain.update({"cam": view}, {"cam": view_proj})["cam"]
        torch.cuda.synchronize()
        counts = read_counts()
        print(f"{what} (unlit albedo): {count} frames, launches {counts}")
        if any(counts[k] != (count if k in staged else 0) for k in counts):
            raise AssertionError(f"{what} (unlit albedo): not K2 + K5b once per frame")
        mask = out.mesh.tile_mask
        red = out.colors[mask][..., 0]
        if not (float(red.min()) > 0.1 and float(out.colors[mask][..., 3].min()) > 0.99):
            raise AssertionError(f"{what}: the sampled albedo is off the synthetic field")

        # the last frame's mesh with the albedo sampled in the kernel (K3s)
        uniforms, _ = terrain.frame_inputs("cam")
        reset_counts()
        for _ in range(count):
            raw, _ = meshgen.generate_mesh_fused(
                refinement.refine_tiles(uniforms, cfg), height.block_array, uniforms, cfg,
                height.patch_plan, height.config.format.max_value,
                albedo_blocks=albedo.block_array, albedo_channels=4, albedo_bits=8)
        torch.cuda.synchronize()
        k3s_counts = read_counts()
        rgba = meshgen.fused_albedo_to_grid(raw, cfg, 4, 255.0)
        err = float((rgba[mask] - out.colors[mask]).abs().max())
        same_mesh = torch.equal(raw[:, :kernels.SPH_CH], out.raw_mesh)
        print(f"{what} (mesh + albedo, generate_mesh_fused): {count} calls, launches "
              f"{k3s_counts}; mesh channels equal the frame's: {same_mesh}; fast albedo vs the "
              f"pipeline's sampled colours {err:.3e} (tol {TOL_ALB_FAST:.1e})")
        name = "mesh_fused_spherical_albedo"
        if k3s_counts[name] != count or any(v for k, v in k3s_counts.items() if k != name):
            raise AssertionError("generate_mesh_fused with a planet's albedo did not launch "
                                 f"{name} once per call, and nothing else")
        if not (same_mesh and err <= TOL_ALB_FAST):
            raise AssertionError(f"{what}: K3s's mesh channels or colours disagree with the "
                                 f"frame's")
        query_path(terrain, "planet", albedo_index=1)
        return {name: k3s_counts[name]}


def material_main_path_phase(off_counts: dict) -> dict:
    """The 8k^2 synthetic dataset with an Rgba8 albedo of the height's plan
    (512^2, border 2, 4 mips) beside the height, through ``Terrain(config)``
    (the card by default): lit in the mesh kernel, the same lit frame on the
    kernel-free path (:func:`kernel_free_path`, its launches added to
    ``off_counts``), opaque, the staged unlit albedo, and one attachment
    grid; then the frame's mesh with the albedo sampled in the kernel
    through ``meshgen.generate_mesh_fused``, as the reference package's
    tools/material_frame_bench.py measures it. Each sub-path is driven with
    the launch counts set to 0 just before it and read just after. Returns
    the launches of each kernel in its sub-path."""
    import torch

    from bevy_terrain_tpu_torch import Terrain
    from bevy_terrain_tpu_torch.config import (
        AttachmentConfig, AttachmentFormat, TerrainConfig, TerrainViewConfig,
    )
    from bevy_terrain_tpu_torch.ops import kernels, meshgen, refinement
    from bevy_terrain_tpu_torch.ops.params import unpack_frame_uniforms
    from bevy_terrain_tpu_torch.render import material
    from bevy_terrain_tpu_torch.utils.synthetic import generate_planar_dataset

    model, vc, view, view_proj = bench_scene()
    kw = dict(texture_size=TEXTURE_SIZE, border_size=BORDER, mip_level_count=4)
    atts = (AttachmentConfig(name="height", **kw),
            AttachmentConfig(name="albedo", format=AttachmentFormat.RGBA8, **kw))
    what = "material main path"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_material_") as tmp:
        t0 = time.perf_counter()
        tiles = [generate_planar_dataset("smoke", LOD_COUNT, att, root=tmp) for att in atts]
        print(f"{what}: wrote {len(tiles[0])} tiles each of {TEXTURE_SIZE}^2 R16 height and "
              f"Rgba8 albedo (lods 0-{LOD_COUNT - 1}) in {time.perf_counter() - t0:.1f} s")
        config = TerrainConfig(lod_count=LOD_COUNT, model=model, atlas_size=1024, path="smoke",
                               attachments=atts, assets_root=tmp)
        terrain = Terrain(config)
        if terrain.device.type != "cuda":
            raise AssertionError(f"Terrain(config) runs on {terrain.device}, not the card")
        terrain.add_view("cam", TerrainViewConfig(tile_capacity=vc.tile_capacity),
                         queue_capacity=1024, culling=True)
        terrain.set_shading(smoke_material(material), sample_attachments=(1,))
        out, shaded_launches, walls = stream(terrain, view, view_proj, "mesh_fused_shaded", what,
                                             absent=("mesh_fused_planar",))
        n = out.tile_count
        if n <= 0 or out.overflow != 0:
            raise AssertionError(f"{what} frame: tile_count {n}, overflow {out.overflow}")
        F = vc.tile_capacity
        colors = out.colors
        if colors.shape != (F, 17, 17, 4) or not bool(torch.isfinite(colors).all()):
            raise AssertionError(f"{what}: colours {tuple(colors.shape)} or not finite")
        lit = colors[:n, ..., :3]
        want = kernels.mesh_fused_shaded_reference(*out.mesh_inputs)
        err = float((out.raw_mesh[:, 6:] - want[:, 6:]).abs().max())
        print(f"{what}: {n} tiles, linear RGB in [{float(lit.min()):.4f}, "
              f"{float(lit.max()):.4f}], alpha in [{float(colors[:n, ..., 3].min()):.4f}, "
              f"{float(colors[:n, ..., 3].max()):.4f}]; max |kernel - plain| colours {err:.3e} "
              f"(tol {TOL_ALB_FAST:.1e})")
        if not err <= TOL_ALB_FAST or float(lit.max()) <= 0.0:
            raise AssertionError(f"{what}: shaded colours disagree with the plain version")
        compare(out.raw_mesh[:, :6], kernels.mesh_fused_planar_reference(*out.mesh_inputs[:6]),
                f"{what} last frame mesh")
        h = out.mesh.heights[:n]
        stage_timing(terrain, what, n, float(h.min()), float(h.max()), walls)
        kernel_free_path(config, terrain, out, view, view_proj, what, off_counts,
                         shading=dict(material=smoke_material(material),
                                      sample_attachments=(1,)))
        material_raster_path(terrain, view, view_proj, card_line())

        def frames(label, kernel_name, check, count=5, **shading):
            """``count`` frames of one shading; every frame launches
            ``kernel_name`` (and ``check``'s kernels) once."""
            terrain.set_shading(sample_attachments=(1,), **shading)
            reset_counts()
            for _ in range(count):
                out = terrain.update({"cam": view}, {"cam": view_proj})["cam"]
            torch.cuda.synchronize()
            counts = read_counts()
            print(f"{what} ({label}): {count} frames, launches {counts}")
            for k in (kernel_name, *check):
                if counts[k] != count:
                    raise AssertionError(f"{label}: {k} launched {counts[k]} times in "
                                         f"{count} frames")
            if any(v for k, v in counts.items() if k not in (kernel_name, *check)):
                raise AssertionError(f"{label}: another kernel launched")
            return out, counts

        out, _ = frames("opaque", "mesh_fused_shaded", (),
                        material=smoke_material(material, opaque_base_color=True))
        alpha = out.colors[..., 3]
        if not (bool((alpha[:n] == 1.0).all()) and not bool(alpha[n:].any())):
            raise AssertionError("opaque: alpha is not the tile's liveness")
        out, staged = frames("staged, unlit albedo", "mesh_fused_planar",
                             ("attach_sample_fused_packed",),
                             material=material.albedo_material(1), lighting=False)
        grid = terrain.sample_attachment_grid("cam", out, 1)
        mask = out.mesh.tile_mask
        err = float((out.colors[mask] - grid[mask]).abs().max())
        print(f"{what} (staged, unlit albedo): colours vs sample_attachment_grid {err:.3e}")
        if not (err <= 1e-6 and bool(torch.isfinite(out.colors).all())):
            raise AssertionError("staged: colours differ from sample_attachment_grid")

        # the last frame's mesh with the albedo sampled in the kernel (the
        # default fast path), from the library's mesh entry point
        height, albedo = terrain.atlas.attachments
        cfg = terrain._static_cfgs["cam"]
        u = unpack_frame_uniforms(terrain._last_blobs["cam"], 1, LOD_COUNT, cfg.tree_size)
        reset_counts()
        count = 5
        for _ in range(count):
            raw, _ = meshgen.generate_mesh_fused(
                refinement.refine_tiles(u, cfg), height.block_array, u, cfg, height.patch_plan,
                height.config.format.max_value, albedo_blocks=albedo.block_array,
                albedo_channels=4, albedo_bits=8)
        torch.cuda.synchronize()
        albedo_counts = read_counts()
        rgba = meshgen.fused_albedo_to_grid(raw, cfg, 4, 255.0)
        err = float((rgba[mask] - out.colors[mask]).abs().max())
        same_mesh = torch.equal(raw[:, :6], out.raw_mesh)
        print(f"{what} (mesh + albedo, generate_mesh_fused): {count} calls, launches "
              f"{albedo_counts}; mesh rows equal the staged frame's: {same_mesh}; fast "
              f"albedo vs the staged sampler {err:.3e} (tol {TOL_ALB_FAST:.1e})")
        if albedo_counts["mesh_fused_albedo"] != count or any(
                v for k, v in albedo_counts.items() if k != "mesh_fused_albedo"):
            raise AssertionError("generate_mesh_fused with an albedo did not launch "
                                 "mesh_fused_albedo once per call, and nothing else")
        if not (same_mesh and err <= TOL_ALB_FAST):
            raise AssertionError("mesh + albedo: mesh rows or colours disagree with the "
                                 "staged frame")

        reset_counts()
        heights = terrain.sample_attachment_grid("cam", out, 0)
        torch.cuda.synchronize()
        grid_counts = read_counts()
        print(f"{what} (height attachment grid): launches {grid_counts}")
        if grid_counts["attach_sample_fused"] != 1:
            raise AssertionError("sample_attachment_grid did not launch attach_sample_fused")
        if not bool(torch.isfinite(heights).all()):
            raise AssertionError("height attachment grid is not finite")
        # an albedo whose plan is not the height's (border 1 beside border
        # 2, the layout of the JAX package's examples/planar.py): the staged
        # sampler, no sampler kernel
        fwhat = "fallback sampler path"
        albedo1 = AttachmentConfig(name="albedo1", format=AttachmentFormat.RGBA8,
                                   **{**kw, "border_size": 1})
        generate_planar_dataset("smoke", LOD_COUNT, albedo1, root=tmp)
        terrain1 = Terrain(dataclasses.replace(config, attachments=(atts[0], albedo1)))
        terrain1.add_view("cam", TerrainViewConfig(tile_capacity=vc.tile_capacity),
                          queue_capacity=1024, culling=True)
        terrain1.set_shading(material.albedo_material(1), lighting=False,
                             sample_attachments=(1,))
        if terrain1.atlas.attachments[1].patch_plan == terrain1.atlas.attachments[0].patch_plan:
            raise AssertionError(f"{fwhat}: the border-1 albedo has the height's patch plan")
        out1, _, _ = stream(terrain1, view, view_proj, "mesh_fused_planar", fwhat,
                            absent=tuple(k for k, *_ in KERNELS if k != "mesh_fused_planar"),
                            timed=3)
        c1 = out1.colors
        grid1 = terrain1.sample_attachment_grid("cam", out1, 1)
        mask1 = out1.mesh.tile_mask
        own = float((c1[mask1] - grid1[mask1]).abs().max())

        (rows1, keys1), (rows2, keys2) = rows_by_key(out1), rows_by_key(out)
        if not torch.equal(keys1, keys2):
            raise AssertionError(f"{fwhat}: the tile set differs from the material path's")
        # both albedos hold the same analytic colour field on texel grids
        # half a texel apart: 8-bit steps (2/255) plus the bilinear error of
        # the blue wave at the coarsest sampled mip (~6e-3 each)
        gap = float((c1[:n][rows1] - out.colors[:n][rows2]).abs().max())
        print(f"{fwhat}: {out1.tile_count} tiles, colours in [{float(c1[mask1].min()):.4f}, "
              f"{float(c1[mask1].max()):.4f}]; vs sample_attachment_grid {own:.3e}; vs the "
              f"border-2 albedo through attach_sample_fused_packed {gap:.3e} (tol 3e-2)")
        if not (bool(torch.isfinite(c1).all()) and 0.0 <= float(c1.min())
                and float(c1.max()) <= 1.0 + 1e-6 and own <= 1e-6 and gap <= 3e-2):
            raise AssertionError(f"{fwhat}: colours out of range or off the sampled field")

        return {"mesh_fused_shaded": shaded_launches,
                "mesh_fused_albedo": albedo_counts["mesh_fused_albedo"],
                "attach_sample_fused_packed": staged["attach_sample_fused_packed"],
                "attach_sample_fused": grid_counts["attach_sample_fused"]}


def vertex_main_path_phase() -> None:
    """The bench scene over 32^2 height tiles, too small for the patch plan:
    ``Terrain(config).update`` takes the per-vertex path
    (``meshgen.generate_mesh``, bilinear gathers from the mip-0 slab), which
    has no hand-written kernel in either package: every launch count must
    stay 0. The last frame is held to the same stage on the CPU."""
    import torch

    from bevy_terrain_tpu_torch import Terrain
    from bevy_terrain_tpu_torch.config import AttachmentConfig, TerrainConfig, TerrainViewConfig
    from bevy_terrain_tpu_torch.ops import meshgen
    from bevy_terrain_tpu_torch.utils.synthetic import generate_planar_dataset

    model, vc, view, view_proj = bench_scene()
    att = AttachmentConfig(name="height", texture_size=32, border_size=1, mip_level_count=2)
    what = "per-vertex path"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_vertex_") as tmp:
        generate_planar_dataset("smoke_small", LOD_COUNT, att, root=tmp)
        config = TerrainConfig(lod_count=LOD_COUNT, model=model, atlas_size=1024,
                               path="smoke_small", attachments=(att,), assets_root=tmp)
        terrain = Terrain(config)
        if terrain.device.type != "cuda" or terrain.use_grid_mesh:
            raise AssertionError(f"{what}: on {terrain.device}, grid mesh "
                                 f"{terrain.use_grid_mesh}")
        terrain.add_view("cam", TerrainViewConfig(tile_capacity=vc.tile_capacity),
                         queue_capacity=1024, culling=True)
        out, frames, walls = stream(terrain, view, view_proj, None, what, timed=5)
        n, mesh = out.tile_count, out.mesh
        if n <= 0 or out.overflow != 0 or not isinstance(mesh, meshgen.MeshOutput):
            raise AssertionError(f"{what} frame: tile_count {n}, overflow {out.overflow}")
        for field in ("heights", "positions", "uvs", "normals"):
            if not bool(torch.isfinite(getattr(mesh, field)).all()):
                raise AssertionError(f"{what}: non-finite {field}")
        h = mesh.heights[:n]
        hmin, hmax = float(h.min()), float(h.max())
        if not (model.min_height <= hmin and hmax <= model.max_height and hmax - hmin > 10.0):
            raise AssertionError(f"{what}: heights [{hmin}, {hmax}]")
        cfg, height = terrain._static_cfgs["cam"], terrain.atlas.attachments[0]
        ctiles, cmesh = terrain.frame_step_vertex(
            height.slabs[0].cpu(), terrain._last_blobs["cam"].cpu(), cfg, height.config.scale,
            height.config.offset)
        for field in ("tile_side", "tile_lod", "tile_xy", "tile_count"):
            if not torch.equal(getattr(out.tiles, field).cpu(), getattr(ctiles, field)):
                raise AssertionError(f"{what}: the card's tile list differs from the CPU's")
        errs = {f: float((getattr(mesh, f).cpu() - getattr(cmesh, f)).abs().max())
                for f in ("heights", "positions", "uvs")}
        print(f"{what}: {frames} frames, no kernel launched; {n} tiles of "
              f"{cfg.vertices_per_tile} strip vertices, heights [{hmin:.2f}, {hmax:.2f}] m; "
              f"update {statistics.median(walls) * 1e3:.3f} ms median wall; max |card - CPU| "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        hold(max(errs["heights"], errs["positions"]), TOL_POS, f"{what}: card vs CPU")
        hold(errs["uvs"], TOL_UV, f"{what}: card vs CPU uvs")


# -- preprocess path -------------------------------------------------------------

# the sources are made in numpy from this seed (a small noise on the analytic
# fields), then quantized as the file the loader stands in for would be
PRE_SEED = 10
# the bench.py planar geometry: an 8192^2 16-bit height source and a 4096^2
# Rgba8 albedo over lods 0-4 of 512^2 tiles (341 tiles, a finest mosaic of
# 8128^2); six 2048^2 planet faces over lods 0-2 (126 tiles)
PRE_SOURCE, PRE_ALBEDO, PRE_FACE = 8192, 4096, 2048
PRE_ATLAS = 512
# one deeper dataset from the same height source, device path only: lods
# 0-5 (1365 tiles), its device memory peak held under the memory check's plan
PRE_DEEP_LODS, PRE_DEEP_ATLAS = 6, 1536
# the JAX package's yardstick for its full device path against its host path
# (tests/test_preprocess_device.py:189-203): at most 1 unit, on under 2% of
# the texels; host and delta read-back are byte-exact
TOL_PRE_UNITS, TOL_PRE_SHARE = 1, 0.02
# median |streamed height - analytic field| on the bench terrain: 1% of its
# 250 m range (tests/test_preprocess.py holds 2.5 m on a 100 m terrain)
TOL_PRE_FIELD = 2.5
# the Preprocessor's phase methods: on the card the device ones are timed with
# CUDA events, every phase with the host clock too
PRE_PHASES = {"_split_device": "split", "_split_host": "split",
              "_downsample_device": "downsample", "_downsample_host": "downsample",
              "_stitch_device": "stitch", "_stitch_delta": "stitch", "_stitch_host": "stitch",
              "_read_back": "read-back", "_drain_saves": "save", "_pump_saves": "save"}
PRE_DEVICE_PHASES = {"_split_device", "_downsample_device", "_stitch_device", "_stitch_delta",
                     "_read_back"}


def timed_preprocessor(atlas, **kw):
    """The port's ``Preprocessor`` with its phases timed (CUDA events around
    the device ones on a card, the host clock around all) and the bytes of
    its uploads (sources, prior tiles, delta stacks; not the few index
    tables) and read-backs counted."""
    import numpy as np
    import torch

    from bevy_terrain_tpu_torch.preprocess import Preprocessor

    def timed(name):
        base, phase = getattr(Preprocessor, name), PRE_PHASES[name]

        def call(self, *a, **k):
            if phase in self.open_phases:  # the drain's own pumps: in the drain's time
                return base(self, *a, **k)
            self.open_phases.add(phase)
            self.ran.add(phase)
            events = self.atlas.device.type == "cuda" and name in PRE_DEVICE_PHASES
            if events:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            try:
                out = base(self, *a, **k)
                if name == "_read_back":
                    self.d2h += out.nbytes
                return out
            finally:
                self.host_s[phase] += time.perf_counter() - t0
                if events:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    self.spans[phase].append((start, end))
                self.open_phases.discard(phase)
        return call

    class Timed(Preprocessor):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.spans = {p: [] for p in set(PRE_PHASES.values())}
            self.host_s = dict.fromkeys(self.spans, 0.0)
            self.h2d = self.d2h = 0
            self.open_phases, self.ran = set(), set()
            self.planned = 0  # the memory check's highest planned peak (allocated + plan)

        def planned_device_bytes(self, dataset, source_shape):
            need = super().planned_device_bytes(dataset, source_shape)
            if self.atlas.device.type == "cuda":
                self.planned = max(self.planned, torch.cuda.memory_allocated() + need)
            return need

        def _upload(self, array):
            self.h2d += np.asarray(array).size * 4
            return super()._upload(array)

    for name in PRE_PHASES:
        setattr(Timed, name, timed(name))
    return Timed(atlas, **kw)


def preprocess_run(what: str, atlas, queue, tiles: int, card: str, **kw):
    """One ``Preprocessor`` run over ``queue(preprocessor)``; prints its
    ``preprocess:`` line and returns (wall s, preprocessor)."""
    import torch

    pre = timed_preprocessor(atlas, **kw)
    on_card = atlas.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    queue(pre).run(verbose=False)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    path = ("device " + pre.readback) if pre.device else "host"
    phases = []
    for p in ("split", "downsample", "stitch", "read-back", "save"):
        if p not in pre.ran:
            continue
        if pre.spans[p]:
            ms = sum(s.elapsed_time(e) for s, e in pre.spans[p])
            phases.append(f"{p} {ms:.1f} ms (events; host {pre.host_s[p] * 1e3:.1f})")
        else:
            phases.append(f"{p} {pre.host_s[p] * 1e3:.1f} ms (host)")
    peak = (torch.cuda.max_memory_allocated() - base) / 1e6 if on_card else 0.0
    plan = f" (planned {(pre.planned - base) / 1e6:.1f})" if pre.planned else ""
    print(f"preprocess: {what} [{path}]: {tiles} tiles in {wall:.3f} s = {tiles / wall:.1f} "
          f"tiles/s; {', '.join(phases)}; H2D {pre.h2d / 1e6:.1f} MB, D2H {pre.d2h / 1e6:.1f} "
          f"MB; device memory peak {peak:.1f} MB above the atlas{plan}; {card}")
    if pre.planned and peak * 1e6 > pre.planned - base:
        raise AssertionError(f"{what}: the device memory peak {peak:.1f} MB is above the "
                             f"memory check's plan {(pre.planned - base) / 1e6:.1f} MB")
    return wall, pre


def tile_files(root: Path, path: str, name: str) -> dict:
    return {p.name: p.read_bytes()
            for p in sorted((Path(root) / path / "data" / name).glob("*.bin"))}


def hold_full_path(got: dict, want: dict, dtype, what: str) -> float:
    """Every tile of the full device path within TOL_PRE_UNITS of the host
    path's, on under TOL_PRE_SHARE of its texels. Returns the share of
    texels that differ."""
    import numpy as np

    if not want or set(got) != set(want):
        raise AssertionError(f"{what}: the device path wrote {len(got)} tiles, the host "
                             f"path {len(want)}")
    worst, flipped, total = 0, 0, 0
    for name in want:
        d = np.abs(np.frombuffer(got[name], dtype).astype(np.int64)
                   - np.frombuffer(want[name], dtype).astype(np.int64))
        worst = max(worst, int(d.max()))
        flipped += int((d != 0).sum())
        total += d.size
        if d.max() > TOL_PRE_UNITS or (d != 0).mean() >= TOL_PRE_SHARE:
            raise AssertionError(f"{what}: tile {name} off the host path by up to "
                                 f"{int(d.max())} on {(d != 0).mean():.2%} of its texels")
    share = flipped / total
    print(f"{what}: full device path vs host path over {len(want)} tiles: max {worst} "
          f"unit(s), {flipped} of {total} texels differ ({share:.6%}; yardstick <= "
          f"{TOL_PRE_UNITS} on < {TOL_PRE_SHARE:.0%})")
    return share


def kit_source():
    """The interchange fixture's source as load_source_image returns its
    16-bit PNG (no PNG is read): (H, W, 1) f32 in [0, 1]."""
    import numpy as np

    from bevy_terrain_tpu_torch.utils.synthetic import INTERCHANGE as KIT, interchange_source

    return interchange_source(KIT["source_size"])[..., None].astype(np.float32) / 65535.0


def kit_config(root: Path):
    """The interchange fixture's TerrainConfig over ``root``."""
    import numpy as np

    from bevy_terrain_tpu_torch import (
        AttachmentConfig, AttachmentFormat, TerrainConfig, TerrainModel,
    )
    from bevy_terrain_tpu_torch.utils.synthetic import INTERCHANGE as KIT

    return TerrainConfig(
        lod_count=KIT["lod_count"],
        model=TerrainModel.planar(np.zeros(3), KIT["terrain_size"], 0.0, KIT["height"]),
        atlas_size=32, path=KIT["path"], assets_root=str(root),
    ).add_attachment(AttachmentConfig(
        name="height", texture_size=KIT["texture_size"],
        border_size=KIT["border_size"], mip_level_count=KIT["mip_count"],
        format=AttachmentFormat.R16))


def kit_run(what: str, root: Path, card: str, **kw):
    """One preprocess run of the interchange fixture into ``root``; returns
    (the preprocessor, its files: config.tc and the tiles, by name)."""
    from bevy_terrain_tpu_torch import PreprocessDataset
    from bevy_terrain_tpu_torch.terrain_data import TileAtlas
    from bevy_terrain_tpu_torch.utils.synthetic import INTERCHANGE as KIT

    source, lods = kit_source(), KIT["lod_count"]
    _, pre = preprocess_run(
        f"{what} ({source.shape[0]}^2 R16 source, lods 0-{lods - 1}"
        + (", batch_tiles=3)" if "batch_tiles" in kw else ")"),
        TileAtlas(kit_config(root), "cuda"),
        lambda p: p.clear_attachment(0).preprocess_tile(PreprocessDataset(
            attachment_index=0, path="height.png", lod_range=range(0, lods))),
        21, card, loader=lambda p, cfg: source, **kw)
    out = {"config.tc": (root / KIT["path"] / "config.tc").read_bytes()}
    for name, data in tile_files(root, KIT["path"], "height").items():
        out[f"data/height/{name}"] = data
    return pre, out


def kit_expected() -> dict:
    """The committed sha256 of the fixture's files (tools/interchange_expected.json,
    read as data), by the names :func:`kit_run` gives them."""
    from bevy_terrain_tpu_torch.utils.synthetic import INTERCHANGE as KIT

    expected = json.loads((ROOT / "tools" / "interchange_expected.json").read_text())
    prefix = f"assets/{KIT['path']}/"
    return {k[len(prefix):]: v for k, v in expected.items() if k.startswith(prefix)}


def kit_matches(files: dict) -> int:
    """How many of the committed sha256 ``files`` reproduces; raises unless
    all and no other file."""
    want = kit_expected()
    got = {k: hashlib.sha256(v).hexdigest() for k, v in files.items()}
    bad = sorted(k for k in want if got.get(k) != want[k])
    if bad or set(got) != set(want):
        raise AssertionError(f"interchange fixture: hashes differ for {bad}")
    return len(want)


def interchange_preprocess(card: str) -> None:
    """The interchange fixture (utils/synthetic.INTERCHANGE, its hashes in
    tools/interchange_expected.json) on ``TileAtlas(config, "cuda")``:
    the host path and the delta read-back reproduce the committed sha256 of
    config.tc and the 21 tiles; ``device=None`` selects the device path with
    the full read-back, which holds its yardstick."""
    import numpy as np

    from bevy_terrain_tpu_torch.utils import transfer

    what = "interchange fixture"
    files = {}
    transfer._reset_probe()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kit_") as tmp:
        for path, kw in (("host", dict(device=False)), ("full", {}),
                         ("full, 3-tile chunks", dict(batch_tiles=3)),
                         ("delta", dict(device=True, readback="delta"))):
            pre, files[path] = kit_run(what, Path(tmp) / path, card, **kw)
            if path == "full":
                # the device type decides: no transfer probe ran
                probed = sorted(transfer._D2H_S) + sorted(transfer._DISPATCH_S)
                print(f"{what}: Preprocessor(TileAtlas(config, 'cuda')) selected device="
                      f"{pre.device}, readback {pre.readback!r}, probes consulted "
                      f"{probed or 'none'}; then measured: 1 MB read-back "
                      f"{transfer.d2h_seconds('cuda') * 1e3:.3f} ms (limit "
                      f"{transfer._THRESHOLD_S * 1e3:.0f}), launch + sync "
                      f"{transfer.dispatch_seconds('cuda') * 1e3:.3f} ms (limit "
                      f"{transfer._DISPATCH_THRESHOLD_S * 1e3:.0f}); {card}")
                if pre.device is not True or pre.readback != "full" or probed:
                    raise AssertionError("the Preprocessor on the card did not select the "
                                         "device path with the full read-back by the "
                                         "device type alone")
            if kw.get("batch_tiles") and pre.batch_tiles != 3:
                raise AssertionError(f"{what}: batch_tiles {pre.batch_tiles}, not 3")
    for path in ("host", "delta"):
        n = kit_matches(files[path])
        print(f"{what} [{path}]: {n} of {n} committed sha256 reproduced")
    if files["full, 3-tile chunks"] != files["full"]:
        raise AssertionError(f"{what}: batch_tiles=3 wrote other bytes than the default")
    print(f"{what}: batch_tiles=3 (3-tile stitch chunks) wrote the default's bytes")
    if files["full"].pop("config.tc") != files["host"].pop("config.tc"):
        raise AssertionError(f"{what}: the full device path's config.tc differs")
    hold_full_path(files["full"], files["host"], np.uint16, what)


def planar_sources():
    """The 8192^2 height source (default_height_fn) and the 4096^2 Rgba8
    albedo (default_color_fn, channel 0 non-zero), as (H, W, C) f32 in
    [0, 1] quantized to their 16 and 8 bits, a seeded noise under the height."""
    import numpy as np

    from bevy_terrain_tpu_torch.utils.synthetic import default_color_fn

    a = PRE_ALBEDO
    y = (np.arange(a) + 0.5) / a
    u, v = np.meshgrid(y, y, indexing="xy")
    albedo = (np.rint(np.clip(default_color_fn(u, v), 0, 1) * 255.0) / 255.0).astype(np.float32)
    return planar_height_source(), albedo


def planar_height_source():
    """The 8192^2 height source of :func:`planar_sources`."""
    import numpy as np

    from bevy_terrain_tpu_torch.utils.synthetic import default_height_fn

    rng = np.random.default_rng(PRE_SEED)
    n = PRE_SOURCE
    x = ((np.arange(n) + 0.5) / n).astype(np.float32)
    height = np.empty((n, n, 1), np.float32)
    for r in range(0, n, 1024):  # in bands: a few hundred MB at a time
        u, v = np.meshgrid(x, x[r:r + 1024], indexing="xy")
        h = default_height_fn(u, v) + 1e-4 * rng.standard_normal(u.shape, np.float32)
        height[r:r + 1024, :, 0] = np.clip(np.rint(h * 65535.0), 1, 65535) / np.float32(65535.0)
    return height


def planar_preprocess_path(card: str) -> dict:
    """The bench geometry preprocessed on the card and on the host, every
    tile held to the yardstick; then the device-made dataset streamed
    through ``Terrain(config).update`` under the bench camera (K1 every
    frame, heights against the analytic field) and lit with the smoke
    StandardMaterial over the preprocessed albedo (K4 every frame)."""
    import numpy as np
    import torch

    from bevy_terrain_tpu_torch import PreprocessDataset, Terrain
    from bevy_terrain_tpu_torch.config import (
        AttachmentConfig, AttachmentFormat, TerrainConfig, TerrainViewConfig,
    )
    from bevy_terrain_tpu_torch.ops import kernels
    from bevy_terrain_tpu_torch.render import material
    from bevy_terrain_tpu_torch.terrain_data import TileAtlas
    from bevy_terrain_tpu_torch.utils.synthetic import default_height_fn

    what = "planar preprocess path"
    model, vc, view, view_proj = bench_scene()
    kw = dict(texture_size=TEXTURE_SIZE, border_size=BORDER, mip_level_count=4)
    atts = (AttachmentConfig(name="height", **kw),
            AttachmentConfig(name="albedo", format=AttachmentFormat.RGBA8, **kw))
    t0 = time.perf_counter()
    height, albedo = planar_sources()
    sources = {"height.png": height, "albedo.png": albedo}
    print(f"{what}: made a {PRE_SOURCE}^2 R16 height source and a {PRE_ALBEDO}^2 Rgba8 albedo "
          f"(seed {PRE_SEED}) in {time.perf_counter() - t0:.1f} s")
    lods = range(0, LOD_COUNT)
    datasets = [PreprocessDataset(attachment_index=i, path=p, lod_range=lods)
                for i, p in enumerate(sources)]
    tiles = sum(1 << (2 * lod) for lod in lods)
    counts = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pre_") as tmp:
        configs = {}
        for path, dev_kw in (("host", dict(device=False)), ("device", dict(device=True))):
            config = TerrainConfig(lod_count=LOD_COUNT, model=model, atlas_size=PRE_ATLAS,
                                   path="pre", attachments=atts,
                                   assets_root=str(Path(tmp) / path))
            atlas = TileAtlas(config, "cuda")
            for ds, att in zip(datasets, atts):
                def queue(p, ds=ds):
                    if ds.attachment_index == 0:
                        p.clear_attachment(0).clear_attachment(1)
                    return p.preprocess_tile(ds)

                preprocess_run(f"{what}, {att.name} ({att.format.value}, lods 0-{LOD_COUNT - 1})",
                               atlas, queue, tiles, card,
                               loader=lambda p, cfg: sources[p], **dev_kw)
            configs[path] = config
        for att in atts:
            hold_full_path(tile_files(Path(tmp) / "device", "pre", att.name),
                           tile_files(Path(tmp) / "host", "pre", att.name),
                           att.format.dtype, f"{what}, {att.name}")
        deep = dataclasses.replace(configs["device"], lod_count=PRE_DEEP_LODS,
                                   atlas_size=PRE_DEEP_ATLAS, attachments=atts[:1],
                                   assets_root=str(Path(tmp) / "deep"))
        preprocess_run(
            f"{what}, height (R16, lods 0-{PRE_DEEP_LODS - 1}, device path only)",
            TileAtlas(deep, "cuda"),
            lambda p: p.clear_attachment(0).preprocess_tile(PreprocessDataset(
                attachment_index=0, path="height.png", lod_range=range(0, PRE_DEEP_LODS))),
            sum(1 << (2 * lod) for lod in range(PRE_DEEP_LODS)), card,
            loader=lambda p, cfg: sources[p], device=True)

        config = dataclasses.replace(configs["device"], atlas_size=1024)
        terrain = Terrain(config)
        if terrain.device.type != "cuda":
            raise AssertionError(f"Terrain(config) runs on {terrain.device}, not the card")
        terrain.add_view("cam", TerrainViewConfig(tile_capacity=vc.tile_capacity),
                         queue_capacity=1024, culling=True)
        swhat = f"{what}, streamed"
        out, counts["mesh_fused_planar"], walls = stream(
            terrain, view, view_proj, "mesh_fused_planar", swhat, timed=5)
        n = out.tile_count
        if n <= 0 or out.overflow != 0:
            raise AssertionError(f"{swhat}: tile_count {n}, overflow {out.overflow}")
        mesh = out.mesh
        for field in ("heights", "positions", "uvs"):
            if not bool(torch.isfinite(getattr(mesh, field)).all()):
                raise AssertionError(f"{swhat}: non-finite {field}")
        compare(out.raw_mesh, kernels.mesh_fused_planar_reference(*out.mesh_inputs),
                f"{swhat}, last frame")
        pos = mesh.positions[:n].double().cpu().numpy()
        field = default_height_fn(pos[..., 0] / SIDE + 0.5, pos[..., 2] / SIDE + 0.5)
        err = np.abs(pos[..., 1] - (model.min_height + field * (model.max_height
                                                                 - model.min_height)))
        print(f"{swhat}: {n} tiles; |height - analytic field| median {np.median(err):.4f} m, "
              f"99th percentile {np.percentile(err, 99):.4f} m, max {err.max():.4f} m "
              f"(median limit {TOL_PRE_FIELD} m)")
        if not np.median(err) < TOL_PRE_FIELD:
            raise AssertionError(f"{swhat}: heights off the analytic field")

        lwhat = f"{what}, lit"
        terrain.set_shading(smoke_material(material), sample_attachments=(1,))
        out, counts["mesh_fused_shaded"], _ = stream(
            terrain, view, view_proj, "mesh_fused_shaded", lwhat,
            absent=("mesh_fused_planar",), timed=5)
        n = out.tile_count
        colors = out.colors
        if not (n > 0 and bool(torch.isfinite(colors).all())
                and float(colors[:n, ..., :3].max()) > 0.0):
            raise AssertionError(f"{lwhat}: colours not finite or all dark")
        want = kernels.mesh_fused_shaded_reference(*out.mesh_inputs)
        cerr = float((out.raw_mesh[:, 6:] - want[:, 6:]).abs().max())
        print(f"{lwhat}: {n} tiles, max |kernel - plain| colours {cerr:.3e} (tol "
              f"{TOL_ALB_FAST:.1e})")
        if not cerr <= TOL_ALB_FAST:
            raise AssertionError(f"{lwhat}: shaded colours disagree with the plain version")
        compare(out.raw_mesh[:, :6], kernels.mesh_fused_planar_reference(*out.mesh_inputs[:6]),
                f"{lwhat}, last frame mesh")
    return counts


def planet_faces():
    """Six 2048^2 16-bit face sources of default_sphere_height_fn over each
    cube side's uv, with a seeded noise."""
    import numpy as np

    from bevy_terrain_tpu_torch.math.coordinate import local_position_from_side_uv
    from bevy_terrain_tpu_torch.utils.synthetic import default_sphere_height_fn

    rng = np.random.default_rng(PRE_SEED + 1)
    n = PRE_FACE
    x = (np.arange(n) + 0.5) / n
    uv = np.stack(np.meshgrid(x, x, indexing="xy"), axis=-1)
    faces = []
    for side in range(6):
        h = default_sphere_height_fn(local_position_from_side_uv(side, uv))
        h = h + 1e-4 * rng.standard_normal(h.shape)
        faces.append((np.clip(np.rint(h * 65535.0), 1, 65535) / 65535.0)
                     .astype(np.float32)[..., None])
    return faces


def planet_preprocess_path(card: str) -> dict:
    """Six seeded faces preprocessed with ``preprocess_spherical`` (lods
    0-2 of 512^2, cross-face stitched) on the card and on the host, every
    tile held to the yardstick; then streamed at the 60 km Earth camera (K2
    every frame)."""
    import torch

    from bevy_terrain_tpu_torch import SphericalDataset, Terrain
    from bevy_terrain_tpu_torch.config import AttachmentConfig, TerrainConfig, TerrainViewConfig
    from bevy_terrain_tpu_torch.ops import kernels
    from bevy_terrain_tpu_torch.terrain_data import TileAtlas

    what = "planet preprocess path"
    model = sphere_model("sphere")
    view, view_proj = sphere_view(model)
    att = AttachmentConfig(name="height", texture_size=TEXTURE_SIZE, border_size=BORDER,
                           mip_level_count=4)
    t0 = time.perf_counter()
    faces = planet_faces()
    print(f"{what}: made six {PRE_FACE}^2 R16 face sources (seed {PRE_SEED + 1}) in "
          f"{time.perf_counter() - t0:.1f} s")
    lods = range(0, SPH_DATA_LODS)
    dataset = SphericalDataset(attachment_index=0, paths=[str(s) for s in range(6)],
                               lod_range=lods)
    tiles = 6 * sum(1 << (2 * lod) for lod in lods)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pre_planet_") as tmp:
        configs = {}
        for path, dev_kw in (("host", dict(device=False)), ("device", dict(device=True))):
            config = TerrainConfig(lod_count=SPH_LODS, model=model, atlas_size=SPH_ATLAS,
                                   path="planet", attachments=(att,),
                                   assets_root=str(Path(tmp) / path))
            preprocess_run(f"{what} (6 x {PRE_FACE}^2 R16, lods 0-{SPH_DATA_LODS - 1})",
                           TileAtlas(config, "cuda"),
                           lambda p: p.clear_attachment(0).preprocess_spherical(dataset),
                           tiles, card, loader=lambda p, cfg: faces[int(p)], **dev_kw)
            configs[path] = config
        hold_full_path(tile_files(Path(tmp) / "device", "planet", "height"),
                       tile_files(Path(tmp) / "host", "planet", "height"), att.format.dtype,
                       what)
        terrain = Terrain(configs["device"])
        terrain.add_view("cam", TerrainViewConfig(tile_capacity=SPH_CAPACITY),
                         queue_capacity=2048, culling=True)
        swhat = f"{what}, streamed"
        out, launches, _ = stream(terrain, view, view_proj, "mesh_fused_spherical", swhat,
                                  absent=("fetch_resample_cached",), timed=5)
        n = out.tile_count
        if n <= 100 or out.overflow != 0:
            raise AssertionError(f"{swhat}: tile_count {n}, overflow {out.overflow}")
        hmin, hmax = check_sphere_mesh(out.mesh, n, model, swhat)
        if not hmax - hmin > 1000.0:
            raise AssertionError(f"{swhat}: heights [{hmin}, {hmax}] carry no relief")
        compare_spherical(out.raw_mesh, kernels.mesh_fused_spherical_reference(*out.mesh_inputs),
                          f"{swhat}, last frame")
        print(f"{swhat}: {n} tiles, heights [{hmin:.1f}, {hmax:.1f}] m")
        torch.cuda.synchronize()
    return {"mesh_fused_spherical": launches}


def deepest_dataset(card: str) -> None:
    """The deepest planar dataset of 512^2 tiles (border 2) whose full
    read-back fits the card's free memory by ``planned_device_bytes`` (the
    plan its memory check holds it to), R16 and Rgba8, the source at the
    finest lod's resolution."""
    import torch

    from bevy_terrain_tpu_torch import PreprocessDataset, Preprocessor
    from bevy_terrain_tpu_torch.config import AttachmentConfig, AttachmentFormat, TerrainConfig
    from bevy_terrain_tpu_torch.terrain_data import TileAtlas

    free = torch.cuda.mem_get_info()[0]
    model, _, _, _ = bench_scene()
    for fmt in (AttachmentFormat.R16, AttachmentFormat.RGBA8):
        att = AttachmentConfig(name="a", texture_size=512, border_size=2, format=fmt)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_plan_") as tmp:
            pre = Preprocessor(TileAtlas(TerrainConfig(
                lod_count=10, model=model, atlas_size=1, path="plan", attachments=(att,),
                assets_root=tmp), "cpu"), device=False)
        plans = []
        for finest in range(4, 10):
            n = (1 << finest) * att.center_size
            plans.append((finest, pre.planned_device_bytes(
                PreprocessDataset(lod_range=range(0, finest + 1)), (n, n, fmt.channels))))
        fits = [f for f, need in plans if need <= free]
        print(f"preprocess: full read-back plan, one planar {fmt.value} dataset of 512^2 tiles "
              f"from a source at the finest lod's size: "
              + ", ".join(f"lods 0-{f} {need / 1e9:.2f} GB" for f, need in plans)
              + f"; {free / 1e9:.2f} GB free: the deepest that fits is lods 0-"
              f"{max(fits) if fits else None}; {card}")


def preprocess_path_phase() -> dict:
    """The preprocess path (preprocess/, ops/preprocess*.py: torch ops and
    numpy, no kernel of its own) on the card: the interchange fixture, the
    bench geometry with its albedo, the planet; each device-made dataset
    streamed through the mesh kernels. Returns the streams' launches."""
    card = card_line()
    t0 = time.perf_counter()
    interchange_preprocess(card)
    counts = planar_preprocess_path(card)
    counts.update(planet_preprocess_path(card))
    deepest_dataset(card)
    print(f"preprocess path: {time.perf_counter() - t0:.1f} s in all; stream launches {counts}")
    return counts


# -- entry points: the example and tool twins, and the entry() twin --------

# the kernels each entry point must launch (in the count of its run), and
# those it must not; the albedo of examples_torch/planar.py and
# render_capture.py has border 1 (models.albedo_attachment, as in the JAX
# examples), so its patch plan is not the height's and its material is
# staged: K1, the staged sampler and the shade, no K4 and no sampler kernel
_MATERIAL_KERNELS = ("mesh_fused_albedo", "mesh_fused_shaded", "mesh_fused_spherical_albedo",
                     "attach_sample_fused", "attach_sample_fused_packed")
ENTRY_POINTS = {
    # name: (module, argv, kernels required, kernels absent)
    "examples preprocess_planar": ("examples_torch.preprocess_planar", [], (), "all"),
    "examples minimal": ("examples_torch.minimal", [], ("mesh_fused_planar",), _MATERIAL_KERNELS),
    "examples planar": ("examples_torch.planar", [], ("mesh_fused_planar",), _MATERIAL_KERNELS),
    "examples preprocess_spherical": ("examples_torch.preprocess_spherical", [], (), "all"),
    "examples spherical": ("examples_torch.spherical", [], ("mesh_fused_spherical",),
                           _MATERIAL_KERNELS),
    "examples render_capture": ("examples_torch.render_capture", [], ("mesh_fused_planar",),
                                _MATERIAL_KERNELS),
    "tools refine_bench": ("tools_torch.refine_bench", [], (), "all"),
    "tools earth_frame_bench": ("tools_torch.earth_frame_bench", [], ("mesh_fused_spherical",),
                                _MATERIAL_KERNELS),
    "tools flythrough_bench": ("tools_torch.flythrough_bench", ["--device-time"],
                               ("mesh_fused_planar",), _MATERIAL_KERNELS),
    "tools material_frame_bench": ("tools_torch.material_frame_bench", [],
                                   ("mesh_fused_planar", "mesh_fused_albedo", "mesh_fused_shaded",
                                    "attach_sample_fused", "attach_sample_fused_packed"),
                                   ("mesh_fused_spherical", "mesh_fused_spherical_albedo")),
    "tools raster_bench": ("tools_torch.raster_bench", [], ("mesh_fused_planar",),
                           _MATERIAL_KERNELS),
}


def _summary(result: dict) -> str:
    """The numbers of an entry point's returned dict, short."""
    import numpy as np

    def short(v):
        if isinstance(v, float):
            return f"{v:.4g}"
        if isinstance(v, (list, tuple, np.ndarray)) and len(v) > 8:
            v = np.asarray(v)
            if v.dtype.kind not in "biuf":  # rows the call printed itself
                return f"[{len(v)} rows]"
            return f"[{len(v)}: {v.min():.4g}..{v.max():.4g}]"
        if isinstance(v, dict):
            return "{" + ", ".join(f"{k}: {short(x)}" for k, x in v.items()) + "}"
        if isinstance(v, np.ndarray):
            return np.array2string(v, precision=4)
        if isinstance(v, list) and v and isinstance(v[0], Path):
            return "[" + ", ".join(p.name for p in v) + "]"
        return str(v)

    return ", ".join(f"{k} {short(v)}" for k, v in result.items())


def entry_point(what: str, call, need=(), absent=()):
    """Run ``call()`` on the card with the launch counts set to 0 just
    before and read just after: each kernel in ``need`` must have launched,
    none in ``absent`` ("all": no kernel at all). Prints one ``entry:`` line
    (wall seconds, launches, the call's own numbers); returns (result,
    counts)."""
    import torch

    reset_counts()
    t0 = time.perf_counter()
    result = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launched = {k: v for k, v in counts.items() if v}
    print(f"entry: {what}: {wall:.1f} s wall; launches {launched or 'none'}; "
          f"{_summary(result) if isinstance(result, dict) else result}")
    if absent == "all":
        absent = tuple(counts)
    missing = [k for k in need if not counts[k]]
    extra = [k for k in absent if counts[k]]
    if missing or extra:
        raise AssertionError(f"{what}: kernels {missing} did not launch, {extra} must not")
    return result, counts


def entry_points_path() -> None:
    """The ports of the repo's examples and frame bench tools, each
    ``main(argv)`` called in-process on the card at the JAX defaults (the
    examples in one assets directory, as a user runs them in turn), and the
    ``entry()`` twin: launches counted around each call."""
    import importlib

    import numpy as np
    import torch

    from bevy_terrain_tpu_torch.entry import entry

    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_entry_") as tmp:
        for what, (module, argv, need, absent) in ENTRY_POINTS.items():
            if module.startswith("examples_torch."):
                argv = argv + ["--assets", f"{tmp}/assets"]
                if module.endswith("render_capture"):
                    argv += ["--out", f"{tmp}/captures"]
            main = importlib.import_module(module).main
            result, counts = entry_point(what, lambda: main(argv), need, absent)
            if "preprocess" in module and not (result["device_path"]
                                               and result["readback"] == "full"):
                raise AssertionError(f"{what}: the Preprocessor took the host path")
            if module.endswith("minimal") and counts["mesh_fused_planar"] != len(
                    result["tiles"]):
                raise AssertionError(f"{what}: {counts['mesh_fused_planar']} mesh kernel "
                                     f"launches in {len(result['tiles'])} frames")
            if module.endswith(".spherical") and counts["mesh_fused_spherical"] != len(
                    result["tiles"]):
                raise AssertionError(f"{what}: {counts['mesh_fused_spherical']} mesh kernel "
                                     f"launches in {len(result['tiles'])} frames")
            if module.endswith("flythrough_bench"):
                if result["overflow_frames"] != 0 or result["tiles_loaded"] <= 0:
                    raise AssertionError(f"{what}: overflow frames "
                                         f"{result['overflow_frames']}, tiles loaded "
                                         f"{result['tiles_loaded']}")
                if result["backend"] != torch.cuda.get_device_name(0):
                    raise AssertionError(f"{what}: backend {result['backend']}")
            if module.endswith("render_capture"):
                for path in result["images"]:
                    img = (np.load(path) if path.suffix == ".npy" else None)
                    if img is not None and img.shape != (512, 512, 4):
                        raise AssertionError(f"{what}: image {path} is {img.shape}")

        def run_entry():
            fn, args = entry()
            positions, heights, count = fn(*args)
            if not (positions.is_cuda and positions.dim() == 3 and positions.shape[-1] == 3
                    and heights.shape == positions.shape[:2] and int(count) > 0
                    and bool(torch.isfinite(positions).all())):
                raise AssertionError("entry(): the frame is not finite (F, V, 3) on the card")
            return {"positions": tuple(positions.shape), "tile_count": int(count)}

        entry_point("bevy_terrain_tpu_torch.entry.entry()", run_entry, (), "all")
    print(f"entry points path: {time.perf_counter() - t_all:.1f} s in all; {card_line()}")


# -- multi-view path (parallel/) ------------------------------------------------

# four distinct cameras over the planar main path's 8k^2 dataset. A
# MultiViewTerrain packs no view projection, so its frames are unculled:
# these heights keep each under the main path's capacity of 4096 (2401,
# 2983, 2887 and 2455 tiles at the scene's mean height; 8000+ at the bench
# camera's 120 m)
MV_VIEWS = {"v0": (240.0, 700.0, -160.0), "v1": (-880.0, 500.0, 560.0),
            "v2": (1500.0, 500.0, 900.0), "v3": (-2000.0, 600.0, -1500.0)}
MV_TIMED = 10
TOL_MV_STAGED = 2e-2  # m: the fused-vs-staged yardstick (tests/test_multi_view.py:150-161)
# the planet's two views, (direction, altitude m); unculled, the default
# morph distance needs 11 000-14 000 tiles a view, so the view config halves
# it (2976 and 3918 tiles at the mean height) under 8192 slots
MV_PLANET = {"far": ((0.0, 0.0, 1.0), 60_000.0), "near": ((0.3, 0.2, 1.0), 20_000.0)}
MV_PLANET_VIEW = dict(tile_capacity=8192, morph_distance=8.0)
_MESH_KERNELS = tuple(k for k, *_ in KERNELS if k.startswith("mesh_fused"))
# the tool twins of the multi-view slice: (module, argv, kernels required,
# kernels absent), as ENTRY_POINTS
MV_TOOLS = {
    "tools multi_view_bench": ("tools_torch.multi_view_bench", [], ("mesh_fused_planar",),
                               _MATERIAL_KERNELS + ("fetch_resample_cached", "fetch_resample")),
    "tools fetch_kernel_sweep": ("tools_torch.fetch_kernel_sweep", [], ("fetch_resample",),
                                 _MESH_KERNELS + ("fetch_resample_cached",)),
    "tools census_frame": ("tools_torch.census_frame", [], ("fetch_resample_cached",),
                           _MESH_KERNELS + ("fetch_resample",)),
    "tools earth_census": ("tools_torch.earth_census", [], ("mesh_fused_spherical",),
                           _MATERIAL_KERNELS + ("fetch_resample_cached", "fetch_resample")),
    "tools preprocess_compute_bench": ("tools_torch.preprocess_compute_bench", [], (), "all"),
}


def mv_stream(terrain, positions, timed: int = 0):
    """Stream a MultiViewTerrain (or a Terrain with the same views) until no
    tile is queued or loading, then ``timed`` frames, each synchronized.
    Returns (last outputs, frames, update walls in s of the timed frames)."""
    import torch

    frames = 0
    for i in range(300):
        out = terrain.update(positions)
        frames += 1
        if i > 3 and not terrain.atlas.state.to_load and not any(
                a.loading for a in terrain.atlas.attachments):
            break
    torch.cuda.synchronize()
    walls = []
    for _ in range(timed):
        t0 = time.perf_counter()
        out = terrain.update(positions)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        frames += 1
    return out, frames, walls


def frame_sha(tiles, mesh) -> str:
    """sha256 of a view's sorted tile list and grid mesh, field by field."""
    h = hashlib.sha256()
    for obj in (tiles, mesh):
        for f in dataclasses.fields(obj):
            x = getattr(obj, f.name)
            h.update(f"{f.name} {x.dtype} {tuple(x.shape)}".encode())
            h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def mv_same_as_terrain(mvt, positions, what: str) -> "object":
    """A Terrain with the same views over the multi-view terrain's atlas,
    streamed; then one frame of each: every view's sha256 of tiles and mesh
    must be equal, and the mesh kernel's product of each view is held
    against its plain version on the same inputs (the multi-view path's own
    tile counts and capacity). Returns the Terrain."""
    from bevy_terrain_tpu_torch import Terrain
    from bevy_terrain_tpu_torch.ops import kernels

    ref = Terrain(mvt.config)  # the card by default
    ref.atlas = mvt.atlas  # the same residency, so the same atlas slots
    for v in positions:
        ref.add_view(v, mvt.view_config, queue_capacity=mvt.cfg.queue_capacity)
    mv_stream(ref, positions)
    outs, routs = mvt.update(positions), ref.update(positions)
    for v in positions:
        a = frame_sha(outs[v].tiles, outs[v].mesh)
        b = frame_sha(routs[v].tiles, routs[v].mesh)
        print(f"multi_view: {what} {v}: {outs[v].tile_count} tiles, sha256 {a[:16]} "
              f"(Terrain {b[:16]})")
        if a != b:
            raise AssertionError(f"{what} {v}: the multi-view frame is not the single-view "
                                 "Terrain's")
        if mvt.cfg.spherical:
            compare_spherical(routs[v].raw_mesh,
                              kernels.mesh_fused_spherical_reference(*routs[v].mesh_inputs),
                              f"multi_view: {what} {v}")
        else:
            compare(routs[v].raw_mesh, kernels.mesh_fused_planar_reference(*routs[v].mesh_inputs),
                    f"multi_view: {what} {v}")
    return ref


def mv_per_key(got, want, what: str) -> dict:
    """Tile sets equal; heights and positions per tile key within
    TOL_MV_STAGED. Returns the largest differences."""
    import torch

    n = got.tile_count
    if n != want.tile_count:
        raise AssertionError(f"{what}: {n} tiles against {want.tile_count}")

    def keys(tiles):
        t = torch.cat([tiles.tile_side[:n, None], tiles.tile_lod[:n, None], tiles.tile_xy[:n]],
                      dim=1).long()
        k = ((t[:, 0] * 64 + t[:, 1]) * 2**24 + t[:, 2]) * 2**24 + t[:, 3]
        order = torch.argsort(k)
        return k[order], order

    ka, ia = keys(got.tiles)
    kb, ib = keys(want.tiles)
    if not torch.equal(ka, kb):
        raise AssertionError(f"{what}: the tile sets differ")
    worst = {}
    for f in ("heights", "positions"):
        worst[f] = float((getattr(got.mesh, f)[:n][ia] - getattr(want.mesh, f)[:n][ib])
                         .abs().max())
        hold(worst[f], TOL_MV_STAGED, f"{what}: {f}")
    return worst


def multi_view_path() -> dict:
    """parallel/ on the card: MultiViewTerrain over the planar main path's
    dataset (replicated: K1 once per view per frame, each view bit-equal to
    a Terrain with the same views over the same atlas, walls and device
    time; sharded: no mesh kernel, within the fused-vs-staged yardstick),
    then one rank of an NCCL group over that dataset
    (``multi_card_path(1)``), over the synthetic planet (K2 once per view,
    bit-equal), the spherical multi_view_frame_step (no kernel), then
    ``dryrun_multichip(4)`` and the slice's tool twins with their kernels
    counted. Returns the NCCL rank's launches by kernel over its whole run
    (``multi_card_path``)."""
    import importlib

    import numpy as np
    import torch

    from bevy_terrain_tpu_torch.config import AttachmentConfig, TerrainConfig, TerrainViewConfig
    from bevy_terrain_tpu_torch.entry import dryrun_multichip, sphere_views
    from bevy_terrain_tpu_torch.parallel import MultiViewTerrain, multi_view_frame_step
    from bevy_terrain_tpu_torch.utils.synthetic import (
        generate_planar_dataset, generate_spherical_dataset,
    )
    t_all = time.perf_counter()
    card = card_line()
    model, vc, _, _ = bench_scene()
    att = AttachmentConfig(name="height", texture_size=TEXTURE_SIZE, border_size=BORDER,
                           mip_level_count=4)
    positions = {v: np.array(p) for v, p in MV_VIEWS.items()}
    V = len(positions)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mv_") as tmp:
        t0 = time.perf_counter()
        generate_planar_dataset("smoke", LOD_COUNT, att, root=tmp)
        print(f"multi_view: wrote the planar dataset in {time.perf_counter() - t0:.1f} s")
        config = TerrainConfig(lod_count=LOD_COUNT, model=model, atlas_size=1024,
                               path="smoke", attachments=(att,), assets_root=tmp)
        view_config = TerrainViewConfig(tile_capacity=vc.tile_capacity)

        # 1. planar, replicated: the fused mesh kernel once per view
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mvt = MultiViewTerrain(config, list(positions), view_config=view_config,
                               queue_capacity=1024)
        torch.cuda.synchronize()
        atlas_bytes = torch.cuda.memory_allocated() - base
        store = tensor_bytes(mvt.atlas.attachments[0].block_array)
        if not (mvt.cfg.pallas_sampling and mvt.device.type == "cuda"):
            raise AssertionError("MultiViewTerrain did not select the fused kernel on the card")
        reset_counts()
        t0 = time.perf_counter()
        outs, frames, walls = mv_stream(mvt, positions, timed=MV_TIMED)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() - base
        tiles = [outs[v].tile_count for v in positions]
        overflow = [int(outs[v].tiles.overflow) for v in positions]
        print(f"multi_view: planar replicated: {V} views, {frames} frames in "
              f"{time.perf_counter() - t0:.1f} s, launches {counts}; tiles {tiles}, overflow "
              f"{overflow}; update {statistics.median(walls) * 1e3:.3f} ms median wall over "
              f"{MV_TIMED} frames ({min(walls) * 1e3:.3f}-{max(walls) * 1e3:.3f}); stacked blob "
              f"{tuple(mvt.terrain.last_stacked.shape)} int32, "
              f"{tensor_bytes(mvt.terrain.last_stacked)} bytes "
              f"a frame in one copy; device memory peak {peak / 1e6:.1f} MB over the atlas's "
              f"{atlas_bytes / 1e6:.1f} MB (block store {store / 1e6:.1f} MB, held once)")
        if counts["mesh_fused_planar"] != V * frames or any(
                counts[k] for k in counts if k != "mesh_fused_planar"):
            raise AssertionError(f"planar replicated: K1 must launch {V} times in each of "
                                 f"{frames} frames, and nothing else: {counts}")
        if min(tiles) <= 0 or any(overflow):
            raise AssertionError(f"planar replicated: tiles {tiles}, overflow {overflow}")
        if peak - atlas_bytes >= store:
            raise AssertionError("planar replicated: the frame held a second block store")
        for v in positions:
            mesh = outs[v].mesh
            n = outs[v].tile_count
            if not all(bool(torch.isfinite(getattr(mesh, f)[:n]).all())
                       for f in ("heights", "positions", "uvs")):
                raise AssertionError(f"planar replicated {v}: non-finite mesh")
        ref = mv_same_as_terrain(mvt, positions, "planar replicated")
        print(f"multi_view: planar replicated checked in {time.perf_counter() - t_all:.1f} s")

        # the update wall per view count: the Terrain steps 1, 2 or 4 of the
        # views (one blob copy each), the MultiViewTerrain all 4 (one copy)
        def wall(terrain, pos, n=MV_TIMED):
            ts = []
            for _ in range(n):
                t0 = time.perf_counter()
                terrain.update(pos)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
            return statistics.median(ts) * 1e3

        sub = {k: dict(list(positions.items())[:k]) for k in (1, 2, V)}
        turns = [wall(mvt, positions), wall(ref, positions), wall(ref, positions),
                 wall(mvt, positions)]
        per_count = {k: wall(ref, p) for k, p in sub.items()}
        print(f"multi_view: planar update wall in turns, MultiViewTerrain ({V} views) / "
              f"Terrain ({V} views) / Terrain / MultiViewTerrain: "
              + " / ".join(f"{t:.3f}" for t in turns) + " ms; Terrain with "
              + ", ".join(f"{k} view{'s' if k > 1 else ''} {t:.3f}"
                          for k, t in per_count.items()) + f" ms; {card}")
        for what, fn in (("MultiViewTerrain 4 views", lambda: mvt.update(positions)),
                         ("Terrain 1 view", lambda: ref.update(sub[1]))):
            total, rows = device_breakdown(fn, label=what)
            k1 = next((r for r in rows if "mesh_fused" in r[0]), None)
            print(f"multi_view: planar {what}: device kernel time {total:.4f} ms a frame, "
                  f"{sum(r[1] for r in rows)} kernels a frame; K1 {k1[1] if k1 else 0} "
                  f"launches, {k1[2] if k1 else 0:.4f} ms in all; {card}")
        del ref

        # 2. planar, the block store in 4 shards: the staged path, no kernel
        smvt = MultiViewTerrain(config, list(positions), view_config=view_config,
                                queue_capacity=1024, shard_atlas=True, blend_per_vertex=True)
        reset_counts()
        souts, sframes, swalls = mv_stream(smvt, positions, timed=3)
        counts = read_counts()
        shards = smvt.terrain.blocks()
        print(f"multi_view: planar sharded: {sframes} frames, launches {counts}; shards "
              f"{tuple(shards.shape)}, a view of the store: "
              f"{shards.data_ptr() == smvt.atlas.attachments[0].block_array.data_ptr()}; "
              f"update {statistics.median(swalls) * 1e3:.3f} ms median wall")
        if any(counts.values()) or smvt.cfg.pallas_sampling or shards.shape[0] != V:
            raise AssertionError(f"planar sharded: kernels launched {counts}, or not {V} "
                                 "shards on the staged path")
        for v in positions:
            worst = mv_per_key(souts[v], outs[v], f"planar sharded {v}")
            print(f"multi_view: planar sharded {v} vs replicated: {souts[v].tile_count} "
                  f"tiles, max |staged - fused| " + ", ".join(
                      f"{k} {x:.3e}" for k, x in worst.items())
                  + f" (tol {TOL_MV_STAGED:.0e})")
        del mvt, smvt, outs, souts

        # one rank in an NCCL group over the same dataset (multi_card_path)
        rank_launches = multi_card_path(1, root=tmp)

    # 3. the planet: two views, the spherical mesh kernel once per view
    smodel = sphere_model("sphere")
    ppos = {}
    for v, (d, alt) in MV_PLANET.items():
        d = np.array(d) / np.linalg.norm(d)
        ppos[v] = smodel.surface_position(d * RADIUS, alt)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mv_sphere_") as tmp:
        t0 = time.perf_counter()
        generate_spherical_dataset("smoke_sphere", SPH_DATA_LODS, att, root=tmp)
        print(f"multi_view: wrote the planet dataset in {time.perf_counter() - t0:.1f} s")
        config = TerrainConfig(lod_count=SPH_LODS, model=smodel, atlas_size=SPH_ATLAS,
                               path="smoke_sphere", attachments=(att,), assets_root=tmp)
        pmvt = MultiViewTerrain(config, list(ppos),
                                view_config=TerrainViewConfig(**MV_PLANET_VIEW))
        reset_counts()
        pouts, pframes, pwalls = mv_stream(pmvt, ppos, timed=5)
        counts = read_counts()
        ptiles = [pouts[v].tile_count for v in ppos]
        print(f"multi_view: planet: {len(ppos)} views (60 km, 20 km), {pframes} frames, "
              f"launches {counts}; tiles {ptiles}; update "
              f"{statistics.median(pwalls) * 1e3:.3f} ms median wall; {card}")
        if counts["mesh_fused_spherical"] != len(ppos) * pframes or any(
                counts[k] for k in counts if k != "mesh_fused_spherical"):
            raise AssertionError(f"planet: K2 must launch {len(ppos)} times a frame, and "
                                 f"nothing else: {counts}")
        for v in ppos:
            n = pouts[v].tile_count
            if n <= 100 or int(pouts[v].tiles.overflow):
                raise AssertionError(f"planet {v}: {n} tiles, overflow")
            check_sphere_mesh(pouts[v].mesh, n, smodel, f"planet {v}")
        mv_same_as_terrain(pmvt, ppos, "planet")
        del pmvt, pouts

    # 4. multi_view_frame_step: 4 distinct spherical cameras, the per-vertex
    # path (no kernel)
    cfg, uniform_list, slab = sphere_views(4)
    reset_counts()
    step_pos, _, step_counts = multi_view_frame_step([torch.device("cuda")] * 4, cfg,
                                                     uniform_list, slab)
    torch.cuda.synchronize()
    counts = read_counts()
    step_tiles = step_counts.tolist()
    print(f"multi_view: multi_view_frame_step: views {step_pos.shape[0]}, tiles {step_tiles}, "
          f"launches {counts}")
    if (step_pos.shape[0] != 4 or min(step_tiles) <= 0 or any(counts.values())
            or not bool(torch.isfinite(step_pos).all())):
        raise AssertionError("multi_view_frame_step: not 4 finite views of tiles, or a kernel "
                             "launched")

    # 5. the dry run and the slice's tool twins, kernels counted
    entry_point("bevy_terrain_tpu_torch.entry.dryrun_multichip(4)", lambda: dryrun_multichip(4),
                ("mesh_fused_planar",),
                _MATERIAL_KERNELS + ("fetch_resample_cached", "fetch_resample",
                                     "mesh_fused_spherical"))
    for what, (module, argv, need, absent) in MV_TOOLS.items():
        main = importlib.import_module(module).main
        result, counts = entry_point(what, lambda: main(argv), need, absent)
        if module.endswith("multi_view_bench") and not result["multi_view_fused"]:
            raise AssertionError(f"{what}: MultiViewTerrain took the staged path")
        if module.endswith("census_frame") and counts["fetch_resample_cached"] < 2:
            raise AssertionError(f"{what}: K6 did not run in the profiled frames")
    print(f"multi_view path: {time.perf_counter() - t_all:.1f} s in all; {card}")
    return rank_launches



# the multi-card path (parallel/launch.py: one process per card, NCCL): the
# planar multi-view scene of multi_view_path at the production shape (the
# 1024-slot atlas of 512^2 R16 tiles, 86 016 blocks, capacity 4096), one
# view per rank, replicated (K1 on each card) and sharded (the all-gather +
# reduce-scatter exchange, no kernel); with two ranks or more the planet's
# two views on two cards (K2 on each)
MC_PLANET_RANKS = 2
MC_TIMED = 10


def mc_planar_scene(root, views):
    """(TerrainConfig, TerrainViewConfig, positions) of the planar scene."""
    import numpy as np

    from bevy_terrain_tpu_torch.config import AttachmentConfig, TerrainConfig, TerrainViewConfig

    model, vc, _, _ = bench_scene()
    att = AttachmentConfig(name="height", texture_size=TEXTURE_SIZE, border_size=BORDER,
                           mip_level_count=4)
    config = TerrainConfig(lod_count=LOD_COUNT, model=model, atlas_size=1024, path="smoke",
                           attachments=(att,), assets_root=root)
    return (config, TerrainViewConfig(tile_capacity=vc.tile_capacity),
            {v: np.array(MV_VIEWS[v]) for v in views})


def mc_planet_scene(root, views):
    """(TerrainConfig, TerrainViewConfig, positions) of the planet's views."""
    import numpy as np

    from bevy_terrain_tpu_torch.config import AttachmentConfig, TerrainConfig, TerrainViewConfig

    model = sphere_model("sphere")
    att = AttachmentConfig(name="height", texture_size=TEXTURE_SIZE, border_size=BORDER,
                           mip_level_count=4)
    config = TerrainConfig(lod_count=SPH_LODS, model=model, atlas_size=SPH_ATLAS,
                           path="smoke_sphere", attachments=(att,), assets_root=root)
    positions = {}
    for v in views:
        d, alt = MV_PLANET[v]
        positions[v] = model.surface_position(np.array(d) / np.linalg.norm(d) * RADIUS, alt)
    return config, TerrainViewConfig(**MV_PLANET_VIEW), positions


def mc_stream(mvt, positions):
    """Update until no tile is queued or loading (``MultiViewTerrain.
    streaming``: in a group, rank 0's answer), loads in step. Returns (the
    last frame, frames, launches by kernel, host broadcast bytes in all)."""
    from bevy_terrain_tpu_torch.parallel.launch import launch_counts
    from bevy_terrain_tpu_torch.terrain_data.tile_atlas import AtlasAttachment
    from bevy_terrain_tpu_torch.utils.loading import loads_in_step

    before, sent = launch_counts(), 0
    with loads_in_step(AtlasAttachment):
        for frames in range(1, 301):
            out = mvt.update(positions)
            sent += sum(s["bytes"] for s in mvt.host_stats.values())
            if not mvt.streaming():
                break
    after = launch_counts()
    return out, frames, {k: after[k] - before[k] for k in after if after[k] != before[k]}, sent


def mc_kernel_ms(mvt, positions, frames: int = 5):
    """Device time a frame of ``mvt.update`` (ms): every record on the card
    in one profiler trace of ``frames`` updates, and the NCCL kernels' part."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bevy_terrain_tpu_torch.utils.timing import _device_records

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            mvt.update(positions)
        torch.cuda.synchronize()
        for _ in range(16):  # the trace's last records can come back late
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    recs = [(d, name) for _, d, name in _device_records(prof) if "spin_kernel" not in name]
    return (sum(d for d, _ in recs) / 1e3 / frames,
            sum(d for d, name in recs if name.startswith("nccl")) / 1e3 / frames)


def mc_measure(mvt, positions, streamed, spherical_model=None) -> dict:
    """One rank's numbers for its view after ``mc_stream``: sha256 of the
    frame, tiles, MC_TIMED update walls, device time a frame, the step's
    audit with its NCCL kernels, the host broadcasts of a steady frame."""
    import torch

    out, frames, launches, sent = streamed
    v = mvt.view_ids[mvt.rank]
    frame = out[v]
    n = frame.tile_count
    if n <= 0 or int(frame.tiles.overflow):
        raise AssertionError(f"multi_card: {v}: {n} tiles, overflow {int(frame.tiles.overflow)}")
    if spherical_model is not None:
        check_sphere_mesh(frame.mesh, n, spherical_model, f"multi_card: {v}")
    elif not all(bool(torch.isfinite(getattr(frame.mesh, f)[:n]).all())
                 for f in ("heights", "positions", "uvs")):
        raise AssertionError(f"multi_card: {v}: non-finite mesh")
    sha = frame_sha(frame.tiles, frame.mesh)
    walls = []
    for _ in range(MC_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mvt.update(positions)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    kernel_ms, nccl_ms = mc_kernel_ms(mvt, positions)
    audit = mvt.audit_step()
    return {"view": v, "device": str(mvt.device), "frames": frames, "launches": launches,
            "stream_bytes": sent, "sha": sha, "tiles": n, "walls": walls,
            "kernel_ms": kernel_ms, "nccl_ms": nccl_ms, "audit": audit,
            "nccl": mvt.nccl_kernels, "host": mvt.host_stats,
            "store": tuple(mvt.terrain.store.shape), "fused": mvt.cfg.pallas_sampling}


def mc_planar_rank(rank, group, device, root, views) -> dict:
    """A rank of the planar multi-card phase: both atlas modes, then the
    group dry run (the production-shape audit included)."""
    import torch

    from bevy_terrain_tpu_torch.entry import dryrun_multichip
    from bevy_terrain_tpu_torch.parallel import MultiViewTerrain

    config, view_config, positions = mc_planar_scene(root, views)
    out = {}
    for mode in ("replicated", "sharded"):
        mvt = MultiViewTerrain(config, views, view_config=view_config, queue_capacity=1024,
                               shard_atlas=mode == "sharded", group=group)
        out[mode] = mc_measure(mvt, positions, mc_stream(mvt, positions))
        del mvt
        torch.cuda.empty_cache()
    out["dryrun"] = dryrun_multichip(len(views), device=device, group=group)
    return out


def mc_planet_rank(rank, group, device, root, views) -> dict:
    """A rank of the planet's multi-card phase (replicated: K2 on each card)."""
    from bevy_terrain_tpu_torch.parallel import MultiViewTerrain

    config, view_config, positions = mc_planet_scene(root, views)
    mvt = MultiViewTerrain(config, views, view_config=view_config, group=group)
    return {"replicated": mc_measure(mvt, positions, mc_stream(mvt, positions),
                                     config.model)}


def mc_check(what: str, ranks: list, refs: dict, need: str | None, capacity: int,
             card: str) -> None:
    """Hold each rank's view to the one-process class on card 0 (sha256),
    its launches (``need`` once a frame, nothing else), its audit (the
    sharded exchange: one all-gather of the views' ids and one
    reduce-scatter of a capacity of f32 quads; replicated: none) and, on
    two cards or more, the NCCL kernels in the same counts; print the rank's
    line."""
    import statistics

    from bevy_terrain_tpu_torch.parallel.collective_audit import format_stats, ici_bytes

    n = len(ranks)
    for rank, r in enumerate(ranks):
        audit = r["audit"]
        host = r["host"].get("collective-broadcast", {"count": 0, "bytes": 0})
        walls = r["walls"]
        print(f"multi_card: {what} rank {rank} ({r['device']}) {r['view']}: {r['tiles']} tiles, "
              f"{r['frames']} frames streamed, launches {r['launches']}, sha256 "
              f"{r['sha'][:16]} (one-process {refs[r['view']][:16]}); store {r['store']} int32; "
              f"update "
              f"{statistics.median(walls) * 1e3:.3f} ms median wall over {len(walls)} frames "
              f"({min(walls) * 1e3:.3f}-{max(walls) * 1e3:.3f}); device time "
              f"{r['kernel_ms']:.4f} ms a frame (NCCL kernels {r['nccl_ms']:.4f} ms); step "
              f"audit: {format_stats(audit, n)} (link bytes a rank {ici_bytes(audit, n)}); "
              f"NCCL kernels in the step {r['nccl']}; host broadcasts a steady frame "
              f"{host['count']} x, {host['bytes']} bytes; {r['stream_bytes']} bytes over the "
              f"stream; {card}")
        want = refs[r["view"]]
        if r["sha"] != want:
            raise AssertionError(f"multi_card: {what} rank {rank} {r['view']}: sha256 {r['sha']} "
                                 f"is not the one-process class's {want}")
        expect = {need: r["frames"]} if need else {}
        if r["launches"] != expect:
            raise AssertionError(f"multi_card: {what} rank {rank}: launches {r['launches']}, "
                                 f"want {expect}")
        if r["fused"] != ("replicated" in what):
            raise AssertionError(f"multi_card: {what} rank {rank}: fused mesh kernel {r['fused']}")
        if "sharded" in what:
            if audit != {"all-gather": {"count": 1, "bytes": n * capacity * 4},
                         "reduce-scatter": {"count": 1, "bytes": capacity * QUAD_BYTES}}:
                raise AssertionError(f"multi_card: {what} rank {rank}: audit {audit}")
        elif audit:
            raise AssertionError(f"multi_card: {what} rank {rank}: the replicated step "
                                 f"exchanged {format_stats(audit)}")
        if n > 1 and r["nccl"] != {op: v["count"] for op, v in audit.items()}:
            raise AssertionError(f"multi_card: {what} rank {rank}: NCCL kernels {r['nccl']} "
                                 f"against the audit {audit}")


def mc_reference(config, view_config, positions, **kw) -> dict:
    """{view: sha256} of the one-process MultiViewTerrain on card 0 over
    the same views, streamed the same way."""
    import torch

    from bevy_terrain_tpu_torch.parallel import MultiViewTerrain

    mvt = MultiViewTerrain(config, list(positions), view_config=view_config, **kw)
    out = mc_stream(mvt, positions)[0]
    shas = {v: frame_sha(out[v].tiles, out[v].mesh) for v in positions}
    del mvt, out
    torch.cuda.empty_cache()
    return shas


def multi_card_path(n_ranks: int, root: str | None = None) -> dict:
    """parallel/ over one process per card: ``n_ranks`` ranks
    (``parallel.launch``, NCCL) step the planar scene's first ``n_ranks``
    views at the production shape, replicated and sharded, then the group
    dry run; with two ranks or more, the planet's two views on two ranks.
    Every view sha256-equal to the one-process class on card 0. ``root``
    holds the planar dataset already (multi_view_path's), else it is
    written. Returns the ranks' launches by kernel, each rank's counted
    over its whole run (``launch`` sets them to 0 just before the rank's
    function and reads them just after), summed over the ranks."""
    import torch

    from bevy_terrain_tpu_torch.parallel import launch
    from bevy_terrain_tpu_torch.utils.synthetic import (
        generate_planar_dataset, generate_spherical_dataset,
    )

    if torch.cuda.device_count() < n_ranks:
        raise RuntimeError(f"--multi-card {n_ranks}: {torch.cuda.device_count()} cards visible")
    t_all = time.perf_counter()
    card = card_line()
    totals: dict = {}

    def add(launched):
        for r in launched:
            for k, v in r["launches"].items():
                if v:
                    totals[k] = totals.get(k, 0) + v

    with contextlib.ExitStack() as stack:
        if root is None:
            root = stack.enter_context(tempfile.TemporaryDirectory(prefix="chip_smoke_mc_"))
            generate_planar_dataset("smoke", LOD_COUNT, mc_planar_scene(root, [])[0]
                                    .attachments[0], root=root)
        views = list(MV_VIEWS)[:n_ranks]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        launched = launch(mc_planar_rank, n_ranks, root, views)
        ranks = [r["result"] for r in launched]
        print(f"multi_card: planar, {n_ranks} rank(s) on {n_ranks} card(s): the launch took "
              f"{time.perf_counter() - t0:.1f} s")
        config, view_config, positions = mc_planar_scene(root, views)
        for mode in ("replicated", "sharded"):
            refs = mc_reference(config, view_config, positions, queue_capacity=1024,
                                shard_atlas=mode == "sharded")
            mc_check(f"planar {mode}", [r[mode] for r in ranks], refs,
                     "mesh_fused_planar" if mode == "replicated" else None,
                     view_config.tile_capacity, card)
        add(launched)
        dry = ranks[0]["dryrun"]["audits"]
        print(f"multi_card: dryrun_multichip({n_ranks}) on the group: production shape "
              f"({dry['production_blocks']} blocks, capacity 4096): {dry['production']}; "
              f"tiny sharded {dry['sharded']}; replicated {dry['replicated']}; {card}")

    if n_ranks >= MC_PLANET_RANKS:
        views = list(MV_PLANET)[:MC_PLANET_RANKS]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mc_sphere_") as proot:
            config, view_config, positions = mc_planet_scene(proot, views)
            generate_spherical_dataset("smoke_sphere", SPH_DATA_LODS, config.attachments[0],
                                       root=proot)
            t0 = time.perf_counter()
            launched = launch(mc_planet_rank, MC_PLANET_RANKS, proot, views)
            ranks = [r["result"] for r in launched]
            print(f"multi_card: planet, {MC_PLANET_RANKS} ranks: the launch took "
                  f"{time.perf_counter() - t0:.1f} s")
            refs = mc_reference(config, view_config, positions)
            mc_check("planet replicated", [r["replicated"] for r in ranks], refs,
                     "mesh_fused_spherical", view_config.tile_capacity, card)
            add(launched)
    print(f"multi_card path: {n_ranks} rank(s), {time.perf_counter() - t_all:.1f} s in all, "
          f"the ranks' launches over their whole runs {totals}; {card}")
    return totals

# the rasterizer (render/raster.py: torch ops and csrc/raster_scan.cu) on
# the material frame at 1920x1080 with tools/raster_bench.py:95's knobs, and
# on the planet at 1024^2 with 16 px bins and the first cap that drops nothing
RASTER_SIZE = (1920, 1080)
RASTER_KNOBS = dict(bin_px=32, bin_cap=512, chunk=16)
# the bench cells' knobs (terrain_bench/traffic/*.json)
BENCH_RASTER_KNOBS = dict(bin_px=16, bin_cap=512, chunk=16)
# the scan kernel's f32 operations per (live candidate, bin pixel) test: four
# planes (a x + b y) + c (2 multiplies, 2 adds each), three edge tests, the
# depth race
SCAN_OPS_PER_TEST = 4 * 4 + 3 + 1
# bin-cap sweep at 1920x1080 (tools_torch/raster_ablation.py): up to the first
# cap that drops no candidate, or the drops at the last
RASTER_CAP_SWEEP = (512, 1024, 2048, 4096, 8192)
PLANET_RASTER_SIZE = 1024
PLANET_BIN_CAPS = (256, 512, 1024, 2048)
# the CPU comparison renders at 1/RASTER_CPU_DIV of the width and height
# with bins of 1/RASTER_CPU_DIV the side: the same camera, the same
# triangles per bin (the material frame at half size takes ~10 s a render
# on the card machine's CPU, at full size about four times that)
RASTER_CPU_DIV = 4
# card against CPU where the triangle ids agree (f32 on both; libm ulps in
# the lighting and the mip selection)
TOL_RASTER = {"depth": 1e-5, "bary": 1e-5, "lit": 1e-4, "unlit": 1e-5}
RASTER_MIN_SAME = 0.999


def to_cpu(x):
    """A tensor, or a dataclass, tuple or dict of them, copied to the CPU."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: to_cpu(getattr(x, f.name))
                                         for f in dataclasses.fields(x) if f.init})
    if isinstance(x, tuple):
        return tuple(to_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    return x


def disc_holes(cov) -> int:
    """Uncovered pixels with covered ones above and below in the column
    (tests/test_raster.py:557-562)."""
    import numpy as np

    above = np.zeros_like(cov)
    above[1:] = np.maximum.accumulate(cov, 0)[:-1]
    below = np.zeros_like(cov)
    below[:-1] = np.maximum.accumulate(cov[::-1], 0)[::-1][1:]
    return int((~cov & above & below).sum())


def raster_profile(call, calls: int = 3):
    """(device kernel ms per call, kernels per call, {range: device ms per
    call}, the 8 costliest kernels as (name, launches, ms) per call) of
    ``call`` under torch.profiler; the ranges are rasterize_grid's
    record_function phases."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    ranges = {e.key: e.device_time_total / calls / 1e3
              for e in prof.key_averages() if e.key.startswith("raster::")}
    kernels = device_events(prof)
    total = sum(e.self_device_time_total for e in kernels)
    ops = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return (total / calls / 1e3, ops / calls, ranges,
            [(e.key[:48], e.count / calls, e.self_device_time_total / calls / 1e3) for e in top])


def raster_compare(what, mode, kw, out, terrain, view_proj, width, height, knobs, unlit):
    """``render_view`` on the card and on the CPU, fed the card's frame
    products copied there, at 1/RASTER_CPU_DIV the size: the triangle ids
    agree on RASTER_MIN_SAME of the pixels, both counters exactly, depth,
    barycentrics and colours within TOL_RASTER where the ids agree."""
    import torch

    from bevy_terrain_tpu_torch.ops.params import unpack_frame_uniforms
    from bevy_terrain_tpu_torch.render import raster

    w, h = width // RASTER_CPU_DIV, height // RASTER_CPU_DIV
    knobs = dict(knobs, bin_px=knobs["bin_px"] // RASTER_CPU_DIV)
    _, cfg = terrain.frame_inputs("cam")
    blob = terrain._last_blobs["cam"]

    def uniforms(b):
        return unpack_frame_uniforms(b, cfg.side_count, cfg.lod_count, cfg.tree_size)

    img, r = raster.render_view(out.mesh, out.tiles, uniforms(blob), cfg, view_proj, w, h,
                                **kw, **knobs)
    t0 = time.perf_counter()
    cimg, cr = raster.render_view(to_cpu(out.mesh), to_cpu(out.tiles), uniforms(blob.cpu()), cfg,
                                  view_proj, w, h, **to_cpu(kw), **knobs)
    cpu_s = time.perf_counter() - t0
    same = (r.tri_id.cpu() == cr.tri_id)
    share = float(same.float().mean())
    errs = {"depth": float((r.depth.cpu() - cr.depth)[same].abs().max()),
            "bary": float((r.bary.cpu() - cr.bary)[same].abs().max()),
            "unlit" if unlit else "lit": float((img.cpu() - cimg)[same].abs().max())}
    counters = [(int(getattr(r, k)), int(getattr(cr, k))) for k in ("near_culled", "bin_overflow")]
    print(f"raster: {what} {mode}: card vs CPU at {w}x{h}, bin_px {knobs['bin_px']} "
          f"({cpu_s:.1f} s on the CPU): ids equal on {share:.5%} of the pixels (least "
          f"{RASTER_MIN_SAME:.1%}), near_culled {counters[0][0]} / {counters[0][1]}, "
          f"bin_overflow {counters[1][0]} / {counters[1][1]}; max |card - CPU| where the ids "
          f"agree: " + ", ".join(f"{k} {v:.2e} (tol {TOL_RASTER[k]:.0e})" for k, v in errs.items()))
    if share < RASTER_MIN_SAME or any(a != b for a, b in counters) or any(
            v > TOL_RASTER[k] for k, v in errs.items()):
        raise AssertionError(f"{what} {mode}: the card's render disagrees with the CPU's")


def raster_path(terrain, view, stream_proj, view_proj, what, width, height, knobs, modes,
                frame_kernels, card):
    """The raster path on a streamed terrain: one more frame, whose kernels
    are counted as the main path counts them; then ``Terrain.render_image``
    in each mode of ``modes`` (name -> (render_image keywords, the same as
    render_view keywords of the frame output, packed sampler launches, unlit)),
    each with the launch counts set to 0 just before and read just after:
    no kernel but the packed sampler (K5b) of ``sample_attachment_grid`` in
    the vertex-rate modes. Each mode is checked (finite, in range), timed
    (CUDA events, median of 10; the profiler's device kernel time, ops and
    rasterize_grid's three phases) and held to the same render on the CPU.
    Returns the frame output."""
    import torch

    from bevy_terrain_tpu_torch.ops import kernels
    from bevy_terrain_tpu_torch.render import raster

    reset_counts()
    out = terrain.update({"cam": view}, {"cam": stream_proj})["cam"]
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"raster: {what}: the rendered frame, {out.tile_count} tiles, launches {counts}")
    if any(counts[k] != (1 if k in frame_kernels else 0) for k in counts):
        raise AssertionError(f"{what}: the rendered frame did not launch {frame_kernels} once")
    for mode, (kw, view_kw, k5b, unlit) in modes.items():
        def render():
            return terrain.render_image("cam", out, view_proj, width, height, **kw, **knobs)

        reset_counts()
        kernels.raster_scan.launches = 0
        img, r = render()
        torch.cuda.synchronize()
        counts = read_counts()
        if any(counts[k] != (k5b if k == "attach_sample_fused_packed" else 0) for k in counts) \
                or kernels.raster_scan.launches != 1:
            raise AssertionError(f"{what} {mode}: render_image launched {counts} and "
                                 f"{kernels.raster_scan.launches} scans")
        cov = r.covered
        lo, hi = float(img.min()), float(img.max())
        ms = cuda_ms(render, n=10, warmup=1)
        dev_ms, ops, ranges, top = raster_profile(render)
        print(f"raster: {what} {mode} at {width}x{height}: render_image {ms:.2f} ms (CUDA events, "
              f"median of 10), {dev_ms:.2f} ms device kernel time and {ops:.0f} kernels per "
              f"call (profiler; " + ", ".join(f"{k} {v:.2f} ms" for k, v in ranges.items())
              + f"); coverage {float(cov.float().mean()):.4f}, near_culled "
              f"{int(r.near_culled)}, bin_overflow {int(r.bin_overflow)}, colours in "
              f"[{lo:.4f}, {hi:.4f}]; launches {sum(counts.values())} (K5b {k5b}); {card}")
        if mode == next(iter(modes)):
            print(f"raster: {what} {mode}: costliest kernels per call: " + "; ".join(
                f"{k} {n:.0f}x {t:.2f} ms" for k, n, t in top))
        if not (img.device.type == "cuda" and img.shape == (height, width, 4)
                and bool(torch.isfinite(img).all()) and lo >= 0.0
                and (hi <= 1.0 + 1e-5 or not unlit)):
            raise AssertionError(f"{what} {mode}: the image is off the card, not finite or out "
                                 f"of range")
    # rasterize_grid's phases alone on the frame's skirted mesh
    _, cfg = terrain.frame_inputs("cam")
    pos = raster.add_skirts(out.mesh.positions, spherical=cfg.spherical)
    vp = torch.as_tensor(view_proj, dtype=torch.float32, device=pos.device)
    args = (pos, out.mesh.tile_mask, vp, width, height, knobs["bin_px"], knobs["bin_cap"],
            knobs.get("chunk", 8), False, 1e-4)
    b = raster._bin(*args)
    best = raster._run_scan(b, knobs["bin_px"], knobs.get("chunk", 8))
    phases = [cuda_ms(lambda: raster._bin(*args), n=10, warmup=1),
              cuda_ms(lambda: raster._run_scan(b, knobs["bin_px"], knobs.get("chunk", 8)), n=10,
                      warmup=1),
              cuda_ms(lambda: raster._resolve(b, *best, width, height, knobs["bin_px"]), n=10,
                      warmup=1)]
    T = b.tri_vidx.shape[0]
    print(f"raster: {what} rasterize_grid at {width}x{height}, {knobs}: setup + binning + sort "
          f"{phases[0]:.2f} ms, scan {phases[1]:.2f} ms ({b.table.shape[1]} candidate slots of "
          f"{b.table.shape[0]} bins), resolve {phases[2]:.2f} ms (CUDA events, median of 10); "
          f"{T} triangles, {4 * T} sort keys; {card}")
    scan_check(f"{what} at {knobs}", b, knobs, card)
    bench = raster._bin(pos, out.mesh.tile_mask, vp, width, height,
                        BENCH_RASTER_KNOBS["bin_px"], BENCH_RASTER_KNOBS["bin_cap"],
                        BENCH_RASTER_KNOBS["chunk"], False, 1e-4)
    scan_check(f"{what} at the bench knobs {BENCH_RASTER_KNOBS}", bench, BENCH_RASTER_KNOBS,
               card)
    for mode, (kw, view_kw, _, unlit) in modes.items():
        raster_compare(what, mode, view_kw(out), out, terrain, view_proj, width, height, knobs,
                       unlit)
    return out


def scan_check(what, b, knobs, card) -> None:
    """The scan kernel (``kernels.raster_scan``, as rasterize_grid runs it)
    against the torch scan (``raster._scan``) on one binned frame: a
    ``digest:`` line of each (the table, coefficients and flags in, best z
    and best triangle out), equal bit for bit or raise; both timed (CUDA
    events, median of 10; the torch scan of 3); the kernel's bound (each
    live (bin, candidate) pair's id, the unique live candidates' 48 bytes of
    coefficients and 3 flags read once, best z and best triangle written
    once, against SCAN_OPS_PER_TEST f32 operations per live pair and bin
    pixel); the table's live share (``scan_candidates / scan_slots``)."""
    import torch

    from bevy_terrain_tpu_torch.render import raster

    bin_px, chunk = knobs["bin_px"], knobs["chunk"]
    inputs = (b.table, b.coefs, b.top_left)
    got = raster._run_scan(b, bin_px, chunk)
    want = raster._scan(b, bin_px, chunk)
    torch.cuda.synchronize()
    held = set(_SHA_MEMO)
    outs = {label: torch.cat([z.view(torch.int32).long(), t], 1)
            for label, (z, t) in (("raster_scan kernel", got), ("raster_scan torch", want))}
    for label, o in outs.items():
        digest(f"{label} {what}", inputs, o)
    for key in set(_SHA_MEMO) - held:  # the frame's tables and outputs go
        del _SHA_MEMO[key]
    equal = torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)) and torch.equal(
        got[1], want[1])
    kernel_ms = cuda_ms(lambda: raster._run_scan(b, bin_px, chunk), n=10, warmup=1)
    torch_ms = cuda_ms(lambda: raster._scan(b, bin_px, chunk), n=3, warmup=1)
    live = int((b.table >= 0).sum())
    unique = int(torch.unique(b.table[b.table >= 0]).numel())
    NB, P = b.table.shape[0], bin_px * bin_px
    print(f"scan: {what}: kernel and torch scan equal bit for bit: {equal}; kernel "
          f"{kernel_ms:.4f} ms, torch scan {torch_ms:.2f} ms (CUDA events); scan_candidates / "
          f"scan_slots {live} / {b.table.numel()} = {live / b.table.numel():.4f} "
          f"({NB} bins of {P} pixels, {unique} unique candidates); {card}")
    row = bound(live * 8 + unique * (48 + 3) + NB * P * (4 + 8),
                live * P * SCAN_OPS_PER_TEST)
    print(f"scan: {what}: bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
          f"{row['bound_ms'] / kernel_ms:.1%} of it")
    if not equal:
        raise AssertionError(f"{what}: the scan kernel differs from the torch scan")


def material_raster_path(terrain, view, view_proj, card) -> None:
    """The material main path's frame (K4 in every frame) at 1920x1080
    under the bench camera: per-pixel textured PBR (render_image's default
    for this material), interpolated vertex colours (``pixel_texturing=
    False``) and a debug view."""
    t0 = time.perf_counter()
    material = terrain.shading_fn
    albedo = terrain.atlas.attachments[1]
    tex = (tuple(albedo.slabs), albedo.config.scale, albedo.config.offset,
           albedo.config.format.max_value, albedo.config.texture_size)

    def grid(out):
        return {1: terrain.sample_attachment_grid("cam", out, 1)}

    modes = {
        "per-pixel textured PBR": (
            {}, lambda out: dict(material=material, pixel_attachment=tex), 0, False),
        "pixel_texturing=False": (
            dict(pixel_texturing=False),
            lambda out: dict(material=material, attachment_samples=grid(out)), 1, False),
        "debug_view=geometry_lod": (
            dict(debug_view="geometry_lod"),
            lambda out: dict(material=material, debug_view="geometry_lod",
                             attachment_samples=grid(out)), 1, True),
    }
    out = raster_path(terrain, view, view_proj, view_proj, "material frame", *RASTER_SIZE,
                      RASTER_KNOBS, modes, ("mesh_fused_shaded",), card)
    # what the prescribed cap drops: the same frame's binning at larger caps
    # (tools_torch/raster_ablation.py), up to the first that drops nothing,
    # and the scan there
    from types import SimpleNamespace

    import torch

    from bevy_terrain_tpu_torch.render import raster
    from tools_torch import raster_ablation

    skirted = SimpleNamespace(positions=raster.add_skirts(out.mesh.positions),
                              tile_mask=out.mesh.tile_mask)
    knobs = {k: v for k, v in RASTER_KNOBS.items() if k != "bin_cap"}
    for cap in RASTER_CAP_SWEEP:
        drops = raster_ablation.dropped(skirted, view_proj, *RASTER_SIZE, bin_cap=cap, **knobs)
        print(f"raster: material frame at bin_cap {cap}: bin_overflow {drops}")
        if drops == 0:
            break
    vp = torch.as_tensor(view_proj, dtype=torch.float32, device="cuda")
    b = raster._bin(skirted.positions, skirted.tile_mask, vp, *RASTER_SIZE, knobs["bin_px"],
                    cap, knobs["chunk"], False, 1e-4)
    scan_ms = cuda_ms(lambda: raster._run_scan(b, knobs["bin_px"], knobs["chunk"]), n=3,
                      warmup=1)
    verdict = (f"bin_cap {cap} is the first that drops nothing" if drops == 0
               else f"{drops} candidates still dropped at bin_cap {cap}")
    print(f"raster: material frame at {RASTER_SIZE[0]}x{RASTER_SIZE[1]}: {verdict}; the scan "
          f"there {scan_ms:.2f} ms ({b.table.shape[1]} candidate slots of {b.table.shape[0]} "
          f"bins; CUDA events, median of 3); {card}")
    print(f"raster: material frame: the raster path took {time.perf_counter() - t0:.1f} s")


def planet_raster_path(terrain, view, stream_proj, card) -> None:
    """The spherical main path's planet (K2 in every frame) at 1024^2 from
    the same camera, the default material per pixel and a debug view, with
    16 px bins and the first cap of PLANET_BIN_CAPS that drops nothing; the
    disc must have no holes."""
    import numpy as np

    from bevy_terrain_tpu_torch.math import frustum

    t0 = time.perf_counter()
    size = PLANET_RASTER_SIZE
    view_proj = frustum.view_projection(view, view * 0.5, np.pi / 3, 1.0)
    out = terrain.update({"cam": view}, {"cam": stream_proj})["cam"]
    for cap in PLANET_BIN_CAPS:
        _, r = terrain.render_image("cam", out, view_proj, size, size, bin_px=16, bin_cap=cap)
        if int(r.bin_overflow) == 0:
            break
    holes = disc_holes(r.covered.cpu().numpy())
    print(f"raster: planet at {size}^2: bin_cap {cap} at bin_px 16 drops nothing (bin_overflow "
          f"{int(r.bin_overflow)}); coverage {float(r.covered.float().mean()):.4f}, {holes} holes "
          f"in the disc")
    if int(r.bin_overflow) != 0 or holes != 0 or float(r.covered.float().mean()) < 0.5:
        raise AssertionError("planet: bins overflow at every cap, or the disc has holes")
    modes = {
        "per-pixel PBR": ({}, lambda out: {}, 0, False),
        "debug_view=geometry_lod": (dict(debug_view="geometry_lod"),
                                    lambda out: dict(debug_view="geometry_lod"), 0, True),
    }
    raster_path(terrain, view, stream_proj, view_proj, "planet", size, size,
                dict(bin_px=16, bin_cap=cap, chunk=16), modes, ("mesh_fused_spherical",), card)
    print(f"raster: planet: the raster path took {time.perf_counter() - t0:.1f} s")


def profile_stage(device_stage, what: str) -> None:
    """Kernel time by name over 10 device stages (``device_breakdown``)."""
    total, rows = device_breakdown(device_stage, label=what, runs=10)
    print(f"profile ({what}): {total:.4f} ms device kernel time per stage, "
          f"{sum(r[1] for r in rows)} kernels per stage")
    for i, (key, count, ms) in enumerate(rows):
        if i < 12 or any(k in key for k in ("mesh_fused", "fetch_resample", "attach_sample")):
            print(f"profile:   {key[:60]:60s} {count:4d}x {ms:.4f} ms")


# ptxas names of the kernel instances: mesh_fused_kernel<SPHERICAL,
# ELLIPSOIDAL, ABL>, mesh_material_kernel<SPHERICAL, ELLIPSOIDAL, SHADE, ABL>
# (the trees before the ablation mask lack its Li..E), the sampler and the
# half-grid kernels
INSTANCES = {
    r"mesh_fused_kernelILb0ELb0E(Li0E)?E": "mesh_fused_planar",
    r"mesh_fused_kernelILb1ELb0E(Li0E)?E": "mesh_fused_spherical (sphere)",
    r"mesh_fused_kernelILb1ELb1E(Li0E)?E": "mesh_fused_spherical (ellipsoid)",
    r"mesh_material_kernelILb0ELb0ELb0E(Li0E)?E": "mesh_fused_albedo",
    r"mesh_material_kernelILb0ELb0ELb1E(Li0E)?E": "mesh_fused_shaded",
    r"mesh_material_kernelILb1ELb0ELb0E(Li0E)?E": "mesh_fused_spherical_albedo (sphere)",
    r"mesh_material_kernelILb1ELb1ELb0E(Li0E)?E": "mesh_fused_spherical_albedo (ellipsoid)",
    r"attach_sample_kernel": "attach_sample_fused[_packed]",
    r"fetch_resample_cached_kernel": "fetch_resample_cached",
    r"fetch_resample_kernel": "fetch_resample",
}
# the ablated instances (the ablation library): the production name's
# template head, then the mask
ABLATED_INSTANCES = {
    r"mesh_fused_kernelILb0ELb0ELi(\d+)EE": "mesh_fused_planar",
    r"mesh_fused_kernelILb1ELb0ELi(\d+)EE": "mesh_fused_spherical (sphere)",
    r"mesh_fused_kernelILb1ELb1ELi(\d+)EE": "mesh_fused_spherical (ellipsoid)",
    r"mesh_material_kernelILb0ELb0ELb0ELi(\d+)EE": "mesh_fused_albedo",
    r"mesh_material_kernelILb0ELb0ELb1ELi(\d+)EE": "mesh_fused_shaded",
    r"mesh_material_kernelILb1ELb0ELb0ELi(\d+)EE": "mesh_fused_spherical_albedo (sphere)",
    r"mesh_material_kernelILb1ELb1ELb0ELi(\d+)EE": "mesh_fused_spherical_albedo (ellipsoid)",
}


def ptxas_entries(log: str):
    """(entry text, registers, shared memory bytes, spill store bytes) of
    each entry function in a build's ``ptxas -v`` report."""
    for entry in re.split(r"Compiling entry function", log)[1:]:
        regs = re.search(r"Used (\d+) registers", entry)
        smem = re.search(r"(\d+) bytes smem", entry)
        spill = re.search(r"(\d+) bytes spill stores", entry)
        if regs:
            yield (entry.split("\n", 1)[0], int(regs.group(1)), int(smem.group(1)) if smem else 0,
                   int(spill.group(1)) if spill else 0)


def print_resources(log: str) -> None:
    """Registers, spills and static shared memory per kernel instance, from
    the build's ``ptxas -v`` report."""
    for head, regs, smem, spill in ptxas_entries(log):
        name = next((v for k, v in INSTANCES.items() if re.search(k, head)), None)
        if name:
            print(f"resources: {name}: {regs} registers, {smem} bytes shared memory, "
                  f"{spill} bytes spill stores")


# blocks of 320 threads per SM that the run-of-tiles kernels' designs rest on
# (their launch bounds): fewer fails the run
MIN_BLOCKS_PER_SM = {"mesh_fused_planar": 4, "mesh_fused_spherical (sphere)": 3,
                     "mesh_fused_spherical (ellipsoid)": 3, "fetch_resample_cached": 4,
                     "fetch_resample": 4}


def print_occupancy() -> None:
    """Blocks of 320 threads per SM of each kernel instance on this card
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at its dynamic shared
    memory) with its registers and shared memory, from the library's
    ``kernel_occupancy`` query; fails where an instance holds fewer than
    :data:`MIN_BLOCKS_PER_SM` (at least one)."""
    import torch

    from bevy_terrain_tpu_torch.ops import kernels

    warps_per_sm = torch.cuda.get_device_properties(0).max_threads_per_multi_processor // 32
    for row in kernels.kernel_occupancy():
        warps = row["blocks_per_sm"] * 10
        print(f"occupancy: {row['name']}: {row['blocks_per_sm']} blocks per SM ({warps} of "
              f"{warps_per_sm} warps, {warps / warps_per_sm:.0%}); {row['registers']} "
              f"registers, {row['static_smem']} + {row['dynamic_smem']} bytes shared memory "
              f"(static + dynamic), {row['local_bytes']} bytes local")
        least = MIN_BLOCKS_PER_SM.get(row["name"], 1)
        if row["blocks_per_sm"] < least:
            raise AssertionError(f"{row['name']}: {row['blocks_per_sm']} blocks of 320 threads "
                                 f"per SM, fewer than {least}")


# -- native path -----------------------------------------------------------------

# the deep streaming flythrough (tools_torch/flythrough_bench.py, BASELINE.json
# configs[4]: 12 geometry lods over 5 data lods, capacity 8192, 120 frames from
# 12 km to 60 m) and the sphere main path's planet at 60 km, then at 3 km,
# where the Taylor near field runs: (altitude m, frames)
NATIVE_FLY_FRAMES = 120
NATIVE_PLANET = ((60_000.0, 20), (3_000.0, 20))
NATIVE_SCENES = {"flythrough": "mesh_fused_planar", "planet": "mesh_fused_spherical"}
# the native entry points Terrain.update runs on each scene
NATIVE_ENTRIES = ("scan_requests", "view_anchors", "NativeResidency.add_existing",
                  "NativeResidency.request", "NativeResidency.drain_loads",
                  "NativeResidency.loaded", "NativeResidency.best_tiles", "sample_bilinear")
# and per run, the entry points each scene and the preprocess host path must
# have called (the numpy child's runs must have called none). The planet's
# descent releases no tile (its 60 km tiles stay in the 3 km tree), so only
# the flythrough must release
NATIVE_NEEDS = {"flythrough": NATIVE_ENTRIES + ("NativeResidency.release",),
                "planet": NATIVE_ENTRIES + ("taylor_from_world", "project_view_uv"),
                "preprocess": ("split_bilinear", "quantize", "downsample")}
# the host prologue's steps (render/pipeline.py Terrain.update 1-4), then the
# device stage (step 5, to the end of the frame's work)
NATIVE_STEPS = ("scan", "residency + IO", "adjust + height + Taylor + pack", "device stage")
# the device twin of the scan against its f64 host twin (tests/test_ops.py)
TWIN_MIN_AGREE = 0.99


def native_build_line(card: str) -> None:
    """Build (or load) the native runtime first of all, so that a failed
    build stops the run before the long paths; print the ``native:`` line."""
    import os
    import platform

    from bevy_terrain_tpu_torch import native

    if os.environ.get("BT_DISABLE_NATIVE"):
        raise AssertionError("BT_DISABLE_NATIVE is set: the main process must run the "
                             "native runtime")
    if not native.available():
        raise AssertionError("the native runtime is not available")
    info = native.build_info
    print(f"native: uname -m {platform.machine()}; {info['cxx']}: {info['version']}; "
          f"flags {info['flags']}; "
          f"built in {info['seconds']:.2f} s; compiler+flags+source sha256 {info['hash'][:16]}; "
          f"{Path(info['path']).relative_to(ROOT)}; {card}")


@contextlib.contextmanager
def prologue_clock(terrain, marks: dict):
    """Record in ``marks`` the host clock when the view's request scan and
    the atlas's uploads return, and when the blobs go to the device (the end
    of the host prologue)."""
    tree, atlas = terrain.tile_trees["cam"], terrain.atlas
    scan, flush, blobs = tree.compute_requests, atlas.flush_uploads, terrain._blobs_to_device

    def after(name, fn):
        def call(*a, **k):
            out = fn(*a, **k)
            marks[name] = time.perf_counter()
            return out
        return call

    def to_device(*a, **k):
        marks["blobs"] = time.perf_counter()
        return blobs(*a, **k)

    tree.compute_requests = after("scan", scan)
    atlas.flush_uploads = after("flush", flush)
    terrain._blobs_to_device = to_device
    try:
        yield
    finally:
        del tree.compute_requests, atlas.flush_uploads, terrain._blobs_to_device


def native_terrain(scene: str, root: Path):
    """(Terrain on the card, [(view, view_proj) per frame], model) of a
    native-path scene over the datasets under ``root``."""
    from bevy_terrain_tpu_torch import Terrain
    from bevy_terrain_tpu_torch.config import AttachmentConfig, TerrainConfig, TerrainViewConfig
    from bevy_terrain_tpu_torch.models import streaming_flythrough_view
    from tools_torch.flythrough_bench import flight_path, flight_view_proj, flythrough_config

    if scene == "flythrough":
        terrain = Terrain(flythrough_config(str(root / "fly")))
        terrain.add_view("cam", streaming_flythrough_view(tile_capacity=8192),
                         queue_capacity=16384, culling=True)
        path = flight_path(NATIVE_FLY_FRAMES)
        return terrain, [(path[i], flight_view_proj(path, i)) for i in range(len(path))]
    model = sphere_model("sphere")
    att = AttachmentConfig(name="height", texture_size=TEXTURE_SIZE, border_size=BORDER,
                           mip_level_count=4)
    terrain = Terrain(TerrainConfig(lod_count=SPH_LODS, model=model, atlas_size=SPH_ATLAS,
                                    path="planet", attachments=(att,),
                                    assets_root=str(root / "planet")))
    terrain.add_view("cam", TerrainViewConfig(tile_capacity=SPH_CAPACITY), queue_capacity=2048,
                     culling=True)
    return terrain, [sphere_view(model, alt) for alt, n in NATIVE_PLANET for _ in range(n)]


def native_datasets(root: Path) -> None:
    """The flythrough's and the planet's datasets, and the bench geometry's
    8192^2 height source as a .npy, under ``root`` (made once, read by both
    processes)."""
    import numpy as np

    from bevy_terrain_tpu_torch.config import AttachmentConfig
    from bevy_terrain_tpu_torch.utils.synthetic import (
        generate_planar_dataset, generate_spherical_dataset,
    )
    from tools_torch.flythrough_bench import DATA_LODS, flythrough_config

    t0 = time.perf_counter()
    fly = flythrough_config(str(root / "fly"))
    n_fly = len(generate_planar_dataset(fly.path, DATA_LODS, fly.attachments[0],
                                        root=str(root / "fly")))
    att = AttachmentConfig(name="height", texture_size=TEXTURE_SIZE, border_size=BORDER,
                           mip_level_count=4)
    n_planet = len(generate_spherical_dataset("planet", SPH_DATA_LODS, att,
                                              root=str(root / "planet")))
    np.save(root / "height.npy", planar_height_source())
    print(f"native path: wrote the flythrough's {n_fly} tiles, the planet's {n_planet} and a "
          f"{PRE_SOURCE}^2 height source in {time.perf_counter() - t0:.1f} s")


def native_scene(scene: str, root: Path, check: bool = False) -> dict:
    """One run of ``scene`` through ``Terrain.update`` on the card, tile
    loads in step. Per frame: the sha256 of the sorted requested and
    released keys, the entries, the packed blob and ``raw_mesh`` (its
    ``tile_count`` rows), and the host clock of the prologue's steps and
    the device stage (ms); the native calls of the run. With ``check``,
    the mesh kernel's product is held against its plain version on the
    first frame of the second half that requests tiles and on the last
    frame. Then the device twin of the scan against its host twin on the
    last frame."""
    import numpy as np
    import torch

    from bevy_terrain_tpu_torch import native
    from bevy_terrain_tpu_torch.ops import kernels, tile_tree
    from bevy_terrain_tpu_torch.terrain_data.tile_atlas import AtlasAttachment
    from bevy_terrain_tpu_torch.utils.loading import loads_in_step

    def keys(tiles):
        return np.array(sorted((c.side, c.lod, c.x, c.y) for c in tiles), np.int64)

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    kernel = NATIVE_SCENES[scene]
    plain, held = ((kernels.mesh_fused_planar_reference, compare) if scene == "flythrough"
                   else (kernels.mesh_fused_spherical_reference, compare_spherical))
    native.reset_counts()  # the residency machine's add_existing runs in Terrain()
    terrain, views = native_terrain(scene, root)
    tree = terrain.tile_trees["cam"]
    frames, steps, marks, checked = [], [], {}, []
    reset_counts()
    with loads_in_step(AtlasAttachment), prologue_clock(terrain, marks):
        for i, (view, view_proj) in enumerate(views):
            t0 = time.perf_counter()
            out = terrain.update({"cam": view}, {"cam": view_proj})["cam"]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            steps.append([(marks["scan"] - t0) * 1e3, (marks["flush"] - marks["scan"]) * 1e3,
                          (marks["blobs"] - marks["flush"]) * 1e3, (t1 - marks["blobs"]) * 1e3])
            n = out.tile_count
            frames.append({
                "requested": sha(keys(tree.requested_tiles)),
                "released": sha(keys(tree.released_tiles)), "entries": sha(tree.entries),
                "blob": sha(terrain._last_blobs["cam"].cpu().numpy()),
                "raw_mesh": sha(out.raw_mesh[:n].cpu().numpy()), "tiles": n})
            loading = (not checked and 2 * i >= len(views) and len(tree.requested_tiles) > 0)
            if check and (loading or i == len(views) - 1):
                what = (f"native path, {scene} frame {i} ({len(tree.requested_tiles)} tiles "
                        f"requested, {n} drawn)")
                held(out.raw_mesh, plain(*out.mesh_inputs), f"{what}: {kernel}")
                checked.append(i)
    launches = read_counts()[kernel]
    calls = {k: v for k, v in native.counts().items() if v}
    if launches < len(views):
        raise AssertionError(f"native path, {scene}: {kernel} launched "
                             f"{launches} times in {len(views)} frames")
    if check and len(checked) != 2:
        raise AssertionError(f"native path, {scene}: no frame of the second half requested "
                             f"tiles, so no loading frame was held against {kernel}'s plain "
                             f"version (checked frames {checked})")
    uniforms, cfg = terrain.frame_inputs("cam")
    xy, req = tile_tree.tile_tree_update(uniforms, cfg)
    xy_host, req_host = tile_tree.tile_tree_update_host(
        terrain.config.model, views[-1][0], uniforms, cfg)
    return {"frames": frames, "steps": steps, "launches": launches, "native_calls": calls,
            "twin_xy_equal": bool(np.array_equal(xy.cpu().numpy(), xy_host)),
            "twin_agree": float(np.mean(req.cpu().numpy() == req_host)),
            "twin_slots": int(req_host.size),
            "resident": sum(s.loading_remaining == 0
                            for s in terrain.atlas.state.tile_states.values())}


def native_preprocess(root: Path, card: str) -> dict:
    """The preprocess host path on the bench geometry (the 8192^2 R16 height
    source over lods 0-4 of 512^2: 341 tiles) and on the interchange
    fixture: the tiles/s, the sha256 of every file written and the native
    calls of the run."""
    import numpy as np

    from bevy_terrain_tpu_torch import PreprocessDataset, native
    from bevy_terrain_tpu_torch.config import AttachmentConfig, TerrainConfig
    from bevy_terrain_tpu_torch.terrain_data import TileAtlas

    native.reset_counts()
    source = np.load(root / "height.npy")
    model = bench_scene()[0]
    att = AttachmentConfig(name="height", texture_size=TEXTURE_SIZE, border_size=BORDER,
                           mip_level_count=4)
    tiles = sum(1 << (2 * lod) for lod in range(LOD_COUNT))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_native_pre_") as tmp:
        config = TerrainConfig(lod_count=LOD_COUNT, model=model, atlas_size=PRE_ATLAS,
                               path="pre", attachments=(att,), assets_root=tmp)
        wall, _ = preprocess_run(
            f"native path, bench geometry height (R16, lods 0-{LOD_COUNT - 1})",
            TileAtlas(config, "cuda"),
            lambda p: p.clear_attachment(0).preprocess_tile(PreprocessDataset(
                attachment_index=0, path="height.png", lod_range=range(LOD_COUNT))),
            tiles, card, loader=lambda p, cfg: source, device=False)
        files = tile_files(Path(tmp), "pre", "height")
        files["config.tc"] = (Path(tmp) / "pre" / "config.tc").read_bytes()
        _, kit = kit_run("native path, interchange fixture", Path(tmp) / "kit", card,
                         device=False)
    return {"tiles_per_s": tiles / wall, "wall_s": wall,
            "native_calls": {k: v for k, v in native.counts().items() if v},
            "hashes": {k: hashlib.sha256(v).hexdigest() for k, v in files.items()},
            "kit": {k: hashlib.sha256(v).hexdigest() for k, v in kit.items()}}


def native_runs(root: Path, card: str, check: bool = False) -> dict:
    """One run of each scene (``check``: with its mesh kernel held against
    the plain version) and of the preprocess host path."""
    import torch

    out = {scene: native_scene(scene, root, check) for scene in NATIVE_SCENES}
    torch.cuda.empty_cache()
    out["preprocess"] = native_preprocess(root, card)
    return out


def native_child(root: Path) -> int:
    """The numpy side of the native path, in a process of its own with
    ``BT_DISABLE_NATIVE=1``: two runs, written to ``root/numpy.json``."""
    import os

    from bevy_terrain_tpu_torch import native

    if os.environ.get("BT_DISABLE_NATIVE") != "1" or native.available():
        raise AssertionError("the numpy side must run with BT_DISABLE_NATIVE=1")
    card = card_line()
    runs = [native_runs(root, card) for _ in range(2)]
    calls = {k: r[k]["native_calls"] for r in runs for k in r if r[k]["native_calls"]}
    if calls:
        raise AssertionError(f"native entry points ran with BT_DISABLE_NATIVE=1: {calls}")
    (root / "numpy.json").write_text(json.dumps(runs))
    return 0


def spread(xs) -> str:
    import numpy as np

    p10, p50, p90 = np.percentile(xs, [10, 50, 90])
    return f"{p50:.3f} ms (p10 {p10:.3f}, p90 {p90:.3f})"


def native_path() -> None:
    """The native host runtime on the main path: the flythrough and the
    planet through ``Terrain.update`` and the preprocess host path, with
    the native runtime here and with the numpy paths (``BT_DISABLE_NATIVE=1``)
    in a child process, in turns (native, numpy, numpy, native): every
    frame and every file byte-equal; each native entry point the path uses
    ran; the host prologue timed apart from the device stage; the device
    twin of the request scan against its host twin on the card."""
    import os

    from bevy_terrain_tpu_torch import native

    if os.environ.get("BT_DISABLE_NATIVE"):
        raise AssertionError("BT_DISABLE_NATIVE is set in the main process")
    card = card_line()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_native_") as tmp:
        root = Path(tmp)
        native_datasets(root)
        first = native_runs(root, card, check=True)
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--native-child", str(root)],
            env={**os.environ, "BT_DISABLE_NATIVE": "1"}, capture_output=True, text=True,
            timeout=900, cwd=ROOT)
        for line in child.stdout.splitlines():
            if line.startswith("preprocess:"):
                print(line.replace("preprocess: native path", "preprocess: numpy child"))
        if child.returncode != 0:
            raise AssertionError(f"native path: the numpy child failed ({child.returncode}):\n"
                                 f"{child.stderr[-4000:]}")
        numpy_runs = json.loads((root / "numpy.json").read_text())
        print(f"native path: the numpy child (BT_DISABLE_NATIVE=1) ran two runs in "
              f"{time.perf_counter() - t0:.1f} s")
        last = native_runs(root, card)
    turns = [("native", first), ("numpy", numpy_runs[0]), ("numpy", numpy_runs[1]),
             ("native", last)]

    for scene in NATIVE_SCENES:
        want = first[scene]
        for i, (side, run) in enumerate(turns[1:], 2):
            got = run[scene]
            if len(got["frames"]) != len(want["frames"]):
                raise AssertionError(f"native path, {scene}: run {i} has "
                                     f"{len(got['frames'])} frames")
            for f, (a, b) in enumerate(zip(want["frames"], got["frames"])):
                bad = sorted(k for k in a if a[k] != b[k])
                if bad:
                    raise AssertionError(f"native path, {scene}: frame {f} of run {i} "
                                         f"({side}) differs from run 1 (native) in {bad}")
        print(f"native path, {scene}: {len(want['frames'])} frames of 4 runs in turns "
              f"(native, numpy, numpy, native) sha256-equal in the requested and released "
              f"keys, entries, packed blob and raw_mesh; tiles "
              f"{min(f['tiles'] for f in want['frames'])}-"
              f"{max(f['tiles'] for f in want['frames'])}, {want['resident']} tiles resident "
              f"at the end, {NATIVE_SCENES[scene]} {want['launches']} launches")
        for i, (side, run) in enumerate(turns, 1):
            st = run[scene]["steps"]
            cols = list(zip(*st))
            prologue = [sum(r[:3]) for r in st]
            print(f"native: {scene} run {i} ({side}): host prologue {spread(prologue)} = "
                  + ", ".join(f"{n} {statistics.median(c):.3f}"
                              for n, c in zip(NATIVE_STEPS[:3], cols[:3]))
                  + f"; {NATIVE_STEPS[3]} {spread(cols[3])}; host clock, {len(st)} frames, "
                  f"loads in step; {card}")
        if not want["twin_xy_equal"] or want["twin_agree"] <= TWIN_MIN_AGREE:
            raise AssertionError(f"native path, {scene}: the device twin of the scan: tile_xy "
                                 f"equal {want['twin_xy_equal']}, masks agree "
                                 f"{want['twin_agree']:.4f}")
        print(f"native path, {scene}: ops/tile_tree.tile_tree_update on the card against "
              f"tile_tree_update_host (last frame, {want['twin_slots']} slots): tile_xy equal, "
              f"request masks agree on {want['twin_agree']:.4%} (limit {TWIN_MIN_AGREE:.0%})")

    for what, need in NATIVE_NEEDS.items():
        for i, (side, run) in enumerate(turns, 1):
            calls = run[what]["native_calls"]
            missing = [k for k in need if not calls.get(k)] if side == "native" else []
            if missing:
                raise AssertionError(f"native path, {what} run {i}: native entry points that "
                                     f"never ran: {missing}")
        print(f"native path, {what}: native calls in run 1: "
              + ", ".join(f"{k} {v}" for k, v in first[what]["native_calls"].items()))

    pre = first["preprocess"]
    for i, (side, run) in enumerate(turns[1:], 2):
        if run["preprocess"]["hashes"] != pre["hashes"]:
            raise AssertionError(f"native path: preprocess run {i} ({side}) wrote other bytes")
        if run["preprocess"]["kit"] != pre["kit"]:
            raise AssertionError(f"native path: interchange fixture run {i} ({side}) differs")
    want_kit = kit_expected()
    if pre["kit"] != want_kit:
        raise AssertionError("native path: the interchange fixture's host path does not "
                             "reproduce the committed sha256")
    print(f"native path, preprocess host path: the bench geometry's {len(pre['hashes'])} files "
          f"and the interchange fixture's {len(want_kit)} of {len(want_kit)} committed sha256 "
          f"equal in 4 runs; tiles/s in turns: "
          + " / ".join(f"{side} {run['preprocess']['tiles_per_s']:.1f}" for side, run in turns)
          + f"; {card}")
    print(f"native path: {time.perf_counter() - t_phase:.1f} s")


# -- ablation path -------------------------------------------------------------

# the ablated instances the path launches (the JAX ablation tools' variants:
# tools_torch/earth_kernel_ablation.py, tools_torch/material_kernel_ablation.py)
# and K1's two, each against its plain version with the same ``ablate``
K1_ABLATIONS = (("full", frozenset()), ("no_smooth", frozenset({"no_smooth"})),
                ("no_phase_a", frozenset({"no_phase_a"})))


def ablated_counts() -> dict:
    """{wrapper[variant]: launches} of the ablated instances."""
    from bevy_terrain_tpu_torch.ops import kernels

    return {f"{name}[{label}]": n for name, *_ in KERNELS
            for label, n in getattr(getattr(kernels, name), "ablated_launches", {}).items()}


def reset_ablated_counts() -> None:
    from bevy_terrain_tpu_torch.ops import kernels

    for name, *_ in KERNELS:
        getattr(kernels, name).ablated_launches = {}


def ablation_rows(what: str, wrapper, plain, args, variants, check, nbound: dict,
                  results: dict, card: str) -> dict:
    """Each variant of ``variants`` ((name, ablate) pairs, the first the
    production kernel) through ``wrapper(*args, ablate=...)``: held against
    ``plain(*args, ablate=...)`` by ``check(got, want, label) -> err``, then
    its device time back to back (L2 warm), with the L2 flushed before each
    launch, and the plain version's. Prints the rows and the deltas against
    the first with the card's name and power limit; an ablated variant's
    row goes into ``results`` as ``wrapper[variant]`` (its bound
    ``nbound``: the full kernel's bytes and operations on these inputs)."""
    import torch

    from bevy_terrain_tpu_torch.ops import kernels

    rows = {}
    for name, abl in variants:
        label = f"{wrapper.__name__}[{name}] ({what})"
        got = wrapper(*args, ablate=abl)
        torch.cuda.synchronize()
        want = plain(*args, ablate=abl)
        err = check(got, want, label)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label}: non-finite output")
        warm = device_ms(lambda abl=abl: wrapper(*args, ablate=abl))
        flushed = cold_ms(lambda abl=abl: wrapper(*args, ablate=abl))
        plain_ms = device_ms(lambda abl=abl: plain(*args, ablate=abl), n=3)
        rows[name] = (warm, flushed)
        print(f"ablation: {label}: {warm:.4f} ms (device, L2 warm), {flushed:.4f} ms "
              f"(L2 flushed); plain PyTorch version {plain_ms:.4f} ms")
        if abl:
            results[f"{wrapper.__name__}[{kernels.ablate_label(abl)}]"] = dict(
                max_abs_err=err, ms=warm, plain_ms=plain_ms, **nbound, library_ms=None)
        del got, want
    full_warm, full_flushed = rows[variants[0][0]]
    for name, _ in variants[1:]:
        warm, flushed = rows[name]
        print(f"ablation: {wrapper.__name__} ({what}) {name}: delta against "
              f"{variants[0][0]} {full_warm - warm:+.4f} ms warm, {full_flushed - flushed:+.4f} "
              f"ms flushed ({(full_warm - warm) / full_warm:+.1%} warm); {card}")
    return rows


def material_check(mesh_rows, shaded: bool, variants):
    """A check of a material variant of ``variants`` ((name, ablate)
    pairs): its mesh rows bit-equal to ``mesh_rows[name]`` (K1's output with
    the same mesh piece removed), its colours within the plain version's
    tolerance of full scale (255, 1 shaded, the largest magnitude with
    ``alb_no_unpack``'s raw words) on the path the variant takes (exact or
    bf16 fast)."""
    import torch

    from bevy_terrain_tpu_torch.ops import kernels

    def check(got, want, label):
        name = label.split("[", 1)[1].split("]", 1)[0]
        if not torch.equal(got[:, :kernels.OUT_CH], mesh_rows[name]):
            raise AssertionError(f"{label}: the mesh rows differ from mesh_fused_planar's")
        cols, wcols = got[:, kernels.OUT_CH:], want[:, kernels.OUT_CH:]
        exact = bool(dict(variants)[name] & kernels.ALBEDO_EXACT_ABLATE)
        scale = 1.0 if shaded else 255.0
        if "alb_no_unpack" in name:
            scale = max(scale, float(wcols.abs().max()))
        tol = (TOL_SHADED_EXACT if shaded else TOL_ALB_EXACT) if exact else TOL_ALB_FAST
        err = float((cols - wcols).abs().max()) / scale
        print(f"ablation: {label}: max |kernel - plain| {err:.3e} of full scale {scale:.6g} "
              f"(tol {tol:.1e}; {'exact' if exact else 'fast'} path)")
        if not err <= tol:
            raise AssertionError(f"{label}: kernel disagrees with the plain version")
        return err

    return check


def ablation_path(card: str) -> dict:
    """The kernels' ablated instances (``ablate``; the ablation library,
    built here) against their plain versions and timed, per variant, with
    the deltas against the production kernel: K2 on the Earth frame of
    tools_torch/earth_kernel_ablation.py (streamed and settled), K1, K3 and
    K4 on the bench frame of tools_torch/material_kernel_ablation.py (random
    packed Rgba8 albedo, default_rng(7)); then the two tools' own timings
    (``generate_mesh_fused`` per variant, ``utils/timing.device_time_ms``).
    Returns {wrapper[variant]: row} for the kernels line."""
    import torch

    from bevy_terrain_tpu_torch.ops import kernels, meshgen
    from tools_torch import earth_kernel_ablation, material_kernel_ablation

    t_path = t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        lib = kernels.build_ablation_library(verbose=True)
    print(f"ablation: build {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s "
          f"({kernels.ABLATION_GROUPS} nvcc processes)")
    ablation_resources(log.getvalue(), lib)
    results: dict = {}

    # (a) K2 on the Earth frame
    t0 = time.perf_counter()
    inputs = earth_kernel_ablation.frame("cuda")
    tiles, blocks, u, cfg, plan, max_value = inputs
    tiles, batch, args = meshgen.fused_kernel_args(tiles, blocks, u, cfg, plan, max_value)
    n = int(tiles.tile_count)
    live_hp = int(((args[5] == 2).repeat_interleave(kernels.TILES_PER_STEP)
                   & (torch.arange(args[1].shape[0], device="cuda") < n)).sum())
    print(f"ablation: Earth frame streamed and settled in {time.perf_counter() - t0:.1f} s: "
          f"{n} tiles (capacity {cfg.tile_capacity}), {int(batch.n_unique)} unique quads, "
          f"{live_hp} tiles on high-precision steps")
    if n <= 100 or int(tiles.overflow):
        raise AssertionError("ablation: the Earth frame is small or overflows")
    nbound = mesh_bound(args, int(batch.n_unique), kernels.SPH_CH, n, live_hp, "sphere")
    ablation_rows("Earth frame", kernels.mesh_fused_spherical,
                  kernels.mesh_fused_spherical_reference, args,
                  earth_kernel_ablation.VARIANTS, compare_spherical, nbound, results, card)
    earth_kernel_ablation.run_variants(inputs, on_card=True)
    del inputs, blocks, args, batch

    # (b) K1, K3 and K4 on the bench frame
    inputs = material_kernel_ablation.scene("cuda")
    tiles, blocks, u, cfg, plan, albedo = inputs
    tiles, batch, base = meshgen.fused_kernel_args(tiles, blocks, u, cfg, plan, 65535.0)
    n, n_unique, Fp = int(tiles.tile_count), int(batch.n_unique), base[1].shape[0]
    print(f"ablation: bench frame {n} tiles, {n_unique} unique quads")
    nbound = mesh_bound(base, n_unique, kernels.OUT_CH, n, 0, "planar")
    ablation_rows("bench frame", kernels.mesh_fused_planar, kernels.mesh_fused_planar_reference,
                  base, K1_ABLATIONS, compare, nbound, results, card)
    # the material kernels' variants: the tool's, and K1's two mesh pieces
    # (their mesh rows are K1's with the same piece removed)
    variants = material_kernel_ablation.VARIANTS + list(K1_ABLATIONS[1:])
    mesh_rows = {name: kernels.mesh_fused_planar(*base, ablate=abl & kernels.MESH_ABLATE)
                 for name, abl in variants}
    spec = material_kernel_ablation.shade_material()
    shade = kernels.pack_shade_spec(spec, "cuda")
    light_ops = sum(OPS_SHADE_LIGHT[light[0]] for light in spec[5])
    for shaded in (False, True):
        wrapper = kernels.mesh_fused_shaded if shaded else kernels.mesh_fused_albedo
        plain = (kernels.mesh_fused_shaded_reference if shaded
                 else kernels.mesh_fused_albedo_reference)
        args = (*base, albedo, 4, 8, *((shade,) if shaded else ()), True, False)
        # the fast path's count (the full kernel's bound on these inputs)
        nbytes = (2 * n_unique * QUAD_BYTES + tensor_bytes(*base[1:6])
                  + (tensor_bytes(shade) if shaded else 0)
                  + Fp * (kernels.OUT_CH + 4) * GV2 * 4)
        ops = (n * (OPS_TILE + GV2 * OPS_VERTEX["planar"])
               + n * 4 * (OPS_ALB_HALF + GV2 * OPS_ALB_VERTEX)
               + (n * GV2 * (OPS_SHADE_VERTEX + light_ops) if shaded else 0))
        ablation_rows("bench frame", wrapper, plain, args, variants,
                      material_check(mesh_rows, shaded, variants), bound(nbytes, ops), results, card)
        material_kernel_ablation.run_variants(inputs, on_card=True, shade=shaded)
    del inputs, blocks, albedo, base, mesh_rows
    torch.cuda.empty_cache()
    print(f"ablation path: {time.perf_counter() - t_path:.1f} s in all; {card}")
    return results


def study_tools_path(card: str) -> None:
    """The study tools on the card: (c) tools_torch/raster_ablation.py on the
    bench frame's mesh (random heights) at 1920x1080: the candidates each
    cap of :data:`RASTER_CAP_SWEEP` drops, up to the first that drops none,
    and the stages timed at the JAX tool's knobs (the material frame's
    sweep and its scan time are in material_raster_path); (d) tools_torch/rust_interchange.py --check (the
    committed hashes of tools/interchange_expected.json it reproduced, and
    those it could not make); (e) tools_torch/make_goldens.py into a
    temporary directory, held to tests/goldens/; (f)
    tools_torch/morph_gating_analysis.py's counts."""
    import torch

    from tools_torch import make_goldens, morph_gating_analysis, raster_ablation, rust_interchange

    t_path = t0 = time.perf_counter()
    mesh, vp32, n = raster_ablation.scene_mesh("cuda")
    width, height = RASTER_SIZE
    knobs = {k: v for k, v in RASTER_KNOBS.items() if k != "bin_cap"}
    for cap in RASTER_CAP_SWEEP:
        drops = raster_ablation.dropped(mesh, vp32, width, height, bin_cap=cap, **knobs)
        print(f"raster ablation: bench frame ({n} tiles, random heights) at {width}x{height}, "
              f"bin_cap {cap}: {drops} candidates dropped")
        if drops == 0:
            break
    row = raster_ablation.stages(mesh, vp32, width, height, **RASTER_KNOBS)
    print(f"raster ablation: bench frame, stages at {RASTER_KNOBS}: " + ", ".join(
        f"{k} {v:.4f}" for k, v in row["ms"].items()) + f" ms (device); {card} "
          f"({time.perf_counter() - t0:.1f} s)")
    del mesh
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    kit = rust_interchange.check("cuda")
    print(f"interchange: {kit['reproduced']} of {kit['expected']} committed hashes reproduced "
          f"on the card; not made: {kit['not_made'] or 'none'} ({time.perf_counter() - t0:.1f} s)")
    if kit["reproduced"] + len(kit["not_made"]) != kit["expected"]:
        raise AssertionError("interchange: a committed hash was neither reproduced nor named")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        make_goldens.write(Path(tmp), "cuda")
        goldens = make_goldens.compare(Path(tmp))
    print(f"goldens: {len(goldens)} of tests/goldens/ reproduced on the card: "
          f"{json.dumps(goldens)} ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    gating = morph_gating_analysis.main([])
    print(f"morph gating: {json.dumps(gating)} ({time.perf_counter() - t0:.1f} s)")
    print(f"study tools path: {time.perf_counter() - t_path:.1f} s in all; {card}")


def ablation_resources(log: str, lib: Path) -> None:
    """Registers, shared memory and spills of each ablated instance (its
    ``ptxas -v`` report), and from ``cuobjdump -sass`` of the library its
    instructions and its cp.async copies (LDGSTS): every instance, the
    ``no_phase_a`` ones too, must still copy its quads."""
    from bevy_terrain_tpu_torch.ops import kernels

    names = {bit: name for name, bit in kernels.ABLATE_BITS.items()}

    def label(mask: int) -> str:
        return "+".join(names[b] for b in sorted(names) if mask & b)

    for head, regs, smem, spill in ptxas_entries(log):
        for pattern, name in ABLATED_INSTANCES.items():
            m = re.search(pattern, head)
            if m:
                print(f"resources: {name}[{label(int(m.group(1)))}]: {regs} registers, "
                      f"{smem} bytes shared memory, {spill} bytes spill stores")
    cuobjdump = Path(kernels._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    for fn in re.split(r"\n\s+Function : ", sass)[1:]:
        head = fn.split("\n", 1)[0]
        for pattern, name in ABLATED_INSTANCES.items():
            m = re.search(pattern, head)
            if not m:
                continue
            instr = len(re.findall(r"/\*[0-9a-f]{4,}\*/", fn))
            copies = len(re.findall(r"\bLDGSTS\b", fn))
            print(f"sass: {name}[{label(int(m.group(1)))}]: {instr} instructions, {copies} "
                  f"LDGSTS (cp.async)")
            if copies == 0:
                raise AssertionError(f"{name}[{label(int(m.group(1)))}]: no cp.async left")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from bevy_terrain_tpu_torch.ops import kernels

    if argv[:1] == ["--native-child"]:
        return native_child(Path(argv[1]))
    n_cards = int(argv[argv.index("--multi-card") + 1]) if "--multi-card" in argv else 0
    if torch.cuda.device_count() < n_cards:
        raise RuntimeError(f"--multi-card {n_cards}: {torch.cuda.device_count()} cards visible")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name} ({torch.cuda.device_count()} visible); nvidia-smi: {card}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        lib = kernels.build_library(verbose=True)
    print(log.getvalue(), end="")
    print(f"build: {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    print_resources(log.getvalue())
    if hasattr(kernels, "kernel_occupancy"):  # not in the trees before it
        print_occupancy()
    if "--kernel-phases" not in argv:
        native_build_line(card)

    results: dict = {}
    if n_cards:
        launches = multi_card_path(n_cards)
        print(json.dumps({"multi_card": {"ranks": n_cards, "launches": launches}}))
        print(f"card: {card}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
        return 0
    if "--ablation" in argv:
        reset_ablated_counts()
        rows = ablation_path(card)
        print(json.dumps({"ablation": rows, "launches": ablated_counts()}))
        study_tools_path(card)
        return 0
    kernel_phase(results)
    sphere_kernel_phase(results)
    material_kernel_phase(results)
    halfgrid_kernel_phase(results)
    if "--kernel-phases" in argv:
        print(json.dumps({"kernel_phases": results}))
        return 0
    native_path()
    # the kernel-free frames' launches (pallas_sampling=False): a field of
    # their own, beside the main paths' counts
    off_counts: dict = {}
    counts = {"mesh_fused_planar": main_path_phase(off_counts),
              **sphere_main_path_phase(),
              **sphere_material_main_path_phase(),
              **material_main_path_phase(off_counts),
              "fetch_resample": sweep_path()}
    vertex_main_path_phase()
    preprocess_path_phase()
    entry_points_path()
    # the NCCL rank's launches over its run: a field of their own (the
    # rank is another process and another run than the main path's)
    rank_counts = multi_view_path()
    reset_counts()
    reset_ablated_counts()
    ablated = ablation_path(card)
    ablated_launches = ablated_counts()
    missing = sorted(set(ablated) - {k for k, v in ablated_launches.items() if v})
    if missing:
        raise AssertionError(f"ablation path: instances never launched: {missing}")
    study_tools_path(card)

    replaces = {k: rep for k, _, _, rep in KERNELS}
    print(json.dumps({"kernels": [
        {"name": k, "route": route, "source": src, "replaces": rep,
         "launches": counts[k], **results[k], "multi_card_launches": rank_counts.get(k, 0),
         "pallas_sampling_off_launches": off_counts.get(k, 0)}
        for k, route, src, rep in KERNELS
    ] + [
        {"name": k, "route": "cuda", "source": "bevy_terrain_tpu_torch/csrc/mesh_fused.cu",
         "replaces": replaces[k.split("[", 1)[0]], "launches": ablated_launches[k], **row}
        for k, row in ablated.items()
    ]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
