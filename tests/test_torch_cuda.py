"""The torch package on an NVIDIA card: CUDA kernels against their plain
versions, and the device stage on the card against the CPU.

Every test here needs a card and skips without one. The file imports no
jax, so it also runs where jax is not installed; there, skip the repo's
conftest (which configures jax):

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from bevy_terrain_tpu_torch.config import TerrainViewConfig
from bevy_terrain_tpu_torch.math import TerrainModel, TerrainModelApproximation, frustum
from bevy_terrain_tpu_torch.ops import kernels, meshgen, patch_sampling, refinement, tile_tree
from bevy_terrain_tpu_torch.ops.params import (
    StaticTerrainConfig, pack_frame_uniforms, unpack_frame_uniforms,
)

LODS = 3
# kernel vs plain version: both f32, differing in summation order and libm ulps
TOL_POS, TOL_UV = 5e-3, 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


def _scene(capacity=256):
    """Planar 1000 m terrain, 3 lods, random atlas entries and blocks."""
    model = TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0)
    vc = TerrainViewConfig(tile_capacity=capacity)
    view = np.array([30.0, 60.0, -20.0])
    origins, vt_int, vt_frac = tile_tree.compute_view_anchors(model, view, LODS, 8)
    approx = TerrainModelApproximation.compute(model, view, vc.origin_lod, 50.0)
    rng = np.random.default_rng(5)
    entries = np.zeros((1, LODS, 8, 8, 2), np.int32)
    entries[..., 0] = rng.integers(-1, 16, (1, LODS, 8, 8))
    entries[..., 1] = np.arange(LODS)[None, :, None, None]
    blob = pack_frame_uniforms(model, view, approx, origins, entries, vt_int, vt_frac, vc)
    plan = patch_sampling.make_patch_plan(512, 4, 2)
    blocks = rng.integers(0, 65535, (16 * plan.total_blocks_per_slot, 32, 128)).astype(np.int32)
    cfg = StaticTerrainConfig(
        spherical=False, side_count=1, lod_count=LODS, tree_size=8, grid_size=16,
        refinement_count=8, queue_capacity=256, tile_capacity=capacity,
        origin_lod=vc.origin_lod,
    )
    return blob, blocks, cfg, plan


def _stage(blob, blocks, cfg, plan, device):
    u = unpack_frame_uniforms(torch.from_numpy(blob).to(device), 1, LODS, 8)
    tiles = refinement.refine_tiles(u, cfg)
    return meshgen.fused_kernel_args(tiles, torch.from_numpy(blocks).to(device), u, cfg,
                                     plan, 65535.0)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [64, 256])
def test_mesh_kernel_matches_plain_version(capacity):
    dev = _card()
    _, _, args = _stage(*_scene(capacity), dev)
    before = kernels.mesh_fused_planar.launches
    got = kernels.mesh_fused_planar(*args)
    torch.cuda.synchronize()
    assert kernels.mesh_fused_planar.launches == before + 1
    want = kernels.mesh_fused_planar_reference(*args)
    err = (got - want).abs()
    assert float(err[:, :4].max()) <= TOL_POS
    assert float(err[:, 4:].max()) <= TOL_UV
    n = int(args[-1])
    assert not got[n:].any()


@pytest.mark.cuda
def test_device_stage_matches_cpu():
    """Refinement and patch plan on the card give the CPU's tile list and
    plan; the mesh agrees to the kernel tolerance."""
    dev = _card()
    scene = _scene()
    tiles, batch, args = _stage(*scene, dev)
    ctiles, cbatch, cargs = _stage(*scene, "cpu")
    for field in ("tile_side", "tile_lod", "tile_xy", "tile_count", "overflow"):
        assert torch.equal(getattr(tiles, field).cpu(), getattr(ctiles, field)), field
    for field in ("uq", "slots", "rank_lo", "rank_hi", "n_unique", "ids"):
        assert torch.equal(getattr(batch, field).cpu(), getattr(cbatch, field)), field
    torch.testing.assert_close(batch.geom.cpu(), cbatch.geom, rtol=0, atol=1e-5)
    got = kernels.mesh_fused_planar(*args).cpu()
    want = kernels.mesh_fused_planar(*cargs)
    assert float((got - want)[:, :4].abs().max()) <= TOL_POS
    assert float((got - want)[:, 4:].abs().max()) <= TOL_UV


@pytest.mark.cuda
def test_wrapper_rejects_mixed_devices():
    dev = _card()
    _, _, args = _stage(*_scene(64), dev)
    with pytest.raises(ValueError):
        kernels.mesh_fused_planar(args[0], args[1].cpu(), *args[2:])


# spherical kernel vs plain version (same inputs, same per-vertex op order):
# heights differ by the resample's summation order over a 9 km range; an
# absolute world position at 6.4e6 m rounds to 0.5 m steps
SPH_TOL = {"heights": 2e-2, "positions": 1.02, "uvs": 1e-6, "normals": 1e-6}


def _sphere_scene(kind, altitude):
    """tests/test_fused_mesh.py's small frame (Earth radius, 4 lods,
    capacity 128, origin_lod 2, random atlas entries over 3 data lods and
    random blocks) at 20 km, on the sphere or the WGS84-like ellipsoid; at
    3 km a culled camera, 256 slots and origin_lod 6 put vertices inside the
    precision threshold (the Taylor near field)."""
    lods = 4
    near = altitude < 10_000.0
    if kind == "sphere":
        model = TerrainModel.sphere(np.zeros(3), 6.371e6, 0.0, 9000.0)
    else:
        model = TerrainModel.ellipsoid(np.zeros(3), 6_378_137.0, 6_356_752.3, 0.0, 9000.0)
    capacity, origin_lod = (256, 6) if near else (128, 2)
    vc = TerrainViewConfig(tile_capacity=capacity, origin_lod=origin_lod,
                           **({"morph_distance": 2.0} if near else {}))
    anchor = np.array([0.3, 0.2, 0.93])
    view = model.position_local_to_world(anchor / np.linalg.norm(anchor), altitude)
    vp = frustum.view_projection(view, view * 0.5, np.pi / 3, 16 / 9) if near else None
    origins, vt_int, vt_frac = tile_tree.compute_view_anchors(model, view, lods, 8)
    approx = TerrainModelApproximation.compute(model, view, origin_lod, 4500.0)
    rng = np.random.default_rng(2)
    entries = np.zeros((6, lods, 8, 8, 2), np.int32)
    entries[..., 0] = rng.integers(0, 16, (6, lods, 8, 8))
    entries[..., 1] = np.minimum(np.arange(lods), 2)[None, :, None, None]
    blob = pack_frame_uniforms(model, view, approx, origins, entries, vt_int, vt_frac, vc,
                               view_proj=vp)
    plan = patch_sampling.make_patch_plan(512, 4, 2)
    blocks = rng.integers(0, 65535, (16 * plan.total_blocks_per_slot, 32, 128)).astype(np.int32)
    cfg = StaticTerrainConfig(
        spherical=True, side_count=6, lod_count=lods, tree_size=8, grid_size=16,
        refinement_count=14 if near else 6, queue_capacity=512, tile_capacity=capacity,
        origin_lod=origin_lod, high_precision=True, ellipsoidal=kind == "ellipsoid",
        culling=near,
    )
    return blob, blocks, cfg, plan


@pytest.mark.cuda
@pytest.mark.parametrize("kind,altitude", [("sphere", 20_000.0), ("ellipsoid", 20_000.0),
                                           ("sphere", 3_000.0)])
def test_spherical_kernel_matches_plain_version(kind, altitude):
    dev = _card()
    blob, blocks, cfg, plan = _sphere_scene(kind, altitude)
    u = unpack_frame_uniforms(torch.from_numpy(blob).to(dev), 6, cfg.lod_count, 8)
    tiles = refinement.refine_tiles(u, cfg)
    _, _, args = meshgen.fused_kernel_args(tiles, torch.from_numpy(blocks).to(dev), u, cfg,
                                           plan, 65535.0)
    if altitude < 10_000.0:
        assert bool((args[5] == 2).any())  # the Taylor near field is exercised
    before = kernels.mesh_fused_spherical.launches
    got = kernels.mesh_fused_spherical(*args)
    torch.cuda.synchronize()
    assert kernels.mesh_fused_spherical.launches == before + 1
    want = kernels.mesh_fused_spherical_reference(*args)
    err = (got - want).abs()
    for name, sl in (("heights", slice(0, 1)), ("positions", slice(1, 4)),
                     ("uvs", slice(4, 6)), ("normals", slice(6, 9))):
        assert float(err[:, sl].max()) <= SPH_TOL[name], name
    n = int(args[6])
    assert n > 0 and not got[n:].any()


# -- material kernels (K3 albedo, K4 shade, K5 samplers) vs their plain versions

# of full scale: the exact resample differs from the plain version's by the
# summation order only; the bf16 fast path rounds its y sums to bf16, where
# one step is up to 1/255 of full scale for 8-bit texels
TOL_EXACT, TOL_FAST = 1e-5, 2.0 / 255.0


def _packed(shape, channels, bits, seed):
    rng = np.random.default_rng(seed)
    words = np.zeros(shape, np.uint32)
    for c in range(channels):
        words |= rng.integers(0, 1 << bits, shape).astype(np.uint32) << (bits * c)
    return words.view(np.int32)


def _material_spec():
    from bevy_terrain_tpu_torch.render.material import (
        DirectionalLight, PointLight, SpotLight, StandardMaterial, albedo_material,
        kernel_shade_spec,
    )

    material = StandardMaterial(
        base_color=albedo_material(1), perceptual_roughness=0.6, metallic=0.2,
        reflectance=0.4,
        lights=(DirectionalLight(direction=(-0.3, -0.8, -0.5), color=(1.0, 0.9, 0.8),
                                 illuminance=0.9),
                PointLight(position=(120.0, 300.0, -80.0), range=3000.0, intensity=0.5),
                SpotLight(position=(0.0, 200.0, 0.0), direction=(0.1, -1.0, 0.2),
                          range=2000.0, intensity=0.7, inner_angle=0.3, outer_angle=0.7)),
    )
    return kernel_shade_spec(material, 255.0)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["fast", "exact", "opaque", "combined", "shaded_exact",
                                  "shaded_fast"])
def test_material_kernel_matches_plain_version(form):
    dev = _card()
    blob, blocks, cfg, plan = _scene(256)
    albedo = torch.from_numpy(_packed(blocks.shape, 4, 8, 7)).to(dev)
    _, _, args = _stage(blob, blocks, cfg, plan, dev)
    channels = 3 if form == "opaque" else 4
    fast = form in ("fast", "opaque", "combined", "shaded_fast")
    if form == "combined":
        base = (torch.cat([args[0], albedo], dim=1), *args[1:6], None)
    else:
        base = (*args[:6], albedo)
    shaded = form.startswith("shaded")
    if shaded:
        shade = kernels.pack_shade_spec(_material_spec(), dev)
        kargs = (*base, channels, 8, shade, fast, form == "combined")
        wrapper, plain = kernels.mesh_fused_shaded, kernels.mesh_fused_shaded_reference
    else:
        kargs = (*base, channels, 8, fast, form == "combined")
        wrapper, plain = kernels.mesh_fused_albedo, kernels.mesh_fused_albedo_reference
    before = wrapper.launches
    got = wrapper(*kargs)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    mesh = kernels.mesh_fused_planar(*args)
    assert torch.equal(got[:, :6], mesh)  # the mesh rows are K1's, bit for bit
    want = plain(*kargs)
    err = float((got[:, 6:] - want[:, 6:]).abs().max())
    scale = 1.0 if shaded else 255.0
    tol = (TOL_FAST if fast else (1e-4 if shaded else TOL_EXACT)) * scale
    assert err <= tol, (form, err)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["fast", "exact", "opaque", "combined"])
@pytest.mark.parametrize("kind,altitude", [("sphere", 20_000.0), ("ellipsoid", 20_000.0),
                                           ("sphere", 3_000.0)])
def test_spherical_albedo_kernel_matches_plain_version(kind, altitude, form):
    """K3s: the mesh channels are K2's bit for bit, the colours the plain
    version's (fast path bit-equal sums, held to 2/255)."""
    dev = _card()
    blob, blocks, cfg, plan = _sphere_scene(kind, altitude)
    albedo = torch.from_numpy(_packed(blocks.shape, 4, 8, 9)).to(dev)
    u = unpack_frame_uniforms(torch.from_numpy(blob).to(dev), 6, cfg.lod_count, 8)
    tiles = refinement.refine_tiles(u, cfg)
    _, _, args = meshgen.fused_kernel_args(tiles, torch.from_numpy(blocks).to(dev), u, cfg,
                                           plan, 65535.0)
    channels = 3 if form == "opaque" else 4
    fast, combined = form != "exact", form == "combined"
    if combined:
        kargs = (torch.cat([args[0], albedo], dim=1), *args[1:], None, channels, 8, fast, True)
    else:
        kargs = (*args, albedo, channels, 8, fast, False)
    before = kernels.mesh_fused_spherical_albedo.launches
    got = kernels.mesh_fused_spherical_albedo(*kargs)
    torch.cuda.synchronize()
    assert kernels.mesh_fused_spherical_albedo.launches == before + 1
    assert got.shape == (args[1].shape[0], 9 + channels, 17, 17)
    assert torch.equal(got[:, :9], kernels.mesh_fused_spherical(*args))
    want = kernels.mesh_fused_spherical_albedo_reference(*kargs)
    err = float((got[:, 9:] - want[:, 9:]).abs().max()) / 255.0
    assert err <= (TOL_FAST if fast else TOL_EXACT), (form, err)
    n = int(args[6])
    assert got[:n, 9:].any() and not got[n:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("channels,bits", [(1, 0), (4, 8), (2, 16)])
def test_attach_kernel_matches_plain_version(channels, bits):
    dev = _card()
    blob, blocks, cfg, plan = _scene(256)
    if bits:
        blocks = _packed(blocks.shape, channels, bits, 9)
    tiles, batch, args = _stage(blob, blocks, cfg, plan, dev)
    rng = np.random.default_rng(3)
    uvs = torch.from_numpy(rng.uniform(0, 1, (batch.ids.shape[0], 2, 17, 17))
                           .astype(np.float32)).to(dev)
    call = (args[0], batch.ids, batch.geom, uvs, args[5])
    if bits:
        wrapper = kernels.attach_sample_fused_packed
        got = wrapper(*call, channels, bits)
        want = kernels.attach_sample_fused_packed_reference(*call, channels, bits)
    else:
        wrapper = kernels.attach_sample_fused
        got = wrapper(*call)
        want = kernels.attach_sample_fused_reference(*call)
    torch.cuda.synchronize()
    assert wrapper.launches > 0 and got.shape == (batch.ids.shape[0], channels, 17, 17)
    full = 65535.0 if bits in (0, 16) else 255.0
    assert float((got - want).abs().max()) <= TOL_EXACT * full
    assert not got[int(tiles.tile_count):].any()


# -- ablated instances (the ablation library) vs their plain versions ---------

# (kernel, the ablate names it reads); planar kernels on _scene(256), spherical
# ones on _sphere_scene at 3 km (the Taylor near field runs)
_ABLATION_KERNELS = {
    "planar": kernels.MESH_ABLATE, "sphere": kernels.SPHERE_ABLATE,
    "ellipsoid": kernels.SPHERE_ABLATE,
    "albedo": kernels.MESH_ABLATE | kernels.ALBEDO_ABLATE,
    "shaded": kernels.MESH_ABLATE | kernels.ALBEDO_ABLATE,
    "sphere_albedo": kernels.SPHERE_ABLATE | kernels.ALBEDO_ABLATE,
    "ellipsoid_albedo": kernels.SPHERE_ABLATE | kernels.ALBEDO_ABLATE,
}
ABLATION_CASES = [
    (kind, frozenset(n for n, bit in kernels.ABLATE_BITS.items() if mask & bit))
    for kind, names in _ABLATION_KERNELS.items()
    for mask in sorted(kernels.ablation_masks(names))
]


def _ablation_call(kind, dev):
    """(wrapper, plain version, kernel arguments, mesh rows) of ``kind``."""
    spherical = kind.startswith(("sphere", "ellipsoid"))
    if spherical:
        blob, blocks, cfg, plan = _sphere_scene(kind.split("_")[0], 3_000.0)
        u = unpack_frame_uniforms(torch.from_numpy(blob).to(dev), 6, cfg.lod_count, 8)
        _, _, args = meshgen.fused_kernel_args(refinement.refine_tiles(u, cfg),
                                               torch.from_numpy(blocks).to(dev), u, cfg, plan,
                                               65535.0)
    else:
        blob, blocks, cfg, plan = _scene(256)
        _, _, args = _stage(blob, blocks, cfg, plan, dev)
    albedo = torch.from_numpy(_packed(blocks.shape, 4, 8, 7)).to(dev)
    if kind in ("planar", "sphere", "ellipsoid"):
        wrapper = kernels.mesh_fused_spherical if spherical else kernels.mesh_fused_planar
        plain = (kernels.mesh_fused_spherical_reference if spherical
                 else kernels.mesh_fused_planar_reference)
        return wrapper, plain, args, 9 if spherical else 6
    if spherical:
        return (kernels.mesh_fused_spherical_albedo, kernels.mesh_fused_spherical_albedo_reference,
                (*args, albedo, 4, 8, True, False), 9)
    if kind == "shaded":
        shade = kernels.pack_shade_spec(_material_spec(), dev)
        return (kernels.mesh_fused_shaded, kernels.mesh_fused_shaded_reference,
                (*args, albedo, 4, 8, shade, True, False), 6)
    return kernels.mesh_fused_albedo, kernels.mesh_fused_albedo_reference, \
        (*args, albedo, 4, 8, True, False), 6


@pytest.mark.cuda
@pytest.mark.parametrize("kind,ablate", ABLATION_CASES,
                         ids=[f"{k}-{kernels.ablate_label(a)}" for k, a in ABLATION_CASES])
def test_ablated_kernel_matches_plain_version(kind, ablate):
    """Every ablated CUDA instance against its plain version with the same
    ``ablate``: mesh rows at the unablated kernels' tolerances, colours of
    full scale (the largest magnitude with ``alb_no_unpack``'s raw words)
    on the path the variant takes; counted as an ablated launch."""
    dev = _card()
    wrapper, plain, kargs, base = _ablation_call(kind, dev)
    label = kernels.ablate_label(ablate)
    before = wrapper.ablated_launches.get(label, 0)
    got = wrapper(*kargs, ablate=ablate)
    torch.cuda.synchronize()
    assert wrapper.ablated_launches[label] == before + 1
    want = plain(*kargs, ablate=ablate)
    err = (got - want).abs()
    if base == 9:
        for name, sl in (("heights", slice(0, 1)), ("positions", slice(1, 4)),
                         ("uvs", slice(4, 6)), ("normals", slice(6, 9))):
            assert float(err[:, sl].max()) <= SPH_TOL[name], name
    else:
        assert float(err[:, :4].max()) <= TOL_POS
        assert float(err[:, 4:6].max()) <= TOL_UV
    if got.shape[1] > base:
        shaded = wrapper is kernels.mesh_fused_shaded
        exact = bool(ablate & kernels.ALBEDO_EXACT_ABLATE)
        scale = 1.0 if shaded else 255.0
        if "alb_no_unpack" in ablate:
            scale = max(scale, float(want[:, base:].abs().max()))
        tol = (1e-4 if shaded else TOL_EXACT) if exact else TOL_FAST
        assert float(err[:, base:].max()) / scale <= tol
    n = int(kargs[6] if base == 9 else kargs[5])
    assert torch.isfinite(got).all() and not got[n:].any()


@pytest.mark.cuda
def test_ablation_without_an_instance_raises():
    """A combination of names that no CUDA instance covers raises on the
    card; the plain version takes it."""
    dev = _card()
    _, _, args = _stage(*_scene(64), dev)
    with pytest.raises(ValueError):
        kernels.mesh_fused_planar(*args, ablate={"no_smooth", "no_phase_a"})
    kernels.mesh_fused_planar_reference(*args, ablate={"no_smooth", "no_phase_a"})


# -- half-grid kernels (K6 fetch_resample_cached, K7 fetch_resample) vs their
# plain versions, in raw texel units on values up to 65535: f32 sums on both
# sides, differing in summation order and, for K6, in the patch mean (an exact
# integer sum in the kernel)
TOL_HALFGRID = 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("ratio", [None, 0.0, 1.0], ids=["planned", "ratio0", "ratio1"])
def test_halfgrid_kernels_match_plain_versions(ratio):
    dev = _card()
    blob, blocks, cfg, plan = _scene(256)
    cfg = dataclasses.replace(cfg, blend_per_vertex=False)  # the plan carries the ratio
    u = unpack_frame_uniforms(torch.from_numpy(blob).to(dev), 1, LODS, 8)
    tiles, batch = patch_sampling.plan_patch_batch(refinement.refine_tiles(u, cfg), u, cfg, plan,
                                                   blocks.shape[0])
    geom = batch.geom.clone()
    if ratio is not None:
        geom[:, 4] = ratio
    quads = torch.from_numpy(blocks).to(dev)
    count = tiles.tile_count.reshape(1).to(torch.int32)
    n = int(count)
    before = kernels.fetch_resample_cached.launches, kernels.fetch_resample.launches
    k6 = kernels.fetch_resample_cached(quads, batch.ids, geom, count)
    ids4 = batch.ids[:, None].expand(-1, 4).contiguous()
    k7 = kernels.fetch_resample(quads, ids4, geom)
    torch.cuda.synchronize()
    assert (kernels.fetch_resample_cached.launches, kernels.fetch_resample.launches) == (
        before[0] + 1, before[1] + 1)
    want6 = kernels.fetch_resample_cached_reference(quads, batch.ids, geom, count)
    want7 = kernels.fetch_resample_reference(quads, ids4, geom)
    assert float((k6 - want6).abs().max()) <= TOL_HALFGRID
    assert float((k7 - want7).abs().max()) <= TOL_HALFGRID
    assert float(k6.abs().max()) > 30000.0 and not k6[n:].any()
    # K7 re-ordered evens-first is K6 on the live tiles (K7 knows no tile_count)
    both = patch_sampling.permute_halfgrid(k7)[:n] - k6[:n]
    assert float(both.abs().max()) <= TOL_HALFGRID
    # a shorter tile_count zeroes the tail, whatever the tiles' valid flags
    cut = kernels.fetch_resample_cached(quads, batch.ids, geom,
                                        torch.tensor([5], dtype=torch.int32, device=dev))
    assert torch.equal(cut[:5], k6[:5]) and not cut[5:].any()


@pytest.mark.cuda
def test_staged_mesh_launches_the_halfgrid_kernel():
    """generate_mesh_grid on the card: K6 once, no mesh kernel, and the mesh
    within the fused-vs-staged yardsticks of the fused kernel's."""
    dev = _card()
    blob, blocks, cfg, plan = _scene(256)
    cfg = dataclasses.replace(cfg, blend_per_vertex=True)
    u = unpack_frame_uniforms(torch.from_numpy(blob).to(dev), 1, LODS, 8)
    refined = refinement.refine_tiles(u, cfg)
    quads = torch.from_numpy(blocks).to(dev)
    before = kernels.fetch_resample_cached.launches, kernels.mesh_fused_planar.launches
    mesh, tiles = meshgen.generate_mesh_grid(refined, quads, u, cfg, plan, 65535.0)
    assert (kernels.fetch_resample_cached.launches, kernels.mesh_fused_planar.launches) == (
        before[0] + 1, before[1])
    raw, ftiles = meshgen.generate_mesh_fused(refined, quads, u, cfg, plan, 65535.0)
    fused = meshgen.fused_to_grid(raw, ftiles, cfg)
    assert torch.equal(tiles.tile_xy, ftiles.tile_xy)
    assert float((mesh.heights - fused.heights).abs().max()) <= 2e-2
    assert float((mesh.positions - fused.positions).abs().max()) <= 2e-2
    assert float((mesh.uvs - fused.uvs).abs().max()) <= 1e-6


# -- the run-of-tiles kernels (K3 / K4 material mesh, K5 samplers) on tile
# orders and counts the patch plan does not give: a block walks an equal
# share of consecutive tiles (a grid of MATERIAL_WAVES / SAMPLER_WAVES waves
# of resident blocks) and keeps the quad it holds while the ids repeat,
# which must be right for any ids, any tile_count and any tile total

ID_CASES = ["sorted", "permuted", "one_quad", "count_0", "count_full", "ragged"]


def _id_case(case, ids, per_tile, live):
    """The frame's tiles re-arranged for one case: (ids, the per-tile
    tensors, tile_count as an int32 tensor). The plan's ``live`` tiles lead
    (a dead tail follows, at capacity 2048 some 250 tiles); "permuted" shuffles the
    live tiles (runs of one tile), "one_quad" puts every tile on the first
    tile's quad, "ragged" drops three tiles so that the total is no multiple
    of most grids' block counts."""
    F = ids.shape[0]
    count = {"count_0": 0, "count_full": F}.get(case, live)
    if case == "permuted":
        perm = torch.from_numpy(np.concatenate([np.random.default_rng(4).permutation(live),
                                                np.arange(live, F)])).to(ids.device)
        ids, per_tile = ids[perm], [x[perm].contiguous() for x in per_tile]
    elif case == "one_quad":
        ids = torch.full_like(ids, int(ids[0]))
    elif case == "ragged":
        ids, per_tile = ids[:F - 3], [x[:F - 3].contiguous() for x in per_tile]
    return (ids.contiguous(), per_tile,
            torch.tensor([min(count, ids.shape[0])], dtype=torch.int32, device=ids.device))


def _each_grid(attr, call, waves=(1, 2, 4, 64)):
    """``call()`` on grids of ``waves`` waves of resident blocks
    (kernels.<attr>; 64 waves give every tile a block of its own); the
    outputs must be bit-equal. Returns the output at the module's value."""
    saved = getattr(kernels, attr)
    try:
        outs = {}
        for w in (*waves, saved):
            setattr(kernels, attr, w)
            outs[w] = call()
    finally:
        setattr(kernels, attr, saved)
    for w, out in outs.items():
        assert torch.equal(out, outs[saved]), w
    return outs[saved]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ID_CASES)
@pytest.mark.parametrize("form", ["fast", "exact", "opaque", "combined"])
def test_shaded_kernel_on_any_tile_order(form, case):
    """K4 against its plain version, its mesh rows against K1's bit for bit,
    on every grid, with zeros past tile_count."""
    dev = _card()
    blob, blocks, cfg, plan = _scene(2048)
    albedo = torch.from_numpy(_packed(blocks.shape, 4, 8, 7)).to(dev)
    _, _, args = _stage(blob, blocks, cfg, plan, dev)
    quads, ids, geom, tp, fs, live = args
    ids, (geom, tp), count = _id_case(case, ids, [geom, tp], int(live))
    channels, fast = (3 if form == "opaque" else 4), form != "exact"
    if form == "combined":
        base = (torch.cat([quads, albedo], dim=1), ids, geom, tp, fs, count, None)
    else:
        base = (quads, ids, geom, tp, fs, count, albedo)
    shade = kernels.pack_shade_spec(_material_spec(), dev)
    kargs = (*base, channels, 8, shade, fast, form == "combined")
    before = kernels.mesh_fused_shaded.launches
    got = _each_grid("MATERIAL_WAVES", lambda: kernels.mesh_fused_shaded(*kargs))
    torch.cuda.synchronize()
    assert kernels.mesh_fused_shaded.launches == before + 5
    n = int(count)
    assert got.shape == (ids.shape[0], 6 + channels, 17, 17) and not got[n:].any()
    assert torch.equal(got[:, :6], kernels.mesh_fused_planar(quads, ids, geom, tp, fs, count))
    want = kernels.mesh_fused_shaded_reference(*kargs)
    err = float((got[:, 6:] - want[:, 6:]).abs().max())
    assert err <= (TOL_FAST if fast else 1e-4), (form, case, err)
    assert n == 0 or bool(got[:n, 6:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ID_CASES)
@pytest.mark.parametrize("channels,bits", [(1, 0), (4, 8), (2, 16)])
def test_attach_kernel_on_any_tile_order(channels, bits, case):
    """K5a / K5b against their plain versions on every grid, with zeros past
    tile_count."""
    dev = _card()
    blob, blocks, cfg, plan = _scene(2048)
    if bits:
        blocks = _packed(blocks.shape, channels, bits, 9)
    tiles, batch, args = _stage(blob, blocks, cfg, plan, dev)
    uvs = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (batch.ids.shape[0], 2, 17, 17)).astype(np.float32)).to(dev)
    ids, (geom, uvs), count = _id_case(case, batch.ids, [batch.geom, uvs],
                                       int(tiles.tile_count))
    call = (args[0], ids, geom, uvs, count)
    if bits:
        wrapper, plain = kernels.attach_sample_fused_packed, kernels.attach_sample_fused_packed_reference
        call = (*call, channels, bits)
    else:
        wrapper, plain = kernels.attach_sample_fused, kernels.attach_sample_fused_reference
    got = _each_grid("SAMPLER_WAVES", lambda: wrapper(*call))
    torch.cuda.synchronize()
    n = int(count)
    assert got.shape == (ids.shape[0], channels, 17, 17) and not got[n:].any()
    full = 65535.0 if bits in (0, 16) else 255.0
    assert float((got - plain(*call)).abs().max()) <= TOL_EXACT * full
    assert n == 0 or bool(got[:n].any())


# -- the mesh kernels K1 / K2 walk runs of tiles too (a grid of MESH_WAVES
# waves of resident blocks), on the same tile orders

MESH_GRIDS = (1, 2, 4, 8, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ID_CASES)
def test_mesh_kernel_on_any_tile_order(case):
    """K1 against its plain version on every grid, bit-equal across grids,
    with zeros past tile_count."""
    dev = _card()
    _, _, args = _stage(*_scene(2048), dev)
    quads, ids, geom, tp, fs, live = args
    ids, (geom, tp), count = _id_case(case, ids, [geom, tp], int(live))
    kargs = (quads, ids, geom, tp, fs, count)
    before = kernels.mesh_fused_planar.launches
    got = _each_grid("MESH_WAVES", lambda: kernels.mesh_fused_planar(*kargs), MESH_GRIDS)
    torch.cuda.synchronize()
    assert kernels.mesh_fused_planar.launches == before + len(MESH_GRIDS) + 1
    n = int(count)
    assert got.shape == (ids.shape[0], 6, 17, 17) and not got[n:].any()
    err = (got - kernels.mesh_fused_planar_reference(*kargs)).abs()
    assert float(err[:, :4].max()) <= TOL_POS and float(err[:, 4:].max()) <= TOL_UV, case
    assert n == 0 or bool(got[:n, 1:4].any())


def _earth_args(kind, altitude):
    """chip_smoke.py's Earth frame on the card (6.371e6 m sphere or the
    WGS84-like ellipsoid, 13 geometry lods over 3 data lods, capacity 2048,
    a culled camera) on a 16-slot random atlas: some 1500-2048 live tiles,
    so that one wave of K2's resident blocks walks runs of several tiles; at
    3 km the last steps are flagged high-precision (the Taylor near field).
    Returns the spherical kernel's arguments."""
    lods, capacity = 13, 2048
    if kind == "sphere":
        model = TerrainModel.sphere(np.zeros(3), 6.371e6, 0.0, 9000.0)
    else:
        model = TerrainModel.ellipsoid(np.zeros(3), 6_378_137.0, 6_356_752.3, -11_000.0,
                                       9000.0)
    vc = TerrainViewConfig(tile_capacity=capacity)
    view = model.surface_position(np.array([0.0, 0.0, 6.371e6 + 60_000.0]), altitude)
    vp = frustum.view_projection(view, view * 0.5, np.pi / 3, 16 / 9)
    origins, vt_int, vt_frac = tile_tree.compute_view_anchors(model, view, lods,
                                                              vc.tree_size)
    approx = TerrainModelApproximation.compute(model, view, vc.origin_lod, 4500.0)
    rng = np.random.default_rng(6)
    entries = np.zeros((6, lods, vc.tree_size, vc.tree_size, 2), np.int32)
    entries[..., 0] = rng.integers(0, 16, entries.shape[:-1])
    entries[..., 1] = np.minimum(np.arange(lods), 2)[None, :, None, None]
    blob = pack_frame_uniforms(model, view, approx, origins, entries, vt_int, vt_frac, vc,
                               view_proj=vp)
    plan = patch_sampling.make_patch_plan(512, 4, 2)
    blocks = rng.integers(0, 65535, (16 * plan.total_blocks_per_slot, 32, 128))
    cfg = StaticTerrainConfig(
        spherical=True, side_count=6, lod_count=lods, tree_size=vc.tree_size,
        grid_size=vc.grid_size, refinement_count=vc.refinement_count, queue_capacity=2048,
        tile_capacity=capacity, origin_lod=vc.origin_lod, high_precision=True,
        ellipsoidal=kind == "ellipsoid", culling=True,
    )
    dev = _card()
    u = unpack_frame_uniforms(torch.from_numpy(blob).to(dev), 6, lods, vc.tree_size)
    return meshgen.fused_kernel_args(
        refinement.refine_tiles(u, cfg), torch.from_numpy(blocks.astype(np.int32)).to(dev),
        u, cfg, plan, 65535.0)[2]


@pytest.fixture(scope="module")
def earth():
    """``earth(kind, altitude)``: :func:`_earth_args`, built once a module."""
    frames = {}

    def get(kind, altitude):
        if (kind, altitude) not in frames:
            frames[kind, altitude] = _earth_args(kind, altitude)
        return frames[kind, altitude]

    return get


def _sphere_case(case, args):
    """The Earth frame's tiles re-arranged for one ID_CASES case (as
    :func:`_id_case`); "ragged" drops the last 64-tile step (the total stays a
    multiple of the step) and three more live tiles, so that the live tiles
    end inside a step; "count_full" first fills the dead tail with copies of
    the live tiles (the tail's zero frame matrices are no tile's: on a planet
    they give NaN normals)."""
    quads, ids, geom, tp, fs, hp, live, olod, ell = args
    if case == "count_full":
        idx = torch.arange(ids.shape[0], device=ids.device) % int(live)
        ids, geom, tp = ids[idx], geom[idx], tp[idx]
    if case == "ragged":
        F = ids.shape[0] - kernels.TILES_PER_STEP
        ids, geom, tp, hp = ids[:F], geom[:F], tp[:F], hp[:-1]
        live = torch.clamp(live, max=F) - 3
    ids, (geom, tp), count = _id_case("sorted" if case == "ragged" else case, ids, [geom, tp],
                                      int(live))
    return quads, ids, geom, tp, fs, hp.contiguous(), count, olod, ell


def _check_sphere(got, args, what):
    """K2's output against its plain version, with zeros past tile_count."""
    n = int(args[6])
    assert got.shape == (args[1].shape[0], 9, 17, 17) and not got[n:].any(), what
    err = (got - kernels.mesh_fused_spherical_reference(*args)).abs()
    for name, sl in (("heights", slice(0, 1)), ("positions", slice(1, 4)),
                     ("uvs", slice(4, 6)), ("normals", slice(6, 9))):
        assert float(err[:, sl].max()) <= SPH_TOL[name], (what, name)
    assert n == 0 or bool(got[:n, 6:9].any())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ID_CASES)
@pytest.mark.parametrize("kind,altitude", [("sphere", 60_000.0), ("ellipsoid", 60_000.0),
                                           ("sphere", 3_000.0)])
def test_spherical_kernel_on_any_tile_order(earth, kind, altitude, case):
    """K2 on the sphere, the ellipsoid and the 3 km frame (flagged
    high-precision steps) against its plain version on every grid,
    bit-equal across grids, with zeros past tile_count."""
    _card()
    args = _sphere_case(case, earth(kind, altitude))
    if altitude < 10_000.0:
        assert bool((args[5] == 2).any())  # the Taylor near field is exercised
    before = kernels.mesh_fused_spherical.launches
    got = _each_grid("MESH_WAVES", lambda: kernels.mesh_fused_spherical(*args), MESH_GRIDS)
    torch.cuda.synchronize()
    assert kernels.mesh_fused_spherical.launches == before + len(MESH_GRIDS) + 1
    _check_sphere(got, args, (kind, altitude, case))


@pytest.mark.cuda
@pytest.mark.parametrize("waves", [1, 2, 4, 8])
def test_spherical_runs_start_inside_high_precision_steps(earth, waves):
    """At 3 km, on a grid of ``waves`` waves, some block's run of live tiles
    starts in the middle of a 64-tile step flagged high-precision (so the
    block takes the step's flag from the tile index, not from its first
    tile); the output equals the one-wave grid's and the plain version's."""
    _card()
    args = earth("sphere", 3_000.0)
    hp, live, F = args[5].cpu(), int(args[6]), args[1].shape[0]
    per_sm = {r["name"]: r["blocks_per_sm"] for r in kernels.kernel_occupancy()}
    resident = (torch.cuda.get_device_properties(0).multi_processor_count
                * per_sm["mesh_fused_spherical (sphere)"])
    grid = min(waves * resident, F)
    starts = [live * b // grid for b in range(grid)]
    assert any(s < live and s % kernels.TILES_PER_STEP and hp[s // kernels.TILES_PER_STEP] == 2
               for s in starts)
    saved = kernels.MESH_WAVES
    try:
        kernels.MESH_WAVES = 1
        one = kernels.mesh_fused_spherical(*args)
        kernels.MESH_WAVES = waves
        got = kernels.mesh_fused_spherical(*args)
    finally:
        kernels.MESH_WAVES = saved
    torch.cuda.synchronize()
    assert torch.equal(got, one)
    _check_sphere(got, args, waves)


# -- the half-grid kernels K6 / K7 walk runs of tiles too (a grid of
# HALFGRID_WAVES waves of resident blocks), on the same tile orders; K7 also
# on sweep-style inputs with edge geometry


@pytest.mark.cuda
@pytest.mark.parametrize("case", ID_CASES)
@pytest.mark.parametrize("per_vertex", [False, True], ids=["tile_ratio", "per_vertex"])
def test_halfgrid_cached_kernel_on_any_tile_order(per_vertex, case):
    """K6 with either blend (the plan's tile-centre ratio, or ratio 0 for
    the per-vertex blend) against its plain version on every grid,
    bit-equal across grids, with zeros past tile_count."""
    dev = _card()
    blob, blocks, cfg, plan = _scene(2048)
    cfg = dataclasses.replace(cfg, blend_per_vertex=per_vertex)
    u = unpack_frame_uniforms(torch.from_numpy(blob).to(dev), 1, LODS, 8)
    tiles, batch = patch_sampling.plan_patch_batch(refinement.refine_tiles(u, cfg), u, cfg, plan,
                                                   blocks.shape[0])
    assert (float(batch.geom[:, 4].max()) > 0.0) != per_vertex
    ids, (geom,), count = _id_case(case, batch.ids, [batch.geom], int(tiles.tile_count))
    kargs = (torch.from_numpy(blocks).to(dev), ids, geom, count)
    before = kernels.fetch_resample_cached.launches
    got = _each_grid("HALFGRID_WAVES", lambda: kernels.fetch_resample_cached(*kargs),
                     MESH_GRIDS)
    torch.cuda.synchronize()
    assert kernels.fetch_resample_cached.launches == before + len(MESH_GRIDS) + 1
    n = int(count)
    assert got.shape == (ids.shape[0], 33, 33) and not got[n:].any()
    err = float((got - kernels.fetch_resample_cached_reference(*kargs)).abs().max())
    assert err <= TOL_HALFGRID, (case, err)
    assert n == 0 or float(got[:n].abs().max()) > 30000.0


def _sweep_inputs(case, F=1024):
    """tools/fetch_kernel_sweep.py's inputs at 1024 tiles (512 random quads
    of values below 30000, patch positions in [0, 30], steps 0.5-1, ratios
    0-1), the first 64 tiles on edge geometry: positions clipped at 0 and 63,
    dp = 0, ratio 0 and 1, a decreasing step and steps of 3 and 40 texels.
    "sorted" orders the tiles by quad, "permuted" keeps the random order,
    "one_quad" puts every tile on one quad, "ragged" drops three tiles."""
    rng = np.random.default_rng(12)
    N = 512
    blocks = patch_sampling.quad_rows(
        rng.integers(0, 30000, size=(N, 32, 32)).astype(np.int32), 8)
    tl = rng.integers(0, N - 10, size=(F,)).astype(np.int32)
    geom = np.zeros((F, 8), np.float32)
    geom[:, 0:2] = rng.uniform(0, 30, size=(F, 2))
    geom[:, 2] = rng.uniform(0.5, 1.0, size=F)
    geom[:, 3] = 1.0
    geom[:, 4] = rng.uniform(0.0, 1.0, size=F)
    geom[0:8, 0:2] = -6.5  # p0 < 0
    geom[8:16, 0:2] = 50.0  # p0 + 32 dp > 63
    geom[16:24, 2] = 0.0
    geom[24:32, 4] = 0.0
    geom[32:40, 4] = 1.0
    geom[40:48, 0:2], geom[40:48, 2] = 60.0, -1.0
    geom[48:56, 2] = 3.0
    geom[56:64, 2] = 40.0
    if case == "sorted":
        order = np.argsort(tl, kind="stable")
        tl, geom = tl[order], geom[order]
    elif case == "one_quad":
        tl[:] = tl[0]
    elif case == "ragged":
        tl, geom = tl[:F - 3], geom[:F - 3]
    ids = np.stack([tl, tl + 1, tl + 8, tl + 9], axis=-1).astype(np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(_card())
                 for a in (blocks, ids, geom))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sorted", "permuted", "one_quad", "ragged"])
def test_sweep_kernel_on_any_tile_order(case):
    """K7 on sweep-style inputs with edge geometry against its plain version
    on every grid, bit-equal across grids."""
    args = _sweep_inputs(case)
    lo, hi, _ = kernels.fetch_resample_support(args[2])
    assert int((hi - lo + 1).sum(dim=2).max()) > 64  # the wide steps' supports
    before = kernels.fetch_resample.launches
    got = _each_grid("HALFGRID_WAVES", lambda: kernels.fetch_resample(*args), MESH_GRIDS)
    torch.cuda.synchronize()
    assert kernels.fetch_resample.launches == before + len(MESH_GRIDS) + 1
    assert got.shape == (args[1].shape[0], 33, 33) and bool(torch.isfinite(got).all())
    err = float((got - kernels.fetch_resample_reference(*args)).abs().max())
    assert err <= TOL_HALFGRID, (case, err)
    assert float(got.max()) > 10000.0 and float(got.min()) >= 0.0


# -- the rasterizer (render/raster.py: torch ops, no csrc kernel) -------------


def _launches():
    return {name: getattr(kernels, name).launches for name in (
        "mesh_fused_planar", "mesh_fused_spherical", "mesh_fused_albedo", "mesh_fused_shaded",
        "mesh_fused_spherical_albedo", "attach_sample_fused", "attach_sample_fused_packed",
        "fetch_resample_cached", "fetch_resample")}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flat", "bumpy", "seam", "grazing", "near", "overflow"])
def test_rasterizer_on_card_matches_cpu(name):
    """rasterize_grid on the card against the CPU on the CPU parity tests'
    scenes: both counters and every decisive pixel's triangle id exactly
    equal, depth and barycentrics within 1e-5 where the ids agree; no host
    sync inside the call, and the same ids with TF32 allowed."""
    from bevy_terrain_tpu_torch.render import raster
    # tests/ is on sys.path for its test modules (pytest's default import mode)
    from torch_raster_cases import decisive, oracle_raster, raster_cases

    dev = _card()
    pos, mask, vp, W, H, knobs = raster_cases()[name]
    cpu = raster.rasterize_grid(torch.from_numpy(pos), torch.tensor(mask), vp, W, H, **knobs)
    pos_d, mask_d = torch.from_numpy(pos).to(dev), torch.tensor(mask, device=dev)
    vp_d = torch.from_numpy(vp).to(dev)
    raster.rasterize_grid(pos_d, mask_d, vp_d, W, H, **knobs)  # the cached tables
    torch.cuda.synchronize()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        card = raster.rasterize_grid(pos_d, mask_d, vp_d, W, H, **knobs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert all(t.device.type == "cuda" for t in card)
    assert int(card.near_culled) == int(cpu.near_culled)
    assert int(card.bin_overflow) == int(cpu.bin_overflow)
    o_tri, _, o_margin = oracle_raster(pos, np.asarray(mask), vp, W, H)
    dec = decisive(o_tri, o_margin)
    tri, ctri = card.tri_id.cpu().numpy(), cpu.tri_id.numpy()
    np.testing.assert_array_equal(tri[dec], ctri[dec])
    same = tri == ctri
    assert same.mean() >= 0.999
    for f in ("depth", "bary"):
        np.testing.assert_allclose(getattr(card, f).cpu().numpy()[same],
                                   getattr(cpu, f).numpy()[same], rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def card_material_terrain(tmp_path_factory):
    """A streamed planar terrain with an Rgba8 albedo lit by a
    StandardMaterial on the card: the in-kernel shade (K4) every frame."""
    from bevy_terrain_tpu_torch import Terrain
    from bevy_terrain_tpu_torch.config import AttachmentConfig, AttachmentFormat, TerrainConfig
    from bevy_terrain_tpu_torch.render import material
    from bevy_terrain_tpu_torch.utils.synthetic import generate_planar_dataset

    dev = _card()
    root = str(tmp_path_factory.mktemp("card_raster"))
    kw = dict(texture_size=512, border_size=2, mip_level_count=4)
    atts = (AttachmentConfig(name="height", **kw),
            AttachmentConfig(name="albedo", format=AttachmentFormat.RGBA8, **kw))
    for att in atts:
        generate_planar_dataset("raster", 3, att, root=root)
    config = TerrainConfig(lod_count=3, model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
                           atlas_size=32, path="raster", attachments=atts, assets_root=root)
    terrain = Terrain(config, device=dev)
    terrain.add_view("cam", TerrainViewConfig(tile_capacity=256, morph_distance=4.0),
                     queue_capacity=1024)
    terrain.set_shading(material.StandardMaterial(base_color=material.albedo_material(1)),
                        sample_attachments=(1,))
    view = np.array([0.0, 320.0, 1.0])
    for _ in range(40):
        out = terrain.update({"cam": view})["cam"]
        if not terrain.atlas.state.to_load and not any(a.loading for a in terrain.atlas.attachments):
            break
    before = _launches()
    out = terrain.update({"cam": view})["cam"]
    torch.cuda.synchronize()
    assert _launches()["mesh_fused_shaded"] == before["mesh_fused_shaded"] + 1
    assert out.overflow == 0 and out.tile_count > 0
    vp = frustum.view_projection(view, np.zeros(3), np.radians(60.0), 1.0, near=0.5)
    return terrain, out, vp


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["pixel", "vertex_colours", "debug"])
def test_render_image_on_card(card_material_terrain, mode):
    """Terrain.render_image on the card: the image is finite, on the card,
    in range, and the same as render_view on the CPU fed the card's frame
    products (ids on 99.9% of the pixels, colours within 1e-4 where they
    agree). The per-pixel mode launches no csrc kernel; the vertex and
    debug modes one packed sampler (K5b) through sample_attachment_grid."""
    from bevy_terrain_tpu_torch.ops.params import unpack_frame_uniforms
    from bevy_terrain_tpu_torch.render import raster

    terrain, out, vp = card_material_terrain
    kw = {"pixel": {}, "vertex_colours": dict(pixel_texturing=False),
          "debug": dict(debug_view="geometry_lod")}[mode]
    knobs = dict(bin_px=16, bin_cap=256)
    before = _launches()
    img, r = terrain.render_image("cam", out, vp, 160, 160, **kw, **knobs)
    torch.cuda.synchronize()
    after = _launches()
    k5b = 0 if mode == "pixel" else 1
    assert after["attach_sample_fused_packed"] == before["attach_sample_fused_packed"] + k5b
    assert all(after[k] == before[k] for k in after if k != "attach_sample_fused_packed")
    assert img.device.type == "cuda" and img.shape == (160, 160, 4)
    assert bool(torch.isfinite(img).all()) and int(r.bin_overflow) == 0
    assert float(r.covered.float().mean()) > 0.9

    # the same render on the CPU from the card's frame products
    def cpu(obj):
        return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).cpu()
                                           for f in dataclasses.fields(obj)
                                           if isinstance(getattr(obj, f.name), torch.Tensor)})

    _, cfg = terrain.frame_inputs("cam")
    uniforms = unpack_frame_uniforms(terrain._last_blobs["cam"].cpu(), cfg.side_count,
                                     cfg.lod_count, cfg.tree_size)
    cpu_kw = dict(kw, material=terrain.shading_fn)
    albedo = terrain.atlas.attachments[1]
    if mode == "pixel":
        cpu_kw.pop("pixel_texturing", None)
        cpu_kw["pixel_attachment"] = (tuple(s.cpu() for s in albedo.slabs), albedo.config.scale,
                                      albedo.config.offset, albedo.config.format.max_value,
                                      albedo.config.texture_size)
    else:
        cpu_kw.pop("pixel_texturing", None)
        cpu_kw["attachment_samples"] = {1: terrain.sample_attachment_grid("cam", out, 1).cpu()}
    want, wr = raster.render_view(cpu(out.mesh), cpu(out.tiles), uniforms, cfg, vp, 160, 160,
                                  **cpu_kw, **knobs)
    same = (r.tri_id.cpu() == wr.tri_id).numpy()
    assert same.mean() >= 0.999
    assert int(r.near_culled) == int(wr.near_culled) and int(r.bin_overflow) == int(wr.bin_overflow)
    np.testing.assert_allclose(img.cpu().numpy()[same], want.numpy()[same], rtol=0, atol=1e-4)


# -- preprocess on the card ------------------------------------------------------

# the JAX package's yardstick for its full device path against its host path
# (tests/test_preprocess_device.py): at most 1 unit apart, on under 2% of texels
PRE_MAX_UNITS, PRE_MAX_SHARE = 1, 0.02


def _preprocess(root, spherical, atlas_device, **kw):
    """The 68^2 fixtures of tests/test_preprocess_device.py (seeded uniform
    sources, 2 lods), handed to the port's Preprocessor through ``loader=``
    (no PIL on the card's machine). Returns {file name: bytes} of the tiles
    and config.tc."""
    from bevy_terrain_tpu_torch import (
        AttachmentConfig, PreprocessDataset, Preprocessor, SphericalDataset, TerrainConfig,
    )
    from bevy_terrain_tpu_torch.terrain_data import TileAtlas

    rng = np.random.default_rng(11)
    # 16-bit sources, as load_source_image returns a 16-bit PNG
    shape, count = ((64, 64), 6) if spherical else ((128, 128), 1)
    sources = [(np.rint(rng.uniform(0.1, 1.0, shape) * 65535.0) / 65535.0)
               .astype(np.float32)[..., None] for _ in range(count)]
    model = (TerrainModel.sphere(np.zeros(3), 100.0, 0.0, 10.0) if spherical
             else TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0))
    config = TerrainConfig(
        lod_count=2, model=model, atlas_size=64, path="t", assets_root=str(root),
        attachments=(AttachmentConfig(name="height", texture_size=68, border_size=2,
                                      mip_level_count=2),))
    pp = Preprocessor(TileAtlas(config, atlas_device), loader=lambda p, cfg: sources[int(p)],
                      **kw).clear_attachment(0)
    if spherical:
        pp.preprocess_spherical(SphericalDataset(attachment_index=0, lod_range=range(0, 2),
                                                 paths=[str(i) for i in range(6)]))
    else:
        pp.preprocess_tile(PreprocessDataset(attachment_index=0, path="0",
                                             lod_range=range(0, 2)))
    pp.run(verbose=False)
    out = {p.name: p.read_bytes() for p in sorted((root / "t/data/height").glob("*.bin"))}
    out["config.tc"] = (root / "t/config.tc").read_bytes()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("spherical", [False, True], ids=["planar", "spherical"])
@pytest.mark.parametrize("readback", ["full", "delta"])
def test_preprocess_device_path_on_the_card(tmp_path, spherical, readback):
    """Full read-back within the reference's yardstick, delta byte-exact;
    and the device path synchronizes once per lod stack, at its read-back
    (counted by torch's sync debug mode: 2 lods, on 6 sides for a planet)."""
    _hold_preprocess_on_the_card(tmp_path, spherical, readback)


@pytest.mark.cuda
@pytest.mark.parametrize("spherical", [False, True], ids=["planar", "spherical"])
@pytest.mark.parametrize("readback", ["full", "delta"])
def test_preprocess_device_path_in_chunks_on_the_card(tmp_path, monkeypatch, spherical,
                                                      readback):
    """The same with stitch chunks of 3 tiles and downsample chunks of one
    parent: still one sync per lod stack."""
    from bevy_terrain_tpu_torch.preprocess import preprocessor

    monkeypatch.setattr(preprocessor, "_CHUNK_BYTES", 3 * 68 * 68 * 4)
    _hold_preprocess_on_the_card(tmp_path, spherical, readback)


@pytest.mark.cuda
@pytest.mark.parametrize("readback", ["full", "delta"])
def test_preprocess_batch_tiles_on_the_card(tmp_path, readback):
    """``batch_tiles`` (the JAX package's fourth argument) bounds the device
    chunks in tiles and changes no byte: 3-tile chunks write the default's
    files, on a planet's cross-face stitch too."""
    _card()
    want = _preprocess(tmp_path / "default", True, "cuda", device=True, readback=readback)
    got = _preprocess(tmp_path / "three", True, "cuda", device=True, batch_tiles=3,
                      readback=readback)
    assert got == want


def _hold_preprocess_on_the_card(tmp_path, spherical, readback):
    import warnings

    _card()
    host = _preprocess(tmp_path / "host", spherical, "cpu", device=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = _preprocess(tmp_path / readback, spherical, "cuda", device=True,
                              readback=readback)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (the first switch to the warn mode in a process adds a notice: not counted)
    syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == (12 if spherical else 2), [str(w.message) for w in syncs]
    assert set(got) == set(host) and len(host) == (6 * 5 + 1 if spherical else 5 + 1)
    assert got.pop("config.tc") == host.pop("config.tc")
    for name in host:
        if readback == "delta":
            assert got[name] == host[name], name
            continue
        d = np.abs(np.frombuffer(got[name], np.uint16).astype(np.int64)
                   - np.frombuffer(host[name], np.uint16).astype(np.int64))
        assert d.max() <= PRE_MAX_UNITS and (d != 0).mean() < PRE_MAX_SHARE, name


@pytest.mark.cuda
@pytest.mark.parametrize("spherical", [False, True], ids=["planar", "cross-face"])
def test_preprocess_stack_ops_on_the_card_equal_the_cpu(spherical):
    from bevy_terrain_tpu_torch.math.coordinate import TileCoordinate
    from bevy_terrain_tpu_torch.ops import preprocess_device as ppd

    dev = _card()
    rng = np.random.default_rng(21)
    ts, b = 68, 2
    children = np.rint(rng.uniform(0, 65535, (12, ts, ts, 2))).astype(np.float32)
    children[rng.uniform(size=children.shape) < 0.2] = 0.0
    idx = np.array([[0, 1, 2, 3], [4, 5, 6, -1], [8, -1, 10, 11]], np.int64)
    want = ppd.downsample_stack(torch.from_numpy(children), torch.from_numpy(idx), ts, b)
    got = ppd.downsample_stack(torch.from_numpy(children).to(dev),
                               torch.from_numpy(idx).to(dev), ts, b)
    assert torch.equal(got.cpu(), want)

    sides = range(6) if spherical else [0]
    coords = [TileCoordinate(s, 1, x, y) for s in sides for x in range(2) for y in range(2)]
    coords.pop(3)
    index_of = {c: i for i, c in enumerate(coords)}
    stack = torch.from_numpy(children[:1].repeat(len(coords), 0) + np.arange(
        len(coords), dtype=np.float32)[:, None, None, None])
    nbr_idx, nbr_side = ppd.stitch_plan(coords, index_of, spherical)
    tile_sides = np.array([c.side for c in coords])
    want = ppd.stitch_stack(stack, tile_sides, nbr_idx, nbr_side, b, spherical)
    got = ppd.stitch_stack(stack.to(dev), tile_sides, nbr_idx, nbr_side, b, spherical)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(ppd.extract_borders(got, b).cpu(), ppd.extract_borders(want, b))


@pytest.mark.cuda
def test_preprocessor_auto_selects_the_device_path_on_the_card(tmp_path):
    from bevy_terrain_tpu_torch import AttachmentConfig, Preprocessor, TerrainConfig
    from bevy_terrain_tpu_torch.terrain_data import TileAtlas
    from bevy_terrain_tpu_torch.utils import transfer

    _card()
    config = TerrainConfig(
        lod_count=2, model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
        atlas_size=8, path="t", assets_root=str(tmp_path),
        attachments=(AttachmentConfig(name="height", texture_size=68, border_size=2),))
    transfer._reset_probe()
    pp = Preprocessor(TileAtlas(config, "cuda"))
    assert pp.device is True and pp.readback == "full"
    # decided by the device type: no probe ran
    assert not transfer._D2H_S and not transfer._DISPATCH_S
    assert transfer.d2h_seconds("cuda") < transfer._THRESHOLD_S
    assert transfer.dispatch_seconds("cuda") < transfer._DISPATCH_THRESHOLD_S


@pytest.mark.cuda
def test_uint16_read_back_keeps_the_top_value():
    from bevy_terrain_tpu_torch.ops import preprocess_device as ppd

    dev = _card()
    values = [0.0, 1.0, 255.0, 32767.0, 32768.0, 65534.0, 65535.0]
    x = torch.tensor(values, device=dev).reshape(1, 7, 1, 1).expand(2, 7, 3, 1)
    got = ppd.read_stored(ppd.to_stored(x, np.uint16), np.uint16)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got[1, :, 2, 0], np.array(values, np.uint16))
    assert int(got.max()) == 65535
    # a stack held at the stored width reads back as the same f32
    assert torch.equal(ppd.from_stored(ppd.to_stored(x, np.uint16)), x)


@pytest.mark.cuda
def test_preprocess_memory_check_reads_the_card():
    from bevy_terrain_tpu_torch.preprocess import preprocessor

    dev = _card()
    free = preprocessor._free_device_bytes(dev)
    assert 0 < free <= torch.cuda.get_device_properties(dev).total_memory


@pytest.mark.cuda
def test_split_mosaic_device_branch_on_the_card():
    """``split_mosaic(use_device=True)``: the dense tent products on the
    card in full f32 (TF32 off for the call whatever the caller set) agree
    with the same products on the CPU and with the host 2-tap split to a
    few f32 ulps."""
    from bevy_terrain_tpu_torch.ops import preprocess as pp

    _card()
    rng = np.random.default_rng(31)
    src = (np.rint(rng.uniform(0.05, 1.0, (300, 260, 2)) * 65535.0) / 65535.0).astype(np.float32)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got, valid = pp.split_mosaic(src, 2, 60, (0.05, 0.0), (0.9, 1.0), row_band=100,
                                     use_device=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    cpu, cvalid = pp.split_mosaic(src, 2, 60, (0.05, 0.0), (0.9, 1.0), row_band=100,
                                  use_device="cpu")
    host, _ = pp.split_mosaic(src, 2, 60, (0.05, 0.0), (0.9, 1.0), row_band=100)
    np.testing.assert_array_equal(valid, cvalid)
    np.testing.assert_allclose(got, cpu, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, host, rtol=0, atol=1e-6)


def _multi_view_scene(root):
    """tests/test_multi_view.py's scene: a 3-lod synthetic planar dataset
    (512^2 R16 tiles, 1000 m, a 64-slot atlas), capacity 512 views, and 4 of
    its seeded cameras."""
    from bevy_terrain_tpu_torch.config import AttachmentConfig, TerrainConfig
    from bevy_terrain_tpu_torch.utils.synthetic import generate_planar_dataset

    att = AttachmentConfig(name="height", texture_size=512, border_size=2, mip_level_count=4)
    generate_planar_dataset("terrains/mv", 3, att, root=str(root))
    config = TerrainConfig(lod_count=3, model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0,
                                                                   100.0),
                           atlas_size=64, path="terrains/mv", attachments=(att,),
                           assets_root=str(root))
    rng = np.random.default_rng(5)
    positions = {f"v{i}": np.array([rng.uniform(-300, 300), rng.uniform(80, 400),
                                    rng.uniform(-300, 300)]) for i in range(8)}
    vc = TerrainViewConfig(tile_capacity=512, morph_distance=2.0, blend_distance=1.0)
    return config, dict(list(positions.items())[:4]), vc


def _stream_views(terrain, positions):
    for _ in range(200):
        terrain.update(positions)
        if not terrain.atlas.state.to_load and not any(
                a.loading for a in terrain.atlas.attachments):
            break
    return terrain.update(positions)


@pytest.mark.cuda
def test_multi_view_frames_equal_the_terrain_on_the_card(tmp_path):
    """MultiViewTerrain on the card: the fused mesh kernel once per view per
    frame, each view bit-equal to a Terrain with the same views over the
    same atlas; the sharded store (the staged path, no kernel) within the
    fused-vs-staged 2e-2 m of it per tile."""
    from bevy_terrain_tpu_torch import Terrain
    from bevy_terrain_tpu_torch.parallel import MultiViewTerrain

    _card()
    config, positions, vc = _multi_view_scene(tmp_path)
    mvt = MultiViewTerrain(config, list(positions), view_config=vc, queue_capacity=1024)
    assert mvt.cfg.pallas_sampling and mvt.device.type == "cuda"
    _stream_views(mvt, positions)
    before = kernels.mesh_fused_planar.launches
    outs = mvt.update(positions)
    torch.cuda.synchronize()
    assert kernels.mesh_fused_planar.launches == before + len(positions)
    ref = Terrain(config)
    ref.atlas = mvt.atlas
    for v in positions:
        ref.add_view(v, vc, queue_capacity=1024)
    _stream_views(ref, positions)
    outs, ref_outs = mvt.update(positions), ref.update(positions)
    sharded = MultiViewTerrain(config, list(positions), view_config=vc, queue_capacity=1024,
                               shard_atlas=True, blend_per_vertex=True)
    assert not sharded.cfg.pallas_sampling
    launches = {name: getattr(kernels, name).launches for name in (
        "mesh_fused_planar", "fetch_resample_cached", "fetch_resample")}
    souts = _stream_views(sharded, positions)
    assert launches == {name: getattr(kernels, name).launches for name in launches}
    for v in positions:
        a, b = outs[v], ref_outs[v]
        for obj_a, obj_b in ((a.tiles, b.tiles), (a.mesh, b.mesh)):
            for f in dataclasses.fields(obj_a):
                assert torch.equal(getattr(obj_a, f.name), getattr(obj_b, f.name)), (v, f.name)
        n = a.tile_count
        assert n > 0 and souts[v].tile_count == n

        def by_key(out):
            t = out.tiles
            return {(int(s), int(l), int(x), int(y)): i for i, (s, l, (x, y)) in enumerate(zip(
                t.tile_side[:n].tolist(), t.tile_lod[:n].tolist(), t.tile_xy[:n].tolist()))}

        ka, ks = by_key(a), by_key(souts[v])
        assert set(ka) == set(ks)
        ia = torch.tensor([ka[k] for k in sorted(ka)], device="cuda")
        is_ = torch.tensor([ks[k] for k in sorted(ka)], device="cuda")
        for f in ("heights", "positions"):
            err = float((getattr(a.mesh, f)[ia] - getattr(souts[v].mesh, f)[is_]).abs().max())
            assert err <= 2e-2, (v, f, err)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4, 8])
def test_sharded_fetch_equals_the_plain_gather_on_the_card(n):
    from bevy_terrain_tpu_torch.parallel import fetch_patches_sharded, shard_blocks

    dev = _card()
    rng = np.random.default_rng(n)
    blocks = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, (37, 32, 128),
                                           dtype=np.int64).astype(np.int32)).to(dev)
    ids = torch.from_numpy(rng.integers(0, 37, (300, 4)).astype(np.int32)).to(dev)
    got = fetch_patches_sharded(shard_blocks(n, blocks), ids)
    assert torch.equal(got, patch_sampling.fetch_patches(blocks, ids))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["planar", "sphere"])
def test_tile_tree_twin_on_the_card_matches_the_host_twin(kind):
    """``ops/tile_tree.tile_tree_update`` as torch ops on the card against
    ``tile_tree_update_host``, the exact f64 numpy twin (tests/test_ops.py's
    yardstick): slot coordinates equal, request masks agree on more than 99%
    of slots; and equal to the same twin on the CPU."""
    dev = _card()
    if kind == "planar":
        model = TerrainModel.planar(np.array([0.0, -100.0, 0.0]), 1000.0, 0.0, 250.0)
        view, lods = np.array([120.0, -40.0, -300.0]), 4
    else:
        model = TerrainModel.sphere(np.zeros(3), 6.4e6, 0.0, 9000.0)
        view, lods = model.position_local_to_world(np.array([0.6, 0.0, 0.8]), 3000.0), 8
    vc = TerrainViewConfig()
    origins, vt_int, vt_frac = tile_tree.compute_view_anchors(model, view, lods, vc.tree_size)
    approx = TerrainModelApproximation.compute(
        model, view, vc.origin_lod, (model.min_height + model.max_height) / 2)
    entries = np.zeros((model.side_count, lods, vc.tree_size, vc.tree_size, 2), np.int32)
    blob = pack_frame_uniforms(model, view, approx, origins, entries, vt_int, vt_frac, vc)
    cfg = StaticTerrainConfig(
        spherical=model.is_spherical, side_count=model.side_count, lod_count=lods,
        tree_size=vc.tree_size, grid_size=vc.grid_size, refinement_count=vc.refinement_count,
        queue_capacity=4096, tile_capacity=vc.tile_capacity, origin_lod=vc.origin_lod,
    )
    S, T = model.side_count, vc.tree_size
    u = unpack_frame_uniforms(torch.from_numpy(blob).to(dev), S, lods, T)
    xy, req = tile_tree.tile_tree_update(u, cfg)
    assert xy.device.type == req.device.type == "cuda"
    xy_host, req_host = tile_tree.tile_tree_update_host(model, view, u, cfg)
    np.testing.assert_array_equal(xy.cpu().numpy(), xy_host)
    agree = float(np.mean(req.cpu().numpy() == req_host))
    assert agree > 0.99, f"request masks agree only {agree:.4f}"
    u_cpu = unpack_frame_uniforms(torch.from_numpy(blob), S, lods, T)
    xy_cpu, req_cpu = tile_tree.tile_tree_update(u_cpu, cfg)
    assert torch.equal(xy.cpu(), xy_cpu)
    assert float((req.cpu() == req_cpu).float().mean()) > 0.99
