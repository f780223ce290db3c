"""The torch package on an NVIDIA card: CUDA kernels against their plain
versions, and the device stage on the card against the CPU.

Every test here needs a card and skips without one. The file imports no
jax, so it also runs where jax is not installed; there, skip the repo's
conftest (which configures jax):

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

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
