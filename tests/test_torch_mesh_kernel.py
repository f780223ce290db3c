"""Fused planar mesh stage: the torch package against the JAX package.

On ``small_frame`` (tests/test_torch_patch_sampling.py) the port's plain
mesh path on the CPU must match the JAX fused Pallas kernel run in
interpret mode, per tile key (a tile list is a set): the tile set exactly,
heights and positions within 1e-3 m, uvs within 1e-6. Both sides are exact
f32 on the CPU and differ only in operation order (and in the CPU log2:
XLA's is less exactly rounded than torch's).

The CUDA kernel itself is compared with the plain version on the card by
tests/test_torch_cuda.py (skipped without a card) and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_terrain_tpu.ops import meshgen as jmeshgen
from bevy_terrain_tpu.ops import pallas_kernels as jpk
from bevy_terrain_tpu.ops import refinement as jrefinement
from bevy_terrain_tpu.ops.params import unpack_frame_uniforms as junpack
from bevy_terrain_tpu_torch.ops import kernels, meshgen, refinement
from bevy_terrain_tpu_torch.ops.params import unpack_frame_uniforms
from tests.test_torch_patch_sampling import LODS, small_frame
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)

MAX_VALUE = 65535.0


def tile_rows(tiles, n):
    lod = np.asarray(tiles.tile_lod[:n])
    xy = np.asarray(tiles.tile_xy[:n])
    return {(int(l), int(x), int(y)): i for i, (l, (x, y)) in enumerate(zip(lod, xy))}


@pytest.fixture(scope="module")
def frames():
    blob, blocks, cfg, jcfg, plan, jplan = small_frame()
    u = unpack_frame_uniforms(torch.from_numpy(blob), 1, LODS, 8)
    tiles = refinement.refine_tiles(u, cfg)
    raw, stiles = meshgen.generate_mesh_fused(
        tiles, torch.from_numpy(blocks), u, cfg, plan, MAX_VALUE)
    mesh = meshgen.fused_to_grid(raw, stiles, cfg)

    ju = junpack(jnp.asarray(blob), 1, LODS, 8)
    jraw, jtiles = jmeshgen.generate_mesh_fused(
        jrefinement.refine_tiles(ju, jcfg), jnp.asarray(blocks), ju, jcfg, jplan,
        MAX_VALUE, interpret=True,
    )
    jmesh = jax.block_until_ready(jmeshgen.fused_to_grid(jraw, jtiles, jcfg))
    return (u, cfg, stiles, raw, mesh), (ju, jcfg, jtiles, jmesh)


def test_tile_sets_equal(frames):
    (_, _, stiles, _, _), (_, _, jtiles, _) = frames
    n = int(stiles.tile_count)
    assert n == int(jtiles.tile_count) > 0
    assert set(tile_rows(stiles, n)) == set(tile_rows(jtiles, n))


@pytest.mark.parametrize("field,atol", [
    ("heights", 1e-3), ("positions", 1e-3), ("uvs", 1e-6), ("normals", 0.0),
])
def test_mesh_matches_jax_interpret(frames, field, atol):
    (_, _, stiles, _, mesh), (_, _, jtiles, jmesh) = frames
    n = int(stiles.tile_count)
    got = getattr(mesh, field).numpy()
    want = np.asarray(getattr(jmesh, field))
    assert got.shape == want.shape
    rows_j = tile_rows(jtiles, n)
    for key, i in tile_rows(stiles, n).items():
        np.testing.assert_allclose(got[i], want[rows_j[key]], rtol=0, atol=atol,
                                   err_msg=f"{field} {key}")
    # capacity lanes past tile_count: zeros (the up normal for normals) in both
    np.testing.assert_array_equal(got[n:], want[n:])
    np.testing.assert_array_equal(mesh.tile_mask.numpy(), np.asarray(jmesh.tile_mask))


def test_mesh_scalars_match_jax(frames):
    """pack_mesh_scalars: exact except fs[43..44] (log2 of the distance
    bases, XLA's CPU log2 rounding), which agree to one ulp."""
    (u, cfg, _, _, _), (ju, jcfg, _, _) = frames
    got = kernels.pack_mesh_scalars(u, cfg, MAX_VALUE).numpy()
    want = np.asarray(jpk.pack_mesh_scalars(ju, jcfg, MAX_VALUE))
    assert got.shape == want.shape == (kernels.FS_LEN,)
    exact = np.r_[0:43, 45:48]
    np.testing.assert_array_equal(got[exact], want[exact])
    np.testing.assert_allclose(got[43:45], want[43:45], rtol=2e-7, atol=0)


def test_raw_layout(frames):
    """raw is (Fp, 6, 17, 17): channels [h, px, py, pz, u, v]; uvs at
    vertex (i, j) are the morphed (j/16, i/16)."""
    (_, cfg, stiles, raw, mesh), _ = frames
    assert raw.shape == (cfg.tile_capacity, 6, 17, 17)
    np.testing.assert_array_equal(raw[:, 0].numpy(), mesh.heights.numpy())
    n = int(stiles.tile_count)
    uv = raw[:n, 4:6].numpy()
    grid = np.arange(17) / 16.0
    # morphing moves a vertex by less than one grid cell toward the even grid
    assert np.all(np.abs(uv[:, 0] - grid[None, None, :]) <= 1.0 / 16 + 1e-6)
    assert np.all(np.abs(uv[:, 1] - grid[None, :, None]) <= 1.0 / 16 + 1e-6)


def test_dead_tiles_are_zero():
    """tile_count bounds the live tiles: tiles past it come out zero, and
    the count is read from the tensor, whatever the per-tile live flag."""
    blob, blocks, cfg, _, plan, _ = small_frame()
    u = unpack_frame_uniforms(torch.from_numpy(blob), 1, LODS, 8)
    tiles = refinement.refine_tiles(u, cfg)
    _, _, args = meshgen.fused_kernel_args(tiles, torch.from_numpy(blocks), u, cfg, plan,
                                           MAX_VALUE)
    full = kernels.mesh_fused_planar(*args)
    cut = kernels.mesh_fused_planar(*args[:5], torch.tensor([5], dtype=torch.int32))
    np.testing.assert_array_equal(cut[:5].numpy(), full[:5].numpy())
    assert not cut[5:].any()


def test_wrapper_checks_arguments():
    blocks = torch.zeros((4, 32, 128), dtype=torch.int32)
    ids = torch.zeros(64, dtype=torch.int32)
    geom = torch.zeros((64, 8))
    params = torch.zeros((64, 4))
    fs = torch.zeros(kernels.FS_LEN)
    count = torch.tensor([1], dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.mesh_fused_planar(blocks.float(), ids, geom, params, fs, count)
    with pytest.raises(ValueError):
        kernels.mesh_fused_planar(blocks, ids, geom[:, :4], params, fs, count)
    with pytest.raises(ValueError):
        kernels.mesh_fused_planar(blocks, ids, geom, params.t().contiguous().t(), fs, count)
    # a CPU call runs the plain version and does not count as a launch
    before = kernels.mesh_fused_planar.launches
    kernels.mesh_fused_planar(blocks, ids, geom, params, fs, count)
    assert kernels.mesh_fused_planar.launches == before
