"""Half-grid kernels (K6 ``fetch_resample_cached``, K7 ``fetch_resample``) and
the staged half-grid functions: the torch package against the JAX package.

On ``small_frame`` (tests/test_torch_patch_sampling.py: 64 tiles, 16 unique
quads, random 16-bit blocks) both packages plan the frame's patch fetches.
The port's plain versions must match the JAX package's Pallas kernels run in
interpret mode within :data:`TOL` = 0.05 raw texel units on values up to
65535 (8e-7 of full scale). Both sides sum in f32 there (on the TPU the JAX
kernels run their dots in bf16 passes, which the port does not imitate);
they differ in summation order, in how the blend is formed (dense products
with ``B = I + ratio (A - I)`` against two 1-2-1 passes) and in the patch
mean, measured at most 0.012 raw units. K7 runs on sweep-style random
inputs (tools/fetch_kernel_sweep.py: random quads, ``dp`` 0.5-1, ``ratio``
0-1) with positions on a 1/64-texel grid, where both packages sample at the
same f32 positions; on continuous positions XLA's fused multiply-adds move
the sample points by an ulp, and both are held to the float64 arithmetic
instead (:data:`TOL_CONTINUOUS`). ``permute_halfgrid(K7) == K6`` pins the two blends (weights against
values) and the two output orders against each other.

Each staged function of ``ops/patch_sampling.py`` is held to its JAX
counterpart at grid size 16 and at grid size 8.

The CUDA kernels themselves are compared with the plain versions on the card
by chip_smoke.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_terrain_tpu.ops import pallas_kernels as jpk
from bevy_terrain_tpu.ops import patch_sampling as jps
from bevy_terrain_tpu.ops import refinement as jrefinement
from bevy_terrain_tpu.ops.params import unpack_frame_uniforms as junpack
from bevy_terrain_tpu_torch.ops import kernels
from bevy_terrain_tpu_torch.ops import patch_sampling as ps
from bevy_terrain_tpu_torch.ops import refinement
from bevy_terrain_tpu_torch.ops.params import unpack_frame_uniforms
from tests.test_torch_patch_sampling import LODS, small_frame
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)

TOL = 0.05  # raw texel units, on values up to 65535
K = 33


@pytest.fixture(scope="module")
def frame():
    """small_frame planned in both packages with the tile-centre blend (the
    plan's ratio column is then non-zero), and the JAX kernels' products."""
    blob, blocks, cfg, jcfg, plan, jplan = small_frame(blend_per_vertex=False)
    u = unpack_frame_uniforms(torch.from_numpy(blob), 1, LODS, 8)
    ju = junpack(jnp.asarray(blob), 1, LODS, 8)
    tiles, batch = ps.plan_patch_batch(refinement.refine_tiles(u, cfg), u, cfg, plan,
                                       blocks.shape[0])
    jtiles, jbatch = jps.plan_patch_batch(jrefinement.refine_tiles(ju, jcfg), ju, jcfg, jplan,
                                          blocks.shape[0], jpk.TILES_PER_STEP)
    n = int(tiles.tile_count)
    assert n == int(jtiles.tile_count) > 8
    assert 0.0 < float(batch.geom[:n, 4].max()) <= 1.0
    # some live tiles without atlas data: their half-grid must come out zero
    geom = batch.geom.clone()
    geom[1:n:7, 3] = 0.0
    return dict(blocks=blocks, cfg=cfg, jcfg=jcfg, tiles=tiles, n=n, geom=geom,
                batch=batch, jbatch=jbatch)


def _k6_both(frame, ratio):
    """K6 with the plan's ratio (None) or with it forced: (port, JAX)."""
    geom = frame["geom"].clone()
    if ratio is not None:
        geom[:, 4] = ratio
    count = frame["tiles"].tile_count.reshape(1)
    got = kernels.fetch_resample_cached(torch.from_numpy(frame["blocks"]), frame["batch"].ids,
                                        geom, count)
    jbatch = frame["jbatch"]._replace(geom=jnp.asarray(geom.numpy()))
    want = jpk.fetch_resample_cached(jnp.asarray(frame["blocks"]), jbatch, interpret=True)
    return got.numpy(), np.asarray(want), geom


@pytest.mark.parametrize("ratio", [None, 0.0, 1.0], ids=["planned", "ratio0", "ratio1"])
def test_fetch_resample_cached_matches_jax_interpret(frame, ratio):
    got, want, geom = _k6_both(frame, ratio)
    n = frame["n"]
    assert got.shape == want.shape == (64, K, K) and got.dtype == np.float32
    assert float(np.abs(want[:n]).max()) > 30000.0
    print(f"K6 plain vs JAX interpret ({ratio}): {np.abs(got - want).max():.3e} raw units")
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # dead tiles (index >= tile_count) and invalid ones are exactly zero
    assert not got[n:].any()
    assert not got[:n][geom[:n, 3].numpy() == 0.0].any()
    assert got[:n][geom[:n, 3].numpy() == 1.0].any()


def _sweep_inputs(n_quads=128, tiles=300, seed=0, dyadic=False):
    """tools/fetch_kernel_sweep.py's inputs at a small size. With ``dyadic``
    the positions and steps are drawn on a 1/64-texel grid, so that every
    ``p0 + k * dp`` is exact in f32, with or without a fused multiply-add."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 65535, (n_quads, 32, 128)).astype(np.int32)
    ids = np.zeros((tiles, 4), np.int32)
    ids[:, 0] = rng.integers(0, n_quads, tiles)
    geom = np.zeros((tiles, 8), np.float32)
    geom[:, 0:2] = rng.uniform(0, 30, (tiles, 2))
    geom[:, 2] = rng.uniform(0.5, 1.0, tiles)
    if dyadic:
        geom[:, 0:3] = np.round(geom[:, 0:3] * 64.0) / 64.0
    geom[:, 3] = 1.0
    geom[:, 4] = rng.uniform(0.0, 1.0, tiles)
    return blocks, ids, geom


def _k7_both(blocks, ids, geom):
    got = kernels.fetch_resample(*(torch.from_numpy(a) for a in (blocks, ids, geom))).numpy()
    want = np.asarray(jpk.fetch_resample(jnp.asarray(blocks), jnp.asarray(ids),
                                         jnp.asarray(geom), interpret=True))
    assert got.shape == want.shape == (ids.shape[0], K, K) and got.dtype == np.float32
    assert float(np.abs(want).max()) > 30000.0
    return got, want


def test_fetch_resample_matches_jax_interpret():
    """Sweep-style inputs with the positions on a 1/64-texel grid: both
    packages then resample at the same f32 positions, and differ by the
    weights' crossfade rounding and the summation order (K7 subtracts no
    mean, so its sums carry the full 16-bit values)."""
    blocks, ids, geom = _sweep_inputs(dyadic=True)
    geom[::9, 3] = 0.0  # invalid tiles
    geom[5, 2] = 1.984375  # about the coarsest mip's step: the widest weight rows
    geom[6, 0:2] = (-0.5, 40.0)  # positions clipped at both patch edges
    got, want = _k7_both(blocks, ids, geom)
    print(f"K7 plain vs JAX interpret (1/64-texel positions): {np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert not got[::9].any()


# K7 on the sweep's continuous positions, against the plain version's own
# arithmetic in float64. XLA's CPU backend contracts p0 + k * dp into a fused
# multiply-add and torch does not, so the two f32 evaluations sample at
# positions one ulp of ~30 texels (2e-6) apart; on random texels, where
# neighbours differ by up to 65535, that alone moves a value by ~0.1 raw
# units. Measured against float64: the port 0.17, the JAX kernel 0.16, the
# two 0.28 apart. Each is held to 0.5 raw units of float64 (8e-6 of full
# scale) and to 1.0 of the other.
TOL_CONTINUOUS = 0.5


def test_fetch_resample_continuous_positions():
    blocks, ids, geom = _sweep_inputs()
    got, want = _k7_both(blocks, ids, geom)
    exact = kernels.fetch_resample_reference(
        torch.from_numpy(blocks), torch.from_numpy(ids),
        torch.from_numpy(geom).double()).numpy()
    print(f"K7 on continuous positions: port vs float64 {np.abs(got - exact).max():.3e}, JAX "
          f"vs float64 {np.abs(want - exact).max():.3e}, port vs JAX "
          f"{np.abs(got - want).max():.3e} raw units")
    np.testing.assert_allclose(got, exact, rtol=0, atol=TOL_CONTINUOUS)
    np.testing.assert_allclose(want, exact, rtol=0, atol=TOL_CONTINUOUS)
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * TOL_CONTINUOUS)


@pytest.mark.parametrize("ratio", [None, 0.0, 1.0], ids=["planned", "ratio0", "ratio1"])
def test_permuted_fetch_resample_equals_cached(frame, ratio):
    """K7 (weights crossfaded, natural order) re-ordered evens-first is K6
    (values blended on both sides): the two blends are the same linear map,
    ``(A w) patch == A (w patch)``."""
    geom = frame["geom"].clone()
    if ratio is not None:
        geom[:, 4] = ratio
    blocks = torch.from_numpy(frame["blocks"])
    ids = frame["batch"].ids
    k6 = kernels.fetch_resample_cached(blocks, ids, geom, torch.tensor([64], dtype=torch.int32))
    ids4 = ids[:, None].expand(-1, 4).contiguous()
    k7 = ps.permute_halfgrid(kernels.fetch_resample(blocks, ids4, geom))
    print(f"permute(K7) vs K6 ({ratio}): {float((k7 - k6).abs().max()):.3e} raw units")
    np.testing.assert_allclose(k7.numpy(), k6.numpy(), rtol=0, atol=TOL)


def test_wrapper_argument_checks(frame):
    blocks = torch.from_numpy(frame["blocks"])
    ids, geom = frame["batch"].ids, frame["geom"]
    count = frame["tiles"].tile_count.reshape(1)
    ids4 = ids[:, None].expand(-1, 4).contiguous()
    bad_k6 = [
        (blocks.float(), ids, geom, count),
        (blocks[:, :16], ids, geom, count),
        (blocks, ids.long(), geom, count),
        (blocks, ids4, geom, count),
        (blocks, ids, geom[:, :5].contiguous(), count),
        (blocks, ids, geom.t().contiguous().t(), count),
        (blocks, ids, geom, count.long()),
        (blocks, ids, geom, torch.zeros(2, dtype=torch.int32)),
    ]
    for args in bad_k6:
        with pytest.raises(ValueError):
            kernels.fetch_resample_cached(*args)
    bad_k7 = [
        (blocks.float(), ids4, geom),
        (blocks, ids, geom),
        (blocks, ids4[:, :2].contiguous(), geom),
        (blocks, ids4, geom[:-1]),
        (blocks, ids4, geom.double()),
    ]
    for args in bad_k7:
        with pytest.raises(ValueError):
            kernels.fetch_resample(*args)
    # a CPU call runs the plain version and does not count as a launch
    before = kernels.fetch_resample_cached.launches, kernels.fetch_resample.launches
    kernels.fetch_resample_cached(blocks, ids, geom, count)
    kernels.fetch_resample(blocks, ids4, geom)
    assert before == (kernels.fetch_resample_cached.launches, kernels.fetch_resample.launches)
    assert kernels.fetch_resample_cached(blocks, ids[:0], geom[:0], count).shape == (0, K, K)


# -- the staged functions of ops/patch_sampling.py ------------------------------


@pytest.fixture(scope="module", params=[16, 8], ids=["grid16", "grid8"])
def staged(request, frame):
    """The frame's patches, geometry and random morphed-like uvs at one grid
    size, as numpy."""
    G = request.param
    n_pts = 2 * G + 1
    rng = np.random.default_rng(G)
    grid = np.arange(G + 1, dtype=np.float32)
    jitter = rng.uniform(0, 1, (64, G + 1, G + 1, 2)).astype(np.float32)
    uv = np.abs(np.stack(np.meshgrid(grid, grid, indexing="xy"), axis=-1) - jitter) / G
    geom = frame["geom"].numpy()
    if G != 16:  # the plan's texel step is per half-grid index
        geom = geom.copy()
        geom[:, 2] *= 16 / G
    half = rng.uniform(0, 65535, (64, n_pts, n_pts)).astype(np.float32)
    return dict(G=G, cfg=dataclasses.replace(frame["cfg"], grid_size=G),
                jcfg=dataclasses.replace(frame["jcfg"], grid_size=G),
                ids=frame["batch"].ids.numpy()[:, None], blocks=frame["blocks"], geom=geom,
                uv=uv, half=half)


def test_fetch_patches_matches_jax(staged):
    for keep_int in (False, True):
        got = ps.fetch_patches(torch.from_numpy(staged["blocks"]),
                               torch.from_numpy(staged["ids"]), keep_int=keep_int)
        want = jps.fetch_patches_xla(jnp.asarray(staged["blocks"]), jnp.asarray(staged["ids"]),
                                     keep_int=keep_int)
        assert got.shape == (64, 64, 64)
        assert got.dtype == (torch.int32 if keep_int else torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_ratio", [False, True], ids=["plain", "ratio"])
def test_halfgrid_resample_matches_jax(staged, with_ratio):
    """Tent-weight products in f32 on both sides: within 0.05 raw units
    (summation order)."""
    geom = staged["geom"]
    patch = jps.fetch_patches_xla(jnp.asarray(staged["blocks"]), jnp.asarray(staged["ids"]))
    ratio = geom[:, 4] if with_ratio else None
    got = ps.halfgrid_resample(
        torch.from_numpy(np.asarray(patch)), torch.from_numpy(geom[:, 0:2]),
        torch.from_numpy(geom[:, 2]), staged["cfg"],
        ratio=None if ratio is None else torch.from_numpy(ratio))
    want = jps.halfgrid_resample(patch, jnp.asarray(geom[:, 0:2]), jnp.asarray(geom[:, 2]),
                                 staged["jcfg"],
                                 ratio=None if ratio is None else jnp.asarray(ratio))
    n_pts = 2 * staged["G"] + 1
    assert got.shape == (64, n_pts, n_pts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_smooth_and_permute_match_jax(staged):
    half = staged["half"]
    th, jh = torch.from_numpy(half), jnp.asarray(half)
    n_pts = half.shape[-1]
    np.testing.assert_array_equal(ps.halfgrid_perm(n_pts), jps.halfgrid_perm(n_pts))
    np.testing.assert_array_equal(ps.permute_halfgrid(th).numpy(),
                                  np.asarray(jps.permute_halfgrid(jh)))
    # 0.25 a + 0.5 b + 0.25 c in the same order on both sides
    np.testing.assert_allclose(ps.smooth_halfgrid(th).numpy(),
                               np.asarray(jps.smooth_halfgrid(jh)), rtol=0, atol=TOL)
    got = ps.smooth_halfgrid_permuted(ps.permute_halfgrid(th))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jps.smooth_halfgrid_permuted(jps.permute_halfgrid(jh))),
                               rtol=0, atol=TOL)
    # the permuted smoothing is the natural one, conjugated
    np.testing.assert_allclose(got.numpy(),
                               ps.permute_halfgrid(ps.smooth_halfgrid(th)).numpy(),
                               rtol=0, atol=TOL)


def test_window_and_vertex_values_match_jax(staged):
    G = staged["G"]
    half_p = np.asarray(jps.permute_halfgrid(jnp.asarray(staged["half"])))
    win = ps._window9(torch.from_numpy(half_p), G)
    jwin = jps._window9(jnp.asarray(half_p), G)
    assert set(win) == set(jwin) and len(win) == 9
    for key, term in win.items():
        np.testing.assert_array_equal(term.numpy(), np.asarray(jwin[key]), err_msg=str(key))
    got = ps.vertex_values_from_halfgrid(torch.from_numpy(half_p),
                                         torch.from_numpy(staged["uv"]), staged["cfg"])
    want = jps.vertex_values_from_halfgrid(jnp.asarray(half_p), jnp.asarray(staged["uv"]),
                                           staged["jcfg"])
    assert got.shape == (64, G + 1, G + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
