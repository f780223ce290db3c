"""The mesh kernels' ``ablate`` variants: torch against JAX, K1 and K2.

The port's ``meshgen.generate_mesh_fused(ablate=...)`` runs the plain
versions on the CPU; the JAX package's ``generate_mesh_fused(ablate=...,
interpret=True)`` runs its Pallas kernel in interpret mode on the same
inputs (each JAX run once per module):

* K1 ``no_smooth`` on ``small_frame`` (tests/test_torch_patch_sampling.py):
  per tile key, heights and positions within 1e-3 m and uvs within 1e-6,
  the bounds of tests/test_torch_mesh_kernel.py;
* K2 ``no_taylor``, ``reuse_far`` and ``no_smooth`` on the 3 km sphere of
  tests/test_torch_spherical_mesh.py (the Taylor near field runs there), per
  tile key within that file's JAX_TOL and unit normals within 1e-5.

Where the JAX kernel leaves the output undefined (``no_phase_a`` reads
scratch that nothing wrote, ``alb_no_store`` writes one slab of it) the port
defines it, and is held to its definition: ``no_phase_a`` is the full
kernel on all-zero quads, ``alb_no_store`` keeps channel 0's sum of the
mean-centred resamples and zeros elsewhere. A name the variant's kernel does
not read raises. tests/test_torch_kernel_ablation_albedo.py and
tests/test_torch_kernel_ablation_shaded.py hold K3's and K4's variants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_terrain_tpu.ops import meshgen as jmeshgen
from bevy_terrain_tpu.ops import refinement as jrefinement
from bevy_terrain_tpu.ops.params import StaticTerrainConfig as JStaticConfig
from bevy_terrain_tpu.ops.params import unpack_frame_uniforms as junpack
from bevy_terrain_tpu_torch.ops import kernels, meshgen, refinement
from bevy_terrain_tpu_torch.ops.params import StaticTerrainConfig, unpack_frame_uniforms
from tests.test_torch_attach_sampling import packed_words
from tests.test_torch_patch_sampling import LODS, small_frame
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_spherical_mesh import JAX_TOL, small_sphere_frame, tile_rows

MAX_VALUE = 65535.0
SPHERE = ("sphere", 3000.0, True)  # test_torch_spherical_mesh.py's "sphere_near"
K2_VARIANTS = ("no_taylor", "reuse_far", "no_smooth")


def planar_inputs():
    """small_frame's (port args, JAX args) for generate_mesh_fused."""
    blob, blocks, cfg, jcfg, plan, jplan = small_frame()
    u = unpack_frame_uniforms(torch.from_numpy(blob), 1, LODS, 8)
    ju = junpack(jnp.asarray(blob), 1, LODS, 8)
    return ((refinement.refine_tiles(u, cfg), torch.from_numpy(blocks), u, cfg, plan, MAX_VALUE),
            (jrefinement.refine_tiles(ju, jcfg), jnp.asarray(blocks), ju, jcfg, jplan,
             MAX_VALUE))


def sphere_inputs():
    """The 3 km sphere's (port args, JAX args) for generate_mesh_fused."""
    blob, blocks, cfg, plan = small_sphere_frame(*SPHERE)
    pcfg, jcfg = StaticTerrainConfig(**cfg), JStaticConfig(**cfg)
    u = unpack_frame_uniforms(torch.from_numpy(blob), 6, pcfg.lod_count, 8)
    ju = junpack(jnp.array(blob), 6, pcfg.lod_count, 8)
    return ((refinement.refine_tiles(u, pcfg), torch.from_numpy(blocks), u, pcfg, plan,
             MAX_VALUE),
            (jrefinement.refine_tiles(ju, jcfg), jnp.array(blocks), ju, jcfg, plan, MAX_VALUE))


def grids(raw, tiles, cfg, u, jax_side: bool):
    """{field: (F, 17, 17[, k]) numpy} of a fused product."""
    if jax_side:
        mesh = jax.block_until_ready(jmeshgen.fused_to_grid(raw, tiles, cfg, u))
        return {f: np.asarray(getattr(mesh, f)) for f in ("heights", "positions", "uvs",
                                                           "normals")}
    mesh = meshgen.fused_to_grid(raw, tiles, cfg)
    return {f: getattr(mesh, f).numpy() for f in ("heights", "positions", "uvs", "normals")}


def run_both(inputs, ablate):
    """(port grids, port tiles, JAX grids, JAX tiles) of one variant."""
    (t, b, u, cfg, plan, mv), (jt, jb, ju, jcfg, jplan, _) = inputs
    raw, tiles = meshgen.generate_mesh_fused(t, b, u, cfg, plan, mv, ablate=ablate)
    jraw, jtiles = jmeshgen.generate_mesh_fused(jt, jb, ju, jcfg, jplan, mv, interpret=True,
                                                ablate=frozenset(ablate))
    return (grids(raw, tiles, cfg, u, False), tiles, grids(jraw, jtiles, jcfg, ju, True),
            jtiles)


@pytest.fixture(scope="module")
def planar():
    return planar_inputs()


def referee(inputs, ablate):
    """The port's spherical arithmetic in float64 on the same inputs (the
    plain version on double geom, tile_params and fs), as grids."""
    t, b, u, cfg, plan, mv = inputs[0]
    tiles, _, args = meshgen.fused_kernel_args(t, b, u, cfg, plan, mv)
    args = list(args)
    for k in (2, 3, 4):
        args[k] = args[k].double()
    raw = kernels.mesh_fused_spherical_reference(*args, ablate=ablate).float()
    return grids(raw, tiles, cfg, u, False)


@pytest.fixture(scope="module")
def sphere_runs():
    inputs = sphere_inputs()
    return {name: (*run_both(inputs, {name}), referee(inputs, {name})) for name in K2_VARIANTS}


def assert_per_key(got, tiles, want, jtiles, tols, ref=None, exact=None):
    """Per tile key, ``got`` within ``tols`` of ``want`` (the JAX kernel's).
    With ``ref`` (the same arithmetic in float64, rows paired with
    ``got``'s) and ``exact`` (the port's own bounds from it), values where
    the JAX kernel is farther than ``exact`` from ``ref`` are not compared
    (its rounding is what differs there); at least half are compared."""
    n = int(tiles.tile_count)
    assert n == int(jtiles.tile_count) > 0
    rows, jrows = tile_rows(tiles, n), tile_rows(jtiles, n)
    assert set(rows) == set(jrows)
    idx = np.array([rows[k] for k in rows])
    jidx = np.array([jrows[k] for k in rows])
    for field, atol in tols.items():
        g, w = got[field][idx].astype(np.float64), want[field][jidx].astype(np.float64)
        bound = np.full(g.shape, atol)
        if ref is not None:
            off = np.abs(w - ref[field][idx]) > exact[field]
            assert off.mean() <= 0.5, (field, float(off.mean()))
            bound[off] = np.inf
        over = np.abs(g - w) > bound
        assert not over.any(), (field, int(over.sum()), float(np.abs(g - w).max()))


def test_k1_no_smooth_matches_jax_interpret(planar):
    got, tiles, want, jtiles = run_both(planar, {"no_smooth"})
    assert_per_key(got, tiles, want, jtiles, {"heights": 1e-3, "positions": 1e-3, "uvs": 1e-6})
    # and it removed something: the full kernel's heights differ
    full, _ = meshgen.generate_mesh_fused(*planar[0])
    assert not np.array_equal(meshgen.fused_to_grid(full, tiles, planar[0][3]).heights.numpy(),
                              got["heights"])


# the port against its own float64 arithmetic: test_torch_spherical_mesh.py's
# bounds on the 3 km sphere (heights, positions, uvs, normals). Without the
# Taylor near field (no_taylor) the view distance near the camera is an f32
# difference of 6.4e6 m world coordinates: one 0.5 m ulp of a 3 km distance
# moves the morph ratio by 1.2e-3 (log2, over the 0.2 morph range) and a uv
# by up to 7.5e-5 (1/16 of it); its uvs are held to two such ulps
EXACT_TOL = {"heights": 1e-1, "positions": 3.0, "uvs": 3e-5, "normals": 1e-5}
EXACT_TOL_NO_TAYLOR = {**EXACT_TOL, "uvs": 1.5e-4}


@pytest.mark.parametrize("name", K2_VARIANTS)
def test_k2_variant_matches_jax_interpret(sphere_runs, name):
    """Within :data:`EXACT_TOL` of the port's float64 arithmetic, and
    within test_torch_spherical_mesh.py's JAX_TOL of the JAX kernel where
    the JAX kernel is within the same bounds of that arithmetic (measured
    on the CPU, largest distance from the float64 arithmetic, JAX kernel /
    port: no_taylor heights 0.52 / 0.079 m, uvs 5.7e-4 / 9.9e-5, positions
    4.25 / 2.0 m; reuse_far and no_smooth positions 3.75 / 1.0 and 3.62 /
    2.0 m)."""
    got, tiles, want, jtiles, ref = sphere_runs[name]
    exact = EXACT_TOL_NO_TAYLOR if name == "no_taylor" else EXACT_TOL
    h_tol, p_tol, uv_tol = JAX_TOL["sphere_near"]
    if name == "no_taylor":  # both within two distance ulps of the float64 uvs
        uv_tol = 2 * exact["uvs"]
    assert_per_key(got, tiles, want, jtiles, {"heights": h_tol, "positions": p_tol,
                                              "uvs": uv_tol, "normals": 1e-5}, ref, exact)
    for field, atol in exact.items():
        np.testing.assert_allclose(got[field], ref[field], rtol=0, atol=atol, err_msg=field)


def _zero_blocks(args, quad_rows=32):
    return (torch.zeros_like(args[0]),) + tuple(args[1:])


def test_no_phase_a_is_the_kernel_on_zero_quads(planar):
    """no_phase_a: the half-grids stay zero, which is what the full kernel
    computes from all-zero quads (an exact zero mean and resample); on K1,
    K2 (the 3 km sphere) and K3 / K4 (their albedo zero too)."""
    t, b, u, cfg, plan, mv = planar[0]
    _, _, args = meshgen.fused_kernel_args(t, b, u, cfg, plan, mv)
    got = kernels.mesh_fused_planar(*args, ablate={"no_phase_a"})
    assert torch.equal(got, kernels.mesh_fused_planar(*_zero_blocks(args)))
    albedo = torch.from_numpy(packed_words(tuple(b.shape), 4, 8, 21))
    for wrapper, extra in ((kernels.mesh_fused_albedo, ()),
                           (kernels.mesh_fused_shaded,
                            (kernels.pack_shade_spec(_spec(), "cpu"),))):
        kargs = (*args, albedo, 4, 8, *extra)
        zargs = (*_zero_blocks(args), torch.zeros_like(albedo), 4, 8, *extra)
        assert torch.equal(wrapper(*kargs, ablate={"no_phase_a"}), wrapper(*zargs))
    (t, b, u, cfg, plan, mv), _ = sphere_inputs()
    _, _, args = meshgen.fused_kernel_args(t, b, u, cfg, plan, mv)
    assert torch.equal(kernels.mesh_fused_spherical(*args, ablate={"no_phase_a"}),
                       kernels.mesh_fused_spherical(*_zero_blocks(args)))


def _spec():
    from bevy_terrain_tpu_torch.render import material

    return material.kernel_shade_spec(
        material.StandardMaterial(base_color=material.albedo_material(1)), 255.0)


@pytest.mark.parametrize("dots", [True, False], ids=["alb_no_store", "alb_no_dots+alb_no_store"])
def test_alb_no_store_keeps_one_sum(planar, dots):
    """alb_no_store: channel 0's half-grid holds the channels' mean-centred
    resamples summed (with alb_no_dots, their means summed), the other
    channels' zeros; the colours are the window over them."""
    t, b, u, cfg, plan, mv = planar[0]
    tiles, batch, args = meshgen.fused_kernel_args(t, b, u, cfg, plan, mv)
    albedo = torch.from_numpy(packed_words(tuple(b.shape), 4, 8, 21))
    words = albedo[batch.ids.long()]
    exact = kernels._channel_halfgrids(words, batch.geom, 4, 8, False)
    means = torch.stack([kernels.unpack(kernels._patch(words), c, 8).double().mean(dim=(1, 2))
                         for c in range(4)], dim=1).float()[:, :, None, None]
    ablate = {"alb_no_store"} if dots else {"alb_no_store", "alb_no_dots"}
    grids = kernels._channel_halfgrids(words, batch.geom, 4, 8, True, ablate)
    want = (exact - means).sum(dim=1) if dots else means.sum(dim=1).expand(-1, 33, 33)
    np.testing.assert_allclose(grids[:, 0].numpy(), want.numpy(), rtol=0, atol=1e-3)
    assert not grids[:, 1:].any()
    out = kernels.mesh_fused_albedo(*args, albedo, 4, 8, ablate=ablate)
    assert out[:, 6].any() and not out[:, 7:].any()


def test_unknown_names_raise(planar):
    t, b, u, cfg, plan, mv = planar[0]
    albedo = torch.from_numpy(packed_words(tuple(b.shape), 4, 8, 21))
    for bad in ({"no_taylor"}, {"reuse_far"}, {"alb_no_dots"}, {"bogus"}):
        with pytest.raises(ValueError):
            meshgen.generate_mesh_fused(t, b, u, cfg, plan, mv, ablate=bad)
    for bad in ({"no_taylor"}, {"smooth"}):
        with pytest.raises(ValueError):
            meshgen.generate_mesh_fused(t, b, u, cfg, plan, mv, albedo_blocks=albedo,
                                        albedo_channels=4, albedo_bits=8, ablate=bad)
    _, _, args = meshgen.fused_kernel_args(t, b, u, cfg, plan, mv)
    with pytest.raises(ValueError):
        kernels.mesh_fused_planar_reference(*args, ablate={"alb_no_interp"})
    # every name the variant's kernel reads is taken, alone and in any set
    for names in (kernels.MESH_ABLATE, {"no_smooth"}, {"no_phase_a"}):
        meshgen.generate_mesh_fused(t, b, u, cfg, plan, mv, ablate=names)
    assert kernels.mesh_fused_planar.ablated_launches == {}  # the CPU runs no kernel


def test_ablation_masks_are_the_instantiated_sets():
    """The CUDA instances: each name a kernel reads, alone, and the two
    pairs the JAX package's tools time (csrc/mesh_fused.cu's mask lists)."""
    bits = kernels.ABLATE_BITS
    assert sorted(kernels.ablation_masks(kernels.MESH_ABLATE)) == [4, 8]
    assert sorted(kernels.ablation_masks(kernels.SPHERE_ABLATE)) == [1, 2, 3, 4, 8]
    assert sorted(kernels.ablation_masks(kernels.MESH_ABLATE | kernels.ALBEDO_ABLATE)) == [
        4, 8, 16, 32, 64, 96, 128]
    assert len(kernels.ablation_masks(kernels.SPHERE_ABLATE | kernels.ALBEDO_ABLATE)) == 10
    assert bits["reuse_far"] | bits["no_taylor"] == 3
    assert kernels.ablate_label({"reuse_far", "no_taylor"}) == "no_taylor+reuse_far"
    assert kernels.ablate_label(()) == "full"
