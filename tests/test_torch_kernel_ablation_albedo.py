"""The albedo kernel's ``ablate`` variants (K3): torch against JAX.

On the frame of tests/test_torch_material_kernel.py (``small_frame`` with a
random packed Rgba8 albedo of the height's plan), the port's
``meshgen.generate_mesh_fused(albedo_blocks=..., ablate=...)`` runs its
plain version on the CPU against the JAX package's in Pallas interpret
mode, for ``alb_no_unpack``, ``alb_no_dots`` and ``alb_no_interp`` (each
JAX run once per module): the mesh rows are the port's own K1's, bit for
bit; the colours are held as in test_torch_material_kernel.py, of full
scale (255; the raw signed word's 2^31 with ``alb_no_unpack``): the exact
path (``alb_no_unpack`` and ``alb_no_dots`` take it, as in the JAX kernel)
within the window's slope times the uv tolerance (32 x 1e-6), the fast
path (``alb_no_interp``) within 2/255, and both within 1e-5 where the two
kernels' morphed uvs are equal. tests/test_torch_kernel_ablation_shaded.py
holds K4's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_terrain_tpu.ops import meshgen as jmeshgen
from bevy_terrain_tpu.render import material as jmaterial
from bevy_terrain_tpu_torch.ops import kernels, meshgen
from tests.test_torch_material_kernel import (
    MAX_VALUE, TOL_EXACT, TOL_FAST, TOL_UV_SLOPE, _material, make_frame,
)
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)

ALBEDO_VARIANTS = ("alb_no_unpack", "alb_no_dots", "alb_no_interp")


def run_both(frame, name, shaded=False):
    """(port raw, port tiles, JAX raw) of one variant with the frame's
    4-channel albedo (fast path asked for, as generate_mesh_fused's
    default), shaded by the frame's material or not."""
    blocks, albedo = torch.from_numpy(frame["blocks"]), torch.from_numpy(frame["albedo"])
    raw, tiles = meshgen.generate_mesh_fused(
        frame["tiles"], blocks, frame["u"], frame["cfg"], frame["plan"], MAX_VALUE,
        albedo_blocks=albedo, albedo_channels=4, albedo_bits=8,
        shade_spec=frame["spec"] if shaded else None, ablate={name})
    spec = jmaterial.kernel_shade_spec(_material(jmaterial), 255.0) if shaded else None
    jraw, _ = jmeshgen.generate_mesh_fused(
        frame["jtiles"], jnp.asarray(frame["blocks"]), frame["ju"], frame["jcfg"],
        frame["jplan"], MAX_VALUE, interpret=True, albedo_blocks=jnp.asarray(frame["albedo"]),
        albedo_channels=4, albedo_bits=8, shade_spec=spec, ablate=frozenset({name}))
    return raw, tiles, jax.block_until_ready(jraw)


def colour_pair(frame, raw, tiles, jraw, scale: float):
    """(port colours, JAX colours, uvs equal mask) of the live tiles, in
    units of ``scale``."""
    n = int(tiles.tile_count)
    got = meshgen.fused_albedo_to_grid(raw, frame["cfg"], 4, scale).numpy()[:n]
    want = np.asarray(jmeshgen.fused_albedo_to_grid(jraw, frame["jcfg"], 4, scale))[:n]
    uv = meshgen.fused_to_grid(raw, tiles, frame["cfg"]).uvs[:n].numpy()
    juv = np.asarray(jmeshgen.fused_to_grid(jraw, frame["jtiles"], frame["jcfg"]).uvs)[:n]
    return got, want, (uv == juv).all(axis=-1)


@pytest.fixture(scope="module")
def frame():
    return make_frame()


@pytest.fixture(scope="module")
def runs(frame):
    return {name: run_both(frame, name) for name in ALBEDO_VARIANTS}


@pytest.mark.parametrize("name", ALBEDO_VARIANTS)
def test_mesh_rows_are_k1s(frame, runs, name):
    raw, tiles, _ = runs[name]
    k1, k1_tiles = meshgen.generate_mesh_fused(frame["tiles"], torch.from_numpy(frame["blocks"]),
                                               frame["u"], frame["cfg"], frame["plan"],
                                               MAX_VALUE)
    assert torch.equal(tiles.tile_xy, k1_tiles.tile_xy)
    assert torch.equal(raw[:, :kernels.OUT_CH], k1)


@pytest.mark.parametrize("name,scale,tol", [
    ("alb_no_unpack", 2.0 ** 31, TOL_UV_SLOPE), ("alb_no_dots", 255.0, TOL_UV_SLOPE),
    ("alb_no_interp", 255.0, TOL_FAST)])
def test_albedo_variant_matches_jax_interpret(frame, runs, name, scale, tol):
    raw, tiles, jraw = runs[name]
    got, want, same = colour_pair(frame, raw, tiles, jraw, scale)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)
    assert same.mean() > 0.5
    np.testing.assert_allclose(got[same], want[same], rtol=0, atol=TOL_EXACT, err_msg=name)
