"""The shaded kernel's ``ablate`` variants (K4): torch against JAX.

tests/test_torch_kernel_ablation_albedo.py's variants (``alb_no_unpack``,
``alb_no_dots``, ``alb_no_interp``) with the in-kernel shade of
tests/test_torch_material_shade.py's material, on the same frame, the port's
plain version on the CPU against the JAX kernel in interpret mode (each JAX
run once per module): the mesh rows are K1's, bit for bit; the shaded
colours within test_torch_material_shade.py's 2e-3 over the exact albedo
(``alb_no_unpack``, ``alb_no_dots``) and 2/255 over the fast one
(``alb_no_interp``), of full scale (1; with ``alb_no_unpack``'s raw words
as the base colour, the largest shaded magnitude).
"""

import numpy as np
import pytest
import torch

from bevy_terrain_tpu_torch.ops import kernels, meshgen
from tests.test_torch_kernel_ablation_albedo import ALBEDO_VARIANTS, colour_pair, run_both
from tests.test_torch_material_kernel import MAX_VALUE, TOL_FAST, make_frame
from tests.test_torch_material_shade import TOL_SHADE
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def frame():
    return make_frame()


@pytest.fixture(scope="module")
def runs(frame):
    return {name: run_both(frame, name, shaded=True) for name in ALBEDO_VARIANTS}


@pytest.mark.parametrize("name,tol", [("alb_no_unpack", TOL_SHADE), ("alb_no_dots", TOL_SHADE),
                                      ("alb_no_interp", TOL_FAST)])
def test_shaded_variant_matches_jax_interpret(frame, runs, name, tol):
    raw, tiles, jraw = runs[name]
    k1, _ = meshgen.generate_mesh_fused(frame["tiles"], torch.from_numpy(frame["blocks"]),
                                        frame["u"], frame["cfg"], frame["plan"], MAX_VALUE)
    assert torch.equal(raw[:, :kernels.OUT_CH], k1)
    got, want, _ = colour_pair(frame, raw, tiles, jraw, 1.0)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.isfinite(got).all() and got[..., :3].max() > 0.05
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol, err_msg=name)
