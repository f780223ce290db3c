"""The fused shaded kernel (K4, K3 plus the in-kernel PBR shade): torch
against JAX.

On the frame of tests/test_torch_material_kernel.py (``small_frame`` with a
random packed Rgba8 albedo of the height's plan), the port's plain version
of ``mesh_fused_shaded`` runs on the CPU against the JAX package's
``mesh_fused(shade=...)`` in Pallas interpret mode, with the material of
test_fused_mesh.py:396-405 plus a spot light (each JAX run happens once per
module):

* the mesh rows are bit-identical to the port's own K1;
* the in-kernel shade within 2e-3 of JAX's over the exact albedo and within
  2/255 over the fast one (the bf16 albedo's yardstick; the shade's
  sensitivity to the base colour is below 1);
* within 2e-3 of the port's own staged ``render.material.shade`` on the
  same frame's albedo (test_fused_mesh.py:429);
* the packed material buffer holds kernel_shade_spec's constants, equal to
  the JAX package's spec.
"""

import numpy as np
import pytest
import torch

from bevy_terrain_tpu.render import material as jmaterial
from bevy_terrain_tpu_torch.ops import kernels, meshgen
from bevy_terrain_tpu_torch.render import material
from tests.test_torch_material_kernel import (
    MAX_VALUE, TOL_FAST, _material, check_mesh_rows, colors, jax_colors, jax_forms,
    make_frame, port_forms,
)
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)

TOL_SHADE = 2e-3
SHADED_FORMS = ("shaded_exact", "shaded_fast")


@pytest.fixture(scope="module")
def frame():
    return make_frame()


@pytest.fixture(scope="module")
def port(frame):
    """The shaded forms and the albedo forms they shade."""
    return port_forms(frame, ("exact", "fast", *SHADED_FORMS))


@pytest.fixture(scope="module")
def jax_runs(frame):
    return jax_forms(frame, SHADED_FORMS)


@pytest.mark.parametrize("form", SHADED_FORMS)
def test_mesh_rows_are_k1s(port, form):
    check_mesh_rows(port, form)


@pytest.mark.parametrize("form,tol", [("shaded_exact", TOL_SHADE),
                                      ("shaded_fast", TOL_FAST)])
def test_shade_matches_jax_interpret(frame, port, jax_runs, form, tol):
    raw, tiles = port[form]
    n = int(tiles.tile_count)
    got = colors(frame, raw, 4, 1.0)[:n]
    want = jax_colors(frame, jax_runs[form], 1.0)[:n]
    assert np.isfinite(got).all() and got[..., :3].max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=form)


@pytest.mark.parametrize("form", ["exact", "fast"])
def test_shade_matches_staged(frame, port, form):
    """The in-kernel shade against render.material.shade on the extracted
    mesh and the same kernel's albedo."""
    raw, tiles = port[form]
    shaded, _ = port[f"shaded_{form}"]
    cfg = frame["cfg"]
    want = material.shade(meshgen.fused_to_grid(raw, tiles, cfg), tiles, frame["u"], cfg,
                          material=_material(material), lighting=True,
                          attachment_samples={1: meshgen.fused_albedo_to_grid(raw, cfg, 4,
                                                                               255.0)})
    n = int(tiles.tile_count)
    np.testing.assert_allclose(colors(frame, shaded, 4, 1.0)[:n], want[:n].numpy(), rtol=0,
                               atol=TOL_SHADE)


def test_shade_spec_matches_jax():
    """The material the kernel bakes: kernel_shade_spec equals the JAX
    package's, and the packed buffer's constants are its f32 roundings."""
    spec = material.kernel_shade_spec(_material(material), 255.0)
    assert spec == jmaterial.kernel_shade_spec(_material(jmaterial), 255.0)
    buf = kernels.pack_shade_spec(spec, "cpu").numpy()
    pr = 0.6
    a2 = (pr * pr) ** 2
    np.testing.assert_array_equal(
        buf[:8], np.float32([1 / 255.0, 0.8, 0.2, 0.16 * 0.4 * 0.4 * 0.8, a2, a2 - 1.0,
                             2 * pr * pr, 3]))
    assert buf.shape == (kernels.SHADE_HEADER + 3 * kernels.LIGHT_STRIDE,)
    spot = buf[kernels.SHADE_HEADER + 2 * kernels.LIGHT_STRIDE:]
    assert spot[0] == 2 and spot[7] == np.float32(1 / 2000.0 ** 2)
    assert spot[11] == np.float32(np.cos(0.7))
    assert spot[12] == np.float32(1.0 / (np.cos(0.3) - np.cos(0.7)))
    # a shadow hook keeps the material on the staged path
    lit = material.StandardMaterial(lights=(material.DirectionalLight(shadow=lambda p: p),))
    assert material.kernel_shade_spec(lit, 255.0) is None


def test_dead_tiles_are_zero(frame):
    _, _, args = meshgen.fused_kernel_args(
        frame["tiles"], torch.from_numpy(frame["blocks"]), frame["u"], frame["cfg"],
        frame["plan"], MAX_VALUE, albedo_blocks=torch.from_numpy(frame["albedo"]),
        albedo_channels=4, albedo_bits=8, shade_spec=frame["spec"])
    full = kernels.mesh_fused_shaded(*args)
    cut = kernels.mesh_fused_shaded(*args[:5], torch.tensor([5], dtype=torch.int32),
                                    *args[6:])
    np.testing.assert_array_equal(cut[:5].numpy(), full[:5].numpy())
    assert not cut[5:].any()
