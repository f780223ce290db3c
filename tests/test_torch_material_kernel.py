"""The fused albedo kernel (K3): torch against JAX.

On ``small_frame`` (tests/test_torch_patch_sampling.py) with a random packed
Rgba8 albedo of the height's plan, the port's plain version of
``mesh_fused_albedo`` (K3) runs on the CPU against the JAX package's
``mesh_fused`` with ``albedo_channels`` in Pallas interpret mode (each JAX
run happens once per module):

* K3's mesh rows are bit-identical to the port's own K1 (mesh_fused_planar)
  in every form, as the reference pins for its kernel
  (test_fused_mesh.py:346-349, 370-371);
* colours within 1e-5 of full scale of JAX's wherever the two kernels'
  morphed uvs are equal, exact and fast (bf16) path alike; elsewhere
  exact-path colours within the window slope times the uv tolerance
  (32 x 1e-6) and fast-path colours within 2/255, the reference's fast vs
  exact yardstick (test_fused_mesh.py:374), which the port's fast path
  also keeps against its exact path;
* the opaque (3-channel) RGB and the combined-block run are bit-identical
  to the 4-channel two-stream run.

tests/test_torch_material_shade.py holds the shaded kernel (K4) the same
way; the two files share this one's frame and helpers, and run their JAX
kernels in separate test processes. The CUDA kernels are compared with
these plain versions on the card by tests/test_torch_cuda.py (skipped
without a card) and by chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_terrain_tpu.ops import meshgen as jmeshgen
from bevy_terrain_tpu.ops import refinement as jrefinement
from bevy_terrain_tpu.ops.params import unpack_frame_uniforms as junpack
from bevy_terrain_tpu.render import material as jmaterial
from bevy_terrain_tpu_torch.ops import kernels, meshgen, refinement
from bevy_terrain_tpu_torch.ops.params import unpack_frame_uniforms
from bevy_terrain_tpu_torch.render import material
from tests.test_torch_attach_sampling import packed_words
from tests.test_torch_patch_sampling import LODS, small_frame
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)

MAX_VALUE = 65535.0
TOL_EXACT = 1e-5  # of full scale
TOL_FAST = 2.0 / 255.0  # one bf16 step of a 128-255 texel is 1/255
# the 3x3 window's slope (32 half-grid steps per unit uv, random texels)
# times the uv tolerance against the JAX kernel (1e-6)
TOL_UV_SLOPE = 32 * 1e-6


def _material(pkg):
    """test_fused_mesh.py:396-405's material plus a spot light, built in
    the package ``pkg`` (the port's or the JAX package's material module)."""
    return pkg.StandardMaterial(
        base_color=pkg.albedo_material(1), perceptual_roughness=0.6, metallic=0.2,
        reflectance=0.4,
        lights=(
            pkg.DirectionalLight(direction=(-0.3, -0.8, -0.5), color=(1.0, 0.9, 0.8),
                                 illuminance=0.9),
            pkg.PointLight(position=(120.0, 300.0, -80.0), range=3000.0, intensity=0.5),
            pkg.SpotLight(position=(0.0, 200.0, 0.0), direction=(0.1, -1.0, 0.2),
                          range=2000.0, intensity=0.7, inner_angle=0.3, outer_angle=0.7),
        ),
    )


# the kernel forms: (channels, fast, combined, shaded)
FORMS = {
    "exact": (4, False, False, False),
    "fast": (4, True, False, False),
    "opaque": (3, True, False, False),
    "combined": (4, True, True, False),
    "shaded_exact": (4, False, False, True),
    "shaded_fast": (4, True, False, True),
}
ALBEDO_FORMS = ("exact", "fast", "opaque", "combined")


def make_frame():
    """small_frame in both packages, its tiles, a random packed Rgba8
    albedo and the kernel material's shade spec."""
    blob, blocks, cfg, jcfg, plan, jplan = small_frame()
    albedo = packed_words(blocks.shape, 4, 8, 21)
    u = unpack_frame_uniforms(torch.from_numpy(blob), 1, LODS, 8)
    ju = junpack(jnp.asarray(blob), 1, LODS, 8)
    return dict(blocks=blocks, albedo=albedo, cfg=cfg, jcfg=jcfg, plan=plan, jplan=jplan,
                u=u, ju=ju, tiles=refinement.refine_tiles(u, cfg),
                jtiles=jrefinement.refine_tiles(ju, jcfg),
                spec=material.kernel_shade_spec(_material(material), 255.0))


def port_forms(frame, forms):
    """``forms`` through the port: {form: (raw, sorted tiles)}, plus K1."""
    out = {}
    blocks = torch.from_numpy(frame["blocks"])
    albedo = torch.from_numpy(frame["albedo"])
    for form in forms:
        channels, fast, combined, shaded = FORMS[form]
        out[form] = meshgen.generate_mesh_fused(
            frame["tiles"], torch.cat([blocks, albedo], dim=1) if combined else blocks,
            frame["u"], frame["cfg"], frame["plan"], MAX_VALUE,
            albedo_blocks=None if combined else albedo, albedo_channels=channels,
            albedo_bits=8, shade_spec=frame["spec"] if shaded else None, albedo_fast=fast,
            albedo_combined=combined)
    out["k1"] = meshgen.generate_mesh_fused(frame["tiles"], blocks, frame["u"], frame["cfg"],
                                            frame["plan"], MAX_VALUE)
    return out


def jax_forms(frame, forms):
    """The JAX kernel in interpret mode: {form: raw} for two-stream 4-channel
    ``forms``."""
    out = {}
    spec = jmaterial.kernel_shade_spec(_material(jmaterial), 255.0)
    for form in forms:
        _, fast, _, shaded = FORMS[form]
        raw, _ = jmeshgen.generate_mesh_fused(
            frame["jtiles"], jnp.asarray(frame["blocks"]), frame["ju"], frame["jcfg"],
            frame["jplan"], MAX_VALUE, interpret=True,
            albedo_blocks=jnp.asarray(frame["albedo"]), albedo_channels=4, albedo_bits=8,
            albedo_fast=fast, shade_spec=spec if shaded else None)
        out[form] = jax.block_until_ready(raw)
    return out


@pytest.fixture(scope="module")
def frame():
    return make_frame()


@pytest.fixture(scope="module")
def port(frame):
    return port_forms(frame, ALBEDO_FORMS)


@pytest.fixture(scope="module")
def jax_runs(frame):
    return jax_forms(frame, ("exact", "fast"))


def colors(frame, raw, channels: int, max_value: float) -> np.ndarray:
    return meshgen.fused_albedo_to_grid(raw, frame["cfg"], channels, max_value).numpy()


def jax_colors(frame, raw, max_value: float) -> np.ndarray:
    return np.asarray(jmeshgen.fused_albedo_to_grid(raw, frame["jcfg"], 4, max_value))


def check_mesh_rows(port, form):
    """The form's mesh rows are K1's, bit for bit, on K1's tile order."""
    raw, tiles = port[form]
    k1, k1_tiles = port["k1"]
    channels = FORMS[form][0]
    assert raw.shape == (k1.shape[0], kernels.OUT_CH + channels, 17, 17)
    assert torch.equal(tiles.tile_xy, k1_tiles.tile_xy)
    assert torch.equal(raw[:, :kernels.OUT_CH], k1), form


@pytest.mark.parametrize("form", sorted(ALBEDO_FORMS))
def test_mesh_rows_are_k1s(port, form):
    check_mesh_rows(port, form)


@pytest.mark.parametrize("form,tol", [("exact", TOL_UV_SLOPE), ("fast", TOL_FAST)])
def test_albedo_matches_jax_interpret(frame, port, jax_runs, form, tol):
    """Colours in [0, 1] (texel / 255), the same sorted tile rows in both.
    Where the two kernels' morphed uvs are bit-equal (about three vertices
    in four), the colours agree within 1e-5 on both paths; elsewhere the
    uvs differ by up to 1e-6 (XLA's CPU log2 in the morph ratio,
    test_torch_mesh_kernel.py), which the window's slope turns into up to
    32 x 1e-6 on random texels."""
    raw, tiles = port[form]
    n = int(tiles.tile_count)
    got = colors(frame, raw, 4, 255.0)[:n]
    want = jax_colors(frame, jax_runs[form], 255.0)[:n]
    assert n > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=form)
    uv = meshgen.fused_to_grid(raw, tiles, frame["cfg"]).uvs[:n].numpy()
    juv = np.asarray(jmeshgen.fused_to_grid(jax_runs[form], frame["jtiles"],
                                            frame["jcfg"]).uvs)[:n]
    same = (uv == juv).all(axis=-1)
    assert same.mean() > 0.5
    np.testing.assert_allclose(got[same], want[same], rtol=0, atol=TOL_EXACT, err_msg=form)


def test_fast_path_within_two_steps_of_exact(frame, port):
    n = int(port["exact"][1].tile_count)
    exact = colors(frame, port["exact"][0], 4, 255.0)[:n]
    fast = colors(frame, port["fast"][0], 4, 255.0)[:n]
    np.testing.assert_allclose(fast, exact, rtol=0, atol=TOL_FAST)
    assert not np.array_equal(fast, exact)  # the fast path does round


def test_opaque_and_combined_are_bit_identical(port):
    """Opaque (3 channels) skips the alpha channel only; combined blocks
    (heights rows 0:32, albedo rows 32:64) are the two-stream run."""
    fast = port["fast"][0]
    assert torch.equal(port["combined"][0], fast)
    assert torch.equal(port["opaque"][0], fast[:, :kernels.OUT_CH + 3])


def test_wrapper_checks_arguments(frame):
    _, _, args = meshgen.fused_kernel_args(
        frame["tiles"], torch.from_numpy(frame["blocks"]), frame["u"], frame["cfg"],
        frame["plan"], MAX_VALUE, albedo_blocks=torch.from_numpy(frame["albedo"]),
        albedo_channels=4, albedo_bits=8)
    base, albedo = args[:6], args[6]
    with pytest.raises(ValueError):  # 4 x 16 bits do not fit a word
        kernels.mesh_fused_albedo(*base, albedo, 4, 16)
    with pytest.raises(ValueError):  # albedo blocks and combined blocks
        kernels.mesh_fused_albedo(*base, albedo, 4, 8, True, True)
    with pytest.raises(ValueError):
        kernels.mesh_fused_albedo(*base, albedo[:-1], 4, 8)
    with pytest.raises(ValueError):  # not a material buffer
        kernels.mesh_fused_shaded(*base, albedo, 4, 8, torch.zeros(3))
    with pytest.raises(NotImplementedError):  # the sphere's albedo variant
        meshgen.fused_kernel_args(
            frame["tiles"], torch.from_numpy(frame["blocks"]), frame["u"],
            dataclasses.replace(frame["cfg"], spherical=True, high_precision=True),
            frame["plan"], MAX_VALUE, albedo_blocks=albedo, albedo_channels=4, albedo_bits=8)
    # a CPU call runs the plain version and does not count as a launch
    before = kernels.mesh_fused_albedo.launches
    kernels.mesh_fused_albedo(*base, albedo, 4, 8)
    assert kernels.mesh_fused_albedo.launches == before
