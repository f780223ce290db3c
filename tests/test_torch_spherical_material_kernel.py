"""The fused albedo on the spherical mesh kernel (K3s): torch against JAX.

On tests/test_torch_spherical_mesh.py's frames ("sphere": an Earth-radius
sphere seen from 20 km; "sphere_near": the view at 3 km, where the Taylor
near field runs) with a random packed Rgba8 albedo of the height's plan,
the port's plain version of ``mesh_fused_spherical_albedo`` runs on the CPU
against the JAX package's ``mesh_fused`` with ``spherical=True`` and
``albedo_channels`` in Pallas interpret mode (three JAX runs, once per
module: the sphere fast and exact, the near frame fast):

* the nine mesh channels are bit-identical to the port's own K2
  (``mesh_fused_spherical``) in every form;
* the raw tensor has 9 + C channels, the colours after the normals, as
  pallas_kernels.py:1093-1113 (``base_rows = 9``);
* colours per tile key against JAX's: where the two kernels' morphed uvs
  are bit-equal, within 1e-5 of full scale on both paths (measured
  1.2e-7); elsewhere the
  exact path within the window slope (32 half-grid steps per unit uv on
  random texels) times the frame's uv tolerance against the JAX kernel
  (test_torch_spherical_mesh.py::UV_TOL), the fast path within 2/255;
* against the plain version's own arithmetic in float64: exact-path colours
  within the same slope bound;
* the opaque (3-channel) RGB and the combined-block run are bit-identical to
  the 4-channel two-stream run; the fast path stays within 2/255 of the
  exact one;
* on the near frame the albedo is read at the MORPHED uv also where the
  normal is the unmorphed one (the Taylor near field).

The CUDA kernel is compared with this plain version on the card by
tests/test_torch_cuda.py (skipped without a card) and by chip_smoke.py.
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
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_spherical_mesh import FRAMES, LODS, UV_TOL, small_sphere_frame, tile_rows

MAX_VALUE = 65535.0
TOL_EXACT = 1e-5  # of full scale, where the uvs are bit-equal
TOL_FAST = 2.0 / 255.0  # one bf16 step of a 128-255 texel is 1/255
SLOPE = 32.0  # the 3x3 window's slope: half-grid steps per unit uv

# the port's forms: (channels, fast, combined)
FORMS = {"exact": (4, False, False), "fast": (4, True, False), "opaque": (3, True, False),
         "combined": (4, True, True)}
# the JAX runs (interpret mode, ~40 s each here)
JAX_RUNS = (("sphere", "fast"), ("sphere", "exact"), ("sphere_near", "fast"))


def _frame(name):
    blob, blocks, cfg, plan = small_sphere_frame(*FRAMES[name])
    albedo = packed_words(blocks.shape, 4, 8, 31)
    return dict(blob=blob, blocks=blocks, albedo=albedo, cfg=cfg, plan=plan)


def _port(frame):
    """{form: raw}, the sorted tiles, K2's raw tensor and the kernel args."""
    cfg = StaticTerrainConfig(**frame["cfg"])
    u = unpack_frame_uniforms(torch.from_numpy(frame["blob"]), 6, LODS, 8)
    tiles = refinement.refine_tiles(u, cfg)
    blocks, albedo = torch.from_numpy(frame["blocks"]), torch.from_numpy(frame["albedo"])
    out = {}
    for form, (channels, fast, combined) in FORMS.items():
        raw, stiles = meshgen.generate_mesh_fused(
            tiles, torch.cat([blocks, albedo], dim=1) if combined else blocks, u, cfg,
            frame["plan"], MAX_VALUE, albedo_blocks=None if combined else albedo,
            albedo_channels=channels, albedo_bits=8, albedo_fast=fast,
            albedo_combined=combined)
        out[form] = raw
    k2, k2_tiles = meshgen.generate_mesh_fused(tiles, blocks, u, cfg, frame["plan"], MAX_VALUE)
    assert torch.equal(k2_tiles.tile_xy, stiles.tile_xy)
    _, _, args = meshgen.fused_kernel_args(tiles, blocks, u, cfg, frame["plan"], MAX_VALUE,
                                           albedo_blocks=albedo, albedo_channels=4,
                                           albedo_bits=8, albedo_fast=False)
    return dict(raws=out, tiles=stiles, k2=k2, cfg=cfg, args=args)


def _jax(frame, fast: bool):
    jcfg = JStaticConfig(**frame["cfg"])
    ju = junpack(jnp.array(frame["blob"]), 6, LODS, 8)
    raw, jtiles = jmeshgen.generate_mesh_fused(
        jrefinement.refine_tiles(ju, jcfg), jnp.array(frame["blocks"]), ju, jcfg,
        frame["plan"], MAX_VALUE, interpret=True, albedo_blocks=jnp.array(frame["albedo"]),
        albedo_channels=4, albedo_bits=8, albedo_fast=fast)
    raw = jax.block_until_ready(raw)
    return dict(raw=raw, tiles=jtiles, cfg=jcfg,
                colors=np.asarray(jmeshgen.fused_albedo_to_grid(raw, jcfg, 4, 255.0)),
                uvs=np.asarray(jmeshgen.fused_to_grid(raw, jtiles, jcfg, ju).uvs))


@pytest.fixture(scope="module")
def frames():
    return {name: _frame(name) for name in ("sphere", "sphere_near")}


@pytest.fixture(scope="module")
def port(frames):
    return {name: _port(frame) for name, frame in frames.items()}


@pytest.fixture(scope="module")
def jax_runs(frames):
    return {(name, form): _jax(frames[name], form == "fast") for name, form in JAX_RUNS}


def _colors(p, form):
    channels = FORMS[form][0]
    return meshgen.fused_albedo_to_grid(p["raws"][form], p["cfg"], channels, 255.0).numpy()


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name", ["sphere", "sphere_near"])
def test_mesh_channels_are_k2s(port, name, form):
    """K3s's nine mesh channels are K2's, bit for bit, and the colours
    follow them (9 + C channels)."""
    p = port[name]
    raw = p["raws"][form]
    assert raw.shape == (p["k2"].shape[0], kernels.SPH_CH + FORMS[form][0], 17, 17)
    assert torch.equal(raw[:, :kernels.SPH_CH], p["k2"]), form
    n = int(p["tiles"].tile_count)
    assert raw[:n, kernels.SPH_CH:].any() and not raw[n:].any()


@pytest.mark.parametrize("name,form", JAX_RUNS)
def test_albedo_matches_jax_interpret(port, jax_runs, name, form):
    """Colours in [0, 1] (texel / 255) per tile key against the JAX kernel
    in interpret mode. Measured: bit-equal uvs on 83% ("sphere") and 90%
    ("sphere_near") of the vertices, colours there within 1.2e-7 on both
    paths (the bf16 sums round alike); elsewhere up to 1.6e-5."""
    p, j = port[name], jax_runs[(name, form)]
    n = int(p["tiles"].tile_count)
    assert n == int(j["tiles"].tile_count) > 6
    rows_j = tile_rows(j["tiles"], n)
    order = np.array([rows_j[key] for key in tile_rows(p["tiles"], n)])
    got = _colors(p, form)[:n]
    want = j["colors"][order]
    uv = meshgen.fused_to_grid(p["raws"][form], p["tiles"], p["cfg"]).uvs[:n].numpy()
    same = (uv == j["uvs"][order]).all(axis=-1)
    tol_same = TOL_EXACT
    tol_rest = TOL_FAST if form == "fast" else SLOPE * UV_TOL[name] + TOL_EXACT
    err_same = float(np.abs(got[same] - want[same]).max())
    err_rest = float(np.abs(got[~same] - want[~same]).max()) if (~same).any() else 0.0
    print(f"{name} {form}: {n} tiles, uvs bit-equal on {same.mean():.3f}; colours there "
          f"{err_same:.3e} (tol {tol_same:.1e}), elsewhere {err_rest:.3e} (tol {tol_rest:.1e})")
    assert np.isfinite(got).all() and same.mean() > 0.5
    assert err_same <= tol_same and err_rest <= tol_rest


@pytest.mark.parametrize("name", ["sphere", "sphere_near"])
def test_exact_path_matches_float64_arithmetic(port, name):
    """The plain version in float64 on the same inputs (the referee of the
    spherical tests): exact-path colours within the window slope times the
    f32 uv error. Measured 5.8e-6 ("sphere"), 9.7e-6 ("sphere_near")."""
    p = port[name]
    a = list(p["args"])
    for k in (2, 3, 4):  # geom, tile_params, fs
        a[k] = a[k].double()
    exact = kernels.mesh_fused_spherical_albedo_reference(*a)
    n = int(p["tiles"].tile_count)
    got = p["raws"]["exact"][:n, kernels.SPH_CH:].double() / 255.0
    want = exact[:n, kernels.SPH_CH:] / 255.0
    err = float((got - want).abs().max())
    print(f"{name}: exact colours vs float64 {err:.3e}")
    assert err <= SLOPE * UV_TOL[name] + TOL_EXACT


@pytest.mark.parametrize("name", ["sphere", "sphere_near"])
def test_opaque_and_combined_are_bit_identical(port, name):
    raws = port[name]["raws"]
    assert torch.equal(raws["combined"], raws["fast"])
    assert torch.equal(raws["opaque"], raws["fast"][:, :kernels.SPH_CH + 3])
    n = int(port[name]["tiles"].tile_count)
    exact, fast = _colors(port[name], "exact")[:n], _colors(port[name], "fast")[:n]
    np.testing.assert_allclose(fast, exact, rtol=0, atol=TOL_FAST)
    assert not np.array_equal(fast, exact)  # the fast path does round


def test_near_field_samples_the_morphed_uv(port):
    """In the Taylor near field the kernel keeps the unmorphed normal, but
    the albedo is read at the morphed uv: the colours equal the packed
    sampler's at the kernel's own uv channels, near-field vertices
    included."""
    p = port["sphere_near"]
    args = p["args"]
    raw = p["raws"]["exact"]
    n = int(p["tiles"].tile_count)
    geom = args[2].clone()
    geom[:, 4] = 0.0
    sampled = kernels.attach_sample_fused_packed(
        args[9], args[1], geom, raw[:, 4:6].contiguous(), args[6], 4, 8)
    np.testing.assert_allclose(raw[:n, kernels.SPH_CH:].numpy(), sampled[:n].numpy(), rtol=0,
                               atol=255.0 * TOL_EXACT)
    # the frame has near-field vertices that morph (so the two uvs differ)
    view = args[4][39:42]
    pos = raw[:n, 1:4].permute(0, 2, 3, 1)
    near = torch.linalg.vector_norm(pos - view, dim=-1) < 0.5 * float(args[4][27])
    grid = torch.arange(17, dtype=torch.float32) / 16.0
    morphed = (raw[:n, 4] != grid.view(1, 1, 17)) | (raw[:n, 5] != grid.view(1, 17, 1))
    assert int((near & morphed).sum()) > 100


def test_wrapper_checks_arguments(port):
    args = port["sphere"]["args"]
    blocks, ids, geom, params, fs, hp, count, origin_lod, ell, albedo = args[:10]
    base = (blocks, ids, geom, params, fs, hp, count, origin_lod, ell)
    with pytest.raises(ValueError):  # 4 x 16 bits do not fit a word
        kernels.mesh_fused_spherical_albedo(*base, albedo, 4, 16)
    with pytest.raises(ValueError):  # albedo blocks and combined blocks
        kernels.mesh_fused_spherical_albedo(*base, albedo, 4, 8, True, True)
    with pytest.raises(ValueError):  # the albedo does not pair with the heights
        kernels.mesh_fused_spherical_albedo(*base, albedo[:-1], 4, 8)
    with pytest.raises(ValueError):  # planar tile parameters
        kernels.mesh_fused_spherical_albedo(blocks, ids, geom, params[:, :4].contiguous(), fs,
                                            hp, count, origin_lod, ell, albedo, 4, 8)
    with pytest.raises(ValueError):  # one flag per 64-tile step
        kernels.mesh_fused_spherical_albedo(blocks, ids, geom, params, fs, hp[:1], count,
                                            origin_lod, ell, albedo, 4, 8)
    with pytest.raises(ValueError):
        kernels.mesh_fused_spherical_albedo(blocks, ids, geom, params, fs, hp, count, -1, ell,
                                            albedo, 4, 8)
    with pytest.raises(NotImplementedError):  # the in-kernel shade is planar
        meshgen.mesh_kernel(port["sphere"]["cfg"], 4, shaded=True)
    # a CPU call runs the plain version and does not count as a launch
    before = kernels.mesh_fused_spherical_albedo.launches
    out = kernels.mesh_fused_spherical_albedo(*base, albedo, 4, 8)
    assert kernels.mesh_fused_spherical_albedo.launches == before
    assert torch.equal(out, port["sphere"]["raws"]["fast"])
