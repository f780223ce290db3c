"""Attachment samplers (kernel K5): the torch package against the JAX package.

On ``small_frame`` (tests/test_torch_patch_sampling.py) both packages plan
the attachment's patch fetches in the frame's order (``assume_sorted``) and
sample it at the same random vertex uvs. The port's plain versions of
``attach_sample_fused`` (one raw channel) and ``attach_sample_fused_packed``
(Rgba8 = 4 x 8 bits, Rg16 = 2 x 16 bits) must match the JAX package's Pallas
kernels run in interpret mode within 1e-5 of full scale (texel / max value;
the reference's own sampler yardstick is 2e-3, test_fused_mesh.py:257), and
``sample_attachment_vertices`` must match the JAX package's (its XLA
fallback on the CPU) within 1e-5.

The CUDA kernel itself is compared with the plain version on the card by
tests/test_torch_cuda.py (skipped without a card) and by chip_smoke.py.
"""

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

GV = 17
T = jpk.TILES_PER_STEP
# (channels, bits, full scale); bits 0 is one raw channel (the height blocks)
FORMATS = {"raw": (1, 0, 65535.0), "rgba8": (4, 8, 255.0), "rg16": (2, 16, 65535.0)}
TOL = 1e-5  # of full scale


def packed_words(shape, channels: int, bits: int, seed: int) -> np.ndarray:
    """Random texels, ``channels`` channels of ``bits`` bits packed into
    int32 words (channel c in bits [c * bits, (c + 1) * bits))."""
    rng = np.random.default_rng(seed)
    words = np.zeros(shape, np.uint32)
    for c in range(channels):
        words |= rng.integers(0, 1 << bits, shape).astype(np.uint32) << np.uint32(bits * c)
    return words.view(np.int32)


def jax_uvrows(uv: np.ndarray, Fp: int) -> jnp.ndarray:
    """(F, 17, 17, 2) uvs -> the JAX kernels' (steps, 34, 64 * 17) rows."""
    F = uv.shape[0]
    steps = Fp // T

    def rows_of(comp):
        x = np.concatenate([uv[..., comp], np.zeros((Fp - F, GV, GV), np.float32)])
        return x.reshape(steps, T, GV, GV).transpose(0, 2, 1, 3).reshape(steps, GV, T * GV)

    return jnp.asarray(np.concatenate([rows_of(0), rows_of(1)], axis=1))


def jax_unlane(raw, channels: int, Fp: int) -> np.ndarray:
    """The JAX kernels' (steps, C * 17, 64 * 17) -> (Fp, C, 17, 17)."""
    raw = np.asarray(raw)
    steps = Fp // T
    return np.stack([
        raw[:, c * GV:(c + 1) * GV].reshape(steps, GV, T, GV).transpose(0, 2, 1, 3)
        .reshape(Fp, GV, GV)
        for c in range(channels)
    ], axis=1)


@pytest.fixture(scope="module")
def frame():
    """The frame's sorted tiles and its attachment plan in both packages,
    random uvs, and the blocks of each format. Per-vertex blend, as in the
    fused frame: the plan's tile-center blend column (geom[:, 4], a log2
    that XLA's CPU backend rounds differently) is then zero."""
    blob, blocks, cfg, jcfg, plan, jplan = small_frame(blend_per_vertex=True)
    u = unpack_frame_uniforms(torch.from_numpy(blob), 1, LODS, 8)
    ju = junpack(jnp.asarray(blob), 1, LODS, 8)
    tiles, _ = ps.plan_patch_batch(refinement.refine_tiles(u, cfg), u, cfg, plan,
                                   blocks.shape[0])
    jtiles, _ = jps.plan_patch_batch(jrefinement.refine_tiles(ju, jcfg), ju, jcfg, jplan,
                                     blocks.shape[0], T)
    _, batch = ps.plan_patch_batch(tiles, u, cfg, plan, blocks.shape[0], assume_sorted=True)
    _, jbatch = jps.plan_patch_batch(jtiles, ju, jcfg, jplan, blocks.shape[0], T,
                                     assume_sorted=True)
    # morphed-like uvs: each vertex moved by up to one grid cell toward the
    # lower even vertex, inside its 3x3 window (vertex 0 moves up)
    rng = np.random.default_rng(4)
    grid = np.arange(GV, dtype=np.float32)
    jitter = rng.uniform(0, 1, (cfg.tile_capacity, GV, GV, 2)).astype(np.float32)
    uv = np.abs(np.stack(np.meshgrid(grid, grid, indexing="xy"), axis=-1) - jitter) / (GV - 1)
    data = {"raw": blocks, "rgba8": packed_words(blocks.shape, 4, 8, 11),
            "rg16": packed_words(blocks.shape, 2, 16, 12)}
    return dict(u=u, ju=ju, cfg=cfg, jcfg=jcfg, plan=plan, jplan=jplan, tiles=tiles,
                jtiles=jtiles, batch=batch, jbatch=jbatch, uv=uv, data=data)


def sample_both(frame, fmt: str):
    """K5 on ``fmt``'s blocks: (port plain version, JAX interpret), both
    (Fp, C, 17, 17) raw texel values, with the tile count."""
    channels, bits, _ = FORMATS[fmt]
    blocks = frame["data"][fmt]
    batch, jbatch = frame["batch"], frame["jbatch"]
    Fp = batch.ids.shape[0]
    geom = batch.geom.clone()
    geom[:, 4] = 0.0
    uvs = torch.from_numpy(frame["uv"]).permute(0, 3, 1, 2)
    uvs = torch.cat([uvs, uvs.new_zeros((Fp - uvs.shape[0], 2, GV, GV))]).contiguous()
    count = frame["tiles"].tile_count.reshape(1)
    args = (torch.from_numpy(blocks), batch.ids, geom, uvs, count)
    jbatch = jbatch._replace(geom=jbatch.geom.at[:, 4].set(0.0))
    uvrows = jax_uvrows(frame["uv"], Fp)
    if bits:
        got = kernels.attach_sample_fused_packed(*args, channels, bits)
        want = jpk.attach_sample_fused_packed(jnp.asarray(blocks), jbatch, uvrows, channels,
                                              bits, interpret=True)
    else:
        got = kernels.attach_sample_fused(*args)
        want = jpk.attach_sample_fused(jnp.asarray(blocks), jbatch, uvrows, interpret=True)
    return got.numpy(), jax_unlane(want, channels, Fp), int(count)


def test_assume_sorted_plan_matches_jax(frame):
    """A sibling attachment's plan keeps the frame's row order: every
    PatchBatch field equals the JAX package's, and the tile list is the
    frame's, unsorted."""
    batch, jbatch, tiles = frame["batch"], frame["jbatch"], frame["tiles"]
    for field in ("uq", "slots", "rank_lo", "rank_hi", "n_unique", "geom", "ids"):
        np.testing.assert_array_equal(getattr(batch, field).numpy(),
                                      np.asarray(getattr(jbatch, field)), err_msg=field)
    again, _ = ps.plan_patch_batch(tiles, frame["u"], frame["cfg"], frame["plan"],
                                   frame["data"]["raw"].shape[0], assume_sorted=True)
    for field in ("tile_side", "tile_lod", "tile_xy", "tile_count"):
        assert torch.equal(getattr(again, field), getattr(tiles, field)), field


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_attach_sample_matches_jax_interpret(frame, fmt):
    got, want, n = sample_both(frame, fmt)
    channels, _, full = FORMATS[fmt]
    assert got.shape == want.shape == (frame["batch"].ids.shape[0], channels, GV, GV)
    assert n > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got[:n] / full, want[:n] / full, rtol=0, atol=TOL,
                               err_msg=fmt)
    # texels uniform over the full range: every channel (the sign-bit one
    # too) samples to values around half of it, never below zero
    for c in range(channels):
        assert got[:n, c].min() >= 0.0 and 0.4 * full < got[:n, c].mean() < 0.6 * full


@pytest.mark.parametrize("fmt", ["rgba8", "rg16"])
def test_packed_is_per_channel(frame, fmt):
    """The packed sampler is the one-channel sampler on each unpacked
    channel (the top channel of Rgba8 / Rg16 holds the word's sign bit)."""
    channels, bits, _ = FORMATS[fmt]
    words = frame["data"][fmt]
    batch = frame["batch"]
    geom = batch.geom.clone()
    geom[:, 4] = 0.0
    uvs = torch.from_numpy(frame["uv"]).permute(0, 3, 1, 2).contiguous()
    count = frame["tiles"].tile_count.reshape(1)
    packed = kernels.attach_sample_fused_packed(torch.from_numpy(words), batch.ids, geom, uvs,
                                                count, channels, bits)
    for c in range(channels):
        plane = ((words.view(np.uint32) >> np.uint32(bits * c)) & ((1 << bits) - 1))
        one = kernels.attach_sample_fused(torch.from_numpy(plane.astype(np.int32)), batch.ids,
                                          geom, uvs, count)
        np.testing.assert_allclose(packed[:, c].numpy(), one[:, 0].numpy(), rtol=0,
                                   atol=TOL * (1 << bits), err_msg=f"{fmt} channel {c}")


@pytest.mark.parametrize("fmt", ["raw", "rgba8"])
def test_sample_attachment_vertices_matches_jax(frame, fmt):
    """The vertex sampler (kernel path) against the JAX package's on the
    CPU (its XLA fallback sampler), at the same uvs, in [0, 1]."""
    channels, bits, full = FORMATS[fmt]
    blocks = frame["data"][fmt]
    kw = dict(packed_channels=channels if bits else 0, packed_bits=bits)
    got = ps.sample_attachment_vertices(
        [torch.from_numpy(blocks)], frame["tiles"], torch.from_numpy(frame["uv"]), frame["u"],
        frame["cfg"], frame["plan"], full, **kw)
    want = np.asarray(jps.sample_attachment_vertices(
        [jnp.asarray(blocks)], frame["jtiles"], jnp.asarray(frame["uv"]), frame["ju"],
        frame["jcfg"], frame["jplan"], full, **kw))
    n = int(frame["tiles"].tile_count)
    assert got.shape == want.shape == (frame["cfg"].tile_capacity, GV, GV, channels)
    np.testing.assert_allclose(got[:n].numpy(), want[:n], rtol=0, atol=TOL)


def test_mismatched_plan_raises(frame):
    """An attachment with another patch plan needs the per-tile fallback
    sampler, which is not ported: it raises instead of sampling wrongly."""
    with pytest.raises(NotImplementedError):
        ps.sample_attachment_vertices(
            [torch.from_numpy(frame["data"]["raw"])], frame["tiles"],
            torch.from_numpy(frame["uv"]), frame["u"], frame["cfg"], frame["plan"], 65535.0,
            plan_matches_frame=False)


def test_dead_tiles_are_zero(frame):
    batch = frame["batch"]
    uvs = torch.from_numpy(frame["uv"]).permute(0, 3, 1, 2).contiguous()
    blocks = torch.from_numpy(frame["data"]["rgba8"])
    full = kernels.attach_sample_fused_packed(blocks, batch.ids, batch.geom, uvs,
                                              frame["tiles"].tile_count.reshape(1), 4, 8)
    cut = kernels.attach_sample_fused_packed(blocks, batch.ids, batch.geom, uvs,
                                             torch.tensor([5], dtype=torch.int32), 4, 8)
    np.testing.assert_array_equal(cut[:5].numpy(), full[:5].numpy())
    assert not cut[5:].any()


def test_wrapper_checks_arguments(frame):
    batch = frame["batch"]
    uvs = torch.from_numpy(frame["uv"]).permute(0, 3, 1, 2).contiguous()
    blocks = torch.from_numpy(frame["data"]["rgba8"])
    count = frame["tiles"].tile_count.reshape(1)
    with pytest.raises(ValueError):  # 3 x 16 bits do not fit a word
        kernels.attach_sample_fused_packed(blocks, batch.ids, batch.geom, uvs, count, 3, 16)
    with pytest.raises(ValueError):
        kernels.attach_sample_fused_packed(blocks, batch.ids, batch.geom, uvs, count, 4, 0)
    with pytest.raises(ValueError):  # uvs as (F, 17, 17, 2)
        kernels.attach_sample_fused(blocks, batch.ids, batch.geom,
                                    torch.from_numpy(frame["uv"]), count)
    # a CPU call runs the plain version and does not count as a launch
    before = kernels.attach_sample_fused.launches
    kernels.attach_sample_fused(blocks, batch.ids, batch.geom, uvs, count)
    assert kernels.attach_sample_fused.launches == before


def test_packed_blocks_match_jax():
    """The atlas's packed upload layout: blocks_from_tile_packed on an Rgba8
    and an Rg16 mip chain equals the JAX package's, word for word."""
    plan = ps.make_patch_plan(512, 4, 2)
    rng = np.random.default_rng(5)
    for dtype, channels in ((np.uint8, 4), (np.uint16, 2)):
        mips = [rng.integers(0, np.iinfo(dtype).max + 1, (s, s, channels)).astype(dtype)
                for s in (512, 256, 128, 64)]
        got = ps.blocks_from_tile_packed(mips, plan)
        want = jps.blocks_from_tile_packed(mips, jps.make_patch_plan(512, 4, 2))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
