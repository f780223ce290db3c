"""The torch package's preprocess data ops against the JAX package's, on the
same seeded numpy inputs.

Host functions (ops/preprocess.py) are numpy in both packages and must be
bit-equal; the JAX package's ``downsample_tile`` runs its C++ runtime where
that is built, which it keeps bit-identical to its numpy branch. The
stack ops (ops/preprocess_device.py) run on CPU tensors here: stitch is a
texel permutation and must be equal; downsample and mips are exact on
integer-valued inputs (every sum of four values below 2^24 is exact in
f32) and within one f32 ulp otherwise (the four-term sums may be ordered
differently by XLA and torch). The dense tent products are full-f32
einsums in both and agree to summation order (a few ulps).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_terrain_tpu.math.coordinate import TileCoordinate as JTileCoordinate
from bevy_terrain_tpu.ops import preprocess as jpp
from bevy_terrain_tpu.ops import preprocess_device as jppd
from bevy_terrain_tpu_torch.config import AttachmentConfig
from bevy_terrain_tpu_torch.formats import tiff
from bevy_terrain_tpu_torch.math.coordinate import NEIGHBOURING_SIDES, TileCoordinate
from bevy_terrain_tpu_torch.ops import preprocess as pp
from bevy_terrain_tpu_torch.ops import preprocess_device as ppd

TS, B = 48, 2
CS = TS - 2 * B


def _field(n, rng):
    u, v = np.meshgrid((np.arange(n) + 0.5) / n, (np.arange(n) + 0.5) / n, indexing="xy")
    h = 0.4 + 0.3 * np.sin(2 * np.pi * u) * np.cos(np.pi * v) + 0.2 * u
    return (h + 0.01 * rng.standard_normal((n, n))).astype(np.float32)[..., None]


def _source(n=96, channels=1, nodata=False, seed=0):
    rng = np.random.default_rng(seed)
    src = np.concatenate([_field(n, rng) for _ in range(channels)], axis=-1)
    if nodata:
        src[20:35, 50:70] = 0.0
        src[n - 3:, :4] = 0.0
    return np.ascontiguousarray(src)


def _tile(rng, channels=1, zero_frac=0.2, integer=True):
    t = rng.uniform(1, 60000, (TS, TS, channels))
    if integer:
        t = np.rint(t)
    t[rng.uniform(size=(TS, TS)) < zero_frac] = 0.0
    t[:B] = t[-B:] = 0.0
    t[:, :B] = t[:, -B:] = 0.0
    return t.astype(np.float32)


def test_tent_matrix_and_tap_weights_equal():
    rng = np.random.default_rng(1)
    p = rng.uniform(-3.0, 70.0, 200)
    np.testing.assert_array_equal(pp._tent_matrix(p, 64), jpp._tent_matrix(p, 64))
    for got, want in zip(pp._tap_weights(p, 64), jpp._tap_weights(p, 64)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_resize_rows_and_cols_match_jax():
    rng = np.random.default_rng(2)
    src = _source(40, channels=2)
    my = pp._tent_matrix(rng.uniform(-1, 40, 30), 40)
    mx = pp._tent_matrix(rng.uniform(-1, 40, 50), 40)
    rows = pp._resize_rows(torch.from_numpy(my), torch.from_numpy(src))
    cols = pp._resize_cols(rows, torch.from_numpy(mx))
    jrows = jpp._resize_rows(jnp.asarray(my), jnp.asarray(src))
    jcols = jpp._resize_cols(jrows, jnp.asarray(mx))
    # two-term products in f32 in both; the order of their sums may differ
    np.testing.assert_allclose(rows.numpy(), np.asarray(jrows), rtol=0, atol=1e-6)
    np.testing.assert_allclose(cols.numpy(), np.asarray(jcols), rtol=0, atol=1e-6)


@pytest.mark.parametrize("nodata", [False, True])
@pytest.mark.parametrize("branch", ["host", "naive"])
def test_split_mosaic_bit_equal(branch, nodata):
    src = _source(96, nodata=nodata)
    kw = dict(naive=branch == "naive")
    for lod, tl, br in [(1, (0.0, 0.0), (1.0, 1.0)), (2, (0.1, 0.05), (0.8, 0.9))]:
        mosaic, valid = pp.split_mosaic(src, lod, CS, tl, br, row_band=50, **kw)
        jmosaic, jvalid = jpp.split_mosaic(src, lod, CS, tl, br, row_band=50, **kw)
        assert mosaic.dtype == jmosaic.dtype == np.float32
        np.testing.assert_array_equal(mosaic, jmosaic)
        np.testing.assert_array_equal(valid, jvalid)
        assert valid.all() != nodata


def test_split_mosaic_device_branch():
    """``use_device`` runs the dense tent products (full f32) on the given
    device; on the CPU it agrees with the JAX branch to summation order and
    with the host branch to a few ulps."""
    src = _source(96, nodata=True)
    mosaic, valid = pp.split_mosaic(src, 1, CS, (0.0, 0.0), (1.0, 1.0), use_device="cpu")
    jmosaic, jvalid = jpp.split_mosaic(src, 1, CS, (0.0, 0.0), (1.0, 1.0), use_device=True)
    host, _ = pp.split_mosaic(src, 1, CS, (0.0, 0.0), (1.0, 1.0))
    np.testing.assert_allclose(mosaic, jmosaic, rtol=0, atol=1e-6)
    np.testing.assert_allclose(mosaic, host, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(valid, jvalid)


def test_split_bilinear_equals_host_split():
    """The device path's split (2-tap, separate ops) gives the host numpy
    split's bits, nodata texels included."""
    src = _source(96, channels=2, nodata=True)
    for lod in (1, 2):
        P = (1 << lod) * CS
        uv = (np.arange(P, dtype=np.float64) + 0.5) / P
        pos = uv * 96 - 0.5
        taps = [torch.from_numpy(a) for a in pp._tap_weights(pos, 96)]
        got = ppd.split_bilinear(torch.from_numpy(src), taps, taps)
        want, _ = pp.split_mosaic(src, lod, CS, (0.0, 0.0), (1.0, 1.0))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("with_existing", [False, True])
def test_extract_tile_from_mosaic_bit_equal(with_existing):
    rng = np.random.default_rng(3)
    src = _source(96, nodata=True)
    mosaic, valid = pp.split_mosaic(src, 1, CS, (0.0, 0.0), (1.0, 1.0))
    existing = rng.integers(0, 65535, (TS, TS, 1)).astype(np.uint16) if with_existing else None
    quantized = np.clip(np.rint(mosaic * 65535.0), 0, 65535.0).astype(np.uint16)
    for tx, ty in [(0, 0), (1, 0), (0, 1), (1, 1)]:
        args = (mosaic, valid, tx, ty, TS, B, np.uint16, 65535.0, existing)
        got = pp.extract_tile_from_mosaic(*args)
        np.testing.assert_array_equal(got, jpp.extract_tile_from_mosaic(*args))
        np.testing.assert_array_equal(
            pp.extract_tile_from_mosaic(*args, quantized=quantized), got)


@pytest.mark.parametrize("dtype,channels", [(np.uint16, 1), (np.uint8, 4)])
def test_downsample_tile_bit_equal(dtype, channels):
    rng = np.random.default_rng(4)
    top = np.iinfo(dtype).max
    kids = []
    for i in range(4):
        t = rng.integers(0, top, (TS, TS, channels)).astype(dtype)
        t[rng.uniform(size=(TS, TS)) < 0.3] = 0
        kids.append(t)
    for children in (kids, [kids[0], None, kids[2], None], [None, None, None, kids[3]]):
        got = pp.downsample_tile(children, TS, B)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, jpp.downsample_tile(children, TS, B))
        np.testing.assert_array_equal(pp.downsample_tile_numpy(children, TS, B),
                                      jpp.downsample_tile_numpy(children, TS, B))


def test_stitch_tile_planar_bit_equal():
    rng = np.random.default_rng(5)
    tiles = [rng.integers(1, 65535, (TS, TS, 1)).astype(np.uint16) for _ in range(9)]
    for missing in ([], [1, 4], list(range(8))):
        neighbours = [(0, None if slot in missing else tiles[slot + 1]) for slot in range(8)]
        np.testing.assert_array_equal(pp.stitch_tile(tiles[0], 0, neighbours, B),
                                      jpp.stitch_tile(tiles[0], 0, neighbours, B))


@pytest.mark.parametrize("side", range(6))
def test_stitch_tile_cross_face_bit_equal(side):
    """Every cross-face case of NEIGHBOURING_SIDES: each neighbouring side
    (and the tile's own) in every slot."""
    rng = np.random.default_rng(10 + side)
    tile = rng.integers(1, 65535, (TS, TS, 2)).astype(np.uint16)
    other = rng.integers(1, 65535, (TS, TS, 2)).astype(np.uint16)
    for n_side in sorted({int(s) for s in NEIGHBOURING_SIDES[side]} | {side}):
        for slot in range(8):
            neighbours = [(0, None)] * 8
            neighbours[slot] = (n_side, other)
            np.testing.assert_array_equal(
                pp.stitch_tile(tile, side, neighbours, B),
                jpp.stitch_tile(tile, side, neighbours, B), err_msg=f"{n_side} {slot}")


def test_remap_descriptor_tables_equal():
    for side in range(6):
        for proj in sorted({int(s) for s in NEIGHBOURING_SIDES[side]} | {side}):
            for slot in range(8):
                for size, border in ((TS, B), (68, 2), (40, 1)):
                    got = ppd._remap_descriptor(side, proj, slot, size, border)
                    want = jppd._remap_descriptor(side, proj, slot, size, border)
                    assert tuple(got) == tuple(want), (side, proj, slot, size)
    assert ppd._region_rects(TS, B) == jppd._region_rects(TS, B)


@pytest.mark.parametrize("integer", [True, False])
def test_downsample_stack_matches_jax(integer):
    rng = np.random.default_rng(6)
    children = np.stack([_tile(rng, channels=2, integer=integer) for _ in range(8)])
    idx = np.array([[0, 1, 2, 3], [4, 5, 6, -1], [-1, -1, 7, -1]], np.int32)
    got = ppd.downsample_stack(torch.from_numpy(children), torch.from_numpy(idx), TS, B).numpy()
    want = np.asarray(jppd.downsample_stack(jnp.asarray(children), jnp.asarray(idx), TS, B))
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    # the host oracle on the same children, after the preprocessor's rint
    kids = [children[i].astype(np.uint16) if i >= 0 else None for i in idx[1]]
    if integer:
        np.testing.assert_array_equal(np.rint(got[1]).astype(np.uint16),
                                      pp.downsample_tile_numpy(kids, TS, B)[..., :2])


def _stitch_case(spherical, lod):
    rng = np.random.default_rng(7)
    sides = range(6) if spherical else [0]
    coords = [TileCoordinate(s, lod, x, y) for s in sides
              for x in range(1 << lod) for y in range(1 << lod)]
    coords.pop(3)  # one missing tile: the clamp-repeat fallback
    stack = np.stack([_tile(rng, zero_frac=0.0) for _ in coords])
    index_of = {c: i for i, c in enumerate(coords)}
    nst = len(coords) - 2  # the last two rows are neighbour rows only
    return coords, stack, index_of, nst


@pytest.mark.parametrize("spherical,lod", [(False, 1), (False, 2), (True, 1), (True, 0)],
                         ids=["planar", "planar-lod2", "cross-face", "cross-face-lod0"])
def test_stitch_stack_matches_jax(spherical, lod):
    coords, stack, index_of, nst = _stitch_case(spherical, lod)
    nbr_idx, nbr_side = ppd.stitch_plan(coords[:nst], index_of, spherical)
    jcoords = [JTileCoordinate(c.side, c.lod, c.x, c.y) for c in coords]
    jnbr_idx, jnbr_side = jppd.stitch_plan(
        jcoords[:nst], {j: index_of[c] for j, c in zip(jcoords, coords)}, spherical)
    np.testing.assert_array_equal(nbr_idx, jnbr_idx)
    np.testing.assert_array_equal(nbr_side, jnbr_side)
    sides = np.array([c.side for c in coords[:nst]])
    before = stack.copy()
    st = torch.from_numpy(stack)
    got = ppd.stitch_stack(st, sides, nbr_idx, nbr_side, B, spherical).numpy()
    np.testing.assert_array_equal(st.numpy(), before)  # the input stays as it was
    want = np.asarray(jppd.stitch_stack(jnp.asarray(stack), sides, jnp.asarray(jnbr_idx),
                                        jnbr_side, B, spherical))
    assert got.shape == (nst, TS, TS, 1)
    np.testing.assert_array_equal(got, want)


def test_extract_and_composite_borders_match_jax():
    rng = np.random.default_rng(8)
    stack = np.stack([_tile(rng, channels=3, zero_frac=0.0) for _ in range(4)])
    stack[:, :B] = 7.0
    got = ppd.extract_borders(torch.from_numpy(stack), B).numpy()
    want = np.asarray(jppd.extract_borders(jnp.asarray(stack), B))
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] == ppd.border_strip_length(TS, B, 3) == jppd.border_strip_length(TS, B, 3)
    for i in range(4):
        a = np.zeros((TS, TS, 3), np.float32)
        b = np.zeros((TS, TS, 3), np.float32)
        ppd.composite_borders(a, got[i], B)
        jppd.composite_borders(b, want[i], B)
        np.testing.assert_array_equal(a, b)
        inner = np.zeros((TS, TS), bool)
        inner[B:-B, B:-B] = True
        np.testing.assert_array_equal(a[~inner], stack[i][~inner])


@pytest.mark.parametrize("nodata_aware", [True, False])
@pytest.mark.parametrize("quantize", [True, False])
def test_mip_stack_matches_jax(nodata_aware, quantize):
    rng = np.random.default_rng(9)
    tiles = np.stack([_tile(rng, channels=2), _tile(rng, channels=2, zero_frac=0.9)])
    got = ppd.mip_stack(torch.from_numpy(tiles), 4, nodata_aware, quantize=quantize)
    want = jppd.mip_stack(jnp.asarray(tiles), 4, nodata_aware, quantize=quantize)
    assert len(got) == len(want) == 4
    for level, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        if quantize or level <= 1:
            # integer-valued input to the level: every sum exact, one division
            np.testing.assert_array_equal(g, w, err_msg=str(level))
        else:
            # non-integer means summed again: the order of the four-term
            # sums may differ by one rounding
            np.testing.assert_array_max_ulp(g, w, maxulp=1)


def test_stored_width_keeps_the_top_value():
    x = torch.tensor([0.0, 1.0, 32767.0, 32768.0, 65534.0, 65535.0])
    np.testing.assert_array_equal(ppd.read_stored(ppd.to_stored(x, np.uint16), np.uint16),
                                  [0, 1, 32767, 32768, 65534, 65535])
    y = torch.tensor([0.0, 128.0, 255.0])
    np.testing.assert_array_equal(ppd.read_stored(ppd.to_stored(y, np.uint8), np.uint8),
                                  [0, 128, 255])
    # stacks held at the stored width come back as the same f32
    for v, dtype in ((x, np.uint16), (y, np.uint8)):
        stored = ppd.to_stored(v, dtype)
        assert stored.dtype == ppd.stored_dtype(dtype)
        assert torch.equal(ppd.from_stored(stored), v)


def test_tiff_source_round_trip_matches_jax(tmp_path):
    from bevy_terrain_tpu.formats import tiff as jtiff

    src = _source(64)[..., 0]
    tiff.array_to_source(src, tmp_path / "port.png")
    jtiff.array_to_source(src, tmp_path / "jax.png")
    digest = [hashlib.sha256((tmp_path / f).read_bytes()).hexdigest()
              for f in ("port.png", "jax.png")]
    assert digest[0] == digest[1]
    for fmt in ("R16", "RGBA8"):
        from bevy_terrain_tpu.config import AttachmentConfig as JAtt
        from bevy_terrain_tpu.config import AttachmentFormat as JFormat
        from bevy_terrain_tpu_torch.config import AttachmentFormat

        att = AttachmentConfig(name="a", texture_size=TS, border_size=B,
                               format=AttachmentFormat[fmt])
        jatt = JAtt(name="a", texture_size=TS, border_size=B, format=JFormat[fmt])
        got = tiff.load_source_image(str(tmp_path / "port.png"), att)
        want = jtiff.load_source_image(str(tmp_path / "port.png"), jatt)
        assert got.shape == (64, 64, att.format.channels)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got[..., 0], np.clip(np.rint(src * 65535.0), 0, 65535) / np.float32(65535.0))
