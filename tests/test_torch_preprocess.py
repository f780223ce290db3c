"""The torch package's Preprocessor end to end against the JAX package's.

The same seeded sources go through both packages' ``Preprocessor``, each
with its own atlas (the port's on the CPU):

* the port's host path (and its naive oracle) writes every ``.bin`` and
  ``config.tc`` byte-identical to the JAX host path, planar (3 lods, a
  nodata hole) and spherical (2 lods, cross-face stitching);
* the port's device path on a CPU device: ``readback="delta"`` byte-exact,
  ``readback="full"`` within the JAX package's own yardstick for its full
  device path (at most 1 unit apart, on under 2% of the texels,
  tests/test_preprocess_device.py);
* the device path gives the same bytes when its stitch and downsample run
  in chunks of a few tiles, frees each lod's stacks once it is stitched,
  holds them at the stored width, and raises MemoryError before the split
  when its plan does not fit the device;
* ``device=None`` selects the device path only on a CUDA atlas whose two
  transfer probes pass, and warns when a CUDA atlas falls back to the host;
* the Rust-interchange fixture (the port's copy of tools/rust_interchange.py's
  source and settings) reproduces its committed sha256 for ``config.tc`` and
  all 21 tiles;
* a preprocessed dataset streams through the port's ``Terrain`` on the CPU
  and matches the analytic field (as tests/test_preprocess.py holds the
  JAX package) and the JAX ``Terrain``'s frame on the JAX-preprocessed copy
  within the fused-vs-staged yardsticks (heights and positions 2e-2, uvs
  1e-6; tests/test_fused_mesh.py).
"""

import hashlib
import json
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import bevy_terrain_tpu as jbt
import bevy_terrain_tpu_torch as bt
from bevy_terrain_tpu.formats.tiff import array_to_source as jarray_to_source
from bevy_terrain_tpu.terrain_data import TileAtlas as JTileAtlas
from bevy_terrain_tpu_torch.formats.tiff import array_to_source
from bevy_terrain_tpu_torch.preprocess import preprocessor as pre
from bevy_terrain_tpu_torch.terrain_data import TileAtlas
from bevy_terrain_tpu_torch.utils import transfer
from bevy_terrain_tpu_torch.utils.synthetic import INTERCHANGE, interchange_source
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)

PLANAR_ATT = dict(name="height", texture_size=40, border_size=2, mip_level_count=2)
SPHERE_ATT = dict(name="height", texture_size=68, border_size=2, mip_level_count=2)
# the JAX package's yardstick for its full device path against its host path
FULL_MAX_UNITS, FULL_MAX_SHARE = 1, 0.02


def field(u, v):
    return 0.4 + 0.3 * np.sin(2 * np.pi * u) * np.cos(np.pi * v) + 0.2 * u


def _planar_source(n=256):
    u, v = np.meshgrid((np.arange(n) + 0.5) / n, (np.arange(n) + 0.5) / n, indexing="xy")
    src = field(u, v).astype(np.float32)
    src[40:60, 10:30] = 0.0  # a nodata hole: the validity paths
    return src


def _write_sources(root: Path, spherical: bool, writer) -> list[str]:
    root.mkdir(parents=True, exist_ok=True)
    if not spherical:
        writer(_planar_source(), root / "src.png")
        return [str(root / "src.png")]
    rng = np.random.default_rng(11)
    paths = []
    for side in range(6):
        p = root / f"face{side}.png"
        writer(rng.uniform(0.1, 1.0, (64, 64)).astype(np.float32), p)
        paths.append(str(p))
    return paths


def _config(pkg, root: Path, spherical: bool, path: str = "t"):
    if spherical:
        model = pkg.TerrainModel.sphere(np.zeros(3), 100.0, 0.0, 10.0)
        att, lods = SPHERE_ATT, 2
    else:
        model = pkg.TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0)
        att, lods = PLANAR_ATT, 3
    return pkg.TerrainConfig(lod_count=lods, model=model, atlas_size=64, path=path,
                             attachments=(pkg.AttachmentConfig(**att),),
                             assets_root=str(root / "assets"))


def _queue(pp, pkg, paths, spherical, lods):
    pp.clear_attachment(0)
    if spherical:
        pp.preprocess_spherical(pkg.SphericalDataset(
            attachment_index=0, paths=paths, lod_range=range(0, lods)))
    else:
        pp.preprocess_tile(pkg.PreprocessDataset(
            attachment_index=0, path=paths[0], lod_range=range(0, lods)))
    pp.run(verbose=False)


def _artifacts(root: Path, path: str = "t"):
    data = root / "assets" / path / "data" / "height"
    bins = {p.name: p.read_bytes() for p in sorted(data.glob("*.bin"))}
    return bins, (root / "assets" / path / "config.tc").read_bytes()


def run_port(root: Path, spherical: bool, **kw):
    paths = _write_sources(root / "src", spherical, array_to_source)
    config = _config(bt, root, spherical)
    _queue(bt.Preprocessor(TileAtlas(config, "cpu"), **kw), bt, paths, spherical,
           config.lod_count)
    return _artifacts(root)


def run_jax(root: Path, spherical: bool):
    paths = _write_sources(root / "src", spherical, jarray_to_source)
    config = _config(jbt, root, spherical)
    _queue(jbt.Preprocessor(JTileAtlas(config), device=False), jbt, paths, spherical,
           config.lod_count)
    return _artifacts(root)


@pytest.fixture(scope="module")
def jax_host(tmp_path_factory):
    """The JAX host path's artifacts, planar and spherical."""
    root = tmp_path_factory.mktemp("jax_host")
    return {s: run_jax(root / ("sphere" if s else "planar"), s) for s in (False, True)}


@pytest.mark.parametrize("spherical", [False, True], ids=["planar", "spherical"])
@pytest.mark.parametrize("naive", [False, True], ids=["host", "naive"])
def test_host_path_byte_identical_to_jax(tmp_path, jax_host, spherical, naive):
    bins, tc = run_port(tmp_path, spherical, device=False, naive=naive)
    jbins, jtc = jax_host[spherical]
    assert bins and list(bins) == list(jbins)
    assert len(bins) == (6 * (1 + 4) if spherical else 1 + 4 + 16)
    assert tc == jtc
    for name in bins:
        assert bins[name] == jbins[name], name


@pytest.mark.parametrize("spherical", [False, True], ids=["planar", "spherical"])
@pytest.mark.parametrize("readback", ["delta", "full"])
def test_device_path_on_cpu_against_jax_host(tmp_path, jax_host, spherical, readback):
    _hold_device_path(run_port(tmp_path, spherical, device=True, readback=readback),
                      jax_host[spherical], readback)


@pytest.mark.parametrize("spherical", [False, True], ids=["planar", "spherical"])
@pytest.mark.parametrize("readback", ["delta", "full"])
def test_device_path_in_chunks_of_a_few_tiles(tmp_path, jax_host, monkeypatch, spherical,
                                              readback):
    """Stitch chunks of 3 tiles and downsample chunks of 1 parent: every
    chunk gathers its neighbours from outside it (on a sphere, from the
    other sides' stacks), and the bytes are the whole-lod run's."""
    att = SPHERE_ATT if spherical else PLANAR_ATT
    monkeypatch.setattr(pre, "_CHUNK_BYTES", 3 * att["texture_size"] ** 2 * 4)
    _hold_device_path(run_port(tmp_path, spherical, device=True, readback=readback),
                      jax_host[spherical], readback)


def _hold_device_path(port, jax, readback):
    """Delta byte-exact with the JAX host path, full within its yardstick."""
    bins, tc = port
    jbins, jtc = jax
    assert bins and list(bins) == list(jbins)
    assert tc == jtc
    if readback == "delta":
        for name in bins:
            assert bins[name] == jbins[name], name
        return
    worst, flipped, total = 0, 0, 0
    for name in bins:
        d = np.frombuffer(bins[name], np.uint16).astype(np.int64)
        h = np.frombuffer(jbins[name], np.uint16).astype(np.int64)
        diff = np.abs(d - h)
        worst = max(worst, int(diff.max()))
        flipped += int((diff != 0).sum())
        total += diff.size
        assert diff.max() <= FULL_MAX_UNITS, name
        assert (diff != 0).mean() < FULL_MAX_SHARE, name
    print(f"full device path vs JAX host: max {worst} unit(s), {flipped} of {total} "
          f"texels differ ({flipped / total:.4%})")


def _planar_preprocessor(tmp_path):
    paths = _write_sources(tmp_path / "src", False, array_to_source)
    config = _config(bt, tmp_path, False)
    pp = bt.Preprocessor(TileAtlas(config, "cpu"), device=True, readback="full")
    dataset = bt.PreprocessDataset(attachment_index=0, path=paths[0],
                                   lod_range=range(0, config.lod_count))
    return pp.clear_attachment(0), dataset


def test_device_stacks_held_at_the_stored_width_and_freed(tmp_path):
    pp, dataset = _planar_preprocessor(tmp_path)
    pp._split_and_downsample(dataset)
    stacks = [st for _, st in pp._dev_stacks.values()]
    assert len(stacks) == 3 and all(st.dtype == torch.int16 for st in stacks)
    tile = PLANAR_ATT["texture_size"] ** 2 * 2
    assert sum(st.nbytes for st in stacks) == (1 + 4 + 16) * tile
    # the plan holds the stacks, the finest lod's stitched copy and the source
    assert pp.planned_device_bytes(dataset, (256, 256, 1)) > (1 + 4 + 16 + 16) * tile \
        + 256 * 256 * 4
    pp._dev_stacks.clear()
    pp.preprocess_tile(dataset).run(verbose=False)
    assert pp._dev_stacks == {}  # every lod freed once stitched


def test_full_read_back_raises_when_its_plan_does_not_fit(tmp_path, monkeypatch):
    pp, dataset = _planar_preprocessor(tmp_path)
    need = pp.planned_device_bytes(dataset, (256, 256, 1))
    monkeypatch.setattr(pre, "_free_device_bytes", lambda device: need - 1)
    with pytest.raises(MemoryError, match="readback='delta'"):
        pp.preprocess_tile(dataset).run(verbose=False)
    monkeypatch.setattr(pre, "_free_device_bytes", lambda device: need)
    pp.preprocess_tile(dataset).run(verbose=False)


def _fake_cuda_atlas(tmp_path):
    """A CPU atlas that reports a CUDA device, so the probe matrix is what is
    under test (as tests/test_preprocess_device.py pretends a TPU backend)."""
    atlas = TileAtlas(_config(bt, tmp_path, False), "cpu")
    atlas.device = torch.device("cuda")
    return atlas


@pytest.mark.parametrize(
    "d2h,dispatch,expect",
    [(True, True, True), (True, False, False), (False, True, False), (False, False, False)],
)
def test_auto_select_requires_both_probes(tmp_path, monkeypatch, d2h, dispatch, expect):
    probed = []
    monkeypatch.setattr(transfer, "d2h_is_fast", lambda dev: probed.append(dev) or d2h)
    monkeypatch.setattr(transfer, "dispatch_is_fast", lambda dev: probed.append(dev) or dispatch)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pp = pre.Preprocessor(_fake_cuda_atlas(tmp_path))
    assert pp.device is expect
    # a CUDA atlas that falls back to the host path says so
    assert len([w for w in caught if "preprocessing on the host" in str(w.message)]) \
        == (0 if expect else 1)
    assert all(dev == torch.device("cuda") for dev in probed) and probed
    if expect:
        assert pp.readback == "full"  # a fast read-back reads whole stacks


def test_auto_select_picks_host_on_a_cpu_atlas(tmp_path, monkeypatch):
    monkeypatch.setattr(transfer, "d2h_is_fast", lambda dev: True)
    monkeypatch.setattr(transfer, "dispatch_is_fast", lambda dev: True)
    pp = pre.Preprocessor(TileAtlas(_config(bt, tmp_path, False), "cpu"))
    assert pp.device is False
    # explicit device=True on a slow read-back link: only the strips come back
    monkeypatch.setattr(transfer, "d2h_is_fast", lambda dev: False)
    pp = pre.Preprocessor(_fake_cuda_atlas(tmp_path / "fake"), device=True)
    assert pp.readback == "delta"


def test_probes_pass_on_a_cpu_device():
    transfer._reset_probe()
    assert transfer.d2h_is_fast("cpu") and transfer.dispatch_is_fast(torch.device("cpu"))
    assert not transfer._D2H_S and not transfer._DISPATCH_S  # nothing was timed


def test_port_interchange_fixture_is_the_tools(tmp_path):
    """The port's copy of the kit's source and settings (chip_smoke.py
    imports nothing of tools/) is tools/rust_interchange.py's."""
    import tools.rust_interchange as kit

    assert INTERCHANGE == dict(
        path=kit.PATH, terrain_size=kit.TERRAIN_SIZE, height=kit.HEIGHT,
        texture_size=kit.TEXTURE_SIZE, border_size=kit.BORDER_SIZE, mip_count=kit.MIP_COUNT,
        lod_count=kit.LOD_COUNT, source_size=kit.SOURCE_N)
    for n in (64, kit.SOURCE_N):
        got = interchange_source(n)
        assert got.dtype == np.uint16 and np.array_equal(got, kit.deterministic_source(n))


def _interchange(tmp_path, **kw):
    kit = INTERCHANGE
    # what load_source_image returns for the kit's 16-bit PNG
    source = interchange_source(kit["source_size"])[..., None].astype(np.float32) / 65535.0
    config = bt.TerrainConfig(
        lod_count=kit["lod_count"],
        model=bt.TerrainModel.planar(np.zeros(3), kit["terrain_size"], 0.0, kit["height"]),
        atlas_size=32, path=kit["path"], assets_root=str(tmp_path / "assets"),
    ).add_attachment(bt.AttachmentConfig(
        name="height", texture_size=kit["texture_size"], border_size=kit["border_size"],
        mip_level_count=kit["mip_count"], format=bt.AttachmentFormat.R16))
    bt.Preprocessor(TileAtlas(config, "cpu"), loader=lambda path, cfg: source,
                    **kw).clear_attachment(0).preprocess_tile(bt.PreprocessDataset(
                        attachment_index=0, path="height.png",
                        lod_range=range(0, kit["lod_count"]))).run(verbose=False)
    root = tmp_path / "assets" / kit["path"]
    got = {"config.tc": (root / "config.tc").read_bytes()}
    for p in sorted((root / "data" / "height").glob("*.bin")):
        got[f"data/height/{p.name}"] = p.read_bytes()
    return got, kit["path"]


@pytest.mark.parametrize("path", ["host", "delta", "full"])
def test_interchange_fixture_reproduces_committed_hashes(tmp_path, path):
    kw = dict(device=False) if path == "host" else dict(device=True, readback=path)
    got, kit_path = _interchange(tmp_path, **kw)
    prefix = f"assets/{kit_path}/"
    expected = Path(__file__).resolve().parent.parent / "tools" / "interchange_expected.json"
    want = {k[len(prefix):]: v for k, v in json.loads(expected.read_text()).items()
            if k.startswith(prefix)}
    assert len(want) == 22 and set(got) == set(want)
    if path != "full":
        for k in want:
            assert hashlib.sha256(got[k]).hexdigest() == want[k], k
        return
    # the full device path is held to its yardstick; it has matched bit for bit
    flipped = 0
    for k in want:
        if hashlib.sha256(got[k]).hexdigest() == want[k]:
            continue
        assert k != "config.tc"
        ref, _ = _interchange(tmp_path / "ref", device=False)
        d = np.abs(np.frombuffer(got[k], np.uint16).astype(np.int64)
                   - np.frombuffer(ref[k], np.uint16).astype(np.int64))
        assert d.max() <= FULL_MAX_UNITS and (d != 0).mean() < FULL_MAX_SHARE, k
        flipped += int((d != 0).sum())
    print(f"interchange, full device path: {flipped} texels off the committed tiles")


VIEW = np.array([100.0, 80.0, -50.0])


def _stream(terrain):
    for _ in range(40):
        out = terrain.update({"cam": VIEW})
        if not terrain.atlas.state.to_load and not any(
            a.loading for a in terrain.atlas.attachments
        ):
            break
        time.sleep(0.01)
    return terrain.update({"cam": VIEW})["cam"]


def _sorted_frame(lod, xy, n, heights, positions, uvs):
    """The live tiles' rows ordered by (lod, x, y), with the sorted keys."""
    key = (np.asarray(lod[:n], np.int64) << 40) | (np.asarray(xy[:n, 0], np.int64) << 20) \
        | np.asarray(xy[:n, 1], np.int64)
    order = np.argsort(key)
    return key[order], heights[:n][order], positions[:n][order], uvs[:n][order]


def test_preprocessed_dataset_streams_through_both_terrains(tmp_path):
    """The port-preprocessed planar dataset through the port's Terrain (CPU)
    against the analytic field, and against the JAX Terrain's frame on the
    JAX-preprocessed copy of the same source."""
    from bevy_terrain_tpu.render.pipeline import Terrain as JTerrain

    paths = _write_sources(tmp_path / "src", False, array_to_source)
    config = _config(bt, tmp_path, False)
    bt.Preprocessor(TileAtlas(config, "cpu")).clear_attachment(0).preprocess_tile(
        bt.PreprocessDataset(attachment_index=0, path=paths[0], lod_range=range(0, 3))
    ).run(verbose=False)
    terrain = bt.Terrain(config, device="cpu")
    terrain.add_view("cam", bt.TerrainViewConfig(tile_capacity=4096), queue_capacity=2048)
    out = _stream(terrain)
    n = out.tile_count
    assert n > 0 and out.overflow == 0
    mask = out.mesh.tile_mask.numpy()
    pos = out.mesh.positions.numpy()[mask]
    assert np.isfinite(pos).all()
    expect = field(pos[..., 0] / 1000.0 + 0.5, pos[..., 2] / 1000.0 + 0.5) * 100.0
    err = np.abs(pos[..., 1] - expect)
    print(f"port Terrain on the port-preprocessed dataset: {n} tiles, median |height - "
          f"field| {np.median(err):.3f} m")
    assert np.median(err) < 2.5, float(np.median(err))

    jroot = tmp_path / "jax"
    jpaths = _write_sources(jroot / "src", False, jarray_to_source)
    jconfig = _config(jbt, jroot, False)
    jbt.Preprocessor(JTileAtlas(jconfig), device=False).clear_attachment(0).preprocess_tile(
        jbt.PreprocessDataset(attachment_index=0, path=jpaths[0], lod_range=range(0, 3))
    ).run(verbose=False)
    jterrain = JTerrain(jconfig)
    jterrain.add_view("cam", jbt.TerrainViewConfig(tile_capacity=4096), queue_capacity=2048)
    jout = _stream(jterrain)
    assert int(jout.tiles.tile_count) == n
    t = out.tiles
    got = _sorted_frame(t.tile_lod.numpy(), t.tile_xy.numpy(), n, out.mesh.heights.numpy(),
                        out.mesh.positions.numpy(), out.mesh.uvs.numpy())
    jt = jout.tiles
    want = _sorted_frame(np.asarray(jt.tile_lod), np.asarray(jt.tile_xy), n,
                         np.asarray(jout.mesh.heights),
                         np.asarray(jout.mesh.positions), np.asarray(jout.mesh.uvs))
    np.testing.assert_array_equal(got[0], want[0])
    gaps = [float(np.abs(g - w).max()) for g, w in zip(got[1:], want[1:])]
    print(f"port vs JAX Terrain frame: max |heights| {gaps[0]:.2e}, |positions| "
          f"{gaps[1]:.2e}, |uvs| {gaps[2]:.2e}")
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=2e-2)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=2e-2)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-6)
