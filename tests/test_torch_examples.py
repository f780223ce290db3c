"""The example twins (examples_torch/) on the CPU.

* ``preprocess_planar`` then ``minimal --frames 3`` in both packages, each
  in its own assets directory (the JAX pair writes and reads its source PNG
  through PIL; the port's hands the same quantized source over in memory):
  every ``.bin`` and ``config.tc`` byte-identical (the host path on both
  sides: a CPU atlas in the port, the CPU backend in JAX), the same tile
  count every frame (tile loads made to finish in the frame that asks for
  them, in both packages), and the host ``sample_height`` and the
  ``query_heights`` within 2e-2 m (the fused-vs-staged yardstick,
  tests/test_fused_mesh.py:95-97: the JAX ``Terrain`` takes the staged mesh
  on the CPU, the port the fused one).
* ``planar``, ``preprocess_spherical`` + ``spherical`` and
  ``render_capture`` on the port alone, at their smallest flags or with
  module constants cut down, finish with finite, in-range results; the
  preprocess twins report the host path on a CPU atlas.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest

import examples.minimal as jminimal
import examples.preprocess_planar as jpreprocess_planar
from examples_torch import (
    minimal, planar, preprocess_planar, preprocess_spherical, render_capture, spherical,
)
from bevy_terrain_tpu_torch.utils.loading import loads_in_step
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)

# the fused-vs-staged height yardstick (tests/test_fused_mesh.py:95-97)
TOL_HEIGHT = 2e-2


def _dataset(root: Path) -> dict:
    data = root / "terrains" / "planar"
    out = {p.name: p.read_bytes() for p in sorted((data / "data" / "height").glob("*.bin"))}
    out["config.tc"] = (data / "config.tc").read_bytes()
    return out


def _record(monkeypatch, cls, name, sink):
    """Wrap ``cls.name`` to append what it returns to ``sink``."""
    original = getattr(cls, name)

    def wrapper(*a, **k):
        out = original(*a, **k)
        sink.append(out)
        return out

    monkeypatch.setattr(cls, name, wrapper)


@pytest.fixture
def jax_and_port_loads_in_step():
    """Each tile load finishes before ``start_loading`` returns, in both
    packages, so a frame sees the same resident tiles in both whatever
    their frame times (the approximate height under the camera, and with
    it the tile count, follows the resident tiles)."""
    from bevy_terrain_tpu.terrain_data.tile_atlas import AtlasAttachment as JAtlasAttachment
    from bevy_terrain_tpu_torch.terrain_data.tile_atlas import AtlasAttachment

    with loads_in_step(JAtlasAttachment, AtlasAttachment):
        yield


def test_preprocess_planar_and_minimal_match_jax(tmp_path, monkeypatch, capsys,
                                                 jax_and_port_loads_in_step):
    import bevy_terrain_tpu as jbt

    jroot, root = tmp_path / "jax", tmp_path / "port"
    frames, jheights = [], []
    _record(monkeypatch, jbt.Terrain, "update", frames)
    _record(monkeypatch, jbt.Terrain, "query_heights", jheights)
    jsampled = []
    monkeypatch.setattr(jminimal, "sample_height", functools.partial(
        lambda f, *a: jsampled.append(f(*a)) or jsampled[-1], jminimal.sample_height))
    monkeypatch.setattr(sys, "argv", ["preprocess_planar.py", "--assets", str(jroot)])
    jpreprocess_planar.main()
    monkeypatch.setattr(sys, "argv", ["minimal.py", "--assets", str(jroot), "--frames", "3"])
    jminimal.main()
    jtiles = [int(out["camera"].tile_count) for out in frames]

    pre = preprocess_planar.main(["--assets", str(root), "--device", "cpu"])
    got = minimal.main(["--assets", str(root), "--frames", "3", "--device", "cpu"])
    print(capsys.readouterr().out)
    assert pre["tiles"] == 1 + 4 + 16 + 64 and pre["device_path"] is False

    want = _dataset(jroot)
    have = _dataset(root)
    assert list(have) == list(want) and len(want) == 85 + 1
    for name in want:
        assert have[name] == want[name], name
    assert got["tiles"] == jtiles and len(jtiles) == 3 and min(jtiles) > 0
    dh = abs(got["sample_height"] - jsampled[0])
    dq = float(np.abs(got["query_heights"] - np.asarray(jheights[0])).max())
    print(f"sample_height {got['sample_height']:.4f} m (JAX {jsampled[0]:.4f}); "
          f"query_heights {got['query_heights']} (JAX {np.asarray(jheights[0])}): "
          f"|port - JAX| {dh:.2e} / {dq:.2e} m")
    assert dh <= TOL_HEIGHT and dq <= TOL_HEIGHT
    assert 0.0 <= got["sample_height"] <= 250.0


@pytest.fixture
def port_loads_in_step():
    from bevy_terrain_tpu_torch.terrain_data.tile_atlas import AtlasAttachment

    with loads_in_step(AtlasAttachment):
        yield


def test_planar_example_on_the_cpu(tmp_path, port_loads_in_step):
    got = planar.main(["--assets", str(tmp_path), "--device", "cpu"])
    assert got["tiles"] > 0
    assert np.all((got["lit_mean"] > 0.0) & (got["lit_mean"] < 1.0))
    # the staged sampler against the analytic colormap (8-bit, bilinear)
    assert got["albedo_median_err"] < 0.02


def test_spherical_examples_on_the_cpu(tmp_path, monkeypatch, port_loads_in_step):
    for module in (spherical, preprocess_spherical):
        monkeypatch.setattr(module, "LOD_COUNT", 2)
        monkeypatch.setattr(module, "synthesize_faces",
                            functools.partial(spherical.synthesize_faces, n=256))
    pre = preprocess_spherical.main(["--assets", str(tmp_path), "--device", "cpu"])
    assert pre["tiles"] == 6 * (1 + 4) and pre["device_path"] is False
    got = spherical.main(["--assets", str(tmp_path), "--frames", "1", "--device", "cpu"])
    assert len(got["tiles"]) == 1 and min(got["tiles"]) > 0
    hs = got["query_heights"]
    assert hs.shape == (8,) and np.isfinite(hs).all()
    assert np.all((hs >= 0.0) & (hs <= 9000.0))


def test_render_capture_on_the_cpu(tmp_path, port_loads_in_step):
    got = render_capture.main(["--assets", str(tmp_path / "assets"), "--out",
                               str(tmp_path / "captures"), "--size", "64", "--device", "cpu"])
    assert got["tiles"] > 0 and 0.0 < got["coverage"] <= 1.0
    assert [p.stem for p in got["images"]] == ["terrain_pbr", "terrain_geometry_lod",
                                               "terrain_uv"]
    assert all(p.exists() for p in got["images"])


@pytest.mark.parametrize("module", [preprocess_planar, minimal, planar, preprocess_spherical,
                                    spherical, render_capture], ids=lambda m: m.__name__)
def test_example_twins_run_on_the_card_by_default(tmp_path, module):
    """No fallback: each example's default device is the card, and it
    raises without one (before it makes a source)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this process has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        module.main(["--assets", str(tmp_path / "assets")]
                    + (["--out", str(tmp_path / "out")] if module is render_capture else []))
    assert not (tmp_path / "assets" / "source").exists()
