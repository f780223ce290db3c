"""The seeded inputs: camera paths and datasets are the same for a seed and
differ between seeds; every seed's path has the same geometry."""

import numpy as np
import pytest
import torch

import tiny
from harness import dataset, manifest
from types import SimpleNamespace

loop = manifest.module("loops", "capture")


def cams(cfg, tr, seed):
    return loop.cameras(SimpleNamespace(config=cfg, traffic=tr, seed=seed))


@pytest.mark.parametrize("cell", ["planar", "planet"])
def test_paths_are_seeded(cell):
    cfg = manifest.load_json(manifest.HOME / "configs" / (
        "planar_8k_lit.json" if cell == "planar" else "earth_lit.json"))
    tr = manifest.load_json(manifest.HOME / "traffic" / (
        "aerial_1080p.json" if cell == "planar" else "descent_1024.json"))
    a, b = cams(cfg, tr, 2**31 + 11), cams(cfg, tr, 2**31 + 11)
    assert len(a) == tr["path"]["positions"]
    for (ea, va), (eb, vb) in zip(a, b):
        assert np.array_equal(ea, eb) and np.array_equal(va, vb)
    # some other seed flies another image of the same path
    others = [cams(cfg, tr, s) for s in range(1, 9)]
    assert any(not np.allclose(o[0][0], a[0][0]) for o in others)
    heights = lambda c: [float(np.linalg.norm(e)) if cell == "planet" else float(e[1]) for e, _ in c]
    for o in others:
        assert np.allclose(heights(o), heights(a))


def test_visit_order_covers_the_path():
    order = loop.visit_order(48, 29, 5)
    assert sorted(order) == list(range(48))
    assert order == loop.visit_order(48, 29, 5)
    with pytest.raises(ValueError):
        loop.visit_order(48, 6, 5)


@pytest.mark.parametrize("make", [tiny.planar, tiny.planet])
def test_dataset_is_seeded(make, tmp_path):
    cfg, _ = make()
    one, _ = dataset.ensure(cfg, 123, tmp_path / "a", "cpu")
    two, _ = dataset.ensure(cfg, 123, tmp_path / "b", "cpu")
    three, _ = dataset.ensure(cfg, 124, tmp_path / "c", "cpu")
    files = sorted(p.relative_to(one) for p in one.rglob("*.bin"))
    assert len(files) == 2 * len(dataset.all_tiles(cfg))
    assert all((one / f).read_bytes() == (two / f).read_bytes() for f in files)
    assert any((one / f).read_bytes() != (three / f).read_bytes() for f in files)
    assert (one / cfg["name"] / "config.tc").read_bytes() == (
        two / cfg["name"] / "config.tc").read_bytes()
    # the cache keeps one seed: the same seed is not written again
    again, written = dataset.ensure(cfg, 123, tmp_path / "a", "cpu")
    assert written == 0 and again == one


def test_fields_stay_in_range():
    cfg, _ = tiny.planar()
    coords = dataset.all_tiles(cfg)
    params = dataset.params_of(cfg, 9)
    for att in cfg["attachments"]:
        v = dataset.tile_fields(cfg, att, coords, params, torch.device("cpu"))
        assert float(v.min()) >= 0.0 and float(v.max()) <= 1.0
        t = dataset.payload(v, att["format"])
        assert t[..., 0].min() >= 1
