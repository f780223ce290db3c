"""The comparison that decides ``correct``, at a shrunk size on the CPU: the
program's run against the frozen reference is correct; the control (the
reference in bfloat16 in the program's place) and a run with the timed path
broken underneath are not."""

import pytest
import torch

import tiny
from harness import check, manifest

loop = manifest.module("loops", "capture")
LIMITS = {"planar": tiny.planar, "planet": tiny.planet}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["planar", "planet"])
def test_program_matches_reference_and_control_fails(cell, tmp_path):
    cfg, tr = LIMITS[cell]()
    res = loop.run(tiny.ctx(cfg, tr, tmp_path, seconds=12.0, control=True))
    assert res["correct"], res["checks"]
    # the shrunk image bins too many triangles into too few bins, so its
    # frames count as failed; the comparison does not depend on that
    assert 0 <= res["failed"] <= res["attempted"] and res["attempted"] >= tr["check"]["frames"]
    assert not check.verdict(res["control"], tr["check"]["limits"]), res["control"]


def _stale(update):
    """A step that returns its state unchanged: every frame after the first
    hands over the first frame's output."""
    first = []

    def wrapped(self, *a, **k):
        out = update(self, *a, **k)
        if not first:
            first.append(out)
        return first[0]
    return wrapped


def _half(update):
    """Half of the batch left out: the second half of each frame's tile list
    dropped (its count halved, its mesh rows masked)."""
    def wrapped(self, *a, **k):
        outs = update(self, *a, **k)
        for out in outs.values():
            half = int(out.tiles.tile_count) // 2
            out.tiles.tile_count = torch.tensor(half, dtype=torch.int32)
            mask = out.mesh.tile_mask.clone()
            mask[half:] = False
            out.mesh.tile_mask = mask
        return outs
    return wrapped


def _altered(update):
    """An answer altered where it is produced: one tile's heights and
    positions raised by a metre."""
    def wrapped(self, *a, **k):
        outs = update(self, *a, **k)
        for out in outs.values():
            mesh = out.mesh
            mesh.heights = mesh.heights.clone()
            mesh.heights[0] += 1.0
            mesh.positions = mesh.positions.clone()
            mesh.positions[0, ..., 1] += 1.0
        return outs
    return wrapped


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
def test_broken_timed_path_is_not_correct(fault, tmp_path, monkeypatch):
    from bevy_terrain_tpu_torch import Terrain

    cfg, tr = tiny.planar()
    monkeypatch.setattr(Terrain, "update", fault(Terrain.update))
    res = loop.run(tiny.ctx(cfg, tr, tmp_path))
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
def test_readings_on_the_card(tmp_path):
    """One seed of the planar cell at its own size on the card, with the
    control: the program correct, the control not."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    cfg = manifest.load_json(manifest.HOME / "configs" / "planar_8k_lit.json")
    tr = manifest.load_json(manifest.HOME / "traffic" / "aerial_1080p.json")
    ctx = tiny.ctx(cfg, tr, tmp_path, seconds=8.0, control=True)
    ctx.device, ctx.program_overrides = "cuda:0", {}
    res = loop.run(ctx)
    assert res["correct"], res["checks"]
    assert not check.verdict(res["control"], tr["check"]["limits"])
