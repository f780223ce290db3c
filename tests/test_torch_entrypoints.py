"""The port's entry point and timing helpers on the CPU.

* ``bevy_terrain_tpu_torch.entry.entry(device="cpu")`` against the repo's
  ``__graft_entry__.entry()`` jitted on the CPU (as
  tests/test_entrypoints.py runs it): the same Earth-scale sphere at 2 km
  through refinement and the per-vertex mesh. The tile count is exact;
  heights and positions are held to the yardsticks the port's spherical
  tests use near the surface (tests/test_torch_spherical_mesh.py::JAX_TOL,
  "sphere_near": heights 0.2 m, positions 6.0 m).
* ``utils/timing``: ``benchmark`` and ``Timer`` on a CPU callable; every
  helper that times the card raises in a process without one.
"""

import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from bevy_terrain_tpu_torch.entry import entry
from bevy_terrain_tpu_torch.utils import timing
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_spherical_mesh import JAX_TOL

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def test_entry_matches_the_jax_entry():
    import __graft_entry__ as g

    jfn, jargs = g.entry()
    jpos, jheights, jcount = (np.asarray(x) for x in jax.jit(jfn)(*jargs))
    fn, args = entry(device="cpu")
    assert args[0].device.type == "cpu" and args[1].view_world_position.device.type == "cpu"
    positions, heights, count = fn(*args)
    assert int(count) == int(jcount) > 0
    assert positions.shape == jpos.shape and heights.shape == jheights.shape
    assert positions.shape[-1] == 3 and heights.shape == positions.shape[:2]
    assert bool(torch.isfinite(positions).all())
    h_tol, p_tol, _ = JAX_TOL["sphere_near"]
    n = int(count)
    dh = np.abs(heights.numpy()[:n] - jheights[:n]).max()
    dp = np.abs(positions.numpy()[:n] - jpos[:n]).max()
    print(f"entry vs JAX entry: {n} tiles, heights {dh:.3e} m, positions {dp:.3e} m")
    assert dh <= h_tol and dp <= p_tol


def test_entry_runs_on_the_card_by_default():
    """No fallback: without a card the default entry raises."""
    if torch.cuda.is_available():
        pytest.skip("this process has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        entry()


def test_benchmark_and_timer_on_a_cpu_callable():
    calls = []

    def work(x):
        calls.append(x)
        time.sleep(0.002)

    stats = timing.benchmark(work, 7, n=4, warmup=1)
    assert calls == [7] * 5
    assert set(stats) == {"min_ms", "median_ms", "mean_ms"}
    assert 2.0 <= stats["min_ms"] <= stats["median_ms"] and stats["mean_ms"] >= 2.0
    t = timing.Timer()
    for _ in range(3):
        with t.measure("a"):
            time.sleep(0.001)
    with t.measure("b"):
        pass
    summary = t.summary()
    assert set(summary) == {"a", "b"} and len(t.sections["a"]) == 3
    assert summary["a"] >= 1.0 and summary["b"] < summary["a"]


@pytest.mark.parametrize("helper", ["device_time_ms", "cuda_ms", "device_ms", "cold_ms"])
def test_device_timing_raises_without_a_card(helper):
    if torch.cuda.is_available():
        pytest.skip("this process has a card")
    ran = []
    with pytest.raises(RuntimeError, match="CUDA card"):
        getattr(timing, helper)(lambda: ran.append(1))
    assert not ran  # nothing was timed on the host instead


def test_device_time_reads_each_call_between_markers():
    """Each call's device records are summed between its marker and the
    next; records before the first marker (a late arrival from an earlier
    trace) and after the last call's closing marker are not counted; the
    calls must hold as many records each."""
    records = [(-50.0, 7.0, False),  # an earlier trace's record
               (0.0, 2.0, True), (3.0, 10.0, False), (15.0, 1.0, False),
               (20.0, 2.0, True), (23.0, 12.0, False), (30.0, 1.0, False),
               (40.0, 2.0, True), (43.0, 11.0, False), (50.0, 0.5, False),
               (60.0, 2.0, True), (70.0, 2.0, True), (75.0, 9.0, False)]
    assert timing._per_call_us(records, 3, "t") == [11.0, 13.0, 11.5]
    with pytest.raises(RuntimeError, match="3 of the 4 markers"):
        timing._per_call_us(records[:-3], 3, "t")
    with pytest.raises(RuntimeError, match=r"\[0, 1\] device records"):
        timing._per_call_us([(0.0, 1.0, True), (5.0, 1.0, True), (6.0, 3.0, False),
                             (9.0, 1.0, True)], 2, "t")
    # a call short of a record (lost mid-trace) is not read as a faster call
    with pytest.raises(RuntimeError, match=r"\[2, 1\] device records"):
        timing._per_call_us([(0.0, 1.0, True), (1.0, 3.0, False), (2.0, 3.0, False),
                             (5.0, 1.0, True), (6.0, 3.0, False), (9.0, 1.0, True)], 2, "t")
