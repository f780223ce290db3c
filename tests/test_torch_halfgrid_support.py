"""The supports K7 (``kernels.fetch_resample``) forms its weights over.

The CUDA kernel forms each crossfaded weight row only over its support
``[lo, hi]`` (packed, at most ``HALFGRID_MAX_SUPPORT`` floats an axis) and
its rows pass only over the columns ``[c0, c1]`` that the x supports reach.
That gives the dense product's result only if every weight outside the
support is zero. ``kernels.fetch_resample_support`` mirrors the kernel's
supports; these tests hold the plain version's weight rows
(``kernels.fetch_resample_weights``) to it, on random geometry and on the
edges: positions clipped at 0 and 63, dp = 0, ratio 0 and 1, a decreasing
step, steps wider than a texel. Plain PyTorch on the CPU, no JAX.
"""

import numpy as np
import pytest
import torch

from bevy_terrain_tpu_torch.ops import kernels

F = 256  # tiles per case


def _geom(case: str) -> torch.Tensor:
    """(F, 8) f32 [p0x, p0y, dp, valid, ratio, 0, 0, 0]: the sweep tool's
    ranges (p0 in [0, 30], dp in [0.5, 1], ratio in [0, 1]) or one edge."""
    rng = np.random.default_rng(["random", "clip_low", "clip_high", "dp0", "ratio0",
                                 "ratio1", "decreasing", "wide", "last_texel"].index(case))
    g = np.zeros((F, 8), np.float32)
    g[:, 0:2] = rng.uniform(0.0, 30.0, (F, 2))
    g[:, 2] = rng.uniform(0.5, 1.0, F)
    g[:, 3] = 1.0
    g[:, 4] = rng.uniform(0.0, 1.0, F)
    if case == "clip_low":  # p0 < 0: the first rows clip at texel 0
        g[:, 0:2] = rng.uniform(-20.0, -0.01, (F, 2))
    elif case == "clip_high":  # p0 + 32 dp > 63: the last rows clip at 63
        g[:, 0:2] = rng.uniform(40.0, 70.0, (F, 2))
    elif case == "dp0":
        g[:, 2] = 0.0
    elif case == "ratio0":
        g[:, 4] = 0.0
    elif case == "ratio1":
        g[:, 4] = 1.0
    elif case == "decreasing":
        g[:, 0:2] = rng.uniform(33.0, 63.0, (F, 2))
        g[:, 2] = -rng.uniform(0.5, 1.0, F)
    elif case == "wide":  # supports of many texels, and steps past the patch
        g[:, 0:2] = rng.uniform(-10.0, 10.0, (F, 2))
        g[:, 2] = rng.uniform(1.0, 40.0, F)
    elif case == "last_texel":  # integer positions at the patch's ends
        g[:, 0:2] = rng.choice([0.0, 31.0, 63.0], (F, 2))
        g[:, 2] = rng.choice([0.0, 0.5, 1.0], F)
    return torch.from_numpy(g)


CASES = ["random", "clip_low", "clip_high", "dp0", "ratio0", "ratio1", "decreasing", "wide",
         "last_texel"]


@pytest.mark.parametrize("case", CASES)
def test_weights_vanish_outside_the_support(case):
    """Every non-zero weight of each row, the boundary rows 0 and 32
    included, lies inside its support; outside it the weight is +0."""
    geom = _geom(case)
    lo, hi, _ = kernels.fetch_resample_support(geom)
    r = torch.arange(kernels.P).view(1, 1, kernels.P)
    for axis, w in enumerate(kernels.fetch_resample_weights(geom)):
        inside = (r >= lo[:, axis, :, None]) & (r <= hi[:, axis, :, None])
        outside = w[~inside]
        assert torch.equal(outside, torch.zeros_like(outside)), (case, axis)
        assert not bool(torch.signbit(outside).any()), (case, axis)
        # each row keeps its weight: a tent row sums to one, and so its blend
        assert float((w.sum(-1) - 1.0).abs().max()) <= 1e-5, (case, axis)
    assert bool((lo >= 0).all() and (hi <= kernels.P - 1).all() and (lo <= hi).all())


@pytest.mark.parametrize("case", CASES)
def test_rows_pass_columns_cover_every_x_support(case):
    """The rows pass's columns [c0, c1] hold every x row's support, so the
    contraction over x never reads a column the rows pass left out."""
    geom = _geom(case)
    lo, hi, cols = kernels.fetch_resample_support(geom)
    assert bool((cols[:, 0:1] <= lo[:, 0]).all()), case
    assert bool((cols[:, 1:2] >= hi[:, 0]).all()), case
    # and no wider than the supports themselves
    assert torch.equal(cols[:, 0], lo[:, 0].min(dim=1).values)
    assert torch.equal(cols[:, 1], hi[:, 0].max(dim=1).values)


@pytest.mark.parametrize("case", CASES)
def test_packed_supports_fit_the_kernel_buffer(case):
    """The supports of one axis' 33 rows fit the kernel's packed weight
    buffer: at most 2 (floor(p_32) - floor(p_0)) + 2 K texels."""
    geom = _geom(case)
    lo, hi, _ = kernels.fetch_resample_support(geom)
    total = (hi - lo + 1).sum(dim=2)
    assert int(total.max()) <= kernels.HALFGRID_MAX_SUPPORT, case
    # the boundary rows span their own centre and one neighbour's
    k = torch.tensor([0.0, 1.0, 31.0, 32.0])
    for axis in range(2):
        p = (geom[:, axis:axis + 1] + k * geom[:, 2:3]).clamp(0.0, kernels.P - 1.0)
        want_lo = torch.stack([torch.minimum(p[:, 0], p[:, 1]),
                               torch.minimum(p[:, 2], p[:, 3])], dim=1).floor().long()
        assert torch.equal(lo[:, axis, [0, kernels.K - 1]], want_lo), (case, axis)
