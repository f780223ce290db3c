"""The port's jax-free copies of the JAX package's host modules stay copies.

The port cannot import any module of the JAX package (its ``__init__``
imports jax), so it carries copies of the host modules it needs. Each copy
is read beside its original with the package name rewritten, and the lines
that differ (a minimal line diff: lines only in one file, counted in both)
must stay within the copy's allowance: the differences it had when the
allowance was set (ROADMAP Queue 1 item 4). A change to either side that
passes the allowance fails here, so the copies are brought back in step
or the allowance is raised on purpose.
"""

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

# copy (relative to both packages) -> differing lines allowed
ALLOWANCE = {
    "config.py": 0,
    "formats/tc.py": 0,
    "terrain_data/attachment.py": 0,
    "models/__init__.py": 0,
    "math/ellipsoid.py": 2,
    "math/frustum.py": 2,
    "math/terrain_model.py": 2,
    "terrain_data/sampling_api.py": 2,
    "formats/tiff.py": 11,
    "debug/__init__.py": 15,
    "math/coordinate.py": 18,
    "terrain_data/tile_tree.py": 97,  # the native branches dropped
    "math/approximation.py": 115,  # the Taylor coefficients in the native op order
    "ops/preprocess.py": 142,  # the native branches dropped, torch resizes
    "utils/synthetic.py": 161,  # the spherical, colour and interchange fixtures
}


def differing_lines(a: list[str], b: list[str]) -> int:
    """Lines of ``a`` and ``b`` outside their longest common subsequence."""
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b):
            cur.append(prev[j] + 1 if x == y else max(prev[j + 1], cur[j]))
        prev = cur
    return len(a) + len(b) - 2 * prev[-1]


def test_differing_lines_counts_a_minimal_diff():
    assert differing_lines([], []) == 0
    assert differing_lines(list("abc"), list("abc")) == 0
    assert differing_lines(list("abc"), list("axc")) == 2
    assert differing_lines(list("abcd"), list("bcde")) == 2
    assert differing_lines(list("abc"), []) == 3


@pytest.mark.parametrize("module", sorted(ALLOWANCE))
def test_copy_within_its_allowance(module):
    original = (ROOT / "bevy_terrain_tpu" / module).read_text()
    copy = (ROOT / "bevy_terrain_tpu_torch" / module).read_text()
    rewritten = original.replace("bevy_terrain_tpu", "bevy_terrain_tpu_torch")
    n = differing_lines(rewritten.splitlines(), copy.splitlines())
    print(f"{module}: {n} differing lines (allowance {ALLOWANCE[module]})")
    assert n <= ALLOWANCE[module], (
        f"bevy_terrain_tpu_torch/{module} differs from its original in {n} lines, "
        f"more than its allowance of {ALLOWANCE[module]}")
