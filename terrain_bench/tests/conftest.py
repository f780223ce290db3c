"""The benchmark's own tests: ``python -m pytest terrain_bench/tests -q``.

Tests marked ``cuda`` need an NVIDIA card and skip without one, deciding
inside the test."""

import sys
from pathlib import Path

HOME = Path(__file__).resolve().parents[1]
for p in (str(HOME), str(HOME.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA CUDA card; skips without one")
