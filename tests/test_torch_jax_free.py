"""The torch package, its examples and tools and chip_smoke.py stay free of
jax and of the JAX package.

The card's machine has no jax, and importing any module of
``bevy_terrain_tpu`` runs that package's ``__init__``, which imports jax.
So every module of ``bevy_terrain_tpu_torch``, ``examples_torch/`` and
``tools_torch/`` must import in a process where ``import jax`` fails,
without loading a module of the JAX package or PIL (the source loader
imports PIL when it is called) and without building the native runtime
(it builds at first use); and no source file of the port, of its
examples and tools, nor chip_smoke.py, may name jax, the JAX package or the
repo's ``tools/`` (the JAX package's tooling, whose modules import it) in
an import statement, at any depth.
"""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "bevy_terrain_tpu_torch"
TWINS = [ROOT / "examples_torch", ROOT / "tools_torch"]
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
# the module that the spawned ranks of tests/test_torch_multi_card.py import
RANK_HELPERS = [ROOT / "tests" / "torch_multi_card_cases.py"]
TWIN_SOURCES = sorted(f for d in TWINS for f in d.glob("*.py"))


def _forbidden(name: str) -> bool:
    return any(name == top or name.startswith(top + ".")
               for top in ("jax", "bevy_terrain_tpu", "tools"))


def _bad_imports(path: Path) -> list[tuple[int, str]]:
    """(line, module) of every import of jax, the JAX package or tools/ in
    ``path``."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        bad += [(node.lineno, n) for n in names if _forbidden(n)]
    return bad


def test_every_port_module_imports_without_jax():
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None  # any import of jax raises ImportError
        sys.path.insert(0, {str(ROOT)!r})
        import bevy_terrain_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        twins = [d + "." + m.name for d in ("examples_torch", "tools_torch")
                 for m in pkgutil.iter_modules([{str(ROOT)!r} + "/" + d])]
        for name in twins:
            importlib.import_module(name)
        loaded = sorted(m for m in sys.modules
                        if m == "bevy_terrain_tpu" or m.startswith("bevy_terrain_tpu."))
        assert not loaded, loaded
        assert "PIL" not in sys.modules, "PIL imported at module level"
        from bevy_terrain_tpu_torch import native
        assert native._lib is None, "the native runtime was built at import"
        print(len(names), len(twins))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    # every source file of the package but its __init__ was imported, and
    # every module of the example and tool twins
    n_port, n_twins = map(int, out.stdout.split()[-2:])
    assert n_port == len(SOURCES) - 2
    assert n_twins == len(TWIN_SOURCES) - len(TWINS) and n_twins >= 6 + 1 + 6 + 5 + 6


@pytest.mark.parametrize("what", ["port", "chip_smoke", "twins", "rank_helpers"])
def test_no_source_imports_jax_or_the_jax_package(what):
    files = {"port": SOURCES[:-1], "chip_smoke": SOURCES[-1:], "twins": TWIN_SOURCES,
             "rank_helpers": RANK_HELPERS}[what]
    assert files and all(f.exists() for f in files)
    names = {f.relative_to(ROOT).as_posix() for f in files}
    expected = {
        "port": [f"bevy_terrain_tpu_torch/{m}" for m in (
            "formats/tiff.py", "utils/transfer.py", "ops/preprocess.py",
            "ops/preprocess_device.py", "preprocess/preprocessor.py", "preprocess/__init__.py",
            "models/__init__.py", "utils/timing.py", "entry.py", "parallel/__init__.py",
            "parallel/multi_view.py", "parallel/sharded_atlas.py", "parallel/launch.py",
            "parallel/collective_audit.py", "native/__init__.py", "ops/tile_tree.py")],
        "chip_smoke": ["chip_smoke.py"],
        "rank_helpers": ["tests/torch_multi_card_cases.py"],
        "twins": [f"examples_torch/{m}.py" for m in (
            "preprocess_planar", "minimal", "planar", "spherical", "preprocess_spherical",
            "render_capture")] + [f"tools_torch/{m}.py" for m in (
                "scenes", "refine_bench", "earth_frame_bench", "flythrough_bench",
                "material_frame_bench", "raster_bench", "multi_view_bench",
                "fetch_kernel_sweep", "census_frame", "earth_census",
                "preprocess_compute_bench", "earth_kernel_ablation",
                "material_kernel_ablation", "raster_ablation", "morph_gating_analysis",
                "rust_interchange", "make_goldens")],
    }[what]
    for module in expected:
        assert module in names
    bad = [f"{f.relative_to(ROOT)}:{line} {name}" for f in files
           for line, name in _bad_imports(f)]
    assert not bad, bad


def test_the_scan_finds_what_it_forbids(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import os\nimport jax.numpy as jnp\n\ndef f():\n"
                     "    from bevy_terrain_tpu.ops import kernels\n"
                     "    from bevy_terrain_tpu_torch.ops import kernels as k\n"
                     "    from . import sibling\n"
                     "    from tools.rust_interchange import EXPECTED\n"
                     "    import toolsmith, tools\n"
                     "    from tools_torch.scenes import build_scene\n"
                     "    import tools_torch, tools.multi_view_bench\n"
                     "    from tools import multi_view_bench\n")
    assert _bad_imports(probe) == [(2, "jax.numpy"), (5, "bevy_terrain_tpu.ops"),
                                   (8, "tools.rust_interchange"), (9, "tools"),
                                   (11, "tools.multi_view_bench"), (12, "tools")]
    for name in ("tools", "tools.x", "tools.multi_view_bench"):
        assert _forbidden(name), name
    for name in ("tools_torch", "tools_torch.scenes", "toolsmith", "examples_torch.minimal",
                 "bevy_terrain_tpu_torch", "bevy_terrain_tpu_torch.entry"):
        assert not _forbidden(name), name
