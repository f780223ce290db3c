"""The torch package and chip_smoke.py stay free of jax and of the JAX
package.

The card's machine has no jax, and importing any module of
``bevy_terrain_tpu`` runs that package's ``__init__``, which imports jax.
So every module of ``bevy_terrain_tpu_torch`` must import in a process
where ``import jax`` fails, without loading a module of the JAX package or
PIL (the source loader imports PIL when it is called); and no source file
of the port, nor chip_smoke.py, may name jax, the JAX package or the
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
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
        loaded = sorted(m for m in sys.modules
                        if m == "bevy_terrain_tpu" or m.startswith("bevy_terrain_tpu."))
        assert not loaded, loaded
        assert "PIL" not in sys.modules, "PIL imported at module level"
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    # every source file of the package but its __init__ was imported
    assert int(out.stdout.split()[-1]) == len(SOURCES) - 2


@pytest.mark.parametrize("what", ["port", "chip_smoke"])
def test_no_source_imports_jax_or_the_jax_package(what):
    files = SOURCES[:-1] if what == "port" else SOURCES[-1:]
    assert files and all(f.exists() for f in files)
    names = {f.relative_to(PORT).as_posix() for f in files if PORT in f.parents}
    if what == "port":
        for module in ("formats/tiff.py", "utils/transfer.py", "ops/preprocess.py",
                       "ops/preprocess_device.py", "preprocess/preprocessor.py",
                       "preprocess/__init__.py"):
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
                     "    import toolsmith, tools\n")
    assert _bad_imports(probe) == [(2, "jax.numpy"), (5, "bevy_terrain_tpu.ops"),
                                   (8, "tools.rust_interchange"), (9, "tools")]
