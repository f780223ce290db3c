"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: ``bevy_terrain_tpu_torch`` begins with
``bevy_terrain_tpu``); the reference imports nothing of the program; no
file of the benchmark reads ``bench.py`` or the JAX package's files."""

import ast
import subprocess
import sys

from harness import manifest

HOME = manifest.HOME
FORBIDDEN = {"jax", "jaxlib", "flax", "bevy_terrain_tpu"}


def run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(HOME.parent))
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_harness_loops_and_readers_import_no_jax():
    code = f"""
import importlib.util, sys
sys.path.insert(0, {str(HOME)!r}); sys.path.insert(1, {str(HOME.parent)!r})
from pathlib import Path
home = Path({str(HOME)!r})
files = [home / 'run.py'] + sorted((home / 'loops').glob('*.py')) + sorted(
    (home / 'metrics').glob('*.py')) + sorted((home / 'cameras').glob('*.py')) + sorted(
    (home / 'harness').glob('*.py')) + sorted((home / 'tools').glob('*.py'))
for i, f in enumerate(files):
    spec = importlib.util.spec_from_file_location(f'tb_check_{{i}}', f)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
from harness import scene
scene.package()
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""
    tops = set(eval(run(code)))
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    assert "bevy_terrain_tpu_torch" in tops  # the program is what is measured


def test_reference_imports_nothing_of_the_program():
    code = f"""
import pkgutil, importlib, sys
sys.path.insert(0, {str(HOME)!r})
import reference
for m in pkgutil.walk_packages(reference.__path__, 'reference.'):
    importlib.import_module(m.name)
import harness.check, harness.dataset
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""
    tops = set(eval(run(code)))
    assert "bevy_terrain_tpu_torch" not in tops and not tops & FORBIDDEN


def _strings(node):
    """The string constants a call or a path join uses."""
    if isinstance(node, ast.Call):
        return [a.value for a in list(node.args) + [k.value for k in node.keywords]
                if isinstance(a, ast.Constant) and isinstance(a.value, str)]
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
        return [a.value for a in (node.left, node.right)
                if isinstance(a, ast.Constant) and isinstance(a.value, str)]
    return []


def test_no_file_reads_bench_py_or_the_jax_package():
    bench_py, jax_dir = "bench" + ".py", "bevy_terrain_tpu" + "/"
    for path in sorted(HOME.rglob("*.py")):
        if "_cache" in path.parts:
            continue
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]}
            else:
                tops = set()
            assert not tops & FORBIDDEN, (path, tops)
            for text in _strings(node):
                assert bench_py not in text and jax_dir not in text and text != (
                    "bevy_terrain_tpu"), (path, text)
