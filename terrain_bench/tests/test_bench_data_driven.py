"""A later benchmark PR adds a configuration, a traffic mix and a per-layer
metric as new files and new entries: the harness finds them by name, and
no file the benchmark already has changes."""

import hashlib
import json
import shutil
import subprocess
import sys

from harness import manifest

ROOT = manifest.HOME.parent


def digests(home):
    return {p.relative_to(home): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(home.rglob("*")) if p.is_file() and "_cache" not in p.parts
            and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    home = tmp_path / "terrain_bench"
    shutil.copytree(manifest.HOME, home, ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = digests(home)

    cfg = json.loads((home / "configs" / "planar_8k_lit.json").read_text())
    cfg.update(name="planar_16k_lit", lod_count=6, data_lod_count=6)
    cfg["model"]["side_m"] = 16000.0
    (home / "configs" / "planar_16k_lit.json").write_text(json.dumps(cfg))
    tr = json.loads((home / "traffic" / "aerial_1080p.json").read_text())
    tr["size"] = [3840, 2160]
    (home / "traffic" / "aerial_4k.json").write_text(json.dumps(tr))
    (home / "metrics" / "render_p50_ms.py").write_text(
        "from harness import layers\n\n\ndef read(t):\n    return layers.median(t['render_ms'])\n")
    bench["configs"].append({"name": "planar_16k_lit", "source": "x", "why": "x", "reduced": [],
                             "file": "terrain_bench/configs/planar_16k_lit.json"})
    bench["workloads"].append({"name": "planar_16k_lit.aerial_4k", "config": "planar_16k_lit",
                               "traffic": "aerial_4k", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "render_p50_ms", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "raster", "moves": "frames_per_s",
                               "workloads": ["planar_16k_lit.aerial_4k"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    # in a fresh interpreter, with the copy's harness on the path
    code = f"""
import sys
sys.path.insert(0, {str(home)!r})
from harness import manifest
assert manifest.HOME == __import__('pathlib').Path({str(home)!r})
b = manifest.load_json(manifest.HOME.parent / 'BENCHMARK.json')
c = manifest.cell(b, manifest.HOME.parent, 'planar_16k_lit.aerial_4k')
assert c.config['name'] == 'planar_16k_lit' and c.traffic['size'] == [3840, 2160]
assert [m['name'] for m in c.per_layer][-1] == 'render_p50_ms'
assert manifest.module('metrics', 'render_p50_ms').read({{'render_ms': [3.0, 1.0, 2.0]}}) == 2.0
assert callable(manifest.module('loops', c.traffic['loop']).run)
old = manifest.cell(b, manifest.HOME.parent, 'planar_8k_lit.aerial_1080p')
assert 'render_p50_ms' not in [m['name'] for m in old.per_layer]
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    after = digests(home)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        __import__("pathlib").Path(p) for p in
        ("configs/planar_16k_lit.json", "traffic/aerial_4k.json", "metrics/render_p50_ms.py")}


def test_run_has_no_cell_branch():
    text = (manifest.HOME / "run.py").read_text()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {c["name"] for c in bench["configs"]} | {w["name"] for w in bench["workloads"]}
    names |= {w["traffic"] for w in bench["workloads"]}
    names |= {m["name"] for m in bench["per_layer"]}
    assert not [n for n in names if n in text]
