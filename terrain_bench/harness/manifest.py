"""``BENCHMARK.json`` and the files it names, found by name: a
configuration's file (its ``file``), ``traffic/<traffic>.json``,
``loops/<loop>.py`` and ``metrics/<metric>.py``."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import SimpleNamespace

HOME = Path(__file__).resolve().parents[1]  # terrain_bench/
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def module(kind: str, name: str):
    """``terrain_bench/<kind>/<name>.py`` as a module."""
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = HOME / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"tb_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(bench: dict, root: Path, workload: str) -> SimpleNamespace:
    """The workload's configuration, traffic, chips and metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(HOME / "traffic" / f"{w['traffic']}.json")
    return SimpleNamespace(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if applies(m, workload)],
    )
