"""BENCHMARK.json against the contract's shape: names, units, keys, the files
it names, and which cells report what."""

import json
import re

from harness import manifest

ROOT = manifest.HOME.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def names():
    yield from (c["name"] for c in BENCH["configs"])
    for w in BENCH["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    yield from (m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"])
    for c in BENCH["configs"]:
        yield from c["reduced"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32 and all(TEXT.match(w) for w in BENCH["command"])


def test_names_and_units():
    for n in names():
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    every = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(every) == len(set(every))
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/") and (ROOT / c["file"]).is_file()
        cfg = manifest.load_json(ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == cfg["source"][:200]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        assert (manifest.HOME / "traffic" / f"{w['traffic']}.json").is_file()
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])


def test_every_config_used_and_setup_reported():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])


def test_per_layer_cells_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m.get("workloads", sorted(cells)):
            assert w in cells
            assert manifest.applies(moved, w), (m["name"], w)
    for w in cells:
        assert sum(manifest.applies(m, w) for m in BENCH["end_to_end"]) >= 2
        assert any(manifest.applies(m, w) for m in BENCH["per_layer"])


def test_every_metric_and_loop_has_its_file():
    for m in BENCH["per_layer"]:
        assert callable(manifest.module("metrics", m["name"]).read)
    for w in BENCH["workloads"]:
        tr = manifest.load_json(manifest.HOME / "traffic" / f"{w['traffic']}.json")
        assert callable(manifest.module("loops", tr["loop"]).run)
        assert (manifest.HOME / "cameras" / f"{tr['path']['kind']}.py").is_file()
