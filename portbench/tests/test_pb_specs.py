"""BENCHMARK.json and the files the harness finds by name agree."""
import json
import re

import pytest

from portbench.lib.cell import HERE, ROOT, cell_spec, load_module, metric_names

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    spec = cell_spec(cell)
    for key in ("config", "traffic", "chips", "why"):
        assert spec[key] == entry[key]
    cfg = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert cfg["file"] == f"portbench/configs/{entry['config']}.json"
    assert cfg["source"] == spec["config_spec"]["source"]
    assert cfg["reduced"] == spec["config_spec"]["reduced"] == []
    assert hasattr(load_module("kinds", spec["traffic_spec"]["kind"]), "setup")
    e2e = [m["name"] for m in metric_names(cell, BENCH, trace=False)]
    layer = [m["name"] for m in metric_names(cell, BENCH, trace=True)]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for name in e2e + layer:
        assert callable(load_module("metrics", name).read)


def test_every_metric_has_a_reader_and_each_config_a_cell():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
