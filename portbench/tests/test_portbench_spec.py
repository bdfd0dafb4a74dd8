"""Every cell, configuration, traffic mix and metric that BENCHMARK.json
names is found by its name, and the file keeps to the benchmark's
contract.  A later cell, mix, configuration or metric is new files plus
entries: nothing here lists them."""

import json
import re

import pytest

from portbench import spec

BENCH = spec.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["portbench"]
    assert (spec.ROOT / BENCH["command"][1]).is_file()
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"]
             + METRICS]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_found_and_used(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    path = spec.ROOT / conf["file"]
    assert path.is_file() and conf["file"].startswith("portbench/")
    data = json.loads(path.read_text())
    assert data["reduced"] == conf["reduced"]
    assert data["source"] == conf["source"]
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])
    assert all(NAME.match(k) for k in conf["reduced"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    cell = spec.cell(name)
    w = {w["name"]: w for w in BENCH["workloads"]}[name]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert NAME.match(w["traffic"])
    for fn in ("rows_per_call", "make_inputs", "prepare", "call", "finish",
               "counters"):
        assert callable(getattr(cell.mix, fn)), fn
    for fn in ("expected", "compare", "control"):
        assert callable(getattr(cell.reference, fn)), fn
    assert cell.reference.LIMITS
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in reported, (m["name"], m["moves"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_has_a_reader(metric):
    per_layer = metric in BENCH["per_layer"]
    keys = ({"name", "unit", "better", "source", "layer", "moves"}
            if per_layer else {"name", "unit", "better", "bound", "source"})
    assert set(metric) - {"workloads"} == keys
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower",
                                                               "higher")
    assert metric["source"] in SOURCES
    if per_layer:
        assert "\n" not in metric["layer"] and metric["moves"] in {
            m["name"] for m in BENCH["end_to_end"]}
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    reader = spec.cell(CELLS[0]).reader(metric["name"])
    assert callable(reader.read)
