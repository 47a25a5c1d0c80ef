"""Every cell of ``BENCHMARK.json`` resolves to its files, and the file
keeps the contract's shape."""
import json
import re

import pytest

from gwbench import cell

BENCH = cell.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["paths"] == ["gwbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(isinstance(w, str) and w for w in BENCH["command"])


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("gwbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert len(CELLS) == len(set(CELLS))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    ctx = cell.context(name, 1, 1.0, False, device="cpu")
    assert ctx.config["name"] == ctx.workload["config"]
    assert cell.driver(ctx).run
    assert ctx.limits["numbers"]
    for trace in (False, True):
        ctx.trace = trace
        for m in cell.metrics_of(ctx, BENCH):
            assert callable(cell.metric_reader(m["name"]))


@pytest.mark.parametrize("name", CELLS)
def test_cell_reports_setup_another_metric_and_a_layer(name):
    e2e = [m["name"] for m in BENCH["end_to_end"] if cell.applies(m, name)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"] if cell.applies(m, name)]
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])


def test_configs_files_and_unreduced_widths():
    for c in BENCH["configs"]:
        data = json.loads((cell.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] == []


def test_layers_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
