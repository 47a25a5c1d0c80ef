"""Every cell of ``BENCHMARK.json`` resolves to its files, and the file
keeps the contract's shape."""
import copy
import json
import re

import pytest

from gwbench import arch, cell
from gwbench.reference import arch_name
from gwbench.tests import toy_arch

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
    """Each configuration's file keeps the rule on ``reduced``
    (``arch.reduced_faults``); a U-Net's cuts nothing."""
    for c in BENCH["configs"]:
        data = json.loads((cell.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert arch.reduced_faults(c, data) == [], c["name"]
        if arch_name(data["model"]) == "unet":
            assert data["reduced"] == c["reduced"] == []


def _toy(**change) -> dict:
    data = copy.deepcopy(toy_arch.CONFIG)
    data.update(change)
    return data


def _unet(**change) -> dict:
    data = json.loads((cell.ROOT / "gwbench/configs/pn128.json").read_text())
    data.update(change)
    return data


@pytest.mark.parametrize("listed,data,faults", [
    (["num_blocks"], _toy(), []),
    (["base_ch"], _unet(reduced=["base_ch"], published={"base_ch": 256},
                        deployment="half the channels"),
     ["base_ch: a width", "base_ch: not in unet's CUTTABLE"]),
    (["depth"], _unet(reduced=["depth"], published={"depth": 4},
                      deployment="3 of 4 levels"),
     ["depth: not in unet's CUTTABLE"]),
    (["width"], _toy(reduced=["width"], published={"width": 16}),
     ["width: a width", "width: not in toy's CUTTABLE"]),
    (["t_embed_max_time"], _toy(reduced=["t_embed_max_time"],
                                published={"t_embed_max_time": 1000.0}),
     ["t_embed_max_time: not in toy's CUTTABLE"]),
    ([], _toy(), ["BENCHMARK.json lists [], the file ['num_blocks']"]),
    (["num_blocks"], _toy(published={}), ["num_blocks: no published value"]),
    (["num_blocks"], _toy(published={"num_blocks": 2}),
     ["num_blocks: run at its published value"]),
    (["num_blocks"], _toy(deployment=""), ["no deployment"])],
    ids=["depth_cut", "unet_width", "unet_depth", "toy_width",
         "unlisted_key", "lists_apart", "no_published", "uncut",
         "no_deployment"])
def test_the_rule_on_reduced(monkeypatch, listed, data, faults):
    """A depth key that the architecture lists, with its published value
    and the deployment, passes; every other case fails, each for its
    reasons and no other."""
    toy_arch.register(monkeypatch)
    got = arch.reduced_faults({"reduced": listed}, data)
    assert [f for f in got if not any(f.startswith(w) for w in faults)] \
        == [], got
    assert all(any(f.startswith(w) for f in got) for w in faults), got


def test_layers_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
