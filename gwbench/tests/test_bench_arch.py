"""A second architecture enters the benchmark as new files only: a toy,
its plain forward (``toy_reference``) and its program side (``toy_arch``)
placed where the harness looks up ``reference/toy.py`` and ``arch/toy.py``,
with a configuration cut in depth, runs the reconstruction driver end to
end on the CPU, and the yardstick reads its counts."""
import copy
import importlib
import time

import pytest
import torch

from gwbench import arch, cell, inputs, port, run as grun, yardstick
from gwbench.drivers import serve_batch
from gwbench.reference import architecture
from gwbench.tests import tiny, toy_arch, toy_reference

MODEL = toy_arch.CONFIG["model"]
L = toy_arch.CONFIG["segment_len"]


@pytest.fixture(autouse=True)
def toy(monkeypatch):
    toy_arch.register(monkeypatch)


def _context(seed: int = 3_000_000_043) -> cell.Context:
    name = "toy.recon"
    return cell.Context(name=name, workload={"name": name, "chips": 1},
                        config=copy.deepcopy(toy_arch.CONFIG),
                        traffic=tiny.traffic(), limits=tiny.LIMITS,
                        seed=seed, seconds=0.3, trace=False,
                        device=torch.device("cpu"), started=time.time())


def test_the_harness_finds_the_toys_pair():
    assert architecture(MODEL) is toy_reference
    assert arch.of(MODEL) is toy_arch
    P = inputs.weights(MODEL, 5, "cpu")
    assert {k: tuple(v.shape) for k, v in P.items()} == \
        toy_reference.parameter_shapes(MODEL)
    assert isinstance(port.model(toy_arch.CONFIG, P, "cpu"), toy_arch.Toy)


def test_the_toys_configuration_keeps_the_rule_on_reduced():
    assert arch.reduced_faults({"reduced": ["num_blocks"]},
                               toy_arch.CONFIG) == []


def test_a_toy_architecture_runs_the_driver_end_to_end():
    ctx = _context()
    rec = serve_batch.run(ctx)
    line = grun.result_line(ctx, tiny.bench_for(ctx), rec)
    assert line["correct"] is True, line["compared"]
    assert 0.0 < rec["numbers"]["rel_err"] < 1e-5
    flops = toy_arch.flops_per_sample(MODEL, L)
    assert yardstick.model_flops_per_sample(MODEL, L) == flops
    got = cell.metric_reader("mfu.recon")(rec)
    assert got == 100.0 * flops * rec["forward_rows"] / rec["window_s"] / \
        yardstick.PEAK_BF16_FLOPS


def test_an_altered_toy_answer_makes_the_run_incorrect(monkeypatch):
    real = toy_arch.Toy.forward

    def altered(self, x, t):
        out = real(self, x, t)
        return torch.cat([1.1 * out[:1], out[1:]])

    monkeypatch.setattr(toy_arch.Toy, "forward", altered)
    ctx = _context()
    line = grun.result_line(ctx, tiny.bench_for(ctx), serve_batch.run(ctx))
    assert line["correct"] is False, line["compared"]


def test_the_yardstick_counts_the_toys_launches():
    rows = 16
    k1 = toy_arch.kernel_shapes(MODEL, L, rows)["k1"]
    bounds = yardstick.forward_bounds(MODEL, L, rows)
    assert bounds["k1"] == sum(yardstick.bound_s(*yardstick.k1_cost(*s))
                               for s in k1)
    assert bounds["k2"] == bounds["k2b"] == 0.0
    # three forwards' launches of K1 in 0.5 ms of device time
    run = {"traffic": {"kind": "serve_batch"}, "config": toy_arch.CONFIG,
           "rows_per_forward": rows,
           "trace": {"ops": [["conv3_mma_bf16", "", 5e-4, 6]],
                     "launches": {"conv_gn_silu": 3 * len(k1)}}}
    got = cell.metric_reader("k1_roofline.recon")(run)
    assert got == pytest.approx(100.0 * 3 * bounds["k1"] / 5e-4)
    assert cell.metric_reader("k2_roofline.recon")(run) is None


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (cell.HERE / "arch").glob("*.py")
    if p.stem != "__init__") + ["toy"])
def test_no_architecture_may_cut_a_width(name):
    mod = importlib.import_module(f"gwbench.arch.{name}")
    assert not [k for k in mod.CUTTABLE if arch.WIDTH.search(k)]
