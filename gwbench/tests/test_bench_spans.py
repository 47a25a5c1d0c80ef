"""The readers of the program's spans (``metrics/_spans.py`` and the six
metrics that use it) on hand-built traces, and on the card a traced run of
each cell that prints every one of them."""
import importlib
import json
import subprocess

import pytest

from gwbench import cell, tracing
from gwbench.metrics import _spans
from gwbench.reference import arch_name
from gwbench.tests import toy_arch

BENCH = cell.benchmark()
NEW = ("sampler_self_share.recon", "film_share.recon",
       "cond_bias_share.recon", "resample_share.recon",
       "attn_glue_share.recon", "unspanned_rest_share.recon")

# host ranges (name, start, end) in microseconds, as the program opens them
RANGES = [("serve/call", 0, 1000), ("serve/inputs", 1, 10),
          ("sampler/start", 11, 20), ("sampler/step", 21, 900),
          ("sampler/net_in", 22, 30), ("unet/forward", 31, 800),
          ("unet/film", 100, 110), ("unet/cond_bias", 120, 130),
          ("unet/resample", 140, 150), ("unet/attn", 160, 200),
          ("sampler/guide", 801, 810), ("sampler/update", 811, 820),
          ("serve/aggregate", 901, 910), ("serve/calibrate", 911, 920)]
# device operations (name, host range launched in or None, microseconds)
KERNELS = [("elementwise_kernel", "serve/inputs", 10),
           ("elementwise_kernel", "sampler/start", 5),
           ("elementwise_kernel", "sampler/net_in", 20),
           ("CatArrayBatchedCopy", "sampler/net_in", 10),
           ("conv3_wgmma_bf16", "unet/forward", 100),
           ("elementwise_kernel", "unet/forward", 30),
           ("nvjet_tst_128x64", "unet/film", 8),
           ("elementwise_kernel", "unet/film", 40),
           ("elementwise_kernel", "unet/cond_bias", 50),
           ("gemm_bf16", "unet/cond_bias", 7),
           ("CatArrayBatchedCopy", "unet/resample", 25),
           ("flash_fwd_wgmma_bf16", "unet/attn", 60),
           ("elementwise_kernel", "unet/attn", 15),
           ("nvjet_tst_64x64", "unet/attn", 5),
           ("elementwise_kernel", "sampler/guide", 4),
           ("elementwise_kernel", "sampler/update", 6),
           ("reduce_kernel", "serve/aggregate", 3),
           ("elementwise_kernel", "serve/calibrate", 2),
           ("Memcpy DtoH (Device -> Pageable)", None, 5)]
TOTAL = sum(k[2] for k in KERNELS)
WANT = {"sampler_self_share.recon": 10 + 5 + 30 + 4 + 6 + 3 + 2,
        "film_share.recon": 48, "cond_bias_share.recon": 57,
        "resample_share.recon": 25, "attn_glue_share.recon": 80 - 60,
        # the stem's elementwise work and the copy to the host
        "unspanned_rest_share.recon": 30 + 5}


def _events(with_spans=True):
    """A profiler trace of the tables above: each device operation
    launched from the middle of its range, run one after another."""
    where = {name: (lo, hi) for name, lo, hi in RANGES}
    events, t_dev = [], 5000.0
    for c, (name, rng, us) in enumerate(KERNELS):
        lo, hi = where[rng] if rng else (950, 960)
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": (lo + hi) / 2,
                       "dur": 0.1, "args": {"correlation": c}})
        events.append({"ph": "X", "cat": ("gpu_memcpy" if rng is None
                                          else "kernel"),
                       "name": name, "ts": t_dev, "dur": us,
                       "args": {"correlation": c}})
        t_dev += us
    if with_spans:
        events += [{"ph": "X", "cat": "user_annotation", "name": name,
                    "ts": lo, "dur": hi - lo} for name, lo, hi in RANGES]
    return events


def _run(trace):
    return {"trace": trace, "traffic": {"kind": "serve_batch"}}


@pytest.mark.parametrize("name", NEW)
def test_each_reader_gives_its_share_of_a_hand_built_trace(name):
    run = _run(tracing.summarize(_events(), 0.01))
    got = cell.metric_reader(name)(run)
    assert got == pytest.approx(100.0 * WANT[name] / TOTAL)


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_nothing_without_its_spans(name):
    reader = cell.metric_reader(name)
    assert reader(_run(tracing.summarize(_events(False), 0.01))) is None
    assert reader({"traffic": {"kind": "serve_batch"}}) is None
    assert reader({"trace": tracing.summarize(_events(), 0.01),
                   "traffic": {"kind": "train_step"}}) is None


def test_attn_glue_subtracts_k2():
    trace = {"range_s": {"unet/attn": 3.0},
             "ops": [["flash_fwd_wgmma_bf16", "unet/attn", 2.0, 1],
                     ["elementwise_kernel", "unet/attn", 0.5, 1],
                     ["nvjet_tst_64x64", "unet/attn", 0.5, 1],
                     ["flash_fwd_wgmma_bf16", "", 1.0, 1]]}
    got = cell.metric_reader("attn_glue_share.recon")(_run(trace))
    assert got == pytest.approx(100.0 * 1.0 / 4.0)


def test_unspanned_rest_counts_rest_outside_the_leaves_only():
    trace = {"range_s": {"unet/forward": 6.5, "unet/film": 1.0},
             "ops": [["elementwise_kernel", "unet/film", 1.0, 1],
                     ["elementwise_kernel", "unet/forward", 2.0, 1],
                     ["conv3_wgmma_bf16", "unet/forward", 3.0, 1],
                     ["nvjet_tst_128x64", "unet/forward", 0.5, 1],
                     ["CatArrayBatchedCopy", "sampler/step", 0.25, 1],
                     ["elementwise_kernel", "", 1.25, 1]]}
    got = cell.metric_reader("unspanned_rest_share.recon")(_run(trace))
    assert got == pytest.approx(100.0 * 3.5 / 8.0)


# every ``arch/<arch>.py``, by the glob of ``test_bench_arch.py``
ARCHS = sorted(p.stem for p in (cell.HERE / "arch").glob("*.py")
               if p.stem != "__init__")
# the served path's spans that no architecture opens: the call, and the
# step that holds a forward
SERVED = ("serve/call", "sampler/step")


def span_faults(opened, archs) -> list:
    """What the program's spans ``opened`` break of the rule, none where
    they keep it: they are exactly the served path's own, the sampler's
    leaves and each of ``archs``' ``FORWARD`` and ``SPANS``
    (``gwbench.arch.<arch>``), and hold every leaf that the readers
    read."""
    want = set(SERVED) | set(_spans.SAMPLER)
    for name in archs:
        mod = importlib.import_module(f"gwbench.arch.{name}")
        if hasattr(mod, "FORWARD"):
            want.add(mod.FORWARD)
        want.update(getattr(mod, "SPANS", ()))
    opened = set(opened)
    faults = [f"opened, declared by none: {n}" for n in sorted(opened - want)]
    faults += [f"declared, not opened: {n}" for n in sorted(want - opened)]
    if not set(_spans.LEAVES) < opened:
        faults.append(f"leaves not opened: "
                      f"{sorted(set(_spans.LEAVES) - opened)}")
    return faults


def test_the_leaves_are_spans_the_program_opens():
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils import spans

    assert span_faults(spans.SPANS, ARCHS) == []


@pytest.mark.parametrize("declared", [True, False])
def test_a_new_span_needs_an_architecture_that_declares_it(monkeypatch,
                                                           declared):
    """A span that the program adds (the toy's ``toy/block``) passes where
    the toy's ``arch`` module declares it, and fails where it does not."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils import spans

    monkeypatch.setattr(spans, "SPANS", spans.SPANS + ("toy/block",))
    toy_arch.register(monkeypatch)
    if declared:
        monkeypatch.setattr(toy_arch, "SPANS", ("toy/block",), raising=False)
    faults = span_faults(spans.SPANS, sorted(set(ARCHS) | {"toy"}))
    assert faults == ([] if declared else
                      ["opened, declared by none: toy/block"])


@pytest.mark.parametrize("name", [r[0] for r in RANGES])
def test_a_dropped_or_renamed_span_fails_the_rule(name):
    """Each of the 14 spans that the program opens today."""
    assert span_faults([r[0] for r in RANGES], ARCHS) == []
    opened = [r[0] for r in RANGES if r[0] != name]
    assert span_faults(opened, ARCHS)
    assert span_faults(opened + [name + "_renamed"], ARCHS)


def test_the_new_metrics_are_entries_of_the_benchmark():
    got = {m["name"]: m for m in BENCH["per_layer"]}
    for name in NEW:
        m = got[name]
        assert (m["unit"], m["source"], m["moves"]) == ("%", "device_trace",
                                                        "recon_per_s")
    assert got["attn_glue_share.recon"]["workloads"] == ["attn16k.recon_batch"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]
                                  if w["chips"] == 1])
def test_a_traced_run_prints_every_span_metric(card, name):
    out = subprocess.run(
        BENCH["command"] + ["--workload", name, "--seed", "2147483701",
                            "--seconds", "2", "--trace", "1"],
        cwd=cell.ROOT, capture_output=True, text=True, timeout=420)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    want = [m["name"] for m in BENCH["per_layer"]
            if m["name"] in NEW and cell.applies(m, name)]
    for metric in want:
        assert metric in line["metrics"], (metric, sorted(line["metrics"]))
        assert 0.0 <= line["metrics"][metric]["value"] <= 100.0, metric


def _model(cell_name: str) -> dict:
    w = {w["name"]: w for w in BENCH["workloads"]}[cell_name]
    c = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    return json.loads((cell.ROOT / c["file"]).read_text())["model"]


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]
                                  if arch_name(_model(w["name"])) == "unet"])
def test_each_unet_cell_reads_every_span_of_its_forward(name):
    """The spans are the U-Net's: a cell of a U-Net configuration reads all
    six, the attention's glue only where the bottleneck attends."""
    attends = _model(name)["use_attention"]
    want = {n for n in NEW if attends or n != "attn_glue_share.recon"}
    assert {m["name"] for m in BENCH["per_layer"]
            if m["name"] in NEW and cell.applies(m, name)} == want
