"""The reader of ``head_kernel_share.recon`` on hand-built runs, its entry
in the benchmark, and the names it and ``unspanned_rest_share.recon`` rely
on: the program's counter and the head kernel's names."""
import json
import re

import pytest

from gwbench import cell, yardstick
from gwbench.reference import arch_name

NAME = "head_kernel_share.recon"
BENCH = cell.benchmark()
PORT = "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch"
CONFIG = json.loads((cell.ROOT / "gwbench" / "configs" / "pn128.json")
                    .read_text())


def _run(launches, kind="serve_batch"):
    return {"trace": {"launches": launches}, "traffic": {"kind": kind},
            "config": CONFIG, "rows_per_forward": 128}


@pytest.mark.parametrize("k1,head,want", [
    (1400, 200, 100.0), (1400, 100, 50.0), (1400, 0, 0.0)])
def test_reader_gives_the_share_of_forwards(k1, head, want):
    """pn128's forward launches K1 7 times: 200 heads in 1400 K1 launches
    are every forward."""
    got = cell.metric_reader(NAME)(_run({"conv_gn_silu": k1,
                                         "unet_head": head}))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("run", [
    _run({"conv_gn_silu": 1400, "conv_gn_silu_decoder": 600}),
    _run({"conv_gn_silu": 0, "unet_head": 0}),
    _run({"conv_gn_silu": 7, "unet_head": 1}, "train_step"),
    {"traffic": {"kind": "serve_batch"}}],
    ids=["no_counter", "no_k1", "not_serving", "untraced"])
def test_reader_reads_nothing_without_its_counter(run):
    assert cell.metric_reader(NAME)(run) is None


def test_the_metric_is_an_entry_of_the_benchmark():
    m = {m["name"]: m for m in BENCH["per_layer"]}[NAME]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "%", "higher", "program_counter", "head", "recon_per_s")
    unet = {c["name"] for c in BENCH["configs"] if arch_name(json.loads(
        (cell.ROOT / c["file"]).read_text())["model"]) == "unet"}
    cells = [w["name"] for w in BENCH["workloads"] if w["config"] in unet]
    assert m["workloads"] == cells


def test_the_program_counts_the_head():
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        launch_counts,
    )

    assert {"conv_gn_silu", "unet_head"} <= set(launch_counts())


def test_the_head_kernel_stays_in_the_rest_class():
    """The head's kernels are neither K1's, K2's nor a matrix product's by
    the yardstick's names, so their time stays where
    ``unspanned_rest_share.recon`` reads it."""
    src = (cell.ROOT / PORT / "csrc" / "unet_head.cu").read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s+"
                         r"(\w+)\(", src)
    assert sorted(kernels) == ["unet_head_bf16", "unet_head_f32"]
    for name in kernels:
        assert yardstick.kernel_class(
            f"void (anonymous namespace)::{name}<8, 1>(...)",
            "gwport::unet_head") == "rest"
