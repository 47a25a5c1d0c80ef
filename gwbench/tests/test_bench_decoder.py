"""The reader of ``k1_decoder_share.recon`` on hand-built runs, its entry
in the benchmark, and the names it and ``k1_roofline.recon`` rely on: the
program's counter and the decoder route's kernel names."""
import json
import re

import pytest

from gwbench import cell, yardstick
from gwbench.reference import arch_name

NAME = "k1_decoder_share.recon"
BENCH = cell.benchmark()
PORT = "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch"


def _run(launches, kind="serve_batch"):
    return {"trace": {"launches": launches}, "traffic": {"kind": kind}}


@pytest.mark.parametrize("k1,decoder,want", [
    (1400, 600, 100.0 * 3 / 7), (1400, 1400, 100.0), (1400, 0, 0.0)])
def test_reader_gives_the_share_of_k1_launches(k1, decoder, want):
    got = cell.metric_reader(NAME)(_run({"conv_gn_silu": k1,
                                         "conv_gn_silu_decoder": decoder}))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("run", [
    _run({"conv_gn_silu": 1400, "conv_gn_silu_epilogue": 1400}),
    _run({"conv_gn_silu": 0, "conv_gn_silu_decoder": 0}),
    _run({"conv_gn_silu": 7, "conv_gn_silu_decoder": 3}, "train_step"),
    {"traffic": {"kind": "serve_batch"}}],
    ids=["no_counter", "no_k1", "not_serving", "untraced"])
def test_reader_reads_nothing_without_its_counter(run):
    assert cell.metric_reader(NAME)(run) is None


def test_the_metric_is_an_entry_of_the_benchmark():
    m = {m["name"]: m for m in BENCH["per_layer"]}[NAME]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "%", "higher", "program_counter", "K1", "recon_per_s")
    unet = {c["name"] for c in BENCH["configs"] if arch_name(json.loads(
        (cell.ROOT / c["file"]).read_text())["model"]) == "unet"}
    cells = [w["name"] for w in BENCH["workloads"] if w["config"] in unet]
    assert m["workloads"] == cells


def test_the_program_counts_k1_and_its_decoder_route():
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        launch_counts,
    )

    assert {"conv_gn_silu", "conv_gn_silu_decoder"} <= set(launch_counts())


def test_the_decoder_route_keeps_the_yardsticks_k1_names():
    """The decoder route's conv pass and pack are kernels whose names the
    yardstick counts as K1's, not as the elementwise rest."""
    src = "".join((cell.ROOT / PORT / "csrc" / f"conv_gn_silu.{ext}")
                  .read_text() for ext in ("cu", "cuh"))
    kernels = re.findall(r"__global__ void __launch_bounds__\(.*?\)\)?\s+"
                         r"(\w+)\(", src, re.S)
    for name in ("conv3_wgmma_decoder_bf16", "pack_weights_decoder_bf16"):
        assert name in kernels
        assert yardstick.kernel_class(f"void {name}<128>()", "") == "k1"
