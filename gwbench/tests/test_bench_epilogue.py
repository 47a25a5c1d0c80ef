"""The reader of ``k1_epilogue_share.recon`` on hand-built runs, its entry
in the benchmark, and the names it and ``k1_roofline.recon`` rely on: the
program's counters and the apply pass's kernel name."""
import json
import re

import pytest

from gwbench import cell, yardstick
from gwbench.reference import arch_name

NAME = "k1_epilogue_share.recon"
BENCH = cell.benchmark()
PORT = "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch"


def _run(launches, kind="serve_batch"):
    return {"trace": {"launches": launches}, "traffic": {"kind": kind}}


@pytest.mark.parametrize("k1,epilogue,want", [
    (1400, 1400, 100.0), (1400, 700, 50.0), (1400, 0, 0.0)])
def test_reader_gives_the_share_of_k1_launches(k1, epilogue, want):
    got = cell.metric_reader(NAME)(_run({"conv_gn_silu": k1,
                                         "conv_gn_silu_epilogue": epilogue}))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("run", [
    _run({"conv_gn_silu": 1400}),                 # a program without it
    _run({"conv_gn_silu": 0, "conv_gn_silu_epilogue": 0}),
    _run({"conv_gn_silu": 7, "conv_gn_silu_epilogue": 7}, "train_step"),
    {"traffic": {"kind": "serve_batch"}}],
    ids=["no_counter", "no_k1", "not_serving", "untraced"])
def test_reader_reads_nothing_without_its_counter(run):
    assert cell.metric_reader(NAME)(run) is None


def test_the_metric_is_an_entry_of_the_benchmark():
    m = {m["name"]: m for m in BENCH["per_layer"]}[NAME]
    assert (m["unit"], m["source"], m["layer"], m["moves"]) == (
        "%", "program_counter", "K1", "recon_per_s")
    # K1 is the U-Net's: every cell of a U-Net configuration, and no other
    unet = {c["name"] for c in BENCH["configs"] if arch_name(json.loads(
        (cell.ROOT / c["file"]).read_text())["model"]) == "unet"}
    cells = [w["name"] for w in BENCH["workloads"] if w["config"] in unet]
    assert m["workloads"] == cells


def test_the_program_counts_k1_and_its_epilogue():
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        launch_counts,
    )

    assert {"conv_gn_silu", "conv_gn_silu_epilogue"} <= set(launch_counts())


def test_the_apply_pass_keeps_the_yardsticks_k1_name():
    """K1's apply pass, which carries the epilogue, is still a kernel whose
    name the yardstick counts as K1's."""
    src = (cell.ROOT / PORT / "csrc" / "conv_gn_silu.cuh").read_text()
    # a kernel's name is the first word after its __global__ declaration
    kernels = re.findall(r"__global__ void __launch_bounds__\(.*?\)\)?\s+"
                         r"(\w+)\(", src, re.S)
    assert "gn_affine_silu" in kernels
    assert "gn_affine_silu" in yardstick.K1_KERNELS
