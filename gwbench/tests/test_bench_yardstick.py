"""The frozen arithmetic: the U-Net's FLOP count (``arch/unet.py``) is the
port's, every configuration's counts are finite, and the kernels' bounds
are those of ``PERF.md``'s kernel table at its shapes."""
import json
import math

import pytest

from gwbench import cell, yardstick
from gwbench.arch import unet
from gwbench.reference import arch_name

BENCH = cell.benchmark()
CONFIGS = {c["name"]: json.loads((cell.ROOT / c["file"]).read_text())
           for c in BENCH["configs"]}


def _rows(workload: dict) -> int:
    """Rows of one forward of the cell, as ``serve_batch.run`` records them
    (``rows_per_forward``): each measurement's seeds, conditioned and not."""
    t = json.loads((cell.HERE / "traffic" / f"{workload['traffic']}.json")
                   .read_text())
    return 2 * t["avg_seeds"] * t["measurements_per_call"]


@pytest.mark.parametrize("name", sorted(
    n for n, c in CONFIGS.items() if arch_name(c["model"]) == "unet"))
def test_unet_flops_equal_the_ports(name):
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils import roofline

    cfg = CONFIGS[name]
    m, L = cfg["model"], cfg["segment_len"]
    assert yardstick.model_flops_per_sample(m, L) == roofline.unet_flops_per_sample(
        L, m["in_ch"], m["base_ch"], m["depth"], cond_ch=m["cond_in_ch"],
        fast_decoder=False, use_attention=m["use_attention"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_configurations_counts_are_finite(name):
    """Of any architecture: a row's forward FLOPs positive and finite, and
    at the rows of each of its cells the kernels' bounds finite and not
    negative."""
    cfg = CONFIGS[name]
    m, L = cfg["model"], cfg["segment_len"]
    flops = yardstick.model_flops_per_sample(m, L)
    assert 0.0 < flops < math.inf
    cells = [w for w in BENCH["workloads"] if w["config"] == name]
    assert cells
    for w in cells:
        got = yardstick.forward_bounds(m, L, _rows(w))
        assert all(0.0 <= v < math.inf for v in got.values()), (w["name"],
                                                                got)


def test_flops_of_the_flagships():
    assert yardstick.model_flops_per_sample(
        CONFIGS["pn128"]["model"], 4096) / 1e9 == pytest.approx(8.92, abs=0.01)
    assert yardstick.model_flops_per_sample(
        CONFIGS["attn16k"]["model"], 32768) / 1e9 == pytest.approx(37.28,
                                                                   abs=0.01)


@pytest.mark.parametrize("name,rows,want_ms", [("pn128", 64, 0.601),
                                               ("attn16k", 32, 0.746),
                                               ("attn16k", 16, 0.373)])
def test_k1_bound_of_the_kernel_table(name, rows, want_ms):
    cfg = CONFIGS[name]
    got = yardstick.forward_bounds(cfg["model"], cfg["segment_len"], rows)
    assert 1e3 * got["k1"] == pytest.approx(want_ms, abs=5e-4)


@pytest.mark.parametrize("shape,want_ms", [((32, 4, 4096, 64), 0.556),
                                           ((16, 4, 4096, 64), 0.278)])
def test_k2_bound_of_the_kernel_table(shape, want_ms):
    assert 1e3 * yardstick.bound_s(*yardstick.k2_cost(*shape)) == \
        pytest.approx(want_ms, abs=5e-4)


def test_backward_bounds_of_the_kernel_table():
    cfg = CONFIGS["attn16k"]
    got = yardstick.forward_bounds(cfg["model"], cfg["segment_len"], 16)
    assert 1e3 * got["k1b"] == pytest.approx(0.908, abs=5e-4)
    assert 1e3 * got["k2b"] == pytest.approx(0.695, abs=5e-4)


def test_attention_shape_of_attn16k():
    cfg = CONFIGS["attn16k"]
    assert unet.attention_shape(cfg["model"], 32768, 64) == (64, 4, 4096, 64)
    assert unet.attention_shape(CONFIGS["pn128"]["model"], 4096, 8) is None
    assert unet.kernel_shapes(cfg["model"], 32768, 64)["k2"] == [
        (64, 4, 4096, 64)]
    assert unet.kernel_shapes(CONFIGS["pn128"]["model"], 4096, 8)["k2"] == []


def test_kernel_classes():
    assert yardstick.kernel_class("void conv3_wgmma_bf16<128>(...)", "") == "k1"
    assert yardstick.kernel_class("conv3_wgmma_bf16", yardstick.K1B_RANGE) \
        == "k1b"
    assert yardstick.kernel_class("flash_fwd_wgmma_bf16", "") == "k2"
    assert yardstick.kernel_class("flash_bwd_dq_tma", yardstick.K2B_RANGE) \
        == "k2b"
    assert yardstick.kernel_class("nvjet_tst_128x64", "") == "matmul"
    assert yardstick.kernel_class("elementwise_kernel", "train/backward") \
        == "rest"
