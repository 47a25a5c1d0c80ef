"""On the card: one short run of each one-chip cell through the command of
``BENCHMARK.json``, its result line read back."""
import json
import subprocess

import pytest

from gwbench import cell

BENCH = cell.benchmark()
ONE_CHIP = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ONE_CHIP)
def test_a_short_run_is_correct(card, name):
    out = subprocess.run(
        BENCH["command"] + ["--workload", name, "--seed", "2147483659",
                            "--seconds", "2", "--trace", "0"],
        cwd=cell.ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["compared"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1
    assert "setup_s" in line["metrics"]


@pytest.mark.cuda
def test_the_reference_turns_tf32_off_on_the_card(card):
    """Inside the reference a float32 convolution and product are float32:
    equal to the same in float64 within float32's rounding, where TF32's
    would be a thousand times coarser."""
    import torch
    import torch.nn.functional as F

    from gwbench.reference import float32_exact

    torch.backends.cudnn.allow_tf32 = True
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((4, 256, 4096), device="cuda", generator=g)
    w = torch.randn((256, 256, 3), device="cuda", generator=g) / 28.0
    want = F.conv1d(x.double(), w.double(), padding=1)
    with float32_exact():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        got = F.conv1d(x, w, padding=1)
        prod = x[0].T @ w[:, :, 0].T
    assert torch.backends.cudnn.allow_tf32
    rel = float((got.double() - want).norm() / want.norm())
    prel = float((prod.double() - x[0].T.double() @ w[:, :, 0].T.double())
                 .norm() / prod.double().norm())
    assert rel < 1e-5 and prel < 1e-5, (rel, prel)
