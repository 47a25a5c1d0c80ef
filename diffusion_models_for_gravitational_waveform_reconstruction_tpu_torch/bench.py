"""U-Net denoise steps per second on one card: the port's twin of the root
``bench.py``.

    python -m diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.bench

One denoise step is one conditioned U-Net forward, the eps -> x0 conversion
and a DDIM update of one sample, so a batch-64 sampler step counts 64.  The
model is the reference-default architecture (base_ch 64, depth 3, time_dim
128, 4096-sample segments) with y + 4 metadata channels and the
self-conditioning slot, in bf16, with seeded random weights.  The value is
the marginal cost between a 50- and a 250-step run, each the best of 5
after a warm-up, timed with CUDA events, so a run's fixed cost cancels.

Prints one JSON line: ``metric``, ``value`` and ``unit`` as the root bench
(no ``vs_baseline``: its TPU target does not carry over); the analytic FLOPs
of a sampler step (``utils/roofline.py`` with ``fast_decoder=False``, the
decoder the port runs), the achieved TFLOP/s and ``mfu`` against the card's
dense bf16 peak; the card (``device_kind``, and ``nvidia-smi``'s name and
power limit); and ``measured_hbm_stream_gbps``, the device-memory rate of 32
dependent in-place passes over a 256 MB float32 buffer.  There is no
``hbm_bw_util``: torch has no cost model of the step's bytes, and this bench
counts none.  Runs on the GPU only.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import numpy as np
import torch

from .models.unet import UNet1D
from .ops.schedules import make_schedule
from .utils.device import resolve_device
from .utils.roofline import peak_for, unet_flops_per_sample
from .utils.weights import randomize_

B, L = 64, 4096
IN_CH, COND_IN_CH = 7, 5
T = 1000
SCAN_STEPS = 50
LONG = 5 * SCAN_STEPS
REPS = 5
MODEL = dict(in_ch=IN_CH, base_ch=64, time_dim=128, depth=3,
             t_embed_max_time=float(T - 1), cond_in_ch=COND_IN_CH,
             use_selfcond=True)
METRIC = "unet_denoise_steps_per_sec_per_chip"
UNIT = "steps/s/chip (batch=64, base_ch=64, depth=3, L=4096, bf16)"


def flops_per_sampler_step() -> float:
    """Analytic FLOPs of one batch-B sampler step (B U-Net forwards)."""
    return B * unet_flops_per_sample(L, IN_CH, MODEL["base_ch"],
                                     depth=MODEL["depth"], cond_ch=COND_IN_CH,
                                     fast_decoder=False)


def nvidia_smi() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    if shutil.which("nvidia-smi") is None:
        return "not measured"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def best_ms(run, reps: int) -> float:
    """Least device time of ``run()`` over ``reps`` calls after a warm-up,
    in ms from CUDA events."""
    run()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def make_run(model, schedule, x_init, cond, n_steps: int):
    """``run()``: ``n_steps`` DDIM steps (the root bench's scan body: cat,
    U-Net, eps -> x0, update, x0 as the self-conditioning slot) on a
    t-ladder from T-1 to 1; the per-step constants are made beforehand, as
    the root bench's scanned inputs are."""
    dev = x_init.device
    ts = np.linspace(T - 1, 1, n_steps).round().astype(np.int64)
    ab = np.asarray(schedule.alpha_bar, np.float64)
    ab_t = ab[ts].astype(np.float32)
    ab_prev = np.concatenate([ab[ts[1:]], [1.0]]).astype(np.float32)
    steps = [(torch.full((B,), int(t), dtype=torch.int64, device=dev),
              float(np.sqrt(1 - a)), float(np.sqrt(a)), float(np.sqrt(p)),
              float(np.sqrt(np.clip(1 - p, 0.0, None))))
             for t, a, p in zip(ts, ab_t, ab_prev)]

    @torch.no_grad()
    def run():
        x_t, sc = x_init, torch.zeros_like(x_init)
        for t_b, s_eps, s_ab, s_prev, s_dir in steps:
            eps_hat = model(torch.cat([x_t, cond, sc], dim=1), t_b)
            x0_hat = (x_t - s_eps * eps_hat) / s_ab
            x_t, sc = s_prev * x0_hat + s_dir * eps_hat, x0_hat
        return x_t

    return run


def hbm_stream_gbps(device, n: int = 64 * 1024 * 1024, passes: int = 32,
                    reps: int = 3) -> float:
    """Device-memory GB/s of ``passes`` dependent in-place passes over an
    ``n``-element float32 buffer (each reads and writes it once)."""
    x = torch.ones(n, dtype=torch.float32, device=device)

    def stream():
        for _ in range(passes):
            x.mul_(1.0000001)

    ms = best_ms(stream, reps)
    return passes * 2 * n * 4 / (ms * 1e-3) / 1e9


def setup(device=None):
    """``(model, schedule, x_init, cond)`` of the bench on ``device``
    (default: the GPU; a CUDA device only), from fixed seeds."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the bench times the GPU with CUDA events; it does "
                         "not run on the CPU")
    model = UNet1D(**MODEL, dtype=torch.bfloat16, device=dev).eval()
    randomize_(model, 2)
    g = torch.Generator(device=dev).manual_seed(0)
    x_init = torch.randn((B, 1, L), generator=g, device=dev)
    cond = torch.randn((B, COND_IN_CH, L), generator=g, device=dev)
    return model, make_schedule(T, "cosine"), x_init, cond


def run(device=None) -> dict:
    """Time the bench on ``device`` (default: the GPU) and return its JSON
    record."""
    model, schedule, x_init, cond = setup(device)
    dev = x_init.device
    ms = {n: best_ms(make_run(model, schedule, x_init, cond, n), REPS)
          for n in (SCAN_STEPS, LONG)}
    per_step_s = (ms[LONG] - ms[SCAN_STEPS]) / (LONG - SCAN_STEPS) / 1e3
    steps_per_sec = B / per_step_s
    flops = flops_per_sampler_step()
    achieved = flops / per_step_s
    kind = torch.cuda.get_device_name(dev)
    rec = {"metric": METRIC, "value": steps_per_sec, "unit": UNIT,
           "ms_per_sampler_step": per_step_s * 1e3,
           "run_ms": {str(n): t for n, t in ms.items()},
           "flops_per_sampler_step": flops,
           "flops_source": "analytic, utils/roofline.py fast_decoder=False",
           "achieved_tflops": achieved / 1e12, "device_kind": kind,
           "nvidia_smi": nvidia_smi()}
    peak = peak_for(kind)
    if peak:
        rec["mfu"] = achieved / peak[0]
    rec["measured_hbm_stream_gbps"] = hbm_stream_gbps(dev)
    return rec


def main(argv=None) -> int:
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
