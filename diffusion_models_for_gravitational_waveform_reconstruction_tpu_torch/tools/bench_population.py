"""Population-scale batched reconstruction on one card (BASELINE.json config
5, "batched sampling across an injected-SNR grid"): the port's twin of the
root ``tools/bench_population.py``.

    python -m diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools.bench_population \
        [B L STEPS] [--device cpu]

One DDIM call (``ops/sampling.py::ddim_sample``, 't' ladder, cfg 1.5,
self-conditioning) reconstructs a whole population of B measurements at
once with the reference-default U-Net (base_ch 64, depth 3, time_dim 128,
y + 4 metadata channels and the self-conditioning slot, bf16, T 1000
cosine) and seeded random weights.  CFG runs cond and uncond as one
doubled batch, so each step is one forward of 2 B rows.  Defaults: B 256,
L 4096, 100 steps.  After a warm-up, 3 populations are timed, each from
the call to a host copy of its whole result (CUDA events on the GPU, the
host clock on the CPU).

Prints one JSON line with the root tool's keys (``metric``, ``batch``,
``steps``, ``L``, ``wall_s_per_population``, ``samples_per_sec``,
``denoise_steps_per_sec_per_chip``, ``note``), unrounded, and the device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..models.unet import UNet1D
from ..ops.sampling import SamplerConfig, ddim_sample
from ..ops.schedules import make_schedule
from ..utils.device import resolve_device
from ..utils.weights import randomize_

IN_CH, COND_IN_CH = 7, 5
MODEL = dict(in_ch=IN_CH, base_ch=64, time_dim=128, depth=3,
             t_embed_max_time=999.0, cond_in_ch=COND_IN_CH,
             use_selfcond=True)
CFG_SCALE = 1.5
REPS = 3


def setup(B: int, L: int, device, dtype=torch.bfloat16, seed: int = 0):
    """``(model, schedule, cond)``: the U-Net in ``dtype`` with random
    weights from ``seed`` and a (B, 5, L) population of conditioning
    stacks (shape-realistic; values arbitrary), on ``device``."""
    model = UNet1D(**MODEL, dtype=dtype, device=device).eval()
    randomize_(model, seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    cond = torch.randn((B, COND_IN_CH, L), generator=g, device=device)
    return model, make_schedule(1000, "cosine"), cond


def population(model, schedule, cond: torch.Tensor, steps: int, noise):
    """The population's reconstructions (B, 1, L): one batched DDIM call."""
    cfg = SamplerConfig(steps=steps, cfg_scale=CFG_SCALE, use_selfcond=True)
    return ddim_sample(model, schedule, cond, cfg, noise)


def run(B: int = 256, L: int = 4096, steps: int = 100, device=None,
        reps: int = REPS) -> dict:
    """Warm up, time ``reps`` populations and return the JSON record."""
    dev = resolve_device(device)
    model, schedule, cond = setup(B, L, dev)

    def one(seed):
        noise = torch.Generator(device=dev).manual_seed(seed)
        return population(model, schedule, cond, steps, noise).cpu()

    out = one(2)                                      # warm-up
    if tuple(out.shape) != (B, 1, L) or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"population output {tuple(out.shape)} is not a "
                           f"finite ({B}, 1, {L})")
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for r in range(reps):
            one(3 + r)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / reps
        kind = torch.cuda.get_device_name(dev)
    else:
        t0 = time.perf_counter()
        for r in range(reps):
            one(3 + r)
        dt = (time.perf_counter() - t0) / reps
        kind = "cpu"
    return {"metric": "population_ddim", "batch": B, "steps": steps, "L": L,
            "wall_s_per_population": dt, "samples_per_sec": B / dt,
            "denoise_steps_per_sec_per_chip": B * steps / dt,
            "note": f"cfg={CFG_SCALE} -> 2 model forwards per denoise step "
                    f"(one forward of {2 * B} rows)",
            "device": dev.type, "device_kind": kind}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("sizes", type=int, nargs="*", metavar="B L STEPS",
                   help="population size, segment length, DDIM steps "
                        "(default 256 4096 100)")
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    if len(args.sizes) > 3:
        p.error("at most three sizes: B L STEPS")
    print(json.dumps(run(*args.sizes, device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
