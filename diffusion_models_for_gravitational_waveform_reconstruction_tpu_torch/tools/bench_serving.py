"""Serving latency of a ``gw-export`` artifact on the GPU (the port's twin
of the root ``tools/bench_serving.py``).

Replays a port artifact on random inputs of its sidecar's shapes and reports
the time per call and per measurement.  Each call is timed with CUDA events
around the call and the copy of its whole (B, L) output to the host.

    python -m diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools.bench_serving \
        --artifact sampler.pt2 [--reps 5] [--seed 0]

Prints one JSON line with the root tool's keys: artifact, batch, length,
steps, avg_seeds, cfg_scale, sampler, unet_forwards_per_call,
best_s_per_call, median_s_per_call, s_per_measurement, measurements_per_s,
forwards_per_s.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..serving import load_exported


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--artifact", required=True)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    call, contract = load_exported(args.artifact)
    B, C, L = (int(v) for v in
               contract["calling_convention"]["inputs"]["cond_stack"][:3])
    k = contract["knobs"]
    steps, avg_seeds = int(k["steps"]), int(k["avg_seeds"])
    cfg_scale = float(k["cfg_scale"])
    # forwards per call: B measurements x avg_seeds trajectories x steps,
    # x2 when CFG is applied at sampling time (folded CFG: cfg_scale == 1)
    forwards = B * avg_seeds * steps * (2 if cfg_scale != 1.0 else 1)

    rng = np.random.default_rng(args.seed)
    cond = rng.normal(size=(B, C, L)).astype(np.float32)
    sig = np.ones((B,), np.float32)

    call(cond, sig, 0).cpu()                          # warm-up
    times = []
    for r in range(args.reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = call(cond, sig, r + 1).cpu()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    if tuple(out.shape) != (B, L) or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"artifact output {tuple(out.shape)} is not a "
                           f"finite ({B}, {L})")

    best = float(min(times))
    med = float(np.median(times))
    print(json.dumps({
        "artifact": os.path.basename(args.artifact),
        "batch": B, "length": L, "steps": steps, "avg_seeds": avg_seeds,
        "cfg_scale": cfg_scale, "sampler": k["sampler"],
        "unet_forwards_per_call": forwards,
        "best_s_per_call": best,
        "median_s_per_call": med,
        "s_per_measurement": best / B,
        "measurements_per_s": B / best,
        "forwards_per_s": forwards / best,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
