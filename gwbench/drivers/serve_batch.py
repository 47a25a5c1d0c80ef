"""Batch reconstruction: the deployment sampler served closed-loop, one call
of ``measurements_per_call`` measurements after another, each call with new
measurements and a new seed, its answer copied to the host.

Set-up: the kernels built or loaded, the weights and a pool of measurements
made on the device from the seed (the pool on the host, as a serving host
holds its input), one warm-up call.  The window runs whole calls until
``--seconds`` have passed.  After it, the reference reconstructs one call
of the window, drawn from the seed, and its answers are compared.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import inputs, port
from ..reference import sampler as ref_sampler
from ..tracing import traced


def recipe(config: dict, traffic: dict) -> dict:
    """What the reference needs of the sampler's recipe."""
    return {"T": config["T"], "steps": traffic["steps"],
            "cfg_scale": traffic["cfg_scale"],
            "avg_seeds": traffic["avg_seeds"], "clamp": traffic["clamp"],
            "x0_clip": traffic["x0_clip"]}


def reference(ctx, params, cond, sigmas, seed, cast=None):
    """The reference's answers to one call, float32 on the run's device."""
    kw = {} if cast is None else {"cast": cast}
    with torch.no_grad():
        return ref_sampler.sample(
            params, ctx.config["model"], recipe(ctx.config, ctx.traffic),
            cond, sigmas, seed,
            row_block=ctx.traffic["reference_row_block"], **kw)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest of the rows' relative L2 errors."""
    d = (got.double() - want.double()).norm(dim=-1)
    return float((d / want.double().norm(dim=-1).clamp(min=1e-30)).max())


def setup(ctx):
    """The program's serving function and model, the benchmark's weights
    and the measurement pool on the host."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    port.build_kernels(dev)
    params = inputs.weights(cfg["model"], ctx.seed, dev)
    model = port.model(cfg, params, dev)
    fn, _ = port.serving_fn(cfg, tr, dev)
    B = tr["measurements_per_call"]
    m = inputs.chirps(tr["pool_calls"] * B, cfg["segment_len"], cfg["fs"],
                      ctx.seed, "measurements", dev)
    cond = inputs.cond_stacks(m).cpu().numpy()
    sig = m["sigma"].cpu().numpy()
    return params, model, fn, cond, sig


def run(ctx) -> dict:
    """One run of the cell; returns the run's record for the metrics and
    the numbers compared."""
    tr = ctx.traffic
    B = tr["measurements_per_call"]
    params, model, fn, cond, sig = setup(ctx)
    pool = tr["pool_calls"]

    def call(i):
        j = i % pool
        out = fn(model, cond[j * B:(j + 1) * B], sig[j * B:(j + 1) * B],
                 inputs.call_seed(ctx.seed, i))
        return out.cpu().numpy()

    call(-1)                                   # warm-up: every shape once
    t_start = time.perf_counter()
    setup_s = ctx.clock()
    outs = []
    while True:
        outs.append(call(len(outs)))
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    window_s = time.perf_counter() - t_start
    n = len(outs)
    rec = {"setup_s": setup_s, "window_s": window_s,
           "units": {"recon": n * B},
           "attempted": n * B,
           "failed": int(sum((~np.isfinite(o).all(axis=-1)).sum()
                             for o in outs)),
           "forward_rows": n * tr["steps"] * 2 * tr["avg_seeds"] * B,
           "rows_per_forward": 2 * tr["avg_seeds"] * B}
    rec["memory_peak_bytes"] = ctx.memory_peak()
    if ctx.trace:
        before = port.launch_counts()

        def window():
            for k in range(tr["trace_calls"]):
                call(n + k)
            return {}

        rec.update(traced(window))
        after = port.launch_counts()
        rec["trace"]["launches"] = {k: after[k] - before[k] for k in after}
    # the reference, on a call of the window drawn from the seed, once the
    # program's state is freed
    i = int(np.random.default_rng(inputs.mix(ctx.seed, "check")).integers(n))
    j = i % pool
    del model, fn
    ctx.free()
    t_ref = time.perf_counter()
    rows = slice(j * B, (j + 1) * B)
    want = reference(ctx, params,
                     torch.as_tensor(cond[rows], device=ctx.device),
                     torch.as_tensor(sig[rows], device=ctx.device),
                     inputs.call_seed(ctx.seed, i))
    got = torch.as_tensor(outs[i], device=ctx.device)
    rec["numbers"] = {"rel_err": rel_err(got, want)}
    rec["reference_s"] = time.perf_counter() - t_ref
    return rec
