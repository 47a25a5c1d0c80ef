"""The readings that a cell's correctness limits are set from, made on the
chip at the cell's own size; the benchmark's runs do not run this.

    python3 -m gwbench.control --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --out readings.jsonl

For each seed the program's numbers against the float32 reference (the
lower reading: the first call of the window); for each control seed also
the control's, the reference computed with float8 e4m3 activations and
weights put in the program's place (the upper reading).  One JSON line per
seed.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from . import cell, inputs
from .drivers import serve_batch
from .reference import rounding

# the control: float8 e4m3 activations and weights
CONTROL = "float8_e4m3"


def recon_readings(ctx, control: bool) -> dict:
    tr = ctx.traffic
    B = tr["measurements_per_call"]
    params, model, fn, cond, sig = serve_batch.setup(ctx)
    got = fn(model, cond[:B], sig[:B], inputs.call_seed(ctx.seed, 0))
    got = got.detach().clone()
    del model, fn
    ctx.free()
    c = torch.as_tensor(cond[:B], device=ctx.device)
    s = torch.as_tensor(sig[:B], device=ctx.device)
    seed0 = inputs.call_seed(ctx.seed, 0)
    want = serve_batch.reference(ctx, params, c, s, seed0)
    out = {"program": {"rel_err": serve_batch.rel_err(got, want)}}
    if control:
        low = serve_batch.reference(ctx, params, c, s, seed0,
                                    cast=rounding(CONTROL))
        out["control"] = {"rel_err": serve_batch.rel_err(low, want)}
    return out


def _card(ctx) -> str:
    return (torch.cuda.get_device_name(ctx.device)
            if ctx.device.type == "cuda" else "cpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds:
        t0 = time.time()
        ctx = cell.context(args.workload, seed, 0.0, False)
        row = {"workload": args.workload, "seed": seed,
               **recon_readings(ctx, seed in ctl),
               "seconds": time.time() - t0, "card": _card(ctx)}
        with open(args.out, "a") as fh:
            fh.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
        ctx.free()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
