"""Sweep CLI — sampler hyperparameter search in grid or random mode
(counterpart of the JAX package's ``cli/sweep.py``: the same flags,
defaults and artifacts).

    python -m diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli.sweep \\
        --input-h5 corpus.npz --model ck.msgpack --grid --grid-steps 10

``--input-h5`` takes an HDF5 corpus (needs h5py) or its ``.npz`` twin.
``--device`` takes ``cuda`` (the default: the GPU, an error without one) or
``cpu``; ``--seed`` seeds a ``torch.Generator`` on that device, so the
draws differ from the JAX package's.  ``--amp`` is accepted and ignored.
Under ``torchrun`` every process joins the group (``multihost_init``) and
runs the same sweep on its own GPU, as JAX's processes do; only rank 0
writes files.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gw-sweep",
        description="Sweep DDIM sampler knobs; emits grid_results.json / "
                    "coarse_top.json / final_results.json / best_cmd.txt.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--input-h5", type=str, required=True)
    p.add_argument("--indices", type=int, nargs="+", default=[0, 1, 2, 3])
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--outdir", type=str, default="sweep_out")
    p.add_argument("--device", type=str, default=None,
                   help="'cuda' (the default; an error without a GPU) or "
                        "'cpu' (the plain PyTorch path).")
    p.add_argument("--amp", action="store_true", help="(ignored; bf16)")
    p.add_argument("--seed", type=int, default=0)

    p.add_argument("--whiten", type=int, default=None,
                   help="default: inherited from the checkpoint")
    p.add_argument("--whiten-mode",
                   choices=["auto", "model", "welch", "train"], default=None)
    p.add_argument("--sigma-mode", choices=["std", "mad", "fixed"],
                   default=None)
    p.add_argument("--sigma-fixed", type=float, default=None,
                   help="Default: inherited from the checkpoint.")
    p.add_argument("--allow-domain-mismatch", action="store_true",
                   help="Permit an explicit --whiten-mode that differs from "
                        "the checkpoint's trained domain (parity tests).")

    v = p.add_argument_group("Validation gate")
    v.add_argument("--val-samples", type=int, default=16,
                   help="Score the winning combo vs reference-default knobs "
                        "on this many HELD-OUT samples before emitting "
                        "best_cmd.txt; the losing combo is never shipped "
                        "(few-sample sweeps demonstrably overfit). 0 "
                        "disables the gate.")
    v.add_argument("--val-indices", type=int, nargs="+", default=None,
                   help="Explicit held-out sample indices for the gate "
                        "(default: first --val-samples indices disjoint "
                        "from --indices).")

    g = p.add_argument_group("Grid mode")
    p.add_argument("--grid", action="store_true",
                   help="Exhaustive product sweep instead of random search.")
    g.add_argument("--grid-steps", type=int, default=None,
                   help="DDIM steps for grid-mode evaluation (ref "
                        "sweep_infer.py:132, default 200 there). Evaluate at "
                        "the DEPLOYMENT step count to avoid knob-transfer "
                        "failure. Unset: falls back to --steps-coarse.")
    g.add_argument("--grid-snr", type=float, nargs="+", default=[4.0, 8.0, 16.0])
    g.add_argument("--grid-cfg", type=float, nargs="+", default=[1.0, 1.5, 2.0])
    g.add_argument("--grid-init", type=str, nargs="+",
                   default=["noise", "scaled-noise"])
    g.add_argument("--grid-dc", type=float, nargs="+", default=[0.0, 0.1])
    g.add_argument("--grid-eta", type=float, nargs="+", default=[0.0])

    r = p.add_argument_group("Random mode")
    r.add_argument("--n-coarse", type=int, default=64)
    r.add_argument("--topk", type=int, default=5)
    r.add_argument("--sampler", choices=["ddim", "ddpm", "dpmpp"],
                   default="ddim")
    r.add_argument("--ladder", choices=["t", "lambda"], default=None,
                   help="Default: 'lambda' for --sampler dpmpp, else 't'.")
    r.add_argument("--refine-passes", type=int, default=0,
                   help="Iterative refinement passes applied to every combo "
                        "evaluation (fixed, not swept). 0 = off.")
    r.add_argument("--refine-t", type=int, default=300)
    r.add_argument("--refine-steps", type=int, default=0,
                   help="Steps per refinement pass (0 = steps // 2).")
    r.add_argument("--steps-coarse", type=int, default=100)
    r.add_argument("--steps-refine", type=int, default=200)
    r.add_argument("--seeds-refine", type=int, default=3)
    r.add_argument("--start-snr-min", type=float, default=2.0)
    r.add_argument("--start-snr-max", type=float, default=40.0)
    r.add_argument("--cfg-min", type=float, default=0.8)
    r.add_argument("--cfg-max", type=float, default=3.0)
    r.add_argument("--cfg-mode", choices=["const", "tophat", "gauss"],
                   default="const")
    r.add_argument("--cfg-center-min", type=float, default=0.5)
    r.add_argument("--cfg-center-max", type=float, default=0.9)
    r.add_argument("--cfg-width-min", type=float, default=0.05)
    r.add_argument("--cfg-width-max", type=float, default=0.3)
    r.add_argument("--dc-choices", type=float, nargs="+", default=[0.0, 0.05, 0.1])
    r.add_argument("--init-choices", type=str, nargs="+",
                   default=["noise", "scaled-noise", "y-blend"])
    r.add_argument("--eta-choices", type=float, nargs="+", default=[0.0, 0.25])
    return p


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the sweep; returns the shipped top entry."""
    args = build_parser().parse_args(argv)

    from ..data.hdf5io import resolve_h5_path
    from ..evals import sweep
    from ..inference import load_model
    from ..parallel.mesh import multihost_init, rank0_writes
    from ..utils.device import resolve_device
    from .grid import _inherit_domain_flags

    multihost_init(args.device)
    rank0_writes(args, "outdir")
    dev = resolve_device(args.device)
    args.input_h5 = resolve_h5_path(args.input_h5)
    model, schedule, ck = load_model(args.model, device=dev)
    _inherit_domain_flags(args, ck)
    preps = sweep.prep_samples(args.input_h5, args.indices, ck, args.model,
                               bool(args.whiten), args.whiten_mode,
                               args.sigma_mode, args.sigma_fixed)
    run = sweep.run_grid if args.grid else sweep.run_random
    top = run(args, model, schedule, ck, preps, sweep._noise(args.seed, dev),
              device=dev)
    print(f"[sweep] BEST J={top['J']:.4f} combo={top['combo']}")
    print(f"[sweep] artifacts -> {args.outdir}")
    return top


if __name__ == "__main__":
    main(sys.argv[1:])
