"""Mass-grid evaluation CLI — per-(m1, m2) reconstruction-quality heatmaps
(counterpart of the JAX package's ``cli/grid.py``: the same flags,
defaults and artifacts).

    python -m diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli.grid \\
        --input-h5 corpus.npz --model ck.msgpack --from-sweep sweep_out

``--input-h5`` takes an HDF5 corpus (needs h5py) or its ``.npz`` twin.
``--device`` takes ``cuda`` (the default: the GPU, an error without one) or
``cpu``; ``--seed`` seeds the cell selection (numpy, as the JAX package
does) and a ``torch.Generator`` on that device for the sampler.  ``--amp``
and ``--metrics`` are accepted and ignored.  The heatmap PNGs need
matplotlib; without it every CSV and JSON is still written.  Multi-host
initialisation is not called: multi-GPU runs are not ported (ROADMAP.md
P10).
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gw-grid",
        description="Evaluate reconstruction quality over the dataset's "
                    "(m1, m2) mass grid; emits CSVs, heatmap PNGs, "
                    "summary.json.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--input-h5", type=str, required=True)
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--outdir", type=str, default="grid_out")
    p.add_argument("--device", type=str, default=None,
                   help="'cuda' (the default; an error without a GPU) or "
                        "'cpu' (the plain PyTorch path).")
    p.add_argument("--amp", action="store_true", help="(ignored; bf16)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--from-sweep", type=str, default=None,
                   help="Sweep output dir; knobs read from its artifacts.")

    s = p.add_argument_group("Sampler knobs (override --from-sweep)")
    s.add_argument("--steps", type=int, default=None,
                   help="Default: checkpoint's distilled_steps if distilled, else 200.")
    s.add_argument("--sampler", choices=["ddim", "ddpm", "dpmpp"],
                   default="ddim")
    s.add_argument("--ladder", choices=["t", "lambda"], default=None,
                   help="Default: 'lambda' for --sampler dpmpp, else 't'.")
    s.add_argument("--eval-scan-cap", type=int, default=None,
                   help="Max samples per reconstruction call (each "
                        "--avg-seeds rows); default: sized to the card's "
                        "free memory, no cap on the CPU.")
    s.add_argument("--avg-seeds", type=int, default=1,
                   help="Average N independent-noise reconstructions per "
                        "sample (batched into one scan).")
    s.add_argument("--avg-mode", choices=["mean", "median", "mf"],
                   default="mean",
                   help="Seed aggregate: 'median' is outlier-robust; 'mf' "
                        "weights seeds by matched-filter data consistency "
                        "with the measurement (ops.sampling."
                        "aggregate_seeds).")
    s.add_argument("--amp-calib", choices=["none", "mf"], default="none",
                   help="'mf': least-squares matched-filter amplitude "
                        "rescaling of each whitened recon against its "
                        "measurement.")
    s.add_argument("--refine-passes", type=int, default=0,
                   help="Iterative refinement: re-noise each recon to "
                        "--refine-t and re-run the sampler, N times. 0=off.")
    s.add_argument("--refine-t", type=int, default=300)
    s.add_argument("--refine-steps", type=int, default=0,
                   help="Steps per refinement pass (0 = steps // 2).")
    s.add_argument("--eta", type=float, default=0.0)
    s.add_argument("--start-snr", type=float, default=8.0,
                   help="Reference-parity default TRUNCATES the trajectory "
                        "(starts at the t where SNR(t)=8). Models trained "
                        "for full-range sampling (t_min_frac=0, esp. "
                        "pred_type=v) score much better with a high value "
                        "or an explicit --start-t.")
    s.add_argument("--start-t", type=int, default=None)
    s.add_argument("--init-mode", choices=["noise", "scaled-noise", "y-blend"],
                   default="noise")
    s.add_argument("--cfg-scale", type=float, default=None,
                   help="Default: 1.0 for distilled checkpoints (guidance folded in), else 1.5.")
    s.add_argument("--cfg-mode", choices=["const", "tophat", "gauss"],
                   default="const")
    s.add_argument("--cfg-center", type=float, default=0.70)
    s.add_argument("--cfg-width", type=float, default=0.12)
    s.add_argument("--dc-weight", type=float, default=0.0)

    d = p.add_argument_group("Domain (default: inherited from the checkpoint, "
                             "like gw-infer)")
    d.add_argument("--whiten", type=int, default=None)
    d.add_argument("--whiten-mode",
                   choices=["auto", "model", "welch", "train"], default=None)
    d.add_argument("--sigma-mode", choices=["std", "mad", "fixed"],
                   default=None)
    d.add_argument("--sigma-fixed", type=float, default=None,
                   help="Default: inherited from the checkpoint.")

    w = p.add_argument_group("Scoring")
    w.add_argument("--unordered", action="store_true",
                   help="Fold cells to m2 <= m1.")
    w.add_argument("--win", choices=["full", "tail", "merger"], default="tail")
    w.add_argument("--tail-secs", type=float, default=0.8)
    w.add_argument("--left", type=float, default=0.08)
    w.add_argument("--right", type=float, default=0.04)
    w.add_argument("--align", choices=["none", "peak", "xcorr"], default="none")
    w.add_argument("--align-max-shift-s", type=float, default=0.02)
    w.add_argument("--mae-norm", choices=["sigma", "clean"], default="sigma")
    w.add_argument("--metrics", type=str, nargs="+", default=["corr", "mae"],
                   help="(parity; both are always computed)")
    w.add_argument("--per-cell", type=int, default=4)
    w.add_argument("--min-per-cell", type=int, default=1)
    w.add_argument("--max-cells", type=int, default=400,
                   help="Random-subsample cells beyond this count (random-"
                        "mass datasets degenerate into one cell per sample; "
                        "the reference would evaluate them all).")

    v = p.add_argument_group("Plot cosmetics")
    v.add_argument("--xlabel", type=str, default="m1 [Msun]")
    v.add_argument("--ylabel", type=str, default="m2 [Msun]")
    v.add_argument("--title-corr", type=str, default="corr (mean per cell)")
    v.add_argument("--title-mae", type=str, default="normalised MAE (mean)")
    v.add_argument("--annot", action="store_true")
    v.add_argument("--annot-fmt", type=str, default="%.2f")
    v.add_argument("--annot-div", type=float, default=1.0)
    v.add_argument("--tick-fmt", type=str, default="%.0f")
    v.add_argument("--max-ticks-x", type=int, default=12)
    v.add_argument("--max-ticks-y", type=int, default=12)
    v.add_argument("--gridlines", action="store_true")
    v.add_argument("--gridline-alpha", type=float, default=0.15)
    v.add_argument("--gridline-width", type=float, default=0.5)
    p.add_argument("--allow-domain-mismatch", action="store_true",
                   help="Permit an explicit --whiten-mode that differs from "
                        "the checkpoint's trained domain (parity tests).")
    return p


def _inherit_domain_flags(args, ck: dict) -> None:
    """Unset domain flags inherit the checkpoint's training domain (the
    contract of gw-infer): a whiten-trained model evaluated on raw strain
    scores garbage silently."""
    from ..inference import inherit_whiten_domain
    inherit_whiten_domain(args, ck, where="grid")
    if args.sigma_mode is None:
        args.sigma_mode = str(ck.get("sigma_mode", "std"))
    if getattr(args, "sigma_fixed", None) is None:
        # a 'fixed'-sigma checkpoint evaluated with the default 1.0 would be
        # a silent domain mismatch
        args.sigma_fixed = float(ck.get("sigma_fixed", 1.0))


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the evaluation; returns {"summary": summary.json's content,
    "scan_caps": {L: samples per reconstruction call}}."""
    args = build_parser().parse_args(argv)

    from ..data.hdf5io import load_labels, resolve_h5_path
    from ..evals import sweep
    from ..evals.grid import (
        aggregate_and_plot,
        eval_indices,
        parse_sweep_best,
        select_per_cell,
    )
    from ..inference import apply_distilled_defaults, load_model
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.from_sweep:
        knobs = parse_sweep_best(args.from_sweep)
        cli = build_parser().parse_args(argv)   # re-parse for explicit flags
        defaults = build_parser().parse_args(
            ["--input-h5", args.input_h5, "--model", args.model])
        for k, v in knobs.items():
            # CLI value wins only if it differs from the parser default
            if hasattr(args, k) and getattr(cli, k) == getattr(defaults, k):
                setattr(args, k, v)
        print(f"[grid] knobs from sweep {args.from_sweep}: {knobs}")

    args.input_h5 = resolve_h5_path(args.input_h5)
    rng = np.random.default_rng(args.seed)
    m1, m2, snr = load_labels(args.input_h5)

    cells = select_per_cell(m1, m2, args.per_cell, args.min_per_cell, rng,
                            args.unordered)
    if args.max_cells and len(cells) > args.max_cells:
        keep = rng.choice(len(cells), size=args.max_cells, replace=False)
        keys = list(cells.keys())
        cells = {keys[i]: cells[keys[i]] for i in sorted(keep)}
        print(f"[grid] subsampled to {len(cells)} cells (--max-cells)")
    indices = np.concatenate([v for v in cells.values()]) if cells else []
    print(f"[grid] {len(cells)} cells, {len(indices)} samples selected")
    if len(indices) == 0:
        raise SystemExit("no cells satisfy --min-per-cell")

    # --model accepts comma-separated checkpoints: the first is primary
    # (domain flags, schedule); the rest are ensembled in reconstruct_batch
    # (same sampling noise per member, average of predictions)
    model_paths = [p for p in args.model.split(",") if p]
    args.model = model_paths[0]
    model, schedule, ck = load_model(args.model, device=dev)
    _inherit_domain_flags(args, ck)
    apply_distilled_defaults(args, ck)
    extra_models = []
    for mp in model_paths[1:]:
        e_model, _e_sched, e_ck = load_model(mp, device=dev)
        for k2 in ("pred_type", "T", "whiten", "whiten_mode", "sigma_mode",
                   "sigma_fixed", "in_ch", "cond_in_ch", "schedule"):
            if str(e_ck.get(k2)) != str(ck.get(k2)):
                raise SystemExit(
                    f"gw-grid: ensemble member {mp} disagrees with primary "
                    f"on {k2} ({e_ck.get(k2)!r} vs {ck.get(k2)!r}) — members "
                    f"must share the sampling/conditioning domain")
        # the cond stack is built once with the PRIMARY's meta_scale — a
        # member trained with different normalisation would silently see
        # mis-scaled m1/m2/q/Mc channels
        ms_p, ms_e = ck.get("meta_scale") or {}, e_ck.get("meta_scale") or {}
        for k2 in set(ms_p) | set(ms_e):
            if not np.isclose(float(ms_p.get(k2, 0.0)),
                              float(ms_e.get(k2, 0.0)), rtol=1e-3):
                raise SystemExit(
                    f"gw-grid: ensemble member {mp} disagrees with primary "
                    f"on meta_scale[{k2!r}] ({ms_e.get(k2)} vs {ms_p.get(k2)})"
                    f" — conditioning channels would be mis-scaled")
        extra_models.append(e_model)
    if extra_models:
        args._extra_models = extra_models
        print(f"[grid] ensembling {len(model_paths)} checkpoints")
    preps = sweep.prep_samples(args.input_h5, indices, ck, args.model,
                               bool(args.whiten), args.whiten_mode,
                               args.sigma_mode, args.sigma_fixed)
    if preps:
        args._whiten_kind_used = preps[0].get("whiten_kind_used")
    rows = eval_indices(args, model, schedule, ck, preps,
                        sweep._noise(args.seed, dev), device=dev)
    if not rows:
        raise SystemExit(
            "gw-grid: no scorable samples — none of the selected indices "
            "carry a clean signal in the dataset (eval_indices skips "
            "samples without one). A mass-grid evaluation needs a dataset "
            "written with clean signals (gw-gen stores them by default).")

    labels = {int(i): {"m1": float(m1[i]), "m2": float(m2[i]),
                       **({"snr": float(snr[i])} if snr is not None else {})}
              for i in indices}
    if args.unordered:
        for i in labels:
            a, b = labels[i]["m1"], labels[i]["m2"]
            labels[i].update(m1=max(a, b), m2=min(a, b))
    summary = aggregate_and_plot(args, rows, labels)
    # mae is PHYSICAL-strain scale (~1e-21) unless --mae-norm rescales it
    extra = (f" mf_ratio_macro={summary['mf_ratio_macro_mean']:.4f}"
             if "mf_ratio_macro_mean" in summary else "")
    print(f"[grid] summary: corr_macro={summary['corr_macro_mean']:.4f} "
          f"mae_macro={summary['mae_macro_mean']:.4g}"
          f"{extra} whiten={summary.get('whiten_kind_used')}")
    print(f"[grid] artifacts -> {args.outdir}")
    return {"summary": summary, "scan_caps": args._scan_caps}


if __name__ == "__main__":
    main(sys.argv[1:])
