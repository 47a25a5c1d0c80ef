"""Spin-conditioning sensitivity of a checkpoint: the port's twin of the
root ``tools/spin_sensitivity.py``.

Does a model's reconstruction use the spin1z / spin2z conditioning
channels?  For N held-out samples it reconstructs with (a) the true
metadata stack and (b) the same stack with the spin channels zeroed, and
compares the correlation against clean.  A spin-blind model shows no gap;
a spin-aware one scores worse when its spin conditioning is withheld.

    python -m diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools.spin_sensitivity \
        --input-h5 EVAL.npz --model CKPT [--indices 0 1 ...] [--steps 50] \
        [--avg-seeds 4] [--device cpu]

The corpus is an HDF5 file (which needs h5py) or its ``.npz`` twin.  Each
of the two runs starts its noise afresh from ``--seed`` through one seam,
:func:`_noise`, so both see the same draws and the gap measures only the
conditioning; the tests hand in the JAX package's draws there.  Prints one
JSON line: ``corr_true``, ``corr_spin0``, ``gap``, ``n``, ``per_sample``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

# the sweep's seam: one generator seeded with ``--seed`` on the device; the
# tests replace this module's name
from ..evals.sweep import _noise


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--input-h5", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--indices", type=int, nargs="+", default=None,
                   help="default: 16 spread over the file")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--ladder", choices=["t", "lambda"], default="lambda")
    p.add_argument("--avg-seeds", type=int, default=4)
    p.add_argument("--start-t", type=int, default=999)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    from ..data import hdf5io
    from ..evals import metrics as M
    from ..evals.sweep import prep_samples
    from ..inference import dewhiten_back, load_model, reconstruct_batch
    from ..ops.sampling import SamplerConfig
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    model, schedule, ck = load_model(args.model, device=dev)
    if args.indices is None:
        n = hdf5io.num_samples(args.input_h5)
        args.indices = list(np.linspace(0, n - 1, min(16, n)).astype(int))

    preps = prep_samples(
        args.input_h5, args.indices, ck, args.model,
        bool(ck.get("whiten", True)), str(ck.get("whiten_mode", "model")),
        str(ck.get("sigma_mode", "std")), float(ck.get("sigma_fixed", 1.0)))

    use_selfcond = (int(ck.get("in_ch", 3))
                    == (1 + int(ck.get("cond_in_ch", 1)) + 1))
    cfg = SamplerConfig(
        steps=args.steps, start_t=args.start_t, ladder=args.ladder,
        pred_type=str(ck.get("pred_type", "eps")),
        drop_y_only=bool(ck.get("dropout_y_only", True)),
        use_selfcond=use_selfcond)

    # meta channel order is [m1/M, m2/M, s1, s2, ...] (inference.meta_to_stack)
    def run(zero_spins: bool):
        out = {}
        by_len = {}
        for i, pr in enumerate(preps):
            by_len.setdefault(pr["L"], []).append(i)
        draw = _noise(args.seed, dev)          # afresh for each run
        for L, idxs in sorted(by_len.items()):
            conds = np.concatenate([preps[i]["cond_stack"] for i in idxs])
            if zero_spins and conds.shape[1] >= 5:
                conds = conds.copy()
                conds[:, 3:5, :] = 0.0        # s1, s2 channels (after y)
            sig = np.array([preps[i]["sigma"] for i in idxs], np.float32)
            cn = np.concatenate([preps[i]["clean_norm"] for i in idxs])
            rows = len(idxs) * max(1, args.avg_seeds)
            xw = reconstruct_batch(model, schedule, conds, sig, cfg,
                                   draw((rows, 1, L)), clean_norms=cn,
                                   avg_seeds=args.avg_seeds, device=dev)
            for j, i in enumerate(idxs):
                pr = preps[i]
                x0_raw = dewhiten_back(xw[j].astype(np.float64), pr)
                out[i] = M.score_last_window(x0_raw, pr["clean_raw"],
                                             pr["fs"])["corr_last"]
        return [out[i] for i in range(len(preps))]

    corr_true = run(zero_spins=False)
    corr_zero = run(zero_spins=True)
    res = {
        "corr_true": float(np.mean(corr_true)),
        "corr_spin0": float(np.mean(corr_zero)),
        "gap": float(np.mean(corr_true) - np.mean(corr_zero)),
        "n": len(preps),
        "per_sample": [
            {"index": int(ix), "corr_true": float(a), "corr_spin0": float(b)}
            for ix, a, b in zip(args.indices, corr_true, corr_zero)],
    }
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
