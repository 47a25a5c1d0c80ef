"""Glitch robustness of a checkpoint: the port's twin of the root
``tools/glitch_robustness.py``.

Real strain holds non-Gaussian transients ("glitches") that the training
noise never shows the model.  For each requested glitch SNR a
sine-Gaussian, ``g(t) = exp(-(t - t0)^2 / (2 tau^2)) sin(2 pi f0 (t - t0))``
with ``tau = Q / (2 pi f0)``, is scaled in float64 to that matched-filter
SNR against the measurement's model PSD and added to the raw noisy strain;
then the deployment pipeline runs (``prepare_measurement`` in the
checkpoint's domain, batched sampling on the device, de-whitening) and the
reconstruction is scored (corr against clean) with the no-clean
residual-whiteness diagnostic (``res_flatness``) that a deployment would
have to rely on.  One placement per sample, shared across the SNR levels.

    python -m diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools.glitch_robustness \
        --input-h5 EVAL.npz --model CKPT [--glitch-snr 0 4 8 16] \
        [--indices ...] [--steps 50] [--device cpu]

The corpus is an HDF5 file (which needs h5py) or its ``.npz`` twin.  The
sampler noise of each length bucket comes from one seam, :func:`_noise`
(one generator seeded with ``--seed`` on the device, continued by every
call), so the tests can hand in the JAX package's draws.  Prints one JSON
document with the root tool's keys: per glitch SNR the mean corr /
res_flatness / res_clean_corr and per-sample rows.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

# the sweep's seam (one generator seeded with ``--seed`` on the device,
# continued by every call); the tests replace this module's name
from ..evals.sweep import _noise


def sine_gaussian(L: int, fs: float, t0: float, f0: float, q: float) -> np.ndarray:
    """Unit-amplitude sine-Gaussian at center t0 (seconds), f64."""
    t = np.arange(L, dtype=np.float64) / fs
    tau = q / (2.0 * np.pi * f0)
    return np.exp(-((t - t0) ** 2) / (2.0 * tau ** 2)) * np.sin(
        2.0 * np.pi * f0 * (t - t0))


def mf_snr_vs_psd(x: np.ndarray, P: np.ndarray, fs: float) -> float:
    """Matched-filter SNR of ``x`` against one-sided PSD ``P`` (f64):
    snr^2 = 4 sum |X(f)|^2 / P(f) df with X = rfft(x) dt (the convention
    of the corpus's injected SNRs).  Zero-PSD bins (below f_lower) carry
    no weight."""
    x = np.asarray(x, np.float64)
    P = np.asarray(P, np.float64)
    dt = 1.0 / fs
    X = np.fft.rfft(x) * dt
    df = fs / len(x)
    good = P > 0
    return float(np.sqrt(4.0 * np.sum(np.abs(X[good]) ** 2 / P[good]) * df))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--input-h5", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--indices", type=int, nargs="+", default=None,
                   help="default: 12 spread over the file")
    p.add_argument("--glitch-snr", type=float, nargs="+",
                   default=[0.0, 4.0, 8.0, 16.0])
    p.add_argument("--f0-min", type=float, default=80.0)
    p.add_argument("--f0-max", type=float, default=300.0)
    p.add_argument("--q", type=float, default=9.0)
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
    from ..inference import (dewhiten_back, load_model, prepare_measurement,
                             reconstruct_batch)
    from ..ops.sampling import SamplerConfig
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    model, schedule, ck = load_model(args.model, device=dev)
    if args.indices is None:
        n = hdf5io.num_samples(args.input_h5)
        args.indices = list(np.linspace(0, n - 1, min(12, n)).astype(int))

    meta_scale = ck.get("meta_scale", {}) or {}
    use_selfcond = (int(ck.get("in_ch", 3))
                    == (1 + int(ck.get("cond_in_ch", 1)) + 1))
    cfg = SamplerConfig(
        steps=args.steps, start_t=args.start_t, ladder=args.ladder,
        pred_type=str(ck.get("pred_type", "eps")),
        drop_y_only=bool(ck.get("dropout_y_only", True)),
        use_selfcond=use_selfcond)

    raw = hdf5io.load_measurements(args.input_h5,
                                   [int(i) for i in args.indices])
    rng = np.random.default_rng(args.seed)
    # one placement per sample, shared across the SNR levels so that the
    # level axis isolates amplitude; away from the segment edges, where the
    # whitening FFT wraps
    placements = []
    for (y, _, fs, _, _, _) in raw:
        L = len(y)
        placements.append((
            float(rng.uniform(0.15, 0.85) * L / fs),
            float(rng.uniform(args.f0_min, args.f0_max)),
        ))

    draw = _noise(args.seed, dev)
    levels = []
    for gsnr in args.glitch_snr:
        preps = []
        for (y, clean, fs, P_model, welch, meta), (t0, f0) in zip(
                raw, placements):
            y_g = np.asarray(y, np.float64)
            if gsnr > 0:
                if P_model is None:
                    raise SystemExit(
                        "glitch SNR scaling needs a model PSD (dataset has "
                        "none and none derivable)")
                g = sine_gaussian(len(y), fs, t0, f0, args.q)
                s = mf_snr_vs_psd(g, P_model, fs)
                y_g = y_g + g * (gsnr / s)
            preps.append(prepare_measurement(
                y_g, clean, fs, P_model, welch, meta,
                cond_in_ch=int(ck.get("cond_in_ch", 1)),
                M_SCALE=float(meta_scale.get("M", 80.0)),
                Q_SCALE=float(meta_scale.get("q", 10.0)),
                whiten=bool(ck.get("whiten", True)),
                whiten_mode=str(ck.get("whiten_mode_resolved", "")
                                or ck.get("whiten_mode", "model")),
                sigma_mode=str(ck.get("sigma_mode", "std")),
                sigma_fixed=float(ck.get("sigma_fixed", 1.0)),
                ckpt_path=args.model))

        by_len = {}
        for i, pr in enumerate(preps):
            by_len.setdefault(pr["L"], []).append(i)
        out_corr, out_flat, out_ccorr = {}, {}, {}
        for L, idxs in sorted(by_len.items()):
            conds = np.concatenate([preps[i]["cond_stack"] for i in idxs])
            sig = np.array([preps[i]["sigma"] for i in idxs], np.float32)
            cn = np.concatenate([preps[i]["clean_norm"] for i in idxs])
            rows = len(idxs) * max(1, args.avg_seeds)
            xw = reconstruct_batch(model, schedule, conds, sig, cfg,
                                   draw((rows, 1, L)), clean_norms=cn,
                                   avg_seeds=args.avg_seeds, device=dev)
            for j, i in enumerate(idxs):
                pr = preps[i]
                x0w = np.asarray(xw[j], np.float64)
                x0_raw = dewhiten_back(x0w, pr)
                out_corr[i] = M.score_last_window(
                    x0_raw, pr["clean_raw"], pr["fs"])["corr_last"]
                band = None
                if pr.get("P_model_used") is not None:
                    Pm = np.asarray(pr["P_model_used"], np.float64)
                    if len(Pm) == pr["L"] // 2 + 1:
                        band = Pm > 0
                d = M.residual_diagnostics(
                    pr["y_for_cond"], x0w,
                    clean_white=pr["clean_for_cond"], band_mask=band)
                out_flat[i] = d["res_flatness"]
                out_ccorr[i] = d.get("res_clean_corr", float("nan"))
        n = len(preps)
        levels.append({
            "glitch_snr": float(gsnr),
            "corr_mean": float(np.mean([out_corr[i] for i in range(n)])),
            "res_flatness_mean": float(
                np.mean([out_flat[i] for i in range(n)])),
            "res_clean_corr_mean": float(
                np.nanmean([out_ccorr[i] for i in range(n)])),
            "per_sample": [
                {"index": int(ix), "corr": float(out_corr[i]),
                 "res_flatness": float(out_flat[i])}
                for i, ix in enumerate(args.indices)],
        })

    base = levels[0]["corr_mean"] if levels else float("nan")
    res = {
        "model": args.model,
        "knobs": {"steps": args.steps, "ladder": args.ladder,
                  "avg_seeds": args.avg_seeds, "start_t": args.start_t,
                  "q": args.q, "f0": [args.f0_min, args.f0_max]},
        "n": len(args.indices),
        "levels": levels,
        "corr_drop_at_max": float(base - levels[-1]["corr_mean"])
        if levels else float("nan"),
    }
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
