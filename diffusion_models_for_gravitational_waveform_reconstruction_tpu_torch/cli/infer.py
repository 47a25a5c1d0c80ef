"""Inference CLI: reconstruct strain from one measurement with a diffusion
checkpoint (counterpart of the JAX package's ``cli/infer.py``, with the same
flags, defaults, artifacts and printed lines).

    python -m diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli.infer \\
        --model ckpt.msgpack --input-npy y.npy --fs 4096 --outdir out

The measurement comes from ``--input-h5 --index`` (needs ``h5py``) or
``--input-npy --fs``; the architecture, the whitening domain and the sigma
mode come from the checkpoint's args.  Artifacts in ``--outdir``:
``recon_<tag>.npy`` (strain), ``recon_spread_<tag>.npy`` (seed scatter,
``--avg-seeds`` > 1), ``measurement_<tag>.npy``, ``clean_<tag>.npy``,
``proxy_<tag>.npy``, ``metrics_<tag>.json``, the per-step JSONL
(``--log-jsonl``) and, with ``--plot``, PNGs.

``--device`` defaults to the GPU and never falls back to the CPU; ``--seed``
seeds a ``torch.Generator`` on that device.  ``--amp``, ``--selfcond-ema``
and ``--save-every`` are accepted and ignored.  ``--tiled-chunk`` N
evaluates the U-Net in halo tiles of N samples (``parallel/seqtile.py``),
for segments longer than one forward can take.  Under ``torchrun`` every
process joins the group (``multihost_init``) and runs the same
reconstruction on its own GPU, as JAX's processes do; only rank 0 writes
files.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gw-infer", description="Waveform reconstruction via diffusion.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    src = p.add_argument_group("Input")
    src.add_argument("--input-h5", type=str, default=None)
    src.add_argument("--input-npy", type=str, default=None)
    src.add_argument("--index", type=int, default=0)
    src.add_argument("--fs", type=float, default=4096.0,
                     help="Sampling rate for --input-npy.")
    p.add_argument("--model", type=str, required=True,
                   help="Checkpoint path (.msgpack, or a reference .pth).")
    p.add_argument("--outdir", type=str, default="infer_out")
    p.add_argument("--device", type=str, default=None,
                   help="'cuda' (the default; an error without a GPU) or "
                        "'cpu' (the plain PyTorch path).")
    p.add_argument("--amp", action="store_true",
                   help="(ignored; a bf16 checkpoint runs in bf16)")
    p.add_argument("--use-ema", dest="use_ema", action="store_true", default=True)
    p.add_argument("--no-use-ema", dest="use_ema", action="store_false")
    p.add_argument("--seed", type=int, default=0)

    s = p.add_argument_group("Sampler")
    s.add_argument("--sampler", choices=["ddim", "ddpm", "dpmpp"], default="ddim",
                   help="ddim (reference parity) | ddpm (ancestral) | "
                        "dpmpp (DPM-Solver++(2M), best quality at low steps)")
    s.add_argument("--steps", type=int, default=None,
                   help="Default: checkpoint's distilled_steps if distilled, else 200.")
    s.add_argument("--eta", type=float, default=0.0)
    s.add_argument("--start-t", type=int, default=None)
    s.add_argument("--start-snr", type=float, default=None)
    s.add_argument("--init-mode", choices=["noise", "scaled-noise", "y-blend"],
                   default="noise")
    s.add_argument("--x0-std-est", type=float, default=0.14)
    s.add_argument("--dc-weight", type=float, default=0.0)
    s.add_argument("--cond-scale", type=float, default=1.0)
    s.add_argument("--eps-scale", type=float, default=1.0)
    s.add_argument("--pred-type", choices=["eps", "x0", "v"], default=None,
                   help="Default: inherited from the checkpoint.")
    s.add_argument("--cfg-scale", type=float, default=None,
                   help="Default: 1.0 for distilled checkpoints (guidance folded in), else 1.5.")
    s.add_argument("--cfg-mode", choices=["const", "tophat", "gauss"],
                   default="const")
    s.add_argument("--cfg-center", type=float, default=0.70)
    s.add_argument("--cfg-width", type=float, default=0.12)
    s.add_argument("--cfg-u-only-thresh", type=float, default=0.05)
    s.add_argument("--selfcond-ema", type=float, default=0.0,
                   help="(accepted for parity; self-cond channel is updated "
                   "every step)")
    s.add_argument("--oracle-init", action="store_true")
    s.add_argument("--tiled-chunk", type=int, default=0,
                   help="Evaluate the U-Net in halo tiles of this length "
                        "(sequence-parallel long-segment path; 0 = off).")
    s.add_argument("--ladder", choices=["t", "lambda"], default=None,
                   help="Timestep ladder: 't' = reference-parity linspace in "
                        "t; 'lambda' = uniform in log-SNR (better low-step "
                        "quality; measured +0.09 corr at 20 steps). Default: "
                        "'lambda' for --sampler dpmpp (whose multistep "
                        "coefficients need even lambda spacing), else 't'.")
    s.add_argument("--avg-seeds", type=int, default=1,
                   help="Average this many independent-noise reconstructions "
                        "(one batched scan; sampler noise averages down "
                        "~1/sqrt(N) while the conditioned signal is "
                        "coherent). 1 = off.")
    s.add_argument("--avg-mode", choices=["mean", "median", "mf"],
                   default="mean",
                   help="Seed aggregate: 'median' is outlier-robust; 'mf' "
                        "weights seeds by matched-filter data consistency "
                        "with the measurement (ops.sampling."
                        "aggregate_seeds).")
    s.add_argument("--amp-calib", choices=["none", "mf"], default="none",
                   help="'mf': rescale the whitened recon by the least-"
                        "squares matched-filter amplitude against the "
                        "measurement (fixes the shape-right/amplitude-low "
                        "failure mode of v-pred models).")
    s.add_argument("--refine-passes", type=int, default=0,
                   help="Iterative refinement: after the base pass, re-noise "
                        "the recon to --refine-t (forward q_sample) and "
                        "re-run the sampler over [refine_t..0], this many "
                        "times (SDEdit-style resampling). 0 = off.")
    s.add_argument("--refine-t", type=int, default=300)
    s.add_argument("--refine-steps", type=int, default=0,
                   help="Steps per refinement pass (0 = --steps // 2).")

    d = p.add_argument_group("Domain (default: inherited from the checkpoint "
                             "args so inference matches training)")
    d.add_argument("--whiten", type=int, default=None)
    d.add_argument("--whiten-mode",
                   choices=["auto", "model", "welch", "train"], default=None)
    d.add_argument("--sigma-mode", choices=["std", "mad", "fixed"],
                   default=None)
    d.add_argument("--sigma-fixed", type=float, default=None)
    d.add_argument("--allow-domain-mismatch", action="store_true",
                   help="Permit an explicit --whiten-mode that differs from "
                        "the checkpoint's trained domain (parity tests).")

    o = p.add_argument_group("Output / scoring")
    o.add_argument("--plot", action="store_true")
    o.add_argument("--xcorr-window-samp", type=int, default=0)
    o.add_argument("--score-secs", type=float, default=0.8)
    o.add_argument("--run-tag", type=str, default=None)
    o.add_argument("--save-every", type=int, default=0, help="(parity; unused)")
    o.add_argument("--debug", action="store_true")
    o.add_argument("--log-jsonl", type=str, default=None)
    o.add_argument("--log-interval", type=int, default=1)

    x = p.add_argument_group("One-step proxy")
    x.add_argument("--one-step-proxy", action="store_true")
    x.add_argument("--target-snr", type=float, default=20.0)
    return p


def _noise(seed: int, device):
    """The sampler's noise and the one-step proxy's: one generator on the
    device seeded with ``--seed``, which the proxy continues."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return g, g


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    if (args.input_h5 is None) == (args.input_npy is None):
        raise SystemExit("provide exactly one of --input-h5 / --input-npy")

    from ..data import hdf5io
    from ..data.pipeline import interp_psd_np
    from ..evals import metrics as M
    from ..inference import (
        apply_distilled_defaults,
        dewhiten_back,
        inherit_whiten_domain,
        load_model,
        make_run_tag,
        prepare_measurement,
        proxy_reconstruct,
        reconstruct,
        resolve_start_t,
    )
    from ..ops.sampling import SamplerConfig
    from ..parallel.mesh import multihost_init, rank0_writes
    from ..utils.device import resolve_device
    from ..utils.jsonl import JsonlLogger

    multihost_init(args.device)
    rank0_writes(args, "outdir", "log_jsonl")
    dev = resolve_device(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    model, schedule, ck = load_model(args.model, use_ema=args.use_ema,
                                     device=dev)
    inherit_whiten_domain(args, ck, where="infer")
    if args.sigma_mode is None:
        args.sigma_mode = str(ck.get("sigma_mode", "std"))
    if args.sigma_fixed is None:
        args.sigma_fixed = float(ck.get("sigma_fixed", 1.0))
    if args.pred_type is None:
        args.pred_type = str(ck.get("pred_type", "eps"))
    apply_distilled_defaults(args, ck)
    meta_scale = ck.get("meta_scale", {}) or {}
    M_SCALE = float(meta_scale.get("M", 80.0))
    Q_SCALE = float(meta_scale.get("q", 10.0))
    cond_in_ch = int(ck.get("cond_in_ch", 1))

    if args.input_h5:
        y, clean, fs, P_model, welch, meta = hdf5io.load_measurement(
            hdf5io.resolve_h5_path(args.input_h5), args.index)
    else:
        y, clean, fs, P_model, welch, meta = hdf5io.load_measurement_npy(
            args.input_npy, args.fs)

    prep = prepare_measurement(
        y, clean, fs, P_model, welch, meta, cond_in_ch=cond_in_ch,
        M_SCALE=M_SCALE, Q_SCALE=Q_SCALE, whiten=bool(args.whiten),
        whiten_mode=args.whiten_mode, sigma_mode=args.sigma_mode,
        sigma_fixed=args.sigma_fixed, ckpt_path=args.model)
    print(f"[infer] L={prep['L']} fs={fs} whiten={prep['whiten_kind_used']} "
          f"sigma={prep['sigma']:.4g}")

    start_t = resolve_start_t(schedule, args.start_t, args.start_snr)
    if (args.init_mode == "noise" and start_t is not None
            and int(start_t) < int(0.8 * schedule.T)):
        print(f"[infer] WARNING: init_mode=noise with start_t={int(start_t)} "
              f"(< 0.8*T={schedule.T}): pure-noise init below the top of the "
              f"chain is a domain mismatch; expect near-zero correlation",
              file=sys.stderr)
    cfg = SamplerConfig(
        steps=args.steps, eta=args.eta, start_t=start_t,
        init_mode=args.init_mode, x0_std_est=args.x0_std_est,
        dc_weight=args.dc_weight, cond_scale=args.cond_scale,
        eps_scale=args.eps_scale, pred_type=args.pred_type,
        use_selfcond=int(ck.get("in_ch", 3)) == (1 + cond_in_ch + 1),
        cfg_scale=args.cfg_scale, cfg_mode=args.cfg_mode,
        cfg_center=args.cfg_center, cfg_width=args.cfg_width,
        cfg_u_only_thresh=args.cfg_u_only_thresh,
        drop_y_only=bool(ck.get("dropout_y_only", True)),
        oracle_init=args.oracle_init,
        selfcond_mode=str(ck.get("selfcond_mode", "update")),
        ladder=args.ladder or ("lambda" if args.sampler == "dpmpp" else "t"),
        refine_passes=args.refine_passes, refine_t=args.refine_t,
        refine_steps=args.refine_steps)

    tag = args.run_tag or make_run_tag(
        args.sampler, cfg, schedule, bool(args.whiten), args.whiten_mode,
        args.sigma_mode)
    logger = JsonlLogger(args.log_jsonl)

    noise, proxy_noise = _noise(args.seed, dev)
    want_spread = args.avg_seeds > 1
    out = reconstruct(
        model, schedule, prep, cfg, noise, sampler=args.sampler,
        collect_diagnostics=bool(args.log_jsonl) or args.debug,
        tiled_chunk=args.tiled_chunk, avg_seeds=args.avg_seeds,
        return_all_seeds=want_spread, amp_calib=args.amp_calib,
        avg_mode=args.avg_mode, device=dev)
    if want_spread:
        x0_raw, x0_white, diag, seeds_white = out
        # the seed scatter: std over the S reconstructions, whitened and
        # (each seed de-whitened) in strain
        spread_white = seeds_white.std(axis=0)
        seeds_raw = np.stack([dewhiten_back(row.astype(np.float64), prep)
                              for row in seeds_white])
        spread_raw = seeds_raw.std(axis=0)
    else:
        x0_raw, x0_white, diag = out
        spread_raw = None

    if diag is not None and args.log_jsonl:
        n_steps = len(diag["t"])
        for i in range(0, n_steps, max(1, args.log_interval)):
            logger.log({"phase": "ddim_step", "i": int(i),
                        "t": int(diag["t"][i]),
                        "alpha_bar": float(diag["alpha_bar"][i]),
                        "cfg_w": float(diag["cfg_w"][i]),
                        "xcorr_vs_y": float(diag["corr"][i].ravel()[0]),
                        "xcorr_lag": float(diag["xcorr_lag"][i].ravel()[0]),
                        "lag": int(diag["lag"][i].ravel()[0])})

    np.save(os.path.join(args.outdir, f"recon_{tag}.npy"), x0_raw)
    if spread_raw is not None:
        np.save(os.path.join(args.outdir, f"recon_spread_{tag}.npy"),
                spread_raw)
    np.save(os.path.join(args.outdir, f"measurement_{tag}.npy"), prep["y_raw"])
    if prep["clean_raw"] is not None:
        np.save(os.path.join(args.outdir, f"clean_{tag}.npy"), prep["clean_raw"])

    results = {"tag": tag, "sigma": prep["sigma"], "L": prep["L"], "fs": fs,
               "whiten_kind": prep["whiten_kind_used"],
               "start_t": -1 if start_t is None else int(start_t)}
    if spread_raw is not None:
        results["seed_spread"] = {
            "n_seeds": int(args.avg_seeds),
            "strain_rms": float(np.sqrt(np.mean(spread_raw ** 2))),
            "white_rms": float(np.sqrt(np.mean(spread_white ** 2))),
            "rel": float(np.sqrt(np.mean(spread_raw ** 2))
                         / (np.sqrt(np.mean(x0_raw ** 2)) + 1e-300)),
        }
    # residual whiteness needs no clean signal: the quality signal on real
    # measurements
    band = None
    if prep.get("P_model_used") is not None:
        Pm = np.asarray(prep["P_model_used"], np.float64)
        if len(Pm) == prep["L"] // 2 + 1:
            band = Pm > 0
    results["residuals"] = M.residual_diagnostics(
        prep["y_for_cond"], x0_white,
        clean_white=prep["clean_for_cond"], band_mask=band)

    if prep["clean_raw"] is not None:
        m_strain = M.score_last_window(x0_raw, prep["clean_raw"], fs,
                                       args.score_secs)
        results["strain"] = m_strain
        if prep["clean_for_cond"] is not None:
            results["white"] = M.score_last_window(
                x0_white, prep["clean_for_cond"], fs, args.score_secs)
        a_al, b_al, t_al = M.align_xcorr(
            prep["clean_raw"], x0_raw, 1.0 / fs,
            args.xcorr_window_samp or int(0.02 * fs))
        results["merger"] = M.merger_window_scores(b_al, a_al, t_al,
                                                   prep["sigma"])
        if P_model is not None:
            # matched-filter SNR of the recon against the clean template
            # under the model PSD, beside the injected SNR
            P = interp_psd_np(P_model, len(P_model), prep["L"], fs)
            rho_rec = M.matched_filter_snr(x0_raw, prep["clean_raw"], P, fs)
            rho_inj = M.matched_filter_snr(prep["clean_raw"],
                                           prep["clean_raw"], P, fs)
            results["mf_snr"] = {"recovered": rho_rec, "injected": rho_inj,
                                 "ratio": rho_rec / max(rho_inj, 1e-30)}
        print(f"[infer] corr_last={m_strain['corr_last']:.4f} "
              f"mae_last={m_strain['mae_last']:.4e} "
              f"merger_nmae_sigma={results['merger']['nmae_sigma']:.4f}"
              + (f" mf_snr_ratio={results['mf_snr']['ratio']:.4f}"
                 if "mf_snr" in results else ""))

    if args.one_step_proxy and prep["clean_norm"] is not None:
        x0_proxy = proxy_reconstruct(model, schedule, prep, cfg, proxy_noise,
                                     args.target_snr, device=dev)
        np.save(os.path.join(args.outdir, f"proxy_{tag}.npy"), x0_proxy)
        results["proxy"] = M.score_last_window(x0_proxy, prep["clean_raw"], fs,
                                               args.score_secs)

    with open(os.path.join(args.outdir, f"metrics_{tag}.json"), "w") as fh:
        json.dump(results, fh, indent=2)

    if args.plot:
        _plots(args, prep, x0_raw, fs, tag, spread_raw=spread_raw)
    print(f"[infer] artifacts -> {args.outdir} (tag={tag})")


def _plots(args, prep, x0_raw, fs, tag, spread_raw=None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..evals import metrics as M

    L = prep["L"]
    t = np.arange(L) / fs
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(t, prep["y_raw"], lw=0.3, alpha=0.5, label="measurement")
    if prep["clean_raw"] is not None:
        ax.plot(t, prep["clean_raw"], lw=0.8, label="clean")
    ax.plot(t, x0_raw, lw=0.8, label="recon")
    if spread_raw is not None:
        ax.fill_between(t, x0_raw - 2 * spread_raw, x0_raw + 2 * spread_raw,
                        alpha=0.25, linewidth=0,
                        label=f"±2σ seed scatter (n={args.avg_seeds})")
    ax.legend()
    ax.set_xlabel("t [s]")
    fig.savefig(os.path.join(args.outdir, f"overlay_{tag}.png"), dpi=120)
    plt.close(fig)

    if prep["clean_raw"] is not None:
        a_al, b_al, t_al = M.align_xcorr(prep["clean_raw"], x0_raw, 1.0 / fs,
                                         int(0.02 * fs))
        fig, ax = plt.subplots(figsize=(10, 4))
        ax.plot(t_al, a_al, lw=0.8, label="clean (aligned)")
        ax.plot(t_al, b_al, lw=0.8, label="recon (aligned)")
        ax.set_xlim(-0.25, 0.1)
        ax.legend()
        ax.set_xlabel("t - t_merger [s]")
        fig.savefig(os.path.join(args.outdir, f"xcorr_{tag}.png"), dpi=120)
        plt.close(fig)


if __name__ == "__main__":
    main(sys.argv[1:])
