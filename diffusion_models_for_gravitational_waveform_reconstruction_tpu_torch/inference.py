"""Reconstruction engine: checkpoint -> model on the device -> float64 host
whitening -> conditioned sampling -> de-whitened strain (counterpart of the
JAX package's ``inference.py``).

- :func:`load_model` rebuilds the U-Net from the checkpoint's args alone
  (EMA weights preferred) on the device; reference ``.pth`` checkpoints
  convert through ``utils/torch_compat.py``.
- :func:`prepare_measurement` whitens in float64 on the host (model PSD,
  saved or fresh Welch PSD, train-like periodogram, or raw), picks sigma
  with per-domain fallbacks, and stacks the metadata channels.
- :func:`reconstruct` samples one prepared measurement (optionally S seeds
  in one batch, with per-step diagnostics), and :func:`reconstruct_batch`
  B measurements at once; both return whitened reconstructions, and
  :func:`dewhiten_back` takes them back to strain.

Noise is a ``torch.Generator`` on the device, or :class:`FixedNoise` (or a
list with one per sampler pass: the base pass's, then one per refinement
pass) holding draws made elsewhere.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .data.pipeline import (
    dewhiten_weight_np,
    pick_sigma_np,
    whiten_model_np,
    whiten_train_like_np,
    whiten_weight_np,
    whiten_welch_np,
)
from .models.unet import UNet1D
from .parallel import mesh as pmesh
from .parallel.seqtile import tiled_apply
from .ops.sampling import (SAMPLERS, Noise, RankNoise, SamplerConfig,
                           aggregate_seeds, one_step_proxy,
                           sample_with_refinement)
from .ops.schedules import make_schedule, snr_from_alpha_bar, t_for_target_snr
from .utils.checkpoint import load_checkpoint, select_weights
from .utils.device import resolve_device
from .utils.weights import params_from_flax

SIGMA_FALLBACK = {"train": 2.914e-12, "welch": 2.914e-16, "model": 2.914e-16,
                  "raw": 2.914e-12}


# ---------------------------------------------------------------------------
# Model loading
# ---------------------------------------------------------------------------

def _unet_from_args(ck: dict, device, *, use_attention: bool, bf16: bool):
    in_ch = int(ck.get("in_ch", 3))
    cond_in_ch = int(ck.get("cond_in_ch", 1))
    T = int(ck.get("T", 1000))
    return UNet1D(
        in_ch=in_ch,
        base_ch=int(ck.get("base_ch", 64)),
        time_dim=int(ck.get("time_dim", 128)),
        depth=int(ck.get("depth", 3)),
        t_embed_max_time=max(0, T - 1),
        cond_in_ch=cond_in_ch,
        use_selfcond=in_ch == (1 + cond_in_ch + 1),
        use_attention=use_attention,
        dtype=torch.bfloat16 if bf16 else None,
        device=device)


def model_from_checkpoint(ckpt: dict, use_ema: bool = True, device=None):
    """The U-Net of a checkpoint already read by ``load_checkpoint``, rebuilt
    from its args on ``device`` in eval mode; returns ``(model, used_ema)``."""
    ck = ckpt["args"]
    weights, used_ema = select_weights(ckpt, use_ema=use_ema)
    model = _unet_from_args(
        ck, resolve_device(device),
        use_attention=bool(ck.get("use_attention", False)),
        bf16=bool(ck.get("bf16", False)))
    model.load_state_dict(params_from_flax(weights), strict=True)
    return model.eval(), used_ema


def load_model(ckpt_path: str, use_ema: bool = True, device=None):
    """Rebuild the U-Net and schedule from a checkpoint's args; returns
    ``(model, schedule, ck_args)`` with the model on ``device`` (default:
    the GPU) in eval mode.  ``.msgpack`` checkpoints of this format and
    reference torch ``.pth`` checkpoints are both accepted; the ``.pth``
    branch builds an f32 model without attention, as the JAX package does."""
    dev = resolve_device(device)
    if ckpt_path.endswith((".pth", ".pt")):
        from .utils.torch_compat import load_torch_checkpoint_as_flax

        weights, ck, used_ema = load_torch_checkpoint_as_flax(
            ckpt_path, use_ema=use_ema)
        model = _unet_from_args(ck, dev, use_attention=False, bf16=False)
        model.load_state_dict(params_from_flax(weights), strict=True)
        model.eval()
        print(f"[infer] converted torch checkpoint {ckpt_path} "
              f"({'EMA' if used_ema else 'raw'})")
    else:
        ckpt = load_checkpoint(ckpt_path)
        ck = ckpt["args"]
        model, used_ema = model_from_checkpoint(ckpt, use_ema, dev)
        print(f"[infer] loaded {'EMA' if used_ema else 'raw'} weights from "
              f"{ckpt_path}")
    schedule = make_schedule(int(ck.get("T", 1000)), ck.get("schedule", "cosine"))
    return model, schedule, ck


# ---------------------------------------------------------------------------
# Metadata stack
# ---------------------------------------------------------------------------

def meta_to_stack(meta: dict, L: int, cond_in_ch: int, M_SCALE: float,
                  Q_SCALE: float) -> Optional[np.ndarray]:
    """(cond_in_ch - 1, L) channels in the fixed order [m1, m2, s1, s2, q,
    Mc]; masses and chirp mass / M_SCALE, q clipped to [0, Q_SCALE] /
    Q_SCALE, zero channels past the sixth."""
    C = max(0, cond_in_ch - 1)
    if C <= 0:
        return None

    def tile(v):
        return np.full((L,), float(v), np.float32)

    qv = meta.get("q", 0.0)
    if not np.isfinite(qv):
        qv = 0.0
    rows = [
        tile(meta.get("mass1", 0.0) / max(M_SCALE, 1e-9)),
        tile(meta.get("mass2", 0.0) / max(M_SCALE, 1e-9)),
        tile(meta.get("spin1z", 0.0)),
        tile(meta.get("spin2z", 0.0)),
        tile(min(max(qv, 0.0), Q_SCALE) / max(Q_SCALE, 1e-9)),
        tile(meta.get("chirp_mass", 0.0) / max(M_SCALE, 1e-9)),
    ]
    arr = np.stack(rows[:C], axis=0)
    if arr.shape[0] < C:
        arr = np.concatenate(
            [arr, np.zeros((C - arr.shape[0], L), np.float32)], axis=0)
    return arr


# ---------------------------------------------------------------------------
# Knob resolution against the checkpoint
# ---------------------------------------------------------------------------

def apply_distilled_defaults(args, ck: dict) -> None:
    """Resolve unset (None) sampler knobs against a checkpoint's deployment
    contract, in place: a distilled checkpoint's recorded steps, ladder and
    start t with CFG folded in (cfg_scale 1), otherwise steps 200 and
    cfg_scale 1.5.  Values already set always win."""
    dist = "distilled_steps" in ck
    if getattr(args, "steps", None) is None:
        args.steps = int(ck["distilled_steps"]) if dist else 200
        if dist:
            print(f"[infer] distilled checkpoint: steps={args.steps} "
                  f"(ladder={ck.get('distilled_ladder')}, CFG folded)")
    if getattr(args, "cfg_scale", None) is None:
        args.cfg_scale = 1.0 if dist else 1.5
    if dist and getattr(args, "ladder", None) is None:
        args.ladder = str(ck.get("distilled_ladder", "lambda"))
    if (dist and getattr(args, "start_t", None) is None
            and ck.get("distilled_start_t") is not None):
        args.start_t = int(ck["distilled_start_t"])


def inherit_whiten_domain(args, ck: dict, where: str = "infer") -> None:
    """Resolve ``args.whiten`` / ``args.whiten_mode`` against the domain the
    checkpoint TRAINED in, in place.  ``whiten_mode_resolved`` (the
    pipeline's actual domain) wins over the requested ``whiten_mode``.  An
    explicit mode that contradicts the training domain raises
    ``ValueError`` unless ``args.allow_domain_mismatch`` is set."""
    resolved = str(ck.get("whiten_mode_resolved", "") or "")
    if getattr(args, "whiten", None) is None:
        args.whiten = int(bool(ck.get("whiten", False)))
    if getattr(args, "whiten_mode", None) is None:
        if resolved in ("model", "welch", "train"):
            args.whiten_mode = resolved
            requested = str(ck.get("whiten_mode", resolved))
            if requested not in ("", "auto", resolved):
                print(f"[{where}] NOTE: checkpoint requested whiten_mode="
                      f"'{requested}' but actually TRAINED in '{resolved}' "
                      f"— evaluating in the trained domain",
                      file=sys.stderr, flush=True)
        else:
            args.whiten_mode = str(ck.get("whiten_mode", "auto"))
    elif (bool(args.whiten) and resolved in ("model", "welch", "train")
          and args.whiten_mode not in ("auto", resolved)):
        msg = (f"[{where}] eval whiten_mode='{args.whiten_mode}' does not "
               f"match the checkpoint's training domain '{resolved}' — "
               f"reconstructions would be evaluated in the wrong domain")
        if getattr(args, "allow_domain_mismatch", False):
            print(msg + " (allowed by --allow-domain-mismatch)",
                  file=sys.stderr, flush=True)
        else:
            raise ValueError(msg + "; pass --allow-domain-mismatch to force")


def sigma_fallbacks(ckpt_path: Optional[str]) -> Dict[str, float]:
    """Per-domain sigma fallbacks, overridden by the ``median`` entries of a
    ``fallback_sigma.json`` beside the checkpoint when one is readable."""
    fallback = dict(SIGMA_FALLBACK)
    if ckpt_path:
        try:
            with open(os.path.join(os.path.dirname(ckpt_path),
                                   "fallback_sigma.json")) as fh:
                fb = json.load(fh)
            for k in list(fallback.keys()):
                if k in fb and "median" in fb[k]:
                    fallback[k] = float(fb[k]["median"])
        except (OSError, ValueError, TypeError, KeyError):
            pass
    return fallback


# ---------------------------------------------------------------------------
# Measurement preparation
# ---------------------------------------------------------------------------

def prepare_measurement(
    y_raw: np.ndarray,
    clean_raw: Optional[np.ndarray],
    fs: float,
    P_model: Optional[np.ndarray],
    welch_in: Tuple[Optional[np.ndarray], Optional[np.ndarray]],
    meta: dict,
    *,
    cond_in_ch: int,
    M_SCALE: float = 80.0,
    Q_SCALE: float = 10.0,
    whiten: bool = False,
    whiten_mode: str = "auto",
    sigma_mode: str = "std",
    sigma_fixed: float = 1.0,
    ckpt_path: Optional[str] = None,
) -> dict:
    """Whiten (float64), normalise by sigma and stack one measurement.

    ``whiten_mode`` 'auto' prefers model -> saved Welch -> train; 'model'
    without a model PSD degrades to train (with a warning); 'welch' uses the
    dataset's saved Welch PSD when there is one, else a fresh Welch estimate
    of the measurement.  A sigma that is not finite or below 1e-20 falls
    back to the domain's entry of :func:`sigma_fallbacks`."""
    from numpy.fft import irfft, rfft, rfftfreq
    from scipy.signal import welch as scipy_welch

    L = len(y_raw)
    fw_in, Pw_in = welch_in
    kind = "raw"
    P_train = freqs_P = P_model_used = None
    y_c, clean_c = y_raw, clean_raw

    if whiten:
        mode = whiten_mode
        if mode == "auto":
            if P_model is not None:
                mode = "model"
            elif fw_in is not None and Pw_in is not None:
                mode = "saved-welch"
            else:
                mode = "train"
        if mode == "model" and P_model is None:
            print("[inference] WARNING: whiten_mode='model' requested but no "
                  "model PSD is available (saved or derivable) — degrading "
                  "to TRAIN-LIKE whitening; the eval domain is 'train'.",
                  file=sys.stderr, flush=True)
            mode = "train"
        if mode == "welch" and fw_in is not None and Pw_in is not None:
            # a welch-trained checkpoint saw the dataset's saved PSD; a fresh
            # estimate from the signal-containing measurement would put it
            # in another domain
            mode = "saved-welch"
        if mode == "model":
            x = clean_raw if clean_raw is not None else np.zeros_like(y_raw)
            y_c, clean_c, P_model_used = whiten_model_np(y_raw, x, P_model, fs,
                                                         eps=1e-12)
            clean_c = clean_c if clean_raw is not None else None
            kind = "model"
        elif mode == "saved-welch":
            f_tgt = rfftfreq(L, 1.0 / fs)
            P = np.interp(f_tgt, fw_in, Pw_in, left=Pw_in[0], right=Pw_in[-1])
            w = whiten_weight_np(P)
            Y = rfft(y_raw.astype(np.float64))
            y_c = irfft(Y * w, n=L).astype(np.float32)
            if clean_raw is not None:
                X = rfft(clean_raw.astype(np.float64))
                clean_c = irfft(X * w, n=L).astype(np.float32)
            else:
                clean_c = None
            freqs_P = (f_tgt, P)
            kind = "welch"
        elif mode == "welch":
            f_w, P_w = scipy_welch(y_raw, fs=fs, nperseg=min(4096, L))
            x = clean_raw if clean_raw is not None else np.zeros_like(y_raw)
            y_c, clean_c, P = whiten_welch_np(y_raw, x, f_w, P_w, fs, eps=1e-12)
            clean_c = clean_c if clean_raw is not None else None
            freqs_P = (rfftfreq(L, 1.0 / fs), P)
            kind = "welch"
        else:  # 'train'
            x = clean_raw if clean_raw is not None else np.zeros_like(y_raw)
            y_c, clean_c, P_train = whiten_train_like_np(y_raw, x)
            clean_c = clean_c if clean_raw is not None else None
            kind = "train"

    sigma = pick_sigma_np(np.asarray(y_c), sigma_mode, sigma_fixed)
    fb = sigma_fallbacks(ckpt_path)
    if (not np.isfinite(sigma)) or sigma < 1e-20:
        sigma = fb.get(kind, fb["train"])
        print(f"[warn] sigma degenerate; fallback={sigma:.3e} (mode={kind})")

    y_norm = (np.asarray(y_c) / sigma).astype(np.float32)[None, None, :]
    clean_norm = None
    if clean_c is not None:
        clean_norm = (np.asarray(clean_c) / sigma).astype(np.float32)[None, None, :]

    if cond_in_ch <= 1:
        cond_stack = y_norm
    else:
        arr = meta_to_stack(meta, L, cond_in_ch, M_SCALE, Q_SCALE)
        if arr is None:
            arr = np.zeros((cond_in_ch - 1, L), np.float32)
        cond_stack = np.concatenate([y_norm, arr[None]], axis=1)

    return {
        "y_raw": y_raw, "clean_raw": clean_raw, "y_for_cond": np.asarray(y_c),
        "clean_for_cond": (np.asarray(clean_c) if clean_c is not None else None),
        "y_norm": y_norm, "clean_norm": clean_norm, "cond_stack": cond_stack,
        "sigma": float(sigma), "fs": float(fs), "L": L,
        "whiten_kind_used": kind, "P_train": P_train, "freqs_P": freqs_P,
        "P_model_used": P_model_used,
    }


def mf_amp_calibrate(x0_white: np.ndarray, y_white: np.ndarray,
                     clip: tuple = (0.25, 4.0)):
    """Rescale a whitened reconstruction by the least-squares matched-filter
    amplitude ``s = <y, x> / <x, x>`` (float64, clipped).  Returns
    (calibrated x0_white, s)."""
    x = np.asarray(x0_white, np.float64).ravel()
    y = np.asarray(y_white, np.float64).ravel()
    den = float(np.dot(x, x))
    if den <= 0.0 or not np.isfinite(den):
        return x0_white, 1.0
    s = float(np.dot(y, x) / den)
    if not np.isfinite(s):
        return x0_white, 1.0
    s = float(np.clip(s, *clip))
    return (np.asarray(x0_white) * s).astype(np.asarray(x0_white).dtype), s


def dewhiten_back(x: np.ndarray, prep: dict) -> np.ndarray:
    """Invert the whitening :func:`prepare_measurement` applied: the exact
    in-band inverse (out-of-band bins stay zero)."""
    from numpy.fft import irfft, rfft

    kind = prep["whiten_kind_used"]
    L = len(x)
    if kind == "train":
        return irfft(rfft(x) * np.sqrt(prep["P_train"]), n=L)
    if kind == "welch":
        _, P = prep["freqs_P"]
        return irfft(rfft(x) * dewhiten_weight_np(P), n=L)
    if kind == "model":
        return irfft(rfft(x) * dewhiten_weight_np(prep["P_model_used"]), n=L)
    return x


# ---------------------------------------------------------------------------
# Reconstruction
# ---------------------------------------------------------------------------

def resolve_start_t(schedule, start_t: Optional[int],
                    start_snr: Optional[float]):
    """A start SNR wins over a start t."""
    if start_snr is not None:
        return t_for_target_snr(schedule, start_snr)
    return start_t


def make_run_tag(mode: str, cfg: SamplerConfig, schedule, whiten: bool,
                 whiten_mode: str, sigma_mode: str) -> str:
    """The run tag spelled from the knob values ('.' written 'p')."""
    start_t_eff = (schedule.T - 1) if cfg.start_t is None else int(cfg.start_t)
    snr_eff = snr_from_alpha_bar(schedule.alpha_bar)[start_t_eff]
    tag = (f"{mode}_t{start_t_eff}_snr{snr_eff:.1f}_steps{cfg.steps}"
           f"_eta{cfg.eta}_cfg{cfg.cfg_scale}_cfgmode-{cfg.cfg_mode}"
           f"_ctr{cfg.cfg_center}_w{cfg.cfg_width}_init-{cfg.init_mode}"
           f"_pred-{cfg.pred_type}_dc{cfg.dc_weight}_cond{cfg.cond_scale}"
           f"_eps{cfg.eps_scale}_{'white' if whiten else 'raw'}"
           f"_{whiten_mode}_{sigma_mode}")
    if cfg.refine_passes > 0:
        tag += f"_ref{cfg.refine_passes}x{cfg.refine_t}"
    return tag.replace(".", "p")


def reconstruct(model, schedule, prep: dict, cfg: SamplerConfig, noise, *,
                sampler: str = "ddim", collect_diagnostics: bool = False,
                tiled_chunk: int = 0, mesh=None, avg_seeds: int = 1,
                return_all_seeds: bool = False, amp_calib: str = "none",
                avg_mode: str = "mean", device=None):
    """Sample one prepared measurement; returns ``(x0_raw strain, x0_white,
    diagnostics or None)``, and the per-seed whitened reconstructions
    (S, L) as a 4th element with ``return_all_seeds``.

    ``avg_seeds`` S > 1 samples S rows of the measurement in one batch and
    aggregates them with ``avg_mode``.  ``collect_diagnostics`` (DDIM) logs
    the base pass; refinement passes run after it.  ``amp_calib="mf"``
    rescales by the matched-filter amplitude against ``y_for_cond``.
    ``noise`` is a ``torch.Generator`` on ``device``, a ``FixedNoise``, or a
    list with one per pass.

    ``tiled_chunk`` > 0 evaluates the U-Net in halo tiles of that length
    (``parallel/seqtile.py``), for segments longer than one forward can
    take; with ``mesh`` (``parallel.mesh.make_mesh``) the tiles are spread
    over its data axis, and every rank samples the same noise and returns
    the same reconstruction.  Without tiling ``mesh`` is not used, as in
    the JAX package."""
    if mesh is not None:
        pmesh.check_mesh(mesh)
    model_fn = model
    if tiled_chunk > 0:
        def model_fn(x, t):
            return tiled_apply(model, x, t, chunk=tiled_chunk, mesh=mesh)
    dev = resolve_device(device)
    cond = torch.as_tensor(prep["cond_stack"], dtype=torch.float32, device=dev)
    clean_norm = (torch.as_tensor(prep["clean_norm"], dtype=torch.float32,
                                  device=dev)
                  if prep["clean_norm"] is not None else None)
    # always cfg.x0_std_est: the batch path has no oracle access either
    x0_std = cfg.x0_std_est
    S = max(1, int(avg_seeds))
    if S > 1:
        cond = cond.repeat(S, 1, 1)
        if clean_norm is not None:
            clean_norm = clean_norm.repeat(S, 1, 1)

    diagnostics = sampler == "ddim" and collect_diagnostics
    out = sample_with_refinement(SAMPLERS[sampler], model_fn, schedule, cond,
                                 cfg, noise, clean_norm=clean_norm,
                                 x0_std_est=x0_std,
                                 collect_diagnostics=diagnostics)
    x0_norm, diag = out if diagnostics else (out, None)

    seeds_white = None
    if S > 1:
        if return_all_seeds:
            seeds_white = x0_norm[:, 0, :].cpu().numpy() * prep["sigma"]
        x0_norm = aggregate_seeds(x0_norm[:, None], avg_mode,
                                  y_norm=cond[:1, 0, :])
    x0_white = x0_norm.reshape(-1).cpu().numpy() * prep["sigma"]
    if amp_calib == "mf":
        x0_white, s_cal = mf_amp_calibrate(x0_white, prep["y_for_cond"])
        if seeds_white is not None:
            seeds_white = seeds_white * s_cal
    x0_raw = dewhiten_back(x0_white, prep)
    if return_all_seeds:
        return x0_raw, x0_white, diag, seeds_white
    return x0_raw, x0_white, diag


def reconstruct_batch(model, schedule, cond_stacks, sigmas,
                      cfg: SamplerConfig, noise: Noise, *,
                      clean_norms=None, sampler: str = "ddim", mesh=None,
                      avg_seeds: int = 1, amp_calib: str = "none",
                      extra_models: Optional[Sequence] = None,
                      avg_mode: str = "mean", return_seed_std: bool = False,
                      device=None):
    """Sample B measurements ``cond_stacks`` (B, cond_in_ch, L) with per-row
    ``sigmas`` (B,); returns whitened reconstructions (B, L) as numpy.

    ``avg_seeds`` S > 1 tiles the batch seed-major (row s*B + b is seed s of
    measurement b) and aggregates with ``avg_mode``.  ``extra_models`` are
    ensembled with ``model``; every member samples with the same noise.
    ``noise`` is a ``torch.Generator`` on ``device`` or a ``FixedNoise``.
    With ``return_seed_std`` (S > 1) also returns the per-element seed std
    (B, L), rescaled with the same MF calibration as the aggregate.

    With ``mesh`` (``parallel.mesh.make_mesh``) the B*S rows, which must
    split evenly, are spread over its data axis: each rank samples its rows
    with its rows of the global noise draws, the members' weights are
    broadcast from data rank 0, and every rank gathers all rows and returns
    the same result as the call without a mesh.  A model axis splits
    nothing here: each of its ranks samples its data index's rows with the
    whole model (JAX replicates the parameters for sampling), so a model
    that a tensor-parallel run trained serves as it is.
    """
    if mesh is not None:
        pmesh.check_mesh(mesh)
    dev = resolve_device(device)
    sample_fn = SAMPLERS[sampler]
    cond = torch.as_tensor(np.asarray(cond_stacks), dtype=torch.float32,
                           device=dev)
    cn = (torch.as_tensor(np.asarray(clean_norms), dtype=torch.float32,
                          device=dev) if clean_norms is not None else None)
    B = cond.shape[0]
    S = max(1, int(avg_seeds))
    cond_all = cond
    if S > 1:
        cond_all = cond.repeat(S, 1, 1)
        if cn is not None:
            cn = cn.repeat(S, 1, 1)
    members = [model] + list(extra_models or [])
    cond_rows = cond_all
    if mesh is not None:
        cond_rows = pmesh.local_rows(mesh, cond_all)
        cn = pmesh.local_rows(mesh, cn) if cn is not None else None
        pmesh.replicate_tree(members, mesh)
    state = noise.get_state() if isinstance(noise, torch.Generator) else None
    x0_norm = None
    for m in members:
        if state is not None:
            noise.set_state(state)
        z = noise if mesh is None else RankNoise(noise, mesh.rank, mesh.n_data)
        out = sample_with_refinement(sample_fn, m, schedule, cond_rows, cfg,
                                     z, clean_norm=cn)
        x0_norm = out if x0_norm is None else x0_norm + out
    x0_norm = x0_norm / len(members)
    if mesh is not None:
        x0_norm = pmesh.gather_rows(mesh, x0_norm)
    sig = np.asarray(sigmas)
    std_white = None
    if S > 1:
        per_seed = x0_norm.reshape(S, B, *x0_norm.shape[1:])
        if return_seed_std:
            std_white = (per_seed.std(dim=0, correction=0)[:, 0, :]
                         .cpu().numpy() * sig[:, None])
        x0_norm = aggregate_seeds(per_seed, avg_mode, y_norm=cond[:, 0, :])
    x0_white = x0_norm[:, 0, :].cpu().numpy() * sig[:, None]
    if amp_calib == "mf":
        y_white = np.asarray(cond_stacks)[:, 0, :] * sig[:, None]
        for i in range(x0_white.shape[0]):
            x0_white[i], s_cal = mf_amp_calibrate(x0_white[i], y_white[i])
            if std_white is not None:
                std_white[i] = std_white[i] * s_cal
    if return_seed_std:
        return x0_white, std_white
    return x0_white


def proxy_reconstruct(model, schedule, prep: dict, cfg: SamplerConfig,
                      noise: Noise, target_snr: float = 20.0,
                      device=None) -> np.ndarray:
    """The one-step proxy (``ops.sampling.one_step_proxy``) of a prepared
    measurement with a clean reference, de-whitened to strain."""
    dev = resolve_device(device)
    x0_norm = one_step_proxy(
        model, schedule,
        torch.as_tensor(prep["clean_norm"], dtype=torch.float32, device=dev),
        torch.as_tensor(prep["cond_stack"], dtype=torch.float32, device=dev),
        target_snr, cfg, noise)
    x0_white = x0_norm.reshape(-1).cpu().numpy() * prep["sigma"]
    return dewhiten_back(x0_white, prep)
