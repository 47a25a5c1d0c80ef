"""Sampler-hyperparameter sweep engine (counterpart of the JAX package's
``evals/sweep.py``, with the same objective, modes, artifacts and gate).

- model + samples are prepared once; each combo reconstructs every prepared
  sample in one batch per length group (``inference.reconstruct_batch``);
- objective J = corr_strain + 0.5 corr_white - 0.1 nmae_sigma;
- grid mode over {start_snr x cfg x init x dc x eta}; random mode: coarse
  draws -> top-k -> refine with several seeds, log-uniform start_snr;
- artifacts ``grid_results.json`` / ``coarse_top.json`` /
  ``final_results.json``, ``validation.json`` (the held-out gate) and a
  replayable ``best_cmd.txt``.

Random start_snr draws are snapped to a start_t grid (multiples of
``START_T_QUANT``), as the JAX package snaps them to bound its recompiles,
so that both packages evaluate the same ladders.

Noise: every ``reconstruct_batch`` call takes its noise from a draw
function, called once per call in the order in which the JAX package
splits its key for its calls (one split per length group within a combo,
one per combo, per coarse draw and per refine seed, then the gate's).  The
draw function comes from the module-level factory :func:`_noise` (the one
seam: the tests replace it to hand over the JAX package's draws); the
default draws every call from one ``torch.Generator`` on the device, seeded
with ``--seed``.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from ..data import hdf5io
from ..inference import dewhiten_back, prepare_measurement, reconstruct_batch
from ..ops.sampling import Noise, SamplerConfig
from ..ops.schedules import t_for_target_snr
from . import metrics as M

START_T_QUANT = 25
INFER_PROG = ("python -m diffusion_models_for_gravitational_waveform_"
              "reconstruction_tpu_torch.cli.infer")

# draw(shape of the batch's x_T, (rows, 1, L)) -> the noise of one
# reconstruct_batch call
DrawNoise = Callable[[tuple], Noise]


def _noise(seed: int, device) -> DrawNoise:
    """The noise of a sweep or grid run: one ``torch.Generator`` on
    ``device`` seeded with ``seed``, which every call continues."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return lambda shape: g


@dataclasses.dataclass
class Combo:
    """One sampler-knob combination under sweep."""

    start_snr: float
    cfg_scale: float
    init_mode: str
    dc_weight: float
    eta: float
    cfg_mode: str = "const"
    cfg_center: float = 0.70
    cfg_width: float = 0.12

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def prep_samples(
    h5_path: str,
    indices: Sequence[int],
    ck: dict,
    ckpt_path: str,
    whiten: bool,
    whiten_mode: str,
    sigma_mode: str,
    sigma_fixed: float = 1.0,
) -> List[dict]:
    """Prepare each requested sample once (whiten/sigma/cond stack); the
    corpus is an HDF5 file or its ``.npz`` twin."""
    meta_scale = ck.get("meta_scale", {}) or {}
    preps = []
    for idx, meas in zip(indices, hdf5io.load_measurements(h5_path, indices)):
        p = prepare_measurement(
            *meas,
            cond_in_ch=int(ck.get("cond_in_ch", 1)),
            M_SCALE=float(meta_scale.get("M", 80.0)),
            Q_SCALE=float(meta_scale.get("q", 10.0)),
            whiten=whiten, whiten_mode=whiten_mode,
            sigma_mode=sigma_mode, sigma_fixed=sigma_fixed,
            ckpt_path=ckpt_path)
        p["index"] = int(idx)
        preps.append(p)
    return preps


def _sampler_config(combo: Combo, steps: int, schedule, ck: dict,
                    use_selfcond: bool,
                    start_t_override: int | None = None,
                    ladder: str = "t",
                    refine: tuple = (0, 300, 0)) -> SamplerConfig:
    """Sampler config for one combo, inheriting checkpoint-domain knobs:
    ``pred_type`` and ``selfcond_mode`` come from the checkpoint; the start
    is the SNR-derived t quantised to ``START_T_QUANT`` unless
    ``start_t_override`` (e.g. gw-grid ``--start-t``) is given."""
    if start_t_override is not None:
        start_t = int(np.clip(start_t_override, 1, schedule.T - 1))
    else:
        start_t = t_for_target_snr(schedule, combo.start_snr)
        start_t = int(np.clip(round(start_t / START_T_QUANT) * START_T_QUANT,
                              START_T_QUANT, schedule.T - 1))
    return SamplerConfig(
        steps=steps, eta=combo.eta, start_t=start_t,
        init_mode=combo.init_mode, dc_weight=combo.dc_weight,
        cfg_scale=combo.cfg_scale, cfg_mode=combo.cfg_mode,
        cfg_center=combo.cfg_center, cfg_width=combo.cfg_width,
        use_selfcond=use_selfcond,
        pred_type=str(ck.get("pred_type", "eps")),
        drop_y_only=bool(ck.get("dropout_y_only", True)),
        # distilled students never saw a non-zero self-cond channel
        selfcond_mode=str(ck.get("selfcond_mode", "update")),
        ladder=ladder,
        refine_passes=int(refine[0]), refine_t=int(refine[1]),
        refine_steps=int(refine[2]))


def refine_from_args(args) -> tuple:
    """(refine_passes, refine_t, refine_steps) from CLI args (0,300,0 = off)."""
    return (int(getattr(args, "refine_passes", 0) or 0),
            int(getattr(args, "refine_t", 300) or 300),
            int(getattr(args, "refine_steps", 0) or 0))


def uses_selfcond(ck: dict) -> bool:
    return int(ck.get("in_ch", 3)) == (1 + int(ck.get("cond_in_ch", 1)) + 1)


def by_length(preps: List[dict]) -> Dict[int, List[int]]:
    """Positions of ``preps`` grouped by sample length."""
    groups: Dict[int, List[int]] = {}
    for i, p in enumerate(preps):
        groups.setdefault(p["L"], []).append(i)
    return groups


def batch_inputs(preps: List[dict], idxs: Sequence[int]):
    """(cond stacks, sigmas, clean_norms or None) of ``preps[idxs]``."""
    conds = np.concatenate([preps[i]["cond_stack"] for i in idxs], axis=0)
    sigmas = np.array([preps[i]["sigma"] for i in idxs], np.float32)
    cleans = [preps[i]["clean_norm"] for i in idxs]
    cn = (np.concatenate(cleans, axis=0)
          if all(c is not None for c in cleans) else None)
    return conds, sigmas, cn


def eval_combo(
    model, schedule, ck: dict,
    preps: List[dict],
    combo: Combo,
    steps: int,
    noise: DrawNoise,
    sampler: str = "ddim",
    ladder: str = "t",
    start_t_override: int | None = None,
    refine: tuple = (0, 300, 0),
    device=None,
) -> dict:
    """Evaluate one combo on all prepared samples (batched per length group,
    one ``noise`` draw per batch).

    Returns {combo, steps, start_t, J, J_std, per_sample}."""
    cfg = _sampler_config(combo, steps, schedule, ck, uses_selfcond(ck),
                          ladder=ladder, start_t_override=start_t_override,
                          refine=refine)
    per_sample = [None] * len(preps)
    for L, idxs in sorted(by_length(preps).items()):
        conds, sigmas, cn = batch_inputs(preps, idxs)
        x0_white = reconstruct_batch(model, schedule, conds, sigmas, cfg,
                                     noise((len(idxs), 1, L)), clean_norms=cn,
                                     sampler=sampler, device=device)
        for j, i in enumerate(idxs):
            p = preps[i]
            x0_raw = dewhiten_back(x0_white[j].astype(np.float64), p)
            m_strain = m_white = None
            if p["clean_raw"] is not None:
                m_strain = M.score_last_window(x0_raw, p["clean_raw"], p["fs"])
                a_al, b_al, t_al = M.align_xcorr(p["clean_raw"], x0_raw,
                                                 1.0 / p["fs"],
                                                 int(0.02 * p["fs"]))
                m_strain.update(M.merger_window_scores(b_al, a_al, t_al,
                                                       p["sigma"]))
            if p["clean_for_cond"] is not None:
                m_white = M.score_last_window(x0_white[j], p["clean_for_cond"],
                                              p["fs"])
            per_sample[i] = {
                "index": p["index"],
                "J": M.sweep_objective(m_strain, m_white),
                "strain": m_strain, "white": m_white,
            }

    Js = [s["J"] for s in per_sample if s is not None]
    return {
        "combo": combo.to_dict(),
        "steps": steps,
        "start_t": cfg.start_t,
        "J": float(np.mean(Js)) if Js else float("nan"),
        "J_std": float(np.std(Js)) if Js else float("nan"),
        "per_sample": per_sample,
    }


def sample_combo(rng: np.random.Generator, args) -> Combo:
    """Random-mode combo draw; start_snr is log-uniform."""
    lo, hi = np.log(args.start_snr_min), np.log(args.start_snr_max)
    return Combo(
        start_snr=float(np.exp(rng.uniform(lo, hi))),
        cfg_scale=float(rng.uniform(args.cfg_min, args.cfg_max)),
        init_mode=str(rng.choice(args.init_choices)),
        dc_weight=float(rng.choice(args.dc_choices)),
        eta=float(rng.choice(args.eta_choices)),
        cfg_mode=args.cfg_mode,
        cfg_center=float(rng.uniform(args.cfg_center_min, args.cfg_center_max)),
        cfg_width=float(rng.uniform(args.cfg_width_min, args.cfg_width_max)),
    )


def best_cmd(args, combo: dict, steps: int,
             start_t_override: int | None = None) -> str:
    """Replayable infer command line: the JAX package's flags in its order;
    the one difference is the program, this package's infer CLI
    (:data:`INFER_PROG`) where the JAX package writes ``gw-infer``."""
    start = (f"--start-t {int(start_t_override)}"
             if start_t_override is not None
             else f"--start-snr {combo['start_snr']:.4g}")
    refine = refine_from_args(args)
    return (
        f"{INFER_PROG} --input-h5 {args.input_h5} --index {args.indices[0]} "
        f"--model {args.model} --outdir {args.outdir}/best "
        f"--steps {steps} --eta {combo['eta']} "
        f"{start} "
        f"--init-mode {combo['init_mode']} --cfg-scale {combo['cfg_scale']:.4g} "
        f"--cfg-mode {combo['cfg_mode']} --cfg-center {combo['cfg_center']:.4g} "
        f"--cfg-width {combo['cfg_width']:.4g} --dc-weight {combo['dc_weight']:.4g} "
        f"--whiten {int(args.whiten)} --whiten-mode {args.whiten_mode} "
        f"--sigma-mode {args.sigma_mode}"
        + (f" --sampler {args.sampler}"
           if getattr(args, "sampler", "ddim") != "ddim" else "")
        + (f" --ladder {args.ladder}" if getattr(args, "ladder", None) else "")
        + (f" --refine-passes {refine[0]} --refine-t {refine[1]}"
           f" --refine-steps {refine[2]}" if refine[0] > 0 else "")
    )


def resolve_ladder(args) -> str:
    """The ladder of every sweep and grid stage: ``--ladder``, else 'lambda'
    for dpmpp (which requires it), else 't'."""
    return (getattr(args, "ladder", None)
            or ("lambda" if getattr(args, "sampler", "ddim") == "dpmpp"
                else "t"))


def default_combo() -> Combo:
    """Reference-default sampler knobs: cfg 1.5 const, eta 0, init from pure
    noise, no data consistency, full-range start (start_t = T-1, applied via
    start_t_override)."""
    return Combo(start_snr=0.0, cfg_scale=1.5, init_mode="noise",
                 dc_weight=0.0, eta=0.0, cfg_mode="const")


def _eval_kw(args, device) -> dict:
    return dict(sampler=getattr(args, "sampler", "ddim"),
                ladder=resolve_ladder(args), refine=refine_from_args(args),
                device=device)


def validate_top(args, model, schedule, ck, top: dict, steps: int,
                 noise: DrawNoise, device=None) -> dict:
    """Held-out validation gate for the selected knobs: score the winning
    combo AND the reference-default knobs on ``--val-samples`` held-out
    samples (disjoint from the sweep indices); ship whichever wins.

    Returns {enabled, emit_top, J_val_top, J_val_default, default_combo,
    default_start_t, val_indices}."""
    n_val = int(getattr(args, "val_samples", 0) or 0)
    if n_val <= 0:
        return {"enabled": False, "emit_top": True}

    val_indices = getattr(args, "val_indices", None)
    if not val_indices:
        n_total = hdf5io.num_samples(args.input_h5)
        excluded = set(int(i) for i in args.indices)
        val_indices = [i for i in range(n_total) if i not in excluded][:n_val]
    if not val_indices:
        print("[sweep] validation gate skipped: no held-out samples")
        return {"enabled": False, "emit_top": True}

    preps_val = prep_samples(args.input_h5, val_indices, ck, args.model,
                             bool(args.whiten), args.whiten_mode,
                             args.sigma_mode, args.sigma_fixed)
    kw = _eval_kw(args, device)
    r_top = eval_combo(model, schedule, ck, preps_val, Combo(**top["combo"]),
                       steps, noise, **kw)
    r_def = eval_combo(model, schedule, ck, preps_val, default_combo(), steps,
                       noise, start_t_override=schedule.T - 1, **kw)
    emit = bool(r_top["J"] >= r_def["J"])
    print(f"[sweep] validation ({len(val_indices)} held-out samples): "
          f"J_top={r_top['J']:.4f} vs J_default={r_def['J']:.4f} -> "
          f"{'top knobs' if emit else 'DEFAULT knobs (top failed to beat '
            'defaults out of sample)'}")
    return {"enabled": True, "emit_top": emit,
            "J_val_top": r_top["J"], "J_val_default": r_def["J"],
            # the knobs the gate shipped when it rejected top: --from-sweep
            # parsers honour the decision
            "default_combo": default_combo().to_dict(),
            "default_start_t": int(schedule.T - 1),
            "val_indices": [int(i) for i in val_indices]}


def _emit_best_cmd(args, model, schedule, ck, top, steps, noise, device=None):
    """Validation-gated best_cmd.txt emission shared by grid/random modes."""
    val = validate_top(args, model, schedule, ck, top, steps, noise, device)
    if val.get("enabled"):
        _dump(args.outdir, "validation.json", val)
    with open(os.path.join(args.outdir, "best_cmd.txt"), "w") as fh:
        if val.get("emit_top", True):
            fh.write(best_cmd(args, top["combo"], steps) + "\n")
        else:
            fh.write(best_cmd(args, default_combo().to_dict(), steps,
                              start_t_override=schedule.T - 1) + "\n")
    return val


def run_grid(args, model, schedule, ck, preps, noise: DrawNoise,
             device=None) -> dict:
    """Exhaustive product sweep at ``--grid-steps`` (else
    ``--steps-coarse``), which is also what ``best_cmd.txt`` replays."""
    results = []
    combos = [
        Combo(start_snr=s, cfg_scale=c, init_mode=i, dc_weight=d, eta=e,
              cfg_mode=args.cfg_mode)
        for s, c, i, d, e in itertools.product(
            args.grid_snr, args.grid_cfg, args.grid_init, args.grid_dc,
            args.grid_eta)
    ]
    grid_steps = int(getattr(args, "grid_steps", None) or args.steps_coarse)
    print(f"[sweep] grid: {len(combos)} combos x {len(preps)} samples "
          f"@ {grid_steps} steps")
    kw = _eval_kw(args, device)
    for n, combo in enumerate(combos):
        r = eval_combo(model, schedule, ck, preps, combo, grid_steps, noise,
                       **kw)
        results.append(r)
        print(f"[sweep] {n + 1}/{len(combos)} J={r['J']:.4f}  {combo.to_dict()}")

    results.sort(key=lambda r: -r["J"])
    # the sampler/ladder the combos were scored under, so --from-sweep
    # replays do not switch algorithms
    for r in results:
        r["sampler"] = kw["sampler"]
        r["ladder"] = kw["ladder"]
    _dump(args.outdir, "grid_results.json", results)
    top = results[0]
    top["validation"] = _emit_best_cmd(args, model, schedule, ck, top,
                                       grid_steps, noise, device)
    return top


def run_random(args, model, schedule, ck, preps, noise: DrawNoise,
               device=None) -> dict:
    """Coarse random search -> top-k refinement."""
    rng = np.random.default_rng(args.seed)
    kw = _eval_kw(args, device)
    coarse = []
    print(f"[sweep] coarse: {args.n_coarse} draws @ {args.steps_coarse} steps")
    for n in range(args.n_coarse):
        combo = sample_combo(rng, args)
        r = eval_combo(model, schedule, ck, preps, combo, args.steps_coarse,
                       noise, **kw)
        coarse.append(r)
        print(f"[sweep] coarse {n + 1}/{args.n_coarse} J={r['J']:.4f}")

    coarse.sort(key=lambda r: -r["J"])
    top_k = coarse[: args.topk]
    _dump(args.outdir, "coarse_top.json", top_k)

    finals = []
    print(f"[sweep] refine: top-{len(top_k)} x {args.seeds_refine} seeds "
          f"@ {args.steps_refine} steps")
    for r in top_k:
        combo = Combo(**r["combo"])
        Js = [eval_combo(model, schedule, ck, preps, combo, args.steps_refine,
                         noise, **kw)["J"] for _ in range(args.seeds_refine)]
        finals.append({"combo": combo.to_dict(),
                       "J": float(np.mean(Js)),
                       "J_std": float(np.std(Js)),
                       "J_seeds": Js,
                       "steps": args.steps_refine})
        print(f"[sweep] refined J={finals[-1]['J']:.4f} "
              f"(+-{finals[-1]['J_std']:.4f}) {combo.to_dict()}")

    finals.sort(key=lambda r: -r["J"])
    for r in finals:
        r["sampler"] = kw["sampler"]
        r["ladder"] = kw["ladder"]
    top = finals[0]
    # the refine results are written BEFORE the gate, whose extra
    # reconstructions must not lose the sweep if they fail
    _dump(args.outdir, "final_results.json", finals)
    top["validation"] = _emit_best_cmd(args, model, schedule, ck, top,
                                       args.steps_refine, noise, device)
    _dump(args.outdir, "final_results.json", finals)
    return top


def _dump(outdir: str, name: str, obj) -> None:
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, name), "w") as fh:
        json.dump(obj, fh, indent=2, default=float)
