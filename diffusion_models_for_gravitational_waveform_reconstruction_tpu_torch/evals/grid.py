"""Mass-grid heatmap evaluator (counterpart of the JAX package's
``evals/grid.py``, with the same selection, scoring and artifacts).

- discrete (m1, m2) axes from the unique dataset masses with midpoint bin
  edges; per-cell random sample selection ``--per-cell``;
- sampler knobs parsed from sweep artifacts (``final_results.json`` /
  ``grid_results.json`` / ``best_cmd.txt``, honouring the validation gate)
  with CLI overrides;
- scoring windows full/tail/merger and alignment none/peak/xcorr, MAE
  normalised by sigma or clean;
- ``per_index_metrics.csv``, ``metrics_grid.csv``, ``metrics_grid.json``
  and ``summary.json`` with the JAX files' columns and keys, in the same
  order, rows in ``groupby(["m1", "m2"])`` order; aggregated here without
  pandas (means and medians skip NaN, ``std`` has ddof 1, as pandas'), and
  annotated heatmap PNGs when matplotlib is installed.

Samples are reconstructed in batches per length group, in chunks of
``--eval-scan-cap`` samples (S seeds each) per ``reconstruct_batch`` call.
Without the flag the cap is sized to the card's free memory
(:func:`auto_scan_cap`); on the CPU there is no cap.  The last chunk is
not padded: rows are independent and nothing is compiled that padding
would let a chunk reuse.
"""
from __future__ import annotations

import csv
import json
import math
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..inference import dewhiten_back, reconstruct_batch
from . import metrics as M
from .sweep import (Combo, _sampler_config, batch_inputs, by_length,
                    refine_from_args, resolve_ladder, uses_selfcond)


# ---------------------------------------------------------------------------
# Sweep artifact parsing
# ---------------------------------------------------------------------------

def parse_sweep_best(sweep_dir: str) -> dict:
    """Read sampler knobs from a sweep output directory.

    Prefers ``final_results.json`` (top entry), then ``grid_results.json``,
    falls back to parsing the flags inside ``best_cmd.txt``.  When the
    sweep's validation gate rejected the top combo, the default knobs it
    shipped are returned instead.
    """
    fr = os.path.join(sweep_dir, "final_results.json")
    gr = os.path.join(sweep_dir, "grid_results.json")
    for path in (fr, gr):
        if os.path.exists(path):
            with open(path) as fh:
                data = json.load(fh)
            if data:
                out = dict(data[0]["combo"])
                out["steps"] = int(data[0].get("steps", 200))
                for k in ("sampler", "ladder"):
                    if data[0].get(k):
                        out[k] = data[0][k]
                val = data[0].get("validation") or {}
                if val.get("enabled") and not val.get("emit_top", True):
                    out.update(val.get("default_combo") or {})
                    if val.get("default_start_t") is not None:
                        out["start_t"] = int(val["default_start_t"])
                    print("[grid] sweep validation gate rejected the top "
                          "combo; using reference-default knobs "
                          "(as best_cmd.txt does)")
                return out
    bc = os.path.join(sweep_dir, "best_cmd.txt")
    if os.path.exists(bc):
        with open(bc) as fh:
            cmd = fh.read()
        out = {}
        for flag, key, cast in [
            ("--steps", "steps", int), ("--eta", "eta", float),
            ("--start-snr", "start_snr", float),
            ("--init-mode", "init_mode", str),
            ("--cfg-scale", "cfg_scale", float),
            ("--cfg-mode", "cfg_mode", str),
            ("--cfg-center", "cfg_center", float),
            ("--cfg-width", "cfg_width", float),
            ("--dc-weight", "dc_weight", float),
            ("--sampler", "sampler", str),
            ("--ladder", "ladder", str),
            ("--start-t", "start_t", int),
        ]:
            m = re.search(rf"{flag}\s+(\S+)", cmd)
            if m:
                out[key] = cast(m.group(1))
        return out
    raise FileNotFoundError(f"no sweep artifacts under {sweep_dir}")


# ---------------------------------------------------------------------------
# Axes / binning
# ---------------------------------------------------------------------------

def midpoint_edges_from_values(vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Unique sorted values -> (centers, midpoint bin edges)."""
    centers = np.unique(np.round(np.asarray(vals, np.float64), 6))
    if len(centers) == 1:
        c = centers[0]
        return centers, np.array([c - 0.5, c + 0.5])
    mids = 0.5 * (centers[1:] + centers[:-1])
    first = centers[0] - (mids[0] - centers[0])
    last = centers[-1] + (centers[-1] - mids[-1])
    return centers, np.concatenate([[first], mids, [last]])


def select_per_cell(
    m1: np.ndarray, m2: np.ndarray, per_cell: int, min_per_cell: int,
    rng: np.random.Generator, unordered: bool = False,
) -> Dict[Tuple[float, float], np.ndarray]:
    """{(m1_center, m2_center): indices} with per-cell subsampling."""
    key1 = np.round(m1, 6)
    key2 = np.round(m2, 6)
    if unordered:
        hi = np.maximum(key1, key2)
        lo = np.minimum(key1, key2)
        key1, key2 = hi, lo
    cells: Dict[Tuple[float, float], list] = {}
    for i in range(len(key1)):
        cells.setdefault((float(key1[i]), float(key2[i])), []).append(i)
    out = {}
    for cell, idxs in cells.items():
        if len(idxs) < min_per_cell:
            continue
        idxs = np.asarray(idxs)
        if per_cell > 0 and len(idxs) > per_cell:
            idxs = rng.choice(idxs, size=per_cell, replace=False)
        out[cell] = np.sort(idxs)
    return out


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

# working set of one sampled row of a U-Net forward, in elements of
# L x base_ch: every level's skip (L x base_ch each, channels doubling as
# the length halves), the widest decoder input and output and the fused
# blocks' f32 intermediates, with room to spare
ROW_ELEMS_PER_L_BASE = 16
# the share of the card's free memory a chunk may take
FREE_SHARE = 0.5


def row_bytes(base_ch: int, L: int) -> int:
    """Analytic device bytes of one sampled row of a U-Net forward of width
    ``base_ch`` at length ``L`` (4-byte elements): the attention is flash
    attention on the card, so no L^2 term."""
    return ROW_ELEMS_PER_L_BASE * L * int(base_ch) * 4


def auto_scan_cap(model, L: int, seeds: int, device) -> Optional[int]:
    """Samples per ``reconstruct_batch`` call that fit ``FREE_SHARE`` of the
    card's free memory: each sample is ``seeds`` rows, doubled for the
    classifier-free guidance batch.  None (no cap) on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    base_ch = int(model.enc0.conv.kernel.shape[-1])
    per_sample = row_bytes(base_ch, L) * 2 * max(1, int(seeds))
    return max(1, int(FREE_SHARE * free) // per_sample)


def eval_indices(args, model, schedule, ck, preps: List[dict], noise,
                 device=None) -> List[dict]:
    """Reconstruct + score all prepared samples, batched per length group
    in chunks of the scan cap, one ``noise`` draw per chunk.  Records the
    resolved start t (``args._start_t_resolved``) and each length's chunk
    (``args._scan_caps``)."""
    combo = Combo(
        start_snr=args.start_snr, cfg_scale=args.cfg_scale,
        init_mode=args.init_mode, dc_weight=args.dc_weight, eta=args.eta,
        cfg_mode=args.cfg_mode, cfg_center=args.cfg_center,
        cfg_width=args.cfg_width)
    cfg = _sampler_config(combo, args.steps, schedule, ck, uses_selfcond(ck),
                          start_t_override=getattr(args, "start_t", None),
                          ladder=resolve_ladder(args),
                          refine=refine_from_args(args))
    # the RESOLVED start_t goes into summary.json: two eval runs whose knobs
    # agree but whose start t differs must be told apart
    args._start_t_resolved = int(cfg.start_t)
    if args.init_mode == "noise" and cfg.start_t < int(0.8 * schedule.T):
        print(f"[grid] WARNING: init_mode=noise with resolved start_t="
              f"{int(cfg.start_t)} < 0.8*T = {int(0.8 * schedule.T)}: pure-noise "
              f"init "
              f"below the top of the chain is a domain mismatch and yields "
              f"near-zero correlation; pass --start-t {schedule.T - 1} "
              f"(or an --init-mode that uses y)", file=sys.stderr)

    rows = []
    avg_seeds = int(getattr(args, "avg_seeds", 1))
    S = max(1, avg_seeds)
    dev = next(model.parameters()).device if device is None else device
    args._scan_caps = {}
    for L, idxs in sorted(by_length(preps).items()):
        cap_override = getattr(args, "eval_scan_cap", None)
        cap = (max(1, int(cap_override)) if cap_override
               else auto_scan_cap(model, L, S, dev))
        chunk = len(idxs) if cap is None else min(len(idxs), cap)
        args._scan_caps[int(L)] = chunk
        print(f"[grid] L={L}: {len(idxs)} samples x {S} seeds in chunks of "
              f"{chunk} ({'--eval-scan-cap' if cap_override else 'automatic'}"
              f" cap {cap if cap is not None else 'none'})")
        x0_parts, std_parts = [], []
        for c0 in range(0, len(idxs), chunk):
            sub = idxs[c0:c0 + chunk]
            conds, sigmas, cn = batch_inputs(preps, sub)
            try:
                out = reconstruct_batch(
                    model, schedule, conds, sigmas, cfg,
                    noise((S * len(sub), 1, L)), clean_norms=cn,
                    sampler=getattr(args, "sampler", "ddim"),
                    avg_seeds=avg_seeds,
                    avg_mode=getattr(args, "avg_mode", "mean"),
                    amp_calib=getattr(args, "amp_calib", "none"),
                    extra_models=getattr(args, "_extra_models", None),
                    return_seed_std=avg_seeds > 1, device=dev)
            except torch.cuda.OutOfMemoryError as e:
                raise RuntimeError(
                    f"gw-grid: out of device memory reconstructing "
                    f"{len(sub)} samples x {S} seeds at L={L} in one call; "
                    f"pass a smaller --eval-scan-cap (rows per call)") from e
            xw, sw = out if avg_seeds > 1 else (out, None)
            x0_parts.append(np.asarray(xw))
            if sw is not None:
                std_parts.append(np.asarray(sw))
        x0_white = np.concatenate(x0_parts, axis=0)
        std_white = (np.concatenate(std_parts, axis=0)
                     if std_parts else None)
        for j, i in enumerate(idxs):
            row = _score(args, preps[i], x0_white[j],
                         None if std_white is None else std_white[j])
            if row is not None:
                rows.append(row)
    return rows


def _score(args, p: dict, x0w: np.ndarray, stdw) -> Optional[dict]:
    """One sample's row (None without a clean signal)."""
    x0_raw = dewhiten_back(x0w.astype(np.float64), p)
    clean = p["clean_raw"]
    if clean is None:
        return None
    a_al, b_al = M.apply_alignment(clean, x0_raw, p["fs"], args.align,
                                   args.align_max_shift_s)
    lo, hi = M.window_indices(args.win, a_al, p["fs"], args.tail_secs,
                              args.left, args.right)
    c_w = a_al[lo:hi]
    r_w = b_al[lo:hi]
    mae = float(np.mean(np.abs(r_w - c_w)))
    # zero-guarded denominator, no absolute eps: physical-strain scales
    # (~1e-22) are far below any absolute eps
    denom = (float(np.mean(np.abs(c_w)))
             if args.mae_norm == "clean" else float(p["sigma"]))
    row = {
        "index": p["index"],
        "corr": M.corr(r_w, c_w),
        "mae": mae,
        "mae_norm": mae / denom if denom > 0 else float("nan"),
        "sigma": p["sigma"],
        "L": p["L"],
    }
    if stdw is not None:
        # relative seed-ensemble scatter: RMS of the per-seed std over the
        # whitened recon's RMS (invariant to the MF amplitude calibration)
        num = float(np.sqrt(np.mean(stdw ** 2)))
        den = float(np.sqrt(np.mean(x0w ** 2)))
        row["unc_rel"] = num / den if den > 0 else float("nan")
    if p.get("P_model_used") is not None:
        P = np.asarray(p["P_model_used"], np.float64)
        rho_r = M.matched_filter_snr(x0_raw, clean, P, p["fs"])
        rho_i = M.matched_filter_snr(clean, clean, P, p["fs"])
        row["mf_ratio"] = rho_r / rho_i if rho_i > 0 else float("nan")
    band = None
    if p.get("P_model_used") is not None:
        Pm = np.asarray(p["P_model_used"], np.float64)
        if len(Pm) == p["L"] // 2 + 1:
            band = Pm > 0
    row.update(M.residual_diagnostics(
        p["y_for_cond"], x0w, clean_white=p["clean_for_cond"], band_mask=band))
    return row


# ---------------------------------------------------------------------------
# Aggregation + plots (no pandas)
# ---------------------------------------------------------------------------

_NAN = float("nan")


def _vals(rows: List[dict], col: str) -> np.ndarray:
    return np.array([_NAN if r.get(col) is None else float(r[col])
                     for r in rows], np.float64)


def _mean(v: np.ndarray) -> float:
    v = v[~np.isnan(v)]
    return float(v.mean()) if len(v) else _NAN


def _median(v: np.ndarray) -> float:
    v = v[~np.isnan(v)]
    return float(np.median(v)) if len(v) else _NAN


def _std(v: np.ndarray) -> float:
    v = v[~np.isnan(v)]
    return float(v.std(ddof=1)) if len(v) > 1 else _NAN


def _columns(rows: List[dict]) -> List[str]:
    """Every key of ``rows`` in the order of first appearance."""
    cols: Dict[str, None] = {}
    for r in rows:
        cols.update(dict.fromkeys(r))
    return list(cols)


def _is_int(v) -> bool:
    return isinstance(v, (int, np.integer)) and not isinstance(v, bool)


def _write_csv(path: str, rows: List[dict], cols: List[str]) -> None:
    """``rows`` as a CSV of ``cols`` in pandas' spelling: a column whose
    values are all integers is written as integers, every other number in
    full precision, a missing value or NaN as an empty field."""
    int_cols = {c for c in cols if all(c in r and _is_int(r[c]) for r in rows)}

    def cell(r, c):
        v = r.get(c)
        if v is None:
            return ""
        if c in int_cols:
            return str(int(v))
        v = float(v)
        return "" if math.isnan(v) else repr(v)

    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow(cols)
        for r in rows:
            w.writerow([cell(r, c) for c in cols])


def _null_nan(v):
    return None if isinstance(v, float) and math.isnan(v) else v


def _aggregate(rows: List[dict]) -> List[dict]:
    """Per (m1, m2) cell, sorted by m1 then m2: corr mean/std, mae_norm
    mean/std, count, and the means of mf_ratio and unc_rel where rows have
    them."""
    cols = _columns(rows)
    cells: Dict[Tuple[float, float], List[dict]] = {}
    for r in rows:
        cells.setdefault((r["m1"], r["m2"]), []).append(r)
    agg = []
    for key in sorted(cells):
        sel = cells[key]
        a = {"m1": key[0], "m2": key[1],
             "corr_mean": _mean(_vals(sel, "corr")),
             "corr_std": _std(_vals(sel, "corr")),
             "mae_mean": _mean(_vals(sel, "mae_norm")),
             "mae_std": _std(_vals(sel, "mae_norm")),
             "n": len(sel)}
        if "mf_ratio" in cols:
            a["mf_ratio_mean"] = _mean(_vals(sel, "mf_ratio"))
        if "unc_rel" in cols:
            a["unc_rel_mean"] = _mean(_vals(sel, "unc_rel"))
        agg.append(a)
    return agg


def _pearson(a, b):
    a = a - a.mean()
    b = b - b.mean()
    d = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / d) if d > 0 else float("nan")


def _rank(a):
    r = np.empty(len(a))
    r[np.argsort(a, kind="stable")] = np.arange(len(a))
    return r


def aggregate_and_plot(args, rows: List[dict], labels: Dict[int, dict]) -> dict:
    """Write ``per_index_metrics.csv``, ``metrics_grid.csv`` / ``.json``,
    the two heatmaps and ``summary.json``; returns the summary."""
    os.makedirs(args.outdir, exist_ok=True)
    has_snr = all("snr" in labels[r["index"]] for r in rows)
    df = []
    for r in rows:
        lab = labels[r["index"]]
        d = dict(r, m1=lab["m1"], m2=lab["m2"])
        if has_snr:
            d["snr"] = lab["snr"]
        df.append(d)
    cols = _columns(df)
    _write_csv(os.path.join(args.outdir, "per_index_metrics.csv"), df, cols)

    agg = _aggregate(df)
    agg_cols = list(agg[0])
    _write_csv(os.path.join(args.outdir, "metrics_grid.csv"), agg, agg_cols)
    with open(os.path.join(args.outdir, "metrics_grid.json"), "w") as fh:
        json.dump([{k: _null_nan(v) for k, v in a.items()} for a in agg], fh,
                  indent=2)

    c1, e1 = midpoint_edges_from_values([a["m1"] for a in agg])
    c2, e2 = midpoint_edges_from_values([a["m2"] for a in agg])
    grid_corr = np.full((len(c2), len(c1)), np.nan)
    grid_mae = np.full((len(c2), len(c1)), np.nan)
    for a in agg:
        i1 = int(np.argmin(np.abs(c1 - a["m1"])))
        i2 = int(np.argmin(np.abs(c2 - a["m2"])))
        grid_corr[i2, i1] = a["corr_mean"]
        grid_mae[i2, i1] = a["mae_mean"]

    try:
        plot_heat(args, grid_corr, c1, c2, e1, e2, args.title_corr, "corr",
                  os.path.join(args.outdir, "heat_corr.png"))
        plot_heat(args, grid_mae, c1, c2, e1, e2, args.title_mae, "mae",
                  os.path.join(args.outdir, "heat_mae.png"))
    except ImportError as e:
        print(f"[grid] heat_corr.png and heat_mae.png not drawn: {e}")

    corr_means = np.array([a["corr_mean"] for a in agg], np.float64)
    mae_means = np.array([a["mae_mean"] for a in agg], np.float64)
    summary = {
        "n_rows": len(df),
        "n_cells": len(agg),
        "corr_macro_mean": _mean(corr_means),
        "corr_macro_median": _median(corr_means),
        "corr_micro_mean": _mean(_vals(df, "corr")),
        "mae_macro_mean": _mean(mae_means),
        "mae_macro_median": _median(mae_means),
        "mae_micro_mean": _mean(_vals(df, "mae_norm")),
        **({"mf_ratio_macro_mean": _mean(np.array(
            [a["mf_ratio_mean"] for a in agg], np.float64))}
           if "mf_ratio_mean" in agg_cols else {}),
        "knobs": {k: getattr(args, k, None) for k in
                  ["steps", "eta", "start_snr", "start_t", "init_mode",
                   "cfg_scale", "cfg_mode", "cfg_center", "cfg_width",
                   "dc_weight", "win", "align", "mae_norm", "amp_calib",
                   "avg_seeds", "avg_mode", "sampler", "ladder", "seed",
                   "refine_passes", "refine_t", "refine_steps"]},
        "start_t_resolved": getattr(args, "_start_t_resolved", None),
        # the eval whitening domain actually used: a silent domain fallback
        # must be visible in every artifact
        "whiten": bool(getattr(args, "whiten", False)),
        "whiten_mode": getattr(args, "whiten_mode", None),
        "whiten_kind_used": getattr(args, "_whiten_kind_used", None),
        "sigma_mode": getattr(args, "sigma_mode", None),
    }
    res_cols = [c for c in ("res_std_ratio", "res_clean_corr",
                            "res_flatness") if c in cols]
    if res_cols:
        # residual-whiteness block: 1.0 / 0.0 / 1.0 = perfect
        summary["residuals"] = {
            c: {"mean": _mean(_vals(df, c)), "median": _median(_vals(df, c))}
            for c in res_cols if (~np.isnan(_vals(df, c))).any()
        }
    if "unc_rel" in cols and (~np.isnan(_vals(df, "unc_rel"))).sum() >= 3:
        # uncertainty calibration: does the seed-ensemble scatter predict
        # the error?  Correlation of unc_rel with (1 - corr) over the rows
        u_all, c_all = _vals(df, "unc_rel"), _vals(df, "corr")
        keep = ~np.isnan(u_all) & ~np.isnan(c_all)
        u, e = u_all[keep], 1.0 - c_all[keep]
        summary["uncertainty"] = {
            "n": int(keep.sum()),
            "unc_rel_mean": float(u.mean()),
            "unc_rel_median": float(np.median(u)),
            "pearson_unc_vs_err": _pearson(u, e),
            "spearman_unc_vs_err": _pearson(_rank(u), _rank(e)),
        }
    snr = _vals(df, "snr") if has_snr else None
    if has_snr and len(np.unique(snr[~np.isnan(snr)])) >= 3:
        # SNR-stratified breakdown over terciles of the evaluated rows: the
        # residual error is dominated by the low-SNR tail, which mass-cell
        # macro averages hide
        edges = np.quantile(snr, [0.0, 1 / 3, 2 / 3, 1.0])
        bins = np.clip(np.searchsorted(edges[1:-1], snr, side="right"), 0, 2)
        by_snr = []
        for b in range(3):
            sel = [r for r, k in zip(df, bins) if k == b]
            if not sel:
                continue
            ent = {
                "snr_lo": float(edges[b]), "snr_hi": float(edges[b + 1]),
                "n": len(sel),
                "corr_mean": _mean(_vals(sel, "corr")),
                "mae_norm_mean": _mean(_vals(sel, "mae_norm")),
            }
            if "mf_ratio" in cols:
                ent["mf_ratio_mean"] = _mean(_vals(sel, "mf_ratio"))
            by_snr.append(ent)
        summary["by_snr"] = by_snr
    with open(os.path.join(args.outdir, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=2)
    return summary


def plot_heat(args, grid: np.ndarray, c1, c2, e1, e2, title: str, kind: str,
              path: str) -> None:
    """Annotated heatmap with tick thinning and optional gridlines; needs
    matplotlib (an ImportError without it)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6.5))
    cmap = "viridis" if kind == "corr" else "magma_r"
    pm = ax.pcolormesh(e1, e2, grid, cmap=cmap, shading="flat")
    fig.colorbar(pm, ax=ax)
    ax.set_xlabel(args.xlabel)
    ax.set_ylabel(args.ylabel)
    ax.set_title(title)

    def thin(centers, max_ticks):
        if len(centers) <= max_ticks:
            return centers
        stride = int(np.ceil(len(centers) / max_ticks))
        return centers[::stride]

    ax.set_xticks(thin(c1, args.max_ticks_x))
    ax.set_yticks(thin(c2, args.max_ticks_y))
    ax.set_xticklabels([args.tick_fmt % v for v in thin(c1, args.max_ticks_x)])
    ax.set_yticklabels([args.tick_fmt % v for v in thin(c2, args.max_ticks_y)])

    if args.gridlines:
        for e in e1:
            ax.axvline(e, color="w", alpha=args.gridline_alpha,
                       lw=args.gridline_width)
        for e in e2:
            ax.axhline(e, color="w", alpha=args.gridline_alpha,
                       lw=args.gridline_width)

    if args.annot and grid.size <= 400:
        for i2 in range(len(c2)):
            for i1 in range(len(c1)):
                v = grid[i2, i1]
                if np.isfinite(v):
                    ax.text(c1[i1], c2[i2],
                            args.annot_fmt % (v / args.annot_div),
                            ha="center", va="center", fontsize=7, color="w")
    fig.savefig(path, dpi=130)
    plt.close(fig)
