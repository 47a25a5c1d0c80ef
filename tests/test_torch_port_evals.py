"""The PyTorch port's evaluation harnesses against the JAX package's, on the
CPU: the ``.npz`` twin of an HDF5 corpus, the sweep and grid helpers,
``eval_indices`` (seeds with median / mf, chunking, an ensemble), the
pandas-free aggregation, and the ``gw-sweep`` (grid and random mode, the
validation gate on) and ``gw-grid --from-sweep`` CLIs end to end.

The corpus is written by the JAX package (a 2 x 2 mass grid, 3 samples a
cell, L 512, noise coloured by the aLIGO design PSD, the model PSD derived
from the grid scalars) and turned into its twin with ``corpus_to_npz``; the
checkpoints are JAX-written (base_ch 16, depth 2, f32).  JAX's draws reach
the port through its one noise seam (``evals.sweep._noise``): every key the
JAX package hands to ``reconstruct_batch`` is recorded, in order, and the
port's n-th call samples with the n-th key's draws (x_T from
``split(key)[0]``, step i from ``fold_in(split(key)[1], i)``; of a padded
JAX chunk only the real rows ``s * chunk + b``).

Tolerances: host arithmetic (the twin's arrays, labels, meta scale, the
helpers, ``best_cmd``) equal; reconstruction-derived numbers (J, every
per-sample metric, every CSV and JSON number) within 1e-4 relative,
max-abs normalised over the samples of one metric (``rel_err``), as the
port's other parity tests measure f32 sampling.
"""
import csv
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_for_gravitational_waveform_reconstruction_tpu import inference as jinf
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.cli import grid as jgrid_cli
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.cli import sweep as jsweep_cli
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.data import hdf5io as jio
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.evals import grid as jgrid
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.evals import sweep as jsweep
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.utils import checkpoint as jck
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import inference as tinf
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import grid as tgrid_cli
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import sweep as tsweep_cli
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import hdf5io as tio
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.evals import grid as tgrid
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.evals import sweep as tsweep
from test_torch_port_infer import synth
from test_torch_port_unet import REL_TOL, SMALL, model_pair, rel_err

FS, L = 4096.0, 512
MASSES = [(30.0, 20.0), (30.0, 25.0), (40.0, 20.0), (40.0, 25.0)]
PER_CELL = 3
CK = {"in_ch": 7, "cond_in_ch": 5, "base_ch": SMALL["base_ch"],
      "time_dim": SMALL["time_dim"], "depth": SMALL["depth"], "T": 1000,
      "schedule": "cosine", "pred_type": "v", "whiten": 1,
      "whiten_mode": "model", "whiten_mode_resolved": "model",
      "sigma_mode": "std", "meta_scale": {"M": 45.0, "q": 5.0},
      "bf16": False}
PORT_INFER = tsweep.INFER_PROG


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The JAX-written HDF5 corpus, its .npz twin, and two JAX-written
    checkpoints (EMA weights apart from the raw ones)."""
    d = tmp_path_factory.mktemp("evals")
    sig, noi, noisy, times = [], [], [], []
    meta = {k: [] for k in ("mass1", "mass2", "spin1z", "spin2z", "q",
                            "chirp_mass", "snr", "label_m1", "label_m2",
                            "psd_len", "psd_df", "psd_f_lower")}
    n = 0
    for m1, m2 in MASSES:
        for _ in range(PER_CELL):
            amp = 1e-21 * (0.6 + 0.15 * n)
            clean, noise, _ = synth(L, FS, 100 + n, amp=amp)
            sig.append(clean)
            noi.append(noise)
            noisy.append(clean + noise)
            times.append(np.arange(L) / FS)
            mc = (m1 * m2) ** 0.6 / (m1 + m2) ** 0.2
            for k, v in (("mass1", m1), ("mass2", m2), ("spin1z", 0.1),
                         ("spin2z", -0.1), ("q", m1 / m2), ("chirp_mass", mc),
                         ("snr", 8.0 + 1.5 * n), ("label_m1", m1),
                         ("label_m2", m2), ("psd_len", L // 2 + 1),
                         ("psd_df", FS / L), ("psd_f_lower", 20.0)):
                meta[k].append(v)
            n += 1
    h5 = str(d / "corpus.h5")
    jio.write_dataset(h5, sig, noi, noisy, times, meta, FS)
    npz = str(d / "corpus.npz")
    tio.corpus_to_npz(h5, npz)
    cks = []
    for i, seeds in enumerate(((4, 5), (6, 7))):
        _, params, _ = model_pair(L, seed=seeds[0], **SMALL)
        _, ema, _ = model_pair(L, seed=seeds[1], **SMALL)
        path = str(d / f"model{i}" / "model.msgpack")
        jck.save_checkpoint(path, params, CK, epoch=2, model_ema_state=ema)
        cks.append(path)
    return types.SimpleNamespace(dir=d, h5=h5, npz=npz, ckpt=cks[0],
                                 ckpt2=cks[1])


# ---------------------------------------------------------------------------
# JAX's draws through the port's noise seam
# ---------------------------------------------------------------------------

class JaxDraws:
    """The draws a JAX sampler makes from ``key`` for a batch of
    ``jax_rows`` rows (S seeds, seed-major), restricted to the rows the
    port samples: row s * chunk + b for b below the port's chunk."""

    def __init__(self, key, jax_rows, seeds):
        self.k_init, self.k_loop = jax.random.split(key)
        self.jax_rows, self.seeds = jax_rows, seeds

    def _rows(self, k, shape):
        z = np.asarray(jax.random.normal(k, (self.jax_rows,) + tuple(shape[1:]),
                                         jnp.float32))
        chunk, sub = self.jax_rows // self.seeds, shape[0] // self.seeds
        assert shape[0] % self.seeds == 0 and sub <= chunk
        take = [s * chunk + b for s in range(self.seeds) for b in range(sub)]
        return torch.from_numpy(z[take])

    def init(self, shape, dtype, device):
        return self._rows(self.k_init, shape).to(device=device, dtype=dtype)

    def step(self, i, shape, dtype, device):
        return self._rows(jax.random.fold_in(self.k_loop, i),
                          shape).to(device=device, dtype=dtype)


@pytest.fixture
def jax_keys(monkeypatch):
    """Records every (key, rows, seeds) the JAX package's reconstruct_batch
    receives, and hands them, in order, to the port's noise seam."""
    calls = []

    def wrap(orig):
        def rb(model, params, schedule, conds, sigmas, cfg, key, **kw):
            calls.append((key, int(np.shape(conds)[0]),
                          max(1, int(kw.get("avg_seeds", 1)))))
            return orig(model, params, schedule, conds, sigmas, cfg, key, **kw)
        return rb

    monkeypatch.setattr(jsweep, "reconstruct_batch",
                        wrap(jsweep.reconstruct_batch))
    monkeypatch.setattr(jgrid, "reconstruct_batch",
                        wrap(jgrid.reconstruct_batch))
    used = []

    def noise(seed, device):
        assert str(device) == "cpu"

        def draw(shape):
            key, rows, seeds = calls[len(used)]
            used.append(shape)
            assert shape[0] <= rows * seeds
            return JaxDraws(key, rows * seeds, seeds)
        return draw

    monkeypatch.setattr(tsweep, "_noise", noise)
    return types.SimpleNamespace(calls=calls, used=used)


# ---------------------------------------------------------------------------
# the .npz twin
# ---------------------------------------------------------------------------

def _equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_npz_twin_reads_as_the_h5(corpus):
    n = len(MASSES) * PER_CELL
    assert tio.num_samples(corpus.npz) == tio.num_samples(corpus.h5) == n
    for i in range(n):
        want = jio.load_measurement(corpus.h5, i)
        _equal(tio.load_measurement(corpus.h5, i), want)
        _equal(tio.load_measurement(corpus.npz, i), want)
    _equal(tio.load_measurements(corpus.npz, [3, 0, 7]),
           [jio.load_measurement(corpus.h5, i) for i in (3, 0, 7)])
    full_h5, full_npz = tio.load_full(corpus.h5), tio.load_full(corpus.npz)
    want = jio.load_full(corpus.h5)
    for k in ("noisy", "signal", "psd_model", "psd_welch", "psd_welch_freqs",
              "fs", "psd_model_source", "n", "mass1", "snr", "label_m2"):
        _equal(full_h5[k], want[k])
        _equal(full_npz[k], want[k])
    assert tio.compute_meta_scale(corpus.npz) == jio.compute_meta_scale(corpus.h5)
    m1, m2, snr = tio.load_labels(corpus.npz)
    _equal((m1, m2, snr), tio.load_labels(corpus.h5))
    assert m1.dtype == np.float64 and sorted(set(m1)) == [30.0, 40.0]
    with np.load(corpus.npz) as z:
        assert z["sampling_rate"].shape == () and float(z["sampling_rate"]) == FS
        assert z["noisy"].shape == (n, L) and z["noisy"].dtype == np.float32
        assert "psd" not in z.files and "noise" not in z.files


def test_save_corpus_npz_matches_the_twin_and_refuses_ragged(corpus, tmp_path):
    full = jio.load_full(corpus.h5)
    meta = {k: full[k] for k in ("mass1", "mass2", "snr")}
    path = str(tmp_path / "w.npz")
    tio.save_corpus_npz(path, full["signal"], full["noisy"], meta, FS,
                        psd_model=full["psd_model"])
    for i in (0, 5):
        y, clean, fs, P, _, m = tio.load_measurement(path, i)
        wy, wclean, wfs, wP, _, wm = jio.load_measurement(corpus.h5, i)
        _equal((y, clean, fs, P), (wy, wclean, wfs, wP))
        assert m == {k: wm[k] for k in meta}
    with pytest.raises(ValueError, match="needs HDF5"):
        tio.save_corpus_npz(str(tmp_path / "r.npz"),
                            [np.zeros(4), np.zeros(5)],
                            [np.zeros(4), np.zeros(5)], {}, FS)
    assert not (tmp_path / "r.npz").exists()


# ---------------------------------------------------------------------------
# helpers, bit-equal
# ---------------------------------------------------------------------------

def _sweep_dir(tmp_path, name, files):
    d = tmp_path / name
    d.mkdir()
    for fname, content in files.items():
        (d / fname).write_text(content if isinstance(content, str)
                               else json.dumps(content))
    return str(d)


COMBO = {"start_snr": 6.5, "cfg_scale": 1.2, "init_mode": "y-blend",
         "dc_weight": 0.05, "eta": 0.25, "cfg_mode": "gauss",
         "cfg_center": 0.6, "cfg_width": 0.2}
SWEEP_DIRS = {
    "final": {"final_results.json": [{"combo": COMBO, "steps": 40,
                                      "sampler": "dpmpp", "ladder": "lambda"}]},
    "grid": {"grid_results.json": [{"combo": COMBO, "steps": 12}]},
    "gate_rejected": {"final_results.json": [{
        "combo": COMBO, "steps": 40, "validation": {
            "enabled": True, "emit_top": False,
            "default_combo": {"start_snr": 0.0, "cfg_scale": 1.5,
                              "init_mode": "noise", "dc_weight": 0.0,
                              "eta": 0.0, "cfg_mode": "const"},
            "default_start_t": 999}}]},
    "cmd": {"best_cmd.txt": "gw-infer --steps 30 --eta 0.0 --start-t 999 "
                            "--init-mode noise --cfg-scale 1.5 --cfg-mode const "
                            "--cfg-center 0.7 --cfg-width 0.12 --dc-weight 0 "
                            "--sampler ddpm --ladder t\n"},
}


@pytest.mark.parametrize("name", sorted(SWEEP_DIRS))
def test_parse_sweep_best_matches_jax(tmp_path, name):
    d = _sweep_dir(tmp_path, name, SWEEP_DIRS[name])
    assert tgrid.parse_sweep_best(d) == jgrid.parse_sweep_best(d)
    with pytest.raises(FileNotFoundError):
        tgrid.parse_sweep_best(str(tmp_path))


@pytest.mark.parametrize("vals", [[20.0, 30.0, 45.0], [7.5], [3.0, 1.0, 3.0, 2.0]])
def test_midpoint_edges_match_jax(vals):
    _equal(tgrid.midpoint_edges_from_values(np.array(vals)),
           jgrid.midpoint_edges_from_values(np.array(vals)))


@pytest.mark.parametrize("per_cell,min_per_cell,unordered",
                         [(2, 1, False), (0, 3, False), (1, 1, True)])
def test_select_per_cell_matches_jax(per_cell, min_per_cell, unordered):
    rng = np.random.default_rng(3)
    m1 = rng.choice([20.0, 30.0, 40.0], 40)
    m2 = rng.choice([20.0, 30.0], 40)
    got = tgrid.select_per_cell(m1, m2, per_cell, min_per_cell,
                                np.random.default_rng(9), unordered)
    want = jgrid.select_per_cell(m1, m2, per_cell, min_per_cell,
                                 np.random.default_rng(9), unordered)
    assert list(got) == list(want)
    _equal(list(got.values()), list(want.values()))


@pytest.mark.parametrize("extra", [
    {}, {"sampler": "dpmpp", "ladder": "lambda"},
    {"refine_passes": 2, "refine_t": 250, "refine_steps": 3}])
@pytest.mark.parametrize("start_t", [None, 999])
def test_best_cmd_matches_jax_but_for_the_program(extra, start_t):
    args = types.SimpleNamespace(
        input_h5="c.npz", indices=[4, 1], model="ck.msgpack", outdir="out",
        whiten=1, whiten_mode="model", sigma_mode="std", **extra)
    got = tsweep.best_cmd(args, COMBO, 20, start_t_override=start_t)
    want = jsweep.best_cmd(args, COMBO, 20, start_t_override=start_t)
    assert got.startswith(PORT_INFER + " ") and want.startswith("gw-infer ")
    assert got[len(PORT_INFER):] == want[len("gw-infer"):]


def test_sampler_config_and_ladder_match_jax():
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu.ops.schedules import make_schedule as jmake
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.schedules import make_schedule as tmake

    ck = dict(CK, selfcond_mode="zero", dropout_y_only=False)
    for snr, override in ((3.7, None), (40.0, None), (8.0, 600)):
        combo = dict(COMBO, start_snr=snr)
        got = tsweep._sampler_config(tsweep.Combo(**combo), 9, tmake(1000), ck,
                                     True, override, "lambda", (1, 200, 2))
        want = jsweep._sampler_config(jsweep.Combo(**combo), 9, jmake(1000),
                                      ck, True, override, "lambda", (1, 200, 2))
        assert {k: getattr(got, k) for k in got.__dataclass_fields__} == {
            k: getattr(want, k) for k in got.__dataclass_fields__}
    for a in ({"sampler": "dpmpp"}, {"sampler": "ddim"},
              {"sampler": "dpmpp", "ladder": "t"}):
        ns = types.SimpleNamespace(**a)
        assert tsweep.resolve_ladder(ns) == jsweep.resolve_ladder(ns)
    rng_args = types.SimpleNamespace(
        start_snr_min=2.0, start_snr_max=40.0, cfg_min=0.8, cfg_max=3.0,
        init_choices=["noise", "y-blend"], dc_choices=[0.0, 0.1],
        eta_choices=[0.0, 0.25], cfg_mode="tophat", cfg_center_min=0.5,
        cfg_center_max=0.9, cfg_width_min=0.05, cfg_width_max=0.3)
    got = [tsweep.sample_combo(np.random.default_rng(2), rng_args).to_dict()]
    want = [jsweep.sample_combo(np.random.default_rng(2), rng_args).to_dict()]
    assert got == want


# ---------------------------------------------------------------------------
# the pandas-free aggregation against the JAX package's pandas one
# ---------------------------------------------------------------------------

def _read_csv(path):
    with open(path) as fh:
        rows = list(csv.reader(fh))
    return rows[0], rows[1:]


def _close_csv(got_path, want_path, tol=0.0):
    gh, grows = _read_csv(got_path)
    wh, wrows = _read_csv(want_path)
    assert gh == wh and len(grows) == len(wrows), (gh, wh)
    for c, col in enumerate(wh):
        g = [r[c] for r in grows]
        w = [r[c] for r in wrows]
        assert [v == "" for v in g] == [v == "" for v in w], col
        gv = np.array([float(v) for v in g if v != ""])
        wv = np.array([float(v) for v in w if v != ""])
        if len(wv) and np.abs(wv).max() > 0:
            assert rel_err(gv, wv) <= tol, (col, gv, wv)
        else:
            np.testing.assert_array_equal(gv, wv)


def _close_json(got, want, tol, path=""):
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _close_json(got[k], want[k], tol, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close_json(g, w, tol, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        if np.isnan(want):
            assert np.isnan(got), path
        else:
            assert abs(got - want) <= tol * max(abs(want), 1e-12), (path, got,
                                                                    want)
    else:
        assert got == want, path


def _grid_args(outdir, **kw):
    ns = jgrid_cli.build_parser().parse_args(
        ["--input-h5", "x", "--model", "m", "--outdir", outdir])
    ns.__dict__.update(kw)
    return ns


def _synthetic_rows(rng, n, seeds):
    rows = []
    for i in range(n):
        r = {"index": i, "corr": float(rng.uniform(-0.2, 0.9)),
             "mae": float(rng.uniform(1e-22, 3e-22)),
             "mae_norm": float(rng.uniform(0.1, 2.0)),
             "sigma": float(rng.uniform(1.0, 3.0)), "L": 512}
        if seeds:
            r["unc_rel"] = float(rng.uniform(0.1, 0.5))
        r["mf_ratio"] = float("nan") if i == 2 else float(rng.uniform(0, 1))
        r.update(res_std_ratio=float(rng.uniform(0.9, 1.2)),
                 res_clean_corr=float(rng.uniform(0, 0.1)),
                 res_flatness=float(rng.uniform(0.8, 1.1)))
        rows.append(r)
    rows[3]["corr"] = float("nan")
    return rows


@pytest.mark.parametrize("seeds,with_snr", [(True, True), (False, False)])
def test_aggregate_matches_pandas(tmp_path, seeds, with_snr):
    """The files and summary of the pandas-free aggregation against the JAX
    package's pandas one on the same rows: NaNs, a one-sample cell (std
    NaN), unc_rel, mf_ratio and SNR terciles; no PNG compared."""
    rng = np.random.default_rng(4)
    rows = _synthetic_rows(rng, 9, seeds)
    cells = [(30.0, 20.0)] * 4 + [(40.0, 20.0)] * 2 + [(30.0, 25.0)] * 2 + [
        (25.0, 25.0)]
    labels = {i: {"m1": c[0], "m2": c[1],
                  **({"snr": 8.0 + 2 * i} if with_snr else {})}
              for i, c in enumerate(cells)}
    out = {}
    for name, mod in (("jax", jgrid), ("port", tgrid)):
        args = _grid_args(str(tmp_path / name), avg_seeds=2 if seeds else 1,
                          _start_t_resolved=975, _whiten_kind_used="model",
                          whiten=1, whiten_mode="model", sigma_mode="std",
                          steps=10, cfg_scale=1.5)
        out[name] = mod.aggregate_and_plot(args, [dict(r) for r in rows],
                                           labels)
    assert "uncertainty" in out["port"] if seeds else True
    assert ("by_snr" in out["port"]) == with_snr
    _close_json(out["port"], out["jax"], 1e-12)
    for f in ("per_index_metrics.csv", "metrics_grid.csv"):
        _close_csv(str(tmp_path / "port" / f), str(tmp_path / "jax" / f),
                   1e-12)
    with open(tmp_path / "port" / "metrics_grid.json") as a, \
            open(tmp_path / "jax" / "metrics_grid.json") as b:
        got, want = json.load(a), json.load(b)
    assert [list(r) for r in got] == [list(r) for r in want]
    for g, w in zip(got, want):
        for k in w:
            if w[k] is None:
                assert g[k] is None, k
            else:
                assert abs(g[k] - w[k]) <= 1e-9 * max(abs(w[k]), 1.0), k
    for name in ("port", "jax"):
        with open(tmp_path / name / "summary.json") as fh:
            out[name] = json.load(fh)
    assert list(out["port"]) == list(out["jax"])


# ---------------------------------------------------------------------------
# eval_indices: seeds, chunks and an ensemble
# ---------------------------------------------------------------------------

def _assert_rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w) and g.get("index") == w.get("index")
    for k in want[0]:
        gv = np.array([r[k] for r in got], np.float64)
        wv = np.array([r[k] for r in want], np.float64)
        assert np.array_equal(np.isnan(gv), np.isnan(wv)), k
        ok = ~np.isnan(wv)
        if ok.any() and np.abs(wv[ok]).max() > 0:
            assert rel_err(gv[ok], wv[ok]) <= REL_TOL, (k, gv, wv)


EVAL_CASES = {
    "seeds3-median-chunked": dict(avg_seeds=3, avg_mode="median",
                                  eval_scan_cap=2, amp_calib="mf"),
    "seeds2-mf-eta": dict(avg_seeds=2, avg_mode="mf", eta=0.5,
                          init_mode="scaled-noise", start_t=700),
    "ensemble": dict(avg_seeds=1, ensemble=True, cfg_scale=1.0),
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_eval_indices_matches_jax(corpus, jax_keys, case, tmp_path):
    kw = dict(EVAL_CASES[case])
    ensemble = kw.pop("ensemble", False)
    base = dict(steps=2, cfg_scale=1.5, start_t=999, whiten=1,
                whiten_mode="model", sigma_mode="std", sigma_fixed=1.0)
    indices = [0, 4, 5, 9, 11]
    jm, jparams, jsched, jck_args = jinf.load_model(corpus.ckpt)
    tm, tsched, tck_args = tinf.load_model(corpus.ckpt, device="cpu")
    jargs = _grid_args(str(tmp_path / "j"), **dict(base, **kw))
    targs = _grid_args(str(tmp_path / "t"), **dict(base, **kw))
    if ensemble:
        jm2, jp2, _, _ = jinf.load_model(corpus.ckpt2)
        jargs._extra_models = [(jm2, jp2)]
        targs._extra_models = [tinf.load_model(corpus.ckpt2, device="cpu")[0]]
    jpreps = jsweep.prep_samples(corpus.h5, indices, jck_args, corpus.ckpt,
                                 True, "model", "std")
    tpreps = tsweep.prep_samples(corpus.npz, indices, tck_args, corpus.ckpt,
                                 True, "model", "std")
    want = jgrid.eval_indices(jargs, jm, jparams, jsched, jck_args, jpreps,
                              jax.random.PRNGKey(11))
    got = tgrid.eval_indices(targs, tm, tsched, tck_args, tpreps,
                             tsweep._noise(11, "cpu"), device="cpu")
    n_calls = -(-len(indices) // kw.get("eval_scan_cap", len(indices)))
    assert len(jax_keys.calls) == len(jax_keys.used) == n_calls
    assert targs._start_t_resolved == jargs._start_t_resolved
    assert targs._scan_caps == {L: kw.get("eval_scan_cap", len(indices))}
    _assert_rows_close(got, want)
    if kw.get("avg_seeds", 1) > 1:
        assert "unc_rel" in got[0]


def test_eval_combo_matches_jax(corpus, jax_keys):
    jm, jparams, jsched, jck_args = jinf.load_model(corpus.ckpt)
    tm, tsched, tck_args = tinf.load_model(corpus.ckpt, device="cpu")
    indices = [1, 2, 7]
    jpreps = jsweep.prep_samples(corpus.h5, indices, jck_args, corpus.ckpt,
                                 True, "model", "std")
    tpreps = tsweep.prep_samples(corpus.npz, indices, tck_args, corpus.ckpt,
                                 True, "model", "std")
    combo = dict(COMBO, cfg_mode="const")
    want = jsweep.eval_combo(jm, jparams, jsched, jck_args, jpreps,
                             jsweep.Combo(**combo), 3, jax.random.PRNGKey(2))
    got = tsweep.eval_combo(tm, tsched, tck_args, tpreps,
                            tsweep.Combo(**combo), 3, tsweep._noise(2, "cpu"),
                            device="cpu")
    assert {k: got[k] for k in ("combo", "steps", "start_t")} == {
        k: want[k] for k in ("combo", "steps", "start_t")}
    assert abs(got["J"] - want["J"]) <= REL_TOL * abs(want["J"])
    for part in ("strain", "white"):
        _assert_rows_close([s[part] for s in got["per_sample"]],
                           [s[part] for s in want["per_sample"]])
    _assert_rows_close([{"J": s["J"]} for s in got["per_sample"]],
                       [{"J": s["J"]} for s in want["per_sample"]])
    # the port on the .h5 gives what it gives on the .npz twin, exactly
    key, rows, seeds = jax_keys.calls[0]
    tpreps_h5 = tsweep.prep_samples(corpus.h5, indices, tck_args, corpus.ckpt,
                                    True, "model", "std")
    got_h5 = tsweep.eval_combo(tm, tsched, tck_args, tpreps_h5,
                               tsweep.Combo(**combo), 3,
                               lambda shape: JaxDraws(key, rows, seeds),
                               device="cpu")
    assert got_h5 == got


def test_grid_chunk_out_of_memory_names_the_cap(corpus, monkeypatch, tmp_path):
    tm, tsched, tck_args = tinf.load_model(corpus.ckpt, device="cpu")
    preps = tsweep.prep_samples(corpus.npz, [0, 1], tck_args, corpus.ckpt,
                                True, "model", "std")

    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(tgrid, "reconstruct_batch", oom)
    args = _grid_args(str(tmp_path), steps=2, cfg_scale=1.5, eval_scan_cap=1)
    with pytest.raises(RuntimeError, match="--eval-scan-cap"):
        tgrid.eval_indices(args, tm, tsched, tck_args, preps,
                           tsweep._noise(0, "cpu"), device="cpu")


def test_auto_scan_cap_is_sized_to_free_memory(corpus, monkeypatch):
    tm, _, _ = tinf.load_model(corpus.ckpt, device="cpu")
    assert tgrid.auto_scan_cap(tm, L, 2, "cpu") is None
    per_row = tgrid.row_bytes(SMALL["base_ch"], 4096)
    assert per_row == tgrid.ROW_ELEMS_PER_L_BASE * 4096 * SMALL["base_ch"] * 4
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (int(80e9), int(80e9)))
    cap = tgrid.auto_scan_cap(tm, 4096, 2, "cuda")
    assert cap == int(tgrid.FREE_SHARE * 80e9) // (per_row * 4)
    assert tgrid.auto_scan_cap(tm, 4096, 2 * cap + 2, "cuda") == 1


# ---------------------------------------------------------------------------
# the CLIs end to end
# ---------------------------------------------------------------------------

def _sweep_argv(corpus, src, outdir, extra):
    return (["--input-h5", src, "--model", corpus.ckpt, "--outdir", outdir,
             "--indices", "0", "3", "6", "9", "--seed", "5"] + extra)


SWEEP_MODES = {
    "grid": ["--grid", "--grid-steps", "2", "--grid-snr", "8",
             "--grid-cfg", "1.0", "1.5", "--grid-init", "noise",
             "--grid-dc", "0", "--grid-eta", "0", "--val-samples", "3"],
    "random": ["--n-coarse", "2", "--topk", "1", "--seeds-refine", "2",
               "--steps-coarse", "2", "--steps-refine", "2",
               "--init-choices", "noise", "scaled-noise",
               "--eta-choices", "0.0", "--val-samples", "3"],
}


def _load_json(path):
    with open(path) as fh:
        return json.load(fh)


def _compare_sweep_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k in ("per_sample",):
                for part in ("strain", "white"):
                    _assert_rows_close([s[part] for s in g[k]],
                                       [s[part] for s in w[k]])
            elif k == "J_seeds":
                assert rel_err(g[k], w[k]) <= REL_TOL
            elif k == "validation":
                _close_json(g[k], w[k], REL_TOL)
            elif isinstance(w[k], float):
                assert abs(g[k] - w[k]) <= REL_TOL * max(abs(w[k]), 1e-3), k
            else:
                assert g[k] == w[k], k


@pytest.fixture(scope="module")
def sweeps():
    return {}


def _run_sweeps(corpus, jax_keys, tmp_path, mode):
    jout, tout = str(tmp_path / f"jax_{mode}"), str(tmp_path / f"port_{mode}")
    jsweep_cli.main(_sweep_argv(corpus, corpus.h5, jout, SWEEP_MODES[mode]))
    tsweep_cli.main(_sweep_argv(corpus, corpus.npz, tout, SWEEP_MODES[mode])
                    + ["--device", "cpu"])
    assert len(jax_keys.used) == len(jax_keys.calls)
    return jout, tout


@pytest.mark.parametrize("mode", sorted(SWEEP_MODES))
def test_sweep_cli_matches_jax(corpus, jax_keys, tmp_path, mode, sweeps):
    jout, tout = _run_sweeps(corpus, jax_keys, tmp_path, mode)
    sweeps[mode] = jout
    files = sorted(os.listdir(jout))
    assert sorted(os.listdir(tout)) == files
    assert "validation.json" in files and "best_cmd.txt" in files
    for f in files:
        if f.endswith(".json"):
            got, want = _load_json(os.path.join(tout, f)), _load_json(
                os.path.join(jout, f))
            if f == "validation.json":
                _close_json(got, want, REL_TOL)
            else:
                _compare_sweep_results(got, want)
    with open(os.path.join(tout, "best_cmd.txt")) as a, \
            open(os.path.join(jout, "best_cmd.txt")) as b:
        got, want = a.read(), b.read()
    want = want.replace(corpus.h5, corpus.npz).replace(jout, tout)
    assert got == want.replace("gw-infer", PORT_INFER, 1)
    results = _load_json(os.path.join(tout, "grid_results.json" if mode ==
                                      "grid" else "final_results.json"))
    assert results[0]["J"] == max(r["J"] for r in results)
    val = _load_json(os.path.join(tout, "validation.json"))
    shipped = "--start-t 999" in got
    assert shipped == (not val["emit_top"])


def test_grid_cli_from_sweep_matches_jax(corpus, jax_keys, tmp_path, sweeps):
    if "grid" not in sweeps:
        sweep_dir = str(tmp_path / "sweep")
        jsweep_cli.main(_sweep_argv(corpus, corpus.h5, sweep_dir,
                                    SWEEP_MODES["grid"]))
        jax_keys.calls.clear()
    else:
        sweep_dir = sweeps["grid"]
    common = ["--model", corpus.ckpt, "--from-sweep", sweep_dir,
              "--per-cell", "2", "--avg-seeds", "2", "--avg-mode", "median",
              "--amp-calib", "mf", "--start-t", "999", "--seed", "3"]
    jout, tout = str(tmp_path / "jax_grid"), str(tmp_path / "port_grid")
    jgrid_cli.main(["--input-h5", corpus.h5, "--outdir", jout] + common)
    res = tgrid_cli.main(["--input-h5", corpus.npz, "--outdir", tout,
                          "--device", "cpu"] + common)
    assert len(jax_keys.used) == len(jax_keys.calls) == 1
    assert res["scan_caps"] == {L: 8}
    jfiles = sorted(os.listdir(jout))
    assert sorted(os.listdir(tout)) == jfiles
    assert {"heat_corr.png", "heat_mae.png", "summary.json",
            "metrics_grid.csv", "metrics_grid.json",
            "per_index_metrics.csv"} == set(jfiles)
    for f in ("per_index_metrics.csv", "metrics_grid.csv"):
        _close_csv(os.path.join(tout, f), os.path.join(jout, f), REL_TOL)
    got, want = (_load_json(os.path.join(d, "metrics_grid.json"))
                 for d in (tout, jout))
    assert [list(r) for r in got] == [list(r) for r in want]
    summ_t, summ_j = (_load_json(os.path.join(d, "summary.json"))
                      for d in (tout, jout))
    assert summ_t["n_cells"] == 4 and "uncertainty" in summ_t
    assert "by_snr" in summ_t
    _close_json(summ_t, summ_j, REL_TOL)
