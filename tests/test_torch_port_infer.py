"""The PyTorch port's ``gw-infer`` path against the JAX package, on the CPU:
float64 host preparation and the metrics bit-equal, ``make_run_tag``
string-equal, the sampler diagnostics, the one-step proxy and
``reconstruct`` within 1e-4 relative in f32 with JAX's noise injected, the
infer CLI end to end on a JAX-written HDF5 corpus and checkpoint, and the
CLI's modules importing with JAX, flax, msgpack and h5py blocked."""
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_for_gravitational_waveform_reconstruction_tpu import inference as jinf
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.cli import infer as jcli
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.data import hdf5io as jio
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.data import pipeline as jpipe
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.evals import metrics as jmet
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.ops import sampling as jsp
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.ops import schedules as jsch
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.utils import checkpoint as jck
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import inference as tinf
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import infer as tcli
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import hdf5io as tio
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import pipeline as tpipe
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.evals import metrics as tmet
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops import sampling as tsp
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops import schedules as tsch
from test_torch_port_sampling import jax_noise
from test_torch_port_unet import REL_TOL, SMALL, model_pair, rel_err

FS, LM = 4096.0, 1024          # measurement length for host preparation
L = 256                        # sampling length
META = {"mass1": 36.0, "mass2": 29.0, "spin1z": 0.3, "spin2z": -0.1,
        "q": 36.0 / 29.0, "chirp_mass": 28.1, "snr": 20.0}
CK = {"in_ch": 7, "cond_in_ch": 5, "base_ch": 16, "time_dim": 32, "depth": 2,
      "T": 1000, "schedule": "cosine", "pred_type": "v", "whiten": 1,
      "whiten_mode": "model", "whiten_mode_resolved": "model",
      "meta_scale": {"M": 60.0, "q": 5.0}, "bf16": False}


def synth(L_, fs, seed, amp=1e-21):
    """A chirp-like clean waveform (merger at 85% of the segment, a short
    ringdown after it) and Gaussian noise coloured by the aLIGO design PSD;
    returns (clean, noise, P on the rfft grid), float64."""
    t = np.arange(L_) / fs
    tc = 0.85 * L_ / fs
    tau = np.maximum(tc - t, 1e-4)
    f = np.minimum(30.0 * (tau / tc) ** (-3.0 / 8.0), 300.0)
    env = np.where(t < tc, (f / 300.0) ** (2.0 / 3.0),
                   np.exp(-(t - tc) / 0.01))
    clean = amp * env * np.cos(2 * np.pi * np.cumsum(f) / fs)
    freqs = np.fft.rfftfreq(L_, 1.0 / fs)
    P = tio.aligo_zdhp_psd_np(freqs)
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(len(freqs)) + 1j * rng.standard_normal(len(freqs))
    noise = np.fft.irfft(z * np.sqrt(P * fs * L_ / 4.0), n=L_)
    return clean, noise, P


@pytest.fixture(scope="module")
def meas():
    from scipy.signal import welch

    clean, noise, P = synth(LM, FS, 0)
    fw, Pw = welch(noise, fs=FS, nperseg=256)
    return types.SimpleNamespace(
        y=(clean + noise).astype(np.float32), clean=clean.astype(np.float32),
        P=P, welch=(fw, Pw), meta=dict(META))


def assert_equal_values(got, want):
    """Bit-equal: arrays (dtype too), tuples of arrays, scalars, None."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_equal_values(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_equal_values(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, float) and np.isnan(want):
        assert isinstance(got, float) and np.isnan(got)
    else:
        assert type(got) is type(want) and got == want


# ---------------------------------------------------------------------------
# float64 host preparation: bit-equal
# ---------------------------------------------------------------------------

# (name, prepare_measurement keywords, inputs): each whitening branch
BRANCHES = {
    "model": (dict(whiten=True, whiten_mode="model"), "P"),
    "model_interp": (dict(whiten=True, whiten_mode="model"), "P2"),
    "auto_model": (dict(whiten=True, whiten_mode="auto"), "P"),
    "model_degrades_to_train": (dict(whiten=True, whiten_mode="model"), ""),
    "saved_welch": (dict(whiten=True, whiten_mode="welch"), "W"),
    "auto_saved_welch": (dict(whiten=True, whiten_mode="auto"), "W"),
    "fresh_welch": (dict(whiten=True, whiten_mode="welch"), ""),
    "train": (dict(whiten=True, whiten_mode="train"), "PW"),
    "raw": (dict(whiten=False), "PW"),
}


def _prep_args(meas, inputs, clean=True):
    P = None
    if "P2" in inputs:      # a model PSD on another grid: interpolated
        P = tio.aligo_zdhp_psd_np(np.fft.rfftfreq(2 * LM, 1.0 / FS))
    elif "P" in inputs:
        P = meas.P
    welch = meas.welch if "W" in inputs else (None, None)
    return (meas.y, meas.clean if clean else None, FS, P, welch, meas.meta)


@pytest.mark.parametrize("sigma_mode", ["std", "mad", "fixed"])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_prepare_measurement_bit_equal(meas, branch, sigma_mode):
    kw, inputs = BRANCHES[branch]
    kw = dict(kw, cond_in_ch=5, M_SCALE=60.0, Q_SCALE=5.0,
              sigma_mode=sigma_mode, sigma_fixed=3.5)
    for clean in (True, False):
        args = _prep_args(meas, inputs, clean)
        want = jinf.prepare_measurement(*args, **kw)
        got = tinf.prepare_measurement(*args, **kw)
        assert_equal_values(got, want)
        x = want["y_for_cond"].astype(np.float64)
        np.testing.assert_array_equal(tinf.dewhiten_back(x, got),
                                      jinf.dewhiten_back(x, want))
    expected_kind = {"raw": "raw", "train": "train",
                     "model_degrades_to_train": "train"}.get(
        branch, "welch" if "welch" in branch else "model")
    assert got["whiten_kind_used"] == expected_kind


def test_degenerate_sigma_falls_back(meas, tmp_path):
    """Raw strain (~1e-21) is below the 1e-20 sigma floor: the domain's
    fallback is taken, from ``fallback_sigma.json`` beside the checkpoint
    when one is there."""
    ck = str(tmp_path / "ck.msgpack")
    args = _prep_args(meas, "")
    kw = dict(cond_in_ch=5, whiten=False, ckpt_path=ck)
    for fb_json, sigma in ((None, 2.914e-12),
                           ({"raw": {"median": 7e-21}, "train": {}}, 7e-21),
                           ("{not json", 2.914e-12)):
        if fb_json is not None:
            (tmp_path / "fallback_sigma.json").write_text(
                fb_json if isinstance(fb_json, str) else json.dumps(fb_json))
        want = jinf.prepare_measurement(*args, **kw)
        got = tinf.prepare_measurement(*args, **kw)
        assert_equal_values(got, want)
        assert got["sigma"] == sigma
        assert tinf.sigma_fallbacks(ck) == jinf.sigma_fallbacks(ck)


@pytest.mark.parametrize("cond_in_ch", [1, 3, 5, 7, 9])
def test_meta_to_stack_bit_equal(cond_in_ch):
    for meta in (META, {}, dict(META, q=float("nan")), dict(META, q=50.0)):
        assert_equal_values(tinf.meta_to_stack(meta, 64, cond_in_ch, 60.0, 5.0),
                            jinf.meta_to_stack(meta, 64, cond_in_ch, 60.0, 5.0))


def test_whitening_helpers_bit_equal(meas):
    P, y = meas.P, meas.y
    for name in ("psd_floor_np", "whiten_weight_np", "dewhiten_weight_np"):
        for arr in (P, np.zeros(5), np.array([0.0, 1e-50, 2.0])):
            assert_equal_values(getattr(tpipe, name)(arr),
                                getattr(jpipe, name)(arr))
    assert_equal_values(tpipe.interp_psd_np(P, len(P), 2 * LM, FS),
                        jpipe.interp_psd_np(P, len(P), 2 * LM, FS))
    assert tpipe.mad_std_np(y) == jpipe.mad_std_np(y)
    with pytest.raises(ValueError):
        tpipe.pick_sigma_np(y, "max", 1.0)
    assert tpipe.pick_sigma_np(np.zeros(8), "std", 1.0) == 1.0
    freqs = np.fft.rfftfreq(LM, 1.0 / FS)
    assert_equal_values(tio.aligo_zdhp_psd_np(freqs, 15.0),
                        jio.aligo_zdhp_psd_np(freqs, 15.0))
    d = tio.derive_model_psd_np(513, 4.0, 20.0)
    assert_equal_values(d, jio.derive_model_psd_np(513, 4.0, 20.0))
    assert d is tio.derive_model_psd_np(513, 4.0, 20.0) and not d.flags.writeable
    assert tio.INFERENCE_META_KEYS == jio.INFERENCE_META_KEYS


def test_inherit_whiten_domain_matches_jax():
    cases = [
        (dict(whiten=None, whiten_mode=None), CK),
        (dict(whiten=None, whiten_mode=None),
         dict(CK, whiten_mode="model", whiten_mode_resolved="train")),
        (dict(whiten=None, whiten_mode=None),
         {"whiten": True, "whiten_mode": "welch"}),
        (dict(whiten=1, whiten_mode="auto"), CK),
        (dict(whiten=0, whiten_mode="train"), CK),
        (dict(whiten=1, whiten_mode="train", allow_domain_mismatch=True), CK),
    ]
    for a, ck in cases:
        got, want = types.SimpleNamespace(**a), types.SimpleNamespace(**a)
        tinf.inherit_whiten_domain(got, ck)
        jinf.inherit_whiten_domain(want, ck)
        assert vars(got) == vars(want)
    for mod in (tinf, jinf):
        with pytest.raises(ValueError, match="allow-domain-mismatch"):
            mod.inherit_whiten_domain(
                types.SimpleNamespace(whiten=1, whiten_mode="welch"), CK)


def test_make_run_tag_string_equal():
    js, ts = jsch.make_schedule(1000), tsch.make_schedule(1000)
    for kw in ({}, dict(steps=10, eta=0.5, start_t=700, cfg_scale=1.0),
               dict(steps=7, cfg_mode="gauss", cfg_center=0.55,
                    init_mode="y-blend", pred_type="v", dc_weight=0.1,
                    refine_passes=2, refine_t=250),
               dict(eta=0, cfg_scale=2, cond_scale=1, eps_scale=0.9)):
        for whiten, mode, sig in ((True, "model", "std"), (False, "auto", "mad")):
            got = tinf.make_run_tag("ddim", tsp.SamplerConfig(**kw), ts,
                                    whiten, mode, sig)
            want = jinf.make_run_tag("ddim", jsp.SamplerConfig(**kw), js,
                                     whiten, mode, sig)
            assert got == want


# ---------------------------------------------------------------------------
# evals/metrics.py: every function bit-equal
# ---------------------------------------------------------------------------

def _metric_calls(rng):
    a, b = rng.standard_normal((2, 700))
    c = np.roll(a, 9) + 0.1 * b
    small = 1e-22 * a
    P = tio.aligo_zdhp_psd_np(np.fft.rfftfreq(700, 1.0 / FS))
    t = np.linspace(-0.2, 0.1, 700)
    return {
        "corr": [(a, c), (small, 1e-22 * c), (np.ones(5), a[:5])],
        "tail_mask": [(700, FS, 0.05)],
        "score_last_window": [(a, c, FS, 0.05), (a, c[:600], FS)],
        "best_lag_xcorr": [(a, c, 0), (a, c, 20), (c, a[:650], 5)],
        "align_xcorr": [(a, c, 1.0 / FS, 0), (a, c, 1.0 / FS, 30)],
        "align_peak": [(a, c), (c, a)],
        "apply_alignment": [(a, c, FS, m) for m in ("none", "peak", "xcorr")],
        "window_indices": [(w, a, FS) for w in ("full", "tail", "merger")],
        "merger_window_scores": [(a, c, t, 2.0), (a, c, t + 5.0, 2.0),
                                 (a, c, t, 0.0)],
        "residual_diagnostics": [(a, c), (a, c, b), (a, c, b, P > 0),
                                 (a[:10], c[:10])],
        "sweep_objective": [({"corr_last": 0.5, "nmae_sigma": 2.0},
                             {"corr_last": 0.25}), (None, None)],
        "matched_filter_snr": [(small + 1e-23 * b, small, P, FS),
                               (small, small, P, FS, 30.0),
                               (small, small, np.zeros_like(P), FS)],
    }


@pytest.mark.parametrize("name", sorted(_metric_calls(np.random.default_rng(0))))
def test_metrics_bit_equal(name):
    for args in _metric_calls(np.random.default_rng(0))[name]:
        assert_equal_values(getattr(tmet, name)(*args),
                            getattr(jmet, name)(*args))


# ---------------------------------------------------------------------------
# sampling pieces, with JAX's noise injected
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jm, params, tm = model_pair(L, **SMALL)
    clean, noise, P = synth(L, FS, 3, amp=1.0)
    js, ts = jsch.make_schedule(1000), tsch.make_schedule(1000)
    prep = jinf.prepare_measurement(
        (clean + noise).astype(np.float32), clean.astype(np.float32), FS, P,
        (None, None), META, cond_in_ch=5, M_SCALE=60.0, Q_SCALE=5.0,
        whiten=True, whiten_mode="model")
    return types.SimpleNamespace(jm=jm, params=params, tm=tm, js=js, ts=ts,
                                 prep=prep)


def _jfn(jm):
    return lambda p, x, t: jm.apply(p, x, t)


def test_lagged_xcorr_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 300)).astype(np.float32)
    b = np.roll(a, 7, axis=1) + 0.3 * rng.standard_normal((3, 300)).astype(np.float32)
    b[2] = -np.roll(a[2], -12)
    for ms in (299, 20, 3):
        xl_j, lag_j = jsp.lagged_xcorr(jnp.asarray(a), jnp.asarray(b), ms)
        xl_t, lag_t = tsp.lagged_xcorr(torch.from_numpy(a), torch.from_numpy(b), ms)
        np.testing.assert_allclose(xl_t.numpy(), np.asarray(xl_j), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_array_equal(lag_t.numpy(), np.asarray(lag_j))


def _assert_diag_close(got, want):
    assert set(got) == set(want)
    for k in ("t", "lag"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    for k in ("alpha_bar", "cfg_w"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    for k in ("corr", "xcorr_lag", "x_rms", "x0_rms", "eps_rms"):
        assert got[k].shape == np.asarray(want[k]).shape
        assert rel_err(got[k], want[k]) <= REL_TOL, k


@pytest.mark.parametrize("knobs", [dict(cfg_scale=1.5, eta=0.5),
                                   dict(cfg_scale=1.0, ladder="lambda",
                                        cfg_mode="gauss")])
def test_ddim_diagnostics_match_jax(pair, knobs):
    cfg_kw = dict(steps=4, pred_type="v", **knobs)
    cond = np.concatenate([pair.prep["cond_stack"]] * 2)
    key = jax.random.PRNGKey(2)
    want_x, want = jsp.ddim_sample(_jfn(pair.jm), pair.params, pair.js,
                                   jnp.asarray(cond), key,
                                   jsp.SamplerConfig(**cfg_kw),
                                   collect_diagnostics=True)
    n = len(tsp._t_ladder(pair.ts, tsp.SamplerConfig(**cfg_kw)))
    got_x, got = tsp.ddim_sample(pair.tm, pair.ts, torch.from_numpy(cond),
                                 tsp.SamplerConfig(**cfg_kw),
                                 jax_noise(key, n, (2, 1, L)),
                                 collect_diagnostics=True)
    assert rel_err(got_x, want_x) <= REL_TOL
    assert got["corr"].shape == (n, 2)
    _assert_diag_close(got, want)


@pytest.mark.parametrize("cfg_scale", [1.0, 1.5])
def test_one_step_proxy_and_proxy_reconstruct_match_jax(pair, cfg_scale):
    cfg_kw = dict(pred_type="v", cfg_scale=cfg_scale)
    kp = jax.random.PRNGKey(9)
    eps = tsp.FixedNoise(torch.from_numpy(np.array(
        jax.random.normal(kp, (1, 1, L), jnp.float32))))
    want = jinf.proxy_reconstruct(pair.jm, pair.params, pair.js, pair.prep,
                                  jsp.SamplerConfig(**cfg_kw), kp, 12.0)
    got = tinf.proxy_reconstruct(pair.tm, pair.ts, pair.prep,
                                 tsp.SamplerConfig(**cfg_kw), eps, 12.0,
                                 device="cpu")
    assert rel_err(got, want) <= REL_TOL


RECON_CASES = {
    "one_seed_diag": (dict(steps=3), dict(collect_diagnostics=True)),
    "three_seeds_median_mf_diag_refine": (
        dict(steps=3, refine_passes=1, refine_t=300, refine_steps=2),
        dict(avg_seeds=3, return_all_seeds=True, avg_mode="median",
             amp_calib="mf", collect_diagnostics=True)),
    "three_seeds_mean_mf": (dict(steps=3, ladder="lambda"),
                            dict(avg_seeds=3, amp_calib="mf")),
}


@pytest.mark.parametrize("case", sorted(RECON_CASES))
def test_reconstruct_matches_jax(pair, case):
    cfg_kw, kw = RECON_CASES[case]
    cfg_kw = dict(cfg_kw, pred_type="v", cfg_scale=1.5)
    S = kw.get("avg_seeds", 1)
    key = jax.random.PRNGKey(5)
    want = jinf.reconstruct(pair.jm, pair.params, pair.js, pair.prep,
                            jsp.SamplerConfig(**cfg_kw), key, **kw)
    tcfg = tsp.SamplerConfig(**cfg_kw)
    n = len(tsp._t_ladder(pair.ts, tcfg))
    if tcfg.refine_passes:
        # the base pass draws from split(key)[0]; refinement pass k from the
        # k-th split of split(key)[1]
        k_base, k_ref = jax.random.split(key)
        _, k_pass = jax.random.split(k_ref)
        noise = [jax_noise(k_base, n, (S, 1, L)), jax_noise(k_pass, 2, (S, 1, L))]
    else:
        noise = jax_noise(key, n, (S, 1, L))
    got = tinf.reconstruct(pair.tm, pair.ts, pair.prep, tcfg, noise,
                           device="cpu", **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            _assert_diag_close(g, w)
        elif w is None:
            assert g is None
        else:
            assert g.shape == np.asarray(w).shape
            assert rel_err(g, w) <= REL_TOL


def test_reconstruct_refuses_tiling_and_mesh(pair):
    """Tiling runs (two tiles of 128: finite, of the input's length); a
    ``mesh`` that is not a ``parallel.mesh.Mesh`` is refused."""
    cfg = tsp.SamplerConfig(steps=2)
    _, x0_white, _ = tinf.reconstruct(pair.tm, pair.ts, pair.prep, cfg,
                                      torch.Generator().manual_seed(0),
                                      device="cpu", tiled_chunk=128)
    assert x0_white.shape == (L,) and np.isfinite(x0_white).all()
    with pytest.raises(TypeError, match="make_mesh"):
        tinf.reconstruct(pair.tm, pair.ts, pair.prep, cfg, torch.Generator(),
                         device="cpu", tiled_chunk=128, mesh=object())


# ---------------------------------------------------------------------------
# the infer CLI end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A JAX-written HDF5 corpus (two samples, saved model and Welch PSDs)
    and a JAX-written checkpoint whose EMA weights differ from its raw
    ones."""
    from scipy.signal import welch

    d = tmp_path_factory.mktemp("infer_e2e")
    sig, noi, noisy, times, Ps, Pws, fws = [], [], [], [], [], [], []
    for i in range(2):
        clean, noise, P = synth(512, FS, 10 + i)
        fw, Pw = welch(noise, fs=FS, nperseg=256)
        sig.append(clean)
        noi.append(noise)
        noisy.append(clean + noise)
        times.append(np.arange(512) / FS)
        Ps.append(P)
        Pws.append(Pw)
        fws.append(fw)
    meta = {k: [v, v + 1.0] for k, v in META.items()}
    h5 = str(d / "corpus.h5")
    jio.write_dataset(h5, sig, noi, noisy, times, meta, FS, psd_model=Ps,
                      psd_welch=Pws, psd_welch_freqs=fws)
    _, params, _ = model_pair(L, seed=4, **SMALL)
    _, ema, _ = model_pair(L, seed=5, **SMALL)
    ckpt = str(d / "model" / "model.msgpack")
    jck.save_checkpoint(ckpt, params, CK, epoch=2, model_ema_state=ema)
    return types.SimpleNamespace(dir=d, h5=h5, ckpt=ckpt)


def _read_run(out):
    files = sorted(os.listdir(out))
    arrays = {f.split("_")[0] + ("_spread" if "spread" in f else ""):
              np.load(os.path.join(out, f)) for f in files if f.endswith(".npy")}
    (mname,) = [f for f in files if f.startswith("metrics_")]
    with open(os.path.join(out, mname)) as fh:
        metrics = json.load(fh)
    return files, arrays, metrics


def _assert_numbers_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_numbers_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, str):
        assert got == want, path
    else:
        assert abs(got - want) <= REL_TOL * abs(want), (path, got, want)


def test_infer_cli_matches_jax(corpus, monkeypatch):
    seed, S = 3, 2
    common = ["--input-h5", corpus.h5, "--index", "1", "--model", corpus.ckpt,
              "--steps", "3", "--avg-seeds", str(S), "--amp-calib", "mf",
              "--one-step-proxy", "--target-snr", "8", "--seed", str(seed)]
    jout, tout = str(corpus.dir / "jax_out"), str(corpus.dir / "port_out")
    jcli.main(common + ["--outdir", jout, "--log-jsonl",
                        str(corpus.dir / "jax.jsonl")])
    # JAX's draws: x_T from split(key)[0]; the proxy from split(key)[1]
    key = jax.random.PRNGKey(seed)
    k_init, kp = jax.random.split(key)

    def noise(seed_, device):
        assert seed_ == seed and str(device) == "cpu"
        return (jax_noise(key, 3, (S, 1, 512)),
                tsp.FixedNoise(torch.from_numpy(np.array(
                    jax.random.normal(kp, (1, 1, 512), jnp.float32)))))

    monkeypatch.setattr(tcli, "_noise", noise)
    tcli.main(common + ["--outdir", tout, "--log-jsonl",
                        str(corpus.dir / "port.jsonl"), "--device", "cpu"])

    jfiles, jarr, jmetrics = _read_run(jout)
    tfiles, tarr, tmetrics = _read_run(tout)
    assert tfiles == jfiles and len(tfiles) == 6
    assert tmetrics["tag"] == jmetrics["tag"]
    for k in ("sigma", "L", "whiten_kind", "start_t", "fs"):
        assert tmetrics[k] == jmetrics[k]
    assert tmetrics["whiten_kind"] == "model"
    for k in ("measurement", "clean"):
        assert tarr[k].dtype == jarr[k].dtype
        np.testing.assert_array_equal(tarr[k], jarr[k])
    for k in ("recon", "recon_spread", "proxy"):
        assert tarr[k].shape == jarr[k].shape == (512,)
        assert rel_err(tarr[k], jarr[k]) <= REL_TOL, k
    assert {"residuals", "seed_spread", "strain", "white", "merger", "mf_snr",
            "proxy"} <= set(tmetrics)
    _assert_numbers_close(tmetrics, jmetrics)
    with open(corpus.dir / "jax.jsonl") as a, open(corpus.dir / "port.jsonl") as b:
        jrec = [json.loads(ln) for ln in a]
        trec = [json.loads(ln) for ln in b]
    assert len(trec) == len(jrec) == 3
    for g, w in zip(trec, jrec):
        assert set(g) == set(w)
        for k in ("phase", "i", "t", "lag", "alpha_bar", "cfg_w"):
            assert g[k] == w[k]
        for k in ("xcorr_vs_y", "xcorr_lag"):
            assert abs(g[k] - w[k]) <= REL_TOL * abs(w[k]), k


def test_infer_cli_without_jax(corpus, tmp_path):
    """With jax, flax, msgpack, h5py and the JAX package blocked, the CLI's
    modules import, ``load_model`` reads a port-written checkpoint (EMA
    weights taken, outputs equal to the saved model's), the HDF5 reader
    explains that ``--input-npy`` needs no h5py, and the CLI runs on an
    ``.npy`` measurement.  So do the serving artifact's modules, the export
    and serve CLIs, the bench, ``entry()`` and the serving bench: they
    import, and a one-step artifact of the checkpoint is exported, loaded
    and validated."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "flax", "msgpack", "h5py",
                     "diffusion_models_for_gravitational_waveform_reconstruction_tpu"):
            sys.modules[name] = None
        import json, os
        import numpy as np
        import torch
        pkg = "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch"
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import infer
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import inference
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import hdf5io
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models.unet import UNet1D
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils import checkpoint
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import bench, graft_entry, serving
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import export, serve
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools import bench_serving
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils import roofline
        d = {str(tmp_path)!r}
        kw = dict(in_ch=7, base_ch=8, time_dim=16, depth=2, cond_in_ch=5,
                  use_selfcond=True, t_embed_max_time=999, device="cpu")
        raw, ema = UNet1D(**kw), UNet1D(**kw)
        with torch.no_grad():
            for p in ema.parameters():
                p.add_(0.1)
        args = {{"in_ch": 7, "cond_in_ch": 5, "base_ch": 8, "time_dim": 16,
                 "depth": 2, "T": 1000, "pred_type": "v", "whiten": 1,
                 "whiten_mode_resolved": "train"}}
        ck = os.path.join(d, "ck.msgpack")
        checkpoint.save_checkpoint(ck, raw.state_dict(), args, epoch=1,
                                   model_ema_state=ema.state_dict())
        model, schedule, ck_args = inference.load_model(ck, device="cpu")
        x, t = torch.randn(2, 7, 64), torch.tensor([3, 500])
        with torch.no_grad():
            assert torch.equal(model(x, t), ema(x, t))
        try:
            hdf5io.load_measurement(os.path.join(d, "none.h5"), 0)
            raise AssertionError("load_measurement ran without h5py")
        except ImportError as e:
            assert "--input-npy" in str(e)
        np.save(os.path.join(d, "y.npy"),
                np.random.default_rng(0).standard_normal(64).astype(np.float32))
        infer.main(["--input-npy", os.path.join(d, "y.npy"), "--model", ck,
                    "--outdir", os.path.join(d, "out"), "--steps", "2",
                    "--avg-seeds", "2", "--device", "cpu"])
        files = sorted(os.listdir(os.path.join(d, "out")))
        assert [f.split("_")[0] for f in files] == [
            "measurement", "metrics", "recon", "recon"], files
        art = os.path.join(d, "a.pt2")
        serving.export_sampler(ck, art, batch=1, length=64, device="cpu",
                               steps=1, avg_seeds=1)
        assert serving.validate_export(art, device="cpu") > 0
        assert bench.flops_per_sampler_step() > 0
        bad = [k for k, v in sys.modules.items() if v is not None
               and k.split(".")[0] in ("jax", "flax", "msgpack", "h5py")]
        assert not bad, bad
        print("ok")
    """)
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_infer_cli_needs_a_gpu_unless_told_cpu(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["--input-h5", corpus.h5, "--model", corpus.ckpt,
                   "--outdir", str(corpus.dir / "never")])
    assert not (corpus.dir / "never").exists()
    with pytest.raises(SystemExit):
        tcli.main(["--model", corpus.ckpt, "--device", "cpu"])
