"""The PyTorch port's ``ops/whiten.py`` against the JAX package's: the same
seeded numpy inputs through both, float32.

Tolerances: every function within 1e-4 of the JAX result's largest
magnitude (the module bar; both packages round the same float32 FFTs in
another order); ``welch_psd`` against ``scipy.signal.welch`` in float64
within rtol 2e-3 (JAX's own bar, ``tests/test_whiten.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import welch as scipy_welch

from diffusion_models_for_gravitational_waveform_reconstruction_tpu.ops import whiten as jw
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops import whiten as tw

BAR = 1e-4
FS = 1024.0


def _inputs(seed=0, rows=3, L=600):
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((rows, L)) * 2.0 + 0.3).astype(np.float32)
    x = (0.5 * rng.standard_normal((rows, L))).astype(np.float32)
    P = np.abs(rng.standard_normal(L // 2 + 1)).astype(np.float32) + 0.1
    P[:5] = 0.0                      # out of band
    return y, x, P


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= BAR * scale


def _pair(fn, *args, **kw):
    """fn of both modules on the same arrays."""
    j = getattr(jw, fn)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                          for a in args), **kw)
    t = getattr(tw, fn)(*(torch.from_numpy(np.array(a))
                          if isinstance(a, np.ndarray) else a for a in args),
                        **kw)
    return t, j


@pytest.mark.parametrize("fn", ["psd_floor", "whiten_weight",
                                "dewhiten_weight"])
def test_floors_and_weights_match_jax(fn):
    _, _, P = _inputs()
    _close(*_pair(fn, np.stack([P, 0.0 * P])))


@pytest.mark.parametrize("L", [600, 601])
def test_smoothing_and_train_psd_match_jax(L):
    """At 9 rfft bins or fewer nothing is smoothed (checked alone): the DC
    bin of y - mean(y) is then float32 rounding, amplified by the floor,
    which no two FFTs round alike."""
    y, x, _ = _inputs(1, L=L)
    P = np.abs(y) ** 2
    _close(*_pair("_boxcar_smooth_same", P))
    _close(*_pair("_boxcar_smooth_same", P[:, :9]))
    _close(*_pair("train_psd", y))
    (ty, tx, tP), (jy, jx, jP) = _pair("whiten_train_like", y, x)
    for got, want in ((ty, jy), (tx, jx), (tP, jP)):
        _close(got, want)
    assert _pair("whiten_train_like", y)[0][1] is None
    _close(*_pair("dewhiten_train_like", y, np.asarray(jP)))


def test_model_psd_whitening_matches_jax():
    y, x, P = _inputs(2)
    (ty, tx), (jy, jx) = _pair("whiten_with_psd", y, x, P)
    _close(ty, jy)
    _close(tx, jx)
    _close(*_pair("dewhiten_with_psd", y, P))
    for L_src, L_tgt in ((301, 600), (301, 1000), (101, 600)):
        _close(*_pair("interp_psd_to_length", P[:L_src], L_src, L_tgt, FS))
    _close(tw.rfftfreq(600, 1.0 / FS), jw.rfftfreq(600, 1.0 / FS))


@pytest.mark.parametrize("n", [512, 333])
def test_hann_window_matches_jax_and_scipy(n):
    from scipy.signal import get_window

    _close(tw.hann_window(n), jw.hann_window(n).astype(jnp.float32))
    np.testing.assert_allclose(tw.hann_window(n, torch.float64).numpy(),
                               get_window("hann", n), atol=1e-12)


@pytest.mark.parametrize("detrend,nperseg,noverlap", [
    ("constant", 256, None), ("none", 256, None), ("constant", 255, 100),
    ("constant", 4096, None)])
def test_welch_matches_jax_and_scipy(detrend, nperseg, noverlap):
    rng = np.random.default_rng(3)
    y = (rng.standard_normal((4, 2048)) + 3.0).astype(np.float32)
    tf, tP = tw.welch_psd(torch.from_numpy(y), FS, nperseg=nperseg,
                          noverlap=noverlap, detrend=detrend)
    jf, jP = jw.welch_psd(jnp.asarray(y), FS, nperseg=nperseg,
                          noverlap=noverlap, detrend=detrend)
    _close(tf, jf)
    _close(tP, jP)
    sf, sP = scipy_welch(y.astype(np.float64), fs=FS,
                         nperseg=min(nperseg, 2048), noverlap=noverlap,
                         detrend=False if detrend == "none" else "constant")
    np.testing.assert_allclose(tf.numpy(), sf, rtol=1e-6)
    np.testing.assert_allclose(tP.numpy(), sP, rtol=2e-3, atol=1e-8)
    with pytest.raises(ValueError, match="detrend"):
        tw.welch_psd(torch.from_numpy(y), FS, detrend="linear")


def test_whiten_with_welch_matches_jax():
    y, x, _ = _inputs(4)
    f_w = np.linspace(0.0, FS / 2, 129).astype(np.float32)
    P_w = (np.abs(np.random.default_rng(5).standard_normal(129)) + 0.5
           ).astype(np.float32)
    got = tw.whiten_with_welch(*(torch.from_numpy(a) for a in (y, x, f_w, P_w)),
                               FS)
    want = jw.whiten_with_welch(*(jnp.asarray(a) for a in (y, x, f_w, P_w)),
                                FS)
    for g, w in zip(got, want):
        _close(g, w)
    # outside the Welch grid: the end values, as np.interp
    f = torch.tensor([-5.0, 10.0, 600.0])
    np.testing.assert_allclose(
        tw.interp(f, torch.from_numpy(f_w), torch.from_numpy(P_w)).numpy(),
        np.interp(f.numpy(), f_w, P_w), rtol=1e-6)


@pytest.mark.parametrize("L", [600, 601])
@pytest.mark.parametrize("mode", ["std", "mad", "fixed"])
def test_sigma_matches_jax(mode, L):
    y, _, _ = _inputs(6, L=L)
    y[1] = 0.0                       # degenerate: sigma 1 (std, mad: 1e-24)
    _close(*_pair("pick_sigma", y, mode, 2.5))
    if mode == "mad":
        _close(*_pair("mad_std", y))
    with pytest.raises(ValueError, match="sigma mode"):
        tw.pick_sigma(torch.from_numpy(y), "iqr")
