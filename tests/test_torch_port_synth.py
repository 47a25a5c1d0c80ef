"""The PyTorch port's training data against the JAX package: the 3.5PN and
0PN chirps, sample generation with JAX's normal draws handed over, the
HDF5 corpus prepared into buckets, the batch schedule, the dataset resident
on the device and the synthetic corpus.

Tolerances: the host pipeline is the same float64 numpy, so buckets,
batches and meta scales are bit-equal.  The chirps are float32 in both
packages, but the port runs the time grid, the Newton inversion (to
convergence: 40 iterations, JAX 24) and the phase (hundreds to thousands
of radians) in float64 and JAX in float32: within 3e-3 of the waveform's
peak (measured 6.8e-4, near the merger); the
PN helper functions within 1e-5 relative; the coloured noise, PSD and
matched-filter sigma within 1e-5 of their peak (sigma measured 2.4e-6),
and sigma within 1e-5 of JAX's sigma of the port's own chirp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_models_for_gravitational_waveform_reconstruction_tpu.data import pipeline as jpipe
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.data import pn as jpn
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.data import synth as jsynth
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.data.hdf5io import (
    compute_meta_scale as jmeta_scale,
    write_dataset,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import hdf5io as thdf
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import pipeline as tpipe
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import pn as tpn
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import synth as tsynth

M1 = np.array([36.0, 20.0, 45.0])
M2 = np.array([29.0, 20.0, 10.0])
C1 = np.array([0.3, 0.6, -0.5])
C2 = np.array([-0.1, 0.6, 0.2])
PEAK_TOL = 3e-3
# one generation config for the JAX side of every sample test, so that its
# compiled programs are shared
SYN = dict(n=512, fs=1024)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float32)


def _peak_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("ringdown,taper", [("qnm", 1.0), ("qnm_c1", 0.7),
                                            ("isco", 1.0)])
def test_pn_chirp_matches_jax(ringdown, taper):
    want = np.stack([np.asarray(jpn.pn_chirp(
        M1[i], M2[i], C1[i], C2[i], n=2048, fs=2048, ringdown=ringdown,
        f_taper_frac=taper)) for i in range(3)])
    got = tpn.pn_chirp(_t(M1), _t(M2), _t(C1), _t(C2), n=2048, fs=2048,
                       ringdown=ringdown, f_taper_frac=taper)
    assert got.shape == (3, 2048) and got.dtype == torch.float32
    assert _peak_err(got.numpy(), want) <= PEAK_TOL
    one = tpn.pn_chirp(_t(M1[0]), _t(M2[0]), _t(C1[0]), _t(C2[0]), n=2048,
                       fs=2048, ringdown=ringdown, f_taper_frac=taper)
    assert torch.equal(one, got[0])             # a scalar sample alone


def test_pn_chirp_inversion_converges(monkeypatch):
    """One ulp more on every float64 log moves six 65536-sample chirps (10-20
    Msun, spins +-0.8) by under 1e-6 of their peak with the port's
    ``CHIRP_NEWTON_ITERS``; with JAX's 24 iterations some samples are still
    unconverged and it moves them by over 1e-4 (why the port runs 40)."""
    rng = np.random.default_rng(0)
    params = [_t(rng.uniform(lo, hi, 6)) for lo, hi in
              ((10, 20), (10, 20), (-0.8, 0.8), (-0.8, 0.8))]
    log = torch.log

    def moved(iters):
        monkeypatch.setattr(tpn, "CHIRP_NEWTON_ITERS", iters)
        kw = dict(n=65536, fs=4096, f_taper_frac=0.85)
        base = tpn.pn_chirp(*params, **kw)
        monkeypatch.setattr(torch, "log", lambda x: log(x) * (1 + 2 ** -52)
                            if x.dtype == torch.float64 else log(x))
        try:
            bumped = tpn.pn_chirp(*params, **kw)
        finally:
            monkeypatch.setattr(torch, "log", log)
        return float(((bumped - base).abs().amax(-1)
                      / base.abs().amax(-1)).max())

    assert tpn.CHIRP_NEWTON_ITERS == 40
    assert moved(40) <= 1e-6
    assert moved(24) > 1e-4


def test_pn_chirp_rejects_a_taper_out_of_range():
    with pytest.raises(ValueError, match="f_taper_frac"):
        tpn.pn_chirp(_t(30.0), _t(20.0), n=64, fs=1024, f_taper_frac=0.4)


def test_pn_helpers_match_jax():
    j = [jnp.asarray(a, jnp.float32) for a in (M1, M2, C1, C2)]
    t = [_t(a) for a in (M1, M2, C1, C2)]
    pairs = [(jpn.kerr_isco_f_gw(j[0], j[1], j[2]),
              tpn.kerr_isco_f_gw(t[0], t[1], t[2])),
             (jpn.pn_duration(*j), tpn.pn_duration(*t))]
    pairs += list(zip(jpn.final_mass_spin(*j), tpn.final_mass_spin(*t)))
    mf, af = jpn.final_mass_spin(*j)
    pairs += list(zip(jpn.qnm_f_tau(mf, af),
                      tpn.qnm_f_tau(*tpn.final_mass_spin(*t))))
    M_s, eta = jpn.mass_params(j[0], j[1])
    beta, sigma = jpn.spin_phasing_params(*j)
    tm, te = tpn.mass_params(t[0], t[1])
    tb, ts = tpn.spin_phasing_params(*t)
    v = jnp.asarray([0.2, 0.3, 0.35], jnp.float32)
    pairs.append((jpn.tau_of_v(v, M_s, eta, beta, sigma),
                  tpn.tau_of_v(_t(v), tm, te, tb, ts)))
    pairs.append((jpn.phase_of_v(v, M_s, eta, beta, sigma),
                  tpn.phase_of_v(_t(v), tm, te, tb, ts)))
    tau = jpn.tau_of_v(v, M_s, eta, beta, sigma)
    pairs.append((jpn.invert_tau(tau, M_s, eta, beta, sigma, 0.05, 0.45),
                  tpn.invert_tau(_t(tau), tm, te, tb, ts, 0.05, 0.45)))
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_newtonian_chirp_matches_jax():
    want = np.stack([np.asarray(jsynth.newtonian_chirp(
        M1[i], M2[i], n=2048, fs=2048)) for i in range(3)])
    got = tsynth.newtonian_chirp(_t(M1), _t(M2), n=2048, fs=2048)
    assert _peak_err(got.numpy(), want) <= PEAK_TOL


def test_generate_batch_matches_jax_with_its_draws():
    """JAX's normal draws (per sample: split the sample key into the real
    and imaginary parts' keys) handed to the port's generator."""
    snr = np.array([10.0, 20.0, 15.0])
    key = jax.random.PRNGKey(3)
    want = jsynth.generate_batch(key, *(jnp.asarray(a) for a in (M1, M2, snr,
                                                                  C1, C2)),
                                 config=jsynth.SynthConfig(**SYN))
    parts = [jax.random.split(k) for k in jax.random.split(key, 3)]
    normals = tuple(torch.from_numpy(np.stack([np.asarray(jax.random.normal(
        p[j], (SYN["n"] // 2 + 1,))) for p in parts])) for j in (0, 1))
    got = tsynth.generate_batch(None, *(_t(a) for a in (M1, M2, snr, C1, C2)),
                                config=tsynth.SynthConfig(**SYN),
                                normals=normals)
    assert _peak_err(got["signal"].numpy(), want["signal"]) <= PEAK_TOL
    for k in ("noise", "psd", "raw_sigma"):
        assert _peak_err(got[k].numpy(), want[k]) <= 1e-5, k
    # and raw_sigma against JAX's matched-filter sigma of the port's own
    # chirp, which leaves out the two chirps' difference
    c = tsynth.SynthConfig(**SYN)
    fp, fx = tsynth.resolve_antenna(c.ra, c.dec, c.polarization)
    h = tpn.pn_chirp(*(_t(a) for a in (M1, M2, C1, C2)), n=c.n, fs=c.fs,
                     distance=c.distance, f_lower=c.f_lower, fplus=fp,
                     fcross=fx, ringdown=c.ringdown,
                     f_taper_frac=c.f_taper_frac)
    sigma = jsynth.matched_filter_sigma(jnp.asarray(h.numpy()), want["psd"],
                                        c.fs, c.f_lower)
    assert _peak_err(got["raw_sigma"].numpy(), sigma) <= 1e-5
    torch.testing.assert_close(got["noisy"], got["signal"] + got["noise"])
    assert dataclass_fields(tsynth.SynthConfig) == dataclass_fields(
        jsynth.SynthConfig)


def dataclass_fields(cls):
    import dataclasses

    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_antenna_conventions_match_jax():
    assert tsynth.resolve_antenna(0.0, 0.0, 0.0) == (1.0, 0.0)
    for sky in [(1.0, 0.3, 0.2), (0.5, -0.7, 1.1)]:
        assert tsynth.resolve_antenna(*sky) == jsynth.resolve_antenna(*sky)
    with pytest.raises(ValueError, match="zero antenna"):
        tsynth.resolve_antenna(np.pi / 4, 0.0, 0.0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A ragged HDF5 corpus written by the JAX package's writer, with model
    PSDs and scalar metadata."""
    rng = np.random.default_rng(0)
    lengths = [900, 1000, 1024, 1500, 2048, 700, 1024]
    signal = [rng.normal(size=n).astype(np.float32) * 0.3 for n in lengths]
    noise = [rng.normal(size=n).astype(np.float32) for n in lengths]
    noisy = [s + x for s, x in zip(signal, noise)]
    times = [np.arange(n) / 4096.0 for n in lengths]
    n = len(lengths)
    psd = [thdf.aligo_zdhp_psd_np(np.fft.rfftfreq(L, 1 / 4096.0)) * 1e46
           + 1e-3 for L in lengths]
    meta = {"mass1": list(rng.uniform(20, 50, n)),
            "mass2": list(rng.uniform(10, 20, n)),
            "spin1z": list(rng.uniform(-0.5, 0.5, n)),
            "spin2z": [0.0] * n, "q": list(rng.uniform(1, 3, n)),
            "chirp_mass": list(rng.uniform(10, 30, n)), "snr": [10.0] * n}
    path = str(tmp_path_factory.mktemp("corpus") / "c.h5")
    write_dataset(path, signal, noise, noisy, times, meta, 4096.0,
                  psd_model=psd)
    return path


def _assert_datasets_equal(got, want):
    assert got.bucket_lengths == want.bucket_lengths
    for k in ("fs", "meta_scale", "whiten", "whiten_mode", "sigma_mode", "n",
              "whiten_mode_resolved"):
        assert getattr(got, k) == getattr(want, k), k
    for L in want.bucket_lengths:
        for k, v in want.buckets[L].items():
            assert got.buckets[L][k].dtype == v.dtype, (L, k)
            np.testing.assert_array_equal(got.buckets[L][k], v)


@pytest.mark.parametrize("kw", [dict(), dict(whiten=True),
                                dict(whiten=True, whiten_mode="train",
                                     sigma_mode="mad", max_len=1000),
                                dict(bucket_lengths=[1024, 4096],
                                     include_metadata=False)])
def test_prepare_dataset_is_bit_equal(corpus, kw):
    _assert_datasets_equal(tpipe.prepare_dataset(corpus, **kw),
                           jpipe.prepare_dataset(corpus, **kw))


def test_compute_meta_scale_matches_jax(corpus, tmp_path):
    assert thdf.compute_meta_scale(corpus) == jmeta_scale(corpus)
    bad = tmp_path / "not.h5"
    bad.write_bytes(b"not an hdf5 file")
    assert thdf.compute_meta_scale(str(bad)) == {"M": 80.0, "q": 10.0}


def test_iterate_batches_same_order(corpus):
    """Same seed, same batches; the device-resident gather (here on the
    CPU) gives the same rows as the host batches."""
    ds_j = jpipe.prepare_dataset(corpus)
    ds_t = tpipe.prepare_dataset(corpus)
    assert tpipe.num_batches(ds_t, 2) == jpipe.num_batches(ds_j, 2)
    assert tpipe.meta_dim(ds_t) == jpipe.meta_dim(ds_j) == 4
    for drop in (False, True):
        want = list(jpipe.iterate_batches(ds_j, 2, np.random.default_rng(3),
                                          drop_remainder=drop))
        got = list(tpipe.iterate_batches(ds_t, 2, np.random.default_rng(3),
                                         drop_remainder=drop))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    dev = tpipe.upload_buckets(ds_t, torch.device("cpu"))
    resident = list(tpipe.device_resident_batches(
        ds_t, 2, np.random.default_rng(3), dev))
    assert len(resident) == len(want := list(jpipe.iterate_batches(
        ds_j, 2, np.random.default_rng(3))))
    for g, w in zip(resident, want):
        assert set(g) == set(w) - {"index"}
        for k in g:
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    assert tpipe.upload_buckets(ds_t, torch.device("cpu"), budget_bytes=10) is None


def test_dataset_from_arrays_is_bit_equal():
    rng = np.random.default_rng(2)
    clean = rng.standard_normal((5, 64)).astype(np.float32)
    noisy = clean + rng.standard_normal((5, 64)).astype(np.float32)
    meta = rng.uniform(size=(5, 4)).astype(np.float32)
    for kw in (dict(), dict(sigma_mode="mad", whiten=True, meta=meta)):
        _assert_datasets_equal(
            tpipe.dataset_from_arrays(clean, noisy, 1024.0, **kw),
            jpipe.dataset_from_arrays(clean, noisy, 1024.0, **kw))


def test_synthetic_dataset_on_the_cpu():
    """The numpy draws (masses, SNRs, spins) and so the metadata and its
    scale equal the JAX package's; the noise is the port's own."""
    kw = dict(seed=4, segment_len=SYN["n"], fs=SYN["fs"], spin_max=0.5)
    got = tpipe.synthetic_dataset(3, device="cpu", **kw)
    want = jpipe.synthetic_dataset(3, **kw)
    assert got.bucket_lengths == want.bucket_lengths == [512]
    assert got.meta_scale == want.meta_scale
    for k in ("fs", "n", "whiten", "whiten_mode", "whiten_mode_resolved"):
        assert getattr(got, k) == getattr(want, k), k
    g, w = got.buckets[512], want.buckets[512]
    np.testing.assert_array_equal(g["meta"], w["meta"])
    for k in ("clean", "noisy", "sigma"):
        assert g[k].shape == w[k].shape and np.isfinite(g[k]).all()
    # whitened by the same PSD: the clean chirps agree within the chirps'
    # float32 tolerance, scaled to the same target SNRs
    assert _peak_err(g["clean"], w["clean"]) <= PEAK_TOL
    ratio = g["noisy"].std() / w["noisy"].std()
    assert 0.9 < ratio < 1.1
