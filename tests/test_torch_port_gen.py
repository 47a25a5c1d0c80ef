"""The PyTorch port's ``gw-gen`` and ``gw-merge`` and the corpus writer
against the JAX package's, on the CPU.

- the parser flag for flag, default for default (but ``--device``);
- ``build_specs`` bit-equal in the three modes, the probes and their
  errors, and the length buckets equal over dense draws of masses and spins
  (both engines; the PN engine at taper 0.85 and 1.0);
- both ``gw-gen`` CLIs to ``.h5`` with JAX's normal draws handed to the
  port: the files dataset for dataset and attribute for attribute; the
  port's ``.npz`` twin of that corpus read by every reader as the HDF5
  file; each package's readers on the other's files;
- ``generate_pycbc`` through a fake ``pycbc`` in both packages;
- ``gw-merge`` file for file against JAX's on HDF5, the ``.npz`` merge
  equal to the HDF5 merge, the checks and the domain warning.

Tolerances: specs, buckets, scalar columns, lengths, attributes and the
Welch grid are equal.  The chirps are float32 in both packages, but the
port inverts tau(v) to convergence and computes the phase in float64, JAX
in float32 with fewer iterations: each signal row
within 3e-3 of its peak (the bar of ``tests/test_torch_port_synth.py``),
and so the noisy rows.  Noise, the model PSD and the Welch PSDs within
1e-5 of each row's peak (float32 FFTs rounded in another order; the Welch
PSDs measured 7.6e-6 at most), and each Welch PSD within 1e-5 of JAX's
Welch PSD of the same noisy row.  The
merger time is the |signal| peak's sample, the same sample unless two
samples near the peak are closer than the signal tolerance.
"""
import argparse
import json
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_gen_pycbc_mock import fake_pycbc  # noqa: F401  (the fixture)

from diffusion_models_for_gravitational_waveform_reconstruction_tpu.cli import gen as jgen
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.cli import merge as jmerge
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.data import hdf5io as jio
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.data import pn as jpn
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import gen as tgen
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import merge as tmerge
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import hdf5io as tio

FS = 1024
PEAK_TOL = 3e-3
NOISE_TOL = 1e-5
# a random-mode corpus in two buckets (1024 and 2048 samples), 2 chunks of
# 4 in the larger, spins and every PSD saved
GEN_ARGS = ["--mode", "random", "--num-samples", "10", "--mass1-min", "35",
            "--mass1-max", "60", "--mass2-min", "25", "--mass2-max", "60",
            "--spin1-min", "-0.5", "--spin1-max", "0.5", "--spin2-min", "-0.5",
            "--spin2-max", "0.5", "--snr-min", "8", "--snr-max", "30",
            "--sampling-rate", str(FS), "--chunk", "4", "--save-psd",
            "--psd-nperseg", "512", "--seed", "7", "--device", "cpu"]


def jax_normals(seed, device):
    """The JAX engine's draws, chunk by chunk: its key split once a chunk,
    then once per sample, then into the real and imaginary parts."""
    state = {"key": jax.random.PRNGKey(seed)}

    def draw(rows, nf):
        state["key"], k = jax.random.split(state["key"])
        parts = jax.vmap(jax.random.split)(jax.random.split(k, rows))
        return tuple(torch.from_numpy(np.asarray(jax.vmap(
            lambda kk: jax.random.normal(kk, (nf,)))(parts[:, j]))).to(device)
            for j in (0, 1))
    return draw


def _peak_err(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-300))


def _attr(attrs, k):
    """A file attribute; ``config_args`` as its dict, less the output path
    (each run writes its own file)."""
    if k != "config_args":
        return attrs[k]
    cfg = json.loads(str(attrs[k]))
    cfg.pop("output_path")
    return cfg


def _args(argv):
    return tgen.build_parser().parse_args(argv)


# ---------------------------------------------------------------------------
# parser, specs, probes, buckets
# ---------------------------------------------------------------------------

def test_parser_matches_jax_but_device():
    base = ["--num-samples", "3", "--output-path", "x.h5"]
    got, want = vars(_args(base)), vars(jgen.build_parser().parse_args(base))
    assert got.pop("device") == "cuda" and want.pop("device") == "cpu"
    assert got == want
    tacts = {a.dest: a for a in tgen.build_parser()._actions}
    for a in jgen.build_parser()._actions:
        b = tacts[a.dest]
        assert (a.option_strings, a.type, a.choices, a.nargs, a.required) == (
            b.option_strings, b.type, b.choices, b.nargs, b.required), a.dest


@pytest.mark.parametrize("argv", [
    ["--mode", "fixed", "--mass1", "20", "--mass2", "35"],
    ["--mode", "random", "--mass1-min", "10", "--mass1-max", "80",
     "--mass2-min", "10", "--mass2-max", "80", "--spin1-min", "-0.8",
     "--spin1-max", "0.8", "--spin2-min", "-0.8", "--spin2-max", "0.8",
     "--snr-min", "8", "--snr-max", "30", "--max-seconds", "6"],
    ["--mode", "grid", "--mass1-min", "10", "--mass1-max", "90",
     "--mass2-min", "10", "--mass2-max", "90", "--grid-steps", "5",
     "--spin1-min", "-0.8", "--spin1-max", "0.8", "--augment-symmetric",
     "--shuffle", "--overgen-factor", "1.3", "--max-seconds", "8"],
    ["--mode", "grid", "--approximant", "newtonian", "--grid-steps", "3",
     "--mass1-min", "20", "--mass1-max", "40", "--mass2-min", "20",
     "--mass2-max", "40"],
])
def test_build_specs_match_jax(argv, capsys):
    argv = argv + ["--num-samples", "30", "--output-path", "x.h5"]
    got = tgen.build_specs(_args(argv), np.random.default_rng(5))
    out_t = capsys.readouterr().out
    want = jgen.build_specs(jgen.build_parser().parse_args(argv),
                            np.random.default_rng(5))
    assert capsys.readouterr().out == out_t
    assert got == want and len(got) >= 30


@pytest.mark.parametrize("argv,match", [
    (["--mode", "fixed", "--mass1", "300", "--mass2", "300"],
     r"fixed config \(m1=300.0, m2=300.0\) fails the probe"),
    (["--mode", "random", "--mass1-min", "5", "--mass1-max", "6",
      "--mass2-min", "5", "--mass2-max", "6", "--max-seconds", "2"],
     r"random mode: only 0/4 valid configs after 40 attempts"),
    (["--mode", "grid", "--mass1-min", "5", "--mass1-max", "60",
      "--mass2-min", "5", "--mass2-max", "60", "--grid-steps", "3",
      "--max-seconds", "4", "--require-complete-grid"],
     r"grid combos failed probe.*--require-complete-grid"),
    (["--mode", "grid", "--mass1-min", "300", "--mass1-max", "400",
      "--mass2-min", "300", "--mass2-max", "400", "--grid-steps", "2"],
     "grid mode: no valid"),
])
def test_probe_errors_match_jax(argv, match):
    argv = argv + ["--num-samples", "4", "--output-path", "x.h5"]
    with pytest.raises(SystemExit, match=match) as got:
        tgen.build_specs(_args(argv), np.random.default_rng(1))
    with pytest.raises(SystemExit) as want:
        jgen.build_specs(jgen.build_parser().parse_args(argv),
                         np.random.default_rng(1))
    assert str(got.value) == str(want.value)


def test_probe_and_durations_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(60):
        m1, m2 = sorted(rng.uniform(3.0, 260.0, 2), reverse=True)
        s1, s2 = rng.uniform(-0.95, 0.95, 2)
        for appr in ("pn", "newtonian"):
            args = (m1, m2, 20.0, 6.0, appr, s1, s2)
            assert tgen.probe_config(*args) == jgen.probe_config(*args)
            d_t = tgen.config_duration_s(m1, m2, 20.0, appr, s1, s2)
            d_j = jgen.config_duration_s(m1, m2, 20.0, appr, s1, s2)
            assert d_t == pytest.approx(d_j, rel=1e-5)


@pytest.mark.parametrize("approximant,taper", [("pn", 0.85), ("pn", 1.0),
                                               ("newtonian", 1.0)])
def test_buckets_match_jax(approximant, taper):
    """The JAX engine's bucketing (``generate_jax``) over a dense draw."""
    rng = np.random.default_rng(11)
    n = 3000 if approximant == "pn" else 300
    m = np.sort(rng.uniform(5.0, 100.0, (n, 2)), axis=1)[:, ::-1]
    s = rng.uniform(-0.9, 0.9, (n, 2))
    specs = [dict(m1=float(a), m2=float(b), s1=float(c), s2=float(d))
             for (a, b), (c, d) in zip(m, s)]
    args = argparse.Namespace(sampling_rate=4096, f_lower=20.0,
                              approximant=approximant, f_taper_frac=taper)
    got = tgen.bucket_specs(specs, args)
    if approximant == "pn":
        durs = np.asarray(jpn.pn_duration(*(jnp.asarray([x[k] for x in specs])
                                            for k in ("m1", "m2", "s1", "s2")),
                                          min(taper, 1.0) * 20.0))
        lens = [jgen.padded_pow2_len(float(d), 4096) for d in durs]
    else:
        lens = [jgen.bucket_length(x["m1"], x["m2"], 20.0, 4096) for x in specs]
    want = {}
    for i, L in enumerate(lens):
        want.setdefault(L, []).append(i)
    assert got == dict(sorted(want.items())) and len(got) >= 4


# ---------------------------------------------------------------------------
# the two CLIs, file against file
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    d = tmp_path_factory.mktemp("gen")
    paths = {k: str(d / f"{k}") for k in ("jax.h5", "port.h5", "port.npz")}
    jgen.main(GEN_ARGS + ["--output-path", paths["jax.h5"]])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgen, "_normals", jax_normals)
        summary = tgen.main(GEN_ARGS + ["--output-path", paths["port.h5"]])
        tgen.main(GEN_ARGS + ["--output-path", paths["port.npz"]])
    paths["summary"] = summary
    paths["dir"] = d
    return paths


def _h5(path):
    with h5py.File(path, "r") as f:
        data = {k: f[k][:] for k in f.keys()}
        attrs = dict(f.attrs)
    return data, attrs


def _jax_welch(noisy):
    """JAX's gw-gen Welch PSD of one noisy row (strain x STRAIN_SCALE in
    float32 through ``ops.whiten.welch_psd``, undone in float64)."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu.data.synth import (
        STRAIN_SCALE,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu.ops.whiten import (
        welch_psd,
    )

    args = jgen.build_parser().parse_args(GEN_ARGS + ["--output-path", "x"])
    arr = (np.asarray(noisy, np.float64)[None] * STRAIN_SCALE).astype(
        np.float32)
    _, P = welch_psd(jnp.asarray(arr), FS,
                     nperseg=min(args.psd_nperseg, arr.shape[1]),
                     noverlap=args.psd_noverlap)
    return np.asarray(P, np.float64)[0] / STRAIN_SCALE ** 2


def test_gen_cli_files_match_jax(corpora):
    got, got_attrs = _h5(corpora["port.h5"])
    want, want_attrs = _h5(corpora["jax.h5"])
    assert corpora["summary"]["buckets"] == {1024: 3, 2048: 7}
    assert sorted(got) == sorted(want) and got_attrs.keys() == want_attrs.keys()
    for k, v in want_attrs.items():
        assert _attr(got_attrs, k) == _attr(want_attrs, k), k
    n = len(want["lengths"])
    for k in ("lengths", "psd_detector", "mass1", "mass2", "spin1z", "spin2z",
              "snr", "label_m1", "label_m2", "label_s1", "label_s2", "q",
              "chirp_mass", "epoch", "psd_len", "psd_df", "psd_f_lower"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for i in range(n):
        sig_peak = np.abs(want["signal"][i]).max()
        assert _peak_err(got["signal"][i], want["signal"][i]) <= PEAK_TOL
        assert float(np.abs(got["noisy"][i] - want["noisy"][i]).max()) \
            <= PEAK_TOL * sig_peak
        for k in ("noise", "psd", "psd_model", "psd_welch"):
            assert _peak_err(got[k][i], want[k][i]) <= NOISE_TOL, (k, i)
        assert _peak_err(got["psd_welch"][i],
                         _jax_welch(got["noisy"][i])) <= NOISE_TOL, i
        np.testing.assert_array_equal(got["psd_welch_freqs"][i],
                                      want["psd_welch_freqs"][i])
        shift = got["t_merger"][i] - want["t_merger"][i]
        assert shift == 0.0 or abs(shift) == pytest.approx(1.0 / FS)
        np.testing.assert_allclose(got["times"][i] + shift, want["times"][i],
                                   rtol=0, atol=1e-12)


def test_npz_twin_reads_as_the_h5(corpora):
    h5, npz = corpora["port.h5"], corpora["port.npz"]
    a, b = tio.load_full(h5), tio.load_full(npz)
    assert a.keys() == b.keys()
    for k in a:
        if k in ("path", "attrs"):
            continue
        assert type(a[k]) is type(b[k]), k
        if isinstance(a[k], list):
            for x, y in zip(a[k], b[k]):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k
    assert a["attrs"].keys() == b["attrs"].keys()
    for k in a["attrs"]:
        assert _attr(a["attrs"], k) == _attr(b["attrs"], k), k
    n = tio.num_samples(npz)
    assert n == tio.num_samples(h5) == 10
    for i in range(n):
        ma, mb = tio.load_measurement(h5, i), tio.load_measurement(npz, i)
        for x, y in zip(ma[:4], mb[:4]):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(ma[4], mb[4]):
            np.testing.assert_array_equal(x, y)
        assert ma[5] == mb[5]
    for x, y in zip(tio.load_labels(h5), tio.load_labels(npz)):
        np.testing.assert_array_equal(x, y)
    assert tio.compute_meta_scale(h5) == tio.compute_meta_scale(npz)
    data, _ = _h5(h5)
    with np.load(npz) as z:            # plain numpy reads it too
        assert "times" not in z.files and "psd" not in z.files
        for k in ("t_merger", "lengths", "noise__offsets"):
            assert k in z.files
        np.testing.assert_array_equal(z["t_merger"], data["t_merger"])
        np.testing.assert_array_equal(z["psd_detector"].astype(bytes),
                                      data["psd_detector"])
        assert json.loads(str(z["config_args"]))["seed"] == 7
        off = z["noise__offsets"]
        for i in range(n):
            np.testing.assert_array_equal(z["noise"][off[i]:off[i + 1]],
                                          data["noise"][i])


def test_readers_cross_the_packages(corpora, tmp_path):
    """The JAX readers on the port's HDF5 file; the port's readers on the
    JAX-written ragged file and on its twin from ``corpus_to_npz``."""
    a, b = jio.load_full(corpora["port.h5"]), tio.load_full(corpora["port.h5"])
    for k in ("noisy", "signal", "psd_model", "psd_welch"):
        for x, y in zip(a[k], b[k]):
            np.testing.assert_array_equal(x, y)
    twin = str(tmp_path / "jax_twin.npz")
    tio.corpus_to_npz(corpora["jax.h5"], twin)
    want = jio.load_full(corpora["jax.h5"])
    for got in (tio.load_full(corpora["jax.h5"]), tio.load_full(twin)):
        for k in ("noisy", "signal", "psd_model", "psd_welch",
                  "psd_welch_freqs"):
            assert len(got[k]) == len(want[k])
            for x, y in zip(got[k], want[k]):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
        for k in ("mass1", "snr", "label_m2", "fs", "n"):
            np.testing.assert_array_equal(got[k], want[k])
    with np.load(twin) as z:
        assert z["noisy"].ndim == 1 and "noisy__offsets" in z.files


def test_generate_matches_jax_at_length(monkeypatch):
    """``generate`` with JAX's draws at the longest bucket this test can
    afford, 16384 samples (4 s at 4096 Hz)."""
    argv = ["--mode", "random", "--num-samples", "2", "--mass1-min", "20",
            "--mass1-max", "24", "--mass2-min", "18", "--mass2-max", "22",
            "--spin1-min", "-0.6", "--spin1-max", "0.6", "--snr-min", "8",
            "--snr-max", "30", "--output-path", "x.h5", "--device", "cpu"]
    args_t, args_j = _args(argv), jgen.build_parser().parse_args(argv)
    args_t.f_taper_frac = args_j.f_taper_frac = 0.85
    specs = tgen.build_specs(args_t, np.random.default_rng(4))
    want = jgen.generate_jax(specs, args_j)
    monkeypatch.setattr(tgen, "_normals", jax_normals)
    got = tgen.generate(specs, args_t, "cpu")
    for i in want:
        assert got[i]["n"] == want[i]["n"] == 16384
        assert _peak_err(got[i]["signal"], want[i]["signal"]) <= PEAK_TOL
        for k in ("noise", "psd"):
            assert _peak_err(got[i][k], want[i][k]) <= NOISE_TOL, k


def test_gen_runs_on_the_gpu_by_default(tmp_path):
    argv = ["--num-samples", "1", "--output-path", str(tmp_path / "x.npz")]
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.main(argv)
    assert not (tmp_path / "x.npz").exists()


def test_gen_refuses_a_plot_without_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(tgen.importlib.util, "find_spec", lambda name: None)
    with pytest.raises(SystemExit, match="need matplotlib"):
        tgen.main(["--num-samples", "1", "--output-path",
                   str(tmp_path / "x.npz"), "--plot", "--device", "cpu"])


def test_generate_pycbc_matches_jax(fake_pycbc):  # noqa: F811
    specs = [dict(m1=30.0, m2=25.0, s1=0.5, s2=-0.3, snr=12.0),
             dict(m1=40.0, m2=20.0, s1=0.1, s2=0.2, snr=8.0)]
    argv = ["--mode", "fixed", "--num-samples", "2", "--output-path", "x.h5",
            "--engine", "pycbc"]
    got = tgen.generate_pycbc(specs, _args(argv))
    want = jgen.generate_pycbc(specs, jgen.build_parser().parse_args(argv))
    assert len(fake_pycbc["td"]) == 4 and got.keys() == want.keys()
    for i in want:
        assert got[i]["n"] == want[i]["n"]
        for k in ("signal", "noise", "noisy", "psd"):
            assert got[i][k].dtype == want[i][k].dtype
            np.testing.assert_array_equal(got[i][k], want[i][k])


def test_generate_pycbc_without_pycbc(monkeypatch):
    monkeypatch.setitem(sys.modules, "pycbc", None)
    with pytest.raises(SystemExit, match="requires the 'pycbc' package"):
        tgen.generate_pycbc([], _args(["--num-samples", "1",
                                       "--output-path", "x.h5"]))


# ---------------------------------------------------------------------------
# gw-merge
# ---------------------------------------------------------------------------

def _make(path, rng, n, cfg=None, welch=False, fs=4096.0):
    lengths = rng.integers(800, 2000, size=n)
    signal = [rng.normal(size=L).astype(np.float32) for L in lengths]
    noise = [rng.normal(size=L).astype(np.float32) for L in lengths]
    noisy = [s + x for s, x in zip(signal, noise)]
    times = [np.arange(L) / fs for L in lengths]
    meta = {"mass1": rng.uniform(20, 50, n), "mass2": rng.uniform(20, 50, n),
            "snr": np.full(n, 10.0)}
    kw = {}
    if welch:
        kw = dict(psd_welch=[np.full(33, float(i)) for i in range(n)],
                  psd_welch_freqs=[np.arange(33.0)] * n)
    tio.write_dataset(str(path), signal, noise, noisy, times, meta, fs,
                      detectors=["H1"] * n,
                      psd_model=[np.ones(L // 2 + 1) for L in lengths],
                      attrs_extra={"config_args": json.dumps(cfg or {})}, **kw)


def _pair(tmp_path, rng, cfgs=(None, None), welch=(True, True)):
    """Two inputs, each written as HDF5 and as its twin from the same
    arrays."""
    paths = []
    for j, (cfg, w) in enumerate(zip(cfgs, welch)):
        seed = int(rng.integers(1 << 30))
        for ext in ("h5", "npz"):
            _make(tmp_path / f"in{j}.{ext}", np.random.default_rng(seed),
                  4 + j, cfg, w)
        paths.append(str(tmp_path / f"in{j}"))
    return paths


@pytest.mark.parametrize("welch", [(True, False), (True, True)])
def test_merge_matches_jax_and_the_twin_merge(tmp_path, rng, capsys, welch):
    """Welch PSDs in one input (dropped, said on stderr) or in both (rows of
    one length: h5py's per-row fallback)."""
    a, b = _pair(tmp_path, rng, welch=welch)
    jmerge.merge(str(tmp_path / "j.h5"), [a + ".h5", b + ".h5"])
    want_err = capsys.readouterr().err
    assert tmerge.merge(str(tmp_path / "t.h5"), [a + ".h5", b + ".h5"]) == 9
    assert capsys.readouterr().err == want_err
    assert ("psd_welch" in want_err) != all(welch)
    got, got_attrs = _h5(tmp_path / "t.h5")
    want, want_attrs = _h5(tmp_path / "j.h5")
    assert sorted(got) == sorted(want) and got_attrs == want_attrs
    for k in want:
        assert got[k].dtype == want[k].dtype
        for x, y in zip(got[k], want[k]):
            np.testing.assert_array_equal(x, y)
    tmerge.main(["--output-path", str(tmp_path / "t.npz"), a + ".npz",
                 b + ".npz"])
    assert "wrote 9 samples" in capsys.readouterr().out
    with tio.open_corpus(str(tmp_path / "t.npz"), "", "") as f:
        assert sorted(f.keys()) == sorted(set(want) - {"times", "psd"})
        assert f["noisy"].ragged and f["mass1"].shape == (9,)
        for k in f.keys():
            for x, y in zip(f[k][:], want[k]):
                np.testing.assert_array_equal(
                    x.astype(bytes) if k == "psd_detector" else x, y)
        attrs = dict(f.attrs)
    merged_from = [(r["n"]) for r in json.loads(str(attrs.pop("merged_from")))]
    assert merged_from == [4, 5]
    want_attrs.pop("merged_from")
    assert attrs == want_attrs


def test_merge_equal_length_twins_become_ragged(tmp_path, rng):
    """Two equal-length twins of different lengths: the merge holds both
    forms' rows, flat with offsets."""
    for j, L in enumerate((64, 96)):
        tio.save_corpus_npz(str(tmp_path / f"e{j}.npz"),
                            [np.full(L, j, np.float32)] * 3,
                            [np.full(L, j + 1, np.float32)] * 3,
                            {"mass1": [30.0] * 3}, 4096.0)
    tmerge.merge(str(tmp_path / "m.npz"), [str(tmp_path / "e0.npz"),
                                           str(tmp_path / "e1.npz")])
    full = tio.load_full(str(tmp_path / "m.npz"))
    assert [len(r) for r in full["noisy"]] == [64] * 3 + [96] * 3
    assert float(full["noisy"][4][0]) == 2.0 and full["n"] == 6
    tmerge.merge(str(tmp_path / "s.npz"), [str(tmp_path / "e0.npz")] * 2)
    with np.load(tmp_path / "s.npz") as z:
        assert z["noisy"].shape == (6, 64)      # equal lengths stay (N, L)


@pytest.mark.parametrize("ext", ["h5", "npz"])
def test_merge_domain_warning_and_checks(tmp_path, rng, capsys, ext):
    cfgs = ({"approximant": "pn", "ringdown": "qnm", "f_taper_frac": 1.0},
            {"approximant": "pn", "ringdown": "qnm_c1", "f_taper_frac": 0.85})
    a, b = _pair(tmp_path, rng, cfgs)
    out = str(tmp_path / f"m.{ext}")
    assert tmerge.merge(out, [a + f".{ext}", b + f".{ext}"]) == 9
    err = capsys.readouterr().err
    assert "ringdown" in err and "f_taper_frac" in err and "mixes" in err
    c, d = _pair(tmp_path, rng, (cfgs[0], cfgs[0]))
    tmerge.merge(out, [c + f".{ext}", d + f".{ext}"])
    assert "mixes" not in capsys.readouterr().err
    with pytest.raises(ValueError, match="also an input"):
        tmerge.merge(out, [out, c + f".{ext}"])
    with pytest.raises(ValueError, match="corpus_to_npz"):
        tmerge.merge(out, [c + ".h5", d + ".npz"])
    _make(tmp_path / f"f.{ext}", rng, 2, fs=8192.0)
    with pytest.raises(ValueError, match="sampling_rate"):
        tmerge.merge(str(tmp_path / f"x.{ext}"),
                     [c + f".{ext}", str(tmp_path / f"f.{ext}")])
