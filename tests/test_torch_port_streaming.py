"""The PyTorch port's ``StreamingDataset``, ``prefetch_to_device`` and
``train(streaming=True)`` against the JAX package's, on an HDF5 corpus and
on both forms of its ``.npz`` twin; and the data side end to end with JAX,
h5py and matplotlib blocked from import.

Tolerances: none.  The host preparation is the same float64 numpy in both
packages, so batches (rows, order, whitening, sigma, metadata) are
bit-equal, and so are the dense loader's and the streaming loader's.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from diffusion_models_for_gravitational_waveform_reconstruction_tpu.data import pipeline as jpipe
from diffusion_models_for_gravitational_waveform_reconstruction_tpu.data.hdf5io import (
    write_dataset as jwrite,
)
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import hdf5io as tio
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import pipeline as tpipe
from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.training import train as tt

FS = 1024.0
KEYS = ("clean", "noisy", "mask", "sigma", "meta")


def _corpus(lengths, seed):
    rng = np.random.default_rng(seed)
    sig = [rng.normal(size=L).astype(np.float32) for L in lengths]
    noi = [rng.normal(size=L).astype(np.float32) for L in lengths]
    n = len(lengths)
    f_w = np.fft.rfftfreq(64, 1.0 / FS)
    kw = dict(
        detectors=["H1"] * n,
        psd_model=[np.where(np.arange(L // 2 + 1) > 4,
                            1.0 + rng.random(L // 2 + 1), 0.0)
                   for L in lengths],
        psd_welch=[1.0 + rng.random(33) for _ in lengths],
        psd_welch_freqs=[f_w] * n)
    meta = {"mass1": rng.uniform(20, 50, n), "mass2": rng.uniform(20, 50, n),
            "spin1z": rng.uniform(-0.5, 0.5, n), "spin2z": np.zeros(n),
            "q": np.ones(n), "chirp_mass": rng.uniform(15, 40, n),
            "snr": np.full(n, 10.0)}
    return ([sig, noi, [s + x for s, x in zip(sig, noi)],
             [np.arange(L) / FS for L in lengths], meta, FS], kw)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A ragged corpus as HDF5 (the JAX writer), its full twin (the port's
    writer) and its ``corpus_to_npz`` twin; an equal-length corpus as HDF5
    and its (N, L) twin."""
    d = tmp_path_factory.mktemp("stream")
    out = {}
    args, kw = _corpus([300, 700, 512, 1000, 260, 900, 640, 333, 1024], 0)
    out["h5"] = str(d / "ragged.h5")
    jwrite(out["h5"], *args, **kw)
    out["twin"] = str(d / "ragged.npz")
    tio.write_dataset(out["twin"], *args, **kw)
    out["c2n"] = str(d / "ragged_c2n.npz")
    tio.corpus_to_npz(out["h5"], out["c2n"])
    args, kw = _corpus([512] * 7, 1)
    out["eq_h5"] = str(d / "equal.h5")
    jwrite(out["eq_h5"], *args, **kw)
    out["eq_twin"] = str(d / "equal.npz")
    tio.corpus_to_npz(out["eq_h5"], out["eq_twin"])
    return out


def _same(got, want, keys=KEYS + ("index",)):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in keys:
            g_k = g[k].numpy() if isinstance(g[k], torch.Tensor) else g[k]
            assert g_k.dtype == w[k].dtype, k
            np.testing.assert_array_equal(g_k, w[k], err_msg=k)


@pytest.mark.parametrize("mode", ["model", "welch", "train"])
@pytest.mark.parametrize("shuffle,drop", [(True, False), (False, False),
                                          (True, True)])
@pytest.mark.parametrize("name,ref", [("h5", "h5"), ("twin", "h5"),
                                      ("c2n", "h5"), ("eq_twin", "eq_h5")])
def test_streaming_batches_match_jax(files, name, ref, shuffle, drop, mode):
    kw = dict(whiten=True, whiten_mode=mode, sigma_mode="std", chunk=3)
    got_ds = tpipe.StreamingDataset(files[name], **kw)
    want_ds = jpipe.StreamingDataset(files[ref], **kw)
    assert got_ds.bucket_lengths == want_ds.bucket_lengths
    assert got_ds.whiten_mode_resolved == want_ds.whiten_mode_resolved == mode
    assert got_ds.num_batches(2, drop) == want_ds.num_batches(2, drop)
    for epoch in range(2):
        _same(list(got_ds.iter_batches(2, np.random.default_rng(epoch),
                                       shuffle=shuffle, drop_remainder=drop)),
              list(want_ds.iter_batches(2, np.random.default_rng(epoch),
                                        shuffle=shuffle, drop_remainder=drop)))
    assert got_ds.peak_live_samples == want_ds.peak_live_samples


@pytest.mark.parametrize("name", ["twin", "eq_twin"])
def test_streaming_matches_the_dense_loader(files, name):
    dense = tpipe.prepare_dataset(files[name], whiten=True)
    stream = tpipe.StreamingDataset(files[name], whiten=True, chunk=4)
    assert stream.bucket_lengths == dense.bucket_lengths
    assert stream.n == dense.n and stream.meta_scale == dense.meta_scale
    _same(list(tpipe.iterate_batches(stream, 3, np.random.default_rng(0),
                                     shuffle=False)),
          list(tpipe.iterate_batches(dense, 3, np.random.default_rng(0),
                                     shuffle=False)))


def test_streaming_reads_only_its_chunks(files):
    """On the twin each chunk load reads exactly its rows of the series it
    takes (noisy, signal, the model and Welch PSDs), and the LRU bounds the prepared
    samples held, as JAX's test bounds them."""
    ds = tpipe.StreamingDataset(files["twin"], whiten=True,
                                whiten_mode="model", chunk=2, cache_chunks=1)
    lengths = tio.load_full(files["twin"])
    for Lb in ds.bucket_lengths:
        for ci in range(-(-len(ds._bucket_idx[Lb]) // 2)):
            before = ds.bytes_read
            ds._load_chunk(Lb, ci)
            rows = ds._bucket_idx[Lb][2 * ci:2 * ci + 2]
            want = sum(8 * len(lengths["noisy"][i])
                       + 8 * len(lengths["psd_model"][i])
                       + 16 * len(lengths["psd_welch"][i]) for i in rows)
            assert ds.bytes_read - before == want
    rng = np.random.default_rng(1)
    for _ in range(3):
        seen = []
        for b in ds.iter_batches(2, rng, shuffle=True, drop_remainder=True):
            seen.extend(b["index"].tolist())
        assert len(seen) == len(set(seen))
    assert ds.peak_live_samples <= 2 * 1


def test_device_residency_and_prefetch(files):
    """``iter_batches_device`` (here on the CPU): the batches of
    ``iter_batches`` with the same ``rng``; the first epoch copies every
    chunk once, the second nothing; over the budget every epoch copies
    every chunk again.  ``prefetch_to_device`` gives the host batches as tensors."""
    kw = dict(whiten=True, chunk=2, cache_chunks=1)
    host = tpipe.StreamingDataset(files["twin"], **kw)
    dev = tpipe.StreamingDataset(files["twin"], **kw)
    want = list(host.iter_batches(2, np.random.default_rng(7)))
    _same(list(dev.iter_batches_device(2, np.random.default_rng(7),
                                       device="cpu")), want, KEYS)
    first = dev.h2d_bytes_epoch
    assert first == sum(v.nbytes for c in dev._dev_chunks.values()
                        for v in c.values()) > 0
    list(dev.iter_batches_device(2, np.random.default_rng(8), device="cpu"))
    assert dev.h2d_bytes_epoch == 0
    assert dev.peak_live_samples <= 2 * dev.cache_chunks + 2
    small = tpipe.StreamingDataset(files["twin"], **kw)
    for seed in (7, 8):
        list(small.iter_batches_device(2, np.random.default_rng(seed),
                                       budget_bytes=1, device="cpu"))
        # every chunk at least once (a tail's wrap-fill copies one again)
        assert small.h2d_bytes_epoch >= first
    assert not small._dev_chunks
    assert tpipe.upload_buckets(small, "cpu") is None
    _same(list(tpipe.prefetch_to_device(iter(want), size=2, device="cpu")),
          want, KEYS)


def _train_cfg(tmp_path, data, name, **kw):
    return tt.TrainConfig(**dict(
        dict(data=data, model_dir=str(tmp_path / name), epochs=2,
             batch_size=2, base_ch=8, time_dim=16, depth=1, T=20,
             t_min_frac=0.0, bf16=False, warmup_steps=2, data_parallel=False,
             streaming=True, stream_chunk=3, whiten=True, p_selfcond=0.5,
             log_jsonl=str(tmp_path / f"{name}.jsonl")), **kw))


def test_train_streaming_end_to_end(files, tmp_path):
    """``train(streaming=True)`` on the HDF5 file and on both twins of the
    ragged corpus (the same batches, so the same losses), with the chunks
    resident on the device and through ``prefetch_to_device``; the epoch
    log reports the copies; ``--max-len`` is refused with streaming."""
    runs = {name: tt.train(_train_cfg(tmp_path, files[name], name, **kw),
                           device="cpu")
            for name, kw in (("h5", {}), ("twin", {}),
                             ("c2n", dict(device_data=False)))}
    hist = [[h["avg_per_sample"] for h in r["history"]] for r in runs.values()]
    assert all(np.isfinite(hist[0])) and hist[0] == hist[1] == hist[2]
    import json

    with open(tmp_path / "twin.jsonl") as fh:
        ends = [r for r in map(json.loads, fh) if r["phase"] == "epoch_end"]
    assert ends[0]["h2d_bytes"] > 0 and ends[1]["h2d_bytes"] == 0
    assert ends[1]["peak_live_samples"] <= 2 * 3
    eq = tt.train(_train_cfg(tmp_path, files["eq_twin"], "eq", epochs=1),
                  device="cpu")
    assert np.isfinite(eq["history"][0]["avg_per_sample"])
    with pytest.raises(ValueError, match="max-len"):
        tt.train(_train_cfg(tmp_path, files["twin"], "ml", max_len=256),
                 device="cpu")


def test_data_side_runs_without_jax_h5py_matplotlib(tmp_path):
    """gw-gen to a ragged .npz (random mode, two buckets), gw-merge,
    gw-train --streaming for one epoch and gw-infer on index 0, on the CPU
    with jax, h5py and matplotlib blocked, as on the card's machine."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax", "msgpack", "h5py",
                     "pandas", "matplotlib",
                     "diffusion_models_for_gravitational_waveform_reconstruction_tpu"):
            sys.modules[name] = None
        import os
        import numpy as np
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import gen, infer, merge, train
        d = {str(tmp_path)!r}
        base = ["--mode", "random", "--mass2-min", "30", "--mass2-max", "40",
                "--snr-min", "8", "--snr-max", "30", "--sampling-rate",
                "1024", "--save-psd", "--device", "cpu"]
        a = gen.main(base + ["--num-samples", "6", "--mass1-min", "35",
                             "--mass1-max", "60", "--output-path",
                             os.path.join(d, "a.npz")])
        assert len(a["buckets"]) == 2, a
        gen.main(base + ["--num-samples", "3", "--mass1-min", "30",
                         "--mass1-max", "32", "--seed", "5", "--output-path",
                         os.path.join(d, "b.npz")])
        merge.main(["--output-path", os.path.join(d, "m.npz"),
                    os.path.join(d, "a.npz"), os.path.join(d, "b.npz")])
        out = train.main(["--data", os.path.join(d, "m.npz"), "--streaming",
                          "--stream-chunk", "4", "--epochs", "1",
                          "--batch-size", "3", "--base_ch", "8", "--depth",
                          "1", "--whiten", "1", "--whiten_mode", "model",
                          "--model_dir", os.path.join(d, "mdl"),
                          "--device", "cpu", "--no-bf16"])
        assert np.isfinite(out["history"][0]["avg_per_sample"])
        infer.main(["--input-h5", os.path.join(d, "m.npz"), "--index", "0",
                    "--model", out["checkpoint"], "--outdir",
                    os.path.join(d, "inf"), "--steps", "2", "--device", "cpu"])
        assert any(f.startswith("recon_") for f in os.listdir(
            os.path.join(d, "inf")))
        bad = [k for k, v in sys.modules.items() if v is not None and
               k.split(".")[0] in ("jax", "flax", "h5py", "matplotlib")]
        assert not bad, bad
        print("ok")
    """)
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip().endswith("ok")
