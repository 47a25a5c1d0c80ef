"""Measurement readers of the HDF5 dataset schema (counterpart of the reader
side of the JAX package's ``data/hdf5io.py``), and its ``.npz`` twin.

The schema: variable-length float32 ``signal`` / ``noise`` / ``noisy`` per
sample, per-sample scalar metadata, optional float64 PSDs (``psd_model``
with its legacy alias ``psd`` on the rfft grid, ``psd_welch`` with
``psd_welch_freqs``), the rfft-grid descriptors ``psd_len`` / ``psd_df`` /
``psd_f_lower``, and the file attributes ``sampling_rate`` / ``delta_t``.

The ``.npz`` twin holds the same datasets under the same names, as arrays
of equal-length rows ((N, L) for the series, (N,) for the scalar columns,
each in the HDF5 file's dtype), and ``sampling_rate`` / ``delta_t`` as 0-d
arrays; it leaves out ``noise``, ``times``, ``t_merger``, ``lengths`` and
the other file attributes, which no reader here uses.  A ragged corpus has
no twin.  Every reader takes either file, chosen by its suffix.

``h5py`` is imported only by the functions that open an ``.h5`` file, so
this module, the ``.npz`` corpora, the ``--input-npy`` path of the infer
CLI and the trainer's ``--data synth:N`` work where it is not installed.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

INFERENCE_META_KEYS = [
    "mass1", "mass2", "spin1z", "spin2z", "q", "chirp_mass", "snr", "epoch",
    "label_m1", "label_m2", "label_s1", "label_s2",
]
# the per-sample scalar columns of the schema
META_SCALAR_KEYS = [
    "mass1", "mass2", "snr", "spin1z", "spin2z",
    "label_m1", "label_m2", "label_s1", "label_s2",
    "q", "chirp_mass", "epoch",
    "psd_len", "psd_df", "psd_f_lower",
]
# the per-sample series the .npz twin carries, as (N, K) arrays
NPZ_SERIES_KEYS = ["noisy", "signal", "psd_model", "psd", "psd_welch",
                   "psd_welch_freqs"]


def aligo_zdhp_psd_np(freqs: np.ndarray, f_lower: float = 20.0) -> np.ndarray:
    """The analytic aLIGO zero-detuning high-power design PSD in physical
    units (~1e-46, float64: it would underflow float32), zero below
    ``f_lower``."""
    f = np.asarray(freqs, np.float64)
    x = np.maximum(f, 1e-3) / 215.0
    s = 1e-49 * (
        np.power(x, -4.14)
        - 5.0 * np.power(x, -2.0)
        + 111.0 * (1.0 - x ** 2 + 0.5 * x ** 4) / (1.0 + 0.5 * x ** 2)
    )
    return np.where(f >= f_lower, s, 0.0)


_DERIVED_PSD_CACHE: Dict[tuple, np.ndarray] = {}


def derive_model_psd_np(psd_len: int, psd_df: float,
                        psd_f_lower: float) -> np.ndarray:
    """The per-sample model PSD re-derived from its stored grid scalars (the
    noise of every dataset was coloured by the analytic curve on that grid).

    Results are cached by grid and SHARED read-only: a corpus with one sample
    length costs one array, not one per sample."""
    key = (int(psd_len), round(float(psd_df), 12), round(float(psd_f_lower), 9))
    P = _DERIVED_PSD_CACHE.get(key)
    if P is None:
        freqs = np.arange(key[0], dtype=np.float64) * key[1]
        P = aligo_zdhp_psd_np(freqs, key[2])
        P.setflags(write=False)
        _DERIVED_PSD_CACHE[key] = P
    return P


def is_npz(path: str) -> bool:
    return str(path).lower().endswith(".npz")


def _needs_h5py_for(path: str, instead: str) -> None:
    """An ``.h5`` / ``.hdf5`` path without h5py raises before anything
    looks for the file."""
    if str(path).lower().endswith((".h5", ".hdf5")):
        _h5py("reading an HDF5 corpus", instead)


def resolve_h5_path(path: str) -> str:
    """A directory -> the most recently modified .h5 / .hdf5 / .npz inside
    it."""
    if os.path.isdir(path):
        cands = [
            os.path.join(path, f) for f in os.listdir(path)
            if f.lower().endswith((".h5", ".hdf5", ".npz"))
        ]
        if not cands:
            raise FileNotFoundError(
                f"no .h5/.hdf5/.npz files in directory: {path}")
        cands.sort(key=os.path.getmtime, reverse=True)
        return cands[0]
    if not os.path.exists(path):
        raise FileNotFoundError(f"HDF5 path not found: {path}")
    return path


def read_sampling_rate(f) -> float:
    """``sampling_rate`` of an open file, else 1 / ``delta_t``."""
    fs_attr = float(f.attrs.get("sampling_rate", 0.0))
    if fs_attr > 0:
        return fs_attr
    return 1.0 / float(f.attrs.get("delta_t", 1.0 / 4096.0))


def _h5py(what: str, instead: str):
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"{what} needs h5py, which is not installed; "
                          f"{instead} works without it") from e
    return h5py


class _NpzCorpus:
    """An open ``.npz`` twin with the part of ``h5py.File``'s interface the
    readers use: ``in``, ``[name]`` (each array read once), ``get`` and
    ``attrs``."""

    def __init__(self, z):
        self._z = z
        self._cache: Dict[str, np.ndarray] = {}
        self.attrs = {k: z[k][()] for k in ("sampling_rate", "delta_t")
                      if k in z.files}

    def __contains__(self, name: str) -> bool:
        return name in self._z.files

    def __getitem__(self, name: str) -> np.ndarray:
        if name not in self._cache:
            self._cache[name] = self._z[name]
        return self._cache[name]

    def get(self, name: str, default=None):
        return self[name] if name in self else default


@contextlib.contextmanager
def open_corpus(path: str, what: str, instead: str) -> Iterator:
    """An ``.npz`` twin or an HDF5 file, open for reading; the HDF5 branch
    needs h5py (``what`` and ``instead`` word the error without it)."""
    if is_npz(path):
        with np.load(path, allow_pickle=False) as z:
            yield _NpzCorpus(z)
    else:
        h5py = _h5py(what, instead)
        with h5py.File(path, "r") as f:
            yield f


def _measurement(f, index: int):
    meta = {}
    y = np.array(f["noisy"][index], np.float32)
    clean = np.array(f["signal"][index], np.float32) if "signal" in f else None
    fs = read_sampling_rate(f)
    P_model = None
    if "psd_model" in f:
        P_model = np.array(f["psd_model"][index], np.float64)
    elif "psd" in f:
        P_model = np.array(f["psd"][index], np.float64)
    elif all(k in f for k in ("psd_len", "psd_df", "psd_f_lower")):
        P_model = derive_model_psd_np(
            f["psd_len"][index], f["psd_df"][index], f["psd_f_lower"][index])
        meta["psd_model_source"] = "derived:aLIGOZeroDetHighPower"
    fw = Pw = None
    if "psd_welch" in f and "psd_welch_freqs" in f:
        Pw = np.array(f["psd_welch"][index], np.float64)
        fw = np.array(f["psd_welch_freqs"][index], np.float64)
    for k in INFERENCE_META_KEYS:
        if k in f:
            try:
                meta[k] = float(np.asarray(f[k][index]).reshape(()))
            except (TypeError, ValueError):
                pass
    return y, clean, fs, P_model, (fw, Pw), meta


def load_measurements(h5_path: str, indices: Sequence[int]) -> List[tuple]:
    """The samples ``indices`` of an HDF5 corpus or its ``.npz`` twin, the
    file opened once: a list of (y, clean, fs, P_model, (f_welch, P_welch),
    meta)."""
    with open_corpus(h5_path, "reading an HDF5 measurement",
                     "an .npz corpus or --input-npy (load_measurement_npy)"
                     ) as f:
        return [_measurement(f, int(i)) for i in indices]


def load_measurement(h5_path: str, index: int):
    """One sample: (y, clean, fs, P_model, (f_welch, P_welch), meta)."""
    return load_measurements(h5_path, [index])[0]


def load_measurement_npy(npy_path: str, fs: float):
    """A raw .npy measurement, in the layout of :func:`load_measurement`."""
    y = np.load(npy_path).astype(np.float32).ravel()
    return y, None, fs, None, (None, None), {}


def load_full(h5_path: str, allow_no_signal: bool = False) -> dict:
    """A whole HDF5 corpus or its ``.npz`` twin in host memory, as ragged
    lists: 'noisy', 'signal' (float32 per sample; 'signal' None when absent and allowed), 'fs',
    'psd_model' (float64 per sample, saved or derived from the grid scalars,
    else None) with 'psd_model_source', 'psd_welch' / 'psd_welch_freqs',
    the scalar columns as float64 arrays (None when absent), 'attrs', 'n'
    and the resolved 'path'."""
    _needs_h5py_for(h5_path, "an .npz corpus or --data synth:N")
    path = resolve_h5_path(h5_path)
    out = {"path": path}
    with open_corpus(path, "reading an HDF5 corpus",
                     "an .npz corpus or --data synth:N") as f:
        if "noisy" not in f:
            raise KeyError("HDF5 must have 'noisy' dataset")
        out["noisy"] = [np.asarray(a, np.float32) for a in f["noisy"][:]]
        if "signal" in f:
            out["signal"] = [np.asarray(a, np.float32) for a in f["signal"][:]]
        elif not allow_no_signal:
            raise KeyError("missing 'signal' dataset (allow_no_signal=False)")
        else:
            out["signal"] = None
        out["fs"] = read_sampling_rate(f)
        pm = f.get("psd_model", f.get("psd", None))
        out["psd_model_source"] = "saved" if pm is not None else None
        if pm is not None:
            out["psd_model"] = [np.asarray(a, np.float64) for a in pm[:]]
        elif all(k in f for k in ("psd_len", "psd_df", "psd_f_lower")):
            pl = np.asarray(f["psd_len"][:], np.float64)
            pdf = np.asarray(f["psd_df"][:], np.float64)
            pfl = np.asarray(f["psd_f_lower"][:], np.float64)
            out["psd_model"] = [derive_model_psd_np(pl[i], pdf[i], pfl[i])
                                for i in range(len(pl))]
            out["psd_model_source"] = "derived:aLIGOZeroDetHighPower"
        else:
            out["psd_model"] = None
        out["psd_welch"] = ([np.asarray(a, np.float64) for a in f["psd_welch"][:]]
                            if "psd_welch" in f else None)
        out["psd_welch_freqs"] = (
            [np.asarray(a, np.float64) for a in f["psd_welch_freqs"][:]]
            if "psd_welch_freqs" in f else None)
        for k in ["mass1", "mass2", "spin1z", "spin2z", "q", "chirp_mass", "snr",
                  "label_m1", "label_m2", "label_s1", "label_s2"]:
            out[k] = np.asarray(f[k][:], np.float64) if k in f else None
        out["attrs"] = dict(f.attrs)
    out["n"] = len(out["noisy"])
    return out


def compute_meta_scale(h5_path: str) -> dict:
    """Label scales from 95th percentiles: M = the largest of p95(mass1),
    p95(mass2), p95(chirp_mass); q = p95(q); each defaulting (M 80, q 10)
    where absent, not finite or not positive, or where the file cannot be
    read (said on stdout)."""
    scale = {"M": 80.0, "q": 10.0}
    _needs_h5py_for(h5_path, "an .npz corpus or --data synth:N")
    try:
        path = resolve_h5_path(h5_path)
        with open_corpus(path, "reading an HDF5 corpus",
                         "an .npz corpus or --data synth:N") as f:
            def p95(name):
                if name in f:
                    arr = np.asarray(f[name][:], np.float64)
                    if arr.size:
                        return float(np.nanpercentile(arr, 95))
                return None

            cands = [p95("mass1"), p95("mass2"), p95("chirp_mass")]
            cands = [x for x in cands if x is not None and np.isfinite(x) and x > 0]
            if cands:
                scale["M"] = float(max(cands))
            qp = p95("q")
            if qp is not None and np.isfinite(qp) and qp > 0:
                scale["q"] = float(qp)
    except (OSError, KeyError, ValueError) as e:
        print(f"[data] meta_scale computation failed; defaults {scale} ({e})")
    return scale


def num_samples(h5_path: str) -> int:
    """The number of samples of an HDF5 corpus or its ``.npz`` twin."""
    with open_corpus(h5_path, "reading an HDF5 corpus",
                     "an .npz corpus") as f:
        return int(f["noisy"].shape[0])


def load_labels(h5_path: str) -> Tuple[np.ndarray, np.ndarray,
                                       Optional[np.ndarray]]:
    """(m1, m2, snr or None) of every sample, float64: the masses from
    ``label_m1`` / ``label_m2`` where both exist, else ``mass1`` /
    ``mass2``; ``snr`` where the corpus has it."""
    with open_corpus(h5_path, "reading an HDF5 corpus",
                     "an .npz corpus") as f:
        if "label_m1" in f and "label_m2" in f:
            m1 = np.asarray(f["label_m1"][:], np.float64)
            m2 = np.asarray(f["label_m2"][:], np.float64)
        else:
            m1 = np.asarray(f["mass1"][:], np.float64)
            m2 = np.asarray(f["mass2"][:], np.float64)
        snr = np.asarray(f["snr"][:], np.float64) if "snr" in f else None
    return m1, m2, snr


def _rows(name: str, arrs, dtype) -> np.ndarray:
    """Equal-length rows as one (N, L) array; a ragged set raises."""
    arrs = [np.asarray(a, dtype).reshape(-1) for a in arrs]
    lens = sorted({len(a) for a in arrs})
    if len(lens) > 1:
        raise ValueError(
            f"'{name}' holds samples of {len(lens)} lengths ({lens[0]} to "
            f"{lens[-1]}): a ragged corpus has no .npz twin and needs HDF5")
    return np.stack(arrs) if arrs else np.zeros((0, 0), dtype)


def save_corpus_npz(
    path: str,
    signal: Sequence[np.ndarray],
    noisy: Sequence[np.ndarray],
    meta: Dict[str, Sequence[float]],
    sampling_rate: float,
    *,
    psd_model: Optional[Sequence[np.ndarray]] = None,
    psd_welch: Optional[Sequence[np.ndarray]] = None,
    psd_welch_freqs: Optional[Sequence[np.ndarray]] = None,
) -> None:
    """Write an ``.npz`` corpus in the schema's names and dtypes, as the JAX
    package's ``write_dataset`` writes them: float32 series and scalar
    columns, float64 PSDs; equal-length samples only."""
    out = {"noisy": _rows("noisy", noisy, np.float32),
           "signal": _rows("signal", signal, np.float32),
           "sampling_rate": np.asarray(float(sampling_rate)),
           "delta_t": np.asarray(1.0 / float(sampling_rate))}
    for k, arr in meta.items():
        if len(arr):
            out[k] = np.asarray(arr, np.float32)
    if psd_model is not None:
        out["psd_model"] = _rows("psd_model", psd_model, np.float64)
    if psd_welch is not None and psd_welch_freqs is not None:
        out["psd_welch"] = _rows("psd_welch", psd_welch, np.float64)
        out["psd_welch_freqs"] = _rows("psd_welch_freqs", psd_welch_freqs,
                                       np.float64)
    _write_npz(path, out)


def _write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def corpus_to_npz(h5_path: str, npz_path: str) -> None:
    """The ``.npz`` twin of an HDF5 corpus (needs h5py): the series of
    :data:`NPZ_SERIES_KEYS` that the file has (its legacy ``psd`` alias
    only without ``psd_model``) and its scalar columns of
    :data:`META_SCALAR_KEYS`, each in its dtype, and the sampling rate; a
    ragged corpus raises."""
    h5py = _h5py("converting an HDF5 corpus", "save_corpus_npz")
    out = {}
    with h5py.File(resolve_h5_path(h5_path), "r") as f:
        for k in NPZ_SERIES_KEYS:
            if k in f and not (k == "psd" and "psd_model" in f):
                ds = f[k]
                out[k] = _rows(k, ds[:], h5py.check_vlen_dtype(ds.dtype)
                               or ds.dtype)
        for k in META_SCALAR_KEYS:
            if k in f:
                out[k] = np.asarray(f[k][:])
        fs = read_sampling_rate(f)
    out["sampling_rate"] = np.asarray(fs)
    out["delta_t"] = np.asarray(1.0 / fs)
    _write_npz(npz_path, out)
