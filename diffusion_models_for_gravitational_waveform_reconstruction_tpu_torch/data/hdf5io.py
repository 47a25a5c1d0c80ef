"""The HDF5 dataset schema (counterpart of the JAX package's
``data/hdf5io.py``): its writer and readers, and its ``.npz`` twin.

The schema: variable-length float32 ``signal`` / ``noise`` / ``noisy`` per
sample, float64 ``times`` (t = 0 at the |signal| peak), ``t_merger`` and
int32 ``lengths``; per-sample float32 scalar metadata
(:data:`META_SCALAR_KEYS`, with the rfft-grid descriptors ``psd_len`` /
``psd_df`` / ``psd_f_lower``); optional float64 PSDs (``psd_model`` with
its legacy alias ``psd`` on the rfft grid, ``psd_welch`` with
``psd_welch_freqs``) and ``psd_detector``; the file attributes
``padding``, ``sampling_rate``, ``delta_t``, ``time_axis``, ``psd_saved``,
``psd_model_kind``, the ``psd_*`` Welch parameters and the generator's
(``mode``, ``engine``, ``config_args``).

The ``.npz`` twin holds the same datasets under the same names and dtypes,
and the file attributes as 0-d arrays.  A per-sample series takes one of
two forms: an (N, L) array when every sample has the same length (the only
form before ragged corpora had a twin), else its rows stored flat, one
after another, with their offsets ((N + 1,) int64) in
``<name>__offsets``.  Every member is stored uncompressed, so a row range
of any series is read on its own by seeking in the file past the member's
``.npy`` header (:class:`_NpzCorpus`): ``StreamingDataset`` reads it chunk
by chunk.  :func:`write_dataset` to an ``.npz`` path writes every dataset
of the schema but ``times`` (which is ``arange(n) / sampling_rate -
t_merger``) and the ``psd`` alias; :func:`corpus_to_npz` and
:func:`save_corpus_npz` write the series and columns the readers use.
Every reader takes either file, chosen by its suffix.

``h5py`` is imported only by the functions that open an ``.h5`` file, so
this module, the ``.npz`` corpora, the ``--input-npy`` path of the infer
CLI and the trainer's ``--data synth:N`` work where it is not installed.
"""
from __future__ import annotations

import contextlib
import os
import struct
import zipfile
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# the twin's member of a ragged series' row offsets: "<name>" + OFFSETS
OFFSETS = "__offsets"
# rows read from an HDF5 dataset at a time when copying
CHUNK = 2048

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
# the per-sample series ``corpus_to_npz`` carries
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


class _NpzArray:
    """One stored ``.npy`` member of an ``.npz`` file, read lazily: its
    header is parsed once, and a row range of its leading axis is one seek
    and one read of exactly those bytes."""

    ragged = False

    def __init__(self, corpus: "_NpzCorpus", info: zipfile.ZipInfo):
        self.name = info.filename[:-4]
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(
                f"member {self.name!r} of {corpus.path} is compressed: the "
                f".npz twin is read in row ranges, which needs stored "
                f"members (np.savez, not np.savez_compressed)")
        fh = corpus.fh
        fh.seek(info.header_offset)
        local = fh.read(30)
        if local[:4] != b"PK\x03\x04":
            raise ValueError(f"{corpus.path}: bad zip member {self.name!r}")
        n_name, n_extra = struct.unpack("<HH", local[26:30])
        fh.seek(info.header_offset + 30 + n_name + n_extra)
        version = np.lib.format.read_magic(fh)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(fh)
        else:
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(fh)
        if dtype.hasobject or fortran:
            raise ValueError(f"{corpus.path}: member {self.name!r} holds "
                             f"objects or is Fortran-ordered")
        self.corpus, self.shape, self.dtype = corpus, tuple(shape), dtype
        self.ndim = len(self.shape)
        self._data = fh.tell()
        self._row = dtype.itemsize * int(np.prod(self.shape[1:], dtype=np.int64))

    def read(self, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of the leading axis, as a new array."""
        out = np.empty((max(0, hi - lo),) + self.shape[1:], self.dtype)
        self.corpus.read_into(self._data + lo * self._row, out)
        return out

    def __getitem__(self, idx):
        if self.ndim == 0:
            return self.read(0, 1).reshape(())[idx]
        if isinstance(idx, slice):
            lo, hi, step = idx.indices(self.shape[0])
            return self.read(lo, max(lo, hi))[::step]
        i = int(idx)
        i = i + self.shape[0] if i < 0 else i
        if not 0 <= i < self.shape[0]:
            raise IndexError(f"index {idx} out of range for {self.name!r} "
                             f"of {self.shape[0]} rows")
        return self.read(i, i + 1)[0]


class _NpzRagged:
    """A ragged series of the twin: its rows stored flat, one after another,
    with their offsets ((N + 1,) int64) in the member ``<name>__offsets``.
    ``[i]`` is a row; a slice an object array of rows, like h5py's
    variable-length datasets, read in one piece."""

    ragged = True
    dtype = np.dtype(object)
    ndim = 1

    def __init__(self, flat: _NpzArray, offsets: np.ndarray):
        self.flat, self.offsets = flat, np.asarray(offsets, np.int64)
        self.name, self.row_dtype = flat.name, flat.dtype
        self.shape = (len(self.offsets) - 1,)

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def __getitem__(self, idx):
        off = self.offsets
        if isinstance(idx, slice):
            lo, hi, step = idx.indices(self.shape[0])
            hi = max(lo, hi)
            flat = self.flat.read(int(off[lo]), int(off[hi]))
            out = np.empty(hi - lo, dtype=object)
            for j in range(hi - lo):
                out[j] = flat[off[lo + j] - off[lo]:off[lo + j + 1] - off[lo]]
            return out[::step]
        i = int(idx)
        i = i + self.shape[0] if i < 0 else i
        if not 0 <= i < self.shape[0]:
            raise IndexError(f"index {idx} out of range for {self.name!r} "
                             f"of {self.shape[0]} rows")
        return self.flat.read(int(off[i]), int(off[i + 1]))


class _NpzCorpus:
    """An open ``.npz`` twin with the part of ``h5py.File``'s interface the
    readers use: ``in``, ``[name]``, ``get``, ``keys()`` and ``attrs`` (its
    0-d members).  A series is an (N, L) member (equal lengths) or a
    :class:`_NpzRagged`; every member is read lazily, in row ranges, and
    ``bytes_read`` counts the bytes read since the file was opened (the
    attributes and the row offsets, read then, not counted)."""

    def __init__(self, path: str):
        self.path = path
        self.fh = open(path, "rb")
        self.bytes_read = 0
        try:
            with zipfile.ZipFile(self.fh) as zf:
                members = {i.filename[:-4]: _NpzArray(self, i)
                           for i in zf.infolist()
                           if i.filename.endswith(".npy")}
        except BaseException:
            self.fh.close()
            raise
        self.attrs = {k: a[()] for k, a in members.items() if a.ndim == 0}
        self._data: Dict[str, object] = {}
        for k, a in members.items():
            if a.ndim == 0 or k.endswith(OFFSETS):
                continue
            off = members.get(k + OFFSETS)
            self._data[k] = a if off is None else _NpzRagged(a, off[:])
        self.bytes_read = 0          # the attributes and offsets not counted

    def read_into(self, pos: int, out: np.ndarray) -> None:
        """Fill ``out`` with the file's bytes from ``pos`` on."""
        buf = out.reshape(-1).view(np.uint8)
        self.fh.seek(pos)
        if self.fh.readinto(buf) != buf.nbytes:
            raise ValueError(f"{self.path} is truncated")
        self.bytes_read += buf.nbytes

    def keys(self) -> List[str]:
        return list(self._data)

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def __getitem__(self, name: str):
        return self._data[name]

    def get(self, name: str, default=None):
        return self._data.get(name, default)

    def row_lengths(self, name: str) -> np.ndarray:
        """The length of each row of the series ``name``."""
        ds = self._data[name]
        if ds.ragged:
            return ds.lengths
        return np.full(ds.shape[0], ds.shape[1] if ds.ndim > 1 else 1,
                       np.int64)

    def close(self) -> None:
        self.fh.close()


@contextlib.contextmanager
def open_corpus(path: str, what: str, instead: str) -> Iterator:
    """An ``.npz`` twin or an HDF5 file, open for reading; the HDF5 branch
    needs h5py (``what`` and ``instead`` word the error without it)."""
    if is_npz(path):
        f = _NpzCorpus(path)
        try:
            yield f
        finally:
            f.close()
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
            f"{lens[-1]}): save_corpus_npz takes equal lengths; a ragged "
            f"corpus needs HDF5 or write_dataset to an .npz path")
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
    """Write an equal-length ``.npz`` corpus in the schema's names and
    dtypes, as the JAX package's ``write_dataset`` writes them: float32
    series and scalar columns, float64 PSDs, ``sampling_rate`` and
    ``delta_t``.  :func:`write_dataset` writes the whole schema, ragged or
    not."""
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
    with _NpzWriter(path) as w:
        for k, v in out.items():
            w.add(k, v)


class _NpzWriter:
    """Writes an ``.npz`` file member by member, stored (uncompressed), so
    that a row range of any member can be read without the rest; a series
    is written row by row (:meth:`add_series`), never concatenated in
    memory.  Members carry a fixed timestamp, so the same arrays make the
    same bytes.  The file appears at ``path`` when the ``with`` block ends
    without an error."""

    def __init__(self, path: str):
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self.path, self.tmp = path, path + ".tmp.npz"
        self.zf = zipfile.ZipFile(self.tmp, "w", zipfile.ZIP_STORED,
                                  allowZip64=True)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        self.zf.close()
        if exc_type is None:
            os.replace(self.tmp, self.path)
        else:
            os.remove(self.tmp)

    def _member(self, name: str):
        info = zipfile.ZipInfo(name + ".npy", date_time=(1980, 1, 1, 0, 0, 0))
        return self.zf.open(info, "w", force_zip64=True)

    def add(self, name: str, arr) -> None:
        with self._member(name) as fh:
            np.lib.format.write_array(fh, np.asanyarray(arr),
                                      allow_pickle=False)

    def _add_rows(self, name: str, rows: Iterable, dtype, shape) -> None:
        dtype = np.dtype(dtype)
        want = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
        done = 0
        with self._member(name) as fh:
            np.lib.format.write_array_header_1_0(fh, {
                "descr": np.lib.format.dtype_to_descr(dtype),
                "fortran_order": False, "shape": tuple(shape)})
            for r in rows:
                r = np.ascontiguousarray(r, dtype).reshape(-1)
                fh.write(r.data)
                done += r.nbytes
        if done != want:
            raise ValueError(f"series {name!r}: wrote {done} bytes of {want}")

    def add_series(self, name: str, lengths: Sequence[int], rows: Iterable,
                   dtype) -> None:
        """A per-sample series with row lengths ``lengths``: (N, L) when
        every row has length L, else flat with ``<name>__offsets``."""
        lengths = np.asarray(lengths, np.int64)
        if len(set(lengths.tolist())) <= 1:
            L = int(lengths[0]) if len(lengths) else 0
            self._add_rows(name, rows, dtype, (len(lengths), L))
        else:
            offsets = np.concatenate([[0], np.cumsum(lengths)])
            self._add_rows(name, rows, dtype, (int(offsets[-1]),))
            self.add(name + OFFSETS, offsets)


def _add_series_list(w: _NpzWriter, name: str, arrs, dtype) -> None:
    arrs = [np.asarray(a).reshape(-1) for a in arrs]
    w.add_series(name, [len(a) for a in arrs], arrs, dtype)


def _h5_rows(ds, lo: int = 0, hi: Optional[int] = None) -> Iterator:
    """The rows [lo, hi) of an h5py dataset, read CHUNK rows at a time."""
    hi = ds.shape[0] if hi is None else hi
    for c0 in range(lo, hi, CHUNK):
        yield from ds[c0:min(hi, c0 + CHUNK)]


def corpus_to_npz(h5_path: str, npz_path: str) -> None:
    """The ``.npz`` twin of an HDF5 corpus (needs h5py): the series of
    :data:`NPZ_SERIES_KEYS` that the file has (its legacy ``psd`` alias
    only without ``psd_model``), ragged or not, and its scalar columns of
    :data:`META_SCALAR_KEYS`, each in its dtype, and the sampling rate.
    Series are copied CHUNK rows at a time (twice: their lengths, then
    their rows)."""
    h5py = _h5py("converting an HDF5 corpus", "save_corpus_npz")
    with h5py.File(resolve_h5_path(h5_path), "r") as f, \
            _NpzWriter(npz_path) as w:
        for k in NPZ_SERIES_KEYS:
            if k in f and not (k == "psd" and "psd_model" in f):
                ds = f[k]
                dtype = h5py.check_vlen_dtype(ds.dtype) or ds.dtype
                if ds.ndim == 2:
                    lengths = [ds.shape[1]] * ds.shape[0]
                else:
                    lengths = [len(r) for r in _h5_rows(ds)]
                w.add_series(k, lengths, _h5_rows(ds), dtype)
        for k in META_SCALAR_KEYS:
            if k in f:
                w.add(k, np.asarray(f[k][:]))
        fs = read_sampling_rate(f)
        w.add("sampling_rate", np.asarray(fs))
        w.add("delta_t", np.asarray(1.0 / fs))


def _file_attrs(sampling_rate: float, psd_saved: bool, psd_model: bool,
                psd_model_kind: str, psd_params: Optional[dict],
                attrs_extra: Optional[dict]) -> dict:
    """The file attributes of the schema, in the JAX writer's order."""
    attrs = {"padding": "none", "sampling_rate": float(sampling_rate),
             "delta_t": 1.0 / float(sampling_rate),
             "time_axis": "seconds-rel-peak", "psd_saved": bool(psd_saved),
             "psd_model_kind": psd_model_kind if psd_model else ""}
    if psd_params is not None:
        attrs["psd_source"] = str(psd_params.get("source", "both"))
        attrs["psd_welch_nperseg"] = int(psd_params.get("nperseg", -1))
        nov = psd_params.get("noverlap")
        attrs["psd_welch_noverlap"] = int(nov if nov is not None else -1)
        attrs["psd_welch_window"] = str(psd_params.get("window", ""))
    attrs.update(attrs_extra or {})
    return attrs


def _vlen(arr_list: Sequence[np.ndarray], dtype) -> np.ndarray:
    obj = np.empty(len(arr_list), dtype=object)
    for i, a in enumerate(arr_list):
        obj[i] = np.asarray(a, dtype=dtype).reshape(-1)
    return obj


def write_dataset(
    output_path: str,
    signal: Sequence[np.ndarray],
    noise: Sequence[np.ndarray],
    noisy: Sequence[np.ndarray],
    times: Sequence[np.ndarray],
    meta: Dict[str, Sequence[float]],
    sampling_rate: float,
    *,
    detectors: Optional[Sequence[str]] = None,
    psd_model: Optional[Sequence[np.ndarray]] = None,
    psd_welch: Optional[Sequence[np.ndarray]] = None,
    psd_welch_freqs: Optional[Sequence[np.ndarray]] = None,
    psd_params: Optional[dict] = None,
    psd_model_kind: str = "aLIGOZeroDetHighPower",
    attrs_extra: Optional[dict] = None,
) -> None:
    """Write a corpus of the schema: HDF5 (needs h5py) or, for a path
    ending in ``.npz``, its twin.

    ``times`` are absolute per-sample time axes, re-centred here so that
    t = 0 falls at the |signal| peak; ``t_merger`` records the removed
    offset.  PSDs are stored in float64 (physical PSDs, ~1e-46, are below
    float32's smallest normal).  The twin stores no ``times``: each axis
    must be ``arange(n) / sampling_rate`` (gw-gen's), so that the twin's
    is ``arange(n) / sampling_rate - t_merger``; any other axis raises."""
    parent = os.path.dirname(output_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    fs = float(sampling_rate)
    times_rel, t_mergers = [], []
    for s, t_abs in zip(signal, times):
        s = np.asarray(s)
        t_abs = np.asarray(t_abs, np.float64)
        pk = int(np.argmax(np.abs(s))) if s.ndim else 0
        t0 = float(t_abs[pk])
        times_rel.append(t_abs - t0)
        t_mergers.append(t0)
    lengths = np.array([len(np.asarray(s).reshape(-1)) for s in signal],
                       np.int32)
    welch = psd_welch is not None and psd_welch_freqs is not None
    attrs = _file_attrs(fs, psd_model is not None or welch,
                        psd_model is not None, psd_model_kind, psd_params,
                        attrs_extra)

    if is_npz(output_path):
        for t_abs in times:
            t_abs = np.asarray(t_abs, np.float64).reshape(-1)
            if not np.array_equal(t_abs,
                                  np.arange(len(t_abs), dtype=np.float64) / fs):
                raise ValueError(
                    "the .npz twin stores no time axis: each sample's "
                    "times must be arange(n) / sampling_rate; write HDF5 "
                    "for any other axis")
        with _NpzWriter(output_path) as w:
            for k, arrs in (("signal", signal), ("noise", noise),
                            ("noisy", noisy)):
                _add_series_list(w, k, arrs, np.float32)
            w.add("t_merger", np.array(t_mergers, np.float64))
            w.add("lengths", lengths)
            for k, arr in meta.items():
                if len(arr):
                    w.add(k, np.asarray(arr, np.float32))
            if detectors is not None:
                w.add("psd_detector", np.array([str(d) for d in detectors]))
            if psd_model is not None:
                _add_series_list(w, "psd_model", psd_model, np.float64)
            if welch:
                _add_series_list(w, "psd_welch", psd_welch, np.float64)
                _add_series_list(w, "psd_welch_freqs", psd_welch_freqs,
                                 np.float64)
            for k, v in attrs.items():
                w.add(k, np.asarray(v))
        return

    h5py = _h5py("writing an HDF5 corpus", "an .npz output path")
    vlen_f32 = h5py.vlen_dtype(np.dtype("float32"))
    vlen_f64 = h5py.vlen_dtype(np.dtype("float64"))
    with h5py.File(output_path, "w") as f:
        f.create_dataset("signal", data=_vlen(signal, np.float32), dtype=vlen_f32)
        f.create_dataset("noise", data=_vlen(noise, np.float32), dtype=vlen_f32)
        f.create_dataset("noisy", data=_vlen(noisy, np.float32), dtype=vlen_f32)
        f.create_dataset("times", data=_vlen(times_rel, np.float64),
                         dtype=vlen_f64)
        f.create_dataset("t_merger", data=np.array(t_mergers, np.float64))
        f.create_dataset("lengths", data=lengths)
        for k, arr in meta.items():
            if len(arr):
                f.create_dataset(k, data=np.asarray(arr, np.float32))
        if detectors is not None:
            f.create_dataset(
                "psd_detector",
                data=np.array([d.encode("utf-8") for d in detectors],
                              dtype=object),
                dtype=h5py.vlen_dtype(bytes))
        if psd_model is not None:
            obj = _vlen(psd_model, np.float64)
            f.create_dataset("psd", data=obj, dtype=vlen_f64)   # legacy alias
            f.create_dataset("psd_model", data=obj, dtype=vlen_f64)
        if welch:
            f.create_dataset("psd_welch", data=_vlen(psd_welch, np.float64),
                             dtype=vlen_f64)
            f.create_dataset("psd_welch_freqs",
                             data=_vlen(psd_welch_freqs, np.float64),
                             dtype=vlen_f64)
        for k, v in attrs.items():
            f.attrs[k] = v
