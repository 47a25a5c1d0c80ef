"""Host data pipeline: float64 whitening and sigma, static-shape buckets and
batches, the dataset resident on the device, and the synthetic corpus
(counterpart of the JAX package's ``data/pipeline.py``; the host parts are
the same numpy, so their results are bit-equal).

- Whitening, sigma and metadata are computed once, ahead of time, in float64,
  and cached as dense float32 arrays (:func:`prepare_dataset`).
- Samples go to static-length buckets (the next power of two by default),
  LEFT-padded so mergers stay near the end, with validity masks.
- Metadata is kept as per-sample scalars (N, 4) = [m1/M, m2/M, s1, s2].
- :func:`upload_buckets` puts every bucket on the device once and
  :func:`device_resident_batches` gathers each batch there, with the batch
  schedule of :func:`iterate_batches` (the same numpy ``Generator`` draws).

PSD floors are RELATIVE to the PSD's maximum (1e-12): physical-strain PSDs
are ~1e-46, so an absolute epsilon would swamp every bin.  Bins where a PSD
is zero are out of band (below ``f_lower``): whitening zeroes them, and
de-whitening keeps them zero.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from numpy.fft import irfft, rfft, rfftfreq

from . import hdf5io


def whiten_train_like_np(y: np.ndarray, x: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Whitening by the measurement's own periodogram, smoothed over 9 bins
    and floored; returns (y_w, x_w, P)."""
    L = len(y)
    y64 = y.astype(np.float64) - np.mean(y, dtype=np.float64)
    Y = rfft(y64)
    P = np.abs(Y) ** 2
    if P.size > 9:
        P = np.convolve(P, np.ones(9) / 9.0, mode="same")
    P = psd_floor_np(P, 1e-12)
    y_w = irfft(Y / np.sqrt(P), n=L).astype(np.float32)
    X = rfft(x.astype(np.float64) - np.mean(x, dtype=np.float64))
    x_w = irfft(X / np.sqrt(P), n=L).astype(np.float32)
    return y_w, x_w, P


def psd_floor_np(P: np.ndarray, rel: float = 1e-12) -> np.ndarray:
    """``P`` floored at ``rel`` times its maximum (all ones when the maximum
    is not positive)."""
    mx = float(np.max(P)) if P.size else 0.0
    if mx <= 0:
        return np.full_like(np.asarray(P, np.float64), 1.0)
    return np.maximum(np.asarray(P, np.float64), rel * mx)


def whiten_weight_np(P: np.ndarray, rel: float = 1e-12) -> np.ndarray:
    """Per-bin whitening weight 1 / sqrt(floored P), zero where P == 0."""
    P = np.asarray(P, np.float64)
    Pf = psd_floor_np(P, rel)
    return np.where(P > 0, 1.0 / np.sqrt(Pf), 0.0)


def dewhiten_weight_np(P: np.ndarray, rel: float = 1e-12) -> np.ndarray:
    """The exact inverse of :func:`whiten_weight_np` on the in-band bins."""
    P = np.asarray(P, np.float64)
    Pf = psd_floor_np(P, rel)
    return np.where(P > 0, np.sqrt(Pf), 0.0)


def interp_psd_np(P: np.ndarray, L_src: int, L_tgt: int, fs: float) -> np.ndarray:
    """A PSD of ``L_src`` rfft bins onto the rfft grid of ``L_tgt`` samples."""
    if L_src == (L_tgt // 2 + 1):
        return P.astype(np.float64)
    f_src = rfftfreq(L_src * 2 - 2, 1.0 / fs)
    f_tgt = rfftfreq(L_tgt, 1.0 / fs)
    return np.interp(f_tgt, f_src, P, left=P[0], right=P[-1]).astype(np.float64)


def whiten_model_np(y: np.ndarray, x: np.ndarray, P_model: np.ndarray, fs: float,
                    eps: float = 1e-12) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Model-PSD whitening; returns (y_w, x_w, P_interp), and de-whitening
    must use the returned P."""
    L = len(y)
    P = interp_psd_np(np.asarray(P_model, np.float64), len(P_model), L, fs)
    w = whiten_weight_np(P, eps)
    y_w = irfft(rfft(y.astype(np.float64)) * w, n=L).astype(np.float32)
    x_w = irfft(rfft(x.astype(np.float64)) * w, n=L).astype(np.float32)
    return y_w, x_w, P


def whiten_welch_np(y: np.ndarray, x: np.ndarray, f_w: np.ndarray, P_w: np.ndarray,
                    fs: float, eps: float = 1e-12
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Welch-PSD whitening, the PSD interpolated onto the rfft grid; returns
    (y_w, x_w, P)."""
    L = len(y)
    f_tgt = rfftfreq(L, 1.0 / fs)
    P = np.interp(f_tgt, np.asarray(f_w, np.float64), np.asarray(P_w, np.float64),
                  left=P_w[0], right=P_w[-1])
    w = whiten_weight_np(P, eps)
    y_w = irfft(rfft(y.astype(np.float64)) * w, n=L).astype(np.float32)
    x_w = irfft(rfft(x.astype(np.float64)) * w, n=L).astype(np.float32)
    return y_w, x_w, P


def mad_std_np(x: np.ndarray) -> float:
    """1.4826 times the median absolute deviation (plus 1e-24)."""
    x64 = np.asarray(x, np.float64)
    return 1.4826 * float(np.median(np.abs(x64 - np.median(x64)))) + 1e-24


def pick_sigma_np(y: np.ndarray, mode: str, fixed: float) -> float:
    """sigma of ``y`` by ``mode`` (std | mad | fixed); 1 when not finite or
    not positive."""
    if mode == "std":
        s = float(np.std(y.astype(np.float64)))
    elif mode == "mad":
        s = mad_std_np(y)
    elif mode == "fixed":
        s = float(fixed)
    else:
        raise ValueError(f"unknown sigma_mode: {mode!r}")
    if not np.isfinite(s) or s <= 0:
        s = 1.0
    return s


# ---------------------------------------------------------------------------
# Bucketed, static-shape batching
# ---------------------------------------------------------------------------

def next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _resolve_whiten_mode(mode: str, has_model: bool, has_welch: bool) -> str:
    """'auto' prefers model -> welch -> train."""
    if mode != "auto":
        return mode
    if has_model:
        return "model"
    if has_welch:
        return "welch"
    return "train"


def _check_whiten_domain(mode: str, has_model: bool, has_welch: bool,
                         whiten: bool, where: str) -> str:
    """The whitening domain actually used ('none' without whitening): a
    requested 'model' or 'welch' whose PSD is missing falls back to 'train',
    said on stderr, so that a checkpoint never records a domain it was not
    trained in."""
    if not whiten:
        return "none"
    missing = None
    if mode == "model" and not has_model:
        missing = "no per-sample model PSD (saved or derivable from grid scalars)"
    elif mode == "welch" and not has_welch:
        missing = "no saved Welch PSD"
    if missing is None:
        return mode
    print(
        f"[pipeline] WARNING: whiten_mode='{mode}' requested for {where} "
        f"but {missing}; falling back to TRAIN-LIKE whitening. The actual "
        f"training/eval domain is 'train', not '{mode}'.",
        file=sys.stderr, flush=True)
    return "train"


def _prep_sample(
    y: np.ndarray,
    x: np.ndarray,
    fs: float,
    *,
    whiten: bool,
    whiten_mode: str,
    sigma_mode: str,
    sigma_fixed: float,
    psd_model: Optional[np.ndarray] = None,
    psd_welch: Optional[np.ndarray] = None,
    psd_welch_freqs: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """NaN guard -> whitening (``whiten_mode`` already resolved) -> sigma for
    one sample."""
    if not np.isfinite(y).all():
        y = np.nan_to_num(y, nan=0.0, posinf=0.0, neginf=0.0)
    if not np.isfinite(x).all():
        x = np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    if whiten:
        if whiten_mode == "model" and psd_model is not None:
            y, x, _ = whiten_model_np(y, x, psd_model, fs)
        elif (whiten_mode == "welch" and psd_welch is not None
              and psd_welch_freqs is not None):
            y, x, _ = whiten_welch_np(y, x, psd_welch_freqs, psd_welch, fs)
        else:
            y, x, _ = whiten_train_like_np(y, x)
    sigma = pick_sigma_np(y, sigma_mode, sigma_fixed)
    return y, x, sigma


@dataclasses.dataclass
class PreparedDataset:
    """Whitened, padded, mask-carrying dense arrays, grouped by bucket length.

    buckets: {L: dict(clean (Nb,1,L) f32, noisy (Nb,1,L) f32, mask (Nb,1,L) f32,
                      sigma (Nb,) f32, meta (Nb,4) f32, index (Nb,) i64)}
    ``whiten_mode_resolved`` is the whitening domain actually used ('model',
    'welch', 'train', 'raw' or 'none'), which checkpoints record.
    """

    buckets: Dict[int, Dict[str, np.ndarray]]
    fs: float
    meta_scale: dict
    whiten: bool
    whiten_mode: str
    sigma_mode: str
    n: int
    whiten_mode_resolved: str = "none"

    @property
    def bucket_lengths(self) -> List[int]:
        return sorted(self.buckets.keys())


def prepare_dataset(
    h5_path: str,
    *,
    whiten: bool = False,
    whiten_mode: str = "auto",
    sigma_mode: str = "std",
    sigma_fixed: float = 1.0,
    include_metadata: bool = True,
    mass_scale: Optional[float] = None,
    bucket_lengths: Optional[List[int]] = None,
    allow_no_signal: bool = False,
    max_samples: Optional[int] = None,
    max_len: Optional[int] = None,
) -> PreparedDataset:
    """Load, whiten, pick sigma and bucket a corpus once: an HDF5 file
    (needs h5py) or its ``.npz`` twin.

    ``bucket_lengths``: explicit static lengths (default: each sample to the
    next power of two >= its length).  ``max_samples``: a cap for quick
    runs.  ``max_len``: LEFT-truncate longer samples after whitening (the
    merger at the right end is kept), which caps the largest bucket."""
    raw = hdf5io.load_full(h5_path, allow_no_signal=allow_no_signal)
    fs = raw["fs"]
    meta_scale = hdf5io.compute_meta_scale(raw["path"])
    M = float(mass_scale if mass_scale is not None else meta_scale.get("M", 80.0))

    per_bucket: Dict[int, Dict[str, list]] = {}
    n = raw["n"] if max_samples is None else min(raw["n"], int(max_samples))
    has_model = raw["psd_model"] is not None
    has_welch = (raw["psd_welch"] is not None
                 and raw["psd_welch_freqs"] is not None)
    mode = _resolve_whiten_mode(whiten_mode, has_model, has_welch)
    resolved = _check_whiten_domain(mode, has_model, has_welch, whiten,
                                    raw["path"])
    if whiten and mode == "model" and str(
            raw.get("psd_model_source", "")).startswith("derived"):
        print(f"[pipeline] model-PSD whitening via derived analytic PSD "
              f"(--save-psd was off for {raw['path']})",
              file=sys.stderr, flush=True)
    for i in range(n):
        y = raw["noisy"][i]
        x = raw["signal"][i] if raw["signal"] is not None else np.zeros_like(y)
        y, x, sigma = _prep_sample(
            y, x, fs, whiten=whiten, whiten_mode=resolved, sigma_mode=sigma_mode,
            sigma_fixed=sigma_fixed,
            psd_model=raw["psd_model"][i] if raw["psd_model"] is not None else None,
            psd_welch=raw["psd_welch"][i] if raw["psd_welch"] is not None else None,
            psd_welch_freqs=(raw["psd_welch_freqs"][i]
                             if raw["psd_welch_freqs"] is not None else None))
        if max_len is not None and len(y) > max_len:
            y, x = y[-max_len:], x[-max_len:]

        if include_metadata:
            def _get(name):
                arr = raw.get(name)
                return float(arr[i]) if arr is not None else 0.0

            meta = np.array([
                _get("mass1") / max(M, 1e-9),
                _get("mass2") / max(M, 1e-9),
                _get("spin1z"),
                _get("spin2z"),
            ], np.float32)
        else:
            meta = np.zeros(0, np.float32)

        L = len(y)
        if bucket_lengths is not None:
            fits = [bl for bl in bucket_lengths if bl >= L]
            if not fits:
                raise ValueError(f"sample length {L} exceeds all bucket lengths")
            Lb = min(fits)
        else:
            Lb = next_pow2(L)
        b = per_bucket.setdefault(Lb, {"clean": [], "noisy": [], "mask": [],
                                       "sigma": [], "meta": [], "index": []})
        pad = Lb - L
        b["clean"].append(np.pad(x.astype(np.float32), (pad, 0)))
        b["noisy"].append(np.pad(y.astype(np.float32), (pad, 0)))
        b["mask"].append(np.pad(np.ones(L, np.float32), (pad, 0)))
        b["sigma"].append(sigma)
        b["meta"].append(meta)
        b["index"].append(i)

    buckets = {}
    for Lb, cols in per_bucket.items():
        buckets[Lb] = {
            "clean": np.stack(cols["clean"])[:, None, :],
            "noisy": np.stack(cols["noisy"])[:, None, :],
            "mask": np.stack(cols["mask"])[:, None, :],
            "sigma": np.asarray(cols["sigma"], np.float32),
            "meta": np.stack(cols["meta"]) if include_metadata
                    else np.zeros((len(cols["sigma"]), 0), np.float32),
            "index": np.asarray(cols["index"], np.int64),
        }

    return PreparedDataset(
        buckets=buckets, fs=fs, meta_scale=meta_scale, whiten=whiten,
        whiten_mode=whiten_mode, sigma_mode=sigma_mode, n=n,
        whiten_mode_resolved=resolved,
    )


def dataset_from_arrays(
    clean: np.ndarray,
    noisy: np.ndarray,
    fs: float,
    *,
    meta: Optional[np.ndarray] = None,
    sigma_mode: str = "std",
    sigma_fixed: float = 1.0,
    whiten: bool = False,
    meta_scale: Optional[dict] = None,
) -> PreparedDataset:
    """A one-bucket dataset from dense (N, L) arrays (``meta`` (N, 4) already
    scaled), with no HDF5 round trip."""
    clean = np.asarray(clean, np.float32)
    noisy = np.asarray(noisy, np.float32)
    N, L = noisy.shape
    sigmas = np.array([pick_sigma_np(noisy[i], sigma_mode, sigma_fixed)
                       for i in range(N)], np.float32)
    if meta is None:
        meta = np.zeros((N, 4), np.float32)
    bucket = {
        "clean": clean[:, None, :],
        "noisy": noisy[:, None, :],
        "mask": np.ones((N, 1, L), np.float32),
        "sigma": sigmas,
        "meta": np.asarray(meta, np.float32),
        "index": np.arange(N, dtype=np.int64),
    }
    return PreparedDataset(
        buckets={L: bucket}, fs=fs,
        meta_scale=meta_scale or {"M": 80.0, "q": 10.0},
        whiten=whiten, whiten_mode="raw", sigma_mode=sigma_mode, n=N,
        whiten_mode_resolved="raw" if whiten else "none",
    )


def _batch_order(ds, batch_size: int, rng: np.random.Generator,
                 shuffle: bool, drop_remainder: bool) -> List[tuple]:
    """One epoch's (bucket length, row indices) per batch: each bucket
    permuted, cut into batches (a short last batch wrap-filled from the
    permutation unless ``drop_remainder``), then the batches shuffled."""
    order = []
    for Lb in ds.bucket_lengths:
        N = ds.buckets[Lb]["sigma"].shape[0]
        idx = rng.permutation(N) if shuffle else np.arange(N)
        n_batches = N // batch_size if drop_remainder else -(-N // batch_size)
        for bi in range(n_batches):
            sel = idx[bi * batch_size:(bi + 1) * batch_size]
            if len(sel) < batch_size:
                fill = np.resize(idx, batch_size - len(sel))
                sel = np.concatenate([sel, fill])
            order.append((Lb, sel))
    if shuffle:
        rng.shuffle(order)
    return order


class StreamingDataset:
    """A corpus larger than host memory, loaded and whitened a chunk at a
    time: an HDF5 file (needs h5py) or its ``.npz`` twin, of either form,
    read by row ranges.

    - One init scan reads ``lengths`` (or the rows' lengths) and the scalar
      metadata, and assigns every sample to a static power-of-two bucket;
      each bucket's indices stay sorted, so a chunk reads near rows.
    - Iteration prepares one chunk of ``chunk`` samples at a time through
      the dense path's :func:`_prep_sample` (bit-equal samples), keeping an
      LRU of ``cache_chunks`` prepared chunks; ``peak_live_samples`` records
      the most samples it held at once.
    - Shuffling is two-level (the chunk order, then within each chunk), with
      the numpy ``rng`` draws of the JAX package's ``StreamingDataset``; a
      bucket's short tail is wrap-filled from its first chunk.

    It has the part of :class:`PreparedDataset`'s interface the trainer uses
    (``bucket_lengths``, ``meta_scale``, ``n``, ``fs``, ``c_meta``,
    ``whiten_mode_resolved``, ``num_batches``, ``iter_batches``), and
    :meth:`iter_batches_device` keeps chunks resident on the device."""

    def __init__(
        self,
        h5_path: str,
        *,
        whiten: bool = False,
        whiten_mode: str = "auto",
        sigma_mode: str = "std",
        sigma_fixed: float = 1.0,
        include_metadata: bool = True,
        mass_scale: Optional[float] = None,
        bucket_lengths: Optional[List[int]] = None,
        allow_no_signal: bool = False,
        max_samples: Optional[int] = None,
        chunk: int = 512,
        cache_chunks: int = 2,
    ):
        hdf5io._needs_h5py_for(h5_path, "an .npz corpus")
        self.path = hdf5io.resolve_h5_path(h5_path)
        self.whiten = whiten
        self.sigma_mode = sigma_mode
        self.sigma_fixed = sigma_fixed
        self.include_metadata = include_metadata
        self.chunk = int(chunk)
        self.cache_chunks = int(cache_chunks)
        self.meta_scale = hdf5io.compute_meta_scale(self.path)
        self.M = float(mass_scale if mass_scale is not None
                       else self.meta_scale.get("M", 80.0))
        self.c_meta = 4 if include_metadata else 0
        self._cache: Dict[tuple, Dict[str, np.ndarray]] = {}
        self._cache_order: list = []
        self.peak_live_samples = 0
        self.bytes_read = 0          # array bytes read from an .npz twin
        self.h2d_bytes_epoch = 0
        self._dev_chunks: Dict[tuple, Dict[str, torch.Tensor]] = {}
        self._dev_bytes = 0

        with self._open() as f:
            if "noisy" not in f:
                raise KeyError("HDF5 must have 'noisy' dataset")
            n_total = f["noisy"].shape[0]
            if "signal" not in f and not allow_no_signal:
                raise KeyError("missing 'signal' dataset (allow_no_signal=False)")
            self._has_signal = "signal" in f
            self.fs = hdf5io.read_sampling_rate(f)
            if "lengths" in f:
                lengths = np.asarray(f["lengths"][:], np.int64)
            elif isinstance(f, hdf5io._NpzCorpus):
                lengths = f.row_lengths("noisy")
            else:
                # one row at a time: slicing the whole variable-length
                # dataset would load the corpus
                noisy_ds = f["noisy"]
                lengths = np.fromiter(
                    (len(noisy_ds[i]) for i in range(n_total)),
                    dtype=np.int64, count=n_total)
            self._psd_key = "psd_model" if "psd_model" in f else (
                "psd" if "psd" in f else None)
            self._psd_grid = None
            if self._psd_key is None and all(
                    k in f for k in ("psd_len", "psd_df", "psd_f_lower")):
                self._psd_grid = tuple(np.asarray(f[k][:], np.float64)
                                       for k in ("psd_len", "psd_df",
                                                 "psd_f_lower"))
            has_model = self._psd_key is not None or self._psd_grid is not None
            self._has_welch = "psd_welch" in f and "psd_welch_freqs" in f
            self.whiten_mode = _resolve_whiten_mode(whiten_mode, has_model,
                                                    self._has_welch)
            self.whiten_mode_resolved = _check_whiten_domain(
                self.whiten_mode, has_model, self._has_welch, whiten,
                self.path)
            self._meta_cols = {k: (np.asarray(f[k][:], np.float64)
                                   if k in f else None)
                               for k in ("mass1", "mass2", "spin1z", "spin2z")}

        self.n = int(n_total if max_samples is None
                     else min(n_total, int(max_samples)))
        lengths = lengths[:self.n]
        if bucket_lengths is not None:
            bl_sorted = sorted(bucket_lengths)
            Lb_of = np.empty(self.n, np.int64)
            for i, L in enumerate(lengths):
                fits = [b for b in bl_sorted if b >= L]
                if not fits:
                    raise ValueError(
                        f"sample length {L} exceeds all bucket lengths")
                Lb_of[i] = fits[0]
        else:
            Lb_of = np.array([next_pow2(int(L)) for L in lengths], np.int64)
        self._bucket_idx: Dict[int, np.ndarray] = {
            int(Lb): np.nonzero(Lb_of == Lb)[0] for Lb in np.unique(Lb_of)}

    def _open(self):
        return hdf5io.open_corpus(self.path, "streaming an HDF5 corpus",
                                  "an .npz corpus")

    @property
    def bucket_lengths(self) -> List[int]:
        return sorted(self._bucket_idx.keys())

    def num_batches(self, batch_size: int, drop_remainder: bool = False) -> int:
        total = 0
        for Lb in self.bucket_lengths:
            N = len(self._bucket_idx[Lb])
            total += (N // batch_size if drop_remainder
                      else -(-N // batch_size))
        return total

    def _load_chunk(self, Lb: int, ci: int) -> Dict[str, np.ndarray]:
        """Chunk ``ci`` of bucket ``Lb``, prepared (whitened, sigma, meta,
        left-padded) and kept in the LRU."""
        key = (Lb, ci)
        if key in self._cache:
            return self._cache[key]
        idx = self._bucket_idx[Lb][ci * self.chunk:(ci + 1) * self.chunk]
        cols: Dict[str, list] = {"clean": [], "noisy": [], "mask": [],
                                 "sigma": [], "meta": [], "index": []}
        with self._open() as f:
            noisy_ds = f["noisy"]
            sig_ds = f["signal"] if self._has_signal else None
            psd_ds = f[self._psd_key] if self._psd_key else None
            pw_ds = f["psd_welch"] if self._has_welch else None
            pwf_ds = f["psd_welch_freqs"] if self._has_welch else None
            for i in idx:
                y = np.asarray(noisy_ds[i], np.float32)
                x = (np.asarray(sig_ds[i], np.float32) if sig_ds is not None
                     else np.zeros_like(y))
                if psd_ds is not None:
                    P_model = np.asarray(psd_ds[i], np.float64)
                elif self._psd_grid is not None:
                    pl, pdf, pfl = self._psd_grid
                    P_model = hdf5io.derive_model_psd_np(pl[i], pdf[i], pfl[i])
                else:
                    P_model = None
                y, x, sigma = _prep_sample(
                    y, x, self.fs, whiten=self.whiten,
                    whiten_mode=self.whiten_mode_resolved,
                    sigma_mode=self.sigma_mode, sigma_fixed=self.sigma_fixed,
                    psd_model=P_model,
                    psd_welch=(np.asarray(pw_ds[i], np.float64)
                               if pw_ds is not None else None),
                    psd_welch_freqs=(np.asarray(pwf_ds[i], np.float64)
                                     if pwf_ds is not None else None))
                if self.include_metadata:
                    def _get(name, i=i):
                        col = self._meta_cols.get(name)
                        return float(col[i]) if col is not None else 0.0

                    meta = np.array([_get("mass1") / max(self.M, 1e-9),
                                     _get("mass2") / max(self.M, 1e-9),
                                     _get("spin1z"), _get("spin2z")],
                                    np.float32)
                else:
                    meta = np.zeros(0, np.float32)
                L = len(y)
                pad = Lb - L
                cols["clean"].append(np.pad(x.astype(np.float32), (pad, 0)))
                cols["noisy"].append(np.pad(y.astype(np.float32), (pad, 0)))
                cols["mask"].append(np.pad(np.ones(L, np.float32), (pad, 0)))
                cols["sigma"].append(sigma)
                cols["meta"].append(meta)
                cols["index"].append(int(i))
            self.bytes_read += getattr(f, "bytes_read", 0)

        out = {
            "clean": np.stack(cols["clean"])[:, None, :],
            "noisy": np.stack(cols["noisy"])[:, None, :],
            "mask": np.stack(cols["mask"])[:, None, :],
            "sigma": np.asarray(cols["sigma"], np.float32),
            "meta": (np.stack(cols["meta"]) if self.include_metadata
                     else np.zeros((len(idx), 0), np.float32)),
            "index": np.asarray(cols["index"], np.int64),
        }
        self._cache[key] = out
        self._cache_order.append(key)
        while len(self._cache_order) > self.cache_chunks:
            self._cache.pop(self._cache_order.pop(0), None)
        live = sum(v["sigma"].shape[0] for v in self._cache.values())
        self.peak_live_samples = max(self.peak_live_samples, live)
        return out

    def _plans(self, rng: np.random.Generator, shuffle: bool) -> List[tuple]:
        """(bucket length, chunk order) per bucket, in the epoch's order."""
        plans = []
        for Lb in self.bucket_lengths:
            n_chunks = -(-len(self._bucket_idx[Lb]) // self.chunk)
            plans.append((Lb, rng.permutation(n_chunks) if shuffle
                          else np.arange(n_chunks)))
        if shuffle:
            rng.shuffle(plans)
        return plans

    def iter_batches(
        self,
        batch_size: int,
        rng: np.random.Generator,
        shuffle: bool = True,
        drop_remainder: bool = False,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Static-shape numpy batches, two-level shuffled, bounded memory."""
        for Lb, chunk_order in self._plans(rng, shuffle):
            pool: Optional[Dict[str, np.ndarray]] = None
            for ci in chunk_order:
                c = self._load_chunk(Lb, int(ci))
                if shuffle:
                    perm = rng.permutation(c["sigma"].shape[0])
                    c = {k: v[perm] for k, v in c.items()}
                pool = (c if pool is None else
                        {k: np.concatenate([pool[k], c[k]]) for k in c})
                while pool["sigma"].shape[0] >= batch_size:
                    yield {k: v[:batch_size] for k, v in pool.items()}
                    pool = {k: v[batch_size:] for k, v in pool.items()}
            n_left = pool["sigma"].shape[0] if pool is not None else 0
            if n_left and not drop_remainder:
                first = self._load_chunk(Lb, int(chunk_order[0]))
                reps = -(-(batch_size - n_left) // first["sigma"].shape[0])
                yield {k: np.concatenate(
                    [pool[k]] + [first[k]] * reps)[:batch_size]
                    for k in pool}

    def iter_batches_device(
        self,
        batch_size: int,
        rng: np.random.Generator,
        shuffle: bool = True,
        drop_remainder: bool = False,
        budget_bytes: int = 4 << 30,
        device=None,
    ) -> Iterator[Dict[str, torch.Tensor]]:
        """The batches of :meth:`iter_batches` (the same ``rng`` draws, the
        same rows; no 'index'), gathered on ``device`` (default: the GPU)
        from chunks resident there.

        Each chunk is prepared on the host (the LRU still bounds host
        memory), copied to the device once and kept there while the
        resident chunks fit ``budget_bytes``, so epochs after the first
        copy nothing; chunks over the budget are copied again every epoch.
        ``h2d_bytes_epoch`` is the bytes the latest epoch copied."""
        from ..utils.device import resolve_device

        dev = resolve_device(device)
        self.h2d_bytes_epoch = 0

        def get_chunk(Lb, ci):
            key = (Lb, ci)
            if key in self._dev_chunks:
                return self._dev_chunks[key]
            host = self._load_chunk(Lb, ci)
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                   for k, v in host.items() if k != "index"}
            nbytes = sum(v.nbytes for k, v in host.items() if k != "index")
            self.h2d_bytes_epoch += nbytes
            if self._dev_bytes + nbytes <= budget_bytes:
                self._dev_chunks[key] = out
                self._dev_bytes += nbytes
            return out

        for Lb, chunk_order in self._plans(rng, shuffle):
            pool = None
            for ci in chunk_order:
                c = get_chunk(Lb, int(ci))
                if shuffle:
                    perm = rng.permutation(int(c["sigma"].shape[0]))
                    sel = torch.from_numpy(perm).to(dev)
                    c = {k: v.index_select(0, sel) for k, v in c.items()}
                pool = (c if pool is None else
                        {k: torch.cat([pool[k], c[k]]) for k in c})
                while pool["sigma"].shape[0] >= batch_size:
                    yield {k: v[:batch_size] for k, v in pool.items()}
                    pool = {k: v[batch_size:] for k, v in pool.items()}
            n_left = int(pool["sigma"].shape[0]) if pool is not None else 0
            if n_left and not drop_remainder:
                first = get_chunk(Lb, int(chunk_order[0]))
                reps = -(-(batch_size - n_left) // int(first["sigma"].shape[0]))
                yield {k: torch.cat([pool[k]] + [first[k]] * reps)[:batch_size]
                       for k in pool}


def prefetch_to_device(batch_iter, size: int = 2, device=None):
    """Numpy batches (less 'index') as tensors on ``device`` (default: the
    GPU), ``size`` batches in flight.  On the GPU each batch is pinned and
    copied without blocking on a side stream, so the copy of batch i + 1
    overlaps the step on batch i; the compute stream waits for the copy of
    the batch it receives."""
    import collections

    from ..utils.device import resolve_device

    dev = resolve_device(device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(batch):
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items() if k != "index"}
        if side is None:
            return host, None
        with torch.cuda.stream(side):
            out = {k: v.pin_memory().to(dev, non_blocking=True)
                   for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def take(item):
        out, done = item
        if done is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(done)
            for v in out.values():
                v.record_stream(cur)
        return out

    queue = collections.deque()
    for batch in batch_iter:
        queue.append(put(batch))
        if len(queue) > size:
            yield take(queue.popleft())
    while queue:
        yield take(queue.popleft())


def iterate_batches(
    ds,
    batch_size: int,
    rng: np.random.Generator,
    shuffle: bool = True,
    drop_remainder: bool = False,
) -> Iterator[Dict[str, np.ndarray]]:
    """Static-shape numpy batches across buckets for one epoch, in the order
    and with the ``rng`` draws of the JAX package's ``iterate_batches``; a
    :class:`StreamingDataset` yields its own."""
    if hasattr(ds, "iter_batches"):
        yield from ds.iter_batches(batch_size, rng, shuffle=shuffle,
                                   drop_remainder=drop_remainder)
        return
    for Lb, sel in _batch_order(ds, batch_size, rng, shuffle, drop_remainder):
        b = ds.buckets[Lb]
        yield {k: v[sel] for k, v in b.items()}


def upload_buckets(ds, device, budget_bytes: int = 10 << 30):
    """Every bucket's arrays (all but 'index') as tensors on ``device``, once:
    {L: {key: tensor}}; None when the dataset's arrays exceed
    ``budget_bytes`` or it is a :class:`StreamingDataset`."""
    if not hasattr(ds, "buckets"):
        return None
    total = sum(v.nbytes for b in ds.buckets.values() for v in b.values()
                if isinstance(v, np.ndarray))
    if total > budget_bytes:
        return None
    return {Lb: {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in b.items() if k != "index"}
            for Lb, b in ds.buckets.items()}


def device_resident_batches(
    ds,
    batch_size: int,
    rng: np.random.Generator,
    dev_buckets,
    shuffle: bool = True,
    drop_remainder: bool = False,
):
    """The batches of :func:`iterate_batches` (same ``rng`` draws, same
    rows), gathered on the device from :func:`upload_buckets`' tensors.  The
    epoch's row indices go to the device in one copy; each batch is then an
    ``index_select`` there, with no host-to-device copy per step."""
    order = _batch_order(ds, batch_size, rng, shuffle, drop_remainder)
    if not order:
        return
    device = next(iter(next(iter(dev_buckets.values())).values())).device
    rows = torch.from_numpy(np.stack([sel for _, sel in order])).to(device)
    for i, (Lb, _) in enumerate(order):
        yield {k: v.index_select(0, rows[i]) for k, v in dev_buckets[Lb].items()}


def synthetic_dataset(
    n: int,
    *,
    seed: int = 0,
    segment_len: int = 8192,
    fs: int = 4096,
    mass_min: float = 20.0,
    mass_max: float = 50.0,
    snr_min: float = 8.0,
    snr_max: float = 30.0,
    spin_min: float = 0.0,
    spin_max: float = 0.0,
    whiten: bool = True,
    sigma_mode: str = "std",
    chunk: int = 256,
    device=None,
) -> PreparedDataset:
    """A self-contained corpus: chirps in coloured noise synthesised on
    ``device`` (default: the GPU) in chunks, whitened there by the
    generation PSD, then a one-bucket :class:`PreparedDataset` (the
    ``gw-train --data synth:N`` path).  Masses, SNRs and spins are the numpy
    draws of the JAX package's ``synthetic_dataset`` from ``seed``; the noise
    comes from a ``torch.Generator`` seeded with ``seed``, so it differs
    from the JAX package's."""
    from ..ops.whiten import whiten_weight
    from ..utils.device import resolve_device
    from . import synth

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = synth.SynthConfig(n=segment_len, fs=fs)

    a = rng.uniform(mass_min, mass_max, size=n)
    b = rng.uniform(mass_min, mass_max, size=n)
    m1 = np.maximum(a, b)
    m2 = np.minimum(a, b)
    snr = rng.uniform(snr_min, snr_max, size=n)
    s1 = rng.uniform(spin_min, spin_max, size=n)
    s2 = rng.uniform(spin_min, spin_max, size=n)

    def col(v, sl):
        return torch.as_tensor(v[sl], dtype=torch.float32, device=dev)

    clean_l, noisy_l = [], []
    w = None
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(n, c0 + chunk))
        out = synth.generate_batch(gen, col(m1, sl), col(m2, sl),
                                   col(snr, sl), col(s1, sl), col(s2, sl),
                                   config=cfg)
        if whiten:
            # the scaled generation PSD: the joint strain / PSD scaling
            # cancels in the whitening up to a global factor, which
            # sigma-normalisation removes
            if w is None:
                w = whiten_weight(out["psd"][0])
            C = torch.fft.rfft(out["signal"], dim=-1) * w
            Y = torch.fft.rfft(out["noisy"], dim=-1) * w
            clean_l.append(torch.fft.irfft(C, n=segment_len).cpu().numpy())
            noisy_l.append(torch.fft.irfft(Y, n=segment_len).cpu().numpy())
        else:
            clean_l.append(out["signal"].cpu().numpy())
            noisy_l.append(out["noisy"].cpu().numpy())

    clean = np.concatenate(clean_l).astype(np.float32)
    noisy = np.concatenate(noisy_l).astype(np.float32)
    M = max(float(np.percentile(np.concatenate([m1, m2]), 95)), 1e-9)
    meta = np.stack([m1 / M, m2 / M, s1, s2], axis=1).astype(np.float32)
    ds = dataset_from_arrays(clean, noisy, fs=float(fs), meta=meta,
                             sigma_mode=sigma_mode,
                             meta_scale={"M": M, "q": 10.0})
    ds.whiten = whiten
    ds.whiten_mode = "model" if whiten else "raw"
    return ds


def meta_dim(ds) -> int:
    """Number of metadata channels."""
    if hasattr(ds, "c_meta"):
        return int(ds.c_meta)
    return int(ds.buckets[ds.bucket_lengths[0]]["meta"].shape[1])


def num_batches(ds, batch_size: int, drop_remainder: bool = False) -> int:
    """Batches per epoch of :func:`iterate_batches`."""
    if hasattr(ds, "num_batches"):
        return ds.num_batches(batch_size, drop_remainder)
    total = 0
    for Lb in ds.bucket_lengths:
        N = ds.buckets[Lb]["sigma"].shape[0]
        total += N // batch_size if drop_remainder else -(-N // batch_size)
    return total
