"""PSD estimation, whitening and de-whitening as tensor ops (counterpart of
the JAX package's ``ops/whiten.py``).

- 'train'-mode whitening: rfft -> |Y|^2 -> 9-bin boxcar smoothing -> floor
  -> / sqrt(P);
- model-PSD whitening, the PSD interpolated onto the rfft grid of the
  measurement's length;
- Welch PSDs with ``scipy.signal.welch``'s conventions (periodic hann
  window, noverlap = nperseg // 2, density scaling, a per-segment mean
  detrend, the one-sided doubling), every segment of every row in one
  batched rfft;
- sigma estimators (std / mad / fixed, 1 where degenerate).

They act on the LAST axis and broadcast over leading axes (``interp`` and
the functions built on it take a 1-D PSD), on the device and in the dtype
of their input.  The float64 host versions are in ``data/pipeline.py``.

PSD floors are RELATIVE to the per-row maximum: physical-strain PSDs are
~1e-46, so an absolute epsilon would swamp every bin.  Bins where a PSD is
zero are out of band (below f_lower): whitening zeroes them.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def rfftfreq(n: int, d: float, device=None) -> torch.Tensor:
    return torch.fft.rfftfreq(n, d, device=device)


def _boxcar_smooth_same(P: torch.Tensor, width: int = 9) -> torch.Tensor:
    """``np.convolve(P, ones(w) / w, mode='same')`` on the last axis (zero
    edges)."""
    F_ = P.shape[-1]
    if F_ <= width:
        return P
    kern = torch.full((1, 1, width), 1.0 / width, dtype=P.dtype,
                      device=P.device)
    out = F.conv1d(P.reshape(-1, 1, F_), kern, padding=width // 2)
    return out.reshape(P.shape)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor,
           left=None, right=None) -> torch.Tensor:
    """``np.interp`` for a 1-D increasing ``xp``: linear between the points,
    ``left`` / ``right`` (default the end values) outside them."""
    x = x.to(fp.dtype)
    xp = xp.to(fp.dtype)
    j = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    x0, x1 = xp[j - 1], xp[j]
    y0, y1 = fp[j - 1], fp[j]
    w = (x - x0) / torch.where(x1 > x0, x1 - x0, torch.ones_like(x1))
    out = y0 + w * (y1 - y0)
    lo = fp[0] if left is None else left
    hi = fp[-1] if right is None else right
    out = torch.where(x < xp[0], torch.as_tensor(lo, dtype=fp.dtype,
                                                 device=fp.device), out)
    return torch.where(x > xp[-1], torch.as_tensor(hi, dtype=fp.dtype,
                                                   device=fp.device), out)


# ---------------------------------------------------------------------------
# floors and weights
# ---------------------------------------------------------------------------

def psd_floor(P: torch.Tensor, rel: float = 1e-12) -> torch.Tensor:
    """Floor a PSD at ``rel`` times its per-row maximum (a maximum that is
    not positive counts as 1): scale-free, unlike an absolute epsilon."""
    mx = P.amax(dim=-1, keepdim=True)
    mx = torch.where(mx > 0, mx, torch.ones_like(mx))
    return torch.maximum(P, rel * mx)


def whiten_weight(P: torch.Tensor, rel: float = 1e-12) -> torch.Tensor:
    """1 / sqrt(floored P), and 0 where P == 0: such bins are out of band
    (below f_lower), where the noise counts as infinite."""
    return torch.where(P > 0, 1.0 / torch.sqrt(psd_floor(P, rel)),
                       torch.zeros_like(P))


def dewhiten_weight(P: torch.Tensor, rel: float = 1e-12) -> torch.Tensor:
    """The exact in-band inverse of :func:`whiten_weight`."""
    return torch.where(P > 0, torch.sqrt(psd_floor(P, rel)),
                       torch.zeros_like(P))


# ---------------------------------------------------------------------------
# train-like whitening (the measurement's own smoothed periodogram)
# ---------------------------------------------------------------------------

def train_psd(y: torch.Tensor) -> torch.Tensor:
    """|rfft(y - mean)|^2, smoothed over 9 bins and floored."""
    Y = torch.fft.rfft(y - y.mean(dim=-1, keepdim=True))
    return psd_floor(_boxcar_smooth_same(Y.abs() ** 2, 9))


def whiten_train_like(
    y: torch.Tensor, x: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Whiten y (and x) by y's own smoothed periodogram; returns
    (y_w, x_w or None, P)."""
    L = y.shape[-1]
    Y = torch.fft.rfft(y - y.mean(dim=-1, keepdim=True))
    P = psd_floor(_boxcar_smooth_same(Y.abs() ** 2, 9))
    y_w = torch.fft.irfft(Y / torch.sqrt(P), n=L)
    x_w = None
    if x is not None:
        X = torch.fft.rfft(x - x.mean(dim=-1, keepdim=True))
        x_w = torch.fft.irfft(X / torch.sqrt(P), n=L)
    return y_w, x_w, P


def dewhiten_train_like(sig: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """The inverse of train-like whitening by the floored P it returned."""
    L = sig.shape[-1]
    return torch.fft.irfft(torch.fft.rfft(sig) * torch.sqrt(P), n=L)


# ---------------------------------------------------------------------------
# model-PSD whitening
# ---------------------------------------------------------------------------

def interp_psd_to_length(P: torch.Tensor, L_src: int, L_tgt: int,
                         fs: float) -> torch.Tensor:
    """A 1-D one-sided PSD of ``L_src`` bins onto the rfft grid of
    ``L_tgt`` samples."""
    if L_src == (L_tgt // 2 + 1):
        return P
    f_src = torch.from_numpy(np.fft.rfftfreq(L_src * 2 - 2, 1.0 / fs))
    f_tgt = torch.from_numpy(np.fft.rfftfreq(L_tgt, 1.0 / fs))
    return interp(f_tgt.to(P.device), f_src.to(P.device), P)


def whiten_with_psd(
    y: torch.Tensor, x: Optional[torch.Tensor], P: torch.Tensor,
    eps: float = 1e-12,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Whiten by a one-sided PSD on the rfft grid of y's length (``eps`` a
    floor relative to the PSD's maximum)."""
    L = y.shape[-1]
    w = whiten_weight(P, eps)
    y_w = torch.fft.irfft(torch.fft.rfft(y) * w, n=L)
    x_w = None
    if x is not None:
        x_w = torch.fft.irfft(torch.fft.rfft(x) * w, n=L)
    return y_w, x_w


def dewhiten_with_psd(sig: torch.Tensor, P: torch.Tensor,
                      eps: float = 1e-12) -> torch.Tensor:
    """The exact in-band inverse of :func:`whiten_with_psd`."""
    L = sig.shape[-1]
    return torch.fft.irfft(torch.fft.rfft(sig) * dewhiten_weight(P, eps), n=L)


# ---------------------------------------------------------------------------
# Welch PSD
# ---------------------------------------------------------------------------

def hann_window(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The periodic ("DFT-even") Hann window ``scipy.signal.welch`` uses."""
    k = torch.arange(n, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)


def welch_psd(
    y: torch.Tensor,
    fs: float,
    nperseg: int = 4096,
    noverlap: Optional[int] = None,
    detrend: str = "constant",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-sided Welch PSD with density scaling; returns (freqs, Pxx).

    ``scipy.signal.welch(y, fs, nperseg=..., window='hann',
    noverlap=nperseg // 2, scaling='density')``: every segment of every row
    at once (``unfold``), a per-segment mean detrend for
    ``detrend='constant'`` ('none' keeps the mean), the window, one batched
    rfft, the segments' mean, and the one-sided doubling of every bin but
    DC and (for even ``nperseg``) Nyquist."""
    if detrend not in ("constant", "none"):
        raise ValueError(f"unknown detrend {detrend!r}: 'constant' or 'none'")
    L = y.shape[-1]
    nperseg = int(min(nperseg, L))
    if noverlap is None:
        noverlap = nperseg // 2
    step = nperseg - noverlap
    nseg = max(1, (L - noverlap) // step)
    win = hann_window(nperseg, y.dtype, y.device)
    scale = 1.0 / (fs * torch.sum(win * win))
    seg = y.unfold(-1, nperseg, step)[..., :nseg, :]
    if detrend == "constant":
        seg = seg - seg.mean(dim=-1, keepdim=True)
    Z = torch.fft.rfft(seg * win)
    P = ((Z.abs() ** 2) * scale).mean(dim=-2)
    nf = P.shape[-1]
    mult = torch.full((nf,), 2.0, dtype=P.dtype, device=P.device)
    mult[0] = 1.0
    if nperseg % 2 == 0:
        mult[-1] = 1.0
    freqs = torch.fft.rfftfreq(nperseg, 1.0 / fs, device=y.device)
    return freqs, P * mult


def whiten_with_welch(
    y: torch.Tensor, x: Optional[torch.Tensor], f_w: torch.Tensor,
    P_w: torch.Tensor, fs: float, eps: float = 1e-12,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Interpolate a saved 1-D Welch PSD onto y's rfft grid and whiten;
    returns (y_w, x_w, P_interp)."""
    L = y.shape[-1]
    f_tgt = torch.fft.rfftfreq(L, 1.0 / fs, device=y.device)
    P = interp(f_tgt, f_w, P_w)
    y_w, x_w = whiten_with_psd(y, x, P, eps)
    return y_w, x_w, P


# ---------------------------------------------------------------------------
# sigma estimators
# ---------------------------------------------------------------------------

def _median(x: torch.Tensor) -> torch.Tensor:
    """The median over the last axis, the mean of the two middle values for
    an even count (numpy's, not ``torch.median``'s lower middle)."""
    s = torch.sort(x, dim=-1).values
    n = s.shape[-1]
    if n % 2:
        return s[..., n // 2]
    return 0.5 * (s[..., n // 2 - 1] + s[..., n // 2])


def mad_std(x: torch.Tensor) -> torch.Tensor:
    """1.4826 * median(|x - median(x)|) + 1e-24, over the last axis."""
    med = _median(x)[..., None]
    return 1.4826 * _median((x - med).abs()) + 1e-24


def pick_sigma(y: torch.Tensor, mode: str = "std",
               fixed: float = 1.0) -> torch.Tensor:
    """Per-row sigma in the conditioning domain; 1 where it is not finite
    or not positive."""
    if mode == "std":
        s = y.std(dim=-1, correction=0)
    elif mode == "mad":
        s = mad_std(y)
    elif mode == "fixed":
        s = torch.full(y.shape[:-1], fixed, dtype=y.dtype, device=y.device)
    else:
        raise ValueError(f"unknown sigma mode: {mode!r}")
    return torch.where(torch.isfinite(s) & (s > 0), s, torch.ones_like(s))
