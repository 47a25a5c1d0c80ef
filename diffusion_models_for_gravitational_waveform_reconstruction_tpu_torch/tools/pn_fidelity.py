"""Waveform-engine fidelity: the time-domain chirp of ``data/pn.py`` against
the closed-form TaylorF2 stationary-phase waveform; the port's twin of the
root ``tools/pn_fidelity.py``.

For each (m1, m2, chi1 = chi2 = chi) of a grid over the trained parameter
space, ``pn.pn_chirp`` (the whole assembly: tau(v) Newton inversion,
spin-dependent termination, half-Hann turn-on, the ``--ringdown``
attachment) is computed in float64 on the device, FFT'd, and matched
against

    H(f) = sqrt(5/24) pi^(-2/3) Mc^(5/6) D^(-1) f^(-7/6) e^(-i (psi(v) - pi/4)),
    v = (pi M f)^(1/3)

with the same 3.5PN psi(v) series, by the aLIGO-ZDHP-weighted inner
product maximised over coalescence time (an inverse FFT of the overlap
integrand) and phase (its modulus), in the band below 85% of the Kerr ISCO
frequency (SPA is not valid through merger) and in an inspiral core band.
Mismatch = 1 - match.  No pycbc is needed.

    python -m diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools.pn_fidelity \
        [--out runs/flagship/pn_fidelity.json] [--ringdown qnm] [--device cpu]

Writes the root tool's JSON (``method``, ``pycbc_status``,
``f_taper_frac``, ``ringdown``, ``rows``, ``mismatch_max``,
``mismatch_median``) and the device it ran on.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..data import pn
from ..data.hdf5io import aligo_zdhp_psd_np
from ..utils.device import resolve_device

MSUN_S = pn.MSUN_S
MPC_S = pn.MPC_S
MASSES = [(20, 20), (28, 24), (36, 30), (44, 36), (50, 42)]
CHIS = [-0.6, 0.0, 0.6]


def _f64(v, device="cpu") -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float64, device=device)


def taylorf2(freqs: np.ndarray, m1: float, m2: float, chi1: float,
             chi2: float, distance: float) -> np.ndarray:
    """Closed-form restricted-amplitude TaylorF2 H(f) (f64, physical)."""
    M_s, eta = pn.mass_params(float(m1), float(m2))
    beta, sigma = pn.spin_phasing_params(float(m1), float(m2), float(chi1),
                                         float(chi2))
    mc_s = float(M_s) * eta ** 0.6
    f = np.asarray(freqs, np.float64)
    v = (np.pi * float(M_s) * f) ** (1.0 / 3.0)
    psi = pn.psi_of_v(torch.from_numpy(v), eta, beta, sigma).numpy()
    D_s = distance * MPC_S
    amp = (np.sqrt(5.0 / 24.0) * np.pi ** (-2.0 / 3.0)
           * mc_s ** (5.0 / 6.0) / D_s * f ** (-7.0 / 6.0))
    # e^{-i(psi - pi/4)}: t_c and phi_c are free (maximised over in the match)
    return amp * np.exp(-1j * (psi - np.pi / 4.0))


def weighted_match(h_td: np.ndarray, fs: float, m1, m2, chi1, chi2,
                   distance: float, f_lo: float, f_hi: float) -> float:
    """Noise-weighted match of a time-domain waveform against TaylorF2,
    maximised over time (IFFT) and phase (modulus)."""
    n = len(h_td)
    H1 = np.fft.rfft(h_td.astype(np.float64)) / fs          # continuous FT
    freqs = np.fft.rfftfreq(n, 1.0 / fs)
    band = (freqs >= f_lo) & (freqs <= f_hi)
    H2 = np.zeros_like(H1)
    H2[band] = taylorf2(freqs[band], m1, m2, chi1, chi2, distance)
    P = aligo_zdhp_psd_np(freqs, f_lower=max(10.0, f_lo - 5.0))
    w = np.zeros_like(P)
    ok = band & (P > 0)
    w[ok] = 1.0 / P[ok]
    df = fs / n
    s11 = 4.0 * df * np.sum(np.abs(H1) ** 2 * w)
    s22 = 4.0 * df * np.sum(np.abs(H2) ** 2 * w)
    integrand = H1 * np.conj(H2) * w
    # maximise over time and phase: C(t_j) = sum_k z_k e^{2 pi i k j / N};
    # a positive-frequency sum, so its modulus is the phase maximisation;
    # x4 zero padding for sub-sample peak resolution
    N4 = 4 * n
    z = np.zeros(N4, np.complex128)
    z[:len(integrand)] = integrand
    C = np.fft.ifft(z) * N4
    m = 4.0 * df * np.max(np.abs(C))
    return float(m / np.sqrt(s11 * s22))


def chirp(m1, m2, chi, n: int, fs: float, f_lower: float, ringdown: str,
          f_taper_frac: float, device) -> np.ndarray:
    """``pn.pn_chirp`` from float64 parameters on ``device`` (its phase and
    everything else in float64; the chirp comes back float32), as float64
    numpy."""
    m1_t, m2_t, chi_t = (_f64(v, device) for v in (m1, m2, chi))
    return pn.pn_chirp(m1_t, m2_t, chi_t, chi_t, n=n, fs=int(fs),
                       distance=410.0, f_lower=f_lower, fplus=1.0,
                       fcross=0.0, ringdown=ringdown,
                       f_taper_frac=f_taper_frac).cpu().numpy().astype(
        np.float64)


def fidelity_rows(fs: float, fl: float, ringdown: str, f_taper_frac: float,
                  device, masses=MASSES, chis=CHIS) -> list:
    """One row per (m1, m2, chi): the segment length, the match band's top,
    the match, the mismatch and the inspiral core's mismatch."""
    rows = []
    for (m1, m2) in masses:
        for chi in chis:
            # compare below 85% of the (spin-dependent) ISCO, so that neither
            # SPA's breakdown nor the ringdown attachment enters the match
            f_term = float(pn.kerr_isco_f_gw(
                _f64(m1), _f64(m2), pn.chi_eff(_f64(m1), _f64(m2), _f64(chi),
                                              _f64(chi))))
            f_hi = 0.85 * f_term
            # the segment sized from the taper-start frequency, so that a
            # below-band turn-on (f_taper_frac < 1) is contained
            dur = float(pn.pn_duration(_f64(m1), _f64(m2), _f64(chi),
                                       _f64(chi),
                                       f_lower=f_taper_frac * fl))
            n = 1 << int(np.ceil(np.log2((dur + 1.0) * fs)))
            h = chirp(m1, m2, chi, n, fs, fl, ringdown, f_taper_frac, device)
            match = weighted_match(h, fs, m1, m2, chi, chi, 410.0,
                                   fl + 2.0, f_hi)
            # inspiral core: away from the turn-on and the merger's leakage
            core = (weighted_match(h, fs, m1, m2, chi, chi, 410.0,
                                   fl + 6.0, 0.7 * f_term)
                    if 0.7 * f_term > fl + 10.0 else None)
            rows.append({"m1": m1, "m2": m2, "chi": chi,
                         "f_hi_hz": f_hi, "n": n, "match": match,
                         "mismatch": 1.0 - match,
                         "core_mismatch": (1.0 - core
                                           if core is not None else None)})
            print(f"m1={m1} m2={m2} chi={chi:+.1f}: match={match:.5f} "
                  f"(mismatch {1 - match:.2e}, band [{fl + 2:.0f},"
                  f"{f_hi:.0f}] Hz; core "
                  f"{(1 - core) if core is not None else float('nan'):.2e})")
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="runs/flagship/pn_fidelity.json")
    ap.add_argument("--fs", type=float, default=4096.0)
    ap.add_argument("--f-lower", type=float, default=20.0)
    ap.add_argument("--f-taper-frac", type=float, default=1.0,
                    help="< 1: the half-Hann turn-on completes at the "
                         "f_lower crossing (taper below band) instead of "
                         "ramping 0.25 s into the band (pn.pn_chirp)")
    ap.add_argument("--ringdown", choices=["qnm", "qnm_c1", "isco"],
                    default="qnm",
                    help="post-inspiral attachment; 'qnm_c1' is the C1 "
                         "(chirp-rate-matched) blend")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    rows = fidelity_rows(args.fs, args.f_lower, args.ringdown,
                         args.f_taper_frac, dev)
    mm = [r["mismatch"] for r in rows]
    out = {
        "method": "TD assembly vs closed-form TaylorF2 SPA, aLIGO-ZDHP-"
                  "weighted match, maximised over t_c/phi_c, inspiral band",
        "pycbc_status": "not installed; no SEOBNRv4 fixture in the repo — "
                        "the comparison is against TaylorF2 only",
        "f_taper_frac": args.f_taper_frac,
        "ringdown": args.ringdown,
        "rows": rows,
        "mismatch_max": max(mm), "mismatch_median": float(np.median(mm)),
        "device": dev.type,
    }
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2)
    print(f"[pn_fidelity] max mismatch {max(mm):.2e}, "
          f"median {np.median(mm):.2e} -> {args.out}")
    return out


if __name__ == "__main__":
    main()
