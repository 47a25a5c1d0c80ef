"""Gravitational-waveform and detector-noise synthesis as tensor ops
(counterpart of the JAX package's ``data/synth.py``).

A sample: a chirp (3.5PN aligned-spin by default, ``data/pn.py``; or the
restricted 0PN chirp), the constant antenna response of one detector, the
analytic aLIGO zero-detuning high-power design PSD (zero below f_lower),
the chirp scaled to a target matched-filter SNR, and Gaussian noise coloured
by the PSD.  Everything is fixed-length and batched over samples, on the
device of the inputs.

Scaled units: physical PSDs (~1e-46 strain^2/Hz) underflow float32, so the
PSD is carried times ``PSD_SCALE`` (strain times ``STRAIN_SCALE`` where it
matters); matched-filter SNR is invariant under the joint scaling.

Normal draws come from a ``torch.Generator``, or are passed in (``normals``)
to reproduce draws made elsewhere.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import pn

MSUN_S = pn.MSUN_S
MPC_S = pn.MPC_S
STRAIN_SCALE = 1e21
PSD_SCALE = STRAIN_SCALE * STRAIN_SCALE


# ---------------------------------------------------------------------------
# Design-curve PSD
# ---------------------------------------------------------------------------

def aligo_zdhp_psd(freqs: torch.Tensor, f_lower: float = 20.0, *,
                   scale: float = PSD_SCALE) -> torch.Tensor:
    """Analytic fit to the aLIGO zero-detuning high-power design PSD,
    S(f) = 1e-49 (x^-4.14 - 5 x^-2 + 111 (1 - x^2 + x^4/2) / (1 + x^2/2)),
    x = f / 215 Hz, zero below ``f_lower``; returns S * ``scale`` in freqs'
    floating dtype (float32 for other inputs)."""
    f = torch.as_tensor(freqs)
    if not f.is_floating_point():
        f = f.to(torch.float32)
    x = torch.clamp(f, min=1e-3) / 215.0
    s = (1e-49 * scale) * (
        torch.pow(x, -4.14)
        - 5.0 * torch.pow(x, -2.0)
        + 111.0 * (1.0 - x ** 2 + 0.5 * x ** 4) / (1.0 + 0.5 * x ** 2))
    return torch.where(f >= f_lower, s, torch.zeros_like(s))


# ---------------------------------------------------------------------------
# Restricted 0PN chirp
# ---------------------------------------------------------------------------

def chirp_mass(m1, m2):
    M = m1 + m2
    eta = (m1 * m2) / (M * M)
    return torch.pow(eta, 3.0 / 5.0) * M


def isco_frequency(m1, m2):
    """Schwarzschild ISCO GW frequency for total mass M (Hz)."""
    M_s = (m1 + m2) * MSUN_S
    return 1.0 / (6.0 ** 1.5 * math.pi * M_s)


def tau_of_f(mc_s, f):
    """Newtonian time to coalescence at GW frequency f."""
    return (5.0 / 256.0) * torch.pow(mc_s, -5.0 / 3.0) * torch.pow(
        math.pi * f, -8.0 / 3.0)


def antenna_pattern(ra: float, dec: float, psi: float) -> Tuple[float, float]:
    """Static long-wavelength response (F+, Fx) of a detector with arms along
    x and y, at GMST 0."""
    cth = np.sin(dec)
    c2ps, s2ps = np.cos(2 * psi), np.sin(2 * psi)
    fp0 = 0.5 * (1 + cth ** 2) * np.cos(2 * ra)
    fx0 = cth * np.sin(2 * ra)
    return float(fp0 * c2ps - fx0 * s2ps), float(fp0 * s2ps + fx0 * c2ps)


# ra = dec = psi = 0 is the documented optimally-oriented sky (F+ 1, Fx 0);
# any other sky with no response is refused
_OPTIMAL_SKY = (0.0, 0.0, 0.0)


def resolve_antenna(ra: float, dec: float, psi: float) -> Tuple[float, float]:
    """(F+, Fx) for a SynthConfig sky, with the optimal-sky convention."""
    if (ra, dec, psi) == _OPTIMAL_SKY:
        return 1.0, 0.0
    fp, fx = antenna_pattern(ra, dec, psi)
    if abs(fp) < 1e-6 and abs(fx) < 1e-6:
        raise ValueError(
            f"sky (ra={ra}, dec={dec}, psi={psi}) has zero antenna "
            f"response for this detector orientation; pick another sky or "
            f"use the default optimal orientation")
    return fp, fx


def newtonian_chirp(m1, m2, *, n: int, fs: int, distance: float = 410.0,
                    f_lower: float = 20.0, phi_c: float = 0.0,
                    inclination: float = 0.0, fplus: float = 1.0,
                    fcross: float = 0.0, t_post: float = 0.05,
                    ringdown_damp: float = 12.0) -> torch.Tensor:
    """Restricted 0PN chirp, float32, ``m1.shape + (n,)``: Schwarzschild-ISCO
    termination, a damped ringdown at f_isco matched there, a half-Hann
    turn-on over 0.25 s from the f_lower crossing."""
    m1 = torch.as_tensor(m1, dtype=torch.float32)
    m2 = torch.as_tensor(m2, dtype=torch.float32, device=m1.device)
    m1, m2 = torch.broadcast_tensors(m1, m2)
    e = (..., None)
    dt = 1.0 / fs
    mc_s = chirp_mass(m1, m2) * MSUN_S
    d_s = distance * MPC_S
    t = torch.arange(n, dtype=torch.float32, device=m1.device) * dt
    t_c = (n - 1) * dt - t_post
    tau = t_c - t

    f_isco = isco_frequency(m1, m2)
    tau_isco = tau_of_f(mc_s, f_isco)
    tau_eff = torch.maximum(tau, tau_isco[e])
    f_t = (1.0 / math.pi) * torch.pow(5.0 / (256.0 * tau_eff), 3.0 / 8.0) \
        * torch.pow(mc_s, -5.0 / 8.0)[e]
    phase = phi_c - 2.0 * torch.pow(tau_eff / (5.0 * mc_s[e]), 5.0 / 8.0)
    amp = (4.0 / d_s) * torch.pow(mc_s, 5.0 / 3.0)[e] * torch.pow(
        math.pi * f_t, 2.0 / 3.0)
    ci = math.cos(inclination)
    h_insp = (fplus * amp * (1.0 + ci * ci) / 2.0 * torch.cos(phase)
              + fcross * amp * ci * torch.sin(phase))

    t_isco = t_c - tau_isco
    phase_isco = phi_c - 2.0 * torch.pow(tau_isco / (5.0 * mc_s), 5.0 / 8.0)
    amp_isco = (4.0 / d_s) * torch.pow(mc_s, 5.0 / 3.0) * torch.pow(
        math.pi * f_isco, 2.0 / 3.0)
    tau_rd = ringdown_damp / (2.0 * math.pi * f_isco)
    dt_rd = torch.clamp(t - t_isco[e], min=0.0)
    ph_rd = phase_isco[e] + 2.0 * math.pi * f_isco[e] * dt_rd
    env = amp_isco[e] * torch.exp(-dt_rd / tau_rd[e])
    h_rd = (fplus * env * (1.0 + ci * ci) / 2.0 * torch.cos(ph_rd)
            + fcross * env * ci * torch.sin(ph_rd))
    h = torch.where(tau > tau_isco[e], h_insp, h_rd)

    t_start = t_c - tau_of_f(mc_s, torch.full_like(mc_s, f_lower))
    ramp = torch.clamp((t - t_start[e]) / 0.25, 0.0, 1.0)
    window = 0.5 - 0.5 * torch.cos(math.pi * ramp)
    return (h * window).to(torch.float32)


# ---------------------------------------------------------------------------
# Matched-filter sigma and coloured noise
# ---------------------------------------------------------------------------

def matched_filter_sigma(signal: torch.Tensor, psd: torch.Tensor, fs: float,
                         f_lower: float = 20.0, *, signal_scale: float = 1.0,
                         psd_scale: float = PSD_SCALE) -> torch.Tensor:
    """sqrt(4 df sum_{f >= f_lower} |h~|^2 / S(f)) over the last axis, with
    h~ = dt rfft(h) (pycbc.filter.sigma's convention).  ``signal`` is
    physical strain times ``signal_scale``, ``psd`` physical times
    ``psd_scale`` on the rfft grid; the result is physical."""
    N = signal.shape[-1]
    dt = 1.0 / fs
    df = fs / N
    factor = (psd_scale ** 0.5) / signal_scale
    hf = torch.fft.rfft(signal * factor) * dt
    freqs = torch.fft.rfftfreq(N, dt, device=signal.device)
    valid = (freqs >= f_lower) & (psd > 0)
    integrand = torch.where(
        valid, hf.abs() ** 2 / torch.where(psd > 0, psd, torch.ones_like(psd)),
        torch.zeros_like(psd))
    return torch.sqrt(4.0 * df * integrand.sum(dim=-1))


def colored_noise(a: torch.Tensor, b: torch.Tensor, psd: torch.Tensor, n: int,
                  fs: float, *, psd_scale: float = PSD_SCALE,
                  out_scale: float = STRAIN_SCALE) -> torch.Tensor:
    """Gaussian noise with the one-sided PSD ``psd`` (physical times
    ``psd_scale``) from standard normal draws ``a``, ``b`` (the real and
    imaginary parts, (..., n // 2 + 1)); the output is physical strain times
    ``out_scale``.  E|X_k|^2 = n fs S_k / 2 for interior bins; DC and (for
    even n) Nyquist are real with doubled variance."""
    unit = out_scale / (psd_scale ** 0.5)
    amp = torch.sqrt(n * fs * psd / 4.0) * unit
    z = torch.complex(amp * a, amp * b)
    z[..., 0] = torch.sqrt(n * fs * psd[..., 0] / 2.0) * unit * a[..., 0]
    if n % 2 == 0:
        z[..., -1] = torch.sqrt(n * fs * psd[..., -1] / 2.0) * unit * a[..., -1]
    return torch.fft.irfft(z, n=n).to(torch.float32)


# ---------------------------------------------------------------------------
# Full sample generation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SynthConfig:
    """Static generation parameters."""

    n: int = 16384                 # segment length in samples
    fs: int = 4096
    f_lower: float = 20.0
    distance: float = 410.0
    detector: str = "H1"
    ra: float = 0.0
    dec: float = 0.0
    polarization: float = 0.0
    engine: str = "pn"             # "pn" (3.5PN aligned spin) | "newtonian"
    ringdown: str = "qnm"          # pn engine: "qnm" | "qnm_c1" | "isco"
    f_taper_frac: float = 1.0      # pn engine: < 1 ends the turn-on at f_lower


def generate_sample(generator: Optional[torch.Generator], m1, m2, target_snr,
                    spin1z=0.0, spin2z=0.0, *,
                    config: SynthConfig = SynthConfig(),
                    normals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One (signal, noise, noisy) triple, or a batch of them when the
    parameters are (B,) tensors: chirp -> antenna projection -> design PSD
    -> scale to ``target_snr`` -> coloured noise.  The noise's normal draws
    are ``normals`` = (a, b), each (..., n // 2 + 1), or drawn from
    ``generator`` (real parts first).

    Returns float32 'signal', 'noise', 'noisy' in PHYSICAL strain (..., n),
    'psd' (..., n // 2 + 1) in physical units times ``PSD_SCALE`` (one
    curve, broadcast over the samples), and
    'raw_sigma', the chirp's matched-filter sigma before scaling."""
    c = config
    fp, fx = resolve_antenna(c.ra, c.dec, c.polarization)
    m1 = torch.as_tensor(m1, dtype=torch.float32,
                         device=None if generator is None else generator.device)
    dev = m1.device
    f32 = dict(dtype=torch.float32, device=dev)
    m2 = torch.as_tensor(m2, **f32)
    target_snr = torch.as_tensor(target_snr, **f32)
    spin1z = torch.as_tensor(spin1z, **f32)
    spin2z = torch.as_tensor(spin2z, **f32)
    if c.engine == "pn":
        h = pn.pn_chirp(m1, m2, spin1z, spin2z, n=c.n, fs=c.fs,
                        distance=c.distance, f_lower=c.f_lower, fplus=fp,
                        fcross=fx, ringdown=c.ringdown,
                        f_taper_frac=c.f_taper_frac)
    elif c.engine == "newtonian":
        h = newtonian_chirp(m1, m2, n=c.n, fs=c.fs, distance=c.distance,
                            f_lower=c.f_lower, fplus=fp, fcross=fx)
    else:
        raise ValueError(f"unknown SynthConfig.engine {c.engine!r}")
    freqs = torch.fft.rfftfreq(c.n, 1.0 / c.fs, device=dev)
    psd = aligo_zdhp_psd(freqs, c.f_lower)
    current = matched_filter_sigma(h, psd, c.fs, c.f_lower)
    scale = target_snr / torch.clamp(current, min=1e-30)
    signal = (h * scale[..., None]).to(torch.float32)
    if normals is None:
        shape = h.shape[:-1] + (c.n // 2 + 1,)
        normals = tuple(torch.randn(shape, generator=generator, **f32)
                        for _ in range(2))
    noise = colored_noise(normals[0], normals[1], psd, c.n, c.fs,
                          out_scale=1.0)
    return {"signal": signal, "noise": noise, "noisy": signal + noise,
            "psd": psd.expand(h.shape[:-1] + psd.shape), "raw_sigma": current}


def generate_batch(generator: Optional[torch.Generator], m1, m2, target_snr,
                   spin1z=None, spin2z=None, *,
                   config: SynthConfig = SynthConfig(),
                   normals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """:func:`generate_sample` over (B,) parameters at once; spins default to
    0 and broadcast from scalars."""
    m1 = torch.as_tensor(m1, dtype=torch.float32,
                         device=None if generator is None else generator.device)
    B = m1.shape[0]
    spins = [torch.broadcast_to(torch.as_tensor(
        0.0 if s is None else s, dtype=torch.float32, device=m1.device), (B,))
        for s in (spin1z, spin2z)]
    return generate_sample(generator, m1, m2, target_snr, *spins,
                           config=config, normals=normals)
