"""3.5PN aligned-spin inspiral waveforms, TaylorT2-style (counterpart of the
JAX package's ``data/pn.py``; the same formulas, as tensor ops).

From the TaylorF2 stationary-phase series with v = (pi M f)^(1/3),

    psi(v) = 3/(128 eta v^5) * sum_k c_k v^k        (k = 0,2,3,4,5L,6L,7)

with the aligned-spin terms (spin-orbit beta at 1.5PN, spin-spin sigma at
2PN), the time-domain phasing follows from the stationary-phase relations
tau(v) = -(M / (6 v^2)) psi'(v) and Phi(v) = phi_c - 2 pi f tau(v) - psi(v).
A chirp is then: the Kerr-ISCO termination of the effective spin, clipped
to the band and to the monotone branch of tau(v); tau(v) inverted on the
time grid by bracketed Newton-bisection (a fixed number of iterations,
vectorised over every sample and time); the restricted amplitude; a
merger-ringdown attachment matched at the termination; a half-Hann turn-on
at the f_lower crossing.

Functions take tensors (per-sample parameters of any leading shape) and
compute in their dtype; a chirp of (B,) parameters is (B, n).
:func:`pn_chirp` computes the per-sample parameters in its inputs' dtype
(float32 unless one is float64) and the time grid, the inversion of tau(v)
and the phase in float64 always: over a long segment the phase reaches
about 1e4 rad, where a float32's rounding (about 1e-3 rad) would differ
between devices.  It inverts tau(v) with ``CHIRP_NEWTON_ITERS`` iterations,
not the JAX package's 24, after which some samples are still unconverged,
so that one ulp more on a log moves a 65536-sample chirp by over 1e-4 of
its peak (under 1e-6 after 40).  The chirp it returns is float32.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

# geometric unit conversions (the values of data/synth.py)
MSUN_S = 4.925490947641267e-06    # G * Msun / c^3  [seconds]
MPC_S = 1.02927125054339e14       # 1 Mpc / c       [seconds]

EULER_GAMMA = 0.5772156649015329

_LN4 = 1.3862943611198906

# Newton-bisection iterations of pn_chirp's tau(v) inversion (see above)
CHIRP_NEWTON_ITERS = 40


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


# ---------------------------------------------------------------------------
# Mass / spin parameter combinations
# ---------------------------------------------------------------------------

def mass_params(m1, m2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Total mass in seconds and symmetric mass ratio eta."""
    M = m1 + m2
    eta = (m1 * m2) / (M * M)
    return M * MSUN_S, eta


def spin_phasing_params(m1, m2, chi1, chi2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Aligned-spin phasing parameters: the 1.5PN spin-orbit
    beta = (1/12) sum_i [113 (m_i/M)^2 + 75 eta] chi_i and the 2PN
    spin-spin sigma = (79/8) eta chi1 chi2 (Poisson & Will 1995)."""
    M = m1 + m2
    eta = (m1 * m2) / (M * M)
    x1 = m1 / M
    x2 = m2 / M
    beta = ((113.0 * x1 * x1 + 75.0 * eta) * chi1
            + (113.0 * x2 * x2 + 75.0 * eta) * chi2) / 12.0
    sigma = (79.0 / 8.0) * eta * chi1 * chi2
    return beta, sigma


def chi_eff(m1, m2, chi1, chi2) -> torch.Tensor:
    """Mass-weighted aligned effective spin."""
    M = m1 + m2
    return (m1 * chi1 + m2 * chi2) / M


def kerr_isco_f_gw(m1, m2, chi) -> torch.Tensor:
    """GW frequency (twice the orbital) of the Kerr ISCO for spin chi
    (Bardeen-Press-Teukolsky, prograde branch; chi = 0 gives r = 6 M)."""
    M_s = (m1 + m2) * MSUN_S
    a = torch.clamp(chi, -0.998, 0.998)
    one_m = torch.clamp(1.0 - a * a, min=1e-9)
    z1 = 1.0 + _cbrt(one_m) * (_cbrt(1.0 + a) + _cbrt(1.0 - a))
    z2 = torch.sqrt(3.0 * a * a + z1 * z1)
    root = torch.sqrt(torch.clamp((3.0 - z1) * (3.0 + z1 + 2.0 * z2), min=0.0))
    r = 3.0 + z2 - torch.sign(a) * root
    m_omega = 1.0 / (torch.pow(r, 1.5) + a)
    return m_omega / (math.pi * M_s)


# ---------------------------------------------------------------------------
# Remnant and quasi-normal-mode fits
# ---------------------------------------------------------------------------

def final_mass_spin(m1, m2, chi1, chi2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Remnant mass (seconds) and spin: the Barausse & Rezzolla 2009
    aligned-spin fit for the spin, the nonspinning radiated-energy fit of
    Barausse, Morozova & Rezzolla 2012 for the mass."""
    M_s, eta = mass_params(m1, m2)
    chi = chi_eff(m1, m2, chi1, chi2)
    s4, s5, t0, t2, t3 = -0.1229, 0.4537, -2.8904, -3.5171, 2.5763
    a_f = (chi + s4 * chi * chi * eta + s5 * chi * eta * eta + t0 * chi * eta
           + 2.0 * math.sqrt(3.0) * eta + t2 * eta * eta
           + t3 * eta * eta * eta)
    a_f = torch.clamp(a_f, -0.998, 0.998)
    e_rad = eta * (0.0559745 + eta * (0.580951 + eta * (-0.960673
                                                        + 3.35241 * eta)))
    return M_s * (1.0 - e_rad), a_f


def qnm_f_tau(m_f_s, a_f) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frequency (Hz) and damping time (s) of the l = m = 2, n = 0 Kerr QNM
    (Berti, Cardoso & Will 2006 fits)."""
    one_m = torch.clamp(1.0 - a_f, min=1e-4)
    omega = (1.5251 - 1.1568 * torch.pow(one_m, 0.1292)) / m_f_s
    q = 0.7000 + 1.4187 * torch.pow(one_m, -0.4990)
    return omega / (2.0 * math.pi), 2.0 * q / omega


# ---------------------------------------------------------------------------
# 3.5PN phasing series and its SPA-derived tau / Phi
# ---------------------------------------------------------------------------

def _coeffs(eta, beta, sigma):
    """TaylorF2 phasing coefficients; c5 and c6 carry ln v as (constant,
    ln-v slope) parts."""
    pi = math.pi
    c2 = 3715.0 / 756.0 + 55.0 * eta / 9.0
    c3 = 4.0 * beta - 16.0 * pi
    c4 = (15293365.0 / 508032.0 + 27145.0 * eta / 504.0
          + 3085.0 * eta * eta / 72.0 - 10.0 * sigma)
    a5 = pi * (38645.0 / 756.0 - 65.0 * eta / 9.0)
    c6_const = (11583231236531.0 / 4694215680.0 - 640.0 * pi * pi / 3.0
                - 6848.0 * (EULER_GAMMA + _LN4) / 21.0
                + (-15737765635.0 / 3048192.0 + 2255.0 * pi * pi / 12.0) * eta
                + 76055.0 * eta * eta / 1728.0
                - 127825.0 * eta * eta * eta / 1296.0)
    c6_ln = -6848.0 / 21.0
    c7 = pi * (77096675.0 / 254016.0 + 378515.0 * eta / 1512.0
               - 74045.0 * eta * eta / 756.0)
    return c2, c3, c4, a5, c6_const, c6_ln, c7


def psi_of_v(v, eta, beta, sigma):
    """SPA phasing psi(v) (3.5PN, aligned spin)."""
    c2, c3, c4, a5, c6c, c6l, c7 = _coeffs(eta, beta, sigma)
    lv = torch.log(v)
    series = (1.0 + c2 * v ** 2 + c3 * v ** 3 + c4 * v ** 4
              + a5 * (1.0 + 3.0 * lv) * v ** 5
              + (c6c + c6l * lv) * v ** 6
              + c7 * v ** 7)
    return 3.0 / (128.0 * eta) * series / v ** 5


def tau_of_v(v, M_s, eta, beta, sigma):
    """Time to coalescence tau(v) = -(M / (6 v^2)) dpsi/dv."""
    c2, c3, c4, a5, c6c, c6l, c7 = _coeffs(eta, beta, sigma)
    lv = torch.log(v)
    bracket = (5.0 / v ** 8
               + 3.0 * c2 / v ** 6
               + 2.0 * c3 / v ** 5
               + c4 / v ** 4
               - 3.0 * a5 / v ** 3
               - (c6c + c6l * lv + c6l) / v ** 2
               - 2.0 * c7 / v)
    return (M_s / (256.0 * eta)) * bracket


def phase_of_v(v, M_s, eta, beta, sigma):
    """GW phase relative to coalescence, -2 pi f tau - psi, with
    f = v^3 / (pi M)."""
    f = v ** 3 / (math.pi * M_s)
    return (-2.0 * math.pi * f * tau_of_v(v, M_s, eta, beta, sigma)
            - psi_of_v(v, eta, beta, sigma))


def _dtau_dv(v, M_s, eta, beta, sigma):
    """Analytic d tau / dv."""
    c2, c3, c4, a5, c6c, c6l, c7 = _coeffs(eta, beta, sigma)
    lv = torch.log(v)
    bracket = (-40.0 / v ** 9
               - 18.0 * c2 / v ** 7
               - 10.0 * c3 / v ** 6
               - 4.0 * c4 / v ** 5
               + 9.0 * a5 / v ** 4
               + (2.0 * (c6c + c6l * lv + c6l) - c6l) / v ** 3
               + 2.0 * c7 / v ** 2)
    return (M_s / (256.0 * eta)) * bracket


def monotone_v_term(v_min, v_cand, M_s, eta, beta, sigma, npts: int = 64):
    """Largest v <= v_cand with tau'(v) < 0 on [v_min, v], by a scan of
    ``npts`` grid points: one point back from the first turnover (times
    0.999), or v_cand where there is none."""
    frac = torch.linspace(0.0, 1.0, npts, dtype=v_cand.dtype,
                          device=v_cand.device)
    e = (..., None)
    vg = v_min[e] + (v_cand - v_min)[e] * frac
    bad = _dtau_dv(vg, M_s[e], eta[e], beta[e], sigma[e]) >= 0.0
    first_bad = torch.argmax(bad.to(torch.int8), dim=-1, keepdim=True)
    idx = torch.clamp(first_bad - 1, min=1)
    v_safe = torch.gather(vg, -1, idx)[..., 0] * 0.999
    return torch.where(bad.any(dim=-1), v_safe, v_cand)


def invert_tau(tau_target, M_s, eta, beta, sigma, v_min, v_max,
               iters: int = 24):
    """Solve tau(v) = tau_target elementwise by bracketed Newton-bisection
    (``iters`` iterations; a Newton step that leaves the [lo, hi] bracket
    falls back to the midpoint).  ``tau_target`` has any shape; the other
    arguments broadcast against it."""
    tau_floor = torch.clamp(tau_target, min=1e-8)
    lo = torch.broadcast_to(torch.as_tensor(v_min, dtype=tau_floor.dtype,
                                            device=tau_floor.device),
                            tau_floor.shape)
    hi = torch.broadcast_to(torch.as_tensor(v_max, dtype=tau_floor.dtype,
                                            device=tau_floor.device),
                            tau_floor.shape)
    v = torch.pow(5.0 * M_s / (256.0 * eta * tau_floor), 0.125)
    v = torch.minimum(torch.maximum(v, lo), hi)
    for _ in range(iters):
        t = tau_of_v(v, M_s, eta, beta, sigma)
        above = t > tau_target          # tau decreasing: root at larger v
        lo = torch.where(above, torch.maximum(lo, v), lo)
        hi = torch.where(above, hi, torch.minimum(hi, v))
        d = torch.clamp(_dtau_dv(v, M_s, eta, beta, sigma), max=-1e-12)
        v_newton = v - (t - tau_target) / d
        mid = 0.5 * (lo + hi)
        use_mid = ((~torch.isfinite(v_newton)) | (v_newton <= lo)
                   | (v_newton >= hi))
        v = torch.where(use_mid, mid, v_newton)
    return v


# ---------------------------------------------------------------------------
# Duration and the full chirp
# ---------------------------------------------------------------------------

def pn_duration(m1, m2, chi1, chi2, f_lower: float = 20.0):
    """PN chirp duration in seconds: tau at the f_lower crossing."""
    M_s, eta = mass_params(m1, m2)
    beta, sigma = spin_phasing_params(m1, m2, chi1, chi2)
    v_low = _cbrt(math.pi * M_s * f_lower)
    f_term = kerr_isco_f_gw(m1, m2, chi_eff(m1, m2, chi1, chi2))
    v_cand = _cbrt(math.pi * M_s * torch.clamp(f_term, min=1.2 * f_lower))
    v_low = torch.minimum(v_low, 0.98 * v_cand)
    return tau_of_v(v_low, M_s, eta, beta, sigma)


def pn_chirp(
    m1: torch.Tensor,
    m2: torch.Tensor,
    chi1=0.0,
    chi2=0.0,
    *,
    n: int,
    fs: int,
    distance: float = 410.0,
    f_lower: float = 20.0,
    phi_c: float = 0.0,
    inclination: float = 0.0,
    fplus: float = 1.0,
    fcross: float = 0.0,
    t_post: float = 0.05,
    ringdown_damp: float = 12.0,
    ringdown: str = "qnm",
    f_taper_frac: float = 1.0,
) -> torch.Tensor:
    """Fixed-length detector-frame 3.5PN aligned-spin chirp, float32, of
    the broadcast shape of the parameters + (n,), on ``m1``'s device:
    coalescence ``t_post`` s before the segment
    end, half-Hann turn-on at the f_lower crossing, merger-ringdown matched
    in amplitude and phase at the termination.

    ``ringdown``: "qnm" (Kerr remnant QNM; the frequency blends from the
    termination to f_QNM over 10 M_f), "qnm_c1" (the blend timescale and the
    decay's ramp-in chosen so frequency and envelope are C^1), "isco" (a
    damped sinusoid at the termination frequency, ``ringdown_damp`` e-folds
    per angular cycle).  ``f_taper_frac`` < 1 makes the turn-on complete at
    the f_lower crossing instead of starting there."""
    if not 0.5 < f_taper_frac <= 1.0:
        raise ValueError(
            f"f_taper_frac must be in (0.5, 1.0], got {f_taper_frac}")
    dev = torch.as_tensor(m1).device
    params = [torch.as_tensor(a, device=dev) for a in (m1, m2, chi1, chi2)]
    dtype = torch.float32
    for a in params:
        if a.is_floating_point():
            dtype = torch.promote_types(dtype, a.dtype)
    m1, m2, chi1, chi2 = torch.broadcast_tensors(
        *(a.to(dtype) for a in params))
    wide = torch.float64
    e = (..., None)
    dt = 1.0 / fs
    M_s, eta = mass_params(m1, m2)
    mc_s = torch.pow(eta, 0.6) * M_s
    d_s = distance * MPC_S
    beta, sigma = spin_phasing_params(m1, m2, chi1, chi2)

    f_term = kerr_isco_f_gw(m1, m2, chi_eff(m1, m2, chi1, chi2))
    f_term = torch.clamp(f_term, 1.2 * f_lower, 0.45 * fs)
    v_cand = _cbrt(math.pi * M_s * f_term)
    v_min = _cbrt(math.pi * M_s * (0.5 * f_lower))
    v_term = monotone_v_term(v_min, v_cand, M_s, eta, beta, sigma)
    tau_term = tau_of_v(v_term, M_s, eta, beta, sigma)
    f_term = v_term ** 3 / (math.pi * M_s)

    # the time grid, tau(v)'s inversion and the phase in float64
    t = torch.arange(n, dtype=wide, device=dev) * dt
    t_c = (n - 1) * dt - t_post
    tau = t_c - t
    tau_eff = torch.maximum(tau, tau_term.to(wide)[e])

    Me, etae, betae, sigmae = (a.to(wide)[e] for a in (M_s, eta, beta, sigma))
    v = invert_tau(tau_eff, Me, etae, betae, sigmae, v_min.to(wide)[e],
                   v_term.to(wide)[e], iters=CHIRP_NEWTON_ITERS)
    f_t = v ** 3 / (math.pi * Me)
    phase = phi_c + phase_of_v(v, Me, etae, betae, sigmae)
    amp = (4.0 / d_s) * torch.pow(mc_s, 5.0 / 3.0)[e] * torch.pow(
        math.pi * f_t, 2.0 / 3.0)

    ci = math.cos(inclination)
    hp = amp * (1.0 + ci * ci) / 2.0 * torch.cos(phase)
    hc = amp * ci * torch.sin(phase)
    h_insp = fplus * hp + fcross * hc

    t_term = t_c - tau_term
    phase_term = phi_c + phase_of_v(v_term, M_s, eta, beta, sigma)
    amp_term = (4.0 / d_s) * torch.pow(mc_s, 5.0 / 3.0) * torch.pow(
        math.pi * f_term, 2.0 / 3.0)
    dt_rd = torch.clamp(t - t_term[e], min=0.0)
    if ringdown in ("qnm", "qnm_c1"):
        m_f_s, a_f = final_mass_spin(m1, m2, chi1, chi2)
        f_qnm, tau_rd = qnm_f_tau(m_f_s, a_f)
        f_qnm = torch.maximum(f_qnm, 1.05 * f_term)
        if ringdown == "qnm_c1":
            dtau = torch.clamp(_dtau_dv(v_term, M_s, eta, beta, sigma),
                               max=-1e-30)
            fdot_term = -3.0 * v_term ** 2 / (math.pi * M_s * dtau)
            tau_blend = torch.minimum(
                torch.maximum((f_qnm - f_term) / fdot_term, 2.0 * m_f_s),
                100.0 * m_f_s)
        else:
            tau_blend = 10.0 * m_f_s
        blend = torch.exp(-dt_rd / tau_blend[e])
        f_rd_t = f_qnm[e] - (f_qnm - f_term)[e] * blend
        ph_rd = phase_term[e] + 2.0 * math.pi * (
            f_qnm[e] * dt_rd - ((f_qnm - f_term) * tau_blend)[e] * (1.0 - blend))
        if ringdown == "qnm_c1":
            decay_exp = -(dt_rd - tau_blend[e] * (1.0 - blend)) / tau_rd[e]
        else:
            decay_exp = -dt_rd / tau_rd[e]
        decay = (amp_term[e] * torch.pow(f_rd_t / f_term[e], 2.0 / 3.0)
                 * torch.exp(decay_exp))
    else:
        tau_rd = ringdown_damp / (2.0 * math.pi * f_term)
        ph_rd = phase_term[e] + 2.0 * math.pi * f_term[e] * dt_rd
        decay = amp_term[e] * torch.exp(-dt_rd / tau_rd[e])
    h_rd = (fplus * decay * (1.0 + ci * ci) / 2.0 * torch.cos(ph_rd)
            + fcross * decay * ci * torch.sin(ph_rd))

    h = torch.where(tau > tau_term[e], h_insp, h_rd)

    v_low = torch.minimum(_cbrt(math.pi * M_s * f_lower), 0.98 * v_term)
    tau_start = tau_of_v(v_low, M_s, eta, beta, sigma)
    t_start = t_c - tau_start
    if f_taper_frac < 1.0:
        v_tap = torch.minimum(
            _cbrt(math.pi * M_s * (f_taper_frac * f_lower)), 0.98 * v_term)
        tau_tap = tau_of_v(v_tap, M_s, eta, beta, sigma)
        t_tap = t_c - tau_tap
        ramp = torch.clamp((t - t_tap[e]) / torch.clamp(
            t_start - t_tap, min=dt)[e], 0.0, 1.0)
    else:
        ramp = torch.clamp((t - t_start[e]) / 0.25, 0.0, 1.0)
    window = 0.5 - 0.5 * torch.cos(math.pi * ramp)
    return (h * window).to(torch.float32)
