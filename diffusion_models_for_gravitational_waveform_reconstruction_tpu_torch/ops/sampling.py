"""Reverse-process samplers (counterpart of the JAX package's
``ops/sampling.py``).

The JAX ``lax.scan`` over the ladder is a Python loop here.  Per-step
coefficients are computed on the host exactly as JAX does: the float64
ladder constants are cast to float32 at the same points and the derived
scalars are float32 arithmetic, so each tensor op sees the same f32 scalars.
cond and uncond run as one doubled batch per step (classifier-free
guidance as ``out = cu*out_u + cc*out_c``).

Noise comes from a ``torch.Generator`` on the device, from
:class:`SeededNoise` (each draw a function of a seed and the draw's index,
through the registered op ``gwport::seeded_normal``, so that an exported
sampler draws what the live one draws), or from :class:`FixedNoise`, which
hands over draws made elsewhere (the tests pass JAX's own draws, so both
implementations see the same noise).

``ddim_sample(collect_diagnostics=True)`` also returns per-step diagnostics,
computed on the device, stacked there and moved to the host once after the
loop.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..utils.spans import span
from .kernels._op import NAMESPACE
from .schedules import (
    DiffusionSchedule,
    build_lambda_t_schedule,
    build_t_schedule,
    cfg_combination_coeffs,
    cfg_weight_schedule,
    t_for_target_snr,
)

# model_fn(net_in (B, C, L), t (B,)) -> (B, 1, L)
ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Sampler knobs; field names and defaults follow the JAX package."""

    steps: int = 200
    eta: float = 0.0
    start_t: Optional[int] = None
    init_mode: str = "noise"            # noise | scaled-noise | y-blend
    x0_std_est: float = 0.14
    dc_weight: float = 0.0
    cond_scale: float = 1.0
    eps_scale: float = 1.0
    pred_type: str = "eps"              # eps | v | x0
    use_selfcond: bool = True
    cfg_scale: float = 1.5
    cfg_mode: str = "const"             # const | tophat | gauss
    cfg_center: float = 0.70
    cfg_width: float = 0.12
    cfg_u_only_thresh: float = 0.05
    drop_y_only: bool = True
    oracle_init: bool = False
    # the trainer clamps every network input to +-clamp_inputs, so the
    # sampler clamps x_t and the self-conditioning channel to the same bound;
    # x0_clip bounds the x0 estimate (0 disables either)
    clamp_inputs: float = 10.0
    x0_clip: float = 10.0
    ladder: str = "t"                   # t | lambda
    selfcond_mode: str = "update"       # update | zero
    refine_passes: int = 0
    refine_t: int = 300
    refine_steps: int = 0


class FixedNoise:
    """Standard-normal draws given up front: ``init`` (the x_T draw) and
    ``steps[i]`` (the draw of ladder step i), moved to the sampler's device."""

    def __init__(self, init: torch.Tensor,
                 steps: Optional[Sequence[torch.Tensor]] = None):
        self._init = torch.as_tensor(init)
        self._steps = None if steps is None else [torch.as_tensor(s)
                                                  for s in steps]

    @staticmethod
    def _fit(z, shape, dtype, device):
        if tuple(z.shape) != tuple(shape):
            raise ValueError(f"noise of shape {tuple(z.shape)} given where "
                             f"{tuple(shape)} is drawn")
        return z.to(device=device, dtype=dtype)

    def init(self, shape, dtype, device):
        return self._fit(self._init, shape, dtype, device)

    def step(self, i, shape, dtype, device):
        if self._steps is None:
            raise ValueError("this sampler draws per-step noise; none given")
        return self._fit(self._steps[i], shape, dtype, device)


class _GeneratorNoise:
    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def init(self, shape, dtype, device):
        return torch.randn(shape, generator=self.generator, dtype=dtype,
                           device=device)

    def step(self, i, shape, dtype, device):
        return self.init(shape, dtype, device)


_MASK64 = (1 << 64) - 1


def _stream_seed(seed: int, draw: int) -> int:
    """splitmix64 of (seed mod 2^32) * 2^32 + (draw mod 2^32): a generator
    seed per (seed, draw), well mixed in its low 32 bits (the CPU generator
    keeps only those)."""
    z = ((((seed & 0xFFFFFFFF) << 32) | (draw & 0xFFFFFFFF))
         + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


@torch.library.custom_op(f"{NAMESPACE}::seeded_normal", mutates_args=())
def seeded_normal(seed: torch.Tensor, draw: int, shape: List[int],
                  dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Standard-normal ``shape`` in ``dtype`` on ``device``, a deterministic
    function of ``seed`` (a 0-d integer tensor, read on the host), ``draw``
    and the shape: drawn by a generator on ``device`` seeded from
    :func:`_stream_seed`."""
    g = torch.Generator(device=device).manual_seed(
        _stream_seed(int(seed), draw))
    return torch.randn(shape, generator=g, dtype=dtype, device=device)


@seeded_normal.register_fake
def _(seed, draw, shape, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device)


class SeededNoise:
    """Draws of :func:`seeded_normal` from one seed: ``init`` and each
    ``step`` take the next draw index (0, 1, ...), so the passes of a
    refined sampler that share this source draw fresh noise.  The seed is
    kept an int32 tensor on the CPU, so a draw waits on no device."""

    def __init__(self, seed):
        self.seed = torch.as_tensor(seed, dtype=torch.int32, device="cpu")
        self._draws = 0

    def init(self, shape, dtype, device):
        z = seeded_normal(self.seed, self._draws, list(shape), dtype,
                          torch.device(device))
        self._draws += 1
        return z

    def step(self, i, shape, dtype, device):
        return self.init(shape, dtype, device)


Noise = Union[torch.Generator, FixedNoise, SeededNoise]


def _noise_source(noise: Noise):
    return _GeneratorNoise(noise) if isinstance(noise, torch.Generator) else noise


class RankNoise:
    """Rank ``rank`` of ``n``'s rows of ``noise``'s draws: each draw of
    ``blocks`` x b rows is drawn for n times as many rows (the global
    batch) and this rank keeps rows [rank*b, (rank+1)*b) of each of the
    ``blocks`` consecutive blocks of n*b rows, so a sampler that holds its
    rank's rows of a batch sees the noise of the unsharded call.  A batch
    tiled seed-major over S seeds (``build_serving_fn``) is S blocks.
    ``rank`` is an int or a 0-d integer tensor (an input of an exported
    program): the rows are picked by an index tensor."""

    def __init__(self, noise, rank, n: int, blocks: int = 1):
        self.source, self.rank, self.n = _noise_source(noise), rank, n
        self.blocks = blocks

    def _rows(self, draw, shape):
        b = shape[0] // self.blocks
        z = draw((self.n * shape[0],) + tuple(shape[1:]))
        rank = torch.as_tensor(self.rank, device=z.device)
        idx = (torch.arange(self.blocks, device=z.device)[:, None]
               * (self.n * b) + rank * b
               + torch.arange(b, device=z.device)[None, :]).reshape(-1)
        return z.index_select(0, idx)

    def init(self, shape, dtype, device):
        return self._rows(lambda s: self.source.init(s, dtype, device), shape)

    def step(self, i, shape, dtype, device):
        return self._rows(lambda s: self.source.step(i, s, dtype, device),
                          shape)


def _f32(v) -> np.float32:
    return np.float32(v)


def _make_uncond(cond_used: torch.Tensor, drop_y_only: bool) -> torch.Tensor:
    """Unconditional stack: zero y only (keep metadata) or zero everything."""
    if drop_y_only and cond_used.shape[1] > 1:
        return torch.cat([torch.zeros_like(cond_used[:, :1]),
                          cond_used[:, 1:]], dim=1)
    return torch.zeros_like(cond_used)


def _prepare_cond(cond_stack: torch.Tensor, cfg: SamplerConfig):
    """(y_chan, cond_used, cond_u): ``cond_scale`` on the y channel only, and
    the CFG-unconditional stack per ``drop_y_only``."""
    y_chan = cond_stack[:, :1, :]
    y_used = cfg.cond_scale * y_chan
    cond_used = (torch.cat([y_used, cond_stack[:, 1:, :]], dim=1)
                 if cond_stack.shape[1] > 1 else y_used)
    return y_chan, cond_used, _make_uncond(cond_used, cfg.drop_y_only)


def lagged_xcorr(a: torch.Tensor, b: torch.Tensor, max_shift: int):
    """Normalised lag-corrected cross-correlation of the rows of ``a`` and
    ``b`` (B, L), mean-removed: (max over |k| <= max_shift of
    sum_i a[i] b[i+k] / (||a|| ||b||), the k that attains it), each (B,),
    from one FFT cross-correlation."""
    L = a.shape[1]
    nfft = 1 << int(2 * L - 1).bit_length()
    cc = torch.fft.irfft(torch.fft.rfft(a, nfft)
                         * torch.conj(torch.fft.rfft(b, nfft)), nfft)
    lags = torch.arange(-max_shift, max_shift + 1, device=a.device)
    vals = cc[:, (-lags) % nfft]                  # v(k) = sum a[i] b[i+k]
    denom = torch.sqrt((a * a).sum(dim=1) * (b * b).sum(dim=1)) + 1e-30
    best = vals.max(dim=1)
    return best.values / denom, lags[best.indices]


def _step_diagnostics(x_next, y_chan, x0_hat, eps_hat):
    """corr and lag-corrected xcorr of x_next against y (|lag| up to
    min(L - 1, 1024)), and the rms of x_next, x0_hat and eps_hat, per row."""
    B = x_next.shape[0]
    a = x_next.reshape(B, -1)
    a = a - a.mean(dim=1, keepdim=True)
    b = y_chan.reshape(B, -1)
    b = b - b.mean(dim=1, keepdim=True)
    corr = (a * b).sum(dim=1) / (
        torch.sqrt((a * a).sum(dim=1) * (b * b).sum(dim=1)) + 1e-30)
    xl, lag = lagged_xcorr(a, b, min(a.shape[1] - 1, 1024))

    def rms(v):
        return torch.sqrt(torch.mean(v * v, dim=(1, 2)))

    return {"corr": corr, "xcorr_lag": xl, "lag": lag, "x_rms": rms(x_next),
            "x0_rms": rms(x0_hat), "eps_rms": rms(eps_hat)}


def _t_ladder(schedule: DiffusionSchedule, cfg: SamplerConfig) -> np.ndarray:
    if cfg.ladder == "lambda":
        return build_lambda_t_schedule(schedule, cfg.steps, cfg.start_t)
    return build_t_schedule(schedule.T, cfg.steps, cfg.start_t)


def _net_in(x_t, cond, sc, use_selfcond):
    return torch.cat([x_t, cond] + ([sc] if use_selfcond else []), dim=1)


def _forward_out(model_fn, lad, i, x_t, x0_sc, cond_used, cond_u, cfg):
    """Ladder step ``i``'s network input and its (possibly CFG-combined)
    model forward; cond and uncond run as one doubled batch.  Returns the
    clamped ``(x_t, x0_sc)`` and the output."""
    with span("sampler/net_in"):
        x_t, x0_sc = _clamped(x_t, x0_sc, cfg)
        B = x_t.shape[0]
        t_b = torch.full((B,), int(lad.t[i]), dtype=torch.int64,
                         device=x_t.device)
        net = _net_in(x_t, cond_used, x0_sc, cfg.use_selfcond)
        if lad.need_uncond:
            net = torch.cat([net, _net_in(x_t, cond_u, x0_sc,
                                          cfg.use_selfcond)], dim=0)
            t_b = torch.cat([t_b, t_b], dim=0)
    out = model_fn(net, t_b)
    if lad.need_uncond:
        with span("sampler/guide"):
            out = float(lad.cu[i]) * out[B:] + float(lad.cc[i]) * out[:B]
    return x_t, x0_sc, out


def _x0_eps_from_out(out, x_t, ab_t: np.float32, cfg: SamplerConfig):
    """(x0_hat, eps_hat) from the network output under ``cfg.pred_type``;
    ``ab_t`` is the step's float32 alpha_bar."""
    one = _f32(1.0)
    if cfg.pred_type == "eps":
        eps_hat = cfg.eps_scale * out
        x0_hat = ((x_t - float(np.sqrt(one - ab_t)) * eps_hat)
                  / float(np.sqrt(ab_t)))
    elif cfg.pred_type == "v":
        sa = float(np.sqrt(ab_t))
        sb = float(np.sqrt(np.maximum(one - ab_t, _f32(0.0))))
        x0_hat = sa * x_t - sb * out
        eps_hat = sb * x_t + sa * out
    else:
        x0_hat = out
        eps_hat = ((x_t - float(np.sqrt(ab_t)) * x0_hat)
                   / float(np.sqrt(np.maximum(one - ab_t, _f32(1e-12)))))
    return x0_hat, eps_hat


def _init_x(cfg: SamplerConfig, noise, batch, length, ab_start: np.float32,
            y_chan, x0_std_est, clean_norm, dtype, device):
    """Initial x_T."""
    one = _f32(1.0)
    if cfg.oracle_init:
        if clean_norm is None:
            raise ValueError("oracle_init requires clean_norm")
        eps = noise.init(tuple(clean_norm.shape), dtype, device)
        return (float(np.sqrt(ab_start)) * clean_norm
                + float(np.sqrt(one - ab_start)) * eps)
    shape = (batch, 1, length)
    if cfg.init_mode == "noise":
        return noise.init(shape, dtype, device)
    if cfg.init_mode == "scaled-noise":
        std_init = np.sqrt(ab_start * _f32(x0_std_est ** 2) + (one - ab_start))
        return float(std_init) * noise.init(shape, dtype, device)
    if cfg.init_mode == "y-blend":
        z = noise.init(shape, dtype, device)
        return (float(np.sqrt(ab_start)) * y_chan
                + float(np.sqrt(one - ab_start)) * z)
    raise ValueError(f"unknown init_mode: {cfg.init_mode!r}")


class _Ladder:
    """Host-side per-step constants shared by the samplers."""

    def __init__(self, schedule, cfg, ab_hi):
        self.t = _t_ladder(schedule, cfg)
        self.N = len(self.t)
        ab = np.asarray(schedule.alpha_bar, np.float64).clip(1e-12, ab_hi)
        self.ab_t64 = ab[self.t]
        self.ab_t = self.ab_t64.astype(np.float32)
        self.ab_prev = np.concatenate([ab[self.t[1:]], [1.0]]).astype(np.float32)
        w = cfg_weight_schedule(self.N, cfg.cfg_mode, cfg.cfg_scale,
                                cfg.cfg_center, cfg.cfg_width)
        cu, cc = cfg_combination_coeffs(w, cfg.cfg_u_only_thresh)
        self.w = w.astype(np.float32)
        self.need_uncond = bool(np.any(cu != 0.0))
        self.cu, self.cc = cu.astype(np.float32), cc.astype(np.float32)
        self.ab_start = np.float32(self.ab_t64[0])


def _clamped(x_t, x0_sc, cfg):
    if cfg.clamp_inputs > 0:
        c = cfg.clamp_inputs
        return x_t.clamp(-c, c), x0_sc.clamp(-c, c)
    return x_t, x0_sc


def _x0_post(x0_hat, y_chan, x0_sc, cfg):
    """x0 clip, data-consistency blend and the next self-conditioning input."""
    if cfg.x0_clip > 0:
        x0_hat = x0_hat.clamp(-cfg.x0_clip, cfg.x0_clip)
    if cfg.dc_weight > 0:
        x0_hat = (1.0 - cfg.dc_weight) * x0_hat + cfg.dc_weight * y_chan
    sc_next = (x0_hat if (cfg.use_selfcond and cfg.selfcond_mode != "zero")
               else x0_sc)
    return x0_hat, sc_next


def _start(schedule, cfg, cond_stack, noise, clean_norm, x0_std_est, ab_hi):
    """The ladder, the conditioning, x_T and a zero self-conditioning
    input."""
    with span("sampler/start"):
        B, _, L = cond_stack.shape
        lad = _Ladder(schedule, cfg, ab_hi)
        y_chan, cond_used, cond_u = _prepare_cond(cond_stack, cfg)
        x0_std = cfg.x0_std_est if x0_std_est is None else x0_std_est
        x = _init_x(cfg, noise, B, L, lad.ab_start, y_chan, x0_std,
                    clean_norm, cond_stack.dtype, cond_stack.device)
        return lad, y_chan, cond_used, cond_u, x, torch.zeros_like(x)


@torch.no_grad()
def ddim_sample(model_fn: ModelFn, schedule: DiffusionSchedule,
                cond_stack: torch.Tensor, cfg: SamplerConfig, noise: Noise,
                clean_norm: Optional[torch.Tensor] = None,
                x0_std_est: Optional[float] = None,
                collect_diagnostics: bool = False):
    """DDIM reverse process on ``cond_stack`` (B, cond_in_ch, L); returns
    x0_hat_norm (B, 1, L).  At the last step ab_prev = 1, so the update lands
    exactly on x0_hat.

    With ``collect_diagnostics`` returns ``(x0_hat_norm, diag)``: numpy
    arrays per ladder step, ``t``, ``alpha_bar`` and ``cfg_w`` (N,) and
    ``corr``, ``xcorr_lag``, ``lag``, ``x_rms``, ``x0_rms``, ``eps_rms``
    (N, B), as the JAX sampler's."""
    noise = _noise_source(noise)
    dtype, device = cond_stack.dtype, cond_stack.device
    lad, y_chan, cond_used, cond_u, x, sc = _start(
        schedule, cfg, cond_stack, noise, clean_norm, x0_std_est, 1.0)
    one, zero, eta = _f32(1.0), _f32(0.0), _f32(cfg.eta)
    steps = []
    for i in range(lad.N):
        with span("sampler/step"):
            x, sc, out = _forward_out(model_fn, lad, i, x, sc, cond_used,
                                      cond_u, cfg)
            with span("sampler/update"):
                ab_t, ab_prev = lad.ab_t[i], lad.ab_prev[i]
                x0_hat, eps_hat = _x0_eps_from_out(out, x, ab_t, cfg)
                x0_hat, sc = _x0_post(x0_hat, y_chan, sc, cfg)
                sigma_t = eta * np.sqrt(
                    np.maximum((one - ab_prev) / (one - ab_t), zero)
                    * np.maximum(one - ab_t / ab_prev, zero))
                c_dir = np.sqrt(np.maximum(one - ab_prev - sigma_t * sigma_t,
                                           zero))
                x_next = (float(np.sqrt(ab_prev)) * x0_hat
                          + float(c_dir) * eps_hat)
                if cfg.eta > 0:
                    x_next = x_next + float(sigma_t) * noise.step(
                        i, tuple(x.shape), dtype, device)
            if collect_diagnostics:
                steps.append(_step_diagnostics(x_next, y_chan, x0_hat,
                                               eps_hat))
            x = x_next
    if not collect_diagnostics:
        return x
    diag = {"t": lad.t.astype(np.int32), "alpha_bar": lad.ab_t,
            "cfg_w": lad.w}
    for k in steps[0]:
        diag[k] = torch.stack([d[k] for d in steps]).cpu().numpy()
    return x, diag


@torch.no_grad()
def ddpm_sample(model_fn: ModelFn, schedule: DiffusionSchedule,
                cond_stack: torch.Tensor, cfg: SamplerConfig, noise: Noise,
                clean_norm: Optional[torch.Tensor] = None,
                x0_std_est: Optional[float] = None) -> torch.Tensor:
    """Ancestral DDPM over the (possibly strided) ladder, with the exact
    posterior q(x_s | x_t, x0_hat); the last step returns x0_hat."""
    noise = _noise_source(noise)
    dtype, device = cond_stack.dtype, cond_stack.device
    lad, y_chan, cond_used, cond_u, x, sc = _start(
        schedule, cfg, cond_stack, noise, clean_norm, x0_std_est, 1.0)
    one, zero = _f32(1.0), _f32(0.0)
    for i in range(lad.N):
        with span("sampler/step"):
            x, sc, out = _forward_out(model_fn, lad, i, x, sc, cond_used,
                                      cond_u, cfg)
            with span("sampler/update"):
                ab_t, ab_prev = lad.ab_t[i], lad.ab_prev[i]
                x0_hat, _ = _x0_eps_from_out(out, x, ab_t, cfg)
                x0_hat, sc = _x0_post(x0_hat, y_chan, sc, cfg)
                denom = np.maximum(one - ab_t, _f32(1e-12))
                coef0 = np.sqrt(ab_prev) * (one - ab_t / ab_prev) / denom
                coeft = np.sqrt(ab_t / ab_prev) * (one - ab_prev) / denom
                var = np.maximum((one - ab_prev) / denom
                                 * (one - ab_t / ab_prev), zero)
                z = noise.step(i, tuple(x.shape), dtype, device)
                if i == lad.N - 1:
                    x = x0_hat
                else:
                    x = ((float(coef0) * x0_hat + float(coeft) * x)
                         + float(np.sqrt(var)) * z)
    return x


@torch.no_grad()
def dpmpp_sample(model_fn: ModelFn, schedule: DiffusionSchedule,
                 cond_stack: torch.Tensor, cfg: SamplerConfig, noise: Noise,
                 clean_norm: Optional[torch.Tensor] = None,
                 x0_std_est: Optional[float] = None) -> torch.Tensor:
    """DPM-Solver++(2M): deterministic second-order multistep in
    lambda = log(alpha / sigma), one forward per step; first order at the
    first step and at the last (which lands on x0).  ``eta`` is ignored."""
    noise = _noise_source(noise)
    lad, y_chan, cond_used, cond_u, x, sc = _start(
        schedule, cfg, cond_stack, noise, clean_norm, x0_std_est, 1.0 - 1e-12)
    N = lad.N
    alpha = np.sqrt(lad.ab_t64)
    sig = np.sqrt(1.0 - lad.ab_t64)
    alpha_n = np.concatenate([alpha[1:], [1.0]])
    sig_n = np.concatenate([sig[1:], [0.0]])
    with np.errstate(divide="ignore"):
        lam = np.log(alpha / sig)
        lam_n = np.log(np.where(sig_n > 0, alpha_n, 1.0)
                       / np.where(sig_n > 0, sig_n, 1.0))
        lam_n = np.where(sig_n > 0, lam_n, np.inf)
    h = lam_n - lam                                   # > 0; last = inf
    c_x = np.where(sig > 0, sig_n / sig, 0.0).astype(np.float32)
    c_d = (alpha_n * -np.expm1(-h)).astype(np.float32)
    b_old = np.zeros(N)
    if N > 2:
        b_old[1:-1] = -1.0 / (2.0 * (h[:-2] / h[1:-1]))
    b_cur = (1.0 - b_old).astype(np.float32)
    b_old = b_old.astype(np.float32)

    x0_old = torch.zeros_like(x)
    for i in range(N):
        with span("sampler/step"):
            x, sc, out = _forward_out(model_fn, lad, i, x, sc, cond_used,
                                      cond_u, cfg)
            with span("sampler/update"):
                x0_hat, _ = _x0_eps_from_out(out, x, lad.ab_t[i], cfg)
                x0_hat, sc = _x0_post(x0_hat, y_chan, sc, cfg)
                d = float(b_cur[i]) * x0_hat + float(b_old[i]) * x0_old
                x = float(c_x[i]) * x + float(c_d[i]) * d
                x0_old = x0_hat
    return x


@torch.no_grad()
def one_step_proxy(model_fn: ModelFn, schedule: DiffusionSchedule,
                   clean_norm: torch.Tensor, cond_stack: torch.Tensor,
                   target_snr: float, cfg: SamplerConfig,
                   noise: Noise) -> torch.Tensor:
    """Single-step diagnostic reconstruction: forward-noise ``clean_norm``
    (B, 1, L) to the t whose SNR is closest to ``target_snr`` (the draw is
    ``noise``'s ``init``), denoise once (CFG-combined in one doubled batch
    when ``cfg_scale`` != 1) and return x0_hat_norm (B, 1, L) by
    ``cfg.pred_type``."""
    B = clean_norm.shape[0]
    dtype, device = clean_norm.dtype, clean_norm.device
    t_pick = t_for_target_snr(schedule, target_snr)
    t_b = torch.full((B,), t_pick, dtype=torch.int64, device=device)
    ab_t = np.float32(schedule.alpha_bar[t_pick])
    eps = _noise_source(noise).init(tuple(clean_norm.shape), dtype, device)
    x_t = (float(np.sqrt(ab_t)) * clean_norm
           + float(np.sqrt(_f32(1.0) - ab_t)) * eps)
    sc = torch.zeros_like(x_t)
    _, cond_used, cond_u = _prepare_cond(cond_stack, cfg)
    if cfg.cfg_scale != 1.0:
        net2 = torch.cat([_net_in(x_t, cond_used, sc, cfg.use_selfcond),
                          _net_in(x_t, cond_u, sc, cfg.use_selfcond)], dim=0)
        out2 = model_fn(net2, torch.cat([t_b, t_b]))
        out_c, out_u = out2[:B], out2[B:]
        out = out_u + cfg.cfg_scale * (out_c - out_u)
    else:
        out = model_fn(_net_in(x_t, cond_used, sc, cfg.use_selfcond), t_b)
    x0_hat, _ = _x0_eps_from_out(out, x_t, ab_t, cfg)
    return x0_hat


SAMPLERS = {"ddim": ddim_sample, "ddpm": ddpm_sample, "dpmpp": dpmpp_sample}


def _pass_noise(noise, k: int):
    """Noise of sampler pass k: one of a list per pass, or a shared source."""
    return noise[k] if isinstance(noise, (list, tuple)) else noise


def refine_only(sample_fn, model_fn, schedule, cond_stack, cfg: SamplerConfig,
                x0_norm, noise, x0_std_est=None):
    """``cfg.refine_passes`` re-noise -> re-denoise passes on ``x0_norm``:
    each pass forward-diffuses the reconstruction to ``t = refine_t`` (the
    ``oracle_init`` path) and samples the short ladder [refine_t..0].
    ``noise`` is one source for every pass or a list with one per pass."""
    n = int(cfg.refine_passes)
    if n <= 0:
        return x0_norm
    r_t = int(np.clip(int(cfg.refine_t), 1, schedule.T - 1))
    r_steps = (int(cfg.refine_steps) if int(cfg.refine_steps) > 0
               else max(1, int(cfg.steps) // 2))
    cfg_r = dataclasses.replace(cfg, oracle_init=True, start_t=r_t,
                                steps=r_steps, refine_passes=0)
    for k in range(n):
        x0_norm = sample_fn(model_fn, schedule, cond_stack, cfg_r,
                            _pass_noise(noise, k), clean_norm=x0_norm,
                            x0_std_est=x0_std_est)
    return x0_norm


def sample_with_refinement(sample_fn, model_fn, schedule, cond_stack,
                           cfg: SamplerConfig, noise, clean_norm=None,
                           x0_std_est=None, collect_diagnostics=False):
    """Base reverse pass plus ``cfg.refine_passes`` refinement passes.
    ``noise`` is one source for every pass, or a list: the base pass's, then
    one per refinement pass.  With no refinement this is ``sample_fn``.
    ``collect_diagnostics`` (``ddim_sample``) returns ``(x0, diagnostics of
    the base pass)``."""
    kw = {"collect_diagnostics": True} if collect_diagnostics else {}
    out = sample_fn(model_fn, schedule, cond_stack, cfg, _pass_noise(noise, 0),
                    clean_norm=clean_norm, x0_std_est=x0_std_est, **kw)
    x0, diag = out if collect_diagnostics else (out, None)
    if int(cfg.refine_passes) > 0:
        rest = noise[1:] if isinstance(noise, (list, tuple)) else noise
        x0 = refine_only(sample_fn, model_fn, schedule, cond_stack, cfg, x0,
                         rest, x0_std_est=x0_std_est)
    return (x0, diag) if collect_diagnostics else x0


def _median0(x: torch.Tensor) -> torch.Tensor:
    """Median over axis 0, averaging the two middle values for an even count
    (``torch.median`` would return the lower one)."""
    s = torch.sort(x, dim=0).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) * 0.5


def aggregate_seeds(per_seed: torch.Tensor, avg_mode: str = "mean",
                    y_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Aggregate S seed reconstructions (S, B, C, L) into (B, C, L).

    ``mean``; ``median`` (elementwise); ``mf``: a softmax over seeds of the
    matched-filter overlap ``rho_s = <y, x_s> / ||x_s||`` standardised by its
    cross-seed (population) std, which needs ``y_norm`` (B, L).
    """
    if avg_mode not in ("mean", "median", "mf"):
        raise ValueError(
            f"unknown avg_mode {avg_mode!r}: expected 'mean', 'median' or 'mf'")
    if avg_mode == "median":
        return _median0(per_seed)
    if avg_mode == "mf":
        if y_norm is None:
            raise ValueError("avg_mode='mf' needs y_norm (B, L)")
        xs = per_seed[:, :, 0, :]                             # (S, B, L)
        num = torch.sum(xs * y_norm[None, :, :], dim=-1)
        den = torch.sqrt(torch.sum(xs * xs, dim=-1))
        rho = num / torch.where(den > 0, den, torch.ones_like(den))
        tau = torch.std(rho, dim=0, keepdim=True, correction=0)
        z = (rho - rho.max(dim=0, keepdim=True).values) / torch.where(
            tau > 0, tau, torch.ones_like(tau))
        w = torch.softmax(z, dim=0)[:, :, None, None]
        return torch.sum(per_seed * w, dim=0)
    return per_seed.mean(dim=0)
