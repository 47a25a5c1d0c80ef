"""Forward-process math and training losses (counterpart of the JAX package's
``ops/diffusion.py``).

Tensors are shaped (B, C, L) at the API boundary.  ``schedule`` is a
:class:`ops.schedules.DiffusionSchedule`; its ``alpha_bar`` is gathered on
t's device (a trainer passes a schedule already moved there).  Every random
draw takes an explicit ``torch.Generator`` on the device of the draw.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .schedules import DiffusionSchedule


def _gather_ab(alpha_bar: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """alpha_bar[t] broadcast to (B, 1, 1)."""
    return alpha_bar.to(t.device)[t.long()].reshape(-1, 1, 1)


def q_sample(schedule: DiffusionSchedule, x0: torch.Tensor, t: torch.Tensor,
             generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-noise x0 to x_t = sqrt(abar) x0 + sqrt(1 - abar) eps; returns
    (x_t, eps) with eps drawn from ``generator``."""
    eps = torch.randn(x0.shape, generator=generator, device=x0.device,
                      dtype=x0.dtype)
    return q_sample_with_eps(schedule, x0, t, eps), eps


def q_sample_with_eps(schedule: DiffusionSchedule, x0: torch.Tensor,
                      t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Forward-noise with a given eps."""
    ab = _gather_ab(schedule.alpha_bar, t)
    return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * eps


def eps_to_x0(schedule: DiffusionSchedule, x_t: torch.Tensor,
              eps_hat: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """x0_hat = (x_t - sqrt(1 - abar) eps_hat) / sqrt(abar)."""
    ab = _gather_ab(schedule.alpha_bar, t)
    return (x_t - torch.sqrt(1.0 - ab) * eps_hat) / torch.sqrt(ab)


def x0_to_eps(schedule: DiffusionSchedule, x_t: torch.Tensor,
              x0_hat: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """eps_hat from an x0 prediction (1 - abar floored at 1e-12)."""
    ab = _gather_ab(schedule.alpha_bar, t)
    return (x_t - torch.sqrt(ab) * x0_hat) / torch.sqrt(
        torch.clamp(1.0 - ab, min=1e-12))


def v_target(schedule: DiffusionSchedule, x0: torch.Tensor, eps: torch.Tensor,
             t: torch.Tensor) -> torch.Tensor:
    """v-prediction target v = sqrt(abar) eps - sqrt(1 - abar) x0."""
    ab = _gather_ab(schedule.alpha_bar, t)
    return torch.sqrt(ab) * eps - torch.sqrt(1.0 - ab) * x0


def v_to_x0_eps(schedule: DiffusionSchedule, x_t: torch.Tensor,
                v_hat: torch.Tensor, t: torch.Tensor):
    """(x0_hat, eps_hat) from a v prediction."""
    ab = _gather_ab(schedule.alpha_bar, t)
    sa, sb = torch.sqrt(ab), torch.sqrt(1.0 - ab)
    return sa * x_t - sb * v_hat, sb * x_t + sa * v_hat


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def element_loss(eps_hat: torch.Tensor, eps: torch.Tensor, mask: torch.Tensor,
                 loss_type: str = "huber",
                 huber_beta: float = 0.5) -> torch.Tensor:
    """Masked per-element loss: 'huber' (torch smooth_l1 with ``beta``:
    0.5 d^2 / beta below beta, else |d| - beta / 2) or 'mse'."""
    d = eps_hat - eps
    if loss_type == "huber":
        ad = d.abs()
        el = torch.where(ad < huber_beta, 0.5 * d * d / huber_beta,
                         ad - 0.5 * huber_beta)
    elif loss_type == "mse":
        el = d * d
    else:
        raise ValueError(f"unknown loss type: {loss_type!r}")
    return el * mask


def masked_loss(eps_hat: torch.Tensor, eps: torch.Tensor, mask: torch.Tensor,
                t: torch.Tensor, schedule: DiffusionSchedule,
                loss_type: str = "huber", huber_beta: float = 0.5,
                loss_weight_power: float = 0.0) -> torch.Tensor:
    """Element loss, optional (1 - abar_t)^p weighting, per-sample masked
    mean, then the batch mean."""
    el = element_loss(eps_hat, eps, mask, loss_type, huber_beta)
    if loss_weight_power != 0.0:
        ab = _gather_ab(schedule.alpha_bar, t)
        el = el * torch.pow(1.0 - ab, loss_weight_power)
    denom = torch.clamp(mask.sum(dim=(1, 2)), min=1.0)
    return (el.sum(dim=(1, 2)) / denom).mean()


# ---------------------------------------------------------------------------
# Timestep sampling
# ---------------------------------------------------------------------------

def sample_timesteps_uniform(generator: torch.Generator, bsz: int, t_min: int,
                             t_max: int) -> torch.Tensor:
    """t ~ U{t_min..t_max} per item (t_max inclusive), int64 on the
    generator's device."""
    return torch.randint(int(t_min), int(t_max) + 1, (bsz,),
                         generator=generator, device=generator.device)


def sample_timesteps_stratified(generator: torch.Generator, bsz: int,
                                t_min: int, t_max: int,
                                bins: int = 0) -> torch.Tensor:
    """Stratified coverage of [t_min, t_max] within a batch: ``bins`` strata
    (default one per item) with float32 edges truncated to integers, each
    drawing its share of the batch uniformly from its sub-range; then the
    batch is shuffled.  int64 on the generator's device."""
    b = int(bins) if bins and bins > 0 else int(bsz)
    b = max(1, min(b, bsz))
    edges = np.linspace(t_min, t_max + 1, b + 1,
                        dtype=np.float32).astype(np.int64)
    q, r = divmod(bsz, b)
    counts = [q + 1 if i < r else q for i in range(b)]
    dev = generator.device
    pieces = []
    for i in range(b):
        if counts[i] <= 0:
            continue
        lo = int(edges[i])
        hi = max(int(edges[i + 1]) - 1, lo)
        u = torch.rand(counts[i], generator=generator, device=dev)
        pieces.append(lo + torch.floor(u * (hi - lo + 1)).long())
    t = torch.cat(pieces)
    return t[torch.randperm(bsz, generator=generator, device=dev)]


def repeat_for_t_multi(tree, K: int):
    """Repeat every batch item K times along axis 0 (each item's K copies
    adjacent); scalars and non-tensors pass through."""
    if K <= 1:
        return tree
    if isinstance(tree, dict):
        return {k: repeat_for_t_multi(v, K) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(repeat_for_t_multi(v, K) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dim() > 0:
        return tree.repeat_interleave(K, dim=0)
    return tree
