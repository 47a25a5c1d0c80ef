"""PSD floors and whitening weights as tensor ops (counterpart of
``psd_floor`` / ``whiten_weight`` in the JAX package's ``ops/whiten.py``).

They act on the LAST axis and broadcast over leading axes; the float64 host
versions are in ``data/pipeline.py``.
"""
from __future__ import annotations

import torch


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
