"""Plain deployment sampler: DDIM (eta 0) over a uniform t ladder with
classifier-free guidance, self-conditioning, input and x0 clamps and
v-prediction, on a batch tiled over seeds; the seeds averaged, the sigma
rescale and the matched-filter amplitude calibration.

The starting noise is drawn again as the program's deployment sampler
draws it: a ``torch.Generator`` on the device seeded with splitmix64 of
(seed, draw 0), one standard-normal draw of (seeds x measurements, 1, L).
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

from . import architecture, float32_exact, identity

_MASK64 = (1 << 64) - 1


def stream_seed(seed: int, draw: int) -> int:
    """splitmix64 of (seed mod 2^32) * 2^32 + (draw mod 2^32)."""
    z = ((((seed & 0xFFFFFFFF) << 32) | (draw & 0xFFFFFFFF))
         + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def cosine_alpha_bar(T: int, s: float = 0.008) -> np.ndarray:
    """alpha_bar of the cosine schedule (betas clipped to [0, 0.999], held
    in float32 as the schedule is, the product taken in float64)."""
    t = np.linspace(0.0, T, T + 1, dtype=np.float64)
    ac = np.cos(((t / T) + s) / (1 + s) * (math.pi / 2)) ** 2
    ac = ac / ac[0]
    betas = np.clip(1.0 - ac[1:] / ac[:-1], 0.0, 0.999).astype(np.float32)
    alphas = (np.float32(1.0) - betas).astype(np.float64)
    return np.cumprod(alphas).astype(np.float32)


def t_ladder(T: int, steps: int) -> np.ndarray:
    """Descending ladder from T - 1 to 0: linspace, rounded, consecutive
    duplicates collapsed, both ends kept."""
    start = T - 1
    steps = max(1, min(steps, start + 1))
    ts = np.round(np.linspace(start, 0, steps)).astype(np.int64)
    ts = ts[np.concatenate([[True], ts[1:] != ts[:-1]])]
    if ts[0] != start:
        ts = np.concatenate([[start], ts])
    if ts[-1] != 0:
        ts = np.concatenate([ts, [0]])
    return ts


@float32_exact()
def sample(P: Dict[str, torch.Tensor], model: dict, recipe: dict,
           cond: torch.Tensor, sigmas: torch.Tensor, seed: int,
           cast: Callable = identity, row_block: int = 0) -> torch.Tensor:
    """x0_white (B, L) of measurements ``cond`` (B, cond_in_ch, L) float32
    with ``sigmas`` (B,), by the recipe (``steps``, ``cfg_scale``,
    ``avg_seeds``, ``clamp``, ``x0_clip``, ``T``) from ``seed``.  The model
    (``model``'s architecture's plain forward) runs ``row_block`` rows at a
    time (0: all)."""
    dev = cond.device
    B, _, L = cond.shape
    S, w = int(recipe["avg_seeds"]), float(recipe["cfg_scale"])
    clamp, x0_clip = float(recipe["clamp"]), float(recipe["x0_clip"])
    ab_all = cosine_alpha_bar(int(recipe["T"])).astype(np.float64)
    ab_all = np.clip(ab_all, 1e-12, 1.0)
    ts = t_ladder(int(recipe["T"]), int(recipe["steps"]))
    g = torch.Generator(device=dev).manual_seed(stream_seed(seed, 0))
    x = torch.randn((S * B, 1, L), generator=g, device=dev,
                    dtype=torch.float32)
    c = cond.repeat(S, 1, 1)
    c_u = torch.cat([torch.zeros_like(c[:, :1]), c[:, 1:]], dim=1)
    sc = torch.zeros_like(x)
    n = 2 * S * B
    blk = row_block or n
    forward = architecture(model).forward

    def net(inp, t):
        return torch.cat([forward(P, inp[i:i + blk], t[i:i + blk], model,
                                  cast) for i in range(0, n, blk)])

    for i, t in enumerate(ts):
        x, sc = x.clamp(-clamp, clamp), sc.clamp(-clamp, clamp)
        ab = float(ab_all[t])
        ab_prev = float(ab_all[ts[i + 1]]) if i + 1 < len(ts) else 1.0
        inp = torch.cat([torch.cat([x, c, sc], dim=1),
                         torch.cat([x, c_u, sc], dim=1)])
        tt = torch.full((n,), int(t), dtype=torch.int64, device=dev)
        out2 = net(inp, tt)
        out = (1.0 - w) * out2[S * B:] + w * out2[:S * B]
        sa, sb = math.sqrt(ab), math.sqrt(max(1.0 - ab, 0.0))
        x0 = (sa * x - sb * out).clamp(-x0_clip, x0_clip)
        eps = sb * x + sa * out
        x = math.sqrt(ab_prev) * x0 + math.sqrt(max(1.0 - ab_prev, 0.0)) * eps
        sc = x0
    x0 = x.reshape(S, B, 1, L).mean(dim=0)[:, 0, :]
    x0w = x0 * sigmas[:, None]
    yw = cond[:, 0, :] * sigmas[:, None]
    den = (x0w * x0w).sum(dim=-1)
    s = (yw * x0w).sum(dim=-1) / den.clamp(min=1e-30)
    s = torch.where((den > 0) & torch.isfinite(s), s, torch.ones_like(s))
    return x0w * s.clamp(0.25, 4.0)[:, None]
