"""A toy second architecture's plain forward, as ``reference/toy.py``
would hold it: ``num_blocks`` blocks of ``width`` channels (conv k=3 SAME
-> GroupNorm -> SiLU, then shifted and scaled by the timestep,
``h (1 + gamma) + beta``), and a last conv k=3 to one channel.
Channels-first (B, C, L)."""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from gwbench.reference import identity

GROUPS = 4


def time_embedding(t: torch.Tensor, dim: int, max_time: float) -> torch.Tensor:
    """t / max_time at ``dim // 2`` log-spaced frequencies, [sin || cos]."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / half))
    x = (t.to(torch.float32) / max_time)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(x), torch.cos(x)], dim=1)


def parameter_shapes(model: dict) -> Dict[str, tuple]:
    w, shapes, cin = model["width"], {}, model["in_ch"]
    for i in range(model["num_blocks"]):
        shapes.update({f"block{i}.conv.kernel": (3, cin, w),
                       f"block{i}.conv.bias": (w,),
                       f"block{i}.norm.scale": (w,),
                       f"block{i}.norm.bias": (w,),
                       f"block{i}.film.kernel": (model["time_dim"], 2 * w),
                       f"block{i}.film.bias": (2 * w,)})
        cin = w
    shapes.update({"final.kernel": (3, w, 1), "final.bias": (1,)})
    return shapes


def forward(P, x: torch.Tensor, t: torch.Tensor, model: dict,
            cast=identity) -> torch.Tensor:
    """x (B, in_ch, L) float32, t (B,) -> (B, 1, L) float32."""
    temb = cast(time_embedding(t, model["time_dim"],
                               model["t_embed_max_time"]))
    h = cast(x)
    for i in range(model["num_blocks"]):
        name = f"block{i}"
        W = cast(P[f"{name}.conv.kernel"]).permute(2, 1, 0)
        y = F.conv1d(h, W, P[f"{name}.conv.bias"], padding=1)
        y = F.group_norm(y, GROUPS, P[f"{name}.norm.scale"],
                         P[f"{name}.norm.bias"], eps=1e-5)
        h = cast(F.silu(y))
        film = cast(temb @ cast(P[f"{name}.film.kernel"])
                    + cast(P[f"{name}.film.bias"]))
        gamma, beta = film.chunk(2, dim=-1)
        h = cast(h * (1.0 + gamma[:, :, None]) + beta[:, :, None])
    W = cast(P["final.kernel"]).permute(2, 1, 0)
    b = cast(P["final.bias"])[None, :, None]
    return cast(F.conv1d(h, W, padding=1) + b)
