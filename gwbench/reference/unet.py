"""Plain forward of the conditional 1D U-Net the benchmark's configurations
name, from its parameters by their flax names.

The architecture: input ``[x_t | cond (cond_in_ch) | selfcond]``; per stage a
ConvBlock (conv k=3 SAME -> GroupNorm(gcd(8, C), eps 1e-5) -> SiLU), the
conditioning channels linearly resized to the stage's length through a
Dense added as a bias, FiLM ``h (1 + gamma) + beta`` from
``Dense(silu(silu(Dense(sinusoidal(t)))))``; average-pool 2 down, nearest x2
up, pad or crop to the skip, concatenate, ConvBlock; optional pre-norm
multi-head self-attention after the bottleneck with a residual add; the
final conv k=3 over ``[h | x_t]``.  Channels-first (B, C, L) throughout.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from . import identity

Params = Dict[str, torch.Tensor]
Cast = Callable[[torch.Tensor], torch.Tensor]

# f32 elements of one block of attention scores
ATTN_BLOCK_ELEMS = 1 << 28


def time_embedding(t: torch.Tensor, dim: int, max_time: float) -> torch.Tensor:
    """t / max_time at log-spaced frequencies (base 10000 over half - 1),
    [sin || cos], zero-padded to an odd ``dim``."""
    ts = t.to(torch.float32) / max(max_time, 1.0)
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / max(half - 1, 1)))
    x = ts[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(x), torch.cos(x)], dim=1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


def _groups(c: int) -> int:
    return max(1, math.gcd(8, c))


def dense(P: Params, name: str, x: torch.Tensor, cast: Cast) -> torch.Tensor:
    """``x (..., in) @ kernel (in, out) + bias``."""
    return cast(cast(x) @ cast(P[f"{name}.kernel"]) + cast(P[f"{name}.bias"]))


def conv_block(P: Params, name: str, h: torch.Tensor,
               cast: Cast) -> torch.Tensor:
    """conv k=3 SAME (weights (3, Cin, Cout)) -> GroupNorm -> SiLU."""
    W = cast(P[f"{name}.conv.kernel"]).permute(2, 1, 0)
    y = F.conv1d(cast(h), W, P[f"{name}.conv.bias"], padding=1)
    y = F.group_norm(y, _groups(y.shape[1]), P[f"{name}.norm.scale"],
                     P[f"{name}.norm.bias"], eps=1e-5)
    return cast(F.silu(y))


def attention(P: Params, name: str, h: torch.Tensor, heads: int,
              cast: Cast) -> torch.Tensor:
    """``h + proj(softmax(q k^T / sqrt(D)) v)`` over the sequence axis,
    after a GroupNorm; the scores in blocks of at most ``ATTN_BLOCK_ELEMS``."""
    B, C, L = h.shape
    x = cast(F.group_norm(h, _groups(C), P[f"{name}.norm.scale"],
                          P[f"{name}.norm.bias"], eps=1e-5))
    qkv = dense(P, f"{name}.qkv", x.transpose(1, 2), cast)     # (B, L, 3C)
    D = C // heads
    q, k, v = (a.reshape(B, L, heads, D).transpose(1, 2).reshape(
        B * heads, L, D) for a in qkv.chunk(3, dim=-1))
    out = torch.empty_like(q)
    step = max(1, ATTN_BLOCK_ELEMS // (L * L))
    for i in range(0, B * heads, step):
        s = (q[i:i + step] @ k[i:i + step].transpose(1, 2)) / math.sqrt(D)
        p = cast(torch.softmax(s, dim=-1))
        out[i:i + step] = cast(p @ v[i:i + step])
    out = out.reshape(B, heads, L, D).transpose(1, 2).reshape(B, L, C)
    return cast(h + dense(P, f"{name}.proj", out, cast).transpose(1, 2))


def attention_heads(C: int, num_heads: int = 4) -> int:
    heads = max(1, min(num_heads, C // 32 if C >= 32 else 1))
    while C % heads:
        heads -= 1
    return heads


def _fix_len(h: torch.Tensor, n: int) -> torch.Tensor:
    L = h.shape[-1]
    if L < n:
        return F.pad(h, (0, n - L))
    return h[..., :n]


def forward(P: Params, x: torch.Tensor, t: torch.Tensor, model: dict,
            cast: Cast = identity) -> torch.Tensor:
    """x (B, in_ch, L) float32, t (B,) integer timesteps -> (B, 1, L)
    float32.  ``model``: the configuration's ``model`` block."""
    depth, cond_ch = model["depth"], model["cond_in_ch"]
    h = cast(x)
    L0 = h.shape[-1]
    x_t, cond = h[:, :1], h[:, 1:1 + cond_ch]
    temb = cast(time_embedding(t, model["time_dim"],
                               model["t_embed_max_time"]))
    t_ctx = cast(F.silu(dense(P, "time_dense", temb, cast)))
    t_act = cast(F.silu(t_ctx))

    def film(h, name):
        gamma, beta = dense(P, name, t_act, cast).chunk(2, dim=-1)
        return cast(h * (1.0 + gamma[:, :, None]) + beta[:, :, None])

    def cond_bias(h, name):
        c = F.interpolate(cond, size=h.shape[-1], mode="linear",
                          align_corners=False)
        return cast(h + dense(P, name, cast(c).transpose(1, 2),
                              cast).transpose(1, 2))

    skips = []
    for i in range(depth):
        h = conv_block(P, f"enc{i}", h, cast)
        h = film(cond_bias(h, f"cond_enc{i}"), f"tproj_enc{i}")
        skips.append(h)
        B, C, L = h.shape
        h = cast(h[:, :, :L // 2 * 2].reshape(B, C, L // 2, 2).mean(dim=-1))
    h = conv_block(P, "mid", h, cast)
    h = film(cond_bias(h, "cond_mid"), "tproj_mid")
    if model["use_attention"]:
        h = attention(P, "mid_attn", h, attention_heads(h.shape[1]), cast)
    for i in range(depth):
        skip = skips[-(i + 1)]
        h = _fix_len(h.repeat_interleave(2, dim=-1), skip.shape[-1])
        h = conv_block(P, f"dec{i}", torch.cat([h, skip], dim=1), cast)
        h = film(cond_bias(h, f"cond_dec{i}"), f"tproj_dec{i}")
    h = cast(torch.cat([_fix_len(h, L0), x_t], dim=1))
    W = cast(P["final.kernel"]).permute(2, 1, 0)
    b = cast(P["final.bias"])[None, :, None]
    return cast(F.conv1d(h, W, padding=1) + b)


def parameter_shapes(model: dict) -> Dict[str, tuple]:
    """Every parameter's flax name and shape, for the ``model`` block."""
    d, base, cond_ch = model["depth"], model["base_ch"], model["cond_in_ch"]
    chs = [base * (2 ** i) for i in range(d)]
    shapes: Dict[str, tuple] = {
        "time_dense.kernel": (model["time_dim"], base),
        "time_dense.bias": (base,)}

    def block(name, cin, c):
        shapes.update({f"{name}.conv.kernel": (3, cin, c),
                       f"{name}.conv.bias": (c,),
                       f"{name}.norm.scale": (c,), f"{name}.norm.bias": (c,)})

    def side(name, c):
        shapes.update({f"cond_{name}.kernel": (cond_ch, c),
                       f"cond_{name}.bias": (c,),
                       f"tproj_{name}.kernel": (base, 2 * c),
                       f"tproj_{name}.bias": (2 * c,)})

    cin = model["in_ch"]
    for i, c in enumerate(chs):
        block(f"enc{i}", cin, c)
        side(f"enc{i}", c)
        cin = c
    block("mid", chs[-1], chs[-1])
    side("mid", chs[-1])
    if model["use_attention"]:
        C = chs[-1]
        shapes.update({"mid_attn.norm.scale": (C,), "mid_attn.norm.bias": (C,),
                       "mid_attn.qkv.kernel": (C, 3 * C),
                       "mid_attn.qkv.bias": (3 * C,),
                       "mid_attn.proj.kernel": (C, C),
                       "mid_attn.proj.bias": (C,)})
    c_h = chs[-1]
    for i, c_s in enumerate(reversed(chs)):
        block(f"dec{i}", c_h + c_s, c_s)
        side(f"dec{i}", c_s)
        c_h = c_s
    shapes.update({"final.kernel": (3, chs[0] + 1, 1), "final.bias": (1,)})
    return shapes
