"""1D U-Net denoiser with FiLM time conditioning and per-stage measurement
conditioning (counterpart of the JAX package's ``models/unet.py``).

- input channels ``[x_t | cond_0..K-1 | (optional) selfcond]`` with the
  legacy ``in_ch=3`` rule (:meth:`UNet1D._layout`);
- every ConvBlock (conv k=3 SAME -> GroupNorm(gcd(8, C)) -> SiLU), with
  the conditioning bias and FiLM after it, is one call of
  :func:`ops.kernels.fused_conv_gn_silu`: the Hopper kernel on a GPU, its
  plain version on the CPU;
- FiLM ``h*(1+gamma)+beta`` from ``Dense(silu(t_ctx))`` where
  ``t_ctx = silu(Dense(t_emb))`` (SiLU twice, as in the JAX model);
- conditioning bias: cond channels linearly resized to the stage length
  (once a forward for each length), then a 1x1 projection; downsample
  avg-pool 2, decoder nearest x2 -> pad/crop -> skip concat -> ConvBlock;
  zero-initialised final conv on ``[h | x_t]``.
- a decoder block hands the half-length h and the skip to the same call
  (``skip=``).  How each call runs (the bias and FiLM in K1's epilogue or
  as separate steps, the decoder block on K1's decoder route or on its
  materialised input) the wrapper decides from its inputs, not the model.
- with ``use_attention``, pre-norm multi-head self-attention after the
  bottleneck (:class:`BottleneckAttention`) through
  :func:`ops.kernels.flash_attention`: the Hopper kernel on a GPU at every
  bottleneck length, its plain version on the CPU.
- under a model axis (:meth:`UNet1D.tensor_parallel`, inside a
  tensor-parallel train step) each ConvBlock that JAX's rule shards runs K1
  on this rank's share of its output channels and GroupNorm groups, then
  gathers the channels; the attention runs K2 on this rank's heads and
  ``proj`` on their rows, then sums over the ranks.

Activations flow channels-last (B, L, C) in the compute ``dtype`` (bf16 for
the flagship), parameters stay float32 and the output is float32; the public
``forward`` takes and returns the (B, C, L) convention.  Parameters keep the
flax names and layouts (see ``utils/weights.py``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import (conv3_same, decoder_input, epilogue, fix_len,
                           flash_attention, flash_attention_reference,
                           fused_conv_gn_silu, fused_conv_gn_silu_reference,
                           group_norm)
from ..parallel import mesh as pmesh
from ..utils.device import resolve_device
from ..utils.spans import span


@contextlib.contextmanager
def plain_kernels():
    """Inside the block every module of this file runs through the
    kernels' plain versions, on any device (forward and backward): the
    plain path that the kernel path is held against on the card."""
    global fused_conv_gn_silu, flash_attention
    kernels = fused_conv_gn_silu, flash_attention
    fused_conv_gn_silu = fused_conv_gn_silu_reference
    flash_attention = flash_attention_reference
    try:
        yield
    finally:
        fused_conv_gn_silu, flash_attention = kernels


def _lecun_normal_(p: torch.Tensor, fan_in: int) -> None:
    """flax's ``lecun_normal``: truncated normal, variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std)


def _num_groups(out_ch: int) -> int:
    return max(1, math.gcd(8, out_ch))


class TimeEmbedding(nn.Module):
    """Sinusoidal timestep embedding: t / max_time, log-spaced frequencies
    base 10000 over ``max(half-1, 1)``, [sin || cos], zero-padded if ``dim``
    is odd.  Float32."""

    def __init__(self, dim: int, max_time: float = 999.0):
        super().__init__()
        self.dim = dim
        self.max_time = max_time

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t_scaled = t.to(torch.float32) / max(self.max_time, 1.0)
        half = self.dim // 2
        freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                          * -(math.log(10000.0) / max(half - 1, 1)))
        x = t_scaled[:, None] * freqs[None, :]
        emb = torch.cat([torch.sin(x), torch.cos(x)], dim=1)
        if self.dim % 2 == 1:
            emb = F.pad(emb, (0, 1))
        return emb


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` (in, out), ``bias`` (out,), computed in
    ``dtype`` (float32 when None)."""

    def __init__(self, cin: int, cout: int, dtype=None, device=None):
        super().__init__()
        self.dtype = dtype or torch.float32
        self.kernel = nn.Parameter(torch.empty(cin, cout, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))
        _lecun_normal_(self.kernel, cin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dot(x, self.kernel, self.bias)

    def dot(self, x: torch.Tensor, kernel: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x @ kernel + bias`` in this layer's dtype, for its own weights
        or a tensor-parallel slice of them (no bias: the caller adds it
        once, after the ranks' sum)."""
        dt = self.dtype
        y = x.to(dt) @ kernel.to(dt)
        return y if bias is None else y + bias.to(dt)


class _ConvParams(nn.Module):
    """Conv kernel (3, cin, cout) and bias, flax ``nn.Conv`` layout."""

    def __init__(self, cin: int, cout: int, device=None, zero: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(3, cin, cout, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))
        if not zero:
            _lecun_normal_(self.kernel, 3 * cin)


class _GNParams(nn.Module):
    """GroupNorm scale (ones) and bias (zeros)."""

    def __init__(self, ch: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch, device=device))
        self.bias = nn.Parameter(torch.zeros(ch, device=device))


class ConvBlock(nn.Module):
    """Conv1d(k=3, SAME) -> GroupNorm(gcd(8, C), eps 1e-5) -> SiLU on a
    contiguous (B, L, Cin) tensor, then the epilogue ``film``, ``r``,
    ``Wc`` and ``bc`` ask for; with ``skip``, the decoder block on the
    half-length h.  One call of :func:`fused_conv_gn_silu`.

    With ``tp`` set (a mesh, by :meth:`UNet1D.tensor_parallel`) model rank
    m runs the kernel on the materialised input's output channels
    [m C/n, (m+1) C/n) with G/n whole groups, the ranks gather the
    channels, and the epilogue follows as separate steps."""

    # the parameters whose gradient a model rank computes only in part
    TP_PARTIAL = ("conv.kernel", "conv.bias", "norm.scale", "norm.bias")

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.conv = _ConvParams(cin, cout, device)
        self.norm = _GNParams(cout, device)
        self.groups = _num_groups(cout)
        self.tp = None

    def tp_splits(self, name: str, n_model: int) -> bool:
        """Whether the block named ``name`` splits over ``n_model`` model
        ranks: JAX shards its conv (``parallel.mesh.tp_sharded``) and the
        GroupNorm groups do not straddle two ranks."""
        return (pmesh.tp_sharded(f"{name}.conv.kernel",
                                 self.conv.kernel.shape, n_model)
                and self.groups % n_model == 0)

    def forward(self, x: torch.Tensor, film=None, r=None, Wc=None, bc=None,
                skip=None) -> torch.Tensor:
        conv, norm, tp = self.conv, self.norm, self.tp
        if tp is None:
            return fused_conv_gn_silu(x, conv.kernel, conv.bias, norm.scale,
                                      norm.bias, self.groups, film=film, r=r,
                                      Wc=Wc, bc=bc, skip=skip)
        if skip is not None:
            x = decoder_input(x, skip)
        c = conv.kernel.shape[-1] // tp.n_model
        sl = slice(tp.model_rank * c, (tp.model_rank + 1) * c)
        y = pmesh.gather_channels(tp, fused_conv_gn_silu(
            pmesh.copy_to_model(tp, x), conv.kernel[:, :, sl].contiguous(),
            conv.bias[sl], norm.scale[sl], norm.bias[sl],
            self.groups // tp.n_model))
        return y if film is None else epilogue(y, film, r, Wc, bc)


class BottleneckAttention(nn.Module):
    """Pre-norm multi-head self-attention over the sequence axis of a
    (B, L, C) tensor, with a residual add (JAX ``BottleneckAttention``).

    ``min(num_heads, C // 32)`` heads (one below C 32), lowered until they
    divide C; GroupNorm(gcd(8, C), eps 1e-5) in f32, cast to the activation
    type; Dense ``qkv`` (C -> 3C) split as q | k | v; attention per head;
    zero-initialised Dense ``proj``.

    With ``tp`` set (a mesh, by :meth:`UNet1D.tensor_parallel`) model rank
    m takes the q, k and v columns of heads [m H/n, (m+1) H/n), runs the
    kernel on them and ``proj`` on their rows; the ranks sum the products
    and ``proj``'s bias is added once, after the sum."""

    TP_PARTIAL = ("qkv.kernel", "qkv.bias", "proj.kernel")

    def __init__(self, ch: int, num_heads: int = 4, dtype=None, device=None):
        super().__init__()
        heads = max(1, min(num_heads, ch // 32 if ch >= 32 else 1))
        while ch % heads:
            heads -= 1
        self.heads = heads
        self.groups = _num_groups(ch)
        self.norm = _GNParams(ch, device)
        self.qkv = Dense(ch, 3 * ch, dtype, device)
        self.proj = Dense(ch, ch, dtype, device)
        with torch.no_grad():
            self.proj.kernel.zero_()
        self.tp = None

    def tp_splits(self, name: str, n_model: int) -> bool:
        """Whether the attention named ``name`` splits over ``n_model``
        model ranks: JAX shards ``qkv`` and the heads divide evenly."""
        return (pmesh.tp_sharded(f"{name}.qkv.kernel", self.qkv.kernel.shape,
                                 n_model)
                and self.heads % n_model == 0)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        with span("unet/attn"):
            B, L, C = h.shape
            x = group_norm(h, self.groups, self.norm.scale,
                           self.norm.bias).to(h.dtype)
            tp = self.tp
            n, m = (1, 0) if tp is None else (tp.n_model, tp.model_rank)
            heads, c = self.heads // n, C // n

            def split_heads(a):
                return (a.reshape(B, L, heads, c // heads)
                        .transpose(1, 2).contiguous())

            if tp is None:
                qkv = self.qkv(x)
            else:
                # this rank's columns of q, of k and of v
                sl = slice(m * c, (m + 1) * c)
                w = self.qkv.kernel.view(C, 3, C)[:, :, sl].reshape(C, 3 * c)
                b = self.qkv.bias.view(3, C)[:, sl].reshape(3 * c)
                qkv = self.qkv.dot(pmesh.copy_to_model(tp, x), w, b)
            q, k, v = (split_heads(a) for a in qkv.chunk(3, dim=-1))
            out = flash_attention(q, k, v).transpose(1, 2).reshape(B, L, c)
            if tp is None:
                return h + self.proj(out)
            part = self.proj.dot(out, self.proj.kernel[m * c:(m + 1) * c])
            return h + (pmesh.reduce_from_model(tp, part)
                        + self.proj.bias.to(self.proj.dtype))


def _resize_linear(x: torch.Tensor, new_len: int) -> torch.Tensor:
    """Linear resize along axis 1 of (B, L, C) at half-pixel centres, no
    antialiasing (equal to ``F.interpolate(mode='linear',
    align_corners=False)``).  The even-factor branch covers every resize of
    a power-of-two length; with it the flagship serving batch on an H100
    ran about 3% faster end to end than with one ``F.interpolate`` call
    (``chip_smoke.py`` serving phase)."""
    B, L, C = x.shape
    if L == new_len:
        return x
    if L % new_len == 0 and (L // new_len) % 2 == 0:
        # even integer factor f: the source coordinate lies halfway between
        # elements f*i + f//2 - 1 and f*i + f//2 of each window
        f = L // new_len
        off = f // 2 - 1
        xr = x.reshape(B, new_len, f, C)
        return 0.5 * (xr[:, :, off, :] + xr[:, :, off + 1, :])
    src = ((torch.arange(new_len, dtype=torch.float32, device=x.device) + 0.5)
           * (L / new_len) - 0.5)
    src = src.clamp(0.0, L - 1)
    lo = torch.floor(src).long()
    hi = (lo + 1).clamp(max=L - 1)
    w = (src - lo.float())[None, :, None].to(x.dtype)
    return x[:, lo, :] * (1.0 - w) + x[:, hi, :] * w


class UNet1D(nn.Module):
    """The flagship denoiser.  ``in_ch`` is the total input channel count;
    ``cond_in_ch`` / ``use_selfcond`` follow the legacy rule when None.
    ``dtype`` is the activation type (None: float32); parameters are float32.
    ``device`` defaults to the GPU (see ``utils/device.py``)."""

    def __init__(self, in_ch: int = 1, base_ch: int = 64, time_dim: int = 128,
                 depth: int = 3, kernel: int = 3,
                 t_embed_max_time: float = 999.0,
                 cond_in_ch: Optional[int] = None,
                 use_selfcond: Optional[bool] = None,
                 use_attention: bool = False,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        if kernel != 3:
            raise ValueError(f"the fused ConvBlock kernel supports kernel "
                             f"size 3, got {kernel}")
        device = resolve_device(device)
        self.in_ch, self.depth, self.dtype = in_ch, depth, dtype
        self.cond_in_ch, self.use_selfcond = cond_in_ch, use_selfcond
        _, cond_ch = self._layout()
        chs = [base_ch * (2 ** i) for i in range(depth)]

        self.time_embedding = TimeEmbedding(time_dim, max_time=t_embed_max_time)
        self.time_dense = Dense(time_dim, base_ch, dtype, device)
        cin = in_ch
        for i, c in enumerate(chs):
            self.add_module(f"enc{i}", ConvBlock(cin, c, device))
            if cond_ch > 0:
                self.add_module(f"cond_enc{i}", Dense(cond_ch, c, dtype, device))
            self.add_module(f"tproj_enc{i}", Dense(base_ch, 2 * c, dtype, device))
            cin = c
        self.mid = ConvBlock(chs[-1], chs[-1], device)
        if cond_ch > 0:
            self.cond_mid = Dense(cond_ch, chs[-1], dtype, device)
        self.tproj_mid = Dense(base_ch, 2 * chs[-1], dtype, device)
        self.use_attention = use_attention
        if use_attention:
            self.mid_attn = BottleneckAttention(chs[-1], dtype=dtype,
                                                device=device)
        h_ch = chs[-1]
        for i, skip_ch in enumerate(reversed(chs)):
            self.add_module(f"dec{i}", ConvBlock(h_ch + skip_ch, skip_ch, device))
            if cond_ch > 0:
                self.add_module(f"cond_dec{i}",
                                Dense(cond_ch, skip_ch, dtype, device))
            self.add_module(f"tproj_dec{i}",
                            Dense(base_ch, 2 * skip_ch, dtype, device))
            h_ch = skip_ch
        self.final = _ConvParams(h_ch + 1, 1, device, zero=True)

    def _layout(self):
        use_sc = self.use_selfcond
        if use_sc is None:
            use_sc = self.in_ch >= 3  # legacy: 3 channels meant [x_t, y, x0_sc]
        cond_ch = self.cond_in_ch
        if cond_ch is None:
            cond_ch = max(self.in_ch - 1 - (1 if use_sc else 0), 0)
        return bool(use_sc), int(cond_ch)

    def tensor_parallel_plan(self, n_model: int):
        """``(split, whole)``: the names of the ConvBlocks and the attention
        that run split over a model axis of ``n_model`` ranks, and of those
        that run whole on every model rank (JAX's rule leaves their leaves
        whole, or their groups or heads would straddle ranks)."""
        split, whole = [], []
        for name, mod in self.named_children():
            if isinstance(mod, (ConvBlock, BottleneckAttention)):
                (split if mod.tp_splits(name, n_model) else whole).append(name)
        return split, whole

    def tensor_parallel_partial(self, n_model: int):
        """The parameters whose gradient each model rank computes only in
        part (the sum over the model axis is the whole gradient)."""
        split, _ = self.tensor_parallel_plan(n_model)
        return [f"{name}.{p}" for name in split
                for p in getattr(self, name).TP_PARTIAL]

    @contextlib.contextmanager
    def tensor_parallel(self, mesh):
        """Inside the block the split modules of
        :meth:`tensor_parallel_plan` run on this process's share of
        ``mesh``'s model axis (every model rank must call the model on the
        same inputs); outside it the model runs whole.  A mesh whose model
        axis is 1 changes nothing."""
        split, _ = self.tensor_parallel_plan(mesh.n_model)
        for name in split:
            getattr(self, name).tp = mesh
        try:
            yield self
        finally:
            for name in split:
                getattr(self, name).tp = None

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x: (B, C, L); t: (B,) integer timesteps.  Returns the
        single-channel prediction (B, 1, L), float32."""
        with span("unet/forward"):
            _, cond_ch = self._layout()
            cdt = self.dtype or torch.float32
            x = x.transpose(1, 2).to(cdt).contiguous()
            L0 = x.shape[1]

            t_emb = self.time_embedding(t).to(cdt)
            t_ctx = F.silu(self.time_dense(t_emb))
            x_t = x[:, :, :1]
            cond = x[:, :, 1:1 + cond_ch] if cond_ch > 0 else None
            resized = {}

            def cond_at(length):
                # the conditioning at a stage length, resized once a forward
                if length not in resized:
                    with span("unet/cond_bias"):
                        resized[length] = _resize_linear(cond,
                                                         length).contiguous()
                return resized[length]

            def block(h, name, skip=None):
                """ConvBlock ``name`` with its conditioning bias
                (``cond_<name>``) and FiLM (``tproj_<name>``); with
                ``skip``, a decoder block on the half-length h."""
                r = Wc = bc = None
                if cond is not None:
                    dense = getattr(self, f"cond_{name}")
                    r = cond_at(h.shape[1] if skip is None else skip.shape[1])
                    Wc, bc = dense.kernel, dense.bias
                with span("unet/film"):
                    tv = getattr(self, f"tproj_{name}")(F.silu(t_ctx))
                return getattr(self, name)(h, film=tv, r=r, Wc=Wc, bc=bc,
                                           skip=skip)

            skips = []
            h = x
            for i in range(self.depth):
                h = block(h, f"enc{i}")
                skips.append(h)
                with span("unet/resample"):
                    B, L, C = h.shape
                    h = h[:, :L // 2 * 2].reshape(B, L // 2, 2, C).mean(dim=2)

            h = block(h, "mid")
            if self.use_attention:
                h = self.mid_attn(h)

            for i in range(self.depth):
                h = block(h, f"dec{i}", skips[-(i + 1)])

            h = torch.cat([fix_len(h, L0), x_t], dim=-1)
            out = conv3_same(h, self.final.kernel.to(cdt),
                             self.final.bias.to(cdt))
            return out.to(torch.float32).transpose(1, 2)


def build_net_input(x_t: torch.Tensor, cond_stack: Optional[torch.Tensor],
                    selfcond: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, C, L) network input in the channel order ``[x_t | cond | selfcond]``."""
    parts = [x_t]
    if cond_stack is not None:
        parts.append(cond_stack)
    if selfcond is not None:
        parts.append(selfcond)
    return torch.cat(parts, dim=1)
