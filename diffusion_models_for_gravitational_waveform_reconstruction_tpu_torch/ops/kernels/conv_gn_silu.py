"""Fused ConvBlock: conv1d(k=3, SAME) + GroupNorm + SiLU on (B, L, C).

Counterpart of ``ops/pallas/fused.py`` in the JAX package.  The kernel is
hand-written CUDA for Hopper (``csrc/conv_gn_silu.cu``, which states what
bounds it and how it is laid out); this module holds its plain PyTorch
version and the wrapper.  The wrapper runs the plain version for a tensor on
the CPU and, for a tensor on a CUDA device, the registered op
``gwport::conv_gn_silu``, whose CUDA body launches the kernel; anything
else, or an input the kernel does not take, raises.  The op is what
``torch.export`` records, so an exported program launches the kernel and
advances ``launches`` when it is replayed.

The op's backward, registered with ``torch.library.register_autograd``, is
a second hand-written kernel, K1B (``csrc/conv_gn_silu_backward.cu``),
behind its own op ``gwport::conv_gn_silu_backward`` and wrapper
:func:`fused_conv_gn_silu_grad`.  The JAX package has no such kernel (its
Pallas ConvBlock is forward-only and its trainer differentiates the plain
expression); :func:`fused_conv_gn_silu_backward` is the plain backward, the
gradients K1B computes, which the CPU path takes and the card checks
against, and :func:`fused_conv_gn_silu_backward_passes` is K1B's algorithm
written out step by step for the CPU tests.

The kernel's conv pass takes one of three routes, chosen from x alone
(:func:`conv_route`, inside the op's CUDA body, since it reads the base
address): bf16 with Cin % 8 == 0 runs on ``wgmma`` fed by TMA
from weights packed once per call (:func:`pack_weights_reference` is the
pack's plain version); other bf16 inputs run on ``mma.sync``; f32 runs on
the FMA units.  All three are the same kernel and count as its launches.

At inference the U-Net hands each ConvBlock's conditioning bias and FiLM to
the kernel's last pass (the wrapper's ``film``, ``r``, ``Wc`` and ``bc``):
the same launch of K1, counted under ``conv_gn_silu``, with an epilogue,
counted besides by ``fused_conv_gn_silu.epilogue_launches``.  The plain
version with those arguments is the U-Net's composition of the three
steps.  The epilogue has no backward: the U-Net asks for it only where
autograd does not record.

The U-Net's decoder blocks take K1's decoder route (the wrapper's
``skip``): x is the half-length h (B, L/2, C_h) and the block is
``conv3([nearest_up2(h) | skip]) -> GN -> SiLU`` with the ConvBlock's own
W (3, C_h + C_s, Cout), computed without the upsampled or the concatenated
tensor (``conv3_wgmma_decoder_bf16``: bf16, C_h and C_s multiples of 64,
:func:`takes_decoder_route`).  The same op launches it, counted under
``launches`` and besides by ``fused_conv_gn_silu.decoder_launches``.  Its
plain version is the materialised composition (:func:`decoder_input`);
:func:`decoder_conv_passes` is the kernel's conv pass step by step, from
the folded weights of :func:`pack_decoder_weights_reference`.  It has no
backward either.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from ._op import NAMESPACE


def im2col3(x: torch.Tensor) -> torch.Tensor:
    """``[x_{l-1} | x_l | x_{l+1}]`` of channels-last ``x (B, L, C)``, zero
    past either end: (B, L, 3 C)."""
    xp = F.pad(x, (0, 0, 1, 1))
    return torch.cat([xp[:, :-2], xp[:, 1:-1], xp[:, 2:]], dim=-1)


def conv3_same(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """conv1d(k=3, SAME) of channels-last ``x (B, L, Cin)`` with a flax-layout
    kernel ``W (3, Cin, Cout)``, as one im2col product
    ``[x_{l-1} | x_l | x_{l+1}] @ W.reshape(3 Cin, Cout) + b`` in x's dtype."""
    return im2col3(x) @ W.reshape(3 * x.shape[-1], -1) + b


def group_norm(y: torch.Tensor, groups: int, scale: torch.Tensor,
               bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of channels-last ``y (B, L, C)`` over (L, C / groups) per
    sample, then the affine, all in f32 (flax ``GroupNorm``'s arithmetic)."""
    y = y.float()
    B, L, C = y.shape
    yg = y.reshape(B, L, groups, C // groups)
    mean = yg.mean(dim=(1, 3), keepdim=True)
    var = ((yg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    h = ((yg - mean) / torch.sqrt(var + eps)).reshape(B, L, C)
    return h * scale.float() + bias.float()


def _check_decoder_lengths(h: torch.Tensor, skip: torch.Tensor) -> None:
    if skip.dim() != 3 or h.dim() != 3 or skip.shape[0] != h.shape[0] \
            or skip.shape[1] != 2 * h.shape[1]:
        raise ValueError(f"skip must be (B, 2 L, C_s) for h (B, L, C_h), got "
                         f"{tuple(skip.shape)} and {tuple(h.shape)}")


def decoder_input(h: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """The decoder block's materialised input ``[nearest_up2(h) | skip]``
    of h (B, L/2, C_h) and skip (B, L, C_s): (B, L, C_h + C_s)."""
    _check_decoder_lengths(h, skip)
    return torch.cat([h.repeat_interleave(2, dim=1), skip], dim=-1)


def fused_conv_gn_silu_reference(x, W, b, gn_scale, gn_bias, groups: int,
                                 eps: float = 1e-5, *, film=None, r=None,
                                 Wc=None, bc=None, skip=None):
    """Plain version: x (B, L, Cin); W (3, Cin, Cout); b, gn_scale, gn_bias
    (Cout,).  The conv takes its operands in x's dtype and accumulates in f32
    (bf16 values and their products are exact in f32), then GroupNorm over
    (L, Cout / groups) per sample, the affine, SiLU, and a cast to x's dtype
    (JAX ``fused_conv_gn_silu_reference``).

    With ``film`` (B, 2 Cout) = [gamma | beta], the U-Net's steps after the
    block follow in its order and dtypes: ``h + (r @ Wc + bc)`` for the
    conditioning r (B, L, K), a Dense computed in x's dtype (none without
    r), then ``h * (1 + gamma) + beta``.

    With ``skip`` (B, 2 L, C_s), the decoder block: the same on
    :func:`decoder_input` (x, skip), W being (3, Cin + C_s, Cout)."""
    if skip is not None:
        x = decoder_input(x, skip)
    y = conv3_same(x.float(), W.to(x.dtype).float(), b.float())
    h = group_norm(y, groups, gn_scale, gn_bias, eps)
    h = (h * torch.sigmoid(h)).to(x.dtype)
    if film is None:
        return h
    dt = h.dtype
    if r is not None:
        h = h + (r.to(dt) @ Wc.to(dt) + bc.to(dt))
    gamma, beta = film.chunk(2, dim=-1)
    return h * (1.0 + gamma[:, None, :]) + beta[:, None, :]


def fused_conv_gn_silu_backward(dout, x, W, b, gn_scale, gn_bias,
                                groups: int, eps: float = 1e-5):
    """The plain backward of the ConvBlock: the gradients of
    :func:`fused_conv_gn_silu_reference` with respect to (x, W, b, gn_scale,
    gn_bias), given ``dout`` of the output's shape.

    y and the group statistics are recomputed from the inputs (y by the
    im2col product in x's dtype); then SiLU -> affine -> GroupNorm in f32,
    and the conv's two products over the im2col layout in x's dtype:
    dW = im2col(x)^T dy and dx = conv3(dy) with the taps flipped and each
    transposed.  Returns (dx in x's dtype, dW, db, dscale, dbias in f32)."""
    dt = x.dtype
    B, L, Cin = x.shape
    Cout = W.shape[2]
    Wd = W.to(dt)
    y = conv3_same(x, Wd, b.to(dt)).float()
    yg = y.reshape(B, L, groups, Cout // groups)
    mean = yg.mean(dim=(1, 3), keepdim=True)
    std = torch.sqrt(((yg - mean) ** 2).mean(dim=(1, 3), keepdim=True) + eps)
    xhat = (yg - mean) / std
    scale, shift = gn_scale.float(), gn_bias.float()
    h = xhat.reshape(B, L, Cout) * scale + shift
    s = torch.sigmoid(h)
    dh = dout.float() * (s * (1.0 + h * (1.0 - s)))
    dscale = (dh * xhat.reshape(B, L, Cout)).sum(dim=(0, 1))
    dbias = dh.sum(dim=(0, 1))
    dxhat = (dh * scale).reshape(yg.shape)
    dy = ((dxhat - dxhat.mean(dim=(1, 3), keepdim=True)
           - xhat * (dxhat * xhat).mean(dim=(1, 3), keepdim=True)) / std)
    dy = dy.reshape(B, L, Cout)
    db = dy.sum(dim=(0, 1))
    dyd = dy.to(dt)
    dW = (im2col3(x).reshape(B * L, 3 * Cin).transpose(0, 1)
          @ dyd.reshape(B * L, Cout)).reshape(3, Cin, Cout).float()
    dx = im2col3(dyd) @ Wd.flip(0).transpose(1, 2).reshape(3 * Cout, Cin)
    return dx, dW, db, dscale, dbias


# channels per K chunk of the packed weights; Cin and Cout are padded to it
PACK_CHUNK = 64
# the conv pass's routes, by the code the C interface takes
ROUTES = {"fma": 0, "mma_sync": 1, "wgmma": 2}
# longest L: the float row counts of the statistics stay exact (< 2^24) and
# the wgmma grid's L tiles within a grid dimension (L / 128 < 65536)
MAX_L = 1 << 22


def pack_shape(Cin: int, Cout: int) -> tuple:
    """Shape of the packed weights: (Cout_pad, 3, Cin_pad)."""
    return (-(-Cout // PACK_CHUNK) * PACK_CHUNK, 3,
            -(-Cin // PACK_CHUNK) * PACK_CHUNK)


def pack_weights_reference(W: torch.Tensor) -> torch.Tensor:
    """Plain version of the wgmma route's weight pack: W (3, Cin, Cout) f32
    in flax layout -> bf16 (Cout_pad, 3, Cin_pad), K-major (input channels
    contiguous) and zero-padded, so that a 64-channel K chunk never crosses
    a tap."""
    _, Cin, Cout = W.shape
    Wp = torch.zeros(pack_shape(Cin, Cout), dtype=torch.bfloat16,
                     device=W.device)
    Wp[:Cout, :, :Cin] = W.permute(2, 0, 1).to(torch.bfloat16)
    return Wp


def pack_dx_weights_reference(W: torch.Tensor) -> torch.Tensor:
    """Plain version of K1B's pack for dx on the wgmma route: the taps of
    W (3, Cin, Cout) flipped and each transposed, as K1's pack lays out
    weights: bf16 (Cin_pad, 3, Cout_pad), output channels (Cout)
    contiguous."""
    return pack_weights_reference(W.flip(0).transpose(1, 2))


# the decoder pack's parts over h's channels: the taps folded into part
# v = 2 p + u (p the output row's parity, u the step), W0 | W1 + W2 |
# W0 + W1 | W2; the skip's three taps follow
DECODER_FOLD = ((0,), (1, 2), (0, 1), (2,))


def takes_decoder_route(h: torch.Tensor, skip: torch.Tensor) -> bool:
    """Whether K1's decoder route takes h (B, L/2, C_h) and skip (B, L,
    C_s): both bf16, skip twice h's length, C_h and C_s multiples of 64."""
    return (h.dtype == skip.dtype == torch.bfloat16
            and h.dim() == skip.dim() == 3
            and skip.shape[1] == 2 * h.shape[1]
            and h.shape[-1] % PACK_CHUNK == 0
            and skip.shape[-1] % PACK_CHUNK == 0)


def pack_decoder_weights_reference(W: torch.Tensor, Ch: int,
                                   dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of the decoder route's pack: W (3, C_h + C_s, Cout)
    f32 -> (Cout_pad, 4 C_h + 3 C_s) in ``dtype``, K-major: the four folded
    taps of :data:`DECODER_FOLD` over W's first C_h rows, each sum taken in
    f32 and rounded once, then W's three taps over its last C_s rows; rows
    past Cout zero."""
    Cout = W.shape[2]
    parts = [W[list(taps), :Ch].sum(dim=0) for taps in DECODER_FOLD]
    parts += [W[t, Ch:] for t in range(3)]
    packed = torch.cat(parts).transpose(0, 1)
    Wp = torch.zeros((-(-Cout // PACK_CHUNK) * PACK_CHUNK, packed.shape[1]),
                     dtype=dtype, device=W.device)
    Wp[:Cout] = packed.to(dtype)
    return Wp


def decoder_conv_passes(h, skip, W, b, dtype=torch.bfloat16):
    """The decoder route's conv pass in plain PyTorch, as the kernel walks
    it: y (B, L, Cout) f32 = conv3([nearest_up2(h) | skip]) + b from the
    decoder pack (:func:`pack_decoder_weights_reference` in ``dtype``) and
    operands in ``dtype``.  Output row 2j + p sums, over h's two steps u,
    h's row j + p + u - 1 times the folded part 2p + u, and over the skip's
    taps t, the row j + floor(s / 2) of skip seen as (B, L/2, 2 C_s) at
    channel offset (s mod 2) C_s, s = p - 1 + t, times tap t; rows outside
    either tensor are zeros."""
    _check_decoder_lengths(h, skip)
    B, Lh, Ch = h.shape
    Cs = skip.shape[-1]
    Cout = W.shape[2]
    Wp = pack_decoder_weights_reference(W, Ch, dtype)[:Cout].float()
    hf = F.pad(h.to(dtype).float(), (0, 0, 1, 1))      # rows -1 .. Lh
    sv = F.pad(skip.to(dtype).float().reshape(B, Lh, 2 * Cs), (0, 0, 1, 1))
    y = torch.zeros((B, Lh, 2, Cout), dtype=torch.float32, device=h.device)
    for p in range(2):
        for u in range(2):
            off, k0 = p + u - 1, (2 * p + u) * Ch
            y[:, :, p] += hf[:, 1 + off:1 + off + Lh] @ Wp[:, k0:k0 + Ch].T
        for t in range(3):
            s = p - 1 + t
            rows = sv[:, 1 + (s >> 1):1 + (s >> 1) + Lh,
                      (s & 1) * Cs:(s & 1) * Cs + Cs]
            k0 = 4 * Ch + t * Cs
            y[:, :, p] += rows @ Wp[:, k0:k0 + Cs].T
    return y.reshape(B, 2 * Lh, Cout) + b.float()


# K1B's tiling, which the plain step-by-step version repeats: rows per
# partial tile (the forward's statistics tile) and per dW tile (up to that
# many rows of one sample)
BACKWARD_TILE = 64
DW_STEP = 64
# dW's K = B L is cut into dW tiles and the tiles into runs, one f32
# partial each: about 16 CTAs for each of the H100's 132 SMs counted as the
# mma.sync route's grid (chosen by timing attn16k's training blocks on an
# H100 at 4, 8, 16 and 32), at least 256 rows a run, the partials at most
# 64 MiB
DW_TARGET_CTAS = 16 * 132
DW_PART_BYTES = 64 << 20


def dw_tiles(B: int, L: int) -> int:
    """K1B's dW tiles: ``DW_STEP`` rows of one sample each, the last of a
    sample ragged."""
    return B * -(-L // DW_STEP)


def dw_run(B: int, L: int, Cin: int, Cout: int) -> int:
    """Rows per dW partial of K1B: a multiple of ``DW_STEP``, the run being
    that many rows' worth of whole dW tiles (:func:`dw_tiles`); the
    partials number :func:`dw_runs` <= 65535."""
    rows = B * L
    tiles = 3 * -(-Cin // 64) * -(-Cout // 64)
    runs = max(1, min(-(-DW_TARGET_CTAS // tiles), -(-rows // 256),
                      DW_PART_BYTES // (12 * Cin * Cout), 65535))
    return -(-dw_tiles(B, L) // runs) * DW_STEP


def dw_runs(B: int, L: int, Cin: int, Cout: int) -> int:
    """The number of K1B's dW partials."""
    return -(-dw_tiles(B, L) // (dw_run(B, L, Cin, Cout) // DW_STEP))


def _sum_rows(part: torch.Tensor) -> torch.Tensor:
    """K1B's ``k1b_sum_rows`` in its order: (nb, T, C) -> (nb, C), lane j
    of a column summing rows j, j + 8, ... in turn, then the eight lane
    sums added in lane order."""
    nb, T, C = part.shape
    lanes = part.new_zeros((nb, 8, C))
    for i in range(0, T, 8):
        chunk = part[:, i:i + 8]
        lanes[:, :chunk.shape[1]] += chunk
    total = lanes[:, 0]
    for j in range(1, 8):
        total = total + lanes[:, j]
    return total


def fused_conv_gn_silu_backward_passes(dout, x, W, b, gn_scale, gn_bias,
                                       groups: int, eps: float = 1e-5):
    """K1B's algorithm, pass by pass, in plain PyTorch: the gradients of
    :func:`fused_conv_gn_silu_backward` as the kernel forms them.

    y recomputed in f32 from operands in x's dtype (the forward kernel's
    conv); per 64-row tile and channel the sums of dh and dh x-hat, summed
    over tiles and then samples in ``k1b_sum_rows``' order (dbias, dscale);
    per (sample, group) the means of dx-hat and dx-hat x-hat from those
    sums; dy in f32, its tile sums giving db the same way, then cast to x's
    dtype; dx = conv3(dy) through the packed flipped taps
    (:func:`pack_dx_weights_reference`) in bf16, the flipped f32 taps in
    f32; dW as one f32 partial per run of whole dW tiles (:func:`dw_run`),
    summed in run order."""
    dt = x.dtype
    B, L, Cin = x.shape
    Cout = W.shape[2]
    cg = Cout // groups
    n_tiles = -(-L // BACKWARD_TILE)
    scale, shift = gn_scale.float(), gn_bias.float()
    y = conv3_same(x.float(), W.to(dt).float(), b.float())
    yg = y.reshape(B, L, groups, cg)
    mean = yg.mean(dim=(1, 3))
    rstd = torch.rsqrt(((yg - mean[:, None, :, None]) ** 2).mean(dim=(1, 3))
                       + eps)

    def per_channel(a):     # (B, groups) -> (B, 1, Cout)
        return a.repeat_interleave(cg, dim=1)[:, None]

    def tile_sums(a):       # (B, L, Cout) -> (B, n_tiles, Cout)
        a = F.pad(a, (0, 0, 0, n_tiles * BACKWARD_TILE - L))
        return a.reshape(B, n_tiles, BACKWARD_TILE, Cout).sum(dim=2)

    xh = (y - per_channel(mean)) * per_channel(rstd)
    h = xh * scale + shift
    s = torch.sigmoid(h)
    dh = dout.float() * (s * (1.0 + h * (1.0 - s)))
    s_dh, s_dhx = _sum_rows(tile_sums(dh)), _sum_rows(tile_sums(dh * xh))
    dbias, dscale = _sum_rows(s_dh[None])[0], _sum_rows(s_dhx[None])[0]
    ma = (s_dh * scale).reshape(B, groups, cg).sum(dim=-1) / (L * cg)
    mb = (s_dhx * scale).reshape(B, groups, cg).sum(dim=-1) / (L * cg)
    dy = (dh * scale - per_channel(ma) - xh * per_channel(mb)) \
        * per_channel(rstd)
    db = _sum_rows(_sum_rows(tile_sums(dy))[None])[0]
    dyd = dy.to(dt)
    if dt == torch.bfloat16:
        w_t = pack_dx_weights_reference(W)[:Cin, :, :Cout].permute(1, 2, 0)
    else:
        w_t = W.flip(0).transpose(1, 2)
    dx = (im2col3(dyd.float()) @ w_t.float().reshape(3 * Cout, Cin)).to(dt)
    # a run's tiles are consecutive rows of the flattened (B L) axis,
    # starting at its first tile's row
    per_run = dw_run(B, L, Cin, Cout) // DW_STEP
    n_lt = -(-L // DW_STEP)
    starts = [t // n_lt * L + t % n_lt * DW_STEP
              for t in range(0, dw_tiles(B, L), per_run)] + [B * L]
    cols = im2col3(x.float()).reshape(B * L, 3 * Cin)
    dyf = dyd.float().reshape(B * L, Cout)
    parts = torch.stack([cols[r0:r1].transpose(0, 1) @ dyf[r0:r1]
                         for r0, r1 in zip(starts, starts[1:])])
    dW = _sum_rows(parts.reshape(1, len(parts), -1))[0]
    return dx, dW.reshape(3, Cin, Cout), db, dscale, dbias


def conv_route(x: torch.Tensor) -> str:
    """The conv pass the kernel runs for ``x (B, L, Cin)``: "fma" for f32;
    for bf16, "wgmma" when TMA can read x (rows on 16-byte strides, i.e.
    Cin % 8 == 0, and a 16-byte aligned base), else "mma_sync"."""
    if x.dtype == torch.float32:
        return "fma"
    if x.shape[-1] % 8 == 0 and x.data_ptr() % 16 == 0:
        return "wgmma"
    return "mma_sync"


_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


_DEC_ARGTYPES = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 7
                 + [ctypes.c_float, ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_gn_silu")
    if lib.conv_gn_silu_forward.argtypes is None:
        lib.conv_gn_silu_forward.argtypes = _ARGTYPES
        lib.conv_gn_silu_forward.restype = ctypes.c_int
        lib.conv_gn_silu_decoder_forward.argtypes = _DEC_ARGTYPES
        lib.conv_gn_silu_decoder_forward.restype = ctypes.c_int
        for fn in (lib.conv_gn_silu_rows_per_tile,
                   lib.conv_gn_silu_pack_chunk):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.conv_gn_silu_error_string.argtypes = [ctypes.c_int]
        lib.conv_gn_silu_error_string.restype = ctypes.c_char_p
        if lib.conv_gn_silu_pack_chunk() != PACK_CHUNK:
            raise RuntimeError("conv_gn_silu: the library packs weights in "
                               f"chunks of {lib.conv_gn_silu_pack_chunk()}, "
                               f"the wrapper in {PACK_CHUNK}")
    return lib


_BWD_ARGTYPES = ([ctypes.c_void_p] * 23 + [ctypes.c_int] * 5
                 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("conv_gn_silu_backward")
    if lib.conv_gn_silu_backward.argtypes is None:
        lib.conv_gn_silu_backward.argtypes = _BWD_ARGTYPES
        lib.conv_gn_silu_backward.restype = ctypes.c_int
        for fn in (lib.conv_gn_silu_backward_rows_per_tile,
                   lib.conv_gn_silu_backward_rows_per_step):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.conv_gn_silu_backward_error_string.argtypes = [ctypes.c_int]
        lib.conv_gn_silu_backward_error_string.restype = ctypes.c_char_p
        if (lib.conv_gn_silu_backward_rows_per_tile() != BACKWARD_TILE
                or lib.conv_gn_silu_backward_rows_per_step() != DW_STEP):
            raise RuntimeError("conv_gn_silu_backward: the library's tiles "
                               "differ from the wrapper's")
    return lib


def dx_route(x: torch.Tensor, Cout: int) -> str:
    """K1B's conv route for dx, whose input is dy (B, L, Cout) in x's dtype
    (a fresh, aligned buffer): "fma" for f32, "wgmma" for bf16 with Cout %
    8 == 0, else "mma_sync"."""
    if x.dtype == torch.float32:
        return "fma"
    return "wgmma" if Cout % 8 == 0 else "mma_sync"


def dw_route(x: torch.Tensor, Cout: int) -> str:
    """K1B's dW pass for ``x (B, L, Cin)`` and Cout output channels (its
    dy is a fresh, aligned buffer): "wgmma" (fed by TMA) when TMA can map
    both x and dy (bf16, :func:`conv_route` "wgmma" and Cout % 8 == 0),
    "mma_sync" for other bf16, "fma" for f32."""
    if x.dtype == torch.float32:
        return "fma"
    if conv_route(x) == "wgmma" and Cout % 8 == 0:
        return "wgmma"
    return "mma_sync"


def _check_skip(x, skip):
    """The decoder route's sources: x (B, L/2, C_h) and skip (B, L, C_s),
    both bf16 and contiguous on one device, C_h and C_s multiples of 64
    (their 16-byte alignment is checked in the op's body, which alone sees
    real data pointers when ``torch.export`` traces the wrapper)."""
    if skip.dim() != 3 or skip.shape[0] != x.shape[0] \
            or skip.shape[1] != 2 * x.shape[1]:
        raise ValueError(f"skip must be ({x.shape[0]}, {2 * x.shape[1]}, "
                         f"C_s), got {tuple(skip.shape)}")
    if not takes_decoder_route(x, skip):
        raise ValueError("the decoder route takes bf16 x and skip whose "
                         "channels are multiples of 64, got "
                         f"{x.dtype} {x.shape[-1]} and {skip.dtype} "
                         f"{skip.shape[-1]}")
    if skip.device != x.device:
        raise ValueError(f"skip is on {skip.device}, x on {x.device}")
    if not skip.is_contiguous():
        raise ValueError("skip must be contiguous")


def _check(x, W, b, gn_scale, gn_bias, groups, skip=None):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, Cin), got shape {tuple(x.shape)}")
    B, L, Cin = x.shape
    if skip is not None:
        _check_skip(x, skip)
        L, Cin = skip.shape[1], Cin + skip.shape[-1]
    if W.dim() != 3 or W.shape[0] != 3 or W.shape[1] != Cin:
        raise ValueError(f"W must be (3, {Cin}, Cout), got {tuple(W.shape)}")
    Cout = W.shape[2]
    for name, v in (("b", b), ("gn_scale", gn_scale), ("gn_bias", gn_bias)):
        if tuple(v.shape) != (Cout,):
            raise ValueError(f"{name} must be ({Cout},), got {tuple(v.shape)}")
    if groups < 1 or Cout % groups:
        raise ValueError(f"Cout={Cout} not divisible by groups={groups}")
    if not 1 <= B <= 65535 or L < 1 or Cin < 1:
        raise ValueError(f"unsupported shape (B, L, Cin) = {(B, L, Cin)}")
    if L > MAX_L:
        raise ValueError(f"L={L} is longer than the kernel takes ({MAX_L})")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, v in (("x", x), ("W", W), ("b", b), ("gn_scale", gn_scale),
                    ("gn_bias", gn_bias)):
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "x" and v.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {v.dtype}")


def _check_film(x, W, film, r, Wc, bc, L=None):
    """The epilogue's inputs: ``film`` (B, 2 Cout) and ``r`` (B, L, K) in
    x's dtype (L the output's length, x's unless given), ``Wc`` (K, Cout)
    and ``bc`` (Cout,) float32, all three or none of r, Wc and bc, each
    contiguous on x's device."""
    B = x.shape[0]
    L = x.shape[1] if L is None else L
    Cout = W.shape[2]
    cond = (r, Wc, bc)
    if any(v is None for v in cond) and any(v is not None for v in cond):
        raise ValueError("r, Wc and bc go together")
    want = [("film", film, (B, 2 * Cout), x.dtype)]
    if r is not None:
        K = r.shape[-1] if r.dim() == 3 else -1
        want += [("r", r, (B, L, K), x.dtype), ("Wc", Wc, (K, Cout),
                                                torch.float32),
                 ("bc", bc, (Cout,), torch.float32)]
    for name, v, shape, dtype in want:
        if tuple(v.shape) != shape or min(shape) < 1:
            raise ValueError(f"{name} must be {shape}, got {tuple(v.shape)}")
        if v.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {v.dtype}")
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(x, W, b, gn_scale, gn_bias, groups: int, eps: float, film=None,
            r=None, Wc=None, bc=None):
    """Allocate the output and scratch and launch the kernel on the route
    :func:`conv_route` picks, with the epilogue that ``film`` and ``r`` ask
    for (none without film); raises if the launch fails."""
    B, L, Cin = x.shape
    Cout = W.shape[2]
    lib = _lib()
    rows = lib.conv_gn_silu_rows_per_tile()
    n_tiles = -(-L // rows)
    route = conv_route(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    w_packed = (torch.empty(pack_shape(Cin, Cout), dtype=torch.bfloat16,
                            device=x.device) if route == "wgmma" else None)
    out = torch.empty((B, L, Cout), dtype=x.dtype, device=x.device)
    y = torch.empty((B, L, Cout), **f32)
    part_mean = torch.empty((B, n_tiles, Cout), **f32)
    part_m2 = torch.empty((B, n_tiles, Cout), **f32)
    g_mean = torch.empty((B, groups), **f32)
    g_rstd = torch.empty((B, groups), **f32)

    def ptr(v):
        return None if v is None else v.data_ptr()

    with torch.cuda.device(x.device):
        rc = lib.conv_gn_silu_forward(
            x.data_ptr(), W.data_ptr(), b.data_ptr(), gn_scale.data_ptr(),
            gn_bias.data_ptr(), out.data_ptr(), y.data_ptr(),
            part_mean.data_ptr(), part_m2.data_ptr(), g_mean.data_ptr(),
            g_rstd.data_ptr(), ptr(w_packed), ptr(film), ptr(r), ptr(Wc),
            ptr(bc), B, L, Cin, Cout, groups,
            0 if r is None else r.shape[-1], float(eps), ROUTES[route],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("conv_gn_silu launch failed: "
                           + lib.conv_gn_silu_error_string(rc).decode())
    return out


def _launch_decoder(h, skip, W, b, gn_scale, gn_bias, groups: int,
                    eps: float, film=None, r=None, Wc=None, bc=None):
    """Allocate the output and scratch and launch K1's decoder route on h
    (B, L/2, C_h) and skip (B, L, C_s), with the epilogue that ``film``
    and ``r`` ask for; raises if the launch fails."""
    if h.data_ptr() % 16 or skip.data_ptr() % 16:
        raise ValueError("the decoder route needs h and skip 16-byte aligned")
    B, L, Cs = skip.shape
    Ch, Cout = h.shape[-1], W.shape[2]
    lib = _lib()
    n_tiles = 2 * -(-L // (2 * lib.conv_gn_silu_rows_per_tile()))
    dev = h.device
    f32 = dict(dtype=torch.float32, device=dev)
    w_packed = torch.empty((-(-Cout // PACK_CHUNK) * PACK_CHUNK,
                            4 * Ch + 3 * Cs), dtype=torch.bfloat16,
                           device=dev)
    out = torch.empty((B, L, Cout), dtype=h.dtype, device=dev)
    y = torch.empty((B, L, Cout), **f32)
    part_mean = torch.empty((B, n_tiles, Cout), **f32)
    part_m2 = torch.empty((B, n_tiles, Cout), **f32)
    g_mean = torch.empty((B, groups), **f32)
    g_rstd = torch.empty((B, groups), **f32)

    def ptr(v):
        return None if v is None else v.data_ptr()

    with torch.cuda.device(dev):
        rc = lib.conv_gn_silu_decoder_forward(
            h.data_ptr(), skip.data_ptr(), W.data_ptr(), b.data_ptr(),
            gn_scale.data_ptr(), gn_bias.data_ptr(), out.data_ptr(),
            y.data_ptr(), part_mean.data_ptr(), part_m2.data_ptr(),
            g_mean.data_ptr(), g_rstd.data_ptr(), w_packed.data_ptr(),
            ptr(film), ptr(r), ptr(Wc), ptr(bc), B, L, Ch, Cs, Cout, groups,
            0 if r is None else r.shape[-1], float(eps),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("conv_gn_silu decoder launch failed: "
                           + lib.conv_gn_silu_error_string(rc).decode())
    return out


def _launch_backward(dout, x, W, b, gn_scale, gn_bias, groups: int,
                     eps: float):
    """Allocate the gradients and the scratch and launch K1B; raises if a
    launch fails."""
    B, L, Cin = x.shape
    Cout = W.shape[2]
    lib = _bwd_lib()
    n_tiles = -(-L // BACKWARD_TILE)
    route, route_dx = conv_route(x), dx_route(x, Cout)
    run = dw_run(B, L, Cin, Cout)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    bf = dict(dtype=torch.bfloat16, device=dev)
    dx = torch.empty_like(x)
    dW = torch.empty((3, Cin, Cout), **f32)
    db, dscale, dbias = (torch.empty((Cout,), **f32) for _ in range(3))
    y = torch.empty((B, L, Cout), **f32)
    part_a, part_b = (torch.empty((B, n_tiles, Cout), **f32)
                      for _ in range(2))
    g_mean, g_rstd = (torch.empty((B, groups), **f32) for _ in range(2))
    sums = torch.empty((3, B, Cout), **f32)
    coef = torch.empty((2, B, groups), **f32)
    dy = torch.empty((B, L, Cout), dtype=x.dtype, device=dev)
    w_t = torch.empty((3, Cout, Cin), **f32)
    w_packed = (torch.empty(pack_shape(Cin, Cout), **bf)
                if route == "wgmma" else None)
    wt_packed = (torch.empty(pack_shape(Cout, Cin), **bf)
                 if route_dx == "wgmma" else None)
    dw_part = torch.empty((dw_runs(B, L, Cin, Cout), 3, Cin, Cout), **f32)
    with torch.cuda.device(dev):
        rc = lib.conv_gn_silu_backward(
            dout.data_ptr(), x.data_ptr(), W.data_ptr(), b.data_ptr(),
            gn_scale.data_ptr(), gn_bias.data_ptr(), dx.data_ptr(),
            dW.data_ptr(), db.data_ptr(), dscale.data_ptr(),
            dbias.data_ptr(), y.data_ptr(), part_a.data_ptr(),
            part_b.data_ptr(), g_mean.data_ptr(), g_rstd.data_ptr(),
            sums.data_ptr(), coef.data_ptr(), dy.data_ptr(), w_t.data_ptr(),
            None if w_packed is None else w_packed.data_ptr(),
            None if wt_packed is None else wt_packed.data_ptr(),
            dw_part.data_ptr(), B, L, Cin, Cout, groups, float(eps),
            ROUTES[route], ROUTES[route_dx], run,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("conv_gn_silu_backward launch failed: "
                           + lib.conv_gn_silu_backward_error_string(rc)
                           .decode())
    return dx, dW, db, dscale, dbias


@torch.library.custom_op(f"{NAMESPACE}::conv_gn_silu_backward",
                         mutates_args=(), device_types="cuda")
def conv_gn_silu_backward_op(
        dout: torch.Tensor, x: torch.Tensor, W: torch.Tensor,
        b: torch.Tensor, gn_scale: torch.Tensor, gn_bias: torch.Tensor,
        groups: int, eps: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """K1B as a registered op (CUDA only): one launch, counted."""
    grads = _launch_backward(dout, x, W, b, gn_scale, gn_bias, groups, eps)
    fused_conv_gn_silu_grad.launches += 1
    return grads


@conv_gn_silu_backward_op.register_fake
def _(dout, x, W, b, gn_scale, gn_bias, groups, eps):
    f32 = dict(dtype=torch.float32)
    return (torch.empty_like(x), W.new_empty(W.shape, **f32),
            *(b.new_empty(b.shape, **f32) for _ in range(3)))


def fused_conv_gn_silu_grad(dout: torch.Tensor, x: torch.Tensor,
                            W: torch.Tensor, b: torch.Tensor,
                            gn_scale: torch.Tensor, gn_bias: torch.Tensor,
                            groups: int, eps: float = 1e-5):
    """The ConvBlock's gradients (dx in x's dtype; dW, db, dscale, dbias in
    f32) given ``dout`` (B, L, Cout) in x's dtype.  CPU tensors take the
    plain backward :func:`fused_conv_gn_silu_backward`; CUDA tensors go
    through ``gwport::conv_gn_silu_backward``, which launches K1B (a
    non-contiguous dout is made contiguous first)."""
    if x.device.type == "cpu":
        return fused_conv_gn_silu_backward(dout, x, W, b, gn_scale, gn_bias,
                                           groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_gn_silu_grad runs on cpu or cuda, not "
                         f"{x.device}")
    _check(x, W, b, gn_scale, gn_bias, groups)
    want = (*x.shape[:2], W.shape[2])
    if tuple(dout.shape) != want or dout.dtype != x.dtype \
            or dout.device != x.device:
        raise ValueError(f"dout must be {want} {x.dtype} on {x.device}, got "
                         f"{tuple(dout.shape)} {dout.dtype} on {dout.device}")
    return conv_gn_silu_backward_op(dout.contiguous(), x, W, b, gn_scale,
                                    gn_bias, groups, float(eps))


fused_conv_gn_silu_grad.launches = 0


@torch.library.custom_op(f"{NAMESPACE}::conv_gn_silu", mutates_args=(),
                         device_types="cuda")
def conv_gn_silu_op(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                    gn_scale: torch.Tensor, gn_bias: torch.Tensor,
                    groups: int, eps: float,
                    film: Optional[torch.Tensor] = None,
                    r: Optional[torch.Tensor] = None,
                    Wc: Optional[torch.Tensor] = None,
                    bc: Optional[torch.Tensor] = None,
                    skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel as a registered op (CUDA only): one launch, counted, and
    counted as the epilogue's too when ``film`` is given and as the decoder
    route's when ``skip`` is."""
    if skip is None:
        out = _launch(x, W, b, gn_scale, gn_bias, groups, eps, film, r, Wc,
                      bc)
    else:
        out = _launch_decoder(x, skip, W, b, gn_scale, gn_bias, groups, eps,
                              film, r, Wc, bc)
    fused_conv_gn_silu.launches += 1
    fused_conv_gn_silu.epilogue_launches += film is not None
    fused_conv_gn_silu.decoder_launches += skip is not None
    return out


@conv_gn_silu_op.register_fake
def _(x, W, b, gn_scale, gn_bias, groups, eps, film=None, r=None, Wc=None,
      bc=None, skip=None):
    L = x.shape[1] if skip is None else skip.shape[1]
    return x.new_empty((x.shape[0], L, W.shape[2]))


def _setup_context(ctx, inputs, output):
    x, W, b, gn_scale, gn_bias, groups, eps, film = inputs[:8]
    ctx.save_for_backward(x, W, b, gn_scale, gn_bias)
    ctx.groups, ctx.eps = groups, eps
    ctx.epilogue = film is not None
    ctx.decoder = len(inputs) > 11 and inputs[11] is not None


def _backward(ctx, dout):
    if ctx.epilogue or ctx.decoder:
        raise RuntimeError("conv_gn_silu's epilogue and decoder route have "
                           "no backward")
    with torch.profiler.record_function(f"{NAMESPACE}::conv_gn_silu_backward"):
        grads = fused_conv_gn_silu_grad(dout, *ctx.saved_tensors, ctx.groups,
                                        ctx.eps)
    return (*grads, None, None, None, None, None, None, None)


conv_gn_silu_op.register_autograd(_backward, setup_context=_setup_context)


def fused_conv_gn_silu(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                       gn_scale: torch.Tensor, gn_bias: torch.Tensor,
                       groups: int, eps: float = 1e-5, *,
                       film: Optional[torch.Tensor] = None,
                       r: Optional[torch.Tensor] = None,
                       Wc: Optional[torch.Tensor] = None,
                       bc: Optional[torch.Tensor] = None,
                       skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole ConvBlock (conv k=3 SAME + GN + SiLU): x (B, L, Cin) f32 or
    bf16, W (3, Cin, Cout) in flax layout, b / gn_scale / gn_bias (Cout,) f32;
    returns (B, L, Cout) in x's dtype.  CPU tensors take the plain version;
    CUDA tensors go through the registered op, which launches the kernel
    (with grad enabled too: its backward launches K1B through
    :func:`fused_conv_gn_silu_grad`).

    With ``film`` (B, 2 Cout) = [gamma | beta] in x's dtype, and optionally
    the conditioning r (B, L, K) in x's dtype with its Dense's ``Wc`` (K,
    Cout) and ``bc`` (Cout,) f32, the kernel's last pass also adds
    ``r @ Wc + bc`` and applies ``* (1 + gamma) + beta``, as the plain
    version says, in f32, rounded once.  That epilogue has no backward: a
    caller whose autograd records takes the steps apart.

    With ``skip`` (B, 2 L, C_s), the decoder block on x = h (B, L, C_h):
    the block of :func:`decoder_input` (h, skip), W (3, C_h + C_s, Cout),
    returning (B, 2 L, Cout).  On CUDA tensors it takes K1's decoder route
    (:func:`takes_decoder_route` must hold, and x and skip be 16-byte
    aligned), with or without the epilogue (r then (B, 2 L, K)); it has no
    backward."""
    if x.device.type == "cpu":
        return fused_conv_gn_silu_reference(x, W, b, gn_scale, gn_bias,
                                            groups, eps, film=film, r=r,
                                            Wc=Wc, bc=bc, skip=skip)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_gn_silu runs on cpu or cuda, not "
                         f"{x.device}")
    _check(x, W, b, gn_scale, gn_bias, groups, skip)
    if film is None and any(v is not None for v in (r, Wc, bc)):
        raise ValueError("r, Wc and bc need film")
    if film is None and skip is None:
        return conv_gn_silu_op(x, W, b, gn_scale, gn_bias, groups,
                               float(eps))
    if film is not None:
        _check_film(x, W, film, r, Wc, bc,
                    None if skip is None else skip.shape[1])
    if torch.is_grad_enabled() and any(
            v is not None and v.requires_grad
            for v in (x, W, b, gn_scale, gn_bias, film, r, Wc, bc, skip)):
        raise RuntimeError("fused_conv_gn_silu's epilogue and decoder route "
                           "have no backward: pass film or skip where "
                           "autograd does not record")
    return conv_gn_silu_op(x, W, b, gn_scale, gn_bias, groups, float(eps),
                           film, r, Wc, bc, skip)


fused_conv_gn_silu.launches = 0
fused_conv_gn_silu.epilogue_launches = 0
fused_conv_gn_silu.decoder_launches = 0
