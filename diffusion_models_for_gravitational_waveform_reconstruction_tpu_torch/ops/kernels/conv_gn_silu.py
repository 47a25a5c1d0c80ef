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

The op's backward is :func:`fused_conv_gn_silu_backward`, plain PyTorch
registered with ``torch.library.register_autograd``: a forward that autograd
records still launches the kernel, and its gradients come from the plain
backward (the JAX package's trainer differentiates the plain expression too;
its Pallas kernel has no backward).

The kernel's conv pass takes one of three routes, chosen from x alone
(:func:`conv_route`, inside the op's CUDA body, since it reads the base
address): bf16 with Cin % 8 == 0 runs on ``wgmma`` fed by TMA
from weights packed once per call (:func:`pack_weights_reference` is the
pack's plain version); other bf16 inputs run on ``mma.sync``; f32 runs on
the FMA units.  All three are the same kernel and count as its launches.
"""
from __future__ import annotations

import ctypes

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


def fused_conv_gn_silu_reference(x, W, b, gn_scale, gn_bias, groups: int,
                                 eps: float = 1e-5):
    """Plain version: x (B, L, Cin); W (3, Cin, Cout); b, gn_scale, gn_bias
    (Cout,).  The conv takes its operands in x's dtype and accumulates in f32
    (bf16 values and their products are exact in f32), then GroupNorm over
    (L, Cout / groups) per sample, the affine, SiLU, and a cast to x's dtype
    (JAX ``fused_conv_gn_silu_reference``)."""
    y = conv3_same(x.float(), W.to(x.dtype).float(), b.float())
    h = group_norm(y, groups, gn_scale, gn_bias, eps)
    return (h * torch.sigmoid(h)).to(x.dtype)


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


def conv_route(x: torch.Tensor) -> str:
    """The conv pass the kernel runs for ``x (B, L, Cin)``: "fma" for f32;
    for bf16, "wgmma" when TMA can read x (rows on 16-byte strides, i.e.
    Cin % 8 == 0, and a 16-byte aligned base), else "mma_sync"."""
    if x.dtype == torch.float32:
        return "fma"
    if x.shape[-1] % 8 == 0 and x.data_ptr() % 16 == 0:
        return "wgmma"
    return "mma_sync"


_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_gn_silu")
    if lib.conv_gn_silu_forward.argtypes is None:
        lib.conv_gn_silu_forward.argtypes = _ARGTYPES
        lib.conv_gn_silu_forward.restype = ctypes.c_int
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


def _check(x, W, b, gn_scale, gn_bias, groups):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, Cin), got shape {tuple(x.shape)}")
    B, L, Cin = x.shape
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


def _launch(x, W, b, gn_scale, gn_bias, groups: int, eps: float):
    """Allocate the output and scratch and launch the kernel on the route
    :func:`conv_route` picks; raises if the launch fails."""
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
    with torch.cuda.device(x.device):
        rc = lib.conv_gn_silu_forward(
            x.data_ptr(), W.data_ptr(), b.data_ptr(), gn_scale.data_ptr(),
            gn_bias.data_ptr(), out.data_ptr(), y.data_ptr(),
            part_mean.data_ptr(), part_m2.data_ptr(), g_mean.data_ptr(),
            g_rstd.data_ptr(),
            None if w_packed is None else w_packed.data_ptr(),
            B, L, Cin, Cout, groups, float(eps), ROUTES[route],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("conv_gn_silu launch failed: "
                           + lib.conv_gn_silu_error_string(rc).decode())
    return out


@torch.library.custom_op(f"{NAMESPACE}::conv_gn_silu", mutates_args=(),
                         device_types="cuda")
def conv_gn_silu_op(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                    gn_scale: torch.Tensor, gn_bias: torch.Tensor,
                    groups: int, eps: float) -> torch.Tensor:
    """The kernel as a registered op (CUDA only): one launch, counted."""
    out = _launch(x, W, b, gn_scale, gn_bias, groups, eps)
    fused_conv_gn_silu.launches += 1
    return out


@conv_gn_silu_op.register_fake
def _(x, W, b, gn_scale, gn_bias, groups, eps):
    return x.new_empty((x.shape[0], x.shape[1], W.shape[2]))


def _setup_context(ctx, inputs, output):
    x, W, b, gn_scale, gn_bias, groups, eps = inputs
    ctx.save_for_backward(x, W, b, gn_scale, gn_bias)
    ctx.groups, ctx.eps = groups, eps


def _backward(ctx, dout):
    with torch.profiler.record_function(f"{NAMESPACE}::conv_gn_silu_backward"):
        grads = fused_conv_gn_silu_backward(dout, *ctx.saved_tensors,
                                            ctx.groups, ctx.eps)
    return (*grads, None, None)


conv_gn_silu_op.register_autograd(_backward, setup_context=_setup_context)


def fused_conv_gn_silu(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                       gn_scale: torch.Tensor, gn_bias: torch.Tensor,
                       groups: int, eps: float = 1e-5) -> torch.Tensor:
    """The whole ConvBlock (conv k=3 SAME + GN + SiLU): x (B, L, Cin) f32 or
    bf16, W (3, Cin, Cout) in flax layout, b / gn_scale / gn_bias (Cout,) f32;
    returns (B, L, Cout) in x's dtype.  CPU tensors take the plain version;
    CUDA tensors go through the registered op, which launches the kernel
    (with grad enabled too: its backward is
    :func:`fused_conv_gn_silu_backward`)."""
    if x.device.type == "cpu":
        return fused_conv_gn_silu_reference(x, W, b, gn_scale, gn_bias,
                                            groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_gn_silu runs on cpu or cuda, not "
                         f"{x.device}")
    _check(x, W, b, gn_scale, gn_bias, groups)
    return conv_gn_silu_op(x, W, b, gn_scale, gn_bias, groups, float(eps))


fused_conv_gn_silu.launches = 0
