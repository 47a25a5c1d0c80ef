"""The U-Net's head: conv1d(k=3, SAME) of ``[fix_len(h, L0) | x_t]`` to one
output channel, the model's (B, 1, L0) f32 prediction.

The kernel is hand-written CUDA for Hopper (``csrc/unet_head.cu``, which
states what bounds it and how it is laid out): it reads the last decoder
output h (B, L_h, C) once and x_t in place, as channel 0 of the network
input x (B, L0, C_in), so that neither the concatenation nor the im2col
copies of a plain composition are written.  It replaces no Pallas kernel
(the JAX package leaves its head to XLA).  This module holds its plain
version and the wrapper :func:`unet_head`, which picks how the head runs:

- where autograd records the call (training, the distillation student),
  :func:`unet_head_composition`, the U-Net's composition in the compute
  dtype, which carries the gradients (the kernel has no backward);
- otherwise a CPU tensor runs the plain version
  (:func:`unet_head_reference`) and a CUDA tensor the registered op
  ``gwport::unet_head``, whose CUDA body launches the kernel and advances
  ``unet_head.launches``; anything else raises.

:func:`unet_head_plain` is that choice without the kernel, which
``models/unet.py::plain_kernels`` swaps in.  Both the kernel and the plain
version round W to the compute dtype, as the model does, accumulate in
f32, add the f32 bias and round once to the compute dtype.  The
composition rounds its product and its bias add in the compute dtype; it
stays for recorded calls because the plain version's f32 copies raise a
recorded bf16 step's peak memory (by 13-18% at the port's training
shapes on an H100).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._op import NAMESPACE
from .conv_gn_silu import _ptr, _records, conv3_same, fix_len


def unet_head_composition(h, x, W, b) -> torch.Tensor:
    """The head as plain steps in the compute dtype (h's): ``conv3_same``
    of the materialised ``[fix_len(h, L0) | x_t]`` with W and b cast to
    it, then widened to f32; (B, 1, L0).  Autograd runs through it."""
    dt = h.dtype
    hx = torch.cat([fix_len(h, x.shape[1]), x[:, :, :1]], dim=-1)
    out = conv3_same(hx, W.to(dt), b.to(dt))
    return out.to(torch.float32).transpose(1, 2)


def unet_head_reference(h, x, W, b) -> torch.Tensor:
    """Plain version: h (B, L_h, C) and x (B, L0, C_in) in the compute
    dtype, W (3, C + 1, 1) and b (1,) f32.  The conv (``conv3_same``) of
    ``[fix_len(h, L0) | x_t]`` widened to f32, with W rounded to the
    compute dtype: the products summed in f32 with the f32 bias, rounded
    once to the compute dtype, then widened; (B, 1, L0) f32: the kernel's
    arithmetic, and on f32 inputs :func:`unet_head_composition`'s bit for
    bit."""
    dt = h.dtype
    hx = torch.cat([fix_len(h, x.shape[1]).float(), x[:, :, :1].float()],
                   dim=-1)
    y = conv3_same(hx, W.to(dt).float(), b.float())
    return y.to(dt).to(torch.float32).transpose(1, 2)


def unet_head_plain(h, x, W, b) -> torch.Tensor:
    """The head without its kernel, as :func:`unet_head` picks it off the
    card: :func:`unet_head_composition` where autograd records the call,
    else :func:`unet_head_reference`."""
    if _records(h, x, W, b):
        return unet_head_composition(h, x, W, b)
    return unet_head_reference(h, x, W, b)


def head_route(h: torch.Tensor) -> str:
    """How the kernel reads h (B, L_h, C): "vector" (16-byte loads) when C
    fills whole 16-byte vectors and h is 16-byte aligned, else "scalar"."""
    if h.shape[-1] % (16 // h.element_size()) == 0 and h.data_ptr() % 16 == 0:
        return "vector"
    return "scalar"


def _lib() -> ctypes.CDLL:
    lib = _build.load("unet_head")
    if lib.unet_head_forward.argtypes is None:
        lib.unet_head_forward.argtypes = ([ctypes.c_void_p] * 5
                                          + [ctypes.c_int] * 7
                                          + [ctypes.c_void_p])
        lib.unet_head_forward.restype = ctypes.c_int
        lib.unet_head_max_channels.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.unet_head_max_channels.restype = ctypes.c_int
        lib.unet_head_error_string.argtypes = [ctypes.c_int]
        lib.unet_head_error_string.restype = ctypes.c_char_p
    return lib


def _check(h, x, W, b) -> None:
    """What the kernel takes: h (B, L_h, C) and x (B, L0, C_in) contiguous
    in one dtype, f32 or bf16; W (3, C + 1, 1) and b (1,) f32 contiguous;
    all on h's device."""
    if h.dim() != 3 or x.dim() != 3 or x.shape[0] != h.shape[0]:
        raise ValueError(f"h must be (B, L_h, C) and x (B, L0, C_in), got "
                         f"{tuple(h.shape)} and {tuple(x.shape)}")
    B, Lh, C = h.shape
    if not 1 <= B <= 65535 or min(Lh, C, x.shape[1], x.shape[2]) < 1:
        raise ValueError(f"unsupported shapes {tuple(h.shape)} and "
                         f"{tuple(x.shape)}")
    if tuple(W.shape) != (3, C + 1, 1) or tuple(b.shape) != (1,):
        raise ValueError(f"W must be (3, {C + 1}, 1) and b (1,), got "
                         f"{tuple(W.shape)} and {tuple(b.shape)}")
    if h.dtype not in (torch.float32, torch.bfloat16) or x.dtype != h.dtype:
        raise TypeError(f"h and x must be both float32 or both bfloat16, "
                        f"got {h.dtype} and {x.dtype}")
    for name, v in (("h", h), ("x", x), ("W", W), ("b", b)):
        if v.device != h.device:
            raise ValueError(f"{name} is on {v.device}, h on {h.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("W", "b") and v.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {v.dtype}")


def _launch(h, x, W, b) -> torch.Tensor:
    """Allocate the output and launch the kernel on the route
    :func:`head_route` picks; raises if the launch fails."""
    B, Lh, C = h.shape
    L0, Cin = x.shape[1], x.shape[2]
    lib = _lib()
    bf16, vec = int(h.dtype == torch.bfloat16), int(head_route(h) == "vector")
    if C > lib.unet_head_max_channels(bf16, vec):
        raise ValueError(f"C={C} is wider than the head kernel takes "
                         f"({lib.unet_head_max_channels(bf16, vec)})")
    out = torch.empty((B, 1, L0), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        rc = lib.unet_head_forward(
            *map(_ptr, (h, x, W, b, out)), B, Lh, C, L0, Cin, bf16, vec,
            torch.cuda.current_stream(h.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("unet_head launch failed: "
                           + lib.unet_head_error_string(rc).decode())
    return out


@torch.library.custom_op(f"{NAMESPACE}::unet_head", mutates_args=(),
                         device_types="cuda")
def unet_head_op(h: torch.Tensor, x: torch.Tensor, W: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """The kernel as a registered op (CUDA only): one launch, counted."""
    out = _launch(h, x, W, b)
    unet_head.launches += 1
    return out


@unet_head_op.register_fake
def _(h, x, W, b):
    return h.new_empty((h.shape[0], 1, x.shape[1]), dtype=torch.float32)


def unet_head(h: torch.Tensor, x: torch.Tensor, W: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """The U-Net's head: h (B, L_h, C) the last decoder output and x (B, L0,
    C_in) the network input, channels-last in the compute dtype (f32 or
    bf16), x_t its channel 0; W (3, C + 1, 1) and b (1,) the head's f32
    parameters.  Returns the prediction (B, 1, L0) f32.

    Off the card, or where autograd records the call,
    :func:`unet_head_plain`; otherwise the kernel (h, x, W and b
    contiguous)."""
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unet_head runs on cpu or cuda, not {h.device}")
    if h.device.type == "cpu" or _records(h, x, W, b):
        return unet_head_plain(h, x, W, b)
    _check(h, x, W, b)
    return unet_head_op(h, x, W, b)


unet_head.launches = 0
