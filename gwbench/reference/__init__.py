"""The benchmark's plain reference: the forward of each architecture a
configuration names (``<arch>.py``: ``unet.py`` for the U-Net) and the
deployment sampler, in plain PyTorch, float32 by default.

It imports neither JAX nor anything of the program under test, and takes
nothing the program made: the weights, measurements and seeds are the
benchmark's, and every draw the program makes from them is drawn again
here.  Each function takes ``cast``, applied wherever the program keeps an
activation or a weight in its compute dtype: the identity gives the float32
reference, :func:`rounding` a lower precision (the control).  The sampler
runs under :func:`float32_exact`: TF32 off for matrix products and
convolutions, which the card would otherwise take in TF32."""
from __future__ import annotations

import contextlib
import importlib

import torch


@contextlib.contextmanager
def float32_exact():
    """Inside the block (or the function it decorates), float32 matrix
    products and cuDNN convolutions run in float32, not TF32; the switches
    are restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def arch_name(model: dict) -> str:
    """The architecture of a configuration's ``model`` block: its ``arch``,
    the U-Net where it names none."""
    return model.get("arch", "unet")


def architecture(model: dict):
    """The plain module of the ``model`` block's architecture,
    ``reference/<arch>.py``: ``parameter_shapes(model)`` (each parameter's
    name and shape) and ``forward(P, x, t, model, cast)``."""
    return importlib.import_module(f"{__name__}.{arch_name(model)}")


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _scaled(dtype, top: float):
    """Rounding to a float8 ``dtype`` with one scale for the tensor (its
    largest magnitude at the format's largest finite value ``top``), back
    in float32."""

    def fn(x: torch.Tensor) -> torch.Tensor:
        amax = x.detach().abs().amax()
        scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
        return (x / scale).to(dtype).to(torch.float32) * scale

    return fn


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


ROUNDINGS = {"float8_e4m3": _scaled(torch.float8_e4m3fn, 448.0),
             "bfloat16": _bf16}


def rounding(name: str):
    """``cast`` that rounds a float32 tensor to ``name`` ("float8_e4m3",
    "bfloat16") and back to float32."""
    return ROUNDINGS[name]
