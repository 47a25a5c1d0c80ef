"""Flash attention: non-causal ``softmax(Q K^T / sqrt(D)) V`` on (B, H, L, D).

Counterpart of ``ops/pallas/attention.py`` in the JAX package.  The kernel is
hand-written CUDA for Hopper (``csrc/flash_attention.cu``, which states what
bounds it and how it is laid out); this module holds its plain PyTorch
version and the wrapper.  The wrapper runs the plain version for a tensor on
the CPU and, for a tensor on a CUDA device, the registered op
``gwport::flash_attention``, whose CUDA body launches the kernel (so an
exported program launches it too, and counts it); anything else, or an
input the kernel does not take, raises.  Any L >= 1 is taken: the kernel
masks its own ragged edge.

The op's backward is :func:`flash_attention_backward`, plain PyTorch
registered with ``torch.library.register_autograd``: a forward that autograd
records still launches the kernel, and its gradients come from the plain
backward, given the kernel's output.

The kernel takes one of three routes, chosen from the inputs alone
(:func:`attention_route`, inside the op's CUDA body): bf16 with D 64 or
128 and q, k, v on 16-byte aligned bases runs both products on ``wgmma``
fed by TMA; other bf16 inputs run on ``mma.sync``; f32 runs on the FMA
units.  All three are the same kernel and count as its launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ._op import NAMESPACE

MAX_HEAD_DIM = 256   # MAX_D of csrc/flash_attention.cu: its widest template
# the kernel's routes, by the code the C interface takes
ROUTES = {"fma": 0, "mma_sync": 1, "wgmma": 2}
WGMMA_HEAD_DIMS = (64, 128)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Plain version (JAX ``flash_attention_reference``): scores in f32,
    softmax over keys in f32, the probabilities cast to v's dtype, then
    ``p @ v`` in v's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return p @ v


# elements of one f32 (B, H, rows, L) block of the backward's scores: about
# 1 GiB, so the backward's transients stay a few GiB at any L
BACKWARD_BLOCK_ELEMS = 1 << 28


def flash_attention_backward(dout, q, k, v, out):
    """The plain backward of attention: the gradients (dq, dk, dv) of
    :func:`flash_attention_reference` given ``dout`` and the forward's
    output ``out`` (all (B, H, L, D)).

    Over blocks of query rows (each f32 block of scores at most
    ``BACKWARD_BLOCK_ELEMS``): the scores recomputed in f32 and their
    softmax P; dV += P^T dO with P in v's dtype; dP = dO V^T in v's dtype;
    dS = P * (dP - rowsum(dO * O)) in f32; dQ = dS K / sqrt(D) and
    dK += dS^T Q / sqrt(D) in f32.  Returns the three in q's dtype."""
    B, H, L, D = q.shape
    scale = 1.0 / math.sqrt(D)
    qf, kf = q.float(), k.float()
    delta = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    rows = max(1, BACKWARD_BLOCK_ELEMS // (B * H * L))
    for r0 in range(0, L, rows):
        r = slice(r0, min(L, r0 + rows))
        p = torch.softmax((qf[:, :, r] @ kf.transpose(-1, -2)) * scale, dim=-1)
        do = dout[:, :, r]
        dv += (p.to(v.dtype).transpose(-1, -2) @ do).float()
        dp = (do @ v.transpose(-1, -2)).float()
        ds = p * (dp - delta[:, :, r])
        dq[:, :, r] = (ds @ kf) * scale
        dk += (ds.transpose(-1, -2) @ qf[:, :, r]) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_route(q: torch.Tensor, k: torch.Tensor | None = None,
                    v: torch.Tensor | None = None) -> str:
    """The route the kernel runs for ``q, k, v (B, H, L, D)`` (k and v
    default to q): "fma" for f32; for bf16, "wgmma" when D is 64 or 128 and
    TMA can read every input (16-byte aligned bases), else "mma_sync"."""
    if q.dtype == torch.float32:
        return "fma"
    bases = [a.data_ptr() for a in (q, k, v) if a is not None]
    if q.shape[-1] in WGMMA_HEAD_DIMS and all(p % 16 == 0 for p in bases):
        return "wgmma"
    return "mma_sync"


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attention_forward.argtypes is None:
        lib.flash_attention_forward.argtypes = _ARGTYPES
        lib.flash_attention_forward.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v):
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, L, D), got shape {tuple(q.shape)}")
    for name, a in (("k", k), ("v", v)):
        if a.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, q "
                             f"{tuple(q.shape)}")
    B, H, L, D = q.shape
    if not 1 <= B * H <= 65535 or L < 1 or D < 1:
        raise ValueError(f"unsupported shape (B, H, L, D) = {(B, H, L, D)}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dimension {D} > {MAX_HEAD_DIM}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.dtype != q.dtype:
            raise TypeError(f"{name} is {a.dtype}, q {q.dtype}")
        if a.device != q.device:
            raise ValueError(f"{name} is on {a.device}, q on {q.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(q, k, v):
    """Allocate the output and launch the kernel on the route
    :func:`attention_route` picks; raises if the launch fails."""
    B, H, L, D = q.shape
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H,
            L, D, ROUTES[attention_route(q, k, v)],
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    return out


@torch.library.custom_op(f"{NAMESPACE}::flash_attention", mutates_args=(),
                         device_types="cuda")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """The kernel as a registered op (CUDA only): one launch, counted."""
    out = _launch(q, k, v)
    flash_attention.launches += 1
    return out


@flash_attention_op.register_fake
def _(q, k, v):
    return torch.empty_like(q)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs, output)


def _backward(ctx, dout):
    with torch.profiler.record_function(
            f"{NAMESPACE}::flash_attention_backward"):
        return flash_attention_backward(dout, *ctx.saved_tensors)


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Attention of q, k, v (B, H, L, D), f32 or bf16, contiguous; returns
    (B, H, L, D) in q's dtype.  CPU tensors take the plain version; CUDA
    tensors go through the registered op, which launches the kernel on the
    route :func:`attention_route` picks (with grad enabled too: its
    backward is :func:`flash_attention_backward`)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    _check(q, k, v)
    return flash_attention_op(q, k, v)


flash_attention.launches = 0
