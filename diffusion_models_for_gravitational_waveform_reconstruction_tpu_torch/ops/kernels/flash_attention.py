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

The op's backward, registered with ``torch.library.register_autograd``, is
a second hand-written kernel, K2B (``csrc/flash_attention_backward.cu``),
behind its own op ``gwport::flash_attention_backward`` and wrapper
:func:`flash_attention_grad`, given the forward kernel's output.  The JAX
package has no such kernel (its Pallas attention is forward-only and its
trainer differentiates the plain expression); :func:`flash_attention_backward`
is the plain backward, the gradients K2B computes, which the CPU path takes
and the card checks against, and :func:`flash_attention_backward_tiled` is
K2B's algorithm written out step by step for the CPU tests.  K2B's routes
(:func:`backward_route`): ``wgmma`` for bf16 with D 64 or 128 on 16-byte
aligned rows (a TMA ring fed by a producer warpgroup, two consumer
warpgroups), ``mma_sync`` for other bf16, ``fma`` for f32.

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


# K2B's tiles, which the step-by-step version repeats: a CTA owns 128 keys
# (dK, dV) or 128 queries (dQ) and walks the other side in tiles of 64; the
# log-sum-exp pass walks the keys in tiles of 128.  The lse and delta
# scratch has a row for every query of the 128-row tiles.
BACKWARD_TILE = 128
BACKWARD_WALK = 64
LOG2E = 1.4426950408889634


def flash_attention_backward_tiled(dout, q, k, v, out):
    """K2B's algorithm, tile by tile, in plain PyTorch: the gradients of
    :func:`flash_attention_backward` as the kernel forms them.

    delta = rowsum(dO * O) in f32; the log-sum-exp of the scores in log2
    units by an online pass over key tiles of 128; per tile of 128 keys,
    over the query tiles of 64, P^T = exp2(S^T c - lse), dV += P^T dO and
    dK += dS^T Q with dS^T = P^T (dP^T - delta); per tile of 128 queries,
    over the key tiles of 64, dQ += dS K; every product in f32 on operands
    in q's dtype, P and dS rounded to bf16 where the kernel rounds them
    (the A operands of dV, dK and dQ) for bf16 inputs; dK and dQ times
    1 / sqrt(D).  Returns (dq, dk, dv) in q's dtype."""
    B, H, L, D = q.shape
    own, walk = BACKWARD_TILE, BACKWARD_WALK
    scale = 1.0 / math.sqrt(D)
    c = LOG2E * scale
    if q.dtype == torch.bfloat16:
        def rnd(a):
            return a.to(torch.bfloat16).float()
    else:
        def rnd(a):
            return a
    qf, kf, vf, dof = (a.float() for a in (q, k, v, dout))
    delta = (dof * out.float()).sum(dim=-1)
    m = torch.full((B, H, L), -math.inf, device=q.device)
    lsum = torch.zeros((B, H, L), device=q.device)
    for k0 in range(0, L, own):
        x = (qf @ kf[:, :, k0:k0 + own].transpose(-1, -2)) * c
        mn = torch.maximum(m, x.amax(dim=-1))
        lsum = lsum * torch.exp2(m - mn) + torch.exp2(x - mn[..., None]).sum(-1)
        m = mn
    lse = m + torch.log2(lsum)
    dq, dk, dv = (torch.zeros((B, H, L, D), device=q.device)
                  for _ in range(3))
    for k0 in range(0, L, own):
        kt, vt = kf[:, :, k0:k0 + own], vf[:, :, k0:k0 + own]
        for q0 in range(0, L, walk):
            qt, dot = qf[:, :, q0:q0 + walk], dof[:, :, q0:q0 + walk]
            pt = torch.exp2((kt @ qt.transpose(-1, -2)) * c
                            - lse[:, :, None, q0:q0 + walk])
            dv[:, :, k0:k0 + own] += rnd(pt) @ dot
            dst = pt * (vt @ dot.transpose(-1, -2)
                        - delta[:, :, None, q0:q0 + walk])
            dk[:, :, k0:k0 + own] += rnd(dst) @ qt
    for q0 in range(0, L, own):
        qt, dot = qf[:, :, q0:q0 + own], dof[:, :, q0:q0 + own]
        for k0 in range(0, L, walk):
            kt, vt = kf[:, :, k0:k0 + walk], vf[:, :, k0:k0 + walk]
            p = torch.exp2((qt @ kt.transpose(-1, -2)) * c
                           - lse[:, :, q0:q0 + own, None])
            ds = p * (dot @ vt.transpose(-1, -2)
                      - delta[:, :, q0:q0 + own, None])
            dq[:, :, q0:q0 + own] += rnd(ds) @ kt
    return ((dq * scale).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))


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


_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                 + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p])


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_backward")
    if lib.flash_attention_backward.argtypes is None:
        lib.flash_attention_backward.argtypes = _BWD_ARGTYPES
        lib.flash_attention_backward.restype = ctypes.c_int
        lib.flash_attention_backward_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_backward_error_string.restype = ctypes.c_char_p
    return lib


def backward_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   dout: torch.Tensor, out: torch.Tensor | None = None) -> str:
    """K2B's route: "fma" for f32; for bf16, "wgmma" when D is 64 or 128,
    q, k, v, dout (and the forward's output ``out``, when given) start on
    16-byte boundaries and dout's rows, heads and samples lie multiples of
    8 elements apart, else "mma_sync"."""
    if q.dtype == torch.float32:
        return "fma"
    given = [a for a in (q, k, v, dout, out) if a is not None]
    aligned = all(a.data_ptr() % 16 == 0 for a in given)
    strides = all(n % 8 == 0 for n in dout.stride()[:3])
    if q.shape[-1] in WGMMA_HEAD_DIMS and aligned and strides:
        return "wgmma"
    return "mma_sync"


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


def _launch_backward(dout, q, k, v, out):
    """Allocate the gradients and the scratch and launch K2B; raises if a
    launch fails.  dout may be strided; its last dimension is contiguous."""
    B, H, L, D = q.shape
    lib = _bwd_lib()
    dq, dk, dv = (torch.empty_like(a) for a in (q, k, v))
    rows = -(-L // BACKWARD_TILE) * BACKWARD_TILE
    lse, delta = (torch.empty((B * H, rows), dtype=torch.float32,
                              device=q.device) for _ in range(2))
    sb, sh, sl, _ = dout.stride()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_backward(
            dout.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), B, H, L, D, sb, sh, sl,
            ROUTES[backward_route(q, k, v, dout, out)],
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash_attention_backward launch failed: "
                           + lib.flash_attention_backward_error_string(rc)
                           .decode())
    return dq, dk, dv


@torch.library.custom_op(f"{NAMESPACE}::flash_attention_backward",
                         mutates_args=(), device_types="cuda")
def flash_attention_backward_op(
        dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
        v: torch.Tensor, out: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2B as a registered op (CUDA only): one launch, counted."""
    grads = _launch_backward(dout, q, k, v, out)
    flash_attention_grad.launches += 1
    return grads


@flash_attention_backward_op.register_fake
def _(dout, q, k, v, out):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def flash_attention_grad(dout: torch.Tensor, q: torch.Tensor,
                         k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor):
    """The gradients (dq, dk, dv) of attention given ``dout`` and the
    forward's output ``out`` (all (B, H, L, D) in q's dtype), in q's dtype.
    CPU tensors take the plain backward :func:`flash_attention_backward`;
    CUDA tensors go through ``gwport::flash_attention_backward``, which
    launches K2B.  dout may be strided (the U-Net's is transposed) as long
    as its last dimension is contiguous; otherwise it is made contiguous."""
    if q.device.type == "cpu":
        return flash_attention_backward(dout, q, k, v, out)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_grad runs on cpu or cuda, not "
                         f"{q.device}")
    _check(q, k, v)
    for name, a in (("dout", dout), ("out", out)):
        if a.shape != q.shape or a.dtype != q.dtype or a.device != q.device:
            raise ValueError(f"{name} must be {tuple(q.shape)} {q.dtype} on "
                             f"{q.device}, got {tuple(a.shape)} {a.dtype} "
                             f"on {a.device}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    return flash_attention_backward_op(dout, q, k, v, out)


flash_attention_grad.launches = 0


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
        return flash_attention_grad(dout, *ctx.saved_tensors)


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Attention of q, k, v (B, H, L, D), f32 or bf16, contiguous; returns
    (B, H, L, D) in q's dtype.  CPU tensors take the plain version; CUDA
    tensors go through the registered op, which launches the kernel on the
    route :func:`attention_route` picks (with grad enabled too: its
    backward launches K2B through :func:`flash_attention_grad`)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    _check(q, k, v)
    return flash_attention_op(q, k, v)


flash_attention.launches = 0
