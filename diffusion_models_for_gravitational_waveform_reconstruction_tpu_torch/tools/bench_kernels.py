"""Kernel micro-benchmarks on the card: each hand-written kernel of the port
against its plain PyTorch version; the port's twin of the root
``tools/bench_kernels.py``.

    python -m diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools.bench_kernels \
        [conv|conv_bf16|decoder|attn|unet|hbm] [--device cpu]

Sections, at the root tool's shapes:

- ``conv`` / ``conv_bf16``: K1, the fused ConvBlock (``ops/kernels``
  ``fused_conv_gn_silu``), f32 and bf16, at (B, L, Cin, Cout) = (64, 4096,
  64, 64), (64, 2048, 64, 128), (64, 1024, 128, 256), (64, 1024, 512, 256);
- ``decoder``: K1's decoder route (``fused_conv_gn_silu(h, ..., skip=)``,
  upsample and concat folded into the conv pass) at the decoder stages of
  the benchmark's cells (pn128 at 128 rows, attn16k at 64, bf16) beside
  the materialised upsample -> concat -> K1, the concatenation alone, the
  plain fold (``decoder_f32``, the route's arithmetic) and the plain
  version; then the attention U-Net of ``unet`` forward with its decoder
  on the route and materialised;
- ``attn``: K2, flash attention, at (B, H, L, D) = (8, 4, 2048, 64), (4, 4,
  4096, 64), (2, 4, 8192, 64) in f32 (the FMA route) and bf16 (``wgmma``);
- ``unet``: the attention U-Net (base_ch 64, depth 3, bf16) at B 64, L 4096
  through the kernels against the same module through the plain versions
  (``models/unet.py::plain_kernels``), timed in bf16, its error in bf16 and
  f32; its bottleneck runs K2 at (64, 4, 512, 64);
- ``hbm``: 64 dependent saxpy passes over a 256 MB float32 buffer, plain
  PyTorch: the device-memory rate the card delivers against its peak.

Each kernel row gives the kernel's, the plain version's and, where one
PyTorch call computes the same function, that call's time (``F.conv1d`` ->
``F.group_norm`` -> ``F.silu``; ``F.scaled_dot_product_attention``: a
yardstick only, never a path of the port), each the mean of ``reps`` calls
between CUDA events after a warm-up; the bound from ``utils/roofline.py``
(each input read once, each output written once, against the card's
peaks); the largest difference from the plain version and whether every
output is within the port's bars (``TOL``, the table ``chip_smoke.py``
holds the kernels to; bf16 attention also against the exact attention
within the rounding of P, ``attention_within_bound``).  ``conv_row`` and
``attention_row`` build a row from given inputs; ``chip_smoke.py``'s
kernel phases call them too.
The root tool's ``xla_ms`` / ``pallas_ms`` are ``plain_ms`` /
``kernel_ms`` here.  One JSON line per row; on the CPU the wrappers run
their plain versions, so the rows there check the plumbing, not a kernel.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time

import torch
import torch.nn.functional as F

from ..models import unet
from ..ops.kernels import (attention_route, conv3_same, conv_route,
                           decoder_conv_passes, decoder_input,
                           flash_attention, flash_attention_backward,
                           flash_attention_grad, flash_attention_reference,
                           fused_conv_gn_silu, fused_conv_gn_silu_backward,
                           fused_conv_gn_silu_grad,
                           fused_conv_gn_silu_reference, group_norm)
from ..ops.kernels import conv_gn_silu
from ..ops.kernels.conv_gn_silu import dw_route, dx_route
from ..ops.kernels.flash_attention import backward_route
from ..utils.device import resolve_device
from ..utils.roofline import bound_ms, peak_for

CONV_SHAPES = [(64, 4096, 64, 64), (64, 2048, 64, 128),
               (64, 1024, 128, 256), (64, 1024, 512, 256)]
# (rows, L_skip, C_h, C_s, Cout) of the decoder stages of the benchmark's
# cells: pn128 at 128 rows a forward, attn16k at 64
DECODER_STAGES = [(128, 1024, 512, 512, 512), (128, 2048, 512, 256, 256),
                  (128, 4096, 256, 128, 128), (64, 8192, 256, 256, 256),
                  (64, 16384, 256, 128, 128), (64, 32768, 128, 64, 64)]
ATTN_SHAPES = [(8, 4, 2048, 64), (4, 4, 4096, 64), (2, 4, 8192, 64)]
UNET_B, UNET_L = 64, 4096
UNET_MODEL = dict(in_ch=7, base_ch=64, time_dim=128, depth=3, cond_in_ch=5,
                  use_selfcond=True, use_attention=True)
HBM_N, HBM_ITERS = 64 * 1024 * 1024, 64
# the port's one table of kernel bars, kernel against plain version,
# (rtol, atol): f32 differs in summation order (K2 also in exp2 of
# log2-scaled scores); K1 in bf16 may flip an output by one bf16 ulp
# (2^-7 relative); K2 in bf16 rounds P (the kernel before normalising, the
# plain version after) and the output, a few ulps of 2^-8 apart
TOL = {("conv_gn_silu", "float32"): (1e-4, 2e-5),
       ("conv_gn_silu", "bfloat16"): (2 ** -7, 1e-3),
       ("flash_attention", "float32"): (1e-4, 1e-5),
       ("flash_attention", "bfloat16"): (2 ** -6, 2e-3)}
# K1B and K2B (the backward kernels), gradient by gradient, against the
# plain backward in f32 on the values the kernel's products take (the
# exact gradient of the plain forward, whose conv rounds W to x's dtype as
# the kernel does), (rtol, atol): |got - want| <= rtol |want| + atol max
# |want|, the gradient's own largest element.  f32: the JAX package's kernel
# bar; bf16: within 2^-6 of the gradient's largest element (the kernel
# rounds dy, P and dS to bf16 for its products)
GRAD_TOL = {"float32": (2e-4, 2e-5), "bfloat16": (0.0, 2 ** -6)}
# K1's decoder route against the materialised upsample -> concat -> K1,
# (rtol, atol): the route rounds each folded pair of taps (W1 + W2, W0 +
# W1) to bf16 once where the materialised path rounds each tap, so the
# conv before the norm differs by about 2^-9 of its size on the h half:
# within four bf16 ulps (2^-5) of the output, and 2^-6 near zero.  Against
# its own arithmetic in plain PyTorch the route is held to ``TOL``.
DECODER_MAT_TOL = (2 ** -5, 2 ** -6)
REPS = 20


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, reps: int = REPS) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls after a warm-up: CUDA events
    on the GPU, the host clock on the CPU."""
    fn()
    _sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def _kind(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def _bound(flops, nbytes, device, dtype) -> dict:
    b = bound_ms(flops, nbytes, _kind(device), dtype)
    return ({"bound_ms": b[0], "bound_by": b[1]} if b else
            {"bound_ms": None, "bound_by": None})


def _against(got, want, kernel) -> dict:
    """The largest difference of ``got`` from ``want`` and the count of
    outputs outside ``kernel``'s bars in ``TOL``."""
    dname = str(got.dtype).split(".")[1]
    rtol, atol = TOL[(kernel, dname)]
    diff = (got.float() - want.float()).abs()
    bad = int((diff > atol + rtol * want.float().abs()).sum())
    return {"max_abs_err": float(diff.max()), "rtol": rtol, "atol": atol,
            "n_outside_tol": bad}


def epilogue_f32(x, W, b, s, bb, G: int, film, r=None, Wc=None, bc=None):
    """K1's conditioning epilogue on the plain ConvBlock's f32 value before
    its cast, all in f32 (what the kernel rounds once), and the size of its
    terms (the scale of the plain composition's roundings: of h, of Wc and
    the Dense's output, of each sum and of the product)."""
    y = conv3_same(x.float(), W.to(x.dtype).float(), b)
    h = group_norm(y, G, s, bb)
    h = h * torch.sigmoid(h)
    p, terms = torch.zeros_like(h), h.abs()
    if r is not None:
        p = r.float() @ Wc + bc
        terms = terms + r.float().abs() @ Wc.abs() + bc.abs()
    gamma, beta = (a[:, None, :] for a in film.float().chunk(2, dim=-1))
    return ((h + p) * (1.0 + gamma) + beta,
            terms * (1.0 + gamma).abs() + beta.abs())


# K1 with its epilogue against the plain composition, which rounds about
# eight times to x's dtype: within this share of the terms' size (four bf16
# ulps of 2^-7), plus the K1 bar's atol
EPILOGUE_PLAIN_REL = {"float32": 1e-4, "bfloat16": 2 ** -5}


def conv_row(x, W, b, s, bb, G: int, reps: int = REPS,
             plain_reps: int = REPS // 4, *, film=None, r=None, Wc=None,
             bc=None) -> dict:
    """K1 on these inputs against its plain version (``TOL``) and the cuDNN
    yardstick (``F.conv1d`` -> ``F.group_norm`` -> ``F.silu``): route,
    times, the bound (each input read once, the output written once),
    GFLOP, MB and the error.  With ``film`` (and r, Wc, bc) K1 carries the
    U-Net's conditioning epilogue: the error is then against the same
    steps in f32 (``epilogue_f32``, at ``TOL``) and against the plain
    composition (``EPILOGUE_PLAIN_REL``), and the yardstick adds the
    U-Net's separate steps after cuDNN."""
    dev, dtype = x.device, x.dtype
    dname = str(dtype).split(".")[1]
    B, L, Cin = x.shape
    Cout = W.shape[-1]
    epi = {} if film is None else dict(film=film, r=r, Wc=Wc, bc=bc)
    out = fused_conv_gn_silu(x, W, b, s, bb, G, **epi)
    want = fused_conv_gn_silu_reference(x, W, b, s, bb, G, **epi)
    _sync(dev)
    if film is None:
        err = _against(out, want, "conv_gn_silu")
    else:
        ideal, scale = epilogue_f32(x, W, b, s, bb, G, film, r, Wc, bc)
        err = _against(out, ideal, "conv_gn_silu")
        diff = (out.float() - want.float()).abs()
        err["max_abs_err_vs_plain"] = float(diff.max())
        err["n_outside_plain_tol"] = int(
            (diff > EPILOGUE_PLAIN_REL[dname] * scale + err["atol"]).sum())
        del ideal, scale, diff
    del out, want
    xc = x.transpose(1, 2).contiguous()
    Wl = W.permute(2, 1, 0).to(dtype).contiguous()
    bl, sl, bbl = b.to(dtype), s.to(dtype), bb.to(dtype)

    def library():
        h = F.silu(F.group_norm(F.conv1d(xc, Wl, bl, padding=1), G, sl,
                                bbl, 1e-5))
        if film is None:
            return h
        h = h.transpose(1, 2)
        if r is not None:
            h = h + (r @ Wc.to(dtype) + bc.to(dtype))
        gamma, beta = film.chunk(2, dim=-1)
        return h * (1.0 + gamma[:, None, :]) + beta[:, None, :]

    t_k = time_ms(lambda: fused_conv_gn_silu(x, W, b, s, bb, G, **epi), dev,
                  reps)
    t_p = time_ms(lambda: fused_conv_gn_silu_reference(x, W, b, s, bb, G,
                                                       **epi),
                  dev, max(1, plain_reps))
    t_l = time_ms(library, dev, reps)
    esize = x.element_size()
    nbytes = (x.numel() * esize + W.numel() * 4 + 3 * Cout * 4
              + B * L * Cout * esize)
    flops = 2.0 * B * L * 3 * Cin * Cout
    if film is not None:
        # FiLM's coefficients; r, Wc and bc; per output the product with
        # r, the sum and FiLM's multiply-add
        K = 0 if r is None else r.shape[-1]
        nbytes += film.numel() * esize
        if r is not None:
            nbytes += r.numel() * esize + (Wc.numel() + bc.numel()) * 4
        flops += (2.0 * K + 3) * B * L * Cout
    return {"route": conv_route(x), "dtype": dname, "kernel_ms": t_k,
            "plain_ms": t_p, "library_ms": t_l, "speedup": t_p / t_k,
            **_bound(flops, nbytes, dev, dname),
            "tflops": flops / (t_k * 1e9), "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6, **err,
            "within_tol": (err["n_outside_tol"] == 0
                           and err.get("n_outside_plain_tol", 0) == 0)}


def attention_row(q, k, v, reps: int = REPS, plain_reps: int = REPS // 4,
                  exact_bound: bool = False) -> dict:
    """K2 on these inputs against its plain version (``TOL``) and the SDPA
    yardstick: route, times, the bound (q, k, v read once, the output
    written once), GFLOP, MB and the error; with ``exact_bound`` (bf16)
    also the count of outputs outside ``attention_within_bound``."""
    dev = q.device
    dname = str(q.dtype).split(".")[1]
    B, H, L, D = q.shape
    out = flash_attention(q, k, v)
    want = plain_attention(q, k, v)
    _sync(dev)
    err = _against(out, want, "flash_attention")
    ok = err["n_outside_tol"] == 0
    if exact_bound:
        err["n_outside_bound"] = attention_within_bound(out, q, k, v)
        err["bound"] = "2^-8 (|P| @ |V| + |out|) + 1e-4 of the exact attention"
        ok = ok and err["n_outside_bound"] == 0
    del out, want
    t_k = time_ms(lambda: flash_attention(q, k, v), dev, reps)
    t_p = time_ms(lambda: plain_attention(q, k, v), dev, max(1, plain_reps))
    t_l = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), dev, reps)
    nbytes = 4 * q.numel() * q.element_size()
    flops = 4.0 * B * H * L * L * D                # Q K^T and P V
    return {"route": attention_route(q, k, v), "dtype": dname,
            "kernel_ms": t_k, "plain_ms": t_p, "library_ms": t_l,
            "speedup": t_p / t_k, **_bound(flops, nbytes, dev, dname),
            "tflops": flops / (t_k * 1e9), "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6, **err, "within_tol": ok}


def grads_against(got, want, dname: str, zero=()) -> dict:
    """Each gradient of ``got`` against ``want`` within ``GRAD_TOL``, atol
    on the scale of that gradient's largest element.  A gradient that is
    zero in exact arithmetic (``zero``, by position: db with one channel a
    group, dq and dk at L 1) is rounding in both, so it is held on the
    largest scale of the others.  Returns each gradient's scale, its
    largest difference over the scale, the largest difference of all, and
    the count of elements outside the bar."""
    rtol, atol = GRAD_TOL[dname]
    got = [g.float() for g in got]
    want = [w.float() for w in want]
    scales = [float(w.abs().max()) for w in want]
    floor = max((c for i, c in enumerate(scales) if i not in zero),
                default=0.0)
    scales = [max(c, floor) if i in zero else c
              for i, c in enumerate(scales)]
    errs, abs_errs, bad = [], [], 0
    for g, w, scale in zip(got, want, scales):
        diff = (g - w).abs()
        bad += int((diff > rtol * w.abs() + atol * scale).sum())
        abs_errs.append(float(diff.max()))
        errs.append(abs_errs[-1] / scale if scale > 0 else abs_errs[-1])
    return {"grad_scale": scales, "grad_err": errs,
            "max_abs_err": max(abs_errs), "rtol": rtol, "atol": atol,
            "n_outside_tol": bad}


def _backward_row(kernel_fn, plain_fn, oracle, library, args, flops,
                  nbytes, dev, dname, reps, plain_reps, zero):
    """The common part of the backward rows: one counted launch, a second
    call bit-equal to the first, the gradients against ``oracle`` (the
    plain backward in f32) and, with ``reps``, the kernel's, the plain
    backward's and the library backward's times and the bound."""
    before = kernel_fn.launches
    got = kernel_fn(*args)
    launched = kernel_fn.launches - before
    again = kernel_fn(*args)
    _sync(dev)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    err = grads_against(got, oracle(), dname, zero)
    del got
    row = {"dtype": dname, "launches_per_call": launched,
           "deterministic": same, **err,
           "within_tol": err["n_outside_tol"] == 0 and same and (
               dev.type != "cuda" or launched == 1),
           "gflop": flops / 1e9, "mbytes": nbytes / 1e6}
    if reps:
        t_k = time_ms(lambda: kernel_fn(*args), dev, reps)
        t_p = time_ms(lambda: plain_fn(*args), dev, max(1, plain_reps))
        t_l = time_ms(library, dev, reps)
        row.update(kernel_ms=t_k, plain_ms=t_p, library_ms=t_l,
                   speedup=t_p / t_k, tflops=flops / (t_k * 1e9),
                   **_bound(flops, nbytes, dev, dname))
    return row


def conv_backward_row(dout, x, W, b, s, bb, G: int, reps: int = REPS,
                      plain_reps: int = REPS // 4) -> dict:
    """K1B (``fused_conv_gn_silu_grad``) on these inputs: launches, a
    second call bit-equal, the gradients against the plain backward in f32
    on x, dout and W as the kernel's products take them (W rounded to x's
    dtype; ``GRAD_TOL``) and, with ``reps``, times against the
    plain backward in x's dtype and the library yardstick (autograd of
    ``F.conv1d`` -> ``F.group_norm`` -> ``F.silu``, its backward alone),
    the bound: x, dout and the parameters read once, dx and the parameter
    gradients written once; the recompute, dx and dW products."""
    dev, dtype = x.device, x.dtype
    dname = str(dtype).split(".")[1]
    B, L, Cin = x.shape
    Cout = W.shape[-1]
    args = (dout, x, W, b, s, bb, G)
    ins = [a.detach().clone(memory_format=torch.contiguous_format)
           .requires_grad_() for a in (
        x.transpose(1, 2), W.permute(2, 1, 0).to(dtype),
        *(v.to(dtype) for v in (b, s, bb)))]
    out = F.silu(F.group_norm(F.conv1d(ins[0], ins[1], ins[2], padding=1),
                              G, ins[3], ins[4], 1e-5))
    dout_l = dout.transpose(1, 2).contiguous()
    esize = x.element_size()
    nbytes = (2 * x.numel() * esize + dout.numel() * esize
              + 2 * (W.numel() + 3 * Cout) * 4)
    return {"route": conv_route(x), "dx_route": dx_route(x, Cout),
            "dw_route": dw_route(x, Cout),
            **_backward_row(
        fused_conv_gn_silu_grad, fused_conv_gn_silu_backward,
        lambda: fused_conv_gn_silu_backward(
            dout.float(), x.float(), W.to(dtype).float(), *args[3:]),
        lambda: torch.autograd.grad(out, ins, dout_l, retain_graph=True),
        args, 3 * 2.0 * B * L * 3 * Cin * Cout, nbytes, dev, dname, reps,
        plain_reps, zero=(2,) if Cout == G else ())}


def attention_backward_row(dout, q, k, v, reps: int = REPS,
                           plain_reps: int = REPS // 4) -> dict:
    """K2B (``flash_attention_grad``) given the forward kernel's output:
    launches, a second call bit-equal, the gradients against the plain
    backward on the inputs in f32 (``GRAD_TOL``) and, with ``reps``, times
    against the plain backward in q's dtype and SDPA's backward alone, the
    bound: q, k, v, the output and dout read once, dq, dk, dv written once;
    five products of 2 B H L^2 D (S recomputed, dP, dV, dK, dQ)."""
    dev = q.device
    dname = str(q.dtype).split(".")[1]
    B, H, L, D = q.shape
    o = flash_attention(q, k, v)
    args = (dout, q, k, v, o)
    ins = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    out = F.scaled_dot_product_attention(*ins)
    return {"route": backward_route(q, k, v, dout, o), **_backward_row(
        flash_attention_grad, flash_attention_backward,
        lambda: flash_attention_backward(*(a.float() for a in args)),
        lambda: torch.autograd.grad(out, ins, dout, retain_graph=True),
        args, 10.0 * B * H * L * L * D, 8 * q.numel() * q.element_size(),
        dev, dname, reps, plain_reps, zero=(0, 1) if L == 1 else ())}


def bench_conv(device=None, dtype=torch.float32, shapes=CONV_SHAPES,
               reps: int = REPS) -> list:
    """K1 against its plain version and the cuDNN yardstick, JAX's inputs:
    x ~ N(0, 1), W ~ 0.1 N(0, 1), zero biases, unit GroupNorm scale, 8
    groups."""
    dev = resolve_device(device)
    rows = []
    for (B, L, Cin, Cout) in shapes:
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(B, L, Cin, generator=g, device=dev).to(dtype)
        W = torch.randn(3, Cin, Cout, generator=g, device=dev) * 0.1
        b, bb = (torch.zeros(Cout, device=dev) for _ in range(2))
        s = torch.ones(Cout, device=dev)
        row = conv_row(x, W, b, s, bb, 8, reps, reps // 4)
        rows.append({"kernel": "conv_gn_silu" + (
            "_bf16" if dtype == torch.bfloat16 else ""),
            "shape": [B, L, Cin, Cout], **row})
        del x
    return rows


def bench_conv_bf16(device=None, shapes=CONV_SHAPES, reps: int = REPS) -> list:
    return bench_conv(device, torch.bfloat16, shapes, reps)


@contextlib.contextmanager
def _materialised_decoder():
    """Inside the block K1's wrapper runs every decoder block on its
    materialised input, as where K1's decoder route does not apply."""
    route = conv_gn_silu.takes_decoder_route
    conv_gn_silu.takes_decoder_route = lambda h, skip: False
    try:
        yield
    finally:
        conv_gn_silu.takes_decoder_route = route


def decoder_f32(h, skip, W, b, s, bb, G: int, film=None, r=None, Wc=None,
                bc=None):
    """K1's decoder route's arithmetic in plain PyTorch: its conv pass
    (``decoder_conv_passes``, the folded taps rounded once to bf16), then
    GroupNorm, affine, SiLU and the epilogue in f32, as the kernel rounds
    them once."""
    y = group_norm(decoder_conv_passes(h, skip, W, b), G, s, bb)
    y = y * torch.sigmoid(y)
    if film is None:
        return y
    if r is not None:
        y = y + (r.float() @ Wc + bc)
    gamma, beta = (a[:, None, :] for a in film.float().chunk(2, dim=-1))
    return y * (1.0 + gamma) + beta


def decoder_row(h, skip, block: unet.ConvBlock, reps: int = REPS,
                plain_reps: int = REPS // 4, **epi) -> dict:
    """K1's decoder route on h (B, L/2, C_h) and skip (B, L, C_s) bf16 with
    ``block``'s parameters (and the epilogue ``epi``, as the U-Net launches
    it), against its own arithmetic (``decoder_f32``, at ``TOL``; on the
    CPU, where the route is the materialised plain version, against that) and
    against the materialised upsample -> concat -> K1 (``DECODER_MAT_TOL``;
    with the epilogue, three times its atol).  With ``reps`` the times of
    the route (``kernel_ms``), of the materialised path and of its
    concatenation alone, of the plain fold (``decoder_f32``), of the plain
    version and of the library
    (the concatenation, then cuDNN ``conv1d`` -> ``group_norm`` ->
    ``silu``); the bound from the fold's FLOPs (2 C_h + 3 C_s MACs a row and
    output channel) and bytes (h, skip, W, output)."""
    dev = h.device
    B, Ls, Cs = skip.shape
    Ch = h.shape[-1]
    W, b = block.conv.kernel, block.conv.bias
    s, bb, G = block.norm.scale, block.norm.bias, block.groups
    Co = W.shape[-1]
    with torch.no_grad():
        def route():
            return fused_conv_gn_silu(h, W, b, s, bb, G, skip=skip, **epi)

        def materialised():
            return fused_conv_gn_silu(decoder_input(h, skip), W, b, s, bb, G,
                                      **epi)

        out = route().float()
        if dev.type == "cuda":
            alg = decoder_f32(h, skip, W, b, s, bb, G, **epi)
        else:   # the route's CPU path is the materialised plain version
            alg = fused_conv_gn_silu_reference(h, W, b, s, bb, G, skip=skip,
                                               **epi)
        err = _against(out.bfloat16(), alg, "conv_gn_silu")
        del alg
        mat = materialised().float()
        rtol, atol = DECODER_MAT_TOL
        diff = (out - mat).abs()
        err["max_abs_err_vs_materialised"] = float(diff.max())
        err["n_outside_materialised_tol"] = int(
            (diff > rtol * mat.abs() + (3 if epi else 1) * atol).sum())
        del out, mat, diff
        row = {"dtype": "bfloat16", "epilogue": "none" if not epi else
               "film" if epi.get("r") is None else f"cond{epi['r'].shape[-1]}",
               **err, "within_tol": (err["n_outside_tol"] == 0 and
                                     err["n_outside_materialised_tol"] == 0)}
        if reps < 1:
            return row
        Wl = W.permute(2, 1, 0).bfloat16().contiguous()
        bl, sl, bbl = (v.bfloat16() for v in (b, s, bb))

        def library():
            xc = decoder_input(h, skip).transpose(1, 2)
            return F.silu(F.group_norm(F.conv1d(xc, Wl, bl, padding=1), G,
                                       sl, bbl, 1e-5))

        row.update(
            kernel_ms=time_ms(route, dev, reps),
            materialised_ms=time_ms(materialised, dev, reps),
            concat_ms=time_ms(lambda: decoder_input(h, skip), dev, reps),
            plain_fold_ms=time_ms(lambda: decoder_f32(h, skip, W, b, s, bb,
                                                      G, **epi), dev, reps),
            plain_ms=time_ms(lambda: fused_conv_gn_silu_reference(
                h, W, b, s, bb, G, skip=skip, **epi), dev, max(1, plain_reps)),
            library_ms=time_ms(library, dev, reps))
    row["speedup_vs_materialised"] = row["materialised_ms"] / row["kernel_ms"]
    flops = 2.0 * B * Ls * (2 * Ch + 3 * Cs) * Co
    nbytes = (h.numel() + skip.numel() + B * Ls * Co) * 2 + W.numel() * 4
    row.update(_bound(flops, nbytes, dev, "bfloat16"), gflop=flops / 1e9,
               mbytes=nbytes / 1e6)
    return row


def bench_fast_decoder(device=None, stages=DECODER_STAGES,
                       reps: int = REPS, unet_rows: int = UNET_B,
                       unet_L: int = UNET_L) -> list:
    """Per stage (bf16, seeded inputs and weights), ``decoder_row``; then
    the attention U-Net's forward at ``unet_rows`` x ``unet_L`` with its
    decoder on the route and materialised."""
    from ..utils.weights import randomize_

    dev = resolve_device(device)
    rows = []
    for (B, Ls, Ch, Cs, Co) in stages:
        g = torch.Generator(device=dev).manual_seed(0)
        h = torch.randn(B, Ls // 2, Ch, generator=g, device=dev).bfloat16()
        skip = torch.randn(B, Ls, Cs, generator=g, device=dev).bfloat16()
        block = unet.ConvBlock(Ch + Cs, Co, dev)
        randomize_(block, 1)
        rows.append({"kernel": "conv_gn_silu_decoder_bf16",
                     "shape": [B, Ls, Ch, Cs, Co],
                     **decoder_row(h, skip, block, reps)})
        del h, skip
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(unet_rows, UNET_MODEL["in_ch"], unet_L, generator=g,
                    device=dev)
    t = torch.zeros((unet_rows,), dtype=torch.int64, device=dev)
    model = unet.UNet1D(**UNET_MODEL, dtype=torch.bfloat16, device=dev)
    randomize_(model, 1)
    outs = {}
    for on in (False, True):
        with torch.no_grad(), (contextlib.nullcontext() if on
                               else _materialised_decoder()):
            outs[on] = model(x, t)
            ms = time_ms(lambda: model(x, t), dev, max(1, reps // 2))
        rows.append({"kernel": f"unet_fwd_decoder_route={on}",
                     "shape": [unet_rows, UNET_MODEL["in_ch"], unet_L],
                     "ms": ms, "fwd_per_sec": 1e3 / ms})
    rows[-1]["max_rel_err_vs_materialised"] = float(
        (outs[True] - outs[False]).abs().max() / outs[False].abs().max())
    return rows


def _exact_attention(q, k, v):
    """f32 attention of bf16 inputs and sum_i p_i |v_i|, over chunks of B
    so that the scores stay near 2 GB."""
    B, H, L, D = q.shape
    step = max(1, (1 << 31) // (H * L * L * 4))
    outs, absv = [], []
    for i in range(0, B, step):
        qf, kf, vf = (a[i:i + step].float() for a in (q, k, v))
        p = torch.softmax(qf @ kf.transpose(-1, -2) / math.sqrt(D), dim=-1)
        outs.append(p @ vf)
        absv.append(p @ vf.abs())
    return torch.cat(outs), torch.cat(absv)


def attention_within_bound(out, q, k, v) -> int:
    """Outputs of a bf16 attention outside the rounding of P: the kernel
    rounds each unnormalised p_i to bf16 (unit roundoff 2^-8) and then the
    output, so it is off the exact attention by at most 2^-8 (sum_i p_i
    |v_i| + |out|), up to second-order terms and the f32 sums; the count
    of outputs beyond that (with 1e-4 of slack)."""
    exact, absv = _exact_attention(q, k, v)
    bound = 1e-4 + 1.02 * 2 ** -8 * (absv + exact.abs())
    return int(((out.float() - exact).abs() > bound).sum())


def plain_attention(q, k, v):
    """The plain version over chunks of B, so that its f32 scores stay near
    2 GB (at (32, 4, 4096, 64) they would take 8.6 GB at once)."""
    B, H, L, _ = q.shape
    step = max(1, (1 << 31) // (H * L * L * 4))
    return torch.cat([flash_attention_reference(q[i:i + step], k[i:i + step],
                                                v[i:i + step])
                      for i in range(0, B, step)])


def bench_attention(device=None, shapes=ATTN_SHAPES,
                    dtypes=(torch.float32, torch.bfloat16),
                    reps: int = REPS) -> list:
    """K2 against its plain version and the SDPA yardstick, q, k, v ~
    N(0, 1), in f32 (FMA route) and bf16 (``wgmma``; also against the
    exact attention within the rounding of P)."""
    dev = resolve_device(device)
    rows = []
    for dtype in dtypes:
        for (B, H, L, D) in shapes:
            g = torch.Generator(device=dev).manual_seed(0)
            q, k, v = (torch.randn(B, H, L, D, generator=g, device=dev)
                       .to(dtype) for _ in range(3))
            row = attention_row(q, k, v, reps, reps // 4,
                                exact_bound=dtype == torch.bfloat16)
            rows.append({"kernel": "flash_attention" + (
                "_bf16" if dtype == torch.bfloat16 else ""),
                "shape": [B, H, L, D], **row})
            del q, k, v
    return rows


def bench_unet(device=None, B: int = UNET_B, L: int = UNET_L,
               model_kw=UNET_MODEL, reps: int = 10) -> list:
    """The attention U-Net's forward in bf16 through the kernels against
    the same module through the plain versions (seeded random weights):
    times, and the kernel path's error against the plain path relative to
    the latter's largest output, in bf16 and, with the same weights, in
    f32 (``max_rel_err_vs_plain_f32``, the one held to a bar)."""
    from ..utils.weights import randomize_

    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, model_kw["in_ch"], L, generator=g, device=dev)
    t = torch.zeros((B,), dtype=torch.int64, device=dev)
    rows, rel = [], {}
    for dtype in (torch.bfloat16, torch.float32):
        model = unet.UNet1D(**model_kw, dtype=dtype, device=dev).eval()
        randomize_(model, 1)
        outs = {}
        for use_kernels in (False, True):
            with torch.no_grad(), (contextlib.nullcontext() if use_kernels
                                   else unet.plain_kernels()):
                outs[use_kernels] = model(x, t)
                if dtype == torch.bfloat16:
                    ms = time_ms(lambda: model(x, t), dev, reps)
                    rows.append({"kernel": f"unet_fwd_kernels={use_kernels}",
                                 "shape": [B, model_kw["in_ch"], L],
                                 "ms": ms, "fwd_per_sec": 1e3 / ms})
        rel[dtype] = float((outs[True] - outs[False]).abs().max()
                           / outs[False].abs().max())
        del model, outs
    rows[-1]["max_rel_err_vs_plain"] = rel[torch.bfloat16]
    rows[-1]["max_rel_err_vs_plain_f32"] = rel[torch.float32]
    return rows


def bench_hbm_stream(device=None, n: int = HBM_N, iters: int = HBM_ITERS,
                     reps: int = 5) -> list:
    """The device-memory rate the card delivers: ``iters`` dependent saxpy
    passes (y = 1.0000001 y + 1e-7, one kernel a pass, in place) over an
    ``n``-element float32 buffer; bytes = iters x 2 x 4 n; the best of
    ``reps`` runs."""
    dev = resolve_device(device)
    x = torch.ones(n, dtype=torch.float32, device=dev)
    c = torch.tensor(1e-7, device=dev)

    def stream():
        for _ in range(iters):
            torch.add(c, x, alpha=1.0000001, out=x)

    best = min(time_ms(stream, dev, 1) for _ in range(reps))
    gbps = iters * 2 * n * 4 / (best * 1e-3) / 1e9
    kind = _kind(dev)
    out = {"kernel": "hbm_stream_saxpy", "buffer_mb": n * 4 // 2 ** 20,
           "iters": iters, "ms": best, "achieved_gbps": gbps,
           "device_kind": kind}
    peak = peak_for(kind)
    if peak:
        out["peak_gbps"] = peak[1] / 1e9
        out["fraction_of_spec_peak"] = gbps / (peak[1] / 1e9)
    return [out]


SECTIONS = {"conv": bench_conv, "conv_bf16": bench_conv_bf16,
            "decoder": bench_fast_decoder, "attn": bench_attention,
            "unet": bench_unet, "hbm": bench_hbm_stream}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("section", nargs="?", choices=sorted(SECTIONS))
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {_kind(dev)}")
    for name, fn in SECTIONS.items():
        if args.section is None or args.section == name:
            for row in fn(dev):
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
