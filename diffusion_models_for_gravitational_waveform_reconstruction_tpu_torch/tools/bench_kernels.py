"""Kernel micro-benchmarks on the card: each hand-written kernel of the port
against its plain PyTorch version; the port's twin of the root
``tools/bench_kernels.py``.

    python -m diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools.bench_kernels \
        [conv|conv_bf16|decoder|attn|unet|hbm] [--device cpu]

Sections, at the root tool's shapes:

- ``conv`` / ``conv_bf16``: K1, the fused ConvBlock (``ops/kernels``
  ``fused_conv_gn_silu``), f32 and bf16, at (B, L, Cin, Cout) = (64, 4096,
  64, 64), (64, 2048, 64, 128), (64, 1024, 128, 256), (64, 1024, 512, 256);
- ``decoder``: ``models/unet.py::DecoderConvBlock`` (upsample and concat
  folded into the conv, plain PyTorch) against the materialised upsample ->
  concat -> ConvBlock through K1, at the three decoder stages of the
  reference-default U-Net (B 64, bf16; and in f32 for the error); the
  whole-model fast-decoder rows are not run: the port's ``UNet1D`` has no
  fast-decoder path until K1 has a decoder variant;
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
from ..ops.kernels import (attention_route, conv_route, flash_attention,
                           flash_attention_reference, fused_conv_gn_silu,
                           fused_conv_gn_silu_reference)
from ..utils.device import resolve_device
from ..utils.roofline import bound_ms, peak_for

CONV_SHAPES = [(64, 4096, 64, 64), (64, 2048, 64, 128),
               (64, 1024, 128, 256), (64, 1024, 512, 256)]
# (L_skip, C_h, C_s, Cout) of the reference-default U-Net's decoder stages
DECODER_STAGES = [(1024, 256, 256, 256), (2048, 256, 128, 128),
                  (4096, 128, 64, 64)]
DECODER_B = 64
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


def conv_row(x, W, b, s, bb, G: int, reps: int = REPS,
             plain_reps: int = REPS // 4) -> dict:
    """K1 on these inputs against its plain version (``TOL``) and the cuDNN
    yardstick (``F.conv1d`` -> ``F.group_norm`` -> ``F.silu``): route,
    times, the bound (each input read once, the output written once),
    GFLOP, MB and the error."""
    dev, dtype = x.device, x.dtype
    dname = str(dtype).split(".")[1]
    B, L, Cin = x.shape
    Cout = W.shape[-1]
    out = fused_conv_gn_silu(x, W, b, s, bb, G)
    want = fused_conv_gn_silu_reference(x, W, b, s, bb, G)
    _sync(dev)
    err = _against(out, want, "conv_gn_silu")
    del out, want
    xc = x.transpose(1, 2).contiguous()
    Wc = W.permute(2, 1, 0).to(dtype).contiguous()
    bl, sl, bbl = b.to(dtype), s.to(dtype), bb.to(dtype)

    def library():
        return F.silu(F.group_norm(F.conv1d(xc, Wc, bl, padding=1), G, sl,
                                   bbl, 1e-5))

    t_k = time_ms(lambda: fused_conv_gn_silu(x, W, b, s, bb, G), dev, reps)
    t_p = time_ms(lambda: fused_conv_gn_silu_reference(x, W, b, s, bb, G),
                  dev, max(1, plain_reps))
    t_l = time_ms(library, dev, reps)
    esize = x.element_size()
    nbytes = (x.numel() * esize + W.numel() * 4 + 3 * Cout * 4
              + B * L * Cout * esize)
    flops = 2.0 * B * L * 3 * Cin * Cout
    return {"route": conv_route(x), "dtype": dname, "kernel_ms": t_k,
            "plain_ms": t_p, "library_ms": t_l, "speedup": t_p / t_k,
            **_bound(flops, nbytes, dev, dname),
            "tflops": flops / (t_k * 1e9), "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6, **err,
            "within_tol": err["n_outside_tol"] == 0}


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


def _materialised(block: unet.ConvBlock, h, skip):
    u = unet._fix_len(h.repeat_interleave(2, dim=1), skip.shape[1])
    return block(torch.cat([u, skip], dim=-1))


def bench_fast_decoder(device=None, stages=DECODER_STAGES, B: int = DECODER_B,
                       reps: int = REPS) -> list:
    """Per stage, ``DecoderConvBlock`` (bf16) against the materialised
    upsample -> concat -> ``ConvBlock`` through K1 with the same
    parameters; the difference of the two in f32 too.  Then the
    whole-model rows' status."""
    dev = resolve_device(device)
    rows = []
    for (Ls, Ch, Cs, Co) in stages:
        g = torch.Generator(device=dev).manual_seed(0)
        h = torch.randn(B, Ls // 2, Ch, generator=g, device=dev)
        skip = torch.randn(B, Ls, Cs, generator=g, device=dev)
        fast = {dt: unet.DecoderConvBlock(Ch, Cs, Co, dtype=dt, device=dev)
                for dt in (torch.float32, torch.bfloat16)}
        fast[torch.bfloat16].load_state_dict(
            fast[torch.float32].state_dict())
        block = unet.ConvBlock(Ch + Cs, Co, dev)
        block.load_state_dict(fast[torch.float32].state_dict())
        with torch.no_grad():
            want = _materialised(block, h, skip)
            got = fast[torch.float32](h, skip)
            _sync(dev)
            err = _against(got, want, "conv_gn_silu")
            hb, sb = h.to(torch.bfloat16), skip.to(torch.bfloat16)
            err_bf16 = float((fast[torch.bfloat16](hb, sb).float()
                              - _materialised(block, hb, sb).float())
                             .abs().max())
            t_mat = time_ms(lambda: _materialised(block, hb, sb), dev, reps)
            t_fast = time_ms(lambda: fast[torch.bfloat16](hb, sb), dev, reps)
        rows.append({"kernel": "decoder_stage_fast_vs_plain_bf16",
                     "shape": [B, Ls, Ch, Cs, Co],
                     "plain_ms": t_mat, "fast_ms": t_fast,
                     "speedup": t_mat / t_fast,
                     "plain": "upsample -> concat -> ConvBlock through K1",
                     "fast": "DecoderConvBlock, F.conv1d",
                     "max_abs_err_f32": err.pop("max_abs_err"), **err,
                     "within_tol": err["n_outside_tol"] == 0,
                     "max_abs_err_bf16": err_bf16})
    for fastdec in (False, True):
        rows.append({"kernel": f"unet_fwd_fast_decoder={fastdec}",
                     "shape": [UNET_B, 7, UNET_L],
                     "status": "not run: the port's UNet1D has no "
                               "fast-decoder path; it waits for a decoder "
                               "variant of K1 (ROADMAP.md Queue 2, open "
                               "work 9)"})
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
