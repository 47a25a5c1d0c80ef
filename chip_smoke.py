#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Two main paths are driven: the "pn128" flagship (base_ch 128, L 4096, no
attention) and the 16 kHz attention flagship "attn16k" (base_ch 64, depth 3,
bottleneck attention, L 32768).  Phases, each printing JSON lines:

1. device  - the card (also its ``nvidia-smi`` name and power limit, as a raw
             line); TF32 and bf16 reduced-precision reductions are switched
             off for every comparison.
2. build   - compiles every CUDA source of the port with nvcc, one process
             per source, all at once; reports the build's time, ptxas's
             registers, spills and warnings, and how many wgmma
             instructions (``HGMMA``, read with ``cuobjdump -sass``) each
             library's SASS holds; both kernels must have some.
3. kernel  - K1, the fused ConvBlock kernel, against its plain PyTorch
             version at every ConvBlock shape of pn128 (bf16 at 64 rows, the
             serving batch, and 128 rows; f32 at 128 rows) and of attn16k
             (bf16 at 32 rows, its serving batch); K2, the flash-attention
             kernel, at attn16k's bottleneck (32, 4, 4096, 64) in bf16 (and
             at L 4000), in f32, and at a ragged L and other head widths.
             Each with its route, TFLOP/s, time, the plain version's, a
             PyTorch yardstick's (``F.conv1d -> F.group_norm -> F.silu``;
             ``F.scaled_dot_product_attention``) and the roofline bound.
             K1's records also carry the two-pass floor (the bound plus y's
             f32 write and read) and one call's device time split into
             pack / conv / stats / apply (``torch.profiler``).
4. model   - each flagship U-Net in f32 with seeded random weights: the
             kernel path (its launches counted) against the same module
             through the plain versions.
5. serving - the deployment sampler (``serving.build_serving_fn``) on each
             flagship in bf16, ladder lambda, MF amplitude calibration:
             pn128 at 4 requests x 8 seeds x CFG = 64 rows per forward,
             attn16k at 4 requests x 4 seeds x CFG = 32 rows.  Counts the
             kernel launches of one run, then times five more (median, min,
             max) and profiles one (device time by group, idle share, K2's
             launches by kernel, which on attn16k must all be the wgmma
             route; traces in traces/).  A small f32 configuration is also checked against
             the CPU plain path, its launches counted.
6. kernels - one ``{"kernels": [...]}`` line, then the last line
             ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero.  Without a CUDA
device, or without the port's package beside it, it exits non-zero before
printing any result.
"""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# published dense peaks of one H100 SXM (NVIDIA data sheet), at 700 W
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

SERVING_STEPS = 10       # the recipe's 50 steps, cut to bound the run's time
SERVING_REQUESTS = 4
SERVING_TIMED_RUNS = 5
FLAGSHIP = dict(in_ch=7, base_ch=128, time_dim=128, depth=3,
                t_embed_max_time=999.0, cond_in_ch=5, use_selfcond=True)
# the 16 kHz attention flagship (BASELINE.json config 3): PN metadata, so
# in_ch 7 and cond_in_ch 5; 32768-sample segments
ATTN16K = dict(in_ch=7, base_ch=64, time_dim=128, depth=3,
               t_embed_max_time=999.0, cond_in_ch=5, use_selfcond=True,
               use_attention=True)
PATHS = {"pn128": dict(model=FLAGSHIP, L=4096, seeds=8, rows=64),
         "attn16k": dict(model=ATTN16K, L=32768, seeds=4, rows=32)}
# kernel vs plain version: f32 differs only in summation order; bf16 may
# flip an output by one bf16 ulp (2^-7 relative)
K1_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2 ** -7, 1e-3)}
# K2 vs plain version: f32 differs in summation order and in exp2 of
# log2-scaled scores; in bf16 both round P (the kernel before normalising,
# the plain version after) and the output, a few ulps of 2^-8 apart
K2_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2 ** -6, 2e-3)}
# (dtype, B, H, L, D): attn16k's bottleneck in bf16 (the serving shape, and
# the serving batch at a ragged L) and f32, a ragged L, each head-width
# template (D 32, 64, 128, 256; D 128 at a ragged L too) and an odd D, whose
# rows are not 16-byte aligned
K2_SHAPES = [("bfloat16", 32, 4, 4096, 64), ("bfloat16", 32, 4, 4000, 64),
             ("float32", 8, 4, 4096, 64),
             ("bfloat16", 8, 4, 4000, 64), ("float32", 2, 4, 4000, 64),
             ("bfloat16", 8, 4, 4096, 32), ("bfloat16", 8, 4, 4096, 128),
             ("bfloat16", 8, 4, 4000, 128),
             ("float32", 2, 4, 4096, 32), ("float32", 2, 4, 4096, 128),
             ("bfloat16", 2, 2, 777, 65), ("float32", 2, 2, 777, 65),
             ("bfloat16", 2, 4, 2048, 256), ("float32", 1, 2, 2048, 256)]
MODEL_TOL = 1e-3   # f32, max-abs normalised, summation order through 7 blocks


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(torch, fn, reps):
    """Mean device time of ``fn`` in ms over ``reps`` calls after a warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def randomize_(torch, model, seed):
    """Fill every parameter from a seeded generator (the init leaves the
    final conv and the biases at zero): kernels N(0, 1/fan_in), GroupNorm
    scales 1 + N(0, 0.1^2), biases N(0, 0.1^2)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            z = torch.randn(p.shape, generator=g)
            if name.endswith("kernel"):
                z = z / float(np.prod(p.shape[:-1])) ** 0.5
            elif name.endswith("scale"):
                z = 1.0 + 0.1 * z
            else:
                z = 0.1 * z
            p.copy_(z)


def convblock_shapes(model, L):
    """(name, L, Cin, Cout) of every ConvBlock of ``model`` at input length L."""
    d = model.depth
    lens = ([L >> i for i in range(d)] + [L >> d]
            + [L >> (d - 1 - i) for i in range(d)])
    names = ([f"enc{i}" for i in range(d)] + ["mid"]
             + [f"dec{i}" for i in range(d)])
    out = []
    for name, n in zip(names, lens):
        k = getattr(model, name).conv.kernel
        out.append((name, n, int(k.shape[1]), int(k.shape[2])))
    return out


# K1's kernels by pass: the weight pack, the conv (either bf16 route or
# f32), the group statistics, the normalise + affine + SiLU
K1_PASSES = {"pack": "pack_weights", "conv": "conv3_", "stats": "group_stats",
             "apply": "gn_affine_silu"}
K1_KERNELS = tuple(K1_PASSES.values())
K2_KERNELS = ("flash_fwd",)
TRACES = Path(__file__).resolve().parent / "traces"


def device_breakdown(trace_path, wall_us):
    """Device time of a profiled run by group (K1's kernels, K2's, matrix
    products, the rest), K1's by pass, K2's launches by kernel, its top
    kernels, and the share of the run's wall time in which no kernel, copy
    or memset ran."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_name, groups = {}, {"k1": 0.0, "k2": 0.0, "matmul": 0.0, "other": 0.0}
    k1_passes = dict.fromkeys(K1_PASSES, 0.0)
    k2_launches = {}
    for e in dev:
        name, dur = e["name"], float(e["dur"])
        by_name[name] = by_name.get(name, 0.0) + dur
        low = name.lower()
        if any(k in name for k in K1_KERNELS):
            groups["k1"] += dur
            part = next(p for p, k in K1_PASSES.items() if k in name)
            k1_passes[part] += dur
        elif any(k in name for k in K2_KERNELS):
            groups["k2"] += dur
            k2_launches[name] = k2_launches.get(name, 0) + 1
        elif "gemm" in low or "nvjet" in low or "xmma" in low:
            groups["matmul"] += dur
        else:
            groups["other"] += dur
    busy, end = 0.0, None
    for e in sorted(dev, key=lambda e: float(e["ts"])):
        ts, te = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if end is None or ts >= end:
            busy += te - ts
            end = te
        elif te > end:
            busy += te - end
            end = te
    total = sum(groups.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_ms": total / 1e3, "wall_ms": wall_us / 1e3,
            "busy_ms": busy / 1e3, "idle_share": 1.0 - busy / wall_us,
            "share": {k: v / total for k, v in groups.items()},
            "k1_pass_ms": {k: v / 1e3 for k, v in k1_passes.items()},
            "k2_launches_by_kernel": k2_launches,
            "n_device_events": len(dev),
            "top_kernels_ms": [[n[:80], t / 1e3] for n, t in top]}


def k1_split_ms(torch, fn, reps=3):
    """Device ms of one call of ``fn`` by K1 pass, from ``torch.profiler``
    over ``reps`` calls; "not measured" when the profiler saw no kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = dict.fromkeys(K1_PASSES, 0.0)
    for e in prof.key_averages():
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0.0))
        for part, key in K1_PASSES.items():
            if key in e.key:
                split[part] += us / reps / 1e3
    if not any(split.values()):
        return "not measured"
    return split


def phase_kernel(torch, config, shapes, dtypes_rows):
    import torch.nn.functional as F

    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        conv_route,
        fused_conv_gn_silu,
        fused_conv_gn_silu_reference,
    )

    results = []
    for dtype, rows in dtypes_rows:
        dname = str(dtype).split(".")[1]
        rtol, atol = K1_TOL[dname]
        for name, L, Cin, Cout in shapes:
            G = 8
            g = torch.Generator(device="cuda").manual_seed(L + Cin + Cout)
            x = torch.randn(rows, L, Cin, generator=g, device="cuda").to(dtype)
            W = torch.randn(3, Cin, Cout, generator=g, device="cuda") / (3 * Cin) ** 0.5
            b, s, bb = (0.1 * torch.randn(Cout, generator=g, device="cuda")
                        for _ in range(3))
            s = s + 1.0
            out = fused_conv_gn_silu(x, W, b, s, bb, G)
            want = fused_conv_gn_silu_reference(x, W, b, s, bb, G)
            torch.cuda.synchronize()
            diff = (out.float() - want.float()).abs()
            max_err = float(diff.max())
            bad = int((diff > atol + rtol * want.float().abs()).sum())
            xc = x.transpose(1, 2).contiguous()
            Wc = W.permute(2, 1, 0).to(dtype).contiguous()
            bl, sl, bbl = b.to(dtype), s.to(dtype), bb.to(dtype)
            del out, want, diff

            def library():
                return F.silu(F.group_norm(F.conv1d(xc, Wc, bl, padding=1),
                                           G, sl, bbl, 1e-5))

            k_ms = cuda_ms(torch, lambda: fused_conv_gn_silu(x, W, b, s, bb, G), 5)
            p_ms = cuda_ms(torch, lambda: fused_conv_gn_silu_reference(
                x, W, b, s, bb, G), 3)
            l_ms = cuda_ms(torch, library, 5)
            split = k1_split_ms(
                torch, lambda: fused_conv_gn_silu(x, W, b, s, bb, G))
            esize = x.element_size()
            nbytes = (x.numel() * esize + W.numel() * 4 + 3 * Cout * 4
                      + rows * L * Cout * esize)
            y_bytes = 8 * rows * L * Cout      # y written and read in f32
            flops = 2.0 * rows * L * 3 * Cin * Cout
            t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dname]
            rec = {"phase": "kernel", "kernel": "conv_gn_silu",
                   "config": config, "block": name, "route": conv_route(x),
                   "rows": rows, "L": L, "Cin": Cin, "Cout": Cout,
                   "dtype": dname, "max_abs_err": max_err, "rtol": rtol,
                   "atol": atol, "n_outside_tol": bad, "kernel_ms": k_ms,
                   "plain_ms": p_ms, "library_ms": l_ms,
                   "bound_ms": 1e3 * max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes > t_ops else "operations",
                   "two_pass_floor_ms": 1e3 * max(
                       (nbytes + y_bytes) / PEAK_BYTES, t_ops),
                   "tflops": flops / (k_ms * 1e9), "split_ms": split,
                   "gflop": flops / 1e9, "mbytes": nbytes / 1e6}
            emit(rec)
            results.append(rec)
            check(bad == 0, f"conv_gn_silu {config} {name} {dname} "
                            f"rows={rows}: {bad} "
                            f"outputs outside rtol={rtol} atol={atol}")
            del x, W, xc, Wc
            torch.cuda.empty_cache()
    return results


def plain_attention(torch, q, k, v):
    """The plain version over chunks of B, so that its f32 scores stay near
    2 GB (at (32, 4, 4096, 64) they would take 8.6 GB at once)."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        flash_attention_reference,
    )

    B, H, L, _ = q.shape
    step = max(1, (1 << 31) // (H * L * L * 4))
    return torch.cat([flash_attention_reference(q[i:i + step], k[i:i + step],
                                                v[i:i + step])
                      for i in range(0, B, step)])


def phase_kernel_attention(torch):
    import torch.nn.functional as F

    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        attention_route,
        flash_attention,
    )

    results = []
    for dname, B, H, L, D in K2_SHAPES:
        dtype = getattr(torch, dname)
        rtol, atol = K2_TOL[dname]
        g = torch.Generator(device="cuda").manual_seed(B * L + D)
        q, k, v = (torch.randn(B, H, L, D, generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
        out = flash_attention(q, k, v)
        want = plain_attention(torch, q, k, v)
        torch.cuda.synchronize()
        diff = (out.float() - want.float()).abs()
        max_err = float(diff.max())
        bad = int((diff > atol + rtol * want.float().abs()).sum())
        del out, want, diff
        k_ms = cuda_ms(torch, lambda: flash_attention(q, k, v), 20)
        p_ms = cuda_ms(torch, lambda: plain_attention(torch, q, k, v), 2)
        l_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v),
                       20)
        nbytes = 4 * q.numel() * q.element_size()      # q, k, v read; o written
        flops = 4.0 * B * H * L * L * D                # Q K^T and P V
        t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dname]
        rec = {"phase": "kernel", "kernel": "flash_attention", "B": B, "H": H,
               "L": L, "D": D, "dtype": dname,
               "route": attention_route(q, k, v), "max_abs_err": max_err,
               "rtol": rtol, "atol": atol, "n_outside_tol": bad,
               "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes > t_ops else "operations",
               "tflops": flops / (k_ms * 1e9), "gflop": flops / 1e9,
               "mbytes": nbytes / 1e6}
        emit(rec)
        results.append(rec)
        check(bad == 0, f"flash_attention {dname} {(B, H, L, D)}: {bad} "
                        f"outputs outside rtol={rtol} atol={atol}")
        del q, k, v
        torch.cuda.empty_cache()
    return results


def expected_launches(model, forwards):
    """K1 once per ConvBlock per forward, K2 once per forward with
    attention."""
    return {"conv_gn_silu": (2 * model.depth + 1) * forwards,
            "flash_attention": forwards if model.use_attention else 0}


def check_launches(launch_counts, want, what):
    got = launch_counts()
    check(got == want, f"{what}: launches {got} != {want}")
    return got


def phase_model(torch, config, rows, L):
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models import unet
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        flash_attention_reference,
        fused_conv_gn_silu_reference,
        launch_counts,
        reset_launch_counts,
    )

    model = unet.UNet1D(**PATHS[config]["model"], device="cuda")
    randomize_(torch, model, 1)
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(rows, 7, L, generator=g, device="cuda")
    t = torch.tensor([0, 250, 600, 999][-rows:], device="cuda")
    with torch.no_grad():
        reset_launch_counts()
        got = model(x, t)
        launches = check_launches(launch_counts, expected_launches(model, 1),
                                  f"model phase {config}")
        kernels = unet.fused_conv_gn_silu, unet.flash_attention
        unet.fused_conv_gn_silu = fused_conv_gn_silu_reference
        unet.flash_attention = flash_attention_reference
        try:
            want = model(x, t)
        finally:
            unet.fused_conv_gn_silu, unet.flash_attention = kernels
    rel = float((got - want).abs().max() / want.abs().max())
    emit({"phase": "model", "config": f"{config} f32", "rows": rows, "L": L,
          "launches": launches, "max_rel_err": rel, "tol": MODEL_TOL,
          "out_abs_max": float(want.abs().max())})
    check(bool(torch.isfinite(got).all()), "model output finite")
    check(rel <= MODEL_TOL, f"model {config} kernel path vs plain path rel "
                            f"err {rel}")


def serving_config(schedule, steps):
    """The deployment config of a v-prediction PN checkpoint (DDIM, lambda
    ladder, CFG 1.5), and the number of distinct steps of its ladder."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.schedules import (
        build_lambda_t_schedule,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.serving import (
        resolve_serving_config,
    )

    ck = {"in_ch": 7, "cond_in_ch": 5, "pred_type": "v"}
    cfg, sampler = resolve_serving_config(ck, schedule, steps=steps,
                                          ladder="lambda", cfg_scale=1.5)
    return cfg, sampler, len(build_lambda_t_schedule(schedule, cfg.steps,
                                                     cfg.start_t))


def phase_serving_small(torch):
    """A small f32 configuration: the card's path against the CPU plain
    path."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models.unet import UNet1D
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.sampling import (
        FixedNoise,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.schedules import (
        make_schedule,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.serving import (
        build_serving_fn,
    )

    schedule = make_schedule(1000, "cosine")
    small = dict(in_ch=7, base_ch=16, time_dim=32, depth=2, cond_in_ch=5,
                 use_selfcond=True)
    m_gpu = UNet1D(**small, device="cuda")
    randomize_(torch, m_gpu, 3)
    m_cpu = UNet1D(**small, device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in m_gpu.state_dict().items()})
    cfg_small, _, n_steps = serving_config(schedule, 3)
    rng = np.random.default_rng(4)
    cond_s = rng.standard_normal((2, 5, 512)).astype(np.float32)
    sig_s = np.array([1.0, 3.0], np.float32)
    z = torch.randn(4, 1, 512, generator=torch.Generator().manual_seed(5))
    kw = dict(sampler="ddim", avg_seeds=2, amp_calib="mf")
    reset_launch_counts()
    out_g = build_serving_fn(schedule, cfg_small, device="cuda", **kw)(
        m_gpu, cond_s, sig_s, 0, noise=FixedNoise(z)).cpu()
    small_launches = check_launches(
        launch_counts, expected_launches(m_gpu, n_steps), "small serving run")
    out_c = build_serving_fn(schedule, cfg_small, device="cpu", **kw)(
        m_cpu, cond_s, sig_s, 0, noise=FixedNoise(z))
    rel_small = float((out_g - out_c).abs().max() / out_c.abs().max())
    emit({"phase": "serving_small_vs_cpu", "rows": 8, "L": 512, "steps": 3,
          "launches": small_launches, "max_rel_err": rel_small,
          "tol": MODEL_TOL})
    check(rel_small <= MODEL_TOL, f"serving GPU vs CPU rel err {rel_small}")


def phase_serving(torch, config):
    """One main path at full width in bf16: the launches of one run, five
    timed runs, one profiled run."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models.unet import UNet1D
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.schedules import (
        make_schedule,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.serving import (
        build_serving_fn,
    )

    path = PATHS[config]
    L, seeds = path["L"], path["seeds"]
    schedule = make_schedule(1000, "cosine")
    cfg, sampler, n_steps = serving_config(schedule, SERVING_STEPS)
    model = UNet1D(**path["model"], dtype=torch.bfloat16, device="cuda")
    randomize_(torch, model, 6)
    fn = build_serving_fn(schedule, cfg, sampler=sampler, avg_seeds=seeds,
                          avg_mode="mean", amp_calib="mf", device="cuda")
    rng = np.random.default_rng(7)
    cond = np.empty((SERVING_REQUESTS, 5, L), np.float32)
    cond[:, 0] = rng.standard_normal((SERVING_REQUESTS, L))
    cond[:, 1:] = rng.uniform(0.0, 1.0, (SERVING_REQUESTS, 4, 1))
    sigmas = rng.uniform(0.5, 2.0, SERVING_REQUESTS).astype(np.float32)

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(model, cond, sigmas, 0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = check_launches(launch_counts, expected_launches(model, n_steps),
                              f"serving phase {config}")
    check(tuple(out.shape) == (SERVING_REQUESTS, L), f"shape {out.shape}")
    check(bool(torch.isfinite(out).all()), "serving output finite")

    torch.cuda.reset_peak_memory_stats()
    runs = []
    for seed in range(1, 1 + SERVING_TIMED_RUNS):
        t0 = time.perf_counter()
        out2 = fn(model, cond, sigmas, seed)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(out2).all()), "timed serving output finite")
    steady_s = float(np.median(runs))

    # one more run under the profiler: where the device time goes
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(model, cond, sigmas, 99)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    trace = TRACES / f"serving_{config}_trace.json"
    TRACES.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    breakdown = device_breakdown(trace, wall_us)
    check(breakdown["n_device_events"] > 0, "profiler recorded device work")
    k2_seen = breakdown["k2_launches_by_kernel"]
    want_k2 = expected_launches(model, n_steps)["flash_attention"]
    check(sum(k2_seen.values()) == want_k2,
          f"{config}: the trace holds {k2_seen}, not {want_k2} K2 launches")
    check(all("flash_fwd_wgmma" in name for name in k2_seen),
          f"{config}: K2 left the wgmma route: {k2_seen}")
    rows = SERVING_REQUESTS * seeds * (2 if cfg.cfg_scale != 1.0 else 1)
    check(rows == path["rows"], f"{config}: {rows} rows per forward")
    emit({"phase": "serving", "config": f"{config} bf16", "L": L,
          "requests": SERVING_REQUESTS, "avg_seeds": seeds,
          "rows_per_forward": rows, "sampler": sampler, "ladder": cfg.ladder,
          "steps": cfg.steps, "steps_recipe": 50,
          "steps_cut": "50 -> 10 to bound the run's time",
          "ladder_steps": n_steps, "launches": launches,
          "first_run_s": first_s, "timed_runs": len(runs),
          "seconds": steady_s, "seconds_min": min(runs),
          "seconds_max": max(runs),
          "requests_per_s": SERVING_REQUESTS / steady_s,
          "ms_per_step": 1e3 * steady_s / n_steps,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "out_abs_max": float(out.abs().max())})
    emit({"phase": "serving_profile", "config": f"{config} bf16",
          "profiled_runs": 1, "trace": str(trace.relative_to(TRACES.parent)),
          **breakdown})
    return launches


def kernels_line(k1, k2, launches):
    """The ``kernels`` record: K1 summed over the 7 ConvBlocks of one forward
    of each main path at its serving batch, K2 at attn16k's serving shape;
    launches summed over the two main-path serving runs."""
    k1_paths = {}
    for config, path in PATHS.items():
        recs = [r for r in k1 if r["config"] == config
                and r["dtype"] == "bfloat16" and r["rows"] == path["rows"]]
        k1_paths[config] = {
            key: sum(r[key] for r in recs)
            for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                        "two_pass_floor_ms")}
        k1_paths[config]["ops_bound_ms"] = sum(
            r["bound_ms"] for r in recs if r["bound_by"] == "operations")
        k1_paths[config]["max_abs_err"] = max(r["max_abs_err"] for r in recs)
    k1_total = {key: sum(p[key] for p in k1_paths.values())
                for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                            "ops_bound_ms", "two_pass_floor_ms")}
    main = next(r for r in k2 if r["dtype"] == "bfloat16"
                and (r["B"], r["H"], r["L"], r["D"]) == (32, 4, 4096, 64))
    pkg = "diffusion_models_for_gravitational_waveform_reconstruction_tpu"
    return {"kernels": [
        {"name": "conv_gn_silu", "route": "cuda",
         "source": f"{pkg}_torch/csrc/conv_gn_silu.cu",
         "replaces": f"{pkg}/ops/pallas/fused.py:87",
         "launches": sum(n["conv_gn_silu"] for n in launches.values()),
         "launches_by_path": {c: n["conv_gn_silu"]
                              for c, n in launches.items()},
         "max_abs_err": max(p["max_abs_err"] for p in k1_paths.values()),
         "ms": k1_total["kernel_ms"], "plain_ms": k1_total["plain_ms"],
         "bound_ms": k1_total["bound_ms"],
         "bound_by": ("operations" if k1_total["ops_bound_ms"]
                      > k1_total["bound_ms"] / 2 else "bytes"),
         "library_ms": k1_total["library_ms"],
         "two_pass_floor_ms": k1_total["two_pass_floor_ms"],
         "by_path": k1_paths,
         "shapes": "the 7 ConvBlocks of one forward of each main path, bf16: "
                   "pn128 at 64 rows, attn16k at 32 rows",
         "phase": "kernel"},
        {"name": "flash_attention", "route": "cuda",
         "source": f"{pkg}_torch/csrc/flash_attention.cu",
         "replaces": f"{pkg}/ops/pallas/attention.py:70",
         "launches": sum(n["flash_attention"] for n in launches.values()),
         "launches_by_path": {c: n["flash_attention"]
                              for c, n in launches.items()},
         "max_abs_err": main["max_abs_err"], "ms": main["kernel_ms"],
         "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
         "bound_by": main["bound_by"], "library_ms": main["library_ms"],
         "cuda_route": main["route"], "tflops": main["tflops"],
         "shapes": "attn16k's bottleneck (32, 4, 4096, 64), bf16",
         "phase": "kernel"}]}


def sass_has_hgmma(path):
    """Count of wgmma instructions (``HGMMA``) in a built library's SASS,
    or "not measured" where the toolkit has no ``cuobjdump``."""
    tool = (Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
            / "cuobjdump")
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        return "not measured"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    return sum("HGMMA" in ln for ln in sass.splitlines())


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models.unet import UNet1D
        from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port's package is not importable: {e}",
              file=sys.stderr)
        return 1

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the plain attention's bf16 p @ v accumulates in f32, as K2 does
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32": False})

    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    hgmma = {n: sass_has_hgmma(_build.library_path(n)) for n in names}
    emit({"phase": "build", "seconds": build_s,
          "built": sorted(logs), "sass_hgmma": hgmma,
          "ptxas": {name: [ln.strip() for ln in log.splitlines()
                           if "entry function" in ln or "Used" in ln
                           or "spill" in ln or "warning" in ln]
                    for name, log in logs.items()}})
    for name in ("conv_gn_silu", "flash_attention"):
        check(hgmma[name] == "not measured" or hgmma[name] > 0,
              f"{name}'s library holds no wgmma (HGMMA) instruction")

    k1 = []
    for config, dtypes_rows in (
            ("pn128", ((torch.bfloat16, 64), (torch.bfloat16, 128),
                       (torch.float32, 128))),
            ("attn16k", ((torch.bfloat16, 32),))):
        path = PATHS[config]
        shapes = convblock_shapes(UNet1D(**path["model"], device="cuda"),
                                  path["L"])
        k1 += phase_kernel(torch, config, shapes, dtypes_rows)
    k2 = phase_kernel_attention(torch)
    phase_model(torch, "pn128", 4, 4096)
    phase_model(torch, "attn16k", 2, 32768)
    phase_serving_small(torch)
    launches = {config: phase_serving(torch, config) for config in PATHS}

    emit(kernels_line(k1, k2, launches))
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
