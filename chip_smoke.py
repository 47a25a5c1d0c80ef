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
             (``HGMMA``) and TMA load (``UTMALDG``) instructions, read with
             ``cuobjdump -sass``, each library's SASS holds; all four
             kernels (K1, K2, K1B, K2B) must have both.
3. kernel  - K1, the fused ConvBlock kernel, against its plain PyTorch
             version at every ConvBlock shape of pn128 (bf16 at 64 rows, the
             serving batch, and 128 rows; f32 at 128 rows) and of attn16k
             (bf16 at 32 rows, its serving batch), at both training paths'
             batches (16 rows; attn16k at L 32768, pn128 at L 8192) and at
             the bench's model; K2, the flash-attention kernel, at attn16k's
             bottleneck (32, 4, 4096, 64) in bf16 (and at L 4000, at the
             training batch of 16 and at the attn16k grid's 72 and 36 rows),
             in f32, and at a ragged L and other head widths.
             Each with its route, TFLOP/s, time, the plain version's, a
             PyTorch yardstick's (``F.conv1d -> F.group_norm -> F.silu``;
             ``F.scaled_dot_product_attention``), the roofline bound
             (``utils/roofline.py``) and the error within the port's
             kernel bars (``tools.bench_kernels.TOL``), each record built
             by ``tools.bench_kernels.conv_row`` / ``attention_row``.
             K1's records also carry the two-pass floor (the bound plus y's
             f32 write and read) and one call's device time split into
             pack / conv / stats / apply (``torch.profiler``).  K1's
             decoder route at each flagship's decoder blocks (its serving
             batch, its cell's rows and the infer batch of 8; without and
             with the conditioning epilogue), against its own arithmetic
             and against the materialised upsample -> concat -> K1, timed
             beside that path, the concatenation, the plain fold, the plain
             version and the library (``tools.bench_kernels.decoder_row``).
             The U-Net's head kernel at each flagship's head (bf16 at its
             serving batch, its cell's rows and the infer batch; pn128's
             cell rows in f32) against its plain version at the
             ``tools.bench_kernels.TOL`` bars and, in bf16, against the
             composition it replaced, timed between CUDA events and on the
             device beside both, with the bound
             (``tools.bench_kernels.head_row``).
3b. kernel_backward - K1B and K2B, the backward kernels, against their
             plain backwards on the inputs in f32 at every training path's
             shapes in bf16 (attn16k's 7 ConvBlocks at 16 rows and its
             attention (16, 4, 4096, 64), K2B also at D 128; a
             tensor-parallel rank's shares of them, K2B at 2 heads;
             pn128's gw-train at L 8192; the
             distillation student at 16 rows, L 4096; after the data
             phase, the streaming train's other bucket lengths) and in f32
             at one shape each: one launch a call, two calls bit-equal,
             every gradient within ``tools.bench_kernels.GRAD_TOL``; the
             kernel's, the plain backward's and the library backward's
             times (autograd of ``F.conv1d -> F.group_norm -> F.silu``;
             SDPA's backward) and the bound (``conv_backward_row`` /
             ``attention_backward_row``); K2B's time split by kernel (the
             LSE pass, dK / dV, dQ; ``split_ms``).
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
6. infer   - the ``gw-infer`` path on each flagship: a bf16 checkpoint
             written by the port's own writer (seeded random weights, EMA
             weights apart from the raw ones) into a temporary directory,
             ``load_model`` on the card (the EMA weights checked), a
             synthetic chirp in noise coloured by the aLIGO design PSD
             (pn128: fs 4096, L 4096; attn16k: fs 16384, L 32768),
             float64 model-PSD whitening, ``reconstruct`` (DDIM, 't'
             ladder, 10 steps, 4 seeds x CFG = 8 rows per forward, MF
             amplitude calibration, per-step diagnostics), de-whitening
             and the metrics; each stage timed, the reconstruction timed
             as the median of 3 after a warm-up (and 3 more without the
             diagnostics), one run profiled.  Then
             the infer CLI in-process on the same checkpoint with
             ``--input-npy``.  Launches counted in both runs; a small f32
             configuration of ``reconstruct`` is checked against the CPU
             plain path.
7. op_overhead - host time of one launch of each kernel, K1B and K2B
             too, and of K1's decoder route: its launch body alone, its
             registered op called directly, and the public wrapper; what
             the registration adds.
8. export  - per flagship, the serving artifact: ``export_sampler`` on the
             card from the infer phase's checkpoint (serving batch and
             knobs; export time, ``.pt2`` size, the ops in its graph),
             ``load_exported`` in this process and in a fresh one, each
             replay bit-equal to ``build_serving_fn`` at the same seed, the
             launches of one replay (K1 7 x 9, attn16k's K2 9, all
             ``flash_fwd_wgmma`` in a profiled replay), the artifact's
             latency against the live function's (median of 5 each, in
             turns), ``validate_export``, ``tools/bench_serving``, and
             ``gw-serve`` in batch mode (6 requests, one chunk padded) and
             over HTTP on an ephemeral port (a POST, ``/contract``,
             ``/healthz``, a wrong shape answered 400 with the server
             alive).  Then the pod-serving artifact (``pod_serving``):
             pn128 exported with ``dp=2`` in f32 and bf16 (64 rows a
             forward over the two ranks, 10 steps), replayed on two gloo
             ranks sharing the card and held against the dp = 1 artifact
             of the same checkpoint on the same batch and seed (f32 within
             the model bar, bf16 reported), launches and times per rank.
9. autograd - a grad-enabled CUDA forward launches both kernels (counted)
             and backpropagates through the backward kernels K1B and K2B
             (counted).
10. train  - attn16k training at full width (base_ch 64, depth 3,
             attention, v-prediction, bf16) through ``train(cfg,
             dataset=...)`` on 64 segments of L 32768 synthesised on the
             card, batch 16: a counted run with self-conditioning on every
             step (K1 14, K2 2, K1B 7 and K2B 1 launches a step), a timed
             run with the recipe's knobs (the trainer's samples/s and MFU,
             ms per step, peak memory) and one profiled window split into
             K1 / K2 forward, K1B / K2B (each op's backward range, which
             must hold only the kernel's own kernels: no aten kernel, no
             plain backward), the rest of the backward,
             the rest of the forward, the optimizer with EMA and gate, and
             idle; then one step's gradients at full width on 4 rows with
             injected t and eps, kernel path against plain path (f32
             gradients, bf16 loss); then ``gw-train --data synth:32`` at
             pn128 width in-process (the loss falls over 40 epochs, the
             checkpoint goes through ``load_model`` and the infer CLI, a
             ``--resume`` continues its global step).
11. evals  - the sweep and the mass grid on ``.npz`` corpora synthesised on
             the card with the port's ``data/synth.py`` (3.5PN chirps in
             aLIGO-coloured noise, the model PSD's grid scalars; m1 and m2
             on a 3 x 3 grid from 20 to 50 Msun, SNR 8 to 30; pn128: fs
             4096, L 4096, 4 a cell; attn16k: fs 16384, L 32768, 2 a cell),
             from the infer phase's checkpoints: a small f32 ``eval_combo``
             and chunked ``eval_indices`` against the CPU plain path;
             ``gw-sweep --grid`` (2 SNR x 2 cfg at 10 steps, 4 indices, the
             gate on 8) and a random-mode sweep (4 draws, top 2, 2 seeds) on
             pn128; ``gw-grid --from-sweep`` on all 36 pn128 samples (2
             seeds, MF calibration); ``gw-grid`` on attn16k (2 seeds, 10
             steps) forced into 2 chunks, with the automatic cap, and once
             profiled (K2 all ``flash_fwd_wgmma``); every artifact checked,
             launches counted per run.
12. distill - one distillation step's f32 gradients at pn128 width, kernel
             against plain path; ``gw-distill`` from the train phase's
             gw-train checkpoint on the pn128 corpus (8 -> 4 -> 2, 2 epochs,
             batch 16; K1 7 x 3 a step), a profiled window split into the
             teacher's forwards, the student's forward, the backward and the
             optimizer; ``gw-grid`` on the 2-step student (2 steps, CFG
             folded); ``gw-soup`` of the two stage students (the float64
             mean, read by ``load_model``).
13. bench  - the port's ``bench.py`` (its own JSON line printed as it is)
             and ``graft_entry.entry()``, each with K1's launches.
14. parallel - data parallelism and sequence tiling at attn16k's width:
             (a) a one-process NCCL group, two training steps (batch 16,
             L 32768, bf16) through ``train(mesh=make_mesh())`` against the
             same steps without a mesh; (c) a 64 s segment at 16384 Hz
             (L 2^20) through ``reconstruct(tiled_chunk=16384)``: 64 tiles
             of 16880 samples x CFG = 128 rows a forward, K2 at (128, 4,
             2110, 64), 10 steps, launches (K1 7 and K2 1 a forward), wall
             and device time, peak memory, K2's kernel by name; one tiled
             forward against the monolithic one (K2 at (2, 4, 131072, 64)),
             and the same without attention, on the measurement and on
             stationary noise;
             the infer CLI with ``--tiled-chunk 16384``; (b) two ranks
             sharing the card in a gloo group (NCCL takes one rank a
             device): one f32 step at global batch 16 (8 rows a rank,
             injected t and eps) against the single-process step, timed
             and profiled bf16 steps with the all-reduce's time, a NaN in
             rank 1's rows refused on both; (d) on those ranks, in f32,
             ``reconstruct_batch(mesh=)`` (16 rows) and ``tiled_apply(
             mesh=)`` over 3 tiles against their calls without a mesh;
             (e) ``parallel_tp``: (b) and (d) again on a 1x2
             tensor-parallel mesh (each rank all 16 rows, K1 on half of
             each block's output channels with 4 groups, K2 on 2 of the 4
             heads; weights with a non-zero ``proj``), with the
             collectives' time from the profile, each rank's peak memory
             and K1 / K2 launches by shape; then
             ``dryrun_multichip(2, device="cuda")``, now a 1x2
             tensor-parallel step and a dp = 2 pod artifact, and K1 at its
             shard shapes.  The ranks record their launched shapes for
             the launched_shapes phase.
15. data   - the data side through the CLIs in-process: gw-gen of the
             README quickstart corpus as written (grid, 2000 samples, 10-90
             Msun, spins +-0.8, SNR 8-30, fs 4096, every PSD saved, PN
             engine) to a ragged ``.npz`` twin, a 16 kHz corpus (random,
             256 samples, 20-50 Msun, buckets to 65536) and a low-mass
             top-up (random, 256, 10-20 Msun), each with its stage times,
             samples/s, buckets and peak device memory; gates on each: every
             row's matched-filter SNR (float64 numpy) within 1e-3 of its
             column, the noise whitened by the model PSD at sqrt(fs / 2);
             the card's Welch PSDs against ``scipy.signal.welch`` on 64
             rows; a chunk synthesised on the card against the CPU from the
             same draws (the quickstart's most common bucket and both
             corpora's 65536-sample buckets, each gated); gw-merge of the quickstart
             and the top-up; the streaming batches bit-equal to the dense
             loader's with shuffle off; gw-train --streaming on the merged
             corpus at pn128 width (bf16, batch 16, chunks of 256, model
             whitening, 2 epochs: samples/s, the bytes copied to the card a
             epoch, ``peak_live_samples``, K1's launches); gw-infer on its
             index 0.
16. tools  - the port's twins of the repo's Python tools:
             ``tools.bench_population`` at its defaults (BASELINE.json
             config 5: B 256, L 4096, 100 DDIM steps, cfg 1.5, base_ch 64,
             bf16: K1 at 512 rows x 4096 a forward; its JSON line, K1's
             launches, one population profiled, peak memory) and a small
             f32 population (B 4, L 512, 3 steps) against the CPU plain
             path; every ``tools.bench_kernels`` section at the root tool's
             shapes (K1 f32 and bf16; K1's decoder route against
             upsample -> concat -> K1; K2 f32 and bf16; the attention U-Net kernel path
             against plain path, K2 at (64, 4, 512, 64), held in f32
             within the model bar; the HBM stream), each kernel row within
             the port's kernel bars; the glitch and spin
             harnesses on the evals phase's pn128 checkpoint and corpus (cut
             to 10 steps and 2 seeds; the glitch-SNR-0 level against a
             direct ``reconstruct_batch`` on the same draws, the spin gap 0
             on the corpus's zero spins); ``tools.pn_fidelity`` on the card
             and on the CPU (the mismatch table within 1e-6); and
             ``tools.merge_h5`` over the data phase's two corpora,
             byte-equal to gw-merge's file.
17. launched_shapes - every shape each kernel (K1B, K2B and the head too) was
             launched at from phase 4 on (recorded by wrapping the ops' launch bodies; the
             op_overhead phase and the attention model's monolithic
             forward of phase 14, whose K2 shape has no plain version that
             fits the card, are not recorded) that phase 3 did not check, held against its plain
             version in the same way; the coverage, and K1's time summed
             over the blocks of each forward shape (rows and length) of
             each evals, distill, parallel, data and tools run; the
             head's per shape and run.
18. kernels - one ``{"kernels": [...]}`` line (K1, K2, the head, K1B,
             K2B, each with its launches by main path), then the last line
             ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero.  Without a CUDA
device, or without the port's package beside it, it exits non-zero before
printing any result.
"""
import contextlib
import copy
import functools
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

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
# the training paths: attn16k through train() at the trainer's default batch
# of 16 on 64 synthetic 16 kHz segments (4 steps an epoch); gw-train at
# pn128 width on --data synth:32, whose segments are 8192 samples at 4 kHz
TRAIN_BATCH = 16
TRAIN_SAMPLES = 64
TRAIN_TIMED_STEPS = 10
TRAIN_PROFILED_STEPS = 4
GRAD_ROWS = 4                  # the gradient check's batch, at full width
GRAD_LOSS_TOL_BF16 = 2e-2      # bf16: kernel vs plain forward, a few ulps
                               # per block through 7 blocks, relative loss
CLI_TRAIN_L = 8192
CLI_TRAIN_EPOCHS = 40          # 2 steps an epoch at batch 16: 80 steps
# (config, model, L, rows) of K1's extra checks: the training batches and
# the bench's model.  The shapes of the evals and distill runs are checked
# after those runs, as they launched them (``LaunchShapes``)
K1_EXTRA = [("attn16k train", ATTN16K, 32768, TRAIN_BATCH),
            ("pn128 train cli", FLAGSHIP, CLI_TRAIN_L, TRAIN_BATCH)]
# K2's rows on the attn16k grid: 18 samples x 2 seeds x CFG
ATTN16K_GRID_ROWS = 18 * 2 * 2
# (dtype, B, H, L, D): attn16k's bottleneck in bf16 (the serving shape, the
# serving batch at a ragged L, and the infer batch of 8 rows) and f32, a ragged L, each head-width
# template (D 32, 64, 128, 256; D 128 at a ragged L too) and an odd D, whose
# rows are not 16-byte aligned
K2_SHAPES = [("bfloat16", 32, 4, 4096, 64), ("bfloat16", 32, 4, 4000, 64),
             ("bfloat16", 8, 4, 4096, 64), ("float32", 8, 4, 4096, 64),
             ("bfloat16", 8, 4, 4000, 64), ("float32", 2, 4, 4000, 64),
             ("bfloat16", 8, 4, 4096, 32), ("bfloat16", 8, 4, 4096, 128),
             ("bfloat16", 8, 4, 4000, 128),
             ("float32", 2, 4, 4096, 32), ("float32", 2, 4, 4096, 128),
             ("bfloat16", 2, 2, 777, 65), ("float32", 2, 2, 777, 65),
             ("bfloat16", 2, 4, 2048, 256), ("float32", 1, 2, 2048, 256),
             ("bfloat16", TRAIN_BATCH, 4, 4096, 64),
             ("bfloat16", ATTN16K_GRID_ROWS, 4, 4096, 64),
             ("bfloat16", ATTN16K_GRID_ROWS // 2, 4, 4096, 64)]
MODEL_TOL = 1e-3   # f32, max-abs normalised, summation order through 7 blocks
# the infer phase: the 200-step default of plain checkpoints, cut to bound
# the run's time; 4 seeds x CFG = 8 rows per forward
INFER_STEPS = 10
INFER_SEEDS = 4
INFER_ROWS = 2 * INFER_SEEDS
INFER_TIMED_RUNS = 3
INFER_FS = {"pn128": 4096.0, "attn16k": 16384.0}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(torch, fn, reps):
    """Mean device time of ``fn`` in ms over ``reps`` calls after a warm-up,
    from CUDA events (``tools.bench_kernels.time_ms``)."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools.bench_kernels import (
        time_ms,
    )

    return time_ms(fn, torch.device("cuda"), reps)


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


# K2B's kernels: the log-sum-exp pass, dK / dV, dQ
K2B_PASSES = {"pre": "flash_bwd_pre", "dkdv": "flash_bwd_dkdv",
              "dq": "flash_bwd_dq"}


def split_ms(torch, fn, passes, reps=3):
    """Device ms of one call of ``fn`` by pass (``passes``: name -> kernel
    name fragment), from ``torch.profiler`` over ``reps`` calls; "not
    measured" when the profiler saw no kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = dict.fromkeys(passes, 0.0)
    for e in prof.key_averages():
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0.0))
        for part, key in passes.items():
            if key in e.key:
                split[part] += us / reps / 1e3
    if not any(split.values()):
        return "not measured"
    return split


def epilogue_args(torch, epilogue, rows, L, Cout, dtype, g):
    """K1's epilogue arguments for ``epilogue`` ("none", "film" or
    "cond<K>", as ``LaunchShapes`` names them): FiLM's [gamma | beta] and
    for "cond<K>" the conditioning r (rows, L, K), its first row zero as
    the unconditional row of a CFG batch, and its Dense's Wc and bc."""
    if epilogue == "none":
        return {}
    cuda = dict(generator=g, device="cuda")
    film = (0.3 * torch.randn(rows, 2 * Cout, **cuda)).to(dtype)
    if epilogue == "film":
        return {"film": film}
    K = int(epilogue[len("cond"):])
    r = torch.randn(rows, L, K, **cuda)
    r[0] = 0.0
    return {"film": film, "r": r.to(dtype),
            "Wc": torch.randn(K, Cout, **cuda) / K ** 0.5,
            "bc": 0.1 * torch.randn(Cout, **cuda)}


def path_epilogue(config):
    """The epilogue K1 carries on main path ``config``, whose forwards
    autograd does not record: the conditioning bias and FiLM."""
    return f"cond{PATHS[config]['model']['cond_in_ch']}"


def phase_kernel(torch, config, shapes, dtypes_rows, groups=8,
                 epilogues=("none",)):
    """K1 at each (name, L, Cin, Cout) for each (dtype, rows) and each of
    ``epilogues`` (``epilogue_args``): the row of
    ``tools.bench_kernels.conv_row`` (kernel, plain and cuDNN times, the
    bound, the error within the port's bars; with an epilogue, its inputs'
    bytes in the bound and the error against the same steps in f32 and
    against the plain composition) plus the split by pass and the floor of
    a two-pass kernel (its f32 y written and read once more)."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools.bench_kernels import (
        conv_row,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        fused_conv_gn_silu,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.roofline import (
        bound_ms,
    )

    kind = torch.cuda.get_device_name(0)
    results = []
    for dtype, rows in dtypes_rows:
        dname = str(dtype).split(".")[1]
        for (name, L, Cin, Cout), epilogue in itertools.product(shapes,
                                                                epilogues):
            G = groups
            g = torch.Generator(device="cuda").manual_seed(L + Cin + Cout)
            x = torch.randn(rows, L, Cin, generator=g, device="cuda").to(dtype)
            W = torch.randn(3, Cin, Cout, generator=g, device="cuda") / (3 * Cin) ** 0.5
            b, s, bb = (0.1 * torch.randn(Cout, generator=g, device="cuda")
                        for _ in range(3))
            s = s + 1.0
            epi = epilogue_args(torch, epilogue, rows, L, Cout, dtype, g)
            row = conv_row(x, W, b, s, bb, G, reps=5, plain_reps=3, **epi)
            split = split_ms(
                torch, lambda: fused_conv_gn_silu(x, W, b, s, bb, G, **epi),
                K1_PASSES)
            y_bytes = 8 * rows * L * Cout      # y written and read in f32
            rec = {"phase": "kernel", "kernel": "conv_gn_silu",
                   "config": config, "block": name, "rows": rows, "L": L,
                   "Cin": Cin, "Cout": Cout, "groups": G,
                   "epilogue": epilogue, **row,
                   "two_pass_floor_ms": bound_ms(
                       row["gflop"] * 1e9, row["mbytes"] * 1e6 + y_bytes,
                       kind, dname)[0],
                   "split_ms": split}
            emit(rec)
            results.append(rec)
            check(row["within_tol"],
                  f"conv_gn_silu {config} {name} {dname} rows={rows} "
                  f"epilogue {epilogue}: {row['n_outside_tol']} outputs "
                  f"outside rtol={row['rtol']} atol={row['atol']}, "
                  f"{row.get('n_outside_plain_tol', 0)} outside the plain "
                  f"composition's bar")
            del x, W, epi
            torch.cuda.empty_cache()
    return results


def decoder_shapes(model, L):
    """(name, L, C_h, C_s, Cout) of every decoder block of ``model`` at
    input length L, the skip's length and channels (C_s = Cout)."""
    return [(name, n, Cin - Cout, Cout, Cout)
            for name, n, Cin, Cout in convblock_shapes(model, L)
            if name.startswith("dec")]


def phase_kernel_decoder(torch, config, shapes, rows, epilogues=("none",),
                         reps=5):
    """K1's decoder route at each (name, L, C_h, C_s, Cout), bf16, ``rows``
    rows, for each of ``epilogues``: the row of
    ``tools.bench_kernels.decoder_row`` (the route against its arithmetic
    at the K1 bars and against the materialised upsample -> concat -> K1;
    with ``reps``, its time beside the materialised path's, the
    concatenation's, the plain fold's, the plain version's and cuDNN's, and
    the bound) plus its split by pass and, as ``phase_kernel``'s, the
    two-pass floor."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models.unet import (
        ConvBlock,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        fused_conv_gn_silu,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools.bench_kernels import (
        decoder_row,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.roofline import (
        bound_ms,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import (
        randomize_,
    )

    kind = torch.cuda.get_device_name(0)
    results = []
    for (name, L, Ch, Cs, Cout), epilogue in itertools.product(shapes,
                                                              epilogues):
        g = torch.Generator(device="cuda").manual_seed(L + Ch + Cs + Cout)
        h = torch.randn(rows, L // 2, Ch, generator=g,
                        device="cuda").bfloat16()
        skip = torch.randn(rows, L, Cs, generator=g, device="cuda").bfloat16()
        block = ConvBlock(Ch + Cs, Cout, "cuda")
        randomize_(block, L + Cout)
        block.requires_grad_(False)      # a recorded call leaves the route
        epi = epilogue_args(torch, epilogue, rows, L, Cout, torch.bfloat16, g)
        row = decoder_row(h, skip, block, reps=reps, plain_reps=3, **epi)
        rec = {"phase": "kernel_decoder", "kernel": "conv_gn_silu_decoder",
               "config": config, "block": name, "rows": rows, "L": L,
               "Ch": Ch, "Cs": Cs, "Cout": Cout, "groups": block.groups,
               **row}
        if reps > 0:
            rec["two_pass_floor_ms"] = bound_ms(
                row["gflop"] * 1e9, row["mbytes"] * 1e6 + 8 * rows * L * Cout,
                kind, "bfloat16")[0]
            rec["split_ms"] = split_ms(
                torch, lambda: fused_conv_gn_silu(
                    h, block.conv.kernel, block.conv.bias, block.norm.scale,
                    block.norm.bias, block.groups, skip=skip, **epi),
                K1_PASSES)
        emit(rec)
        results.append(rec)
        check(row["within_tol"],
              f"conv_gn_silu decoder route {config} {name} rows={rows} "
              f"epilogue {epilogue}: {row['n_outside_tol']} outputs outside "
              f"the K1 bars, {row['n_outside_materialised_tol']} outside "
              f"the materialised path's")
        del h, skip, block, epi
        torch.cuda.empty_cache()
    return results


def head_shape(model, L):
    """(L_h, C, L0, C_in) of ``model``'s head at input length L: the last
    decoder block's output and the network input, of one length."""
    return L, model.final.kernel.shape[1] - 1, L, model.in_ch


def phase_kernel_head(torch, config, key, reps=5):
    """The head kernel at ``key`` (dtype, rows, L_h, C, L0, C_in), seeded
    inputs and weights: the row of ``tools.bench_kernels.head_row`` (the
    kernel against its plain version at the ``TOL`` bars and, in bf16,
    against the composition it replaced; with ``reps``, its time between
    CUDA events and on the device beside the plain version's and the
    composition's, and the bound from these inputs)."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools.bench_kernels import (
        head_row,
    )

    dname, rows, Lh, C, L0, Cin = key
    g = torch.Generator(device="cuda").manual_seed(rows + Lh + C)
    dtype = getattr(torch, dname)
    h = torch.randn(rows, Lh, C, generator=g, device="cuda").to(dtype)
    x = torch.randn(rows, L0, Cin, generator=g, device="cuda").to(dtype)
    W = torch.randn(3, C + 1, 1, generator=g, device="cuda") / (3 * (C + 1)) ** 0.5
    b = 0.1 * torch.randn(1, generator=g, device="cuda")
    row = head_row(h, x, W, b, reps=reps, plain_reps=3)
    rec = {"phase": "kernel_head", "kernel": HEAD, "config": config,
           "rows": rows, "Lh": Lh, "C": C, "L0": L0, "Cin": Cin, **row}
    emit(rec)
    check(row["within_tol"],
          f"unet_head {config} {key}: {row['n_outside_tol']} outputs "
          f"outside rtol={row['rtol']} atol={row['atol']}, "
          f"{row.get('n_outside_composition_tol', 0)} outside the "
          f"composition's bar")
    del h, x
    torch.cuda.empty_cache()
    return rec


def phase_kernel_heads(torch):
    """``phase_kernel_head`` at the flagships' serving batch, their cells'
    rows (pn128 128, attn16k 64) and the infer batch in bf16, and at
    pn128's cell rows in f32."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models.unet import UNet1D

    kh = []
    for config, dtypes_rows in (
            ("pn128", (("bfloat16", 64), ("bfloat16", 128),
                       ("bfloat16", INFER_ROWS), ("float32", 128))),
            ("attn16k", (("bfloat16", 32), ("bfloat16", 64),
                         ("bfloat16", INFER_ROWS)))):
        path = PATHS[config]
        shape = head_shape(UNet1D(**path["model"], device="cuda"), path["L"])
        kh += [phase_kernel_head(torch, config, (dname, rows, *shape))
               for dname, rows in dtypes_rows]
    return kh


def phase_kernel_attention(torch, shapes=K2_SHAPES):
    """K2 at each (dtype, B, H, L, D): the row of
    ``tools.bench_kernels.attention_row``."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools.bench_kernels import (
        attention_row,
    )

    results = []
    for dname, B, H, L, D in shapes:
        dtype = getattr(torch, dname)
        g = torch.Generator(device="cuda").manual_seed(B * L + D)
        q, k, v = (torch.randn(B, H, L, D, generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
        row = attention_row(q, k, v, reps=20, plain_reps=2)
        rec = {"phase": "kernel", "kernel": "flash_attention", "B": B, "H": H,
               "L": L, "D": D, **row}
        emit(rec)
        results.append(rec)
        check(row["within_tol"],
              f"flash_attention {dname} {(B, H, L, D)}: "
              f"{row['n_outside_tol']} outputs outside rtol={row['rtol']} "
              f"atol={row['atol']}")
        del q, k, v
        torch.cuda.empty_cache()
    return results


def backward_conv_rows(torch, config, blocks, dtype, rows, reps=5):
    """K1B at each (name, L, Cin, Cout, groups) of ``blocks`` for ``rows``
    rows of ``dtype``: the record of ``tools.bench_kernels.
    conv_backward_row`` (one launch a call, two calls bit-equal, every
    gradient within ``GRAD_TOL`` of the plain backward on the inputs in
    f32; with ``reps``, the kernel's, the plain backward's and cuDNN's
    backward times and the bound)."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools.bench_kernels import (
        conv_backward_row,
    )

    results = []
    for name, L, Cin, Cout, G in blocks:
        g = torch.Generator(device="cuda").manual_seed(L + Cin + Cout)
        x = torch.randn(rows, L, Cin, generator=g, device="cuda").to(dtype)
        W = torch.randn(3, Cin, Cout, generator=g, device="cuda") / (3 * Cin) ** 0.5
        b, s, bb = (0.1 * torch.randn(Cout, generator=g, device="cuda")
                    for _ in range(3))
        dout = torch.randn(rows, L, Cout, generator=g, device="cuda").to(dtype)
        row = conv_backward_row(dout, x, W, b, s + 1.0, bb, G, reps=reps,
                                plain_reps=1)
        rec = {"phase": "kernel_backward", "kernel": "conv_gn_silu_backward",
               "config": config, "block": name, "rows": rows, "L": L,
               "Cin": Cin, "Cout": Cout, "groups": G, **row}
        emit(rec)
        results.append(rec)
        check(row["within_tol"],
              f"conv_gn_silu_backward {config} {name} {row['dtype']} "
              f"rows={rows}: {row}")
        del x, dout
        torch.cuda.empty_cache()
    return results


def backward_attention_rows(torch, config, shapes, reps=5):
    """K2B at each (dtype, B, H, L, D) of ``shapes`` with a dout transposed
    as the U-Net hands it back: the record of ``tools.bench_kernels.
    attention_backward_row``, with ``reps`` also one call's device time by
    kernel (``split_ms``: the LSE pass, dK / dV, dQ)."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        flash_attention,
        flash_attention_grad,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools.bench_kernels import (
        attention_backward_row,
    )

    results = []
    for dname, B, H, L, D in shapes:
        dtype = getattr(torch, dname)
        g = torch.Generator(device="cuda").manual_seed(B * L + D + 1)
        q, k, v = (torch.randn(B, H, L, D, generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
        dout = torch.randn(B, L, H, D, generator=g, device="cuda").to(
            dtype).transpose(1, 2)
        row = attention_backward_row(dout, q, k, v, reps=reps, plain_reps=1)
        if reps:
            o = flash_attention(q, k, v)
            row["split_ms"] = split_ms(
                torch, lambda: flash_attention_grad(dout, q, k, v, o),
                K2B_PASSES)
            del o
        rec = {"phase": "kernel_backward",
               "kernel": "flash_attention_backward", "config": config,
               "B": B, "H": H, "L": L, "D": D, **row}
        emit(rec)
        results.append(rec)
        check(row["within_tol"],
              f"flash_attention_backward {config} {(B, H, L, D)}: {row}")
        del q, k, v, dout
        torch.cuda.empty_cache()
    return results


def train_blocks(model_kw, L, n_model=1):
    """(name, L, Cin, Cout, groups) of the ConvBlocks a training step at
    input length L runs K1B on: every block, or with ``n_model`` model
    ranks a rank's shares of the split ones (Cout / n, groups / n)."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models.unet import (
        UNet1D,
        _num_groups,
    )

    model = UNet1D(**model_kw, device="cuda")
    if n_model > 1:
        return [(name, n, cin, cout, _num_groups(cout * n_model) // n_model)
                for name, n, cin, cout in tp_shard_shapes(model, L, n_model)]
    return [(name, n, cin, cout, _num_groups(cout))
            for name, n, cin, cout in convblock_shapes(model, L)]


def phase_kernel_backward(torch):
    """K1B and K2B against their plain backwards on the card at every
    training path's shapes, bf16: attn16k's training batch (7 ConvBlocks,
    K2B at (16, 4, 4096, 64), and at D 128), a tensor-parallel rank's
    shares of it (K2B at 2 heads), pn128's gw-train at L 8192 and the
    distillation student (16 rows, L 4096); in f32 at one shape each
    (attn16k's mid block and its attention at the f32 gradient check's
    rows).  The streaming
    train's other bucket lengths come after the data phase.  Returns K1B's
    and K2B's records."""
    bf = torch.bfloat16
    kb1, kb2 = [], []
    for config, model_kw, L, rows, n_model in (
            ("attn16k train", ATTN16K, 32768, TRAIN_BATCH, 1),
            ("attn16k train tp share", ATTN16K, 32768, TRAIN_BATCH, 2),
            ("pn128 train cli", FLAGSHIP, CLI_TRAIN_L, TRAIN_BATCH, 1),
            ("pn128 distill student", FLAGSHIP, 4096, DISTILL_BATCH, 1)):
        kb1 += backward_conv_rows(torch, config,
                                  train_blocks(model_kw, L, n_model), bf,
                                  rows)
    mid = [b for b in train_blocks(ATTN16K, 32768) if b[0] == "mid"]
    kb1 += backward_conv_rows(torch, "attn16k f32", mid, torch.float32,
                              GRAD_ROWS)
    kb2 += backward_attention_rows(torch, "attn16k train",
                                   [("bfloat16", TRAIN_BATCH, 4, 4096, 64)])
    kb2 += backward_attention_rows(torch, "D 128",
                                   [("bfloat16", TRAIN_BATCH, 4, 4096, 128)])
    kb2 += backward_attention_rows(torch, "attn16k train tp share",
                                   [("bfloat16", TRAIN_BATCH, 2, 4096, 64)])
    kb2 += backward_attention_rows(torch, "attn16k f32",
                                   [("float32", GRAD_ROWS, 4, 4096, 64)])
    return kb1, kb2


def decoder_routes(model):
    """The decoder blocks of ``model`` that take K1's decoder route in a
    forward autograd does not record, as ``takes_decoder_route`` answers
    for each block's h and skip (meta tensors in the model's dtype; every
    length here halves evenly at every stage)."""
    import torch

    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        takes_decoder_route,
    )

    dtype = model.dtype or torch.float32
    routes = 0
    for i in range(model.depth):
        _, cin, cout = getattr(model, f"dec{i}").conv.kernel.shape
        h = torch.empty((1, 1, cin - cout), dtype=dtype, device="meta")
        skip = torch.empty((1, 2, cout), dtype=dtype, device="meta")
        routes += takes_decoder_route(h, skip)
    return routes


@functools.lru_cache(maxsize=None)
def _route_share(model_items):
    import torch

    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models.unet import UNet1D

    model = UNet1D(**dict(model_items), dtype=torch.bfloat16, device="cpu")
    return decoder_routes(model), 2 * model.depth + 1


def route_share(model_kw):
    """(decoder blocks on K1's decoder route, K1 launches) of a bf16
    forward, autograd not recording, of the U-Net of ``model_kw``."""
    return _route_share(tuple(sorted(model_kw.items())))


def expected_launches(model, forwards, backwards=0):
    """K1 once per ConvBlock per forward, K2 once per forward with
    attention; K1B and K2B likewise per backward.  The forwards without a
    backward are the no-grad ones, whose K1 launches carry the
    conditioning epilogue and, for ``decoder_routes`` of the decoder
    blocks, take K1's decoder route."""
    blocks = 2 * model.depth + 1
    return {"conv_gn_silu": blocks * forwards,
            "flash_attention": forwards if model.use_attention else 0,
            "conv_gn_silu_backward": blocks * backwards,
            "flash_attention_backward": (backwards if model.use_attention
                                         else 0),
            EPILOGUE: blocks * (forwards - backwards),
            DECODER: decoder_routes(model) * (forwards - backwards),
            HEAD: forwards - backwards}


KERNEL_NAMES = ("conv_gn_silu", "flash_attention", "conv_gn_silu_backward",
                "flash_attention_backward")
# the count of K1's launches that carried the conditioning epilogue, and
# of those on K1's decoder route (parts of K1's count, not kernels of
# their own)
EPILOGUE = "conv_gn_silu_epilogue"
DECODER = "conv_gn_silu_decoder"
# the U-Net's head kernel: once a forward that autograd does not record
HEAD = "unet_head"


def all_counts(want, model=None):
    """``want`` with every kernel it does not name at 0 launches: serving,
    export and replay runs must launch no backward kernel.  Where ``want``
    does not name the epilogue's count, it is K1's launches less K1B's: a
    forward that autograd records has its backward, and every other
    forward hands each block's bias and FiLM to K1 (a run whose blocks run
    split on a model axis, which keep them apart, names its count).  Where
    it does not name the decoder route's, it is the epilogue's count times
    ``route_share`` of ``model`` (the keyword arguments of the run's bf16
    U-Net; None: no launch on the route): the route is taken on the same
    forwards, by the model's decoder blocks whose widths it takes.  Where
    it does not name the head's, it is the forwards without a backward:
    K1's launches less K1B's over the ConvBlocks of ``model`` (None: of
    ``FLAGSHIP``, whose depth every run that names no model shares)."""
    out = {**dict.fromkeys(KERNEL_NAMES, 0), **want}
    out.setdefault(EPILOGUE, out["conv_gn_silu"]
                   - out["conv_gn_silu_backward"])
    routes = 0 if model is None else route_share(model)[0]
    blocks = 2 * (model or FLAGSHIP)["depth"] + 1
    out.setdefault(DECODER, out[EPILOGUE] * routes // blocks)
    out.setdefault(HEAD, (out["conv_gn_silu"] - out["conv_gn_silu_backward"])
                   // blocks)
    return out


def check_launches(launch_counts, want, what, model=None):
    got, want = launch_counts(), all_counts(want, model)
    check(got == want, f"{what}: launches {got} != {want}")
    return got


def phase_model(torch, config, rows, L):
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import randomize_
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models import unet
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    model = unet.UNet1D(**PATHS[config]["model"], device="cuda")
    randomize_(model, 1)
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(rows, 7, L, generator=g, device="cuda")
    t = torch.tensor([0, 250, 600, 999][-rows:], device="cuda")
    with torch.no_grad():
        reset_launch_counts()
        got = model(x, t)
        launches = check_launches(launch_counts, expected_launches(model, 1),
                                  f"model phase {config}")
        with unet.plain_kernels():
            want = model(x, t)
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
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import randomize_
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
    randomize_(m_gpu, 3)
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
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import randomize_
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
    randomize_(model, 6)
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


def synth_measurement(L, fs, seed, amp=1e-21):
    """A chirp-like clean waveform of peak ``amp`` (merger at 85% of the
    segment, a short ringdown after it) and Gaussian noise coloured by the
    aLIGO design PSD; returns (clean, noise, PSD on the rfft grid), float64."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data.hdf5io import (
        aligo_zdhp_psd_np,
    )

    t = np.arange(L) / fs
    tc = 0.85 * L / fs
    tau = np.maximum(tc - t, 1e-4)
    f = np.minimum(30.0 * (tau / tc) ** (-3.0 / 8.0), 300.0)
    env = np.where(t < tc, (f / 300.0) ** (2.0 / 3.0),
                   np.exp(-np.maximum(t - tc, 0.0) / 0.01))
    clean = amp * env * np.cos(2 * np.pi * np.cumsum(f) / fs)
    freqs = np.fft.rfftfreq(L, 1.0 / fs)
    P = aligo_zdhp_psd_np(freqs)
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(len(freqs)) + 1j * rng.standard_normal(len(freqs))
    noise = np.fft.irfft(z * np.sqrt(P * fs * L / 4.0), n=L)
    return clean, noise, P


def infer_args(model_kw):
    """A bf16 v-prediction PN checkpoint's args, trained in the model-PSD
    domain."""
    return {"in_ch": 7, "cond_in_ch": 5, "base_ch": model_kw["base_ch"],
            "depth": model_kw["depth"], "time_dim": model_kw["time_dim"],
            "use_attention": model_kw.get("use_attention", False), "T": 1000,
            "schedule": "cosine", "pred_type": "v", "bf16": True, "whiten": 1,
            "whiten_mode": "model", "whiten_mode_resolved": "model",
            "sigma_mode": "std", "meta_scale": {"M": 80.0, "q": 10.0}}


def write_checkpoint(model_kw, args, path, seed):
    """Seeded random raw and EMA weights (apart from each other) through the
    port's writer; returns the EMA state_dict."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import randomize_
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models.unet import UNet1D
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.checkpoint import (
        save_checkpoint,
    )

    raw = UNet1D(**model_kw, device="cpu")
    ema = UNet1D(**model_kw, device="cpu")
    randomize_(raw, seed)
    randomize_(ema, seed + 1)
    save_checkpoint(path, raw.state_dict(), args, epoch=1,
                    model_ema_state=ema.state_dict())
    return ema.state_dict()


INFER_META = {"mass1": 36.0, "mass2": 29.0, "spin1z": 0.3, "spin2z": -0.1,
              "q": 36.0 / 29.0, "chirp_mass": 28.1}


def phase_infer_small(torch, tmp):
    """``reconstruct`` on a small f32 checkpoint: the card's path against
    the CPU plain path, with the same injected noise."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import inference
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.sampling import (
        FixedNoise,
        SamplerConfig,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.schedules import (
        build_t_schedule,
    )

    small = dict(in_ch=7, base_ch=16, time_dim=32, depth=2, cond_in_ch=5,
                 use_selfcond=True, t_embed_max_time=999.0)
    path = os.path.join(tmp, "small.msgpack")
    write_checkpoint(small, dict(infer_args(small), bf16=False), path, 8)
    m_gpu, schedule, _ = inference.load_model(path, device="cuda")
    m_cpu, _, _ = inference.load_model(path, device="cpu")
    clean, noise, P = synth_measurement(512, 4096.0, 9)
    prep = inference.prepare_measurement(
        (clean + noise).astype(np.float32), clean.astype(np.float32), 4096.0,
        P, (None, None), INFER_META, cond_in_ch=5, whiten=True,
        whiten_mode="model")
    cfg = SamplerConfig(steps=3, pred_type="v", cfg_scale=1.5)
    z = torch.randn(2, 1, 512, generator=torch.Generator().manual_seed(10))
    kw = dict(avg_seeds=2, amp_calib="mf", collect_diagnostics=True)
    reset_launch_counts()
    _, x_gpu, diag_gpu = inference.reconstruct(m_gpu, schedule, prep, cfg,
                                               FixedNoise(z), device="cuda",
                                               **kw)
    small_launches = check_launches(
        launch_counts, expected_launches(m_gpu, len(build_t_schedule(
            1000, 3, None))), "small infer run")
    _, x_cpu, diag_cpu = inference.reconstruct(m_cpu, schedule, prep, cfg,
                                               FixedNoise(z), device="cpu",
                                               **kw)
    rel = float(np.abs(x_gpu - x_cpu).max() / np.abs(x_cpu).max())
    rel_diag = float(np.abs(diag_gpu["x0_rms"] - diag_cpu["x0_rms"]).max()
                     / np.abs(diag_cpu["x0_rms"]).max())
    emit({"phase": "infer_small_vs_cpu", "rows": 4, "L": 512, "steps": 3,
          "launches": small_launches, "max_rel_err": rel,
          "diag_x0_rms_max_rel_err": rel_diag, "tol": MODEL_TOL})
    check(rel <= MODEL_TOL and rel_diag <= MODEL_TOL,
          f"infer GPU vs CPU rel err {rel}, diagnostics {rel_diag}")


def phase_infer(torch, config, tmp):
    """The gw-infer path at full width in bf16, in-process and through the
    CLI; returns the launches of both runs."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import inference
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import infer as infer_cli
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.evals import metrics
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.sampling import (
        SamplerConfig,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.schedules import (
        build_t_schedule,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )

    path, L, fs = PATHS[config], PATHS[config]["L"], INFER_FS[config]
    args = infer_args(path["model"])
    ckpt = os.path.join(tmp, f"{config}.msgpack")
    t0 = time.perf_counter()
    ema = write_checkpoint(dict(path["model"], t_embed_max_time=999.0),
                           args, ckpt, 11)
    write_s = time.perf_counter() - t0
    # load_model's two stages, each timed on its own: the file read, then
    # the U-Net rebuilt on the card from what was read; then load_model whole
    stages = {}
    t0 = time.perf_counter()
    read = load_checkpoint(ckpt)
    stages["checkpoint_read_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inference.model_from_checkpoint(read, device="cuda")
    torch.cuda.synchronize()
    stages["weights_to_device_s"] = time.perf_counter() - t0
    del read
    t0 = time.perf_counter()
    model, schedule, ck = inference.load_model(ckpt, device="cuda")
    torch.cuda.synchronize()
    stages["load_model_s"] = time.perf_counter() - t0
    sd = model.state_dict()
    check(model.dtype == torch.bfloat16
          and model.use_attention == args["use_attention"],
          f"{config}: load_model built dtype {model.dtype}")
    check(all(torch.equal(sd[k].cpu(), v) for k, v in ema.items()),
          f"{config}: load_model did not take the EMA weights")

    clean, noise, P = synth_measurement(L, fs, 12)
    y = (clean + noise).astype(np.float32)
    t0 = time.perf_counter()
    prep = inference.prepare_measurement(
        y, clean.astype(np.float32), fs, P, (None, None), INFER_META,
        cond_in_ch=5, M_SCALE=80.0, Q_SCALE=10.0, whiten=True,
        whiten_mode="model", sigma_mode="std", ckpt_path=ckpt)
    stages["host_prep_s"] = time.perf_counter() - t0
    check(prep["whiten_kind_used"] == "model", "model-PSD whitening")
    cfg = SamplerConfig(steps=INFER_STEPS, pred_type="v", use_selfcond=True,
                        cfg_scale=1.5, ladder="t")
    n_steps = len(build_t_schedule(1000, INFER_STEPS, None))
    kw = dict(sampler="ddim", avg_seeds=INFER_SEEDS, amp_calib="mf",
              collect_diagnostics=True, device="cuda")

    def run(seed, diagnostics=True):
        g = torch.Generator(device="cuda").manual_seed(seed)
        out = inference.reconstruct(model, schedule, prep, cfg, g,
                                    **dict(kw, collect_diagnostics=diagnostics))
        torch.cuda.synchronize()
        return out

    reset_launch_counts()
    t0 = time.perf_counter()
    x0_raw, x0_white, diag = run(0)
    first_s = time.perf_counter() - t0
    launches = check_launches(launch_counts, expected_launches(model, n_steps),
                              f"infer phase {config}")
    check(x0_raw.shape == (L,) and bool(np.isfinite(x0_raw).all()),
          f"{config}: reconstruction finite, length {L}")
    check(all(len(v) == n_steps for v in diag.values()),
          f"{config}: diagnostics of {n_steps} steps")
    runs = []
    for seed in range(1, 1 + INFER_TIMED_RUNS):
        t0 = time.perf_counter()
        run(seed)
        runs.append(time.perf_counter() - t0)
    stages["reconstruct_s"] = float(np.median(runs))
    # what the per-step diagnostics cost: the same runs without them
    runs_plain = []
    for seed in range(1, 1 + INFER_TIMED_RUNS):
        t0 = time.perf_counter()
        run(seed, diagnostics=False)
        runs_plain.append(time.perf_counter() - t0)

    t0 = time.perf_counter()
    strain = inference.dewhiten_back(x0_white, prep)
    scores = metrics.score_last_window(strain, prep["clean_raw"], fs)
    rho_rec = metrics.matched_filter_snr(strain, prep["clean_raw"], P, fs)
    rho_inj = metrics.matched_filter_snr(prep["clean_raw"], prep["clean_raw"],
                                         P, fs)
    resid = metrics.residual_diagnostics(prep["y_for_cond"], x0_white,
                                         clean_white=prep["clean_for_cond"],
                                         band_mask=prep["P_model_used"] > 0)
    stages["dewhiten_metrics_s"] = time.perf_counter() - t0
    check(np.array_equal(strain, x0_raw), "de-whitening repeats reconstruct's")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(99)
        wall_us = (time.perf_counter() - t0) * 1e6
    trace = TRACES / f"infer_{config}_trace.json"
    TRACES.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    breakdown = device_breakdown(trace, wall_us)
    k2_seen = breakdown["k2_launches_by_kernel"]
    check(sum(k2_seen.values()) == launches["flash_attention"]
          and all("flash_fwd_wgmma" in name for name in k2_seen),
          f"{config}: the infer trace holds K2 launches {k2_seen}")

    # the CLI, in-process, on the same checkpoint and an .npy measurement
    npy = os.path.join(tmp, f"{config}_y.npy")
    np.save(npy, y)
    out = os.path.join(tmp, f"{config}_out")
    log = os.path.join(tmp, f"{config}_steps.jsonl")
    reset_launch_counts()
    t0 = time.perf_counter()
    infer_cli.main(["--input-npy", npy, "--fs", str(fs), "--model", ckpt,
                    "--outdir", out, "--steps", str(INFER_STEPS),
                    "--avg-seeds", str(INFER_SEEDS), "--amp-calib", "mf",
                    "--log-jsonl", log, "--device", "cuda"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_launches = check_launches(launch_counts,
                                  expected_launches(model, n_steps),
                                  f"infer CLI {config}")
    files = sorted(os.listdir(out))
    kinds = [f.split("_")[0] + ("_spread" if "spread" in f else "")
             for f in files]
    check(sorted(kinds) == ["measurement", "metrics", "recon", "recon_spread"],
          f"{config}: CLI artifacts {files}")
    recon = np.load(os.path.join(out, files[kinds.index("recon")]))
    with open(os.path.join(out, files[kinds.index("metrics")])) as fh:
        cli_metrics = json.load(fh)
    with open(log) as fh:
        n_log = len(fh.read().splitlines())
    check(recon.shape == (L,) and bool(np.isfinite(recon).all()),
          f"{config}: CLI reconstruction")
    check({"residuals", "seed_spread"} <= set(cli_metrics),
          f"{config}: CLI metrics keys {sorted(cli_metrics)}")
    check(n_log == n_steps, f"{config}: {n_log} JSONL records")

    rows = INFER_SEEDS * (2 if cfg.cfg_scale != 1.0 else 1)
    check(rows == INFER_ROWS, f"{config}: {rows} rows per forward")
    emit({"phase": "infer", "config": f"{config} bf16", "L": L, "fs": fs,
          "rows_per_forward": rows, "sampler": "ddim", "ladder": cfg.ladder,
          "steps": cfg.steps, "steps_default": 200,
          "steps_cut": "200 -> 10 to bound the run's time",
          "ladder_steps": n_steps, "launches": launches, "used_ema": True,
          "checkpoint_mb": os.path.getsize(ckpt) / 1e6,
          "checkpoint_write_s": write_s, **stages,
          "reconstruct_first_s": first_s, "reconstruct_runs_s": runs,
          "reconstruct_no_diagnostics_s": float(np.median(runs_plain)),
          "ms_per_step": 1e3 * stages["reconstruct_s"] / n_steps,
          "recon_abs_max": float(np.abs(x0_raw).max()),
          "clean_abs_max": float(np.abs(clean).max()),
          "diag_steps": n_steps, "diag_corr_last": float(diag["corr"][-1, 0]),
          **{f"strain_{k}": v for k, v in scores.items()},
          "mf_snr_recovered": rho_rec, "mf_snr_injected": rho_inj,
          "residuals": resid})
    emit({"phase": "infer_profile", "config": f"{config} bf16",
          "profiled_runs": 1, "trace": str(trace.relative_to(TRACES.parent)),
          **breakdown})
    emit({"phase": "infer_cli", "config": f"{config} bf16", "seconds": cli_s,
          "launches": cli_launches, "artifacts": kinds, "jsonl_records": n_log,
          "whiten_kind": cli_metrics["whiten_kind"],
          "seed_spread": cli_metrics["seed_spread"],
          "residuals": cli_metrics["residuals"]})
    return launches, cli_launches


TRAIN_GROUPS = ("k1_forward", "k2_forward", "k1_backward", "k2_backward",
                "rest_of_backward", "rest_of_forward", "optimizer_ema_gate",
                "other")
# the kernels K1B and K2B launch: K1B repeats K1's conv and statistics
# passes (and its weight pack) and adds its own; K2B's are all its own
K1B_KERNELS = K1_KERNELS + ("k1b_",)
K2B_KERNELS = ("flash_bwd_",)
BACKWARD_RANGES = {"gwport::conv_gn_silu_backward": ("k1_backward",
                                                     K1B_KERNELS),
                   "gwport::flash_attention_backward": ("k2_backward",
                                                        K2B_KERNELS)}


def train_split(trace_path, wall_us, steps):
    """Device ms per step of a profiled training window by part: K1's and
    K2's forward kernels, the kernels launched inside each op's backward
    (K1B's, K2B's; ``backward_kernels_ms`` by name, and ``foreign_kernels``
    the names there that are not the kernel's own, which must be none: no
    plain backward on the card), the rest of the backward, the rest of the
    forwards, the optimizer with the EMA and the gate, and anything else
    (the batch gather, the noising); plus the idle share of the wall.  A
    kernel belongs to the innermost ``torch.profiler`` range
    (``train/...``, ``gwport::..._backward``) around the host call that
    launched it."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
              for e in events if e.get("cat") == "user_annotation"
              and (e["name"].startswith("train/")
                   or e["name"].endswith("_backward"))]
    groups = dict.fromkeys(TRAIN_GROUPS, 0.0)
    by_kernel = {"k1_backward": {}, "k2_backward": {}}
    foreign = set()
    for e in dev:
        name, dur = e["name"], float(e["dur"])
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        inside = [r for r in ranges if ts is not None and r[0] <= ts <= r[1]]
        where = min(inside, key=lambda r: r[1] - r[0])[2] if inside else ""
        if where in BACKWARD_RANGES:
            group, own = BACKWARD_RANGES[where]
            groups[group] += dur
            short = name.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0][:60]
            by_kernel[group][short] = by_kernel[group].get(short, 0.0) + dur
            if not any(k in name for k in own):
                foreign.add(f"{where}: {name[:80]}")
            continue
        if any(k in name for k in K1_KERNELS):
            groups["k1_forward"] += dur
            continue
        if any(k in name for k in K2_KERNELS):
            groups["k2_forward"] += dur
            continue
        group = {"train/backward": "rest_of_backward",
                 "train/forward": "rest_of_forward",
                 "train/selfcond_forward": "rest_of_forward",
                 "train/optimizer": "optimizer_ema_gate"}.get(where, "other")
        groups[group] += dur
    busy = device_breakdown(trace_path, wall_us)["busy_ms"]
    total = sum(groups.values())
    return {"ms_per_step": {k: v / 1e3 / steps for k, v in groups.items()},
            "share": {k: v / total for k, v in groups.items()},
            "backward_kernels_ms_per_step": {
                g: {n: v / 1e3 / steps for n, v in sorted(
                    d.items(), key=lambda kv: -kv[1])}
                for g, d in by_kernel.items()},
            "foreign_kernels": sorted(foreign),
            "device_ms_per_step": total / 1e3 / steps,
            "wall_ms_per_step": wall_us / 1e3 / steps,
            "idle_share": 1.0 - busy / (wall_us / 1e3),
            "selfcond_forwards": sum(e.get("cat") == "user_annotation"
                                     and e["name"] == "train/selfcond_forward"
                                     for e in events)}


def _train_module():
    import importlib

    return importlib.import_module(
        "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch"
        ".training.train")


def attn16k_train_config(tmp, name, **kw):
    """The 16 kHz attention flagship's training configuration: its
    architecture at full width, v-prediction, bf16, the trainer's default
    batch; every timestep trained (t_min_frac 0), a short warm-up."""
    tt = _train_module()
    return tt.TrainConfig(**dict(
        dict(base_ch=64, time_dim=128, depth=3, use_attention=True,
             pred_type="v", bf16=True, batch_size=TRAIN_BATCH,
             t_min_frac=0.0, warmup_steps=4,
             model_dir=os.path.join(tmp, name)), **kw))


def phase_train(torch, tmp):
    """attn16k training at full width through ``train(cfg, dataset=...)``:
    the data synthesised on the card, a counted run with self-conditioning
    on every step, a timed run with the recipe's knobs (the trainer's own
    samples/s and MFU from its JSONL, ms per step, peak memory), one
    profiled window split by part.  Returns the counted run's launches and
    the dataset."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import pipeline
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    tt = _train_module()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = pipeline.synthetic_dataset(TRAIN_SAMPLES, segment_len=32768,
                                    fs=16384, whiten=True, device="cuda")
    synth_s = time.perf_counter() - t0
    b = ds.buckets[32768]
    check(ds.bucket_lengths == [32768] and b["clean"].shape
          == (TRAIN_SAMPLES, 1, 32768) and np.isfinite(b["noisy"]).all()
          and np.isfinite(b["clean"]).all(), "synthetic 16 kHz corpus")
    steps = TRAIN_SAMPLES // TRAIN_BATCH

    # counted: self-conditioning on every step, so each step runs two
    # forwards (K1 x 7 and K2 x 1 each) and one backward (K1B x 7, K2B x 1)
    reset_launch_counts()
    out = tt.train(attn16k_train_config(tmp, "count", epochs=1,
                                        p_selfcond=1.0, p_uncond=0.2),
                   dataset=ds, device="cuda")
    torch.cuda.synchronize()
    launches = check_launches(
        launch_counts, {"conv_gn_silu": 14 * steps,
                        "flash_attention": 2 * steps,
                        "conv_gn_silu_backward": 7 * steps,
                        "flash_attention_backward": steps}, "attn16k train",
        model=ATTN16K)
    check(np.isfinite(out["history"][0]["avg_per_sample"])
          and int(out["state"].step) == steps, "attn16k counted run")

    # timed: the recipe's knobs; the trainer's own throughput and MFU from
    # its epoch records (epoch 1 holds the warm-up)
    log = os.path.join(tmp, "attn16k_train.jsonl")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = tt.train(attn16k_train_config(tmp, "timed", epochs=3,
                                        p_selfcond=0.5, p_uncond=0.2,
                                        log_jsonl=log),
                   dataset=ds, device="cuda")
    train_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with open(log) as fh:
        ends = [r for r in map(json.loads, fh) if r["phase"] == "epoch_end"]
    check(len(ends) == 3 and all(np.isfinite(r["avg_per_sample"])
                                 for r in ends), "attn16k timed run")

    # ms per step: the trainer's step on the resident batches, each step
    # timed to a synchronize, after a warm-up
    cfg = attn16k_train_config(tmp, "steps", p_selfcond=0.5, p_uncond=0.2)
    model, schedule, opt, lr, state, _ = tt.build_model_and_state(
        cfg, 4, 100, 7, "cuda")
    step = tt.make_train_step(model, schedule, cfg, opt, lr)
    dev = pipeline.upload_buckets(ds, torch.device("cuda"))
    batches = [bb for _ in range(5) for bb in pipeline.device_resident_batches(
        ds, TRAIN_BATCH, np.random.default_rng(0), dev)]
    key = tt.key_from_seed(3)
    for bb in batches[:3]:
        key, k = tt.split_key(key)
        step(state, bb, k, 0, 0.2, 0.5)
    torch.cuda.synchronize()
    step_ms, coins = [], []
    for bb in batches[3:3 + TRAIN_TIMED_STEPS]:
        key, k = tt.split_key(key)
        t0 = time.perf_counter()
        step(state, bb, k, 0, 0.2, 0.5)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        coins.append(tt._uniform(k) < 0.5)

    from torch.profiler import ProfilerActivity, profile

    window = batches[3 + TRAIN_TIMED_STEPS:][:TRAIN_PROFILED_STEPS]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for bb in window:
            key, k = tt.split_key(key)
            step(state, bb, k, 0, 0.2, 0.5)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    trace = TRACES / "train_attn16k_trace.json"
    TRACES.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    split = train_split(trace, wall_us, len(window))
    check(split["ms_per_step"]["k1_backward"] > 0
          and split["ms_per_step"]["k2_backward"] > 0
          and not split["foreign_kernels"],
          f"the backward ranges hold K1B's and K2B's kernels only: {split}")

    flops = (3.0 + 0.5) * TRAIN_BATCH * _unet_flops(ATTN16K, 32768)
    emit({"phase": "train", "config": "attn16k bf16", "L": 32768,
          "batch": TRAIN_BATCH, "samples": TRAIN_SAMPLES,
          "steps_per_epoch": steps, "synth_s": synth_s,
          "counted_run": {"p_selfcond": 1.0, "launches": launches},
          "timed_run": {"epochs": 3, "seconds": train_s,
                        "avg_per_sample": [r["avg_per_sample"] for r in ends],
                        "samples_per_sec": [r["samples_per_sec"]
                                            for r in ends],
                        "mfu_est": [r["mfu_est"] for r in ends],
                        "steps_per_sec": [r["steps_per_sec"] for r in ends]},
          "step_ms_median": float(np.median(step_ms)), "step_ms": step_ms,
          "step_selfcond": coins,
          "step_ms_median_selfcond": float(np.median(
              [m for m, c in zip(step_ms, coins) if c] or [np.nan])),
          "step_ms_median_no_selfcond": float(np.median(
              [m for m, c in zip(step_ms, coins) if not c] or [np.nan])),
          "train_gflop_per_step": flops / 1e9,
          "peak_memory_gb": peak_gb})
    emit({"phase": "train_profile", "config": "attn16k bf16",
          "profiled_steps": len(window),
          "trace": str(trace.relative_to(TRACES.parent)), **split})
    del state, step, dev, batches
    torch.cuda.empty_cache()
    return launches, ds


def _unet_flops(model_kw, L):
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.roofline import (
        unet_flops_per_sample,
    )

    return unet_flops_per_sample(L, 7, model_kw["base_ch"], model_kw["depth"],
                                 cond_ch=5, fast_decoder=False,
                                 use_attention=model_kw.get("use_attention",
                                                            False))


def phase_train_grads(torch, ds, tmp):
    """One train step's gradients at attn16k's full width and length on
    ``GRAD_ROWS`` rows, with injected t and eps and self-conditioning on:
    the kernel path against the plain path on the card (the same initial
    weights, seeded), in f32 within MODEL_TOL (max-abs normalised over all
    parameters) and in bf16 by the loss within GRAD_LOSS_TOL_BF16."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models import unet
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import randomize_

    tt = _train_module()
    b = ds.buckets[32768]
    g = torch.Generator(device="cuda").manual_seed(21)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[:GRAD_ROWS])).cuda()
             for k, v in b.items() if k != "index"}
    batch["t_inject"] = torch.tensor([5, 250, 600, 990][:GRAD_ROWS],
                                     device="cuda")
    batch["eps_inject"] = torch.randn(GRAD_ROWS, 1, 32768, generator=g,
                                      device="cuda")

    def one_step(bf16, plain):
        cfg = attn16k_train_config(tmp, "grads", bf16=bf16, batch_size=GRAD_ROWS)
        model, schedule, opt, lr, state, _ = tt.build_model_and_state(
            cfg, 4, 10, 5, "cuda")
        randomize_(model, 31)      # the init leaves the final conv at zero
        step = tt.make_train_step(model, schedule, cfg, opt, lr)
        with unet.plain_kernels() if plain else contextlib.nullcontext():
            reset_launch_counts()
            m = step(state, batch, 77, 0, 0.0, 1.0)
            torch.cuda.synchronize()
            counts = launch_counts()
        return float(m["loss"]), state.params.grad.clone(), counts

    rec = {"phase": "train_grads", "config": "attn16k", "rows": GRAD_ROWS,
           "L": 32768, "p_selfcond": 1.0}
    for dname, bf16 in (("float32", False), ("bfloat16", True)):
        lk, gk, ck = one_step(bf16, plain=False)
        lp, gp, cp = one_step(bf16, plain=True)
        check(ck == all_counts({"conv_gn_silu": 14, "flash_attention": 2,
                                "conv_gn_silu_backward": 7,
                                "flash_attention_backward": 1},
                               model=ATTN16K if bf16 else None)
              and cp == all_counts({}),
              f"gradient check {dname}: launches {ck} / plain {cp}")
        grad_rel = float((gk - gp).abs().max() / gp.abs().max())
        loss_rel = abs(lk - lp) / abs(lp)
        rec[dname] = {"loss_kernel": lk, "loss_plain": lp,
                      "loss_rel_err": loss_rel, "grad_max_rel_err": grad_rel,
                      "grad_abs_max": float(gp.abs().max()),
                      "launches": ck}
        check(np.isfinite(lk) and bool(torch.isfinite(gk).all()),
              f"gradient check {dname}: finite")
        if bf16:
            check(loss_rel <= GRAD_LOSS_TOL_BF16,
                  f"bf16 loss kernel {lk} vs plain {lp}")
        else:
            check(grad_rel <= MODEL_TOL and loss_rel <= MODEL_TOL,
                  f"f32 gradients kernel vs plain: rel {grad_rel}, loss "
                  f"{loss_rel}")
        del gk, gp
        torch.cuda.empty_cache()
    rec["tol"] = {"float32": MODEL_TOL, "bfloat16_loss": GRAD_LOSS_TOL_BF16}
    emit(rec)


def phase_train_cli(torch, tmp):
    """``gw-train`` in-process at pn128 width on ``--data synth:32``: the
    loss falls from the first epoch to the last; its checkpoint is read by
    ``load_model`` and reconstructs a synthetic measurement through the
    infer CLI; a ``--resume`` of one epoch continues its global step.
    Returns the launches of the training run and its checkpoint."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import inference
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import infer as infer_cli
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import train as train_cli
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )

    tt = _train_module()
    d = os.path.join(tmp, "pn128_train")
    log = os.path.join(tmp, "pn128_train.jsonl")
    argv = ["--data", "synth:32", "--base_ch", "128", "--pred_type", "v",
            "--epochs", str(CLI_TRAIN_EPOCHS), "--warmup_steps", "4",
            "--t_min_frac", "0", "--model_dir", d, "--log-jsonl", log,
            "--device", "cuda"]
    # the coins the run will draw: the trainer's key, split once for the
    # initial weights, then once per step
    steps = 2 * CLI_TRAIN_EPOCHS
    key = tt.split_key(tt.key_from_seed(42))[0]
    heads = 0
    for _ in range(steps):
        key, k = tt.split_key(key)
        heads += tt._uniform(k) < 0.5
    reset_launch_counts()
    t0 = time.perf_counter()
    out = train_cli.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = check_launches(launch_counts,
                              {"conv_gn_silu": 7 * (steps + heads),
                               "conv_gn_silu_backward": 7 * steps},
                              "pn128 train cli", model=FLAGSHIP)
    hist = [h["avg_per_sample"] for h in out["history"]]
    check(len(hist) == CLI_TRAIN_EPOCHS and hist[0] > hist[-1],
          f"gw-train: the loss did not fall, {hist}")
    ck = load_checkpoint(out["checkpoint"])
    check(ck["global_step"] == steps and ck["epoch"] == CLI_TRAIN_EPOCHS
          and set(ck["optimizer_state"]) == {"0", "1"},
          f"gw-train checkpoint: step {ck['global_step']}")

    model, schedule, args = inference.load_model(out["checkpoint"],
                                                 device="cuda")
    check(model.dtype == torch.bfloat16 and args["base_ch"] == 128
          and args["fs"] == 4096.0, "load_model of the trained checkpoint")
    clean, noise, _ = synth_measurement(CLI_TRAIN_L, 4096.0, 14)
    npy = os.path.join(tmp, "pn128_train_y.npy")
    np.save(npy, (clean + noise).astype(np.float32))
    outdir = os.path.join(tmp, "pn128_train_out")
    t0 = time.perf_counter()
    infer_cli.main(["--input-npy", npy, "--fs", "4096", "--model",
                    out["checkpoint"], "--outdir", outdir, "--steps", "4",
                    "--avg-seeds", "2", "--device", "cuda"])
    infer_s = time.perf_counter() - t0
    recon = [f for f in os.listdir(outdir) if f.startswith("recon_ddim")]
    rec_arr = np.load(os.path.join(outdir, recon[0]))
    check(len(recon) == 1 and rec_arr.shape == (CLI_TRAIN_L,)
          and bool(np.isfinite(rec_arr).all()),
          f"infer CLI on the trained checkpoint: {sorted(os.listdir(outdir))}")

    resumed = train_cli.main(argv[:argv.index("--epochs")] + [
        "--epochs", str(CLI_TRAIN_EPOCHS + 1), "--resume", out["checkpoint"]]
        + argv[argv.index("--epochs") + 2:])
    ck2 = load_checkpoint(resumed["checkpoint"])
    check([h["epoch"] for h in resumed["history"]] == [CLI_TRAIN_EPOCHS + 1]
          and ck2["global_step"] == steps + 2,
          f"--resume: epochs {resumed['history']}, step {ck2['global_step']}")
    with open(log) as fh:
        ends = [r for r in map(json.loads, fh) if r["phase"] == "epoch_end"]
    emit({"phase": "train_cli", "config": "pn128 bf16", "L": CLI_TRAIN_L,
          "data": "synth:32", "batch": TRAIN_BATCH, "epochs": CLI_TRAIN_EPOCHS,
          "steps": steps, "selfcond_steps": heads, "seconds": train_s,
          "avg_per_sample": hist, "launches": launches,
          "samples_per_sec_last": ends[CLI_TRAIN_EPOCHS - 1]["samples_per_sec"],
          "mfu_est_last": ends[CLI_TRAIN_EPOCHS - 1]["mfu_est"],
          "infer_cli_s": infer_s, "recon_abs_max": float(np.abs(rec_arr).max()),
          "resumed_global_step": ck2["global_step"],
          "resumed_avg_per_sample": resumed["history"][0]["avg_per_sample"]})
    return launches, out["checkpoint"]


def host_us_per_call(torch, fn, calls=300):
    """Host time per call of ``fn`` in us: the enqueue of ``calls`` calls,
    on a shape small enough that the device keeps up; then a sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * enqueue_s / calls


def phase_op_overhead(torch):
    """What the op registration adds to the host time of one launch of
    each kernel, forward and backward: the launch body alone, the
    registered op called directly, the public wrapper (checks, then the op)
    and, for K1, the body behind a low-level ``torch.library.Library``
    registration; in turns (each way, then each again in reverse order)."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        conv_gn_silu as k1,
    )
    import importlib

    k2 = importlib.import_module(f"{PORT}.ops.kernels.flash_attention")

    # the same launch body behind a low-level registration (one trip into
    # Python per call, no autograd layer), to price custom_op's layers
    probe = torch.library.Library("gwport_probe", "DEF")
    probe.define("conv_gn_silu(Tensor x, Tensor W, Tensor b, Tensor s, "
                 "Tensor bb, int groups, float eps) -> Tensor")
    probe.impl("conv_gn_silu", k1._launch, "CUDA")
    g = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn(2, 128, 64, generator=g, device="cuda").to(torch.bfloat16)
    W = torch.randn(3, 64, 64, generator=g, device="cuda") / 14.0
    b, s, bb = (torch.randn(64, generator=g, device="cuda") for _ in range(3))
    q, k, v = (torch.randn(1, 2, 128, 64, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    dy = torch.randn(2, 128, 64, generator=g, device="cuda").to(torch.bfloat16)
    # the decoder route at the same output: h at half length, the skip
    h = torch.randn(2, 64, 64, generator=g, device="cuda").to(torch.bfloat16)
    Wd = torch.randn(3, 128, 64, generator=g, device="cuda") / 20.0
    o = k2.flash_attention_op(q, k, v)
    do = torch.randn(o.shape, generator=g, device="cuda").to(torch.bfloat16)
    probe_op = torch.ops.gwport_probe.conv_gn_silu.default
    ways = {
        "conv_gn_silu": {
            "body": lambda: k1._launch(x, W, b, s, bb, 8, 1e-5),
            "op": lambda: k1.conv_gn_silu_op(x, W, b, s, bb, 8, 1e-5),
            "wrapper": lambda: k1.fused_conv_gn_silu(x, W, b, s, bb, 8),
            "library_impl": lambda: probe_op(x, W, b, s, bb, 8, 1e-5)},
        "conv_gn_silu_decoder": {
            "body": lambda: k1._launch_decoder(h, dy, Wd, b, s, bb, 8, 1e-5),
            "op": lambda: k1.conv_gn_silu_op(h, Wd, b, s, bb, 8, 1e-5, None,
                                             None, None, None, dy),
            "wrapper": lambda: k1.fused_conv_gn_silu(h, Wd, b, s, bb, 8,
                                                     skip=dy)},
        "flash_attention": {
            "body": lambda: k2._launch(q, k, v),
            "op": lambda: k2.flash_attention_op(q, k, v),
            "wrapper": lambda: k2.flash_attention(q, k, v)},
        "conv_gn_silu_backward": {
            "body": lambda: k1._launch_backward(dy, x, W, b, s, bb, 8, 1e-5),
            "op": lambda: k1.conv_gn_silu_backward_op(dy, x, W, b, s, bb, 8,
                                                      1e-5),
            "wrapper": lambda: k1.fused_conv_gn_silu_grad(dy, x, W, b, s, bb,
                                                          8)},
        "flash_attention_backward": {
            "body": lambda: k2._launch_backward(do, q, k, v, o),
            "op": lambda: k2.flash_attention_backward_op(do, q, k, v, o),
            "wrapper": lambda: k2.flash_attention_grad(do, q, k, v, o)}}
    for name, fns in ways.items():
        us = {way: [] for way in fns}
        with torch.no_grad():
            for way in list(fns) + list(reversed(fns)):
                us[way].append(host_us_per_call(torch, fns[way]))
        rec = {way: float(np.mean(v)) for way, v in us.items()}
        emit({"phase": "op_overhead", "kernel": name, "calls": 300,
              "shape": list((x if name.startswith("conv") else q).shape),
              "host_us_per_call": rec, "runs_us": us,
              "registration_us": rec["op"] - rec["body"],
              "wrapper_us_over_body": rec["wrapper"] - rec["body"]})


def phase_autograd(torch):
    """A CUDA forward that autograd records launches both kernels (counted;
    no plain forward, no refusal) and backpropagates through the backward
    kernels K1B and K2B (counted) to every parameter."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models.unet import UNet1D
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import randomize_

    model = UNet1D(in_ch=7, base_ch=16, time_dim=32, depth=2, cond_in_ch=5,
                   use_selfcond=True, use_attention=True, device="cuda")
    randomize_(model, 2)
    x = torch.randn(2, 7, 256, device="cuda")
    t = torch.tensor([3, 700], device="cuda")
    reset_launch_counts()
    model(x, t).square().mean().backward()
    torch.cuda.synchronize()
    launches = check_launches(launch_counts, expected_launches(model, 1, 1),
                              "grad-enabled forward")
    grads = {n: p.grad for n, p in model.named_parameters()}
    check(all(g is not None and bool(torch.isfinite(g).all())
              for g in grads.values()), "every parameter has a finite grad")
    check(all(float(grads[n].abs().sum()) > 0 for n in (
        "enc0.conv.kernel", "mid.norm.scale", "dec1.conv.kernel",
        "mid_attn.qkv.kernel")), "the kernels' backward reaches the blocks")
    emit({"phase": "autograd", "launches": launches,
          "params_with_grad": len(grads)})


def served_inputs(n, L, seed):
    rng = np.random.default_rng(seed)
    cond = np.empty((n, 5, L), np.float32)
    cond[:, 0] = rng.standard_normal((n, L))
    cond[:, 1:] = rng.uniform(0.0, 1.0, (n, 4, 1))
    return cond, rng.uniform(0.5, 2.0, n).astype(np.float32)


def phase_export(torch, config, tmp):
    """The serving artifact of one flagship, from the bf16 checkpoint that
    the infer phase wrote: export on the card, replay against the live
    function (bit-equal, in this process and in a fresh one), its launches
    and K2's kernel names, latency against the live function, then
    ``validate_export``, ``tools/bench_serving``, ``gw-serve`` in batch
    mode and over HTTP.  Returns the launches of one replay."""
    import http.client
    import io
    import threading

    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import inference
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import serving
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import serve as serve_cli
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.schedules import (
        build_lambda_t_schedule,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools import bench_serving

    path = PATHS[config]
    L, seeds = path["L"], path["seeds"]
    ckpt = os.path.join(tmp, f"{config}.msgpack")
    art = os.path.join(tmp, f"{config}.pt2")
    knobs = dict(steps=SERVING_STEPS, ladder="lambda", cfg_scale=1.5,
                 avg_seeds=seeds, avg_mode="mean", amp_calib="mf")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    contract = serving.export_sampler(ckpt, art, batch=SERVING_REQUESTS,
                                      length=L, device="cuda", **knobs)
    export_s = time.perf_counter() - t0
    ops_in_graph = contract["ops"]
    t0 = time.perf_counter()
    call, contract2 = serving.load_exported(art)
    load_s = time.perf_counter() - t0
    check(contract2 == contract and contract["platforms"] == ["cuda"],
          f"{config}: sidecar {contract2}")

    model, schedule, ck = inference.load_model(ckpt, device="cuda")
    cfg, sampler = serving.resolve_serving_config(
        ck, schedule, steps=SERVING_STEPS, ladder="lambda", cfg_scale=1.5)
    live = serving.build_serving_fn(schedule, cfg, sampler=sampler,
                                    avg_seeds=seeds, avg_mode="mean",
                                    amp_calib="mf", device="cuda")
    n_steps = len(build_lambda_t_schedule(schedule, cfg.steps, cfg.start_t))
    want_launches = expected_launches(model, n_steps)
    check(ops_in_graph["conv_gn_silu"] == want_launches["conv_gn_silu"]
          and ops_in_graph["flash_attention"]
          == want_launches["flash_attention"],
          f"{config}: the graph holds {ops_in_graph}, not {want_launches}")
    cond, sig = served_inputs(SERVING_REQUESTS, L, 21)

    torch.cuda.synchronize()
    reset_launch_counts()
    got = call(cond, sig, 5)
    torch.cuda.synchronize()
    launches = check_launches(launch_counts, want_launches,
                              f"{config} artifact replay")
    want = live(model, cond, sig, 5)
    max_diff = float((got - want).abs().max())
    check(torch.equal(got, want), f"{config}: artifact vs live function, "
                                  f"max abs diff {max_diff}")
    check(tuple(got.shape) == (SERVING_REQUESTS, L)
          and bool(torch.isfinite(got).all()), f"{config}: artifact output")

    # a fresh process: load, replay at the same seed, count the launches
    npz = os.path.join(tmp, f"{config}_req.npz")
    out_npy = os.path.join(tmp, f"{config}_sub.npy")
    np.savez(npz, cond_stack=cond, sigmas=sig)
    code = (
        "import json, time\n"
        "t0 = time.perf_counter()\n"
        "import numpy as np, torch\n"
        "from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.serving import load_exported\n"
        "from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import launch_counts\n"
        "t1 = time.perf_counter()\n"
        f"call, _ = load_exported({art!r})\n"
        "t2 = time.perf_counter()\n"
        f"d = np.load({npz!r})\n"
        "out = call(d['cond_stack'], d['sigmas'], 5).cpu().numpy()\n"
        "t3 = time.perf_counter()\n"
        f"np.save({out_npy!r}, out)\n"
        "print(json.dumps({'launches': launch_counts(), 'import_s': t1 - t0,"
        " 'load_s': t2 - t1, 'first_call_s': t3 - t2}))\n")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         cwd=str(Path(__file__).resolve().parent))
    sub_s = time.perf_counter() - t0
    check(res.returncode == 0, f"{config}: the fresh process failed: "
                               f"{res.stderr[-2000:]}")
    sub = json.loads(res.stdout.strip().splitlines()[-1])
    sub_launches = sub.pop("launches")
    sub_equal = bool(np.array_equal(np.load(out_npy), want.cpu().numpy()))
    check(sub_equal and sub_launches == want_launches,
          f"{config}: fresh process equal={sub_equal}, launches "
          f"{sub_launches}")

    # latency: artifact and live function in turns, median of 5 each
    runs = {"artifact": [], "live": []}
    for seed in range(1, 1 + SERVING_TIMED_RUNS):
        for way in ("artifact", "live") if seed % 2 else ("live", "artifact"):
            t0 = time.perf_counter()
            (call(cond, sig, seed) if way == "artifact"
             else live(model, cond, sig, seed))
            torch.cuda.synchronize()
            runs[way].append(time.perf_counter() - t0)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call(cond, sig, 99)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    trace = TRACES / f"export_{config}_trace.json"
    TRACES.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    breakdown = device_breakdown(trace, wall_us)
    k2_seen = breakdown["k2_launches_by_kernel"]
    check(sum(k2_seen.values()) == want_launches["flash_attention"]
          and all("flash_fwd_wgmma" in name for name in k2_seen),
          f"{config}: the replay's trace holds K2 launches {k2_seen}")

    peak = serving.validate_export(art)
    check(np.isfinite(peak) and peak > 0, f"{config}: validate {peak}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_serving.main(["--artifact", art, "--reps", "5"])
    check(rc == 0, f"{config}: bench_serving rc {rc}")
    bench_rec = json.loads(buf.getvalue().strip().splitlines()[-1])

    # gw-serve, batch mode: 6 requests at batch 4, the second chunk padded
    cond6, sig6 = served_inputs(6, L, 22)
    req, resp = os.path.join(tmp, f"{config}_6.npz"), os.path.join(
        tmp, f"{config}_6_out.npz")
    np.savez(req, cond_stack=cond6, sigmas=sig6)
    t0 = time.perf_counter()
    rc = serve_cli.main(["--artifact", art, "--input", req, "--output", resp,
                         "--seed", "3", "--device", "cuda"])
    serve_batch_s = time.perf_counter() - t0
    x6 = np.load(resp)["x0_white"]
    check(rc == 0 and x6.shape == (6, L) and bool(np.isfinite(x6).all()),
          f"{config}: gw-serve batch rc {rc}, shape {x6.shape}")
    check(np.array_equal(x6, serving.run_batched(call, contract, cond6, sig6,
                                                 seed=3)),
          f"{config}: gw-serve batch differs from run_batched")

    # gw-serve over HTTP on an ephemeral port
    srv = serve_cli.make_server(art, port=0, device="cuda")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    http_rec = {}
    try:
        host, port = srv.server_address[:2]
        conn = http.client.HTTPConnection(host, port, timeout=300)
        body = io.BytesIO()
        np.savez(body, cond_stack=cond6, sigmas=sig6, seed=np.int32(3))
        t0 = time.perf_counter()
        conn.request("POST", "/reconstruct", body=body.getvalue())
        r = conn.getresponse()
        x_http = np.load(io.BytesIO(r.read()))["x0_white"]
        http_rec["post_s"] = time.perf_counter() - t0
        http_rec["post_status"] = r.status
        check(r.status == 200 and np.array_equal(x_http, x6),
              f"{config}: POST /reconstruct {r.status}")
        conn.request("GET", "/contract")
        r = conn.getresponse()
        http_rec["contract_status"] = r.status
        check(r.status == 200 and json.loads(r.read()) == contract,
              f"{config}: GET /contract")
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        check(r.status == 200 and r.read() == b"ok", f"{config}: /healthz")
        bad = io.BytesIO()
        np.savez(bad, cond_stack=cond6[:, :, :L // 2], sigmas=sig6)
        conn.request("POST", "/reconstruct", body=bad.getvalue())
        r = conn.getresponse()
        r.read()
        http_rec["wrong_shape_status"] = r.status
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        r.read()
        http_rec["healthz_after"] = r.status
        check(http_rec["wrong_shape_status"] == 400
              and http_rec["healthz_after"] == 200,
              f"{config}: wrong shape gave {http_rec}")
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    check(not th.is_alive(), f"{config}: the HTTP server did not stop")

    emit({"phase": "export", "config": f"{config} bf16", "L": L,
          "requests": SERVING_REQUESTS, "avg_seeds": seeds,
          "steps": SERVING_STEPS, "ladder_steps": n_steps,
          "export_s": export_s, "artifact_bytes": contract["artifact_bytes"],
          "artifact_mb": contract["artifact_bytes"] / 1e6,
          "load_s": load_s, "ops_in_graph": ops_in_graph,
          "replay_launches": launches, "equal_to_live": True,
          "fresh_process": {"equal_to_live": sub_equal,
                            "launches": sub_launches, "seconds": sub_s,
                            **sub},
          "artifact_s": float(np.median(runs["artifact"])),
          "live_s": float(np.median(runs["live"])),
          "runs_s": runs, "validate_peak": peak,
          "serve_batch": {"requests": 6, "seconds": serve_batch_s},
          "http": http_rec})
    emit({"phase": "export_profile", "config": f"{config} bf16",
          "profiled_runs": 1, "trace": str(trace.relative_to(TRACES.parent)),
          **breakdown})
    emit({"phase": "bench_serving", "config": f"{config} bf16", **bench_rec})
    return launches


def _pod_rank(rank, port, payload, queue):
    """One of two ranks sharing the card in a gloo group: the ranks export
    the pod artifacts of ``payload["exports"]`` between them, one each, at
    once; then each artifact of ``payload["arts"]`` loaded, replayed on the
    global batch (counted, then timed); puts its results on ``queue`` and
    leaves without the interpreter's teardown."""
    import torch
    import torch.distributed as dist

    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import serving
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=PAR_RANKS, rank=rank)
    out = {"rank": rank, "export_s": {}}
    for dname, kw in list(payload["exports"].items())[rank::PAR_RANKS]:
        t0 = time.perf_counter()
        out["export_dp"] = serving.export_sampler(**kw)["dp"]
        out["export_s"][dname] = time.perf_counter() - t0
    dist.barrier()
    shapes = LaunchShapes()
    with shapes:
        LaunchShapes.label = "pod ranks"
        for dname, art in payload["arts"].items():
            t0 = time.perf_counter()
            call, contract = serving.load_exported(art)
            load_s = time.perf_counter() - t0
            reset_launch_counts()
            x0 = call(payload["cond"], payload["sig"], 5)
            torch.cuda.synchronize()
            launches = launch_counts()
            call_s = []
            for seed in range(6, 6 + POD_TIMED_RUNS):
                t0 = time.perf_counter()
                call(payload["cond"], payload["sig"], seed)
                torch.cuda.synchronize()
                call_s.append(time.perf_counter() - t0)
            out[dname] = {"x0": x0.cpu().numpy(), "load_s": load_s,
                          "launches": launches, "call_s": call_s,
                          "batch": contract["calling_convention"]["inputs"][
                              "cond_stack"][0],
                          "rows_per_rank": contract["rows_per_rank"],
                          "contract_version": contract["contract_version"]}
    out["shapes"] = shapes.raw
    queue.put(out)
    queue.close()
    queue.join_thread()
    dist.barrier()
    sys.stdout.flush()
    os._exit(0)


POD_TIMED_RUNS = 2


def phase_pod(torch, tmp, shapes):
    """The pod-serving artifact (``export_sampler(dp=2)``) at pn128 width,
    the export phase's batch and knobs: 4 requests x 8 seeds x CFG = 64
    rows a forward over both ranks, 10 steps.  Exported in f32 (a
    checkpoint written here) and in bf16 (the infer phase's checkpoint) by
    the two gloo ranks, one each, while this process exports the f32 dp = 1
    reference; replayed on the ranks, which share the card (32 rows a
    forward each), and held against the dp = 1 artifact of the same
    checkpoint on the same batch and seed: f32 within ``MODEL_TOL``, bf16
    reported.  Returns the launches of rank 0's bf16 replay."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import serving
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    config = "pn128"
    L, seeds = PATHS[config]["L"], PATHS[config]["seeds"]
    knobs = dict(steps=SERVING_STEPS, ladder="lambda", cfg_scale=1.5,
                 avg_seeds=seeds, avg_mode="mean", amp_calib="mf")
    ckpts = {"float32": os.path.join(tmp, "pn128_f32.msgpack"),
             "bfloat16": os.path.join(tmp, f"{config}.msgpack")}
    write_checkpoint(FLAGSHIP, dict(infer_args(FLAGSHIP), bf16=False),
                     ckpts["float32"], 12)
    # the bf16 dp = 1 artifact is the export phase's; the ranks export the
    # two dp = 2 artifacts while this process exports the f32 dp = 1 one
    arts = {"float32": {1: os.path.join(tmp, "pn128_f32.pt2")},
            "bfloat16": {1: os.path.join(tmp, f"{config}.pt2")}}
    exports = {}
    for dname in arts:
        arts[dname][2] = os.path.join(tmp, f"pn128_{dname}_dp2.pt2")
        exports[dname] = dict(ckpt_path=ckpts[dname],
                              out_path=arts[dname][2],
                              batch=SERVING_REQUESTS, length=L,
                              device="cuda", dp=2, **knobs)
    cond, sig = served_inputs(SERVING_REQUESTS, L, 23)
    export_s, want, want_launches = {}, {}, {}

    def references():
        t0 = time.perf_counter()
        contract = serving.export_sampler(**dict(
            exports["float32"], out_path=arts["float32"][1], dp=1))
        export_s["float32 dp1"] = time.perf_counter() - t0
        check(contract["dp"] == 1, f"pod reference export: {contract}")
        for dname in arts:
            call, _ = serving.load_exported(arts[dname][1])
            reset_launch_counts()
            want[dname] = call(cond, sig, 5).cpu().numpy()
            torch.cuda.synchronize()
            want_launches[dname] = launch_counts()
            del call

    got, ranks_s = spawn_ranks(_pod_rank, {
        "exports": exports, "arts": {d: a[2] for d, a in arts.items()},
        "cond": cond, "sig": sig}, shapes, meanwhile=references)
    r0, r1 = got
    for r in got:
        check(r["export_dp"] == 2, f"pod export on rank {r['rank']}: dp "
                                   f"{r['export_dp']}")
        export_s.update({f"{d} dp2": t for d, t in r["export_s"].items()})
    rec = {"phase": "pod_serving", "config": config, "dp": 2,
           "ranks": PAR_RANKS, "backend": "gloo", "card_shared": True,
           "requests": SERVING_REQUESTS, "avg_seeds": seeds,
           "rows_per_forward_global": 2 * SERVING_REQUESTS * seeds,
           "steps": SERVING_STEPS, "export_s": export_s,
           "ranks_s": ranks_s,
           "note": "two ranks share one card: the times show that the pod "
                   "artifact runs, not how it scales"}
    for dname in arts:
        a, b = r0[dname], r1[dname]
        err = float(np.abs(a["x0"] - want[dname]).max()
                    / np.abs(want[dname]).max())
        rec[dname] = {"max_rel_err_vs_dp1": err, "tol": (
            MODEL_TOL if dname == "float32" else "reported"),
            "ranks_equal": bool(np.array_equal(a["x0"], b["x0"])),
            "rows_per_rank": a["rows_per_rank"],
            "contract_version": a["contract_version"],
            "load_s": [a["load_s"], b["load_s"]],
            "call_s_median": float(np.median(a["call_s"])),
            "call_s": [a["call_s"], b["call_s"]],
            "launches_rank0": a["launches"],
            "launches_dp1": want_launches[dname]}
        check(rec[dname]["ranks_equal"] and a["x0"].shape == want[
            dname].shape and bool(np.isfinite(a["x0"]).all())
              and a["batch"] == SERVING_REQUESTS
              and a["rows_per_rank"] == SERVING_REQUESTS // 2,
              f"pod {dname}: the ranks' outputs")
        # each rank launches what the dp=1 replay does, at half its rows
        check(all(r[dname]["launches"] == want_launches[dname] for r in got),
              f"pod {dname}: rank launches {a['launches']}, dp=1 "
              f"{want_launches[dname]}")
    emit(rec)
    check(rec["float32"]["max_rel_err_vs_dp1"] <= MODEL_TOL,
          f"pod f32 vs dp=1: {rec['float32']['max_rel_err_vs_dp1']}")
    return r0["bfloat16"]["launches"]


def phase_bench(torch):
    """The port's ``bench.py`` and ``entry()`` once each, with K1's
    launches; returns the launches of both."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import bench, graft_entry
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    reset_launch_counts()
    t0 = time.perf_counter()
    rec = bench.run()
    seconds = time.perf_counter() - t0
    runs = (1 + bench.REPS) * (bench.SCAN_STEPS + bench.LONG)
    bench_launches = check_launches(
        launch_counts, {"conv_gn_silu": (2 * bench.MODEL["depth"] + 1) * runs,
                        "flash_attention": 0}, "bench", model=bench.MODEL)
    print(json.dumps(rec), flush=True)         # the bench's own line
    check(np.isfinite(rec["value"]) and rec["value"] > 0,
          f"bench value {rec['value']}")
    emit({"phase": "bench", "seconds": seconds, "launches": bench_launches,
          "sampler_steps": runs})

    # where a bench step's time goes: one profiled run of 20 steps
    from torch.profiler import ProfilerActivity, profile

    step = bench.make_run(*bench.setup(), 20)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    trace = TRACES / "bench_trace.json"
    TRACES.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    emit({"phase": "bench_profile", "profiled_steps": 20,
          "trace": str(trace.relative_to(TRACES.parent)),
          **device_breakdown(trace, wall_us)})

    reset_launch_counts()
    fn, args = graft_entry.entry()
    out = fn(*args)
    torch.cuda.synchronize()
    entry_launches = check_launches(
        launch_counts, {"conv_gn_silu": 7, "flash_attention": 0}, "entry()",
        model=FLAGSHIP)
    check(tuple(out.shape) == (8, 1, 4096) and bool(torch.isfinite(out).all()),
          f"entry() output {tuple(out.shape)}")
    emit({"phase": "entry", "shape": list(out.shape),
          "launches": entry_launches,
          "out_abs_max": float(out.abs().max())})
    return bench_launches, entry_launches



# the evals and distill phases: mass-grid corpora synthesised on the card
# (m1 and m2 on a 3 x 3 grid, SNR uniform in [8, 30]); the sweep, the grid
# and distillation at the paths' full widths, 10 sampler steps (the 200 of a
# plain checkpoint cut to bound the run's time)
GRID_MASSES = (20.0, 35.0, 50.0)
EVAL_CORPORA = {"pn128": dict(fs=4096, L=4096, per_cell=4),
                "attn16k": dict(fs=16384, L=32768, per_cell=2)}
EVAL_STEPS = 10
EVAL_SEEDS = 2
ATTN16K_GRID_CAP = 9           # the forced cap: 18 samples in 2 chunks
DISTILL_CHAIN = "8,4,2"
DISTILL_EPOCHS = 2
DISTILL_BATCH = 16
DISTILL_PROFILED_STEPS = 4
PORT = "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch"


def synth_grid_corpus(torch, config, path, seed):
    """A mass-grid corpus synthesised on the card with the port's
    ``data/synth.py`` (3.5PN chirps in aLIGO-coloured noise), written with
    ``save_corpus_npz``: the grid scalars of the model PSD, no PSD arrays.
    Returns the sample count."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import (
        hdf5io,
        synth,
    )

    c = EVAL_CORPORA[config]
    a, b = np.meshgrid(GRID_MASSES, GRID_MASSES, indexing="ij")
    m1 = np.repeat(a.ravel(), c["per_cell"])
    m2 = np.repeat(b.ravel(), c["per_cell"])
    n = len(m1)
    snr = np.random.default_rng(seed).uniform(8.0, 30.0, n)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def col(v):
        return torch.as_tensor(v, dtype=torch.float32, device="cuda")

    out = synth.generate_batch(gen, col(m1), col(m2), col(snr),
                               config=synth.SynthConfig(n=c["L"], fs=c["fs"]))
    signal = out["signal"].cpu().numpy()
    noisy = out["noisy"].cpu().numpy()
    check(signal.shape == (n, c["L"]) and np.isfinite(noisy).all()
          and np.abs(signal).max() > 0, f"{config} grid corpus")
    mtot = m1 + m2
    meta = {"mass1": m1, "mass2": m2, "spin1z": np.zeros(n),
            "spin2z": np.zeros(n), "snr": snr,
            "q": np.maximum(m1, m2) / np.minimum(m1, m2),
            "chirp_mass": (m1 * m2) ** 0.6 / mtot ** 0.2,
            "label_m1": m1, "label_m2": m2,
            "psd_len": np.full(n, c["L"] // 2 + 1),
            "psd_df": np.full(n, c["fs"] / c["L"]),
            "psd_f_lower": np.full(n, 20.0)}
    hdf5io.save_corpus_npz(path, signal, noisy, meta, c["fs"])
    return n


def ladder_len(steps, start_t, ladder="t"):
    """Forwards of one sampler pass (the distinct steps of its ladder)."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.schedules import (
        build_lambda_t_schedule,
        build_t_schedule,
        make_schedule,
    )

    if ladder == "lambda":
        return len(build_lambda_t_schedule(make_schedule(1000), steps, start_t))
    return len(build_t_schedule(1000, steps, start_t))


def run_counted(torch, fn, want, what, model=None):
    """``fn()`` with the launch counts set to 0 just before and read just
    after, checked against ``all_counts(want, model)``; returns (its
    result, launches, seconds)."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    torch.cuda.synchronize()
    reset_launch_counts()
    LaunchShapes.label = what
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    LaunchShapes.label = "other"
    got = launch_counts()
    if want is not None:
        check(got == all_counts(want(out) if callable(want) else want,
                                model),
              f"{what}: launches {got}")
    return out, got, seconds


def phase_evals_small(torch, tmp):
    """``eval_combo`` and chunked ``eval_indices`` of a small f32 checkpoint
    on an ``.npz`` corpus: the card's path against the CPU plain path, with
    the same injected noise."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import inference
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import grid as grid_cli
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import hdf5io
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.evals import grid, sweep
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.sampling import (
        FixedNoise,
    )

    small = dict(in_ch=7, base_ch=16, time_dim=32, depth=2, cond_in_ch=5,
                 use_selfcond=True, t_embed_max_time=999.0)
    ck_path = os.path.join(tmp, "evals_small.msgpack")
    write_checkpoint(small, dict(infer_args(small), bf16=False), ck_path, 40)
    sig, noisy = [], []
    for i in range(4):
        clean, noise, _ = synth_measurement(512, 4096.0, 41 + i)
        sig.append(clean)
        noisy.append(clean + noise)
    npz = os.path.join(tmp, "evals_small.npz")
    hdf5io.save_corpus_npz(npz, sig, noisy, {
        "mass1": [30.0, 30.0, 40.0, 40.0], "mass2": [20.0] * 4,
        "snr": [9.0, 12.0, 15.0, 18.0], "psd_len": [257] * 4,
        "psd_df": [8.0] * 4, "psd_f_lower": [20.0] * 4}, 4096.0)
    z = {}

    def draws(shape):
        key = tuple(shape)
        if key not in z:
            z[key] = torch.randn(*shape, generator=torch.Generator()
                                 .manual_seed(len(z) + 50))
        return FixedNoise(z[key])

    def noise(seed, device):
        return draws

    out = {}
    for dev in ("cuda", "cpu"):
        model, schedule, ck = inference.load_model(ck_path, device=dev)
        preps = sweep.prep_samples(npz, [0, 1, 2, 3], ck, ck_path, True,
                                   "model", "std")
        combo = sweep.Combo(start_snr=8.0, cfg_scale=1.5, init_mode="noise",
                            dc_weight=0.0, eta=0.0)
        n = ladder_len(3, sweep._sampler_config(combo, 3, schedule, ck,
                                                True).start_t)
        want = {"conv_gn_silu": 5 * n, "flash_attention": 0, HEAD: n}
        r, got, _ = run_counted(
            torch, lambda: sweep.eval_combo(model, schedule, ck, preps, combo,
                                            3, draws, device=dev),
            want if dev == "cuda" else None, "small eval_combo")
        args = grid_cli.build_parser().parse_args(
            ["--input-h5", npz, "--model", ck_path, "--steps", "3",
             "--start-t", "999", "--avg-seeds", "2", "--eval-scan-cap", "2",
             "--cfg-scale", "1.5", "--whiten", "1", "--whiten-mode", "model",
             "--sigma-mode", "std", "--sigma-fixed", "1"])
        rows, got2, _ = run_counted(
            torch, lambda: grid.eval_indices(args, model, schedule, ck, preps,
                                             draws, device=dev),
            {"conv_gn_silu": 5 * ladder_len(3, 999) * 2,
             "flash_attention": 0, HEAD: ladder_len(3, 999) * 2}
            if dev == "cuda" else None,
            "small eval_indices")
        out[dev] = (r, rows, got, got2)
    (rg, rows_g, lg, lg2), (rc, rows_c, _, _) = out["cuda"], out["cpu"]

    def rel(key_fn, a, b):
        x = np.array([key_fn(s) for s in a], np.float64)
        y = np.array([key_fn(s) for s in b], np.float64)
        return float(np.abs(x - y).max() / np.abs(y).max())

    errs = {"J": rel(lambda s: s["J"], rg["per_sample"], rc["per_sample"])}
    for k in ("corr_last", "nmae_sigma"):
        errs[f"strain_{k}"] = rel(lambda s: s["strain"][k], rg["per_sample"],
                                  rc["per_sample"])
    for k in ("corr", "mae_norm", "unc_rel", "mf_ratio", "res_flatness"):
        errs[f"grid_{k}"] = rel(lambda r: r[k], rows_g, rows_c)
    emit({"phase": "evals_small_vs_cpu", "rows_combo": 4 * 2, "L": 512,
          "steps": 3, "launches": {"eval_combo": lg, "eval_indices": lg2},
          "max_rel_err": errs, "tol": MODEL_TOL})
    check(max(errs.values()) <= MODEL_TOL,
          f"evals GPU vs CPU rel errs {errs}")


def phase_evals(torch, tmp):
    """The sweep and the mass grid at full width on the card, on ``.npz``
    corpora synthesised there, from the checkpoints the infer phase writes.
    Returns the launches of each run."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import grid as grid_cli
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import sweep as sweep_cli
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.evals import grid, sweep
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.schedules import (
        make_schedule,
    )

    launches = {}
    corpora, ckpts, n_samples = {}, {}, {}
    t0 = time.perf_counter()
    for i, config in enumerate(EVAL_CORPORA):
        corpora[config] = os.path.join(tmp, f"{config}_grid.npz")
        n_samples[config] = synth_grid_corpus(torch, config, corpora[config],
                                              60 + i)
        ckpts[config] = os.path.join(tmp, f"{config}.msgpack")
        write_checkpoint(dict(PATHS[config]["model"], t_embed_max_time=999.0),
                         infer_args(PATHS[config]["model"]), ckpts[config], 11)
    setup_s = time.perf_counter() - t0
    schedule = make_schedule(1000)
    ck = infer_args(FLAGSHIP)

    # gw-sweep, grid mode: 2 SNR x 2 cfg combos on 4 indices, the gate on 8
    sw = os.path.join(tmp, "sweep_grid")
    argv = ["--input-h5", corpora["pn128"], "--model", ckpts["pn128"],
            "--outdir", sw, "--grid", "--grid-steps", str(EVAL_STEPS),
            "--grid-snr", "8", "16", "--grid-cfg", "1.0", "1.5",
            "--grid-init", "noise", "--grid-dc", "0", "--grid-eta", "0",
            "--indices", "0", "1", "2", "3", "--val-samples", "8",
            "--device", "cuda"]

    def sweep_forwards(top):
        with open(os.path.join(sw, "grid_results.json")) as fh:
            res = json.load(fh)
        n = sum(ladder_len(r["steps"], r["start_t"]) for r in res)
        return n + ladder_len(EVAL_STEPS, res[0]["start_t"]) + ladder_len(
            EVAL_STEPS, 999)

    top, got, sweep_s = run_counted(
        torch, lambda: sweep_cli.main(argv),
        lambda top: {"conv_gn_silu": 7 * sweep_forwards(top),
                     "flash_attention": 0}, "gw-sweep --grid",
        model=FLAGSHIP)
    launches["pn128 sweep grid"] = got
    with open(os.path.join(sw, "grid_results.json")) as fh:
        res = json.load(fh)
    with open(os.path.join(sw, "best_cmd.txt")) as fh:
        best = fh.read()
    with open(os.path.join(sw, "validation.json")) as fh:
        val = json.load(fh)
    check(len(res) == 4 and res[0]["J"] == max(r["J"] for r in res)
          and all(np.isfinite(r["J"]) for r in res), "grid_results.json")
    shipped = (f"--start-snr {res[0]['combo']['start_snr']:.4g}"
               if val["emit_top"] else "--start-t 999")
    check(val["enabled"] and len(val["val_indices"]) == 8 and shipped in best
          and best.startswith(sweep.INFER_PROG),
          f"best_cmd.txt ships the gate's choice: {best}")

    # gw-sweep, random mode: 4 coarse draws, top 2, 2 refine seeds
    sr = os.path.join(tmp, "sweep_random")
    argv_r = ["--input-h5", corpora["pn128"], "--model", ckpts["pn128"],
              "--outdir", sr, "--n-coarse", "4", "--topk", "2",
              "--seeds-refine", "2", "--steps-coarse", str(EVAL_STEPS),
              "--steps-refine", str(EVAL_STEPS), "--start-snr-min", "8",
              "--start-snr-max", "8", "--val-samples", "4",
              "--device", "cuda"]
    n8 = ladder_len(EVAL_STEPS, sweep._sampler_config(
        sweep.Combo(8.0, 1.5, "noise", 0.0, 0.0), EVAL_STEPS, schedule, ck,
        True).start_t)
    top_r, got, random_s = run_counted(
        torch, lambda: sweep_cli.main(argv_r),
        {"conv_gn_silu": 7 * (n8 * (4 + 2 * 2 + 1)
                              + ladder_len(EVAL_STEPS, 999)),
         "flash_attention": 0}, "gw-sweep random", model=FLAGSHIP)
    launches["pn128 sweep random"] = got
    check(sorted(os.listdir(sr)) == ["best_cmd.txt", "coarse_top.json",
                                      "final_results.json", "validation.json"]
          and np.isfinite(top_r["J"]), f"random sweep artifacts")

    # gw-grid --from-sweep on pn128: all 36 samples, 2 seeds, MF calibration
    def grid_run(config, outdir, extra):
        return grid_cli.main(["--input-h5", corpora[config], "--model",
                              ckpts[config], "--outdir", outdir,
                              "--per-cell", str(EVAL_CORPORA[config]
                                                ["per_cell"]),
                              "--avg-seeds", str(EVAL_SEEDS),
                              "--device", "cuda"] + extra)

    def grid_launches(config, steps, start_t, ladder="t", calls=1):
        n = ladder_len(steps, start_t, ladder) * calls
        return all_counts({"conv_gn_silu": 7 * n,
                           "flash_attention": n if config == "attn16k"
                           else 0}, model=PATHS[config]["model"])

    records = {}
    torch.cuda.reset_peak_memory_stats()
    gp = os.path.join(tmp, "grid_pn128")
    out, got, secs = run_counted(
        torch, lambda: grid_run("pn128", gp, ["--from-sweep", sw,
                                              "--amp-calib", "mf"]),
        None, "gw-grid pn128")
    summ = out["summary"]
    check(got == grid_launches("pn128", summ["knobs"]["steps"],
                               summ["start_t_resolved"]),
          f"gw-grid pn128 launches {got}")
    # --from-sweep replays what the gate shipped: the top combo, or the
    # default knobs from t 999 where the gate rejected it
    shipped_cfg = (res[0]["combo"]["cfg_scale"] if val["emit_top"]
                   else sweep.default_combo().cfg_scale)
    check(summ["knobs"]["cfg_scale"] == shipped_cfg
          and (val["emit_top"] or summ["start_t_resolved"] == 999),
          f"gw-grid --from-sweep replays the gate's choice: {summ['knobs']}")
    launches["pn128 grid"] = got
    records["pn128"] = dict(seconds=secs, summary=summ,
                            scan_caps=out["scan_caps"],
                            peak_gb=torch.cuda.max_memory_allocated() / 1e9)

    # attn16k: forced into 2 chunks, then the automatic cap (one profiled)
    ga = os.path.join(tmp, "grid_attn16k")
    knobs = ["--steps", str(EVAL_STEPS), "--start-t", "999"]
    out, got, secs = run_counted(
        torch, lambda: grid_run("attn16k", ga + "_cap", knobs + [
            "--eval-scan-cap", str(ATTN16K_GRID_CAP)]),
        grid_launches("attn16k", EVAL_STEPS, 999, calls=2),
        "gw-grid attn16k capped")
    launches["attn16k grid capped"] = got
    check(out["scan_caps"] == {32768: ATTN16K_GRID_CAP},
          f"capped chunks {out['scan_caps']}")
    records["attn16k_capped"] = dict(seconds=secs, summary=out["summary"],
                                     scan_caps=out["scan_caps"])
    torch.cuda.reset_peak_memory_stats()
    out, got, secs = run_counted(
        torch, lambda: grid_run("attn16k", ga, knobs), None,
        "gw-grid attn16k")
    calls = -(-n_samples["attn16k"] // out["scan_caps"][32768])
    check(got == grid_launches("attn16k", EVAL_STEPS, 999, calls=calls),
          f"gw-grid attn16k launches {got}")
    launches["attn16k grid"] = got
    rows = n_samples["attn16k"] * EVAL_SEEDS * 2
    records["attn16k"] = dict(seconds=secs, summary=out["summary"],
                              scan_caps=out["scan_caps"],
                              peak_gb=torch.cuda.max_memory_allocated() / 1e9)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grid_run("attn16k", ga + "_prof", knobs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    trace = TRACES / "grid_attn16k_trace.json"
    TRACES.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    breakdown = device_breakdown(trace, wall_us)
    k2_seen = breakdown["k2_launches_by_kernel"]
    check(sum(k2_seen.values()) == got["flash_attention"]
          and all("flash_fwd_wgmma" in name for name in k2_seen),
          f"the attn16k grid trace holds K2 launches {k2_seen}")

    for name, rec in records.items():
        summ = rec["summary"]
        check(summ["n_cells"] == 9 and "uncertainty" in summ
              and summ["n_rows"] == n_samples[name.split("_")[0]]
              and np.isfinite(summ["corr_macro_mean"]),
              f"{name} summary.json: {sorted(summ)}")
    want_keys = ["n_rows", "n_cells", "corr_macro_mean", "corr_macro_median",
                 "corr_micro_mean", "mae_macro_mean", "mae_macro_median",
                 "mae_micro_mean", "mf_ratio_macro_mean", "knobs",
                 "start_t_resolved", "whiten", "whiten_mode",
                 "whiten_kind_used", "sigma_mode", "residuals",
                 "uncertainty", "by_snr"]
    check(list(records["pn128"]["summary"]) == want_keys,
          f"summary.json keys {list(records['pn128']['summary'])}")
    pngs = {d: sorted(f for f in os.listdir(d) if f.endswith(".png"))
            for d in (gp, ga)}
    drawn = all(v == ["heat_corr.png", "heat_mae.png"] for v in pngs.values())
    check(drawn or not any(pngs.values()), f"heatmaps {pngs}")
    for d in (gp, ga):
        check({"per_index_metrics.csv", "metrics_grid.csv",
               "metrics_grid.json", "summary.json"} <= set(os.listdir(d)),
              f"gw-grid artifacts in {d}")

    n_evals = len(res) + 2
    emit({"phase": "evals", "corpora": {
              c: dict(EVAL_CORPORA[c], samples=n_samples[c], cells=9,
                      masses=list(GRID_MASSES)) for c in EVAL_CORPORA},
          "setup_s": setup_s,
          "sweep_grid": {"seconds": sweep_s, "combos": len(res),
                         "evals": n_evals, "s_per_combo": sweep_s / n_evals,
                         "J_top": res[0]["J"], "gate": val,
                         "best_cmd": best.strip()},
          "sweep_random": {"seconds": random_s, "evals": 4 + 4 + 2,
                           "s_per_combo": random_s / 10, "J_top": top_r["J"]},
          "grid": {name: {
              "seconds": rec["seconds"], "scan_caps": rec["scan_caps"],
              "recon_per_s": (rec["summary"]["n_rows"] * EVAL_SEEDS
                              / rec["seconds"]),
              "peak_gb": rec.get("peak_gb"),
              "corr_macro_mean": rec["summary"]["corr_macro_mean"],
              "mf_ratio_macro_mean": rec["summary"].get("mf_ratio_macro_mean"),
              "knobs": {k: rec["summary"]["knobs"][k] for k in (
                  "steps", "cfg_scale", "start_t", "avg_seeds", "amp_calib")}}
              for name, rec in records.items()},
          "attn16k_rows_per_forward": rows,
          "row_bytes_analytic": {c: grid.row_bytes(
              PATHS[c]["model"]["base_ch"], EVAL_CORPORA[c]["L"])
              for c in EVAL_CORPORA},
          "heatmaps_drawn": drawn,
          "launches": launches})
    emit({"phase": "evals_profile", "config": "attn16k grid bf16",
          "profiled_runs": 1, "trace": str(trace.relative_to(TRACES.parent)),
          **breakdown})
    return launches, corpora["pn128"], ckpts["pn128"]


DISTILL_GROUPS = ("teacher_forward", "student_forward", "backward",
                  "optimizer", "other")


def distill_split(trace_path, wall_us, steps):
    """Device ms per distillation step by part: each kernel belongs to the
    innermost ``distill/...`` range around the host call that launched it
    (the backward kernels K1B and K2B run inside ``distill/backward``); the
    port's kernels' share of each part; the idle share of the wall."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
               e["name"].split("/", 1)[1]) for e in events
              if e.get("cat") == "user_annotation"
              and e["name"].startswith("distill/")]
    groups = dict.fromkeys(DISTILL_GROUPS, 0.0)
    kernels = {g: 0.0 for g in DISTILL_GROUPS}
    for e in dev:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        inside = [r for r in ranges if ts is not None and r[0] <= ts <= r[1]]
        group = min(inside, key=lambda r: r[1] - r[0])[2] if inside else "other"
        groups[group] += float(e["dur"])
        if any(k in e["name"] for k in K1B_KERNELS + K2_KERNELS
               + K2B_KERNELS):
            kernels[group] += float(e["dur"])
    busy = device_breakdown(trace_path, wall_us)["busy_ms"]
    return {"ms_per_step": {k: v / 1e3 / steps for k, v in groups.items()},
            "k1_k2_ms_per_step": {k: v / 1e3 / steps
                                  for k, v in kernels.items()},
            "device_ms_per_step": sum(groups.values()) / 1e3 / steps,
            "wall_ms_per_step": wall_us / 1e3 / steps,
            "idle_share": 1.0 - busy / (wall_us / 1e3)}


def phase_distill_grads(torch, corpus):
    """One distillation step's f32 gradients at pn128's full width on
    ``GRAD_ROWS`` rows of the corpus, with injected segments and noise: the
    kernel path against the plain path on the card (the same seeded
    weights), within MODEL_TOL max-abs normalised."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import pipeline
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models import unet
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.schedules import (
        make_schedule,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import randomize_

    tt = _train_module()
    td = _distill_module()
    ds = pipeline.prepare_dataset(corpus, whiten=True, whiten_mode="model")
    b = ds.buckets[4096]
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[:GRAD_ROWS])).cuda()
             for k, v in b.items() if k != "index"}
    g = torch.Generator(device="cuda").manual_seed(22)
    batch["j_inject"] = torch.tensor([0, 1, 2, 3][:GRAD_ROWS], device="cuda")
    batch["eps0_inject"] = torch.randn(GRAD_ROWS, 1, 4096, generator=g,
                                       device="cuda")
    schedule = make_schedule(1000)
    cfg = td.DistillConfig(teacher="", data="", cfg_scale=1.5)
    ladder = td._teacher_ladder(schedule, 4, "lambda", 999)

    def one_step(plain):
        student = unet.UNet1D(**FLAGSHIP, device="cuda")
        teacher = unet.UNet1D(**FLAGSHIP, device="cuda")
        randomize_(student, 33)
        randomize_(teacher, 34)
        flat = tt.FlatParams(student, "cuda")
        opt = tt.ClipAdamW(td.distill_lr_schedule(1e-4, 100), 1.0, 0.0)
        state = tt.TrainState(params=flat, ema_params=flat.flat.clone(),
                              opt_state=opt.init(flat.flat),
                              step=torch.zeros((), dtype=torch.int32,
                                               device="cuda"))
        step = td.make_distill_step(student, schedule, cfg, opt, ladder, "v")
        with unet.plain_kernels() if plain else contextlib.nullcontext():
            reset_launch_counts()
            m = step(state, teacher, batch, 5)
            torch.cuda.synchronize()
            counts = launch_counts()
        return float(m["loss"]), flat.grad.clone(), counts

    lk, gk, ck = one_step(False)
    lp, gp, cp = one_step(True)
    check(ck == all_counts({"conv_gn_silu": 21, "conv_gn_silu_backward": 7})
          and cp == all_counts({}),
          f"distill gradient check: launches {ck} / plain {cp}")
    grad_rel = float((gk - gp).abs().max() / gp.abs().max())
    loss_rel = abs(lk - lp) / abs(lp)
    emit({"phase": "distill_grads", "config": "pn128 f32", "rows": GRAD_ROWS,
          "L": 4096, "cfg_scale": 1.5, "loss_kernel": lk, "loss_plain": lp,
          "loss_rel_err": loss_rel, "grad_max_rel_err": grad_rel,
          "grad_abs_max": float(gp.abs().max()), "launches": ck,
          "tol": MODEL_TOL})
    check(np.isfinite(lk) and bool(torch.isfinite(gk).all()),
          "distill gradients finite")
    check(grad_rel <= MODEL_TOL and loss_rel <= MODEL_TOL,
          f"distill f32 gradients kernel vs plain: rel {grad_rel}, loss "
          f"{loss_rel}")


def _distill_module():
    import importlib

    return importlib.import_module(f"{PORT}.training.distill")


def phase_distill(torch, tmp, teacher, corpus):
    """``gw-distill`` at pn128 width from the gw-train checkpoint on the
    pn128 grid corpus (a 8 -> 4 -> 2 chain), a profiled window of its step
    split by part, ``gw-grid`` on the 2-step student and ``gw-soup`` of the
    two stage students.  Returns the launches of each run."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import inference
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import distill as distill_cli
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import grid as grid_cli
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import soup as soup_cli
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import pipeline
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import (
        params_from_flax,
    )

    tt = _train_module()
    td = _distill_module()
    launches = {}
    d = os.path.join(tmp, "distilled")
    log = os.path.join(tmp, "distill.jsonl")
    n = len(GRID_MASSES) ** 2 * EVAL_CORPORA["pn128"]["per_cell"]
    steps_per_stage = -(-n // DISTILL_BATCH) * DISTILL_EPOCHS
    stages = len(DISTILL_CHAIN.split(",")) - 1
    torch.cuda.reset_peak_memory_stats()
    res, got, secs = run_counted(
        torch, lambda: distill_cli.main([
            "--teacher", teacher, "--data", corpus, "--model_dir", d,
            "--steps-schedule", DISTILL_CHAIN, "--epochs", str(DISTILL_EPOCHS),
            "--batch-size", str(DISTILL_BATCH), "--log-jsonl", log,
            "--device", "cuda"]),
        {"conv_gn_silu": 7 * 3 * steps_per_stage * stages,
         "conv_gn_silu_backward": 7 * steps_per_stage * stages},
        "gw-distill", model=FLAGSHIP)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches["pn128 distill"] = got
    with open(log) as fh:
        epochs = [json.loads(ln) for ln in fh]
    check(len(epochs) == stages * DISTILL_EPOCHS
          and all(np.isfinite(r["loss"]) for r in epochs),
          f"gw-distill losses {[r['loss'] for r in epochs]}")
    cks = [load_checkpoint(p) for p in res["checkpoints"]]
    check([c["args"]["distilled_steps"] for c in cks] == [4, 2]
          and all(c["args"]["selfcond_mode"] == "zero"
                  and c["global_step"] == steps_per_stage for c in cks),
          "the stage checkpoints")

    # a profiled window of the step on the stage-2 shapes
    teacher_m, schedule, ck = inference.load_model(teacher, device="cuda")
    student = copy.deepcopy(teacher_m)
    tt.FlatParams(teacher_m, "cuda")
    flat = tt.FlatParams(student, "cuda")
    cfg = td.DistillConfig(teacher=teacher, data=corpus)
    opt = td.distill_optimizer(cfg, 100)
    state = tt.TrainState(params=flat, ema_params=flat.flat.clone(),
                          opt_state=opt.init(flat.flat),
                          step=torch.zeros((), dtype=torch.int32,
                                           device="cuda"))
    step = td.make_distill_step(student, schedule, cfg, opt,
                                td._teacher_ladder(schedule, 2, "lambda",
                                                   999),
                                str(ck.get("pred_type", "eps")))
    ds = td._prepare(cfg, ck)
    dev = pipeline.upload_buckets(ds, torch.device("cuda"))
    batches = [bb for _ in range(4) for bb in pipeline.device_resident_batches(
        ds, DISTILL_BATCH, np.random.default_rng(0), dev)
        if bb["clean"].shape[0] == DISTILL_BATCH]
    key = tt.key_from_seed(8)
    for bb in batches[:2]:
        key, k = tt.split_key(key)
        step(state, teacher_m, bb, k)
    torch.cuda.synchronize()
    step_ms = []
    for bb in batches[2:6]:
        key, k = tt.split_key(key)
        t0 = time.perf_counter()
        step(state, teacher_m, bb, k)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))

    from torch.profiler import ProfilerActivity, profile

    window = batches[6:6 + DISTILL_PROFILED_STEPS]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for bb in window:
            key, k = tt.split_key(key)
            step(state, teacher_m, bb, k)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    trace = TRACES / "distill_pn128_trace.json"
    TRACES.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    split = distill_split(trace, wall_us, len(window))
    check(all(split["ms_per_step"][g] > 0 for g in (
        "teacher_forward", "student_forward", "backward")),
          f"the distill trace attributes its parts: {split}")
    del state, step, dev, batches, student, teacher_m
    torch.cuda.empty_cache()

    # gw-grid on the 2-step student: 2 steps, CFG folded (cfg 1.0)
    student2 = res["checkpoints"][-1]
    gd = os.path.join(tmp, "grid_distilled")
    n2 = ladder_len(2, 999, "lambda")
    out, got, grid_s = run_counted(
        torch, lambda: grid_cli.main([
            "--input-h5", corpus, "--model", student2, "--outdir", gd,
            "--per-cell", str(EVAL_CORPORA["pn128"]["per_cell"]),
            "--avg-seeds", str(EVAL_SEEDS), "--device", "cuda"]),
        {"conv_gn_silu": 7 * n2, "flash_attention": 0}, "gw-grid distilled",
        model=FLAGSHIP)
    launches["pn128 distilled grid"] = got
    knobs = out["summary"]["knobs"]
    check(knobs["steps"] == 2 and knobs["cfg_scale"] == 1.0
          and knobs["ladder"] == "lambda" and knobs["start_t"] == 999
          and out["summary"]["n_cells"] == 9,
          f"apply_distilled_defaults on the student: {knobs}")

    # gw-soup of the two stage students: the float64 mean cast back
    soup = os.path.join(tmp, "soup.msgpack")
    check(soup_cli.main(["--inputs", *res["checkpoints"], "--output", soup])
          == 0, "gw-soup")
    got_soup = load_checkpoint(soup)
    exact = True
    for key_ in ("model_state", "model_ema_state"):
        members = [params_from_flax(c[key_]) for c in cks]
        mine = params_from_flax(got_soup[key_])
        for name, v in mine.items():
            want = (0.5 * members[0][name].double().numpy()
                    + 0.5 * members[1][name].double().numpy()).astype(
                        np.float32)
            exact &= np.array_equal(v.numpy(), want)
    check(exact, "the soup is the float64 mean of its members, cast back")
    m_soup, _, a_soup = inference.load_model(soup, device="cuda")
    check(a_soup["soup_members"] == [os.path.basename(p)
                                      for p in res["checkpoints"]]
          and next(m_soup.parameters()).is_cuda, "load_model reads the soup")

    n_steps = steps_per_stage * stages
    emit({"phase": "distill", "config": "pn128 bf16", "teacher": "gw-train "
          "checkpoint (pn128 width, synth:32)", "corpus_samples": n,
          "L": 4096, "chain": DISTILL_CHAIN, "epochs_per_stage": DISTILL_EPOCHS,
          "batch": DISTILL_BATCH, "steps": n_steps, "seconds": secs,
          "steps_per_sec": n_steps / secs,
          "samples_per_sec": n_steps * DISTILL_BATCH / secs,
          "epoch_steps_per_sec": [r["steps_per_sec"] for r in epochs],
          "losses": [r["loss"] for r in epochs], "launches": launches,
          "peak_memory_gb": peak_gb,
          "step_ms_median": float(np.median(step_ms)), "step_ms": step_ms,
          "grid_on_student": {"seconds": grid_s, "knobs": {
              k: knobs[k] for k in ("steps", "cfg_scale", "ladder",
                                    "start_t")},
              "corr_macro_mean": out["summary"]["corr_macro_mean"]},
          "soup_exact": exact})
    emit({"phase": "distill_profile", "config": "pn128 bf16",
          "profiled_steps": len(window),
          "trace": str(trace.relative_to(TRACES.parent)), **split})
    return launches


# the parallel phase: data parallelism and sequence tiling at attn16k's full
# width.  A 64 s segment at 16384 Hz, tiled in chunks of 16384 with the
# attention halo receptive_field_radius(3) x 4 = 248: 64 tiles of 16880
# samples, each tile's bottleneck 2110 tokens; CFG doubles the rows
PAR_FS = 16384.0
PAR_L = 1 << 20
PAR_CHUNK = 16384
PAR_TILES = PAR_L // PAR_CHUNK
PAR_TILE_W = PAR_CHUNK + 2 * 248
PAR_ROWS = 2 * PAR_TILES                 # CFG x tiles, one forward
PAR_RANKS = 2                            # gloo ranks sharing the card
PAR_TIMED_STEPS = 6
PAR_PROFILED_STEPS = 3
# the tensor-parallel ranks' bf16 steps: warm-up, timed, profiled (fewer:
# on a shared card they check the path and the collectives, not scaling)
TP_STEPS = (2, 3, 2)
PAR_BATCH_MEASUREMENTS = 8               # x 2 seeds = 16 rows, 8 a rank
PAR_MESH_TILE_L = 3 * PAR_CHUNK - 1000   # 3 tiles: one dummy on 2 ranks


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cuda_batch(torch, batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
            for k, v in batch.items()}


def par_train_batch(rows, seed, inject):
    """``rows`` rows of 16 kHz training data (the synthetic generator's
    chirps in coloured noise, whitened) as host arrays; with ``inject`` also
    t and eps for every row."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import pipeline

    ds = pipeline.synthetic_dataset(rows, segment_len=32768, fs=16384,
                                    whiten=True, seed=seed, device="cuda")
    b = {k: v for k, v in ds.buckets[32768].items() if k != "index"}
    if inject:
        rng = np.random.default_rng(seed)
        b["t_inject"] = rng.integers(0, 1000, rows).astype(np.int64)
        b["eps_inject"] = rng.standard_normal((rows, 1, 32768)).astype(
            np.float32)
    return b


def par_f32_step(torch, tmp, batch, mesh=None):
    """One f32 train step at attn16k's full width on ``batch`` (the global
    batch; with ``mesh`` this rank's rows), self-conditioning on, from the
    same seeded weights; returns (metrics on the host, the flat parameters
    after the step, the flat gradient, averaged over the ranks)."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import randomize_

    tt = _train_module()
    cfg = attn16k_train_config(tmp, "par_f32", bf16=False,
                               batch_size=len(batch["sigma"]))
    model, schedule, opt, lr, state, _ = tt.build_model_and_state(
        cfg, 4, 10, 5, "cuda")
    randomize_(model, 31)      # the init leaves the final conv at zero
    step = tt.make_train_step(model, schedule, cfg, opt, lr, mesh)
    m = step(state, _cuda_batch(torch, batch), 77, 0, 0.0, 1.0)
    torch.cuda.synchronize()
    return ({k: float(v) for k, v in m.items()},
            state.params.flat.cpu().numpy(), state.params.grad.cpu().numpy())


def _par_rank(rank, port, payload, queue):
    """One of two ranks sharing the card in a gloo group, on a 2x1 data
    mesh or, with ``payload["tp"]``, a 1x2 tensor-parallel mesh: the f32
    step on its rows, timed and profiled bf16 steps (the collectives' time,
    the peak memory), a NaN in rank 1's rows, ``reconstruct_batch`` and a
    tiled forward over the mesh; puts its results on ``queue`` and leaves
    without the interpreter's teardown."""
    import torch
    import torch.distributed as dist

    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import inference
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.sampling import SamplerConfig
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.parallel import mesh as pmesh
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.parallel.seqtile import tiled_apply

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=PAR_RANKS, rank=rank)
    tp = payload.get("tp", False)
    mesh = (pmesh.make_mesh(n_data=1, n_model=PAR_RANKS) if tp
            else pmesh.make_mesh())
    out = {"rank": rank, "mesh": mesh.shape, "backend": dist.get_backend(
        mesh.model_group if tp else mesh.group)}
    tt = _train_module()
    shapes = LaunchShapes()
    with shapes, tempfile.TemporaryDirectory() as tmp:
        LaunchShapes.label = "tp ranks" if tp else "gloo ranks"
        out["f32_step"], out["f32_flat"], out["f32_grad"] = par_f32_step(
            torch, tmp, payload["f32_batch"], mesh)

        # bf16 steps at the recipe's knobs on 8 rows a rank
        cfg = attn16k_train_config(tmp, "par_bf16", p_selfcond=0.5,
                                   p_uncond=0.2)
        model, schedule, opt, lr, state, _ = tt.build_model_and_state(
            cfg, 4, 100, 7, "cuda")
        step = tt.make_train_step(model, schedule, cfg, opt, lr, mesh)
        batch = _cuda_batch(torch, payload["bf16_batch"])
        key = tt.key_from_seed(3)
        warm, timed, profiled = (TP_STEPS if tp else
                                 (3, PAR_TIMED_STEPS, PAR_PROFILED_STEPS))
        for _ in range(warm):
            key, k = tt.split_key(key)
            step(state, batch, k, 0, 0.2, 0.5)
        torch.cuda.synchronize()
        step_ms, coins = [], []
        reset_launch_counts()
        shapes.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(timed):
            key, k = tt.split_key(key)
            t0 = time.perf_counter()
            step(state, batch, k, 0, 0.2, 0.5)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            coins.append(tt._uniform(k) < 0.5)
        out["timed_launches"] = launch_counts()
        out["timed_launches_by_shape"] = shapes.launches_by_shape()
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["step_ms"], out["coins"] = step_ms, coins

        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(profiled):
                key, k = tt.split_key(key)
                step(state, batch, k, 0, 0.2, 0.5)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        trace = TRACES / (f"parallel_{'tp' if tp else 'gloo'}_rank{rank}"
                          f"_trace.json")
        TRACES.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
        # the collectives' host ranges (gloo blocks the calling thread):
        # the data axis's gradient mean, the model axis's gradient sum, the
        # tensor-parallel layers' gathers and sums
        coll = {}
        for e in events:
            if e.get("cat") == "user_annotation" and e["name"] in (
                    "train/all_reduce", "train/model_all_reduce",
                    "tp/all_gather", "tp/all_reduce"):
                c = coll.setdefault(e["name"], {"calls": 0, "ms": 0.0})
                c["calls"] += 1
                c["ms"] += float(e["dur"]) / 1e3
        for c in coll.values():
            c["ms_per_step"] = c["ms"] / profiled
            c["calls_per_step"] = c["calls"] / profiled
        out["profile"] = {"trace": str(trace.relative_to(TRACES.parent)),
                          "all_reduce_ms_per_step": coll.get(
                              "train/all_reduce", {}).get("ms_per_step", 0.0),
                          "all_reduces": coll.get(
                              "train/all_reduce", {}).get("calls", 0),
                          "collectives": coll,
                          **train_split(trace, wall_us, profiled)}

        # a NaN in one of rank 1's rows: both ranks refuse the batch
        bad = dict(payload["bf16_batch"])
        bad["clean"] = bad["clean"].copy()
        bad["clean"][PAR_BATCH_MEASUREMENTS + 3, 0, 100] = np.nan
        before = state.params.flat.clone()
        key, k = tt.split_key(key)
        m = step(state, _cuda_batch(torch, bad), k, 0, 0.2, 0.5)
        out["nan_ok"] = bool(m["ok"])
        out["nan_unchanged"] = bool(torch.equal(before, state.params.flat))
        out["bf16_flat"] = state.params.flat.cpu().numpy()
        del model, state, step, batch, before
        torch.cuda.empty_cache()

        # sampling (f32): the batch's rows and the tiles over the ranks
        model, schedule, _ = inference.load_model(payload["ckpt32"],
                                                  device="cuda")
        scfg = SamplerConfig(steps=INFER_STEPS, pred_type="v",
                             use_selfcond=True, cfg_scale=1.5, ladder="t")
        reset_launch_counts()
        with torch.no_grad():
            out["batch_x0"], out["batch_std"] = inference.reconstruct_batch(
                model, schedule, payload["cond"], payload["sigmas"], scfg,
                torch.Generator(device="cuda").manual_seed(5), mesh=mesh,
                avg_seeds=2, amp_calib="mf", return_seed_std=True,
                device="cuda")
        out["batch_launches"] = launch_counts()
        reset_launch_counts()
        with torch.no_grad():
            y = tiled_apply(model, torch.from_numpy(payload["tile_x"]).cuda(),
                            torch.tensor([300, 700], device="cuda"),
                            chunk=PAR_CHUNK, mesh=mesh)
        out["tile_y"] = y.float().cpu().numpy()
        out["tile_launches"] = launch_counts()
    out["shapes"] = shapes.raw
    queue.put(out)
    queue.close()
    queue.join_thread()
    dist.barrier()
    sys.stdout.flush()
    os._exit(0)


def phase_parallel_nccl(torch, tmp):
    """(a) A one-process NCCL group: two attn16k training steps at batch
    16, L 32768, bf16 through ``train(mesh=make_mesh())``, against the same
    steps without a mesh, which they must equal bit for bit.  Returns the
    meshed run's launches."""
    import torch.distributed as dist

    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import pipeline
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.parallel import mesh as pmesh

    tt = _train_module()
    ds = pipeline.synthetic_dataset(2 * TRAIN_BATCH, segment_len=32768,
                                    fs=16384, whiten=True, seed=3,
                                    device="cuda")
    want = {"conv_gn_silu": 14 * 2, "flash_attention": 2 * 2,
            "conv_gn_silu_backward": 7 * 2, "flash_attention_backward": 2}

    def run(name, mesh):
        cfg = attn16k_train_config(tmp, name, epochs=1, p_selfcond=1.0,
                                   p_uncond=0.2)
        return run_counted(torch, lambda: tt.train(cfg, dataset=ds, mesh=mesh,
                                                   device="cuda"),
                           want, f"attn16k train {name}", model=ATTN16K)

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = pmesh.make_mesh()
        backend = dist.get_backend(mesh.group)
        meshed, launches, mesh_s = run("nccl", mesh)
    finally:
        dist.destroy_process_group()
    plain, _, plain_s = run("no mesh", None)
    a, b = meshed["state"].params.flat, plain["state"].params.flat
    diff = float((a - b).abs().max())
    rec = {"phase": "parallel_nccl", "config": "attn16k bf16", "backend":
           backend, "mesh": mesh.shape, "batch": TRAIN_BATCH, "L": 32768,
           "steps": 2, "launches": launches,
           "params_bit_equal": bool(torch.equal(a, b)),
           "params_max_abs_diff": diff,
           "params_max_rel_diff": diff / float(b.abs().max()),
           "seconds": {"mesh": mesh_s, "no_mesh": plain_s},
           "loss": [meshed["history"][0]["avg_per_sample"],
                    plain["history"][0]["avg_per_sample"]]}
    emit(rec)
    check(backend == "nccl" and int(meshed["state"].step) == 2,
          "one-rank NCCL training")
    # AVG over one rank is the identity: any difference is a wiring fault
    check(rec["params_bit_equal"],
          f"NCCL one-rank training vs no mesh: not bit-equal ({diff})")
    return launches


def phase_parallel_tiles(torch, tmp, shapes):
    """(c) A 64 s segment at 16384 Hz through ``reconstruct(tiled_chunk=
    16384)`` and the infer CLI's ``--tiled-chunk``: 64 tiles x CFG = 128
    rows of 16880 samples a forward; launches, wall and device time, peak
    memory, K2's kernel for the 2110-token bottleneck; one tiled U-Net
    forward against the monolithic one at the same L, with attention and
    without (seeded weights), on the measurement and on stationary noise.
    Returns the
    measurement's preparation and the two runs' launches."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import inference
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import infer as infer_cli
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.sampling import SamplerConfig
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.schedules import (
        build_t_schedule,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.parallel.seqtile import tiled_apply

    ckpt = os.path.join(tmp, "attn16k_tiles.msgpack")
    write_checkpoint(dict(ATTN16K, t_embed_max_time=999.0),
                     infer_args(ATTN16K), ckpt, 13)
    model, schedule, _ = inference.load_model(ckpt, device="cuda")
    clean, noise, P = synth_measurement(PAR_L, PAR_FS, 14)
    y = (clean + noise).astype(np.float32)
    t0 = time.perf_counter()
    prep = inference.prepare_measurement(
        y, clean.astype(np.float32), PAR_FS, P, (None, None), INFER_META,
        cond_in_ch=5, whiten=True, whiten_mode="model", ckpt_path=ckpt)
    prep_s = time.perf_counter() - t0
    cfg = SamplerConfig(steps=INFER_STEPS, pred_type="v", use_selfcond=True,
                        cfg_scale=1.5, ladder="t")
    n_steps = len(build_t_schedule(1000, INFER_STEPS, None))
    want = expected_launches(model, n_steps)

    def run(seed):
        return inference.reconstruct(
            model, schedule, prep, cfg,
            torch.Generator(device="cuda").manual_seed(seed),
            tiled_chunk=PAR_CHUNK, amp_calib="mf", device="cuda")

    (x0_raw, x0_white, _), launches, first_s = run_counted(
        torch, lambda: run(0), want, "attn16k tiled infer")
    check(x0_raw.shape == (PAR_L,) and bool(np.isfinite(x0_raw).all()),
          "tiled reconstruction finite, of the segment's length")
    seen = shapes.seen
    k2_shape = ("bfloat16", PAR_ROWS, 4, PAR_TILE_W // 8, 64)
    check(k2_shape in seen["flash_attention"]
          and ("bfloat16", PAR_ROWS, PAR_TILE_W, 7, 64, 8, "cond5")
          in seen["conv_gn_silu"],
          f"the tiled forward ran {PAR_ROWS} rows of {PAR_TILE_W}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run(1)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(2)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    trace = TRACES / "parallel_tiles_trace.json"
    TRACES.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    breakdown = device_breakdown(trace, wall_us)
    check(sum(breakdown["k2_launches_by_kernel"].values())
          == launches["flash_attention"],
          f"the tiled trace holds K2's launches: {breakdown}")

    # one forward by tiles against the monolithic forward (its bottleneck
    # (2, 4, 131072, 64) for K2), on the measurement and on stationary
    # noise in its place: per-tile GroupNorm statistics follow the signal's
    # loudness, which the chirp makes vary along the segment.  The attention
    # model's runs go unrecorded: that K2 shape has no plain version that
    # fits the card (its f32 scores take 275 GB).  The architecture without
    # attention (seeded weights) isolates the GroupNorm part; its
    # monolithic K1 shapes are recorded and checked like the others
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models.unet import UNet1D
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.utils.weights import randomize_

    no_attn = UNet1D(**dict(ATTN16K, use_attention=False),
                     dtype=torch.bfloat16, device="cuda").eval()
    randomize_(no_attn, 17)
    g = torch.Generator(device="cuda").manual_seed(15)
    cond = torch.from_numpy(prep["cond_stack"]).cuda().repeat(2, 1, 1)
    x_t = torch.randn(2, 1, PAR_L, generator=g, device="cuda")
    inputs = {"measurement": torch.cat([x_t, cond, torch.zeros_like(x_t)],
                                       dim=1)}
    inputs["stationary"] = inputs["measurement"].clone()
    inputs["stationary"][:, 1:2] = torch.randn(2, 1, PAR_L, generator=g,
                                               device="cuda")
    t = torch.tensor([300, 700], device="cuda")
    y_rms = prep["cond_stack"][0, 0].reshape(PAR_TILES, -1).std(axis=1)
    versus = {"measurement_y_rms_by_chunk": [float(y_rms.min()),
                                             float(y_rms.max())]}
    for name, net in (("attention", model), ("no_attention", no_attn)):
        LaunchShapes.label = f"tiled vs monolithic, {name}"
        for kind, x in inputs.items():
            record = (contextlib.nullcontext() if name == "no_attention"
                      else shapes.paused())
            with torch.no_grad(), record:
                tiled = tiled_apply(net, x, t, chunk=PAR_CHUNK)
                mono = net(x, t)
            a = tiled.double().cpu().numpy().ravel()
            b = mono.double().cpu().numpy().ravel()
            a0, b0 = a - a.mean(), b - b.mean()
            rec = {"corr": float((a0 * b0).sum() / np.sqrt(
                       (a0 * a0).sum() * (b0 * b0).sum())),
                   "rel_max_dev": float(np.abs(a - b).max() / np.abs(b).max())}
            check(np.isfinite(rec["corr"]) and np.isfinite(rec["rel_max_dev"]),
                  f"tiled vs monolithic, {name}, {kind}")
            versus.setdefault(name, {})[kind] = rec
        LaunchShapes.label = "other"
        x = inputs["measurement"]
        with torch.no_grad(), shapes.paused():
            versus[name]["tiled_forward_ms"] = cuda_ms(
                torch, lambda: tiled_apply(net, x, t, chunk=PAR_CHUNK), 2)
            versus[name]["monolithic_forward_ms"] = cuda_ms(
                torch, lambda: net(x, t), 2)
    versus["monolithic_k2_shape"] = [2, 4, PAR_L // 8, 64]
    del x, x_t, cond, inputs, tiled, mono, no_attn

    npy = os.path.join(tmp, "attn16k_long_y.npy")
    np.save(npy, y)
    outdir = os.path.join(tmp, "tiled_cli_out")
    _, cli_launches, cli_s = run_counted(
        torch, lambda: infer_cli.main([
            "--input-npy", npy, "--fs", str(PAR_FS), "--model", ckpt,
            "--outdir", outdir, "--steps", str(INFER_STEPS),
            "--tiled-chunk", str(PAR_CHUNK), "--amp-calib", "mf",
            "--run-tag", "tiled", "--device", "cuda"]),
        want, "attn16k tiled infer cli")
    recon = np.load(os.path.join(outdir, "recon_tiled.npy"))
    with open(os.path.join(outdir, "metrics_tiled.json")) as fh:
        cli_metrics = json.load(fh)
    check(recon.shape == (PAR_L,) and bool(np.isfinite(recon).all()),
          "the tiled CLI's reconstruction")
    emit({"phase": "parallel_tiles", "config": "attn16k bf16", "L": PAR_L,
          "fs": PAR_FS, "chunk": PAR_CHUNK, "tiles": PAR_TILES,
          "tile_width": PAR_TILE_W, "rows_per_forward": PAR_ROWS,
          "steps": INFER_STEPS, "ladder_steps": n_steps,
          "launches": launches, "launches_per_forward": {
              k: v / n_steps for k, v in launches.items()},
          "host_prep_s": prep_s, "reconstruct_first_s": first_s,
          "reconstruct_s": wall_s, "peak_memory_gb": peak_gb,
          "trace": str(trace.relative_to(TRACES.parent)), **breakdown,
          "k2_tile_shape": list(k2_shape[1:]),
          "tiled_vs_monolithic": versus,
          "cli": {"seconds": cli_s, "launches": cli_launches,
                  "whiten_kind": cli_metrics["whiten_kind"],
                  "residuals": cli_metrics["residuals"]}})
    return prep, launches, cli_launches


def spawn_ranks(fn, payload, shapes, meanwhile=None):
    """Run ``fn(rank, port, payload, queue)`` in ``PAR_RANKS`` spawned
    processes, and ``meanwhile()`` here while they run; returns what each
    put on the queue, in rank order, and the seconds they took.  A failed
    rank raises.  The launch shapes the ranks recorded (their ``shapes``
    entry) go into ``shapes``."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    t0 = time.perf_counter()
    procs = mp.start_processes(fn, args=(_free_port(), payload, queue),
                               nprocs=PAR_RANKS, join=False,
                               start_method="spawn")
    try:
        if meanwhile is not None:
            meanwhile()
    except BaseException:
        for p in procs.processes:
            p.terminate()
        raise
    got = []
    while len(got) < PAR_RANKS:
        try:
            got.append(queue.get(timeout=5))
        except queue_mod.Empty:
            procs.join(timeout=0)        # raises if a rank failed
    while not procs.join():
        pass
    got.sort(key=lambda r: r["rank"])
    for r in got:
        for kernel, raw in r.pop("shapes", {}).items():
            for key, labels in raw.items():
                shapes.raw[kernel].setdefault(key, set()).update(labels)
    return got, time.perf_counter() - t0


def phase_parallel_ranks(torch, tmp, prep, shapes):
    """(b) and (d): two ranks sharing the card in a gloo group (NCCL
    refuses two ranks on one device).  (b) One f32 step at global batch 16
    (8 rows a rank) with injected t and eps against the single-process
    step on the same rows; timed and profiled bf16 steps; a NaN in rank 1's
    rows refused on both.  (d) In f32, so that the check sees the sharding
    and not bf16 rounding: ``reconstruct_batch(mesh=)`` (8 measurements x
    2 seeds = 16 rows) and ``tiled_apply(mesh=)`` over 3 tiles against
    their calls without a mesh.  (e) All of it again on a 1x2
    tensor-parallel mesh (``parallel_tp``); then ``dryrun_multichip(2,
    "cuda")``, a 1x2 tensor-parallel step and the dp = 2 pod artifact, and
    K1 at its shard shapes.  Returns the launches of tensor-parallel rank
    0's timed bf16 steps."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.schedules import (
        build_t_schedule,
    )

    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import graft_entry, inference
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.models.unet import UNet1D
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.sampling import SamplerConfig
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.parallel.seqtile import tiled_apply

    ckpt32 = os.path.join(tmp, "attn16k_f32.msgpack")
    write_checkpoint(dict(ATTN16K, t_embed_max_time=999.0),
                     dict(infer_args(ATTN16K), bf16=False), ckpt32, 16)
    f32_batch = par_train_batch(TRAIN_BATCH, 41, inject=True)
    rng = np.random.default_rng(42)
    payload = {"f32_batch": f32_batch,
               "bf16_batch": par_train_batch(TRAIN_BATCH, 43, inject=False),
               "ckpt32": ckpt32,
               "cond": np.repeat(prep["cond_stack"][:, :, :32768],
                                 PAR_BATCH_MEASUREMENTS, axis=0)
               + 0.1 * rng.standard_normal(
                   (PAR_BATCH_MEASUREMENTS, 5, 32768)).astype(np.float32),
               "sigmas": rng.uniform(0.5, 2.0, PAR_BATCH_MEASUREMENTS),
               "tile_x": rng.standard_normal(
                   (2, 7, PAR_MESH_TILE_L)).astype(np.float32)}
    with tempfile.TemporaryDirectory() as tmp2:
        LaunchShapes.label = "single-process references"
        want_m, want_flat, want_grad = par_f32_step(torch, tmp2, f32_batch)
    model, schedule, _ = inference.load_model(ckpt32, device="cuda")
    scfg = SamplerConfig(steps=INFER_STEPS, pred_type="v", use_selfcond=True,
                         cfg_scale=1.5, ladder="t")
    with torch.no_grad():
        want_x0, want_std = inference.reconstruct_batch(
            model, schedule, payload["cond"], payload["sigmas"], scfg,
            torch.Generator(device="cuda").manual_seed(5), avg_seeds=2,
            amp_calib="mf", return_seed_std=True, device="cuda")
        want_tile = tiled_apply(
            model, torch.from_numpy(payload["tile_x"]).cuda(),
            torch.tensor([300, 700], device="cuda"),
            chunk=PAR_CHUNK).float().cpu().numpy()
    LaunchShapes.label = "other"
    del model
    torch.cuda.empty_cache()

    got, ranks_s = spawn_ranks(_par_rank, payload, shapes)
    r0, r1 = got
    f32_rel = float(np.abs(r0["f32_flat"] - want_flat).max()
                    / np.abs(want_flat).max())
    f32_grad_rel = float(np.abs(r0["f32_grad"] - want_grad).max()
                         / np.abs(want_grad).max())
    f32_loss_rel = abs(r0["f32_step"]["loss"] - want_m["loss"]) / abs(
        want_m["loss"])
    batch_rel = float(np.abs(r0["batch_x0"] - want_x0).max()
                      / np.abs(want_x0).max())
    std_rel = float(np.abs(r0["batch_std"] - want_std).max()
                    / np.abs(want_std).max())
    tile_rel = float(np.abs(r0["tile_y"] - want_tile).max()
                     / np.abs(want_tile).max())
    step_ms = float(np.median(r0["step_ms"]))
    n_fwd = len(build_t_schedule(1000, INFER_STEPS, None))
    emit({"phase": "parallel_gloo", "config": "attn16k", "ranks": PAR_RANKS,
          "backend": r0["backend"], "card_shared": True, "seconds": ranks_s,
          "f32_step": {"global_batch": TRAIN_BATCH,
                       "rows_per_rank": TRAIN_BATCH // PAR_RANKS,
                       "loss_ranks": [r0["f32_step"]["loss"],
                                      r1["f32_step"]["loss"]],
                       "loss_single": want_m["loss"],
                       "loss_rel_err": f32_loss_rel,
                       "grad_norm_ranks": r0["f32_step"]["grad_norm"],
                       "grad_norm_single": want_m["grad_norm"],
                       "grad_max_rel_err": f32_grad_rel,
                       "params_max_rel_err": f32_rel, "tol": MODEL_TOL},
          "bf16_steps": {"step_ms_median": step_ms, "step_ms": r0["step_ms"],
                         "step_ms_rank1": r1["step_ms"],
                         "selfcond": r0["coins"],
                         "samples_per_sec": TRAIN_BATCH / step_ms * 1e3,
                         "launches_rank0": r0["timed_launches"],
                         **r0["profile"]},
          "nan_in_rank1_rows": {"ok": [r0["nan_ok"], r1["nan_ok"]],
                                "unchanged": [r0["nan_unchanged"],
                                              r1["nan_unchanged"]]},
          "reconstruct_batch": {"dtype": "float32",
                                "rows": 2 * PAR_BATCH_MEASUREMENTS,
                                "rows_per_rank_forward":
                                    2 * PAR_BATCH_MEASUREMENTS,
                                "max_rel_err": batch_rel,
                                "seed_std_max_rel_err": std_rel,
                                "launches_rank0": r0["batch_launches"]},
          "tiled_mesh": {"dtype": "float32", "tiles": 3, "padded_tiles": 4,
                         "max_rel_err": tile_rel,
                         "launches_rank0": r0["tile_launches"]}})
    check(r0["backend"] == "gloo", "the ranks' backend")
    check(f32_rel <= MODEL_TOL and f32_grad_rel <= MODEL_TOL
          and f32_loss_rel <= MODEL_TOL,
          f"2-rank f32 step vs single process: params {f32_rel}, gradient "
          f"{f32_grad_rel}, loss {f32_loss_rel}")
    check(r0["f32_step"] == r1["f32_step"]
          and np.array_equal(r0["f32_flat"], r1["f32_flat"])
          and np.array_equal(r0["bf16_flat"], r1["bf16_flat"]),
          "the ranks' parameters stay equal")
    check(not r0["nan_ok"] and not r1["nan_ok"] and r0["nan_unchanged"]
          and r1["nan_unchanged"], "a NaN in rank 1's rows is refused on both")
    check(np.array_equal(r0["batch_x0"], r1["batch_x0"])
          and batch_rel <= MODEL_TOL and std_rel <= MODEL_TOL,
          f"sharded reconstruct_batch vs unsharded: {batch_rel}, {std_rel}")
    check(np.array_equal(r0["tile_y"], r1["tile_y"]) and tile_rel <= MODEL_TOL,
          f"tiled_apply(mesh=) vs unmeshed: {tile_rel}")
    check(r0["batch_launches"] == all_counts({"conv_gn_silu": 7 * n_fwd,
                                               "flash_attention": n_fwd})
          and r0["tile_launches"] == all_counts({"conv_gn_silu": 7,
                                                 "flash_attention": 1})
          and r0["timed_launches"] == all_counts({
              "conv_gn_silu": 7 * (PAR_TIMED_STEPS + sum(r0["coins"])),
              "flash_attention": PAR_TIMED_STEPS + sum(r0["coins"]),
              "conv_gn_silu_backward": 7 * PAR_TIMED_STEPS,
              "flash_attention_backward": PAR_TIMED_STEPS}, model=ATTN16K),
          f"the ranks' launches {r0['batch_launches']} "
          f"{r0['tile_launches']}")

    # (e) the same on a 1x2 tensor-parallel mesh: each rank holds all 16
    # rows and its share of the split blocks' channels and heads
    got, tp_s = spawn_ranks(_par_rank, dict(payload, tp=True), shapes)
    phase_parallel_tp(got, tp_s, want_m, want_flat, want_grad, want_x0,
                      want_std, want_tile, n_fwd)
    tp_launches = got[0]["timed_launches"]

    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(2, device="cuda")
    emit({"phase": "parallel_dryrun", "n_devices": 2, "mesh": "1x2",
          "device": "cuda", "backend": "gloo",
          "seconds": time.perf_counter() - t0})
    # K1 at the dryrun ranks' shard shapes (its tensor-parallel step, f32):
    # Cout / 2 with 4 of the 8 groups, which the ranks launched unrecorded
    dry = UNet1D(in_ch=7, base_ch=16, time_dim=16, depth=2, cond_in_ch=5,
                 use_selfcond=True, device="cuda")
    phase_kernel(torch, "dryrun tp", tp_shard_shapes(dry, 256, PAR_RANKS),
                 ((torch.float32, 2),), groups=8 // PAR_RANKS)
    return tp_launches


def tp_shard_shapes(model, L, n_model):
    """(name, L, Cin, Cout / n) of each ConvBlock of ``model`` that splits
    over ``n_model`` model ranks, at input length L."""
    split, _ = model.tensor_parallel_plan(n_model)
    return [(name, n, cin, cout // n_model)
            for name, n, cin, cout in convblock_shapes(model, L)
            if name in split]


def phase_parallel_tp(got, seconds, want_m, want_flat, want_grad, want_x0,
                      want_std, want_tile, n_fwd):
    """(e): the two tensor-parallel ranks' results against the
    single-process references of (b) and (d); emits ``parallel_tp``."""
    r0, r1 = got
    f32_rel = float(np.abs(r0["f32_flat"] - want_flat).max()
                    / np.abs(want_flat).max())
    f32_grad_rel = float(np.abs(r0["f32_grad"] - want_grad).max()
                         / np.abs(want_grad).max())
    f32_loss_rel = abs(r0["f32_step"]["loss"] - want_m["loss"]) / abs(
        want_m["loss"])
    batch_rel = float(np.abs(r0["batch_x0"] - want_x0).max()
                      / np.abs(want_x0).max())
    std_rel = float(np.abs(r0["batch_std"] - want_std).max()
                    / np.abs(want_std).max())
    tile_rel = float(np.abs(r0["tile_y"] - want_tile).max()
                     / np.abs(want_tile).max())
    fwd = [TP_STEPS[1] + sum(r["coins"]) for r in got]
    emit({"phase": "parallel_tp", "config": "attn16k", "mesh": r0["mesh"],
          "ranks": PAR_RANKS, "backend": r0["backend"], "card_shared": True,
          "note": "two ranks share one card: the times show that tensor "
                  "parallelism runs and what its collectives cost here, "
                  "not how it scales",
          "seconds": seconds,
          "f32_step": {"global_batch": TRAIN_BATCH,
                       "rows_per_rank": TRAIN_BATCH,
                       "loss_ranks": [r0["f32_step"]["loss"],
                                      r1["f32_step"]["loss"]],
                       "loss_single": want_m["loss"],
                       "loss_rel_err": f32_loss_rel,
                       "grad_norm_ranks": r0["f32_step"]["grad_norm"],
                       "grad_norm_single": want_m["grad_norm"],
                       "grad_max_rel_err": f32_grad_rel,
                       "params_max_rel_err": f32_rel, "tol": MODEL_TOL},
          "bf16_steps": {"step_ms_median": float(np.median(r0["step_ms"])),
                         "step_ms_median_rank1": float(
                             np.median(r1["step_ms"])),
                         "step_ms": r0["step_ms"],
                         "step_ms_rank1": r1["step_ms"],
                         "selfcond": r0["coins"],
                         "peak_gb": [r0["peak_gb"], r1["peak_gb"]],
                         "launches_rank0": r0["timed_launches"],
                         "launches_by_shape_rank0":
                             r0["timed_launches_by_shape"],
                         **r0["profile"]},
          "nan_in_batch": {"ok": [r0["nan_ok"], r1["nan_ok"]],
                           "unchanged": [r0["nan_unchanged"],
                                         r1["nan_unchanged"]]},
          "reconstruct_batch": {"dtype": "float32",
                                "rows": 2 * PAR_BATCH_MEASUREMENTS,
                                "max_rel_err": batch_rel,
                                "seed_std_max_rel_err": std_rel,
                                "launches_rank0": r0["batch_launches"]},
          "tiled_mesh": {"dtype": "float32", "max_rel_err": tile_rel,
                         "launches_rank0": r0["tile_launches"]}})
    check(r0["mesh"] == {"data": 1, "model": PAR_RANKS}
          and r0["backend"] == "gloo", f"the tp ranks' mesh {r0['mesh']}")
    check(f32_rel <= MODEL_TOL and f32_grad_rel <= MODEL_TOL
          and f32_loss_rel <= MODEL_TOL,
          f"1x2 tensor-parallel f32 step vs single process: params "
          f"{f32_rel}, gradient {f32_grad_rel}, loss {f32_loss_rel}")
    check(r0["f32_step"] == r1["f32_step"]
          and np.array_equal(r0["f32_flat"], r1["f32_flat"])
          and np.array_equal(r0["bf16_flat"], r1["bf16_flat"]),
          "the tp ranks' parameters stay equal")
    check(not r0["nan_ok"] and not r1["nan_ok"] and r0["nan_unchanged"]
          and r1["nan_unchanged"], "a NaN in the batch is refused on both "
                                   "tp ranks")
    check(np.array_equal(r0["batch_x0"], r1["batch_x0"])
          and batch_rel <= MODEL_TOL and std_rel <= MODEL_TOL
          and tile_rel <= MODEL_TOL,
          f"reconstruct_batch / tiled_apply on a model axis vs no mesh: "
          f"{batch_rel}, {std_rel}, {tile_rel}")
    for r, n in zip(got, fwd):
        check(r["timed_launches"] == all_counts({
            "conv_gn_silu": 7 * n, "flash_attention": n,
            "conv_gn_silu_backward": 7 * TP_STEPS[1],
            "flash_attention_backward": TP_STEPS[1], EPILOGUE: 0}),
              f"tp rank {r['rank']}: timed launches {r['timed_launches']} "
              f"for {n} forwards")
    k1 = r0["timed_launches_by_shape"]["conv_gn_silu"]
    check(all(key.split()[4] in ("32", "64", "128") and key.split()[5] == "4"
              for key in k1),
          f"tp rank 0 launched K1 at {sorted(k1)}, not at Cout / 2 with "
          f"4 groups")
    check(r0["batch_launches"] == all_counts({"conv_gn_silu": 7 * n_fwd,
                                               "flash_attention": n_fwd}),
          f"the tp ranks' sampling launches {r0['batch_launches']}")


# the data phase: the README quickstart's gw-gen corpus as written, a 16 kHz
# corpus in attn16k's domain, a low-mass top-up merged into the first, and
# gw-train --streaming on the merged corpus at pn128 width
DATA_SPINS = ["--spin1-min", "-0.8", "--spin1-max", "0.8",
              "--spin2-min", "-0.8", "--spin2-max", "0.8"]
DATA_QUICKSTART = ["--mode", "grid", "--num-samples", "2000",
                   "--mass1-min", "10", "--mass1-max", "90", "--mass2-min",
                   "10", "--mass2-max", "90", "--grid-steps", "9",
                   "--snr-min", "8", "--snr-max", "30", *DATA_SPINS,
                   "--save-psd", "--shuffle"]
DATA_16K = ["--mode", "random", "--num-samples", "256", "--sampling-rate",
            "16384", "--mass1-min", "20", "--mass1-max", "50", "--mass2-min",
            "20", "--mass2-max", "50", "--spin1-min", "-0.5", "--spin1-max",
            "0.5", "--spin2-min", "-0.5", "--spin2-max", "0.5", "--snr-min",
            "8", "--snr-max", "30", "--save-psd"]
DATA_TOPUP = ["--mode", "random", "--num-samples", "256", "--mass1-min", "10",
              "--mass1-max", "20", "--mass2-min", "10", "--mass2-max", "20",
              "--snr-min", "8", "--snr-max", "30", *DATA_SPINS, "--save-psd",
              "--shuffle", "--seed", "124"]
DATA_TRAIN_EPOCHS = 2
STREAM_CONFIG = "pn128 stream"
DATA_TRAIN_MODEL = ["--base_ch", "128", "--time_dim", "128", "--depth", "3"]
DATA_STREAM_CHUNK = 256
DATA_WELCH_ROWS = 64
DATA_CHUNK_ROWS = 8            # the card-against-CPU chunk, longest bucket
SNR_RTOL = 1e-3
# Welch against scipy (float64) on the bins at or above f_lower: rtol 2e-3
# (the JAX package's bar) plus 1e-6 of the row's largest bin, because a
# float32 rfft's rounding reaches about 1e-7 of its largest bin (2.3e-7
# measured on the CPU) and the aLIGO PSD spans 1e6 from its minimum to its
# maximum in band
WELCH_RTOL = 2e-3
WELCH_ATOL_REL = 1e-6


def corpus_gates(torch, path, name):
    """The repo's own checks of a gw-gen corpus: every row's matched-filter
    SNR in float64 numpy from the stored signal and model PSD (f >=
    f_lower) within ``SNR_RTOL`` of its snr column; the noise whitened by
    the model PSD has std sqrt(fs / 2) times sqrt(in-band share) (median
    within 2%, every row within 10%); finite rows of the stated lengths."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import hdf5io
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data.pipeline import (
        whiten_weight_np,
    )

    with hdf5io.open_corpus(path, "", "") as f:
        fs = float(f.attrs["sampling_rate"])
        f_lower = float(f["psd_f_lower"][0])
        snr_col = np.asarray(f["snr"][:], np.float64)
        lengths = np.asarray(f["lengths"][:])
        snr_err, std_ratio = [], []
        for i in range(len(lengths)):
            h = np.asarray(f["signal"][i], np.float64)
            noise = np.asarray(f["noise"][i], np.float64)
            P = np.asarray(f["psd_model"][i], np.float64)
            n = len(h)
            check(n == lengths[i] and len(P) == n // 2 + 1
                  and np.isfinite(h).all() and np.isfinite(noise).all(),
                  f"{name} row {i}: shape or values")
            freqs = np.fft.rfftfreq(n, 1.0 / fs)
            valid = (freqs >= f_lower) & (P > 0)
            hf = np.fft.rfft(h) / fs
            snr = np.sqrt(4.0 * fs / n * np.sum(
                np.abs(hf[valid]) ** 2 / P[valid]))
            snr_err.append(abs(snr / snr_col[i] - 1.0))
            w = np.fft.irfft(np.fft.rfft(noise) * whiten_weight_np(P), n=n)
            share = valid.sum() / len(P)
            std_ratio.append(float(np.std(w) / np.sqrt(fs / 2.0 * share)))
    std_ratio = np.asarray(std_ratio)
    check(max(snr_err) <= SNR_RTOL,
          f"{name}: matched-filter SNR off by {max(snr_err):.2e}")
    check(abs(np.median(std_ratio) - 1.0) <= 0.02
          and np.all(np.abs(std_ratio - 1.0) <= 0.10),
          f"{name}: whitened noise std ratio {std_ratio.min():.3f} to "
          f"{std_ratio.max():.3f}")
    return {"rows": int(len(lengths)), "snr_max_rel_err": float(max(snr_err)),
            "whitened_noise_std_over_sqrt_fs_2": {
                "median": float(np.median(std_ratio)),
                "min": float(std_ratio.min()), "max": float(std_ratio.max())},
            "lengths": {str(k): int(v) for k, v in zip(
                *np.unique(lengths, return_counts=True))}}


def welch_gate(torch, path):
    """The Welch PSDs the card computed for gw-gen against
    ``scipy.signal.welch`` in float64 on the first ``DATA_WELCH_ROWS`` rows,
    on the bins at or above f_lower."""
    from scipy.signal import welch as scipy_welch

    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import hdf5io

    worst = 0.0
    with hdf5io.open_corpus(path, "", "") as f:
        fs = float(f.attrs["sampling_rate"])
        nperseg = int(f.attrs["psd_welch_nperseg"])
        f_lower = float(f["psd_f_lower"][0])
        for i in range(DATA_WELCH_ROWS):
            y = np.asarray(f["noisy"][i], np.float64)
            fw, Pw = scipy_welch(y, fs=fs, nperseg=min(nperseg, len(y)))
            got_f = np.asarray(f["psd_welch_freqs"][i])
            got = np.asarray(f["psd_welch"][i])
            check(np.allclose(got_f, fw, rtol=1e-6), f"Welch grid, row {i}")
            band = fw >= f_lower
            bound = WELCH_RTOL * Pw[band] + WELCH_ATOL_REL * Pw.max()
            err = np.abs(got[band] - Pw[band])
            check(np.all(err <= bound), f"Welch row {i}: {np.max(err / bound)}"
                  " of the bound")
            worst = max(worst, float(np.max(np.abs(got[band] / Pw[band] - 1))))
    return {"rows": DATA_WELCH_ROWS, "max_rel_err_in_band": worst,
            "rtol": WELCH_RTOL, "atol_of_row_max": WELCH_ATOL_REL}


def chunk_card_vs_cpu(torch, argv, bucket):
    """``DATA_CHUNK_ROWS`` specs of one bucket of ``argv``'s corpus (the
    longest, or the one with the most samples) synthesised by ``generate``
    on the card and on the CPU from the same normal draws (made on the CPU,
    then moved); the largest difference of each output over its peak."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import gen

    args = gen.build_parser().parse_args(argv + ["--output-path", "x.npz"])
    args.f_taper_frac = 0.85
    specs = gen.build_specs(args, np.random.default_rng(args.seed))
    specs = specs[:args.num_samples]
    buckets = gen.bucket_specs(specs, args)
    n = (max(buckets) if bucket == "longest"
         else max(buckets, key=lambda k: len(buckets[k])))
    sub = [specs[i] for i in buckets[n][:DATA_CHUNK_ROWS]]
    normals = gen._normals

    def cpu_draws(seed, device):
        g = torch.Generator().manual_seed(seed)
        return lambda rows, nf: tuple(
            torch.randn(rows, nf, generator=g).to(device) for _ in range(2))

    gen._normals = cpu_draws
    try:
        t0 = time.perf_counter()
        card = gen.generate(sub, args, "cuda")
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = gen.generate(sub, args, "cpu")
        cpu_s = time.perf_counter() - t0
    finally:
        gen._normals = normals
    errs = {k: max(float(np.abs(card[i][k] - cpu[i][k]).max()
                         / np.abs(cpu[i][k]).max()) for i in cpu)
            for k in ("signal", "noise", "psd")}
    return {"bucket": bucket, "n": n, "rows": len(sub),
            "max_err_of_peak": errs,
            "within_bars": errs["signal"] <= 3e-3 and errs["noise"] <= 1e-5
            and errs["psd"] <= 1e-5, "card_s": card_s, "cpu_s": cpu_s}


def phase_data(torch, tmp):
    """The data side on the card, through the CLIs in-process: gw-gen of
    the README quickstart corpus (grid, 2000 samples, 10-90 Msun, spins
    +-0.8, fs 4096, every PSD saved, a ragged .npz), a 16 kHz corpus, a
    low-mass top-up; gw-merge of the first and the top-up; gw-train
    --streaming on the merged corpus at pn128 width (bf16, batch 16,
    chunks of 256, model whitening, 2 epochs, K1 counted); gw-infer on its
    index 0.  Gates: each corpus's SNR and whitened noise, the card's Welch
    against scipy, chunks of the most common and the longest buckets card
    against CPU, the
    streaming batches bit-equal to the dense loader's (shuffle off).
    Returns the launches of the training and infer runs, and the merged
    corpus's bucket lengths."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import gen
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import infer as infer_cli
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import merge
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli import train as train_cli
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import hdf5io
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import pipeline as dpipe

    paths = {k: os.path.join(tmp, f"{k}.npz")
             for k in ("quickstart", "fs16k", "topup", "merged")}
    corpora = {}
    for name, argv in (("quickstart", DATA_QUICKSTART), ("fs16k", DATA_16K),
                       ("topup", DATA_TOPUP)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        summary = gen.main(argv + ["--output-path", paths[name]])
        wall = time.perf_counter() - t0
        rec = {"phase": "data_gen", "corpus": name, "argv": " ".join(argv),
               "samples": summary["n"], "buckets": summary["buckets"],
               "seconds": summary["seconds"], "wall_s": wall,
               "samples_per_s": summary["n"] / wall,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "file_mb": os.path.getsize(paths[name]) / 1e6}
        rec["gates"] = corpus_gates(torch, paths[name], name)
        corpora[name] = rec
        emit(rec)
    emit({"phase": "data_welch", "corpus": "quickstart",
          **welch_gate(torch, paths["quickstart"])})
    # the gates: a chunk of the quickstart's most common bucket and of each
    # corpus's longest (65536 samples), all against the same bars
    for name, argv, bucket in (("quickstart", DATA_QUICKSTART, "largest"),
                               ("quickstart", DATA_QUICKSTART, "longest"),
                               ("fs16k", DATA_16K, "longest")):
        rec = chunk_card_vs_cpu(torch, argv, bucket)
        emit({"phase": "data_chunk_card_vs_cpu", "corpus": name, **rec})
        check(rec["within_bars"], f"card against CPU: {rec}")

    t0 = time.perf_counter()
    merge.main(["--output-path", paths["merged"], paths["quickstart"],
                paths["topup"]])
    merge_s = time.perf_counter() - t0
    n_merged = hdf5io.num_samples(paths["merged"])
    check(n_merged == corpora["quickstart"]["samples"]
          + corpora["topup"]["samples"], f"gw-merge: {n_merged} rows")
    with hdf5io.open_corpus(paths["merged"], "", "") as f:
        check(f["noisy"].ragged and "config_args" in f.attrs
              and "merged_from" in f.attrs, "the merged twin")
    emit({"phase": "data_merge", "rows": n_merged, "seconds": merge_s,
          "file_mb": os.path.getsize(paths["merged"]) / 1e6})

    # streaming against dense, shuffle off: bit-equal batches
    kw = dict(whiten=True, whiten_mode="model")
    stream = dpipe.StreamingDataset(paths["merged"], chunk=DATA_STREAM_CHUNK,
                                    **kw)
    t0 = time.perf_counter()
    dense = dpipe.prepare_dataset(paths["merged"], **kw)
    dense_s = time.perf_counter() - t0
    check(stream.bucket_lengths == dense.bucket_lengths,
          "streaming and dense buckets")
    n_b = 0
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)         # not drawn from: no shuffle
    for a, b in zip(dpipe.iterate_batches(stream, TRAIN_BATCH, rng,
                                          shuffle=False),
                    dpipe.iterate_batches(dense, TRAIN_BATCH, rng,
                                          shuffle=False)):
        check(all(np.array_equal(a[k], b[k]) for k in b),
              f"streaming batch {n_b} differs from the dense loader's")
        n_b += 1
    stream_s = time.perf_counter() - t0
    n_batches = stream.num_batches(TRAIN_BATCH)
    check(n_b == n_batches == dpipe.num_batches(dense, TRAIN_BATCH),
          f"batch counts: {n_b}, {n_batches}")
    stream_buckets = stream.bucket_lengths
    emit({"phase": "data_stream_vs_dense", "batches": n_b, "bit_equal": True,
          "buckets": stream.bucket_lengths, "dense_prepare_s": dense_s,
          "stream_epoch_s": stream_s,
          "peak_live_samples": stream.peak_live_samples})
    del dense, stream

    # gw-train --streaming at pn128 width; the coins the run will draw
    tt = _train_module()
    d = os.path.join(tmp, "stream_train")
    log = os.path.join(tmp, "stream_train.jsonl")
    argv = ["--data", paths["merged"], "--streaming", "--stream-chunk",
            str(DATA_STREAM_CHUNK), *DATA_TRAIN_MODEL,
            "--batch-size", str(TRAIN_BATCH), "--whiten", "1",
            "--whiten_mode", "model", "--pred_type", "v", "--t_min_frac", "0",
            "--warmup_steps", "4", "--epochs", str(DATA_TRAIN_EPOCHS),
            "--model_dir", d, "--log-jsonl", log, "--device", "cuda"]
    steps = n_batches * DATA_TRAIN_EPOCHS
    key = tt.split_key(tt.key_from_seed(42))[0]
    heads = 0
    for _ in range(steps):
        key, k = tt.split_key(key)
        heads += tt._uniform(k) < 0.5
    torch.cuda.reset_peak_memory_stats()
    out, train_l, train_s = run_counted(
        torch, lambda: train_cli.main(argv),
        {"conv_gn_silu": 7 * (steps + heads),
         "conv_gn_silu_backward": 7 * steps}, "pn128 streaming train",
        model=FLAGSHIP)
    peak = torch.cuda.max_memory_allocated() / 1e9
    with open(log) as fh:
        ends = [r for r in map(json.loads, fh) if r["phase"] == "epoch_end"]
    hist = [h["avg_per_sample"] for h in out["history"]]
    check(len(ends) == DATA_TRAIN_EPOCHS and all(np.isfinite(hist))
          and ends[0]["h2d_bytes"] > 0 and ends[1]["h2d_bytes"] == 0,
          f"gw-train --streaming: {ends}")
    emit({"phase": "data_train_stream", "config": "pn128 bf16",
          "rows": n_merged, "batch": TRAIN_BATCH, "epochs": DATA_TRAIN_EPOCHS,
          "steps": steps, "selfcond_steps": int(heads), "seconds": train_s,
          "launches": train_l, "avg_per_sample": hist,
          "samples_per_sec": [e["samples_per_sec"] for e in ends],
          "h2d_bytes": [e["h2d_bytes"] for e in ends],
          "peak_live_samples": ends[-1]["peak_live_samples"],
          "peak_mem_gb": peak})

    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.schedules import (
        build_t_schedule,
    )

    outdir = os.path.join(tmp, "stream_infer")
    forwards = len(build_t_schedule(1000, INFER_STEPS, None))
    _, infer_l, infer_s = run_counted(
        torch, lambda: infer_cli.main([
            "--input-h5", paths["merged"], "--index", "0", "--model",
            out["checkpoint"], "--outdir", outdir, "--steps",
            str(INFER_STEPS), "--device", "cuda"]),
        {"conv_gn_silu": 7 * forwards, "flash_attention": 0},
        "pn128 streaming infer cli", model=FLAGSHIP)
    recon = [f for f in os.listdir(outdir) if f.startswith("recon_ddim")]
    rec_arr = np.load(os.path.join(outdir, recon[0]))
    check(len(recon) == 1 and rec_arr.shape[0]
          == hdf5io.load_measurement(paths["merged"], 0)[0].shape[0]
          and bool(np.isfinite(rec_arr).all()), "gw-infer on the merged twin")
    emit({"phase": "data_infer", "index": 0, "L": int(rec_arr.shape[0]),
          "seconds": infer_s, "launches": infer_l})
    return ({"pn128 streaming train": train_l,
             "pn128 streaming infer cli": infer_l}, stream_buckets, paths)


# the tools phase: the port's twins of the repo's Python tools, on the
# evals phase's pn128 checkpoint and corpus and the data phase's corpora
TOOLS_STEPS = 10          # the harnesses' 50 sampler steps, cut
TOOLS_SEEDS = 2           # their 4 seeds, cut
TOOLS_SMALL = dict(B=4, L=512, steps=3)   # bench_population card vs CPU


def _glitch_level0_direct(torch, corpus, ckpt, indices):
    """The glitch harness's level 0 computed directly: the samples prepared
    as the tool prepares them (no glitch), one ``reconstruct_batch`` with
    a generator seeded as the tool's seam seeds it, scored by
    ``score_last_window``; the per-sample corr."""
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import hdf5io
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.evals import metrics as M
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.inference import (
        dewhiten_back,
        load_model,
        prepare_measurement,
        reconstruct_batch,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.sampling import (
        SamplerConfig,
    )

    model, schedule, ck = load_model(ckpt, device="cuda")
    preps = [prepare_measurement(
        np.asarray(y, np.float64), clean, fs, P, welch, meta, cond_in_ch=5,
        M_SCALE=ck["meta_scale"]["M"], Q_SCALE=ck["meta_scale"]["q"],
        whiten=True, whiten_mode=ck["whiten_mode_resolved"],
        sigma_mode=ck["sigma_mode"], sigma_fixed=1.0, ckpt_path=ckpt)
        for (y, clean, fs, P, welch, meta)
        in hdf5io.load_measurements(corpus, indices)]
    cfg = SamplerConfig(steps=TOOLS_STEPS, start_t=999, ladder="lambda",
                        pred_type=ck["pred_type"], use_selfcond=True)
    xw = reconstruct_batch(
        model, schedule, np.concatenate([p["cond_stack"] for p in preps]),
        np.array([p["sigma"] for p in preps], np.float32), cfg,
        torch.Generator(device="cuda").manual_seed(0),
        clean_norms=np.concatenate([p["clean_norm"] for p in preps]),
        avg_seeds=TOOLS_SEEDS, device="cuda")
    return [M.score_last_window(dewhiten_back(np.asarray(xw[j], np.float64),
                                              p), p["clean_raw"],
                                p["fs"])["corr_last"]
            for j, p in enumerate(preps)]


def phase_tools(torch, tmp, corpus, ckpt, data_paths):
    """The port's tools on the card: ``bench_population`` at its defaults
    (B 256, L 4096, 100 steps, cfg 1.5: K1 at 512 rows a forward; timed,
    counted, one population profiled, peak memory) and a small f32
    population card against CPU; every ``bench_kernels`` section, each row
    within the port's bars; the glitch and spin harnesses on the pn128
    checkpoint and corpus (cut to 10 steps and 2 seeds), the glitch-SNR-0
    level against a direct ``reconstruct_batch`` on the same draws;
    ``pn_fidelity`` on the card and on the CPU; ``merge_h5`` byte-equal to
    gw-merge.  Returns the launches of the counted runs."""
    import filecmp

    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.ops.sampling import (
        FixedNoise,
    )
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.tools import (
        bench_kernels,
        bench_population,
        glitch_robustness,
        merge_h5,
        pn_fidelity,
        spin_sensitivity,
    )

    launches = {}
    # bench_population at its defaults: a warm-up and 3 timed populations
    bp = bench_population
    pops = 1 + bp.REPS
    forwards = ladder_len(100, None)
    torch.cuda.reset_peak_memory_stats()
    rec, got, secs = run_counted(
        torch, bp.run, {"conv_gn_silu": 7 * forwards * pops,
                        "flash_attention": 0}, "bench_population",
        model=bp.MODEL)
    launches["bench_population"] = got
    print(json.dumps(rec), flush=True)              # the tool's own line
    check(rec["samples_per_sec"] > 0 and rec["batch"] == 256
          and rec["L"] == 4096 and rec["steps"] == 100,
          f"bench_population {rec}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    from torch.profiler import ProfilerActivity, profile

    model, schedule, cond = bp.setup(256, 4096, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bp.population(model, schedule, cond, 100, gen).cpu()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    trace = TRACES / "bench_population_trace.json"
    TRACES.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    del model, cond
    emit({"phase": "tools_bench_population", "record": rec,
          "seconds_counted": secs, "populations": pops,
          "rows_per_forward": 2 * rec["batch"], "forwards": forwards,
          "launches": got, "peak_mem_gb": peak})
    emit({"phase": "tools_bench_population_profile", "profiled_populations": 1,
          "trace": str(trace.relative_to(TRACES.parent)),
          **device_breakdown(trace, wall_us)})

    # a small f32 population: the card against the CPU plain path, the same
    # weights, conditioning and x_T
    s = TOOLS_SMALL
    g = torch.Generator().manual_seed(3)
    cond = torch.randn(s["B"], 5, s["L"], generator=g)
    z = torch.randn(s["B"], 1, s["L"], generator=g)
    outs, small_l = {}, {}
    for dev in ("cuda", "cpu"):
        m, sch, _ = bp.setup(s["B"], s["L"], dev, dtype=torch.float32)
        outs[dev], small_l[dev], _ = run_counted(
            torch, lambda: bp.population(m, sch, cond.to(dev), s["steps"],
                                         FixedNoise(z)).cpu(),
            {"conv_gn_silu": 7 * ladder_len(s["steps"], None)
             if dev == "cuda" else 0, "flash_attention": 0},
            f"bench_population small {dev}")
    rel = float((outs["cuda"] - outs["cpu"]).abs().max()
                / outs["cpu"].abs().max())
    emit({"phase": "tools_bench_population_small_vs_cpu", **s,
          "max_rel_err": rel, "tol": MODEL_TOL,
          "card_launches": small_l["cuda"]})
    check(rel <= MODEL_TOL, f"bench_population small card vs CPU {rel}")

    # every bench_kernels section at the root tool's shapes
    rows = {}
    for name, fn in bench_kernels.SECTIONS.items():
        rows[name], got, secs = run_counted(
            torch, lambda: fn("cuda"), None, f"bench_kernels {name}")
        launches[f"bench_kernels {name}"] = got
        for r in rows[name]:
            emit({"phase": "tools_bench_kernels", "section": name, **r})
            if "within_tol" in r:
                check(r["within_tol"], f"bench_kernels {name}: {r}")
    unet_row = rows["unet"][-1]
    check(unet_row["max_rel_err_vs_plain_f32"] <= MODEL_TOL,
          f"bench_kernels unet f32 kernel path vs plain path: {unet_row}")
    check(all(r["route"] == ("wgmma" if r["dtype"] == "bfloat16" else "fma")
              for r in rows["attn"]), "bench_kernels attention routes")

    # the glitch and spin harnesses
    cuts = ["--steps", str(TOOLS_STEPS), "--avg-seeds", str(TOOLS_SEEDS),
            "--device", "cuda"]
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.data import hdf5io

    n_rows = hdf5io.num_samples(corpus)
    fwd = ladder_len(TOOLS_STEPS, 999, "lambda")
    glitch, got, secs = run_counted(
        torch, lambda: glitch_robustness.main(
            ["--input-h5", corpus, "--model", ckpt] + cuts),
        {"conv_gn_silu": 7 * fwd * 4, "flash_attention": 0},
        "glitch_robustness", model=FLAGSHIP)
    launches["glitch_robustness"] = got
    indices = [r["index"] for r in glitch["levels"][0]["per_sample"]]
    direct = _glitch_level0_direct(torch, corpus, ckpt, indices)
    level0 = [r["corr"] for r in glitch["levels"][0]["per_sample"]]
    diff0 = float(np.max(np.abs(np.asarray(level0) - np.asarray(direct))))
    emit({"phase": "tools_glitch_robustness", "cuts": {
              "steps": "50 -> 10", "avg_seeds": "4 -> 2"},
          "seconds": secs, "launches": got, "rows_per_forward":
              2 * TOOLS_SEEDS * len(indices),
          "level0_vs_direct_max_abs": diff0,
          "levels": [{k: lv[k] for k in ("glitch_snr", "corr_mean",
                                         "res_flatness_mean",
                                         "res_clean_corr_mean")}
                     for lv in glitch["levels"]],
          "corr_drop_at_max": glitch["corr_drop_at_max"]})
    check(glitch["n"] == min(12, n_rows) and diff0 <= 1e-6
          and all(np.isfinite(lv["corr_mean"]) for lv in glitch["levels"]),
          f"glitch_robustness level 0 against reconstruct_batch: {diff0}")
    spin, got, secs = run_counted(
        torch, lambda: spin_sensitivity.main(
            ["--input-h5", corpus, "--model", ckpt] + cuts),
        {"conv_gn_silu": 7 * fwd * 2, "flash_attention": 0},
        "spin_sensitivity", model=FLAGSHIP)
    launches["spin_sensitivity"] = got
    emit({"phase": "tools_spin_sensitivity", "cuts": {
              "steps": "50 -> 10", "avg_seeds": "4 -> 2"},
          "seconds": secs, "launches": got,
          **{k: spin[k] for k in ("corr_true", "corr_spin0", "gap", "n")}})
    # the corpus's spins are 0, so zeroing them changes nothing: with the
    # noise restarted for each run the two runs are the same
    check(spin["n"] == min(16, n_rows) and spin["gap"] == 0.0,
          f"spin_sensitivity on a spinless corpus: gap {spin['gap']}")

    # pn_fidelity on the card and on the CPU
    fid = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        fid[dev] = pn_fidelity.main(["--out", os.path.join(
            tmp, f"pn_fidelity_{dev}.json"), "--device", dev])
        fid[dev]["seconds"] = time.perf_counter() - t0
    table = [{"m1": a["m1"], "m2": a["m2"], "chi": a["chi"], "n": a["n"],
              "mismatch_card": a["mismatch"], "mismatch_cpu": b["mismatch"],
              "core_card": a["core_mismatch"], "core_cpu": b["core_mismatch"]}
             for a, b in zip(fid["cuda"]["rows"], fid["cpu"]["rows"])]
    worst = max(abs(r["mismatch_card"] - r["mismatch_cpu"]) for r in table)
    emit({"phase": "tools_pn_fidelity", "rows": table,
          "card_vs_cpu_max_abs": worst,
          "mismatch_max": {d: fid[d]["mismatch_max"] for d in fid},
          "mismatch_median": {d: fid[d]["mismatch_median"] for d in fid},
          "seconds": {d: fid[d]["seconds"] for d in fid}})
    check(worst <= 1e-6, f"pn_fidelity card against CPU: {worst}")

    # merge_h5 over the data phase's two corpora, against gw-merge's file
    shim = os.path.join(tmp, "merged_shim.npz")
    t0 = time.perf_counter()
    merge_h5.main(shim, [data_paths["quickstart"], data_paths["topup"]])
    merge_s = time.perf_counter() - t0
    same = filecmp.cmp(shim, data_paths["merged"], shallow=False)
    emit({"phase": "tools_merge_h5", "seconds": merge_s, "byte_equal": same,
          "mb": os.path.getsize(shim) / 1e6})
    check(same, "merge_h5's file differs from gw-merge's")
    return launches


class LaunchShapes:
    """While installed (``with``), the input shapes each kernel is launched
    at: it wraps each kernel's launch body (``_launch`` of the forward
    kernels, ``_launch_backward`` of K1B and K2B, which the registered op
    calls once per launch) and puts the shape into a set, one tuple a
    launch on the host, under the label of the run in progress
    (``run_counted`` sets it; "other" elsewhere).  K1's key is (dtype,
    rows, L, Cin, Cout, groups, epilogue), the epilogue "none", "film" or
    "cond<K>" (K the conditioning's channels); its decoder route's (dtype,
    rows, L, C_h, C_s, Cout, groups, epilogue), L the skip's length;
    K1B's (dtype, rows, L, Cin, Cout, groups); K2's and K2B's (dtype, B, H,
    L, D); the head's (dtype, rows, L_h, C, L0, C_in)."""

    label = "other"
    # kernel -> (its module in ops/kernels, its launch body there)
    KERNELS = {"conv_gn_silu": ("conv_gn_silu", "_launch"),
               "conv_gn_silu_decoder": ("conv_gn_silu", "_launch_decoder"),
               "flash_attention": ("flash_attention", "_launch"),
               "conv_gn_silu_backward": ("conv_gn_silu", "_launch_backward"),
               "flash_attention_backward": ("flash_attention",
                                            "_launch_backward"),
               HEAD: ("unet_head", "_launch")}

    def __init__(self):
        import importlib

        self.mods = {k: importlib.import_module(f"{PORT}.ops.kernels.{m}")
                     for k, (m, _) in self.KERNELS.items()}
        self.bodies = {k: getattr(self.mods[k], attr)
                       for k, (_, attr) in self.KERNELS.items()}
        self.raw = {k: {} for k in self.KERNELS}     # shape -> labels
        self.counts = {k: {} for k in self.KERNELS}  # shape -> launches

    def _wrap(self, kernel):
        body, raw = self.bodies[kernel], self.raw[kernel]
        counts = self.counts[kernel]
        conv = kernel.startswith("conv_gn_silu")
        o = int(kernel.endswith("_backward"))   # a backward's dout first

        def launch(*args):
            # hashable as they come, normalised by ``seen``
            if kernel == "conv_gn_silu_decoder":   # h, skip, W, ..., groups
                key = (args[0].dtype, args[0].shape, args[1].shape,
                       args[2].shape, args[6])
            elif kernel == HEAD:                   # h, x, W, b
                key = (args[0].dtype, args[0].shape, args[1].shape)
            elif conv:
                key = (args[o].dtype, args[o].shape, args[o + 1].shape,
                       args[o + 5])
            else:
                key = (args[o].dtype, args[o].shape)
            if kernel in ("conv_gn_silu", "conv_gn_silu_decoder"):
                # film and r follow eps
                first = 8 if kernel == "conv_gn_silu_decoder" else 7
                film, r = (*args[first:first + 2], None, None)[:2]
                key += ("none" if film is None else "film" if r is None
                        else f"cond{r.shape[-1]}",)
            raw.setdefault(key, set()).add(LaunchShapes.label)
            counts[key] = counts.get(key, 0) + 1
            return body(*args)

        return launch

    @staticmethod
    def _norm(kernel, key):
        dname = str(key[0]).split(".")[1]
        if kernel == "conv_gn_silu_decoder":
            (B, _, Ch), (_, L, Cs), Cout = key[1], key[2], key[3][2]
            return (dname, B, L, Ch, Cs, Cout, int(key[4]), key[5])
        if kernel == HEAD:
            return (dname, *key[1], *key[2][1:])
        return ((dname, *key[1][:2], *key[2][1:], int(key[3]), *key[4:])
                if kernel.startswith("conv_gn_silu") else (dname, *key[1]))

    @property
    def seen(self):
        """{kernel: {key: labels}} with K1's key (dtype, rows, L, Cin, Cout,
        groups, epilogue), its decoder route's (dtype, rows, L, C_h, C_s,
        Cout, groups, epilogue), K1B's without the epilogue, K2's (dtype,
        B, H, L, D) and the head's (dtype, rows, L_h, C, L0, C_in), dtype
        by name."""
        out = {k: {} for k in self.KERNELS}
        for k, raw in self.raw.items():
            for key, labels in raw.items():
                out[k].setdefault(self._norm(k, key), set()).update(labels)
        return out

    def launches_by_shape(self):
        """{kernel: {"key": launches}} since the last ``reset_counts``."""
        return {k: {" ".join(map(str, self._norm(k, key))): n
                    for key, n in c.items()} for k, c in self.counts.items()}

    def reset_counts(self):
        for c in self.counts.values():
            c.clear()

    def __enter__(self):
        for k, (_, attr) in self.KERNELS.items():
            setattr(self.mods[k], attr, self._wrap(k))
        return self

    def __exit__(self, *exc):
        for k, (_, attr) in self.KERNELS.items():
            setattr(self.mods[k], attr, self.bodies[k])

    @contextlib.contextmanager
    def paused(self):
        """The launches inside go unrecorded."""
        self.__exit__()
        try:
            yield
        finally:
            self.__enter__()


def k1_sum(recs):
    """K1 records summed over their blocks (one forward when the records
    are its 7 ConvBlocks); ``device_ms`` from the profiled pass split."""
    out = {key: sum(r[key] for r in recs) for key in (
        "kernel_ms", "plain_ms", "library_ms", "bound_ms",
        "two_pass_floor_ms")}
    splits = [r["split_ms"] for r in recs]
    out["device_ms"] = (sum(sum(sp.values()) for sp in splits)
                        if all(isinstance(sp, dict) for sp in splits)
                        else "not measured")
    out.update(rows=recs[0]["rows"], L=max(r["L"] for r in recs),
               blocks=len(recs),
               max_abs_err=max(r["max_abs_err"] for r in recs))
    return out


def phase_launched_shapes(torch, shapes, k1, k2, kb, kd, kh):
    """Every shape a kernel was launched at while ``shapes`` recorded (the
    main paths, the small checks against the CPU, the gradient checks, the
    training runs' backward kernels) against the kernel's plain version:
    the shapes no check of the kernel phases covered, one by one, at the
    tolerances of the kernel phases (K1B, K2B and the head without
    timing).  Returns K1's, its decoder route's, K2's and the head's
    records of every launched shape by run label, and the coverage."""
    seen = shapes.seen
    key1 = ("dtype", "rows", "L", "Cin", "Cout", "groups")
    key2 = ("dtype", "B", "H", "L", "D")
    done1 = {tuple(r[k] for k in key1 + ("epilogue",)): r for r in k1}
    done2 = {tuple(r[k] for k in key2): r for r in k2}
    keyd = ("dtype", "rows", "L", "Ch", "Cs", "Cout", "groups", "epilogue")
    doned = {tuple(r[k] for k in keyd): r for r in kd}
    keyh = ("dtype", "rows", "Lh", "C", "L0", "Cin")
    doneh = {tuple(r[k] for k in keyh): r for r in kh}
    done = {"conv_gn_silu": done1, "conv_gn_silu_decoder": doned,
            "flash_attention": done2, HEAD: doneh,
            "conv_gn_silu_backward": {tuple(r[k] for k in key1): r
                                      for r in kb[0]},
            "flash_attention_backward": {tuple(r[k] for k in key2): r
                                         for r in kb[1]}}
    before = {k: len(set(seen[k]) & set(done[k])) for k in done}
    for key in sorted(set(seen["conv_gn_silu_backward"])
                      - set(done["conv_gn_silu_backward"])):
        dname, rows, L, Cin, Cout, G = key
        done["conv_gn_silu_backward"][key], = backward_conv_rows(
            torch, "launched", [(f"L{L} {Cin}->{Cout}", L, Cin, Cout, G)],
            getattr(torch, dname), rows, reps=0)
    for key in sorted(set(seen["flash_attention_backward"])
                      - set(done["flash_attention_backward"])):
        done["flash_attention_backward"][key], = backward_attention_rows(
            torch, "launched", [key], reps=0)
    todo = {}
    for key in sorted(set(seen["conv_gn_silu"]) - set(done1)):
        dname, rows, L, Cin, Cout, G, epilogue = key
        todo.setdefault((dname, rows, G, epilogue), []).append(
            (f"L{L} {Cin}->{Cout}", L, Cin, Cout))
    for (dname, rows, G, epilogue), blocks in todo.items():
        for r in phase_kernel(torch, "launched", blocks,
                              ((getattr(torch, dname), rows),), groups=G,
                              epilogues=(epilogue,)):
            done1[(r["dtype"], r["rows"], r["L"], r["Cin"], r["Cout"],
                   r["groups"], r["epilogue"])] = r
    for r in phase_kernel_attention(torch, sorted(
            set(seen["flash_attention"]) - set(done2))):
        done2[(r["dtype"], r["B"], r["H"], r["L"], r["D"])] = r
    for key in sorted(set(seen["conv_gn_silu_decoder"]) - set(doned)):
        _, rows, L, Ch, Cs, Cout, G, epilogue = key
        r, = phase_kernel_decoder(torch, "launched",
                                  [(f"L{L} {Ch}+{Cs}->{Cout}", L, Ch, Cs,
                                    Cout)], rows, (epilogue,), reps=0)
        doned[tuple(r[k] for k in keyd)] = r
    for key in sorted(set(seen[HEAD]) - set(doneh)):
        doneh[key] = phase_kernel_head(torch, "launched", key, reps=0)
    by_run = {"conv_gn_silu": {}, "conv_gn_silu_decoder": {},
              "flash_attention": {}, HEAD: {}}
    for key, labels in seen["conv_gn_silu"].items():
        for label in labels - {"other"}:
            group = by_run["conv_gn_silu"].setdefault(label, {})
            group.setdefault(f"{key[0]} {key[1]} rows"
                             + ("" if key[6] == "none" else f" {key[6]}"),
                             []).append(done1[key])
    for label, groups in by_run["conv_gn_silu"].items():
        for name, recs in groups.items():
            groups[name] = k1_sum(recs)
    for key, labels in seen["conv_gn_silu_decoder"].items():
        r = doned[key]
        for label in labels - {"other"}:
            by_run["conv_gn_silu_decoder"].setdefault(label, {})[
                " ".join(map(str, key))] = {
                    k: r.get(k, "not measured") for k in (
                        "kernel_ms", "materialised_ms", "plain_ms",
                        "bound_ms", "max_abs_err",
                        "max_abs_err_vs_materialised")}
    for key, labels in seen[HEAD].items():
        r = doneh[key]
        for label in labels - {"other"}:
            by_run[HEAD].setdefault(label, {})[" ".join(map(str, key))] = {
                k: r.get(k, "not measured") for k in (
                    "kernel_dev_ms", "kernel_ms", "plain_ms",
                    "composition_ms", "bound_ms", "max_abs_err",
                    "max_abs_err_vs_composition", "route")}
    for key, labels in seen["flash_attention"].items():
        r = done2[key]
        for label in labels - {"other"}:
            by_run["flash_attention"].setdefault(label, {})[
                f"{key[0]} {key[1:]}"] = {k: r[k] for k in (
                    "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                    "max_abs_err", "route")}
    coverage = {k: {"shapes_launched": len(seen[k]),
                    "checked_in_kernel_phase": before[k],
                    "checked_here": len(seen[k]) - before[k]}
                for k in seen}
    check(all(key in done[k] for k in done for key in seen[k]),
          "every launched shape is checked against its plain version")
    emit({"phase": "launched_shapes", "coverage": coverage,
          "by_run": by_run})
    return by_run, coverage


def kb_sum(recs):
    """K1B records summed over their blocks (one backward when the records
    are a training path's ConvBlocks)."""
    out = {key: sum(r[key] for r in recs) for key in (
        "kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    out["ops_bound_ms"] = sum(r["bound_ms"] for r in recs
                              if r["bound_by"] == "operations")
    out.update(rows=recs[0]["rows"], L=max(r["L"] for r in recs),
               blocks=len(recs), dtype=recs[0]["dtype"],
               max_abs_err=max(r["max_abs_err"] for r in recs),
               grad_err=max(max(r["grad_err"]) for r in recs))
    return out


def backward_entries(kb, launches, coverage, pkg):
    """The ``kernels`` records of K1B and K2B: K1B summed over attn16k's 7
    ConvBlocks at the training batch, K2B at attn16k's training shape (16,
    4, 4096, 64), both bf16; every other checked path beside them;
    launches summed over the main-path runs."""
    kb1, kb2 = kb
    paths = {}
    for r in kb1:
        if "kernel_ms" in r:
            paths.setdefault(r["config"], []).append(r)
    k1b = {c: kb_sum(recs) for c, recs in paths.items()}
    main1 = k1b["attn16k train"]
    k2b = {f"{r['config']} {r['dtype']} {(r['B'], r['H'], r['L'], r['D'])}":
           {key: r[key] for key in ("kernel_ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by", "max_abs_err",
                                    "grad_err", "grad_scale", "route",
                                    "tflops", "split_ms")}
           for r in kb2 if "kernel_ms" in r}
    main2 = next(r for r in kb2 if r["config"] == "attn16k train")
    ref = f"{pkg}/ops/pallas/"
    return [
        {"name": "conv_gn_silu_backward", "route": "cuda",
         "source": f"{pkg}_torch/csrc/conv_gn_silu_backward.cu",
         "replaces": f"{ref}fused.py:26",
         "replaces_note": "no Pallas kernel: the gradient of "
                          "fused_conv_gn_silu_reference (fused.py:26-40), "
                          "which the JAX trainer takes by XLA autodiff",
         "launches": sum(n.get("conv_gn_silu_backward", 0)
                         for n in launches.values()),
         "launches_by_path": {c: n.get("conv_gn_silu_backward", 0)
                              for c, n in launches.items()},
         "max_abs_err": main1["max_abs_err"], "grad_err": main1["grad_err"],
         "ms": main1["kernel_ms"], "plain_ms": main1["plain_ms"],
         "bound_ms": main1["bound_ms"],
         "bound_by": ("operations" if main1["ops_bound_ms"]
                      > main1["bound_ms"] / 2 else "bytes"),
         "library_ms": main1["library_ms"], "by_path": k1b,
         "launched_shapes": coverage["conv_gn_silu_backward"],
         "shapes": "the 7 ConvBlocks of attn16k's training step, 16 rows, "
                   "L 32768, bf16",
         "phase": "kernel_backward"},
        {"name": "flash_attention_backward", "route": "cuda",
         "source": f"{pkg}_torch/csrc/flash_attention_backward.cu",
         "replaces": f"{ref}attention.py:27",
         "replaces_note": "no Pallas kernel: the gradient of "
                          "flash_attention_reference (attention.py:27-33), "
                          "which the JAX trainer takes by XLA autodiff",
         "launches": sum(n.get("flash_attention_backward", 0)
                         for n in launches.values()),
         "launches_by_path": {c: n.get("flash_attention_backward", 0)
                              for c, n in launches.items()},
         "max_abs_err": main2["max_abs_err"], "grad_err": main2["grad_err"],
         "ms": main2["kernel_ms"], "plain_ms": main2["plain_ms"],
         "bound_ms": main2["bound_ms"], "bound_by": main2["bound_by"],
         "library_ms": main2["library_ms"], "cuda_route": main2["route"],
         "tflops": main2["tflops"], "by_shape": k2b,
         "launched_shapes": coverage["flash_attention_backward"],
         "shapes": "attn16k's training attention (16, 4, 4096, 64), bf16",
         "phase": "kernel_backward"}]


def head_entry(kh, launches, by_run, coverage, pkg):
    """The head kernel's ``kernels`` record: summed over one forward of
    each main path at its serving batch, bf16 (``ms``: device time from the
    profiler; ``event_ms``: between CUDA events, the wrapper's host time
    included); also at the benchmark's cells' rows, the infer batch, f32,
    and every shape the runs launched, by run; launches summed over the
    main-path runs."""
    def rec(config, rows, dtype="bfloat16"):
        return next(r for r in kh if r["config"] == config
                    and r["rows"] == rows and r["dtype"] == dtype)

    keys = ("kernel_dev_ms", "kernel_ms", "plain_ms", "composition_ms",
            "bound_ms", "dev_share_of_bound", "max_abs_err",
            "max_abs_err_vs_composition", "route", "rows", "Lh", "C", "Cin")
    by = {f"{r['config']} {r['dtype']} {r['rows']} rows": {
        k: r.get(k, "not measured") for k in keys}
        for r in kh if r["config"] != "launched"}
    main = [rec(config, path["rows"]) for config, path in PATHS.items()]
    dev = [r["kernel_dev_ms"] for r in main]
    return {"name": HEAD, "route": "cuda",
            "source": f"{pkg}_torch/csrc/unet_head.cu",
            "replaces": f"{pkg}/models/unet.py:396",
            "replaces_note": "no Pallas kernel: the JAX model's final conv "
                             "on [h | x_t] (models/unet.py:396-401), left "
                             "to XLA",
            "launches": sum(n.get(HEAD, 0) for n in launches.values()),
            "launches_by_path": {c: n.get(HEAD, 0)
                                 for c, n in launches.items()},
            "max_abs_err": max(r["max_abs_err"] for r in kh),
            "ms": (sum(dev) if all(dev) else "not measured"),
            "event_ms": sum(r["kernel_ms"] for r in main),
            "plain_ms": sum(r["plain_ms"] for r in main),
            "library_ms": sum(r["composition_ms"] for r in main),
            "bound_ms": sum(r["bound_ms"] for r in main),
            "bound_by": "bytes",
            "by_shape": by, "by_eval_run": by_run[HEAD],
            "launched_shapes": coverage[HEAD],
            "shapes": "the head of one forward of each main path, bf16: "
                      "pn128 64 rows (L 4096, C 128), attn16k 32 rows "
                      "(L 32768, C 64)",
            "phase": "kernel_head"}


def kernels_line(k1, k2, kb, kd, kh, launches, by_run, coverage):
    """The ``kernels`` record: K1 summed over the 7 ConvBlocks of one forward
    of each main path at its serving batch as the path launches them (the
    encoder's and mid's from ``k1``, the decoder's on the decoder route
    from ``kd``; their sum also apart), K2 at attn16k's serving shape
    (both also at the infer batch of 8 rows and the training batch of 16,
    K2 at the grid's batch, K1 at the bench's shapes and at the streaming
    train's 16 rows at each bucket length; both at every shape the evals,
    distill and tools runs launched, by run; K1 at bench_population's 512
    rows and K2 at bench_kernels' U-Net bottleneck named apart); launches
    summed over the main-path runs (serving, infer, infer CLI, the
    artifact's replay, attn16k training, pn128 gw-train, the sweeps, the
    grids, gw-distill and the grid of its student, the bench and
    ``entry()``, the parallel runs, the streaming gw-train and its
    gw-infer, bench_population, the bench_kernels sections, the glitch and
    spin harnesses)."""
    def main_path(config, rows):
        """K1's records of one forward of ``config`` at ``rows``, with the
        epilogue the path carries: its decoder blocks on the route."""
        epilogue = path_epilogue(config)
        return [r for r in k1 if r["config"] == config
                and r["dtype"] == "bfloat16" and r["rows"] == rows
                and r["epilogue"] == epilogue
                and not r["block"].startswith("dec")] + [
            r for r in kd if r["config"] == config and r["rows"] == rows
            and r["epilogue"] == epilogue]

    def k1_path_sum(config, rows):
        recs = main_path(config, rows)
        check(len(recs) == 2 * PATHS[config]["model"]["depth"] + 1,
              f"K1's records of a {config} forward at {rows} rows: "
              f"{[r['block'] for r in recs]}")
        out = k1_sum(recs)
        out["decoder_route"] = k1_sum([r for r in recs
                                       if r["kernel"] == DECODER])
        return out

    k1_paths = {}
    for config, path in PATHS.items():
        recs = main_path(config, path["rows"])
        k1_paths[config] = k1_path_sum(config, path["rows"])
        k1_paths[config]["two_pass_floor_ms"] = sum(
            r["two_pass_floor_ms"] for r in recs)
        k1_paths[config]["ops_bound_ms"] = sum(
            r["bound_ms"] for r in recs if r["bound_by"] == "operations")
    k1_total = {key: sum(p[key] for p in k1_paths.values())
                for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                            "ops_bound_ms", "two_pass_floor_ms")}
    k1_infer = {config: k1_path_sum(config, INFER_ROWS) for config in PATHS}
    k1_extra = {config: k1_sum([r for r in k1 if r["config"] == config])
                for config in [c for c, *_ in K1_EXTRA] + ["bench"]}
    main, infer, train, grid_b = (
        next(r for r in k2 if r["dtype"] == "bfloat16"
             and (r["B"], r["H"], r["L"], r["D"]) == (B, 4, 4096, 64))
        for B in (32, INFER_ROWS, TRAIN_BATCH, ATTN16K_GRID_ROWS))
    pkg = "diffusion_models_for_gravitational_waveform_reconstruction_tpu"
    return {"kernels": [
        {"name": "conv_gn_silu", "route": "cuda",
         "source": f"{pkg}_torch/csrc/conv_gn_silu.cu",
         "replaces": f"{pkg}/ops/pallas/fused.py:87",
         "launches": sum(n.get("conv_gn_silu", 0) for n in launches.values()),
         "launches_by_path": {c: n.get("conv_gn_silu", 0)
                              for c, n in launches.items()},
         "max_abs_err": max(p["max_abs_err"] for p in k1_paths.values()),
         "ms": k1_total["kernel_ms"], "plain_ms": k1_total["plain_ms"],
         "bound_ms": k1_total["bound_ms"],
         "bound_by": ("operations" if k1_total["ops_bound_ms"]
                      > k1_total["bound_ms"] / 2 else "bytes"),
         "library_ms": k1_total["library_ms"],
         "two_pass_floor_ms": k1_total["two_pass_floor_ms"],
         "by_path": k1_paths, "by_infer_path": k1_infer,
         "by_train_path_and_bench": k1_extra,
         "by_stream_bucket": {r["config"].split(" L")[-1]: k1_sum(
             [q for q in k1 if q["config"] == r["config"]])
             for r in k1 if r["config"].startswith(STREAM_CONFIG)},
         "by_eval_run": by_run["conv_gn_silu"],
         "bench_population": by_run["conv_gn_silu"].get("bench_population"),
         "launched_shapes": coverage["conv_gn_silu"],
         "shapes": "the 7 ConvBlocks of one forward of each main path, bf16, "
                   "with the conditioning epilogue they launch, the encoder's "
                   "3 and mid materialised, the decoder's 3 on the decoder "
                   "route: pn128 at 64 rows, attn16k at 32 rows",
         "phase": "kernel"},
        {"name": "flash_attention", "route": "cuda",
         "source": f"{pkg}_torch/csrc/flash_attention.cu",
         "replaces": f"{pkg}/ops/pallas/attention.py:70",
         "launches": sum(n.get("flash_attention", 0)
                         for n in launches.values()),
         "launches_by_path": {c: n.get("flash_attention", 0)
                              for c, n in launches.items()},
         "max_abs_err": main["max_abs_err"], "ms": main["kernel_ms"],
         "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
         "bound_by": main["bound_by"], "library_ms": main["library_ms"],
         "cuda_route": main["route"], "tflops": main["tflops"],
         "infer_shape": {key: infer[key] for key in (
             "B", "kernel_ms", "library_ms", "bound_ms", "max_abs_err")},
         "train_shape": {key: train[key] for key in (
             "B", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
             "max_abs_err")},
         "grid_shape": {key: grid_b[key] for key in (
             "B", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
             "max_abs_err")},
         "by_eval_run": by_run["flash_attention"],
         "bench_kernels_unet": by_run["flash_attention"].get(
             "bench_kernels unet"),
         "launched_shapes": coverage["flash_attention"],
         "shapes": "attn16k's bottleneck (32, 4, 4096, 64), bf16",
         "phase": "kernel"},
        head_entry(kh, launches, by_run, coverage, pkg)]
        + backward_entries(kb, launches, coverage, pkg)}


SASS_OPS = ("HGMMA", "UTMALDG")


def sass_counts(path):
    """Counts of wgmma (``HGMMA``) and TMA load (``UTMALDG``) instructions
    in a built library's SASS, each "not measured" where the toolkit has no
    ``cuobjdump``."""
    tool = (Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
            / "cuobjdump")
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        return dict.fromkeys(SASS_OPS, "not measured")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout.splitlines()
    return {op: sum(op in ln for ln in sass) for op in SASS_OPS}


class Laps:
    """Seconds of the run's stretches: each call books the time since the
    previous one under its name."""

    def __init__(self):
        self.t, self.s = time.perf_counter(), {}

    def __call__(self, name):
        now = time.perf_counter()
        self.s[name] = self.s.get(name, 0.0) + now - self.t
        self.t = now


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
    sass = {n: sass_counts(_build.library_path(n)) for n in names}
    emit({"phase": "build", "seconds": build_s,
          "built": sorted(logs),
          "sass_hgmma": {n: c["HGMMA"] for n, c in sass.items()},
          "sass_utmaldg": {n: c["UTMALDG"] for n, c in sass.items()},
          "ptxas": {name: [ln.strip() for ln in log.splitlines()
                           if "entry function" in ln or "Used" in ln
                           or "spill" in ln or "warning" in ln]
                    for name, log in logs.items()}})
    # every kernel has a wgmma route fed by TMA (K1B's recompute and dx
    # are K1's conv pass, its dW its own; K2B's three kernels)
    for name in ("conv_gn_silu", "flash_attention", "conv_gn_silu_backward",
                 "flash_attention_backward"):
        for op in SASS_OPS:
            n = sass[name][op]
            check(n == "not measured" or n > 0,
                  f"{name}'s library holds no {op} instruction")

    lap = Laps()
    k1 = []
    for config, dtypes_rows in (
            ("pn128", ((torch.bfloat16, 64), (torch.bfloat16, 128),
                       (torch.bfloat16, INFER_ROWS), (torch.float32, 128))),
            ("attn16k", ((torch.bfloat16, 32), (torch.bfloat16, INFER_ROWS)))):
        path = PATHS[config]
        shapes = convblock_shapes(UNet1D(**path["model"], device="cuda"),
                                  path["L"])
        k1 += phase_kernel(torch, config, shapes, dtypes_rows,
                           epilogues=("none", path_epilogue(config)))
    from diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch import bench

    for config, model_kw, L, rows in K1_EXTRA + [
            ("bench", bench.MODEL, bench.L, bench.B)]:
        shapes = convblock_shapes(UNet1D(**model_kw, device="cuda"), L)
        k1 += phase_kernel(torch, config, shapes, ((torch.bfloat16, rows),))
    # the decoder route at the flagships' serving batch, their cells' rows
    # (pn128 128, attn16k 64) and the infer batch, with the epilogue the
    # main paths carry
    kd = []
    for config, rows_list in (("pn128", (64, 128, INFER_ROWS)),
                              ("attn16k", (32, 64, INFER_ROWS))):
        path = PATHS[config]
        shapes = decoder_shapes(UNet1D(**path["model"], device="cuda"),
                                path["L"])
        for rows in rows_list:
            kd += phase_kernel_decoder(torch, config, shapes, rows,
                                       ("none", path_epilogue(config)))
    kh = phase_kernel_heads(torch)
    k2 = phase_kernel_attention(torch)
    lap("kernel")
    kb = phase_kernel_backward(torch)
    lap("kernel_backward")
    shapes = LaunchShapes()
    with shapes:
        phase_model(torch, "pn128", 4, 4096)
        phase_model(torch, "attn16k", 2, 32768)
        phase_serving_small(torch)
        launches = {config: phase_serving(torch, config) for config in PATHS}
    lap("model, serving")
    with tempfile.TemporaryDirectory() as tmp:
        with shapes:
            phase_infer_small(torch, tmp)
            for config in PATHS:
                (launches[f"{config} infer"],
                 launches[f"{config} infer cli"]) = phase_infer(torch, config,
                                                                tmp)
        lap("infer")
        phase_op_overhead(torch)        # times the bare launch bodies
        lap("op_overhead")
        with shapes:
            for config in PATHS:
                launches[f"{config} export replay"] = phase_export(
                    torch, config, tmp)
            LaunchShapes.label = "other"
            launches["pn128 pod replay rank 0"] = phase_pod(torch, tmp,
                                                            shapes)
    lap("export, pod_serving")
    # the evals phase's directory lives on until the tools phase
    with shapes, tempfile.TemporaryDirectory() as tmp_evals:
        phase_autograd(torch)
        launches["attn16k train"], ds = phase_train(torch, tmp_evals)
        phase_train_grads(torch, ds, tmp_evals)
        del ds
        launches["pn128 train cli"], trained = phase_train_cli(torch,
                                                               tmp_evals)
        lap("autograd, train")
        phase_evals_small(torch, tmp_evals)
        evals_launches, corpus, ckpt = phase_evals(torch, tmp_evals)
        launches.update(evals_launches)
        lap("evals")
        phase_distill_grads(torch, corpus)
        launches.update(phase_distill(torch, tmp_evals, trained, corpus))
        launches["bench"], launches["entry"] = phase_bench(torch)
        lap("distill, bench")
        with tempfile.TemporaryDirectory() as tmp:
            launches["attn16k train nccl"] = phase_parallel_nccl(torch, tmp)
            (prep, launches["attn16k tiled infer"],
             launches["attn16k tiled infer cli"]) = phase_parallel_tiles(
                torch, tmp, shapes)
            launches["attn16k train tp rank 0"] = phase_parallel_ranks(
                torch, tmp, prep, shapes)
        lap("parallel")
        with tempfile.TemporaryDirectory() as tmp:
            data_launches, data_buckets, data_paths = phase_data(torch, tmp)
            launches.update(data_launches)
            lap("data")
            launches.update(phase_tools(torch, tmp, corpus, ckpt,
                                        data_paths))
            lap("tools")
    # K1 and K1B at the streaming train's shapes: 16 rows at each bucket
    # (K1B at the lengths the kernel_backward phase did not check)
    for L in data_buckets:
        shapes_L = convblock_shapes(UNet1D(**FLAGSHIP, device="cuda"), L)
        k1 += phase_kernel(torch, f"{STREAM_CONFIG} L{L}", shapes_L,
                           ((torch.bfloat16, TRAIN_BATCH),))
        if L not in (4096, CLI_TRAIN_L):
            kb[0].extend(backward_conv_rows(
                torch, f"{STREAM_CONFIG} L{L}", train_blocks(FLAGSHIP, L),
                torch.bfloat16, TRAIN_BATCH, reps=2))
    lap("stream buckets")
    by_run, coverage = phase_launched_shapes(torch, shapes, k1, k2, kb, kd,
                                             kh)
    lap("launched_shapes")
    emit({"phase": "seconds", "by_stretch": lap.s,
          "total": sum(lap.s.values())})
    emit(kernels_line(k1, k2, kb, kd, kh, launches, by_run, coverage))
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
