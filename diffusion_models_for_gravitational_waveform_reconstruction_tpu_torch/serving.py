"""Deployment sampler and its serving artifact (counterpart of the JAX
package's ``serving.py``).

    x0_white (B, L) = fn(model, cond_stack (B, C, L) f32, sigmas (B,) f32, seed)

``cond_stack`` is the whitened, sigma-normalised measurement stack as the
host prepares it.  The function runs the whole recipe on the device: the
timestep ladder, CFG, self-conditioning, seed-averaged sampling, the sigma
rescale and the matched-filter amplitude calibration in float32.
:func:`run_batched` serves any number of measurements through such a
function at its fixed batch size.

:func:`export_sampler` ships the function with a checkpoint's weights inside
as a ``torch.export`` program (``.pt2``) beside a JSON sidecar that keeps the
JAX artifact's contract.  The program holds the port's registered ops (the
kernels and the seeded noise), so loading it needs this package imported,
and it is traced for one device type: a CUDA artifact launches the kernels,
a CPU artifact runs their plain versions.  :func:`load_exported` replays it.

``export_sampler(dp=N)`` is the pod-serving artifact.  ``torch.export`` has
no SPMD partitioner, so where JAX exports one program sharded over a
``data`` mesh the port exports one program of a rank's share, batch / N
rows, that takes the rank's data index as a fourth input and draws every
noise for the global batch, keeping its own rows (``RankNoise``).
:func:`load_exported` runs it in each process of an N-rank group
(``torchrun --nproc-per-node N``, one card each): every rank passes its
rows and its index and gathers the others' rows, so the call serves the
global batch as JAX's does.
"""
from __future__ import annotations

import json
import os
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .inference import apply_distilled_defaults, load_model, resolve_start_t
from .parallel import mesh as pmesh
from .ops.kernels.conv_gn_silu import conv_gn_silu_op
from .ops.kernels.flash_attention import flash_attention_op
from .ops.kernels.unet_head import unet_head_op
from .ops.sampling import (SAMPLERS, RankNoise, SamplerConfig, SeededNoise,
                           aggregate_seeds, seeded_normal,
                           sample_with_refinement)
from .utils.device import resolve_device
from .utils.spans import span

# the calling-convention generation of the sidecar (the JAX package's)
CONTRACT_VERSION = 1
# a pod-serving artifact's: its program takes a rank's rows and the rank
CONTRACT_VERSION_DP = 2
ARTIFACT_FORMAT = "torch.export"


def resolve_serving_config(ck: dict, schedule, *, sampler: str = "ddim",
                           steps: Optional[int] = None,
                           ladder: Optional[str] = None,
                           cfg_scale: Optional[float] = None,
                           start_t: Optional[int] = None,
                           eta: float = 0.0) -> Tuple[SamplerConfig, str]:
    """The deployment ``SamplerConfig`` from a checkpoint's args: explicit
    values win, then a distilled checkpoint's recorded knobs, then the
    defaults.  ``start_t`` falls back to the top of the chain (T-1): a
    serving sampler always starts from pure noise."""
    a = SimpleNamespace(steps=steps, cfg_scale=cfg_scale, ladder=ladder,
                        start_t=start_t)
    apply_distilled_defaults(a, ck)
    if a.start_t is None:
        a.start_t = int(schedule.T) - 1
    cond_in_ch = int(ck.get("cond_in_ch", 1))
    cfg = SamplerConfig(
        steps=int(a.steps),
        eta=float(eta),
        start_t=resolve_start_t(schedule, a.start_t, None),
        init_mode="noise",
        pred_type=str(ck.get("pred_type", "eps")),
        use_selfcond=int(ck.get("in_ch", 3)) == (1 + cond_in_ch + 1),
        cfg_scale=float(a.cfg_scale),
        drop_y_only=bool(ck.get("dropout_y_only", True)),
        selfcond_mode=str(ck.get("selfcond_mode", "update")),
        ladder=a.ladder or ("lambda" if sampler == "dpmpp" else "t"),
    )
    return cfg, sampler


def build_serving_fn(schedule, cfg: SamplerConfig, *, sampler: str = "ddim",
                     avg_seeds: int = 1, avg_mode: str = "mean",
                     amp_calib: str = "none", device=None, dp: int = 1):
    """``fn(model, cond_stack, sigmas, seed, noise=None, rank=None) ->
    x0_white (B, L)`` on ``device`` (default: the GPU).

    The batch is tiled seed-major (row s*B + b is seed s of measurement b),
    sampled in one batch of S*B rows with the draws of
    :class:`ops.sampling.SeededNoise` from ``seed`` (or from ``noise`` when
    given), aggregated over seeds, rescaled by sigma and, with
    ``amp_calib="mf"``, by the least-squares matched-filter amplitude
    clipped to [0.25, 4].  ``seed`` is an int or a 0-d int32 CPU tensor.

    With ``dp`` > 1 the B rows are data rank ``rank``'s (an int or a 0-d
    integer tensor) of a global batch of dp*B: each draw is made for the
    global batch and the rank keeps its rows of every seed's block, so the
    ranks' outputs, concatenated in rank order, are the global call's.
    """
    dev = resolve_device(device)
    sample_fn = SAMPLERS[sampler]
    S = max(1, int(avg_seeds))
    # the samplers read the schedule on the host only; as numpy arrays its
    # constants stay out of a torch.export trace
    schedule = type(schedule)(*(np.asarray(a) for a in schedule))

    @torch.no_grad()
    def fn(model, cond_stack, sigmas, seed, noise=None, rank=None):
        B = len(cond_stack)
        with span("serve/call", f"rows={B} seeds={S} steps={cfg.steps}"):
            with span("serve/inputs"):
                cond = torch.as_tensor(cond_stack, dtype=torch.float32,
                                       device=dev)
                if noise is None:
                    noise = SeededNoise(seed)
                if dp > 1:
                    noise = RankNoise(noise, rank, dp, blocks=S)
                cond_t = cond.repeat(S, 1, 1) if S > 1 else cond
            x0 = sample_with_refinement(sample_fn, model, schedule, cond_t,
                                        cfg, noise)
            if S > 1:
                with span("serve/aggregate"):
                    per_seed = x0.reshape(S, B, *x0.shape[1:])
                    x0 = aggregate_seeds(per_seed, avg_mode,
                                         y_norm=cond[:, 0, :])
            with span("serve/calibrate"):
                sig = torch.as_tensor(sigmas, dtype=torch.float32,
                                      device=dev).reshape(-1)
                x0w = x0[:, 0, :] * sig[:, None]
                if amp_calib == "mf":
                    yw = cond[:, 0, :] * sig[:, None]
                    den = torch.sum(x0w * x0w, dim=-1)
                    s = torch.sum(yw * x0w, dim=-1) / torch.clamp(den,
                                                                  min=1e-30)
                    s = torch.where((den > 0.0) & torch.isfinite(s), s,
                                    torch.ones_like(s))
                    x0w = x0w * s.clamp(0.25, 4.0)[:, None]
            return x0w

    return fn


def calling_convention(batch: int, cond_in_ch: int, length: int) -> dict:
    """The ``calling_convention`` of a serving function of fixed batch size,
    in the layout of the JAX artifact's sidecar."""
    return {
        "inputs": {
            "cond_stack": [batch, cond_in_ch, length, "float32"],
            "sigmas": [batch, "float32"],
            "seed": ["scalar", "int32"],
        },
        "output": {"x0_white": [batch, length, "float32"]},
    }


def run_batched(call, contract: dict, cond_stack, sigmas, seed: int = 0):
    """Serve ``n`` measurements through ``call(cond (B, C, L), sigmas (B,),
    seed)`` of fixed batch size B: ceil(n / B) calls, the tail chunk padded
    with zero conditioning and sigma 1 (dropped from the output), the seed
    advanced by one per chunk.  Returns ``x0_white (n, L) float32``."""
    cc = contract["calling_convention"]["inputs"]
    B, C, L = (int(v) for v in cc["cond_stack"][:3])
    cond = np.asarray(cond_stack, np.float32)
    sig = np.asarray(sigmas, np.float32).reshape(-1)
    if cond.ndim != 3 or cond.shape[1:] != (C, L):
        raise ValueError(
            f"cond_stack shape {cond.shape} incompatible with the contract "
            f"(n, {C}, {L})")
    if sig.shape[0] != cond.shape[0]:
        raise ValueError(
            f"sigmas length {sig.shape[0]} != cond_stack rows {cond.shape[0]}")
    n = cond.shape[0]
    out = np.empty((n, L), np.float32)
    for ci, lo in enumerate(range(0, n, B)):
        hi = min(lo + B, n)
        cchunk, schunk = cond[lo:hi], sig[lo:hi]
        if hi - lo < B:
            pad = B - (hi - lo)
            cchunk = np.concatenate(
                [cchunk, np.zeros((pad, C, L), np.float32)], axis=0)
            schunk = np.concatenate(
                [schunk, np.ones((pad,), np.float32)], axis=0)
        res = call(cchunk, schunk, int(seed) + ci)
        if isinstance(res, torch.Tensor):
            res = res.cpu().numpy()
        out[lo:hi] = np.asarray(res)[:hi - lo]
    return out


class _ServedSampler(nn.Module):
    """The serving function with the model's weights inside, as one module
    for ``torch.export``: ``forward(cond_stack, sigmas, seed)``."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, cond_stack, sigmas, seed):
        return self.fn(self.model, cond_stack, sigmas, seed)


class _ServedShard(_ServedSampler):
    """A pod-serving artifact's program: a rank's rows of the batch and
    the rank, ``forward(cond_stack, sigmas, seed, rank)``."""

    def forward(self, cond_stack, sigmas, seed, rank):
        return self.fn(self.model, cond_stack, sigmas, seed, rank=rank)


def _op_counts(ep) -> dict:
    """How many nodes of each of the port's registered ops the exported
    program's graphs hold (no-grad regions are graphs of their own)."""
    ops = {"conv_gn_silu": conv_gn_silu_op,
           "flash_attention": flash_attention_op,
           "unet_head": unet_head_op,
           "seeded_normal": seeded_normal}
    targets = {op._opoverload: name for name, op in ops.items()}
    counts = dict.fromkeys(ops, 0)
    for gm in ep.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                if node.op == "call_function" and node.target in targets:
                    counts[targets[node.target]] += 1
    return counts


def export_sampler(ckpt_path: str, out_path: str, *, batch: int, length: int,
                   device=None, sampler: str = "ddim",
                   steps: Optional[int] = None, ladder: Optional[str] = None,
                   cfg_scale: Optional[float] = None,
                   start_t: Optional[int] = None, eta: float = 0.0,
                   avg_seeds: int = 8, avg_mode: str = "mean",
                   amp_calib: str = "mf", use_ema: bool = True,
                   dp: int = 1) -> dict:
    """Export a checkpoint's deployment sampler to ``out_path`` (a
    ``torch.export`` program, ``.pt2``) plus a ``<out_path>.json`` sidecar;
    returns the sidecar.

    The model is loaded on ``device`` (default: the GPU) and traced there at
    the static shapes ``cond_stack (batch, cond_in_ch, length) f32``,
    ``sigmas (batch,) f32``, ``seed () int32`` (on the CPU), with its
    weights inside the program.  Trace where you serve: a CUDA export holds
    the kernels' ops (checked here: K1, the head, and K2 for an attention
    checkpoint), a CPU export their plain versions.  Knobs resolve as in
    :func:`resolve_serving_config`.

    ``dp > 1`` exports the pod-serving artifact: one program of batch / dp
    rows that takes the rank's data index (``seed () int32, rank () int64``
    on the CPU) and keeps its rows of the global batch's draws; the sidecar
    keeps the global calling convention, ``"dp": dp``, and adds
    ``rows_per_rank`` and its own contract version
    (``CONTRACT_VERSION_DP``).  :func:`load_exported` serves it over a
    dp-rank process group."""
    dp = max(1, int(dp))
    if batch % dp != 0:
        raise ValueError(f"batch {batch} not divisible by dp {dp}")
    rows = batch // dp
    dev = resolve_device(device)
    model, schedule, ck = load_model(ckpt_path, use_ema=use_ema, device=dev)
    cfg, sampler = resolve_serving_config(
        ck, schedule, sampler=sampler, steps=steps, ladder=ladder,
        cfg_scale=cfg_scale, start_t=start_t, eta=eta)
    fn = build_serving_fn(schedule, cfg, sampler=sampler, avg_seeds=avg_seeds,
                          avg_mode=avg_mode, amp_calib=amp_calib, device=dev,
                          dp=dp)
    cond_in_ch = int(ck.get("cond_in_ch", 1))
    served = (_ServedSampler if dp == 1 else _ServedShard)(model, fn).eval()
    for p in served.parameters():
        p.requires_grad_(False)
    example = (torch.zeros((rows, cond_in_ch, length), dtype=torch.float32,
                           device=dev),
               torch.ones((rows,), dtype=torch.float32, device=dev),
               torch.zeros((), dtype=torch.int32))
    if dp > 1:
        example += (torch.zeros((), dtype=torch.int64),)
    ep = torch.export.export(served, example, strict=False)
    counts = _op_counts(ep)
    if dev.type == "cuda":
        want = ["conv_gn_silu", "unet_head"] + (
            ["flash_attention"] if model.use_attention else [])
        missing = [name for name in want if counts[name] == 0]
        if missing:
            raise RuntimeError(f"the CUDA export holds no {missing} op: "
                               f"{counts}")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.export.save(ep, out_path)

    contract = {
        "contract_version": CONTRACT_VERSION if dp == 1 else CONTRACT_VERSION_DP,
        "calling_convention": calling_convention(batch, cond_in_ch, length),
        "platforms": [dev.type],
        "dp": dp,
        "checkpoint": os.path.abspath(ckpt_path),
        "ema_weights": bool(use_ema),
        "knobs": {
            "sampler": sampler, "steps": cfg.steps, "ladder": cfg.ladder,
            "start_t": int(cfg.start_t) if cfg.start_t is not None else None,
            "cfg_scale": cfg.cfg_scale, "eta": cfg.eta,
            "pred_type": cfg.pred_type, "avg_seeds": avg_seeds,
            "avg_mode": avg_mode, "amp_calib": amp_calib,
            "selfcond_mode": cfg.selfcond_mode,
        },
        "arch": {k: ck.get(k) for k in ("base_ch", "depth", "time_dim",
                                        "in_ch", "cond_in_ch", "T",
                                        "schedule", "use_attention")},
        # the measurement-prep domain: the ingest host builds cond_stack in
        # the checkpoint's domain from this block alone
        "prep": {
            "whiten": bool(ck.get("whiten", False)),
            "whiten_mode": str(ck.get("whiten_mode_resolved", "")
                               or ck.get("whiten_mode", "auto")),
            "sigma_mode": str(ck.get("sigma_mode", "std")),
            "sigma_fixed": float(ck.get("sigma_fixed", 1.0)),
            "meta_scale": dict(ck.get("meta_scale") or {}),
            "fs": float(ck.get("fs", 4096.0)),
        },
        "artifact_bytes": os.path.getsize(out_path),
        "format": ARTIFACT_FORMAT,
        "torch": torch.__version__,
        # the registered ops the program calls, by name: the kernels' once
        # per launch (none in a CPU artifact), the noise once per draw
        "ops": counts,
        "loading": ("torch.export.load needs the ops of "
                    "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch "
                    "registered: load with its serving.load_exported"),
    }
    if dp > 1:
        contract["rows_per_rank"] = rows
    with open(out_path + ".json", "w") as fh:
        json.dump(contract, fh, indent=2)
    return contract


def _program(path: str, device=None):
    """``(replay, contract)``: the artifact's program loaded on ``device``
    (default: the GPU) after the sidecar's checks, as ``replay(cond_stack,
    sigmas, seed, *rank)`` on host or device inputs, and its sidecar."""
    sidecar = path + ".json"
    if not os.path.exists(sidecar):
        raise FileNotFoundError(f"missing sidecar {sidecar}")
    with open(sidecar) as fh:
        contract = json.load(fh)
    dp = int(contract.get("dp", 1))
    want = CONTRACT_VERSION if dp == 1 else CONTRACT_VERSION_DP
    got = int(contract.get("contract_version", -1))
    if got != want:
        raise ValueError(
            f"serving artifact {path} has contract_version {got}; this host "
            f"speaks {want}" + (f" for dp={dp}" if dp > 1 else "")
            + " — re-export the artifact or upgrade the host")
    if contract.get("format") != ARTIFACT_FORMAT:
        raise ValueError(
            f"serving artifact {path} is not a {ARTIFACT_FORMAT} program "
            f"(format {contract.get('format')!r}; a JAX StableHLO artifact "
            f"is served by the JAX package)")
    dev = resolve_device(device)
    platforms = list(contract.get("platforms", []))
    if dev.type not in platforms:
        raise RuntimeError(
            f"serving artifact {path} was traced for {platforms}, not "
            f"{dev.type}: re-export it on the device that serves it")
    module = torch.export.load(path).module()

    def replay(cond_stack, sigmas, seed, *rank):
        cond = torch.as_tensor(cond_stack, dtype=torch.float32).to(dev)
        sig = torch.as_tensor(sigmas, dtype=torch.float32).to(dev)
        return module(cond, sig, torch.tensor(int(seed), dtype=torch.int32),
                      *rank)

    return replay, contract


class PodFault(RuntimeError):
    """A rank's replay of a pod-serving artifact failed.  Every rank raises
    it from the same call, so the process group stays in step."""


def load_exported(path: str, device=None):
    """Load an :func:`export_sampler` artifact on ``device`` (default: the
    GPU); returns ``(call, contract)``.  ``call(cond_stack, sigmas, seed)``
    takes numpy arrays or tensors of the sidecar's shapes and an int seed
    and returns ``x0_white (B, L)``, a float32 tensor on the device.

    Refuses an artifact without its sidecar, of another contract version,
    of another format (a JAX StableHLO artifact) or traced for another
    device type.

    A pod-serving artifact (``dp`` > 1) needs a process group of dp
    processes, each of which loads it (without one it raises, naming
    ``torchrun``): every rank's ``call`` takes the global batch, runs the
    program on its rows and returns every rank's rows; if the program
    fails on any rank, every rank's ``call`` raises :class:`PodFault`."""
    replay, contract = _program(path, device)
    dp = int(contract.get("dp", 1))
    if dp == 1:
        return replay, contract
    if pmesh.world_size() != dp:
        raise RuntimeError(
            f"pod artifact {path} was exported for dp={dp} ranks; this "
            f"process group has {pmesh.world_size()}: serve it under "
            f"`torchrun --nproc-per-node {dp}` (one process per card)")
    mesh = pmesh.make_mesh(n_data=dp)
    rank = torch.tensor(mesh.rank, dtype=torch.int64)
    dev = resolve_device(device)

    def call(cond_stack, sigmas, seed):
        cond = torch.as_tensor(cond_stack, dtype=torch.float32)
        sig = torch.as_tensor(sigmas, dtype=torch.float32)
        try:
            out, fault = replay(pmesh.local_rows(mesh, cond),
                                pmesh.local_rows(mesh, sig), seed, rank), None
        except Exception as e:          # raised on every rank, below
            out, fault = None, e
        # the ranks agree before the gather, so a fault on one rank does
        # not leave the others waiting in it
        failed = torch.tensor([float(fault is not None)], device=dev)
        if float(pmesh.mean_(mesh, failed)) > 0:
            raise PodFault(f"a rank's replay of {path} failed") from fault
        return pmesh.gather_rows(mesh, out)

    return call, contract


def validate_export(path: str, seed: int = 0, device=None) -> float:
    """Replay the artifact on random inputs of its sidecar's shapes and
    return max|output|; raises on a shape violation or a non-finite
    output.  A cheap check after an export.  A pod-serving artifact is
    replayed here once per rank index, in this process, and the rows
    joined: no process group is needed."""
    replay, contract = _program(path, device)
    cc = contract["calling_convention"]
    B, C, L, _ = cc["inputs"]["cond_stack"]
    rng = np.random.default_rng(seed)
    cond = rng.normal(size=(B, C, L)).astype(np.float32)
    sig = np.ones((B,), np.float32)
    dp = int(contract.get("dp", 1))
    b = B // dp
    out = torch.cat([replay(cond[r * b:(r + 1) * b], sig[r * b:(r + 1) * b],
                            seed, *((torch.tensor(r),) if dp > 1 else ()))
                     for r in range(dp)]).cpu().numpy()
    expect = tuple(cc["output"]["x0_white"][:2])
    if out.shape != expect:
        raise ValueError(f"artifact output shape {out.shape} != {expect}")
    if not np.all(np.isfinite(out)):
        raise ValueError("artifact produced non-finite output")
    return float(np.max(np.abs(out)))
