"""Training engine on the GPU (counterpart of the JAX package's
``training/train.py``; the same recipe, configuration and checkpoints).

The recipe: sigma-normalisation in the whitening domain, [y || meta]
conditioning stacks, input clamping, uniform or stratified timesteps with
``t_min_frac`` and ``t_multi`` repeats, classifier-free-guidance dropout
(y-only by default), self-conditioning through a one-step x0 estimate
without gradient, a masked Huber / MSE loss on the eps or v target with
optional (1 - abar_t)^p weighting, AdamW with linear warm-up and cosine
decay, gradient clipping, EMA, bad-batch skipping, JSONL logging
(train_batch / probe / epoch_end), a first-batch debug dump and the
checkpoint contract.

How it runs on the card:

- The U-Net's ConvBlocks and its attention launch the port's Hopper kernels
  in the forward, with grad enabled too, and their backward kernels (K1B,
  K2B; ``ops/kernels``) in the backward, where the JAX trainer
  differentiates its plain expression.  ``cfg.remat`` recomputes the
  forward in the backward (``torch.utils.checkpoint``), which launches the
  forward kernels again.
- The parameters are views of one flat float32 buffer and their gradients
  views of another (:class:`FlatParams`); the optimizer (:class:`ClipAdamW`,
  the arithmetic of ``optax.chain(clip_by_global_norm, adamw(schedule))``),
  the EMA and the bad-batch gate are a few elementwise kernels over flat
  buffers.
- The gate is branchless: a refused batch (loss not finite or above the
  threshold, or a gradient norm not finite) leaves the parameters, the EMA,
  the optimizer state and the step as they were, chosen on the device with
  ``torch.where``; no step waits for the device.  Metrics stay on the device
  and are fetched once per epoch.
- The self-conditioning coin is drawn on the host (one per batch), so the
  extra forward runs only when it comes up.
- Data parallelism (``mesh=``, or a process group of several ranks, one
  per GPU as ``torchrun --nproc-per-node N`` starts them): every rank
  walks the same global batches and keeps its rows; the step draws t, eps
  and the dropout mask for the global batch and keeps its rows, averages
  the flat gradient and the loss over the ranks (one all-reduce each) and
  gates on those global values, so parameters, EMA and optimizer state
  stay the same on every rank.  Only rank 0 writes checkpoints, logs,
  probes, debug dumps and profiles; every rank reads ``--resume``.  Each
  rank keeps the whole corpus resident and gathers the global batch, then
  slices it.
- Tensor parallelism (``--tp`` > 1, a mesh with a model axis): the ranks
  of one model group hold the same rows and the same draws (drawn per
  data index); inside the step the U-Net runs the blocks that JAX shards
  on each rank's share of channels or heads
  (``UNet1D.tensor_parallel``).  After the backward each gradient that a
  rank computed only in part is summed over the model axis, then the
  whole gradient is averaged over the data axis as above.  Weights,
  optimizer state and checkpoints stay whole on every rank
  (``parallel.mesh.shard_params_tp``).

Random streams: a 64-bit key (``rng_key`` in checkpoints, uint32[2] as the
JAX package writes it) is split per step; the step seeds a generator on the
device with its key and draws the coin on the host from the same key.  A checkpoint of
either package resumes in the other, but the two packages' random streams
differ, so a resumed run does not repeat the other package's draws.

``--streaming`` reads the corpus a chunk at a time
(``data/pipeline.py::StreamingDataset``, HDF5 or either form of the
``.npz`` twin): with the dataset on the device (the default) its chunks
stay resident there, else each batch is copied through
``prefetch_to_device``.

One process that sees several GPUs with data or tensor parallelism on
raises, naming ``torchrun``: JAX's single controller takes every visible
device, torch runs one process per GPU.
"""
from __future__ import annotations

import dataclasses
import math
import os
import shutil
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..models.unet import UNet1D
from ..ops.diffusion import (
    eps_to_x0,
    masked_loss,
    q_sample,
    q_sample_with_eps,
    sample_timesteps_stratified,
    v_target,
    v_to_x0_eps,
)
from ..ops.schedules import DiffusionSchedule, make_schedule
from ..parallel import mesh as pmesh
from ..utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
    select_weights,
    state_dict_to_flax,
)
from ..utils.device import resolve_device
from ..utils.jsonl import JsonlLogger
from ..utils.weights import params_from_flax


@dataclasses.dataclass
class TrainConfig:
    """All training knobs, field for field those of the JAX package."""

    data: str = ""
    model_dir: str = "model"
    epochs: int = 50
    batch_size: int = 16
    lr: float = 2e-4
    weight_decay: float = 1e-4
    T: int = 1000
    base_ch: int = 64
    time_dim: int = 128
    depth: int = 3
    seed: int = 42
    schedule: str = "cosine"
    use_attention: bool = False

    # guidance & self-conditioning
    p_uncond: float = 0.2
    p_selfcond: float = 0.5
    t_min_frac: float = 0.5
    force_cond_epochs: int = 0
    dropout_y_only: bool = True

    # timestep coverage
    t_cover: str = "rand"               # 'rand' | 'strat'
    t_bins: int = 0
    t_multi: int = 1

    pred_type: str = "eps"              # 'eps' | 'v'

    # robustness
    loss: str = "huber"                 # 'huber' | 'mse'
    huber_beta: float = 0.5
    clip_grad: float = 1.0
    clamp_inputs: float = 10.0
    skip_bad_batches: bool = True
    skip_loss_threshold: float = 50.0
    loss_weight_power: float = 0.0

    # EMA + LR schedule
    ema: bool = True
    ema_decay: float = 0.999
    warmup_steps: int = 1000
    cosine_decay: bool = True
    min_lr_scale: float = 0.1

    # data domain
    whiten: bool = False
    whiten_mode: str = "auto"
    sigma_mode: str = "std"
    sigma_fixed: float = 1.0
    streaming: bool = False             # chunked lazy loading
    stream_chunk: int = 512
    max_len: int = 0                    # 0 = off; else LEFT-truncate samples
    device_data: bool = True            # dataset resident on the device

    # compute
    bf16: bool = True                   # bf16 activations, f32 parameters
    data_parallel: bool = True
    tp: int = 1                         # model-axis size (tensor parallelism)
    remat: bool = False                 # recompute the forward in backward

    # logging / probes
    log_jsonl: Optional[str] = None
    probe_cond: bool = False
    probe_t: Tuple[int, ...] = (24, 50, 200, 500, 800)
    probe_interval: int = 50
    debug_first: bool = False
    debug_first_every: int = 0

    # checkpointing
    init_from: Optional[str] = None
    save_every_epochs: int = 0          # 0 = final only
    resume: Optional[str] = None        # full-state resume

    # profiling: a torch.profiler trace of steps [start, stop)
    profile_dir: Optional[str] = None
    profile_steps: Tuple[int, int] = (10, 20)


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """splitmix64's finaliser."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def key_from_seed(seed: int) -> int:
    """The key of ``seed``: its low 64 bits (for seeds below 2^32 the two
    words of JAX's ``PRNGKey(seed)``)."""
    return int(seed) & _MASK64


def split_key(key: int) -> Tuple[int, int]:
    """Two new keys from one."""
    z = _mix64(key)
    return _mix64(z ^ 1), _mix64(z ^ 2)


def key_to_array(key: int) -> np.ndarray:
    """uint32[2], high word first (JAX's key layout)."""
    return np.array([key >> 32, key & 0xFFFFFFFF], np.uint32)


def key_from_array(a) -> int:
    a = np.asarray(a, np.uint32).reshape(-1)
    return (int(a[0]) << 32) | int(a[1])


def _uniform(key: int) -> float:
    """A float in [0, 1) from a key."""
    return (_mix64(key ^ 3) >> 11) * 2.0 ** -53


# ---------------------------------------------------------------------------
# Parameters, optimizer, state
# ---------------------------------------------------------------------------

class FlatParams:
    """A module's parameters as views of one flat float32 buffer ``flat``,
    and their gradients as views of ``grad`` (autograd adds into an existing
    ``.grad`` in place), both on ``device``.  Each parameter starts at a
    multiple of ``ALIGN`` elements; the padding stays zero."""

    ALIGN = 64

    def __init__(self, model: torch.nn.Module, device):
        self.names, self.shapes, self.offsets = [], [], []
        size = 0
        for name, p in model.named_parameters():
            self.names.append(name)
            self.shapes.append(tuple(p.shape))
            self.offsets.append(size)
            size += -(-p.numel() // self.ALIGN) * self.ALIGN
        self.flat = torch.zeros(size, dtype=torch.float32, device=device)
        self.grad = torch.zeros_like(self.flat)
        for (_, p), view, gview in zip(model.named_parameters(),
                                       self.views(self.flat).values(),
                                       self.views(self.grad).values()):
            view.copy_(p.detach())
            p.data = view
            p.grad = gview

    def views(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``buf`` (a buffer of ``flat``'s layout) by parameter name."""
        return {name: buf[o:o + math.prod(shape)].view(shape)
                for name, shape, o in zip(self.names, self.shapes,
                                          self.offsets)}

    def mask(self, names) -> torch.Tensor:
        """1 on the elements of the parameters ``names``, 0 elsewhere, in
        ``flat``'s layout."""
        m = torch.zeros_like(self.flat)
        views = self.views(m)
        for name in names:
            views[name].fill_(1.0)
        return m

    def load_(self, buf: torch.Tensor, state_dict) -> None:
        """Copy a ``state_dict`` (names as the model's) into ``buf``."""
        if set(state_dict) != set(self.names):
            raise ValueError(
                "parameter names differ: missing "
                f"{sorted(set(self.names) - set(state_dict))}, unexpected "
                f"{sorted(set(state_dict) - set(self.names))}")
        for name, view in self.views(buf).items():
            v = torch.as_tensor(state_dict[name])
            if tuple(v.shape) != tuple(view.shape):
                raise ValueError(f"{name}: shape {tuple(v.shape)}, the model's "
                                 f"{tuple(view.shape)}")
            view.copy_(v)


class OptState(NamedTuple):
    """The optimizer's state: adam's count, mu and nu (flat buffers) and the
    schedule's count; counts are int32 scalars on the device."""

    count: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    sched_count: torch.Tensor


_INT32_MAX = 2 ** 31 - 1


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    return torch.where(count < _INT32_MAX, count + 1, count)


class ClipAdamW:
    """``optax.chain(clip_by_global_norm(clip), adamw(lr_sched,
    weight_decay=weight_decay))`` on flat float32 buffers (no clip stage
    when ``clip`` <= 0, unless ``clip_stage`` asks for one, as the
    distillation chain does), with optax's arithmetic: the clip keeps g when
    its global norm is below ``clip``, else (g / norm) * clip; adam's moments
    (1 - b) g^k + b m, bias-corrected by 1 - b^count at the incremented
    count; the update m_hat / (sqrt(v_hat) + eps) + weight_decay * p, scaled
    by -lr read at the schedule's own count."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr_sched: Callable, clip: float, weight_decay: float,
                 clip_stage: Optional[bool] = None):
        self.lr_sched = lr_sched
        self.clip = float(clip)
        self.weight_decay = float(weight_decay)
        self.clip_stage = clip > 0 if clip_stage is None else bool(clip_stage)

    def init(self, flat: torch.Tensor) -> OptState:
        zero = torch.zeros((), dtype=torch.int32, device=flat.device)
        return OptState(zero, torch.zeros_like(flat), torch.zeros_like(flat),
                        zero.clone())

    def update(self, grads: torch.Tensor, state: OptState, params: torch.Tensor,
               grad_norm: torch.Tensor) -> Tuple[torch.Tensor, OptState]:
        """The new parameters and state (new tensors; nothing is mutated).
        ``grad_norm`` is the global norm of ``grads``."""
        g = grads
        if self.clip_stage:
            g = torch.where(grad_norm < self.clip, g,
                            (g / grad_norm) * self.clip)
        count = _safe_increment(state.count)
        mu = (1 - self.b1) * g + self.b1 * state.mu
        nu = (1 - self.b2) * (g * g) + self.b2 * state.nu
        c = count.to(torch.float32)
        mu_hat = mu / (1 - torch.pow(self.b1, c))
        nu_hat = nu / (1 - torch.pow(self.b2, c))
        u = mu_hat / (torch.sqrt(nu_hat) + self.eps) + self.weight_decay * params
        new_params = params + (-self.lr_sched(state.sched_count)) * u
        return new_params, OptState(count, mu, nu,
                                    _safe_increment(state.sched_count))

    def state_tree(self, state: OptState, flatp: FlatParams) -> dict:
        """The state in optax's state-dict layout:
        {"0": {}, "1": {"0": {count, mu, nu}, "1": {}, "2": {count}}}
        (without the clip stage {"0": {"0": ..., "1": {}, "2": ...}}); mu
        and nu are {"params": nested} as flax lays out the parameters."""
        adam = {"count": state.count, "mu": state_dict_to_flax(
            flatp.views(state.mu)), "nu": state_dict_to_flax(
            flatp.views(state.nu))}
        inner = {"0": adam, "1": {}, "2": {"count": state.sched_count}}
        return {"0": {}, "1": inner} if self.clip_stage else {"0": inner}

    def load_state_tree(self, state: OptState, tree: dict,
                        flatp: FlatParams) -> None:
        """Copy a state tree of :meth:`state_tree`'s layout (written by
        either package) into ``state``; a tree of another layout raises."""
        want = {"0", "1"} if self.clip_stage else {"0"}
        if set(tree) != want or (self.clip_stage and tree["0"]):
            raise ValueError(f"optimizer state: keys {sorted(tree)}, not "
                             f"those of this optimizer's chain")
        inner = tree["1"] if self.clip_stage else tree["0"]
        if (set(inner) != {"0", "1", "2"} or inner["1"]
                or set(inner["0"]) != {"count", "mu", "nu"}
                or set(inner["2"]) != {"count"}):
            raise ValueError("optimizer state: not the layout of "
                             "optax.adamw's state")
        for dst, src in ((state.count, inner["0"]["count"]),
                         (state.sched_count, inner["2"]["count"])):
            dst.copy_(torch.from_numpy(np.array(src, np.int32)))
        flatp.load_(state.mu, params_from_flax(inner["0"]["mu"]))
        flatp.load_(state.nu, params_from_flax(inner["0"]["nu"]))


@dataclasses.dataclass
class TrainState:
    """The model's parameters (:class:`FlatParams`), the EMA as a flat
    buffer (None without EMA), the optimizer state and the step (int32 on
    the device)."""

    params: FlatParams
    ema_params: Optional[torch.Tensor]
    opt_state: OptState
    step: torch.Tensor


def make_lr_schedule(cfg: TrainConfig, total_steps: int):
    """Linear warm-up, then cosine down to ``min_lr_scale`` of ``lr``, as a
    float32 function of the step (a tensor or an int)."""

    def sched(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp((step + 1.0) / max(1, cfg.warmup_steps), min=1e-8)
        progress = torch.clamp(
            (step - cfg.warmup_steps) / max(1, total_steps - cfg.warmup_steps),
            0.0, 1.0)
        if cfg.cosine_decay:
            cos = cfg.min_lr_scale + 0.5 * (1 - cfg.min_lr_scale) * (
                1 + torch.cos(math.pi * progress))
        else:
            cos = torch.ones_like(step)
        return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)

    return sched


def make_optimizer(cfg: TrainConfig, total_steps: int):
    lr_sched = make_lr_schedule(cfg, total_steps)
    return ClipAdamW(lr_sched, cfg.clip_grad, cfg.weight_decay), lr_sched


def _broadcast_meta(meta: Optional[torch.Tensor], L: int):
    """(B, C_meta) scalars -> (B, C_meta, L) channels (None without any)."""
    if meta is None or meta.dim() != 2 or meta.shape[1] == 0:
        return None
    return meta[:, :, None].expand(*meta.shape, L)


def _on_device(schedule: DiffusionSchedule, device) -> DiffusionSchedule:
    return DiffusionSchedule(*(a.to(device) for a in schedule))


def make_train_step(model: UNet1D, schedule: DiffusionSchedule,
                    cfg: TrainConfig, optimizer: ClipAdamW, lr_sched,
                    mesh: Optional[pmesh.Mesh] = None):
    """The train step:

        step(state, batch, key, t_min, p_uncond_eff, p_selfcond_eff) -> metrics

    ``batch``: the global batch, tensors on the model's device (clean,
    noisy, mask (B, 1, L), sigma (B,), meta (B, C); ``t_inject`` (B*K,) /
    ``eps_inject`` (B*K, 1, L) replace the draws of t and eps); ``key``: an
    int from :func:`split_key`.  Updates ``state`` in place and returns
    device scalars (loss, grad_norm, lr, ok, t_min, t_mean, t_max) and
    ``bsz_eff`` (B*K), all of the global batch.  With ``mesh`` this rank
    trains on its data index's rows of the batch and of every draw, and the
    loss and the gradient are averaged over the data axis (B must split
    evenly).  With a model axis the forwards and the backward run
    tensor-parallel and the gradients that each model rank computed in part
    are first summed over that axis.  The self-conditioning forward, the
    forward, the backward, the two reductions and the optimizer (with the
    EMA and the gate) run in ``torch.profiler`` ranges named
    ``train/...``."""
    K = max(1, int(cfg.t_multi))
    dev = next(model.parameters()).device
    sched = _on_device(schedule, dev)
    gen = torch.Generator(device=dev)
    mesh = mesh or pmesh.Mesh(1)
    keep = None     # the model reduction's mask, made at the first step

    def rows(x):
        return pmesh.local_rows(mesh, x)

    def apply_model(net_in, t):
        if cfg.remat:
            return torch.utils.checkpoint.checkpoint(model, net_in, t,
                                                     use_reentrant=False)
        return model(net_in, t)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], key: int,
             t_min: int, p_uncond_eff: float, p_selfcond_eff: float):
        with model.tensor_parallel(mesh):
            return step_body(state, batch, key, t_min, p_uncond_eff,
                           p_selfcond_eff)

    def step_body(state, batch, key, t_min, p_uncond_eff, p_selfcond_eff):
        nonlocal keep
        gen.manual_seed(key)
        clean_raw = rows(batch["clean"]).float()
        noisy_raw = rows(batch["noisy"]).float()
        sigma = rows(batch["sigma"]).float()
        mask = rows(batch["mask"]).float()
        L = clean_raw.shape[-1]

        sigma_ = sigma.reshape(-1, 1, 1)
        clean_norm = clean_raw / sigma_
        y_norm = noisy_raw / sigma_
        meta = batch.get("meta")
        meta_bc = _broadcast_meta(rows(meta) if meta is not None else None, L)
        if cfg.clamp_inputs > 0:
            clean_norm = clean_norm.clamp(-cfg.clamp_inputs, cfg.clamp_inputs)
            y_norm = y_norm.clamp(-cfg.clamp_inputs, cfg.clamp_inputs)
        if K > 1:
            clean_norm = clean_norm.repeat_interleave(K, dim=0)
            y_norm = y_norm.repeat_interleave(K, dim=0)
            mask = mask.repeat_interleave(K, dim=0)
            if meta_bc is not None:
                meta_bc = meta_bc.repeat_interleave(K, dim=0)
        # every draw is made for the global batch (bsz_eff rows) and this
        # rank keeps its rows, so the ranks train on the unsharded draws
        bsz_eff = batch["clean"].shape[0] * K
        if "t_inject" in batch:
            t_all = batch["t_inject"].long()
        elif cfg.t_cover == "strat":
            t_all = sample_timesteps_stratified(gen, bsz_eff, t_min,
                                                cfg.T - 1, cfg.t_bins)
        else:
            u = torch.rand(bsz_eff, generator=gen, device=dev)
            t_all = (t_min + torch.floor(u * (cfg.T - t_min))).long()
        t = rows(t_all)
        if "eps_inject" in batch:
            eps = rows(batch["eps_inject"]).float()
        else:
            eps = rows(torch.randn((bsz_eff,) + tuple(clean_norm.shape[1:]),
                                   generator=gen, device=dev,
                                   dtype=clean_norm.dtype))
        x_t = q_sample_with_eps(sched, clean_norm, t, eps)
        if cfg.clamp_inputs > 0:
            x_t = x_t.clamp(-cfg.clamp_inputs, cfg.clamp_inputs)

        drop = (rows(torch.rand((bsz_eff, 1, 1), generator=gen, device=dev))
                < p_uncond_eff).float()
        if meta_bc is not None and cfg.dropout_y_only:
            cond_used = torch.cat([y_norm * (1.0 - drop), meta_bc], dim=1)
        else:
            cond_stack = (torch.cat([y_norm, meta_bc], dim=1)
                          if meta_bc is not None else y_norm)
            cond_used = cond_stack * (1.0 - drop)

        # self-conditioning: one coin per batch, drawn on the host
        x0_sc = torch.zeros_like(x_t)
        if _uniform(key) < p_selfcond_eff:
            with torch.no_grad(), record_function("train/selfcond_forward"):
                out0 = model(torch.cat([x_t, cond_used, x0_sc], dim=1), t)
                ab = sched.alpha_bar[t].reshape(-1, 1, 1)
                if cfg.pred_type == "v":
                    x0_sc = torch.sqrt(ab) * x_t - torch.sqrt(1 - ab) * out0
                else:
                    x0_sc = (x_t - torch.sqrt(1 - ab) * out0) / torch.sqrt(ab)

        target = v_target(sched, clean_norm, eps, t) if cfg.pred_type == "v" \
            else eps
        with record_function("train/forward"):
            out = apply_model(torch.cat([x_t, cond_used, x0_sc], dim=1), t)
            loss = masked_loss(out, target, mask, t, sched, cfg.loss,
                               cfg.huber_beta, cfg.loss_weight_power)
        flatp = state.params
        with record_function("train/backward"):
            flatp.grad.zero_()
            loss.backward()
        loss = loss.detach()
        if mesh.model_group is not None:
            with record_function("train/model_all_reduce"):
                if keep is None:
                    # the partial gradients from every model rank, the
                    # whole ones (equal on every model rank) from rank 0
                    part = flatp.mask(model.tensor_parallel_partial(
                        mesh.n_model))
                    keep = torch.where(part > 0, 1.0,
                                       float(mesh.model_rank == 0))
                flatp.grad.mul_(keep)
                pmesh.sum_model_(mesh, flatp.grad)
        if mesh.group is not None:
            with record_function("train/all_reduce"):
                pmesh.mean_(mesh, flatp.grad)
                loss = pmesh.mean_(mesh, loss.reshape(1)).reshape(())

        with record_function("train/optimizer"):
            grad_norm = torch.linalg.vector_norm(flatp.grad)
            new_params, new_opt = optimizer.update(
                flatp.grad, state.opt_state, flatp.flat, grad_norm)
            ok = torch.isfinite(loss)
            if cfg.skip_bad_batches:
                ok = ok & (loss <= cfg.skip_loss_threshold)
            ok = ok & torch.isfinite(grad_norm)
            # the gate: a refused batch changes nothing
            lr = lr_sched(state.step)
            if state.ema_params is not None:
                d = cfg.ema_decay
                new_ema = d * state.ema_params + (1.0 - d) * new_params
                state.ema_params.copy_(
                    torch.where(ok, new_ema, state.ema_params))
            flatp.flat.copy_(torch.where(ok, new_params, flatp.flat))
            for old, new in zip(state.opt_state, new_opt):
                old.copy_(torch.where(ok, new, old))
            state.step.add_(ok.to(torch.int32))
        return {"loss": loss, "grad_norm": grad_norm, "lr": lr, "ok": ok,
                "t_min": t_all.min(), "t_mean": t_all.float().mean(),
                "t_max": t_all.max(), "bsz_eff": bsz_eff}

    return step


def make_probe_fn(model: UNet1D, schedule: DiffusionSchedule, cfg: TrainConfig):
    """Conditioning probe: conditioned vs unconditioned eps-prediction
    quality of one sample at a fixed timestep.

        probe(clean_norm0, y_norm0, meta_bc0, t_pick, generator) -> dict

    of device scalars (mse_on, mse_off, corr_on, corr_off, cond_delta_rms)."""
    dev = next(model.parameters()).device
    sched = _on_device(schedule, dev)

    def corr(a, b):
        a = a.reshape(-1) - a.mean()
        b = b.reshape(-1) - b.mean()
        den = torch.sqrt((a * a).sum()) * torch.sqrt((b * b).sum()) + 1e-12
        return (a * b).sum() / den

    @torch.no_grad()
    def probe(clean_norm0, y_norm0, meta_bc0, t_pick, generator):
        zeros_sc = torch.zeros_like(clean_norm0)
        zeros_y = torch.zeros_like(y_norm0)
        if meta_bc0 is not None and meta_bc0.shape[1] > 0:
            cond_on = torch.cat([y_norm0, meta_bc0], dim=1)
            cond_off = torch.cat([zeros_y, meta_bc0], dim=1)
        else:
            cond_on, cond_off = y_norm0, zeros_y
        t = torch.full((1,), int(t_pick), dtype=torch.long, device=dev)
        x_t, eps = q_sample(sched, clean_norm0, t, generator)
        eps_on = model(torch.cat([x_t, cond_on, zeros_sc], dim=1), t)
        eps_off = model(torch.cat([x_t, cond_off, zeros_sc], dim=1), t)
        delta = eps_on - eps_off
        return {
            "mse_on": ((eps_on - eps) ** 2).mean(),
            "mse_off": ((eps_off - eps) ** 2).mean(),
            "corr_on": corr(eps_on, eps),
            "corr_off": corr(eps_off, eps),
            "cond_delta_rms": (torch.linalg.vector_norm(delta.reshape(-1))
                               / math.sqrt(delta.numel())),
        }

    return probe


def masked_corr(a, b, m):
    """Masked Pearson correlation, scale-invariant: both inputs are
    max-abs-normalised before the products (f32 products of ~1e-22 strain
    values underflow), and a zero denominator gives 0 rather than an
    epsilon-padded ratio."""
    w = m.reshape(-1)
    a = a.reshape(-1) * w
    b = b.reshape(-1) * w
    n = torch.clamp(w.sum(), min=1.0)
    a = a - a.sum() / n * w
    b = b - b.sum() / n * w
    amax = a.abs().max()
    bmax = b.abs().max()
    a = torch.where(amax > 0, a / amax, a)
    b = torch.where(bmax > 0, b / bmax, b)
    den = torch.sqrt((a * a).sum()) * torch.sqrt((b * b).sum())
    return torch.where(den > 0, (a * b).sum() / den, torch.zeros_like(den))


def make_debug_x0_fn(model: UNet1D, schedule: DiffusionSchedule,
                     cfg: TrainConfig):
    """First-batch one-step-x0 probe: masked correlation and MSE of the
    single-step x0 estimate against clean, sigma-normalised and in the
    whitened domain, on sample 0.

        dbg(clean, noisy, sigma, mask, meta, t_pick, generator) -> dict"""
    dev = next(model.parameters()).device
    sched = _on_device(schedule, dev)

    @torch.no_grad()
    def dbg(clean, noisy, sigma, mask, meta, t_pick, generator):
        sigma_ = sigma.reshape(-1, 1, 1)
        clean_norm = clean / sigma_
        y_norm = noisy / sigma_
        if cfg.clamp_inputs > 0:
            clean_norm = clean_norm.clamp(-cfg.clamp_inputs, cfg.clamp_inputs)
            y_norm = y_norm.clamp(-cfg.clamp_inputs, cfg.clamp_inputs)
        meta_bc = _broadcast_meta(meta, clean.shape[-1])
        cond = (torch.cat([y_norm, meta_bc], dim=1) if meta_bc is not None
                else y_norm)
        t = torch.full((clean.shape[0],), int(t_pick), dtype=torch.long,
                       device=dev)
        x_t, _ = q_sample(sched, clean_norm, t, generator)
        if cfg.clamp_inputs > 0:
            x_t = x_t.clamp(-cfg.clamp_inputs, cfg.clamp_inputs)
        out = model(torch.cat([x_t, cond, torch.zeros_like(x_t)], dim=1), t)
        if cfg.pred_type == "v":
            x0_hat_norm, _ = v_to_x0_eps(sched, x_t, out, t)
        else:
            x0_hat_norm = eps_to_x0(sched, x_t, out, t)
        x0_hat = x0_hat_norm * sigma_
        m0 = mask[:1]
        msum = torch.clamp(m0.sum(), min=1.0)
        return {
            "valid_frac": m0.mean(),
            "corr_x0_norm": masked_corr(x0_hat_norm[:1], clean_norm[:1], m0),
            "corr_x0_white": masked_corr(x0_hat[:1], clean[:1], m0),
            "mse_x0_norm": (((x0_hat_norm[:1] - clean_norm[:1]) ** 2)
                            * m0).sum() / msum,
            "mse_x0_white": (((x0_hat[:1] - clean[:1]) ** 2) * m0).sum() / msum,
            "x0_hat_sample0": x0_hat[0],
        }

    return dbg


def prepare_output_dir(base_dir: str) -> str:
    """Empty ``<base>/latest_model`` (creating it when missing)."""
    out_dir = os.path.join(base_dir, "latest_model")
    if os.path.exists(out_dir):
        for f in os.listdir(out_dir):
            p = os.path.join(out_dir, f)
            try:
                os.remove(p) if os.path.isfile(p) else shutil.rmtree(p)
            except OSError:
                pass
    else:
        os.makedirs(out_dir, exist_ok=True)
    return out_dir


def build_model_and_state(cfg: TrainConfig, c_meta: int, total_steps: int,
                          key: int, device=None):
    """The model (its initial weights drawn from ``key``, or ``init_from``'s
    EMA-preferred weights), schedule, optimizer, learning-rate schedule and
    :class:`TrainState` on ``device`` (default: the GPU).  Channels:
    cond_in_ch = 1 + C_meta; in_ch = 1 + cond_in_ch + 1 (self-cond)."""
    cond_in_ch = 1 + c_meta
    in_ch = 1 + cond_in_ch + 1
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(key)
        model = UNet1D(in_ch=in_ch, base_ch=cfg.base_ch, time_dim=cfg.time_dim,
                       depth=cfg.depth, t_embed_max_time=max(0, cfg.T - 1),
                       cond_in_ch=cond_in_ch, use_selfcond=True,
                       use_attention=cfg.use_attention,
                       dtype=torch.bfloat16 if cfg.bf16 else None,
                       device="cpu")
    schedule = make_schedule(cfg.T, cfg.schedule)
    if cfg.init_from:
        if cfg.init_from.endswith((".pth", ".pt")):
            from ..utils.torch_compat import load_torch_checkpoint_as_flax

            weights, _, _ = load_torch_checkpoint_as_flax(cfg.init_from,
                                                          cfg.depth)
            print(f"[init] loaded torch weights from {cfg.init_from} "
                  f"(EMA preferred)")
        else:
            weights, used_ema = select_weights(load_checkpoint(cfg.init_from),
                                               use_ema=True)
            print(f"[init] loaded weights from {cfg.init_from} "
                  f"(EMA={used_ema})")
        model.load_state_dict(params_from_flax(weights), strict=True)
    optimizer, lr_sched = make_optimizer(cfg, total_steps)
    params = FlatParams(model, dev)
    state = TrainState(
        params=params,
        ema_params=params.flat.clone() if cfg.ema else None,
        opt_state=optimizer.init(params.flat),
        step=torch.zeros((), dtype=torch.int32, device=dev))
    return model, schedule, optimizer, lr_sched, state, (in_ch, cond_in_ch)


def checkpoint_args(cfg: TrainConfig, in_ch: int, cond_in_ch: int, c_meta: int,
                    meta_scale: dict, whiten_mode_resolved: str = "",
                    data_fs: float = 0.0) -> dict:
    """The checkpoint ``args`` contract: every config field, the whitening
    domain the data actually used, the data's sampling rate and the
    conditioning layout."""
    d = dataclasses.asdict(cfg)
    d.update({
        "whiten_mode_resolved": whiten_mode_resolved,
        "fs": float(data_fs),
        "conditional": True,
        "in_ch": in_ch,
        "cond_in_ch": cond_in_ch,
        "meta_enabled": c_meta > 0,
        "meta_channels": c_meta,
        "conditioning": ("concat[y + meta]+selfcond" if c_meta > 0
                         else "concat[y]+selfcond"),
        "dropout_y_only": bool(cfg.dropout_y_only),
        "meta_scale": meta_scale,
    })
    return d


def restore_state(state: TrainState, optimizer: ClipAdamW, ck: dict,
                  n_batches: int) -> int:
    """Load a checkpoint read by ``load_checkpoint`` (from either package)
    into ``state``: parameters, EMA, optimizer state and step (the stored
    ``global_step``, else epoch x ``n_batches``).  Returns the step."""
    flatp = state.params
    flatp.load_(flatp.flat, params_from_flax(ck["model_state"]))
    if "model_ema_state" in ck and state.ema_params is not None:
        flatp.load_(state.ema_params, params_from_flax(ck["model_ema_state"]))
    if "optimizer_state" in ck:
        optimizer.load_state_tree(state.opt_state, ck["optimizer_state"], flatp)
    step = int(ck.get("global_step", int(ck.get("epoch", 0)) * n_batches))
    state.step.fill_(step)
    return step


def _metric_table(pending) -> np.ndarray:
    """(steps, 7) host array of the deferred metrics, in one copy."""
    keys = ("loss", "grad_norm", "lr", "ok", "t_min", "t_mean", "t_max")
    return torch.stack([torch.stack([m[k].to(torch.float32) for k in keys])
                        for _, _, m in pending]).cpu().numpy()


def train(cfg: TrainConfig, dataset=None, mesh=None,
          device=None) -> Dict[str, Any]:
    """A full training run on ``device`` (default: the GPU); returns a dict
    with the final state, model, schedule, checkpoint path, history and
    output directory.  ``dataset``: a ready :class:`PreparedDataset`,
    else ``cfg.data`` is read (``synth:N`` synthesises N samples on the
    device; anything else is an HDF5 corpus, which needs h5py, or its
    ``.npz`` twin).

    ``mesh`` (``parallel.mesh.make_mesh``) trains over its axes: rows over
    the data axis, the blocks that JAX shards over the model axis.  Without
    one, a process group of several ranks (``torchrun``; joined here by
    ``multihost_init``) with ``cfg.data_parallel`` or ``cfg.tp`` > 1 makes
    the mesh as JAX makes it over its devices: ``cfg.tp`` ranks on the
    model axis, the rest (or 1 with data parallelism off) on the data
    axis, unless the batch does not split evenly over the data axis: then
    every rank trains unsharded.  Only rank 0 writes files."""
    from ..data import pipeline as dpipe
    from ..data.hdf5io import compute_meta_scale
    from ..utils.roofline import peak_for, unet_flops_per_sample

    if mesh is not None:
        pmesh.check_mesh(mesh)
    pmesh.multihost_init(device)
    dev = resolve_device(device)
    n_world = pmesh.world_size()
    tp = int(cfg.tp)
    if (mesh is None and n_world == 1 and dev.type == "cuda"
            and (cfg.data_parallel or tp > 1)
            and torch.cuda.device_count() > 1):
        n_gpu = torch.cuda.device_count()
        raise NotImplementedError(
            f"{n_gpu} GPUs are visible to one process with data or tensor "
            f"parallelism on: the port runs one process per GPU. Launch with "
            f"`torchrun --nproc-per-node {n_gpu} -m "
            f"diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch"
            f".cli.train ...`, expose one GPU (CUDA_VISIBLE_DEVICES) or pass "
            f"--no-data-parallel" + (" and --tp 1" if tp > 1 else ""))
    # JAX's mesh rule and its three messages, with the world size in place
    # of the device count
    if mesh is None and (cfg.data_parallel or tp > 1) and n_world > 1:
        n_model = max(1, tp)
        n_data = max(1, n_world // n_model) if cfg.data_parallel else 1
        if n_model > n_world:
            raise ValueError(
                f"--tp {cfg.tp} requested but only {n_world} "
                f"devices are visible")
        if n_data * n_model != n_world:
            # JAX leaves spare devices idle; a spare process would leave
            # the others waiting for it at their first collective
            raise ValueError(
                f"{n_world} processes do not fill the {n_data}x{n_model} "
                f"mesh (--tp {cfg.tp}): process {pmesh.process_index()} "
                f"would be outside it; start {n_data * n_model} processes")
        if cfg.batch_size % n_data == 0:
            mesh = pmesh.make_mesh(n_data=n_data, n_model=n_model)
        else:
            dropped = (f" (and the requested --tp {cfg.tp} tensor "
                       f"parallelism)" if n_model > 1 else "")
            print(f"[train] batch_size={cfg.batch_size} not divisible by "
                  f"{n_data} data-parallel devices; running without "
                  f"sharding{dropped}")
    elif mesh is None and tp > 1:
        print(f"[train] --tp {cfg.tp} requested but only "
              f"{n_world} device(s) visible; tensor parallelism "
              f"dropped")
    n_chips = mesh.n_data * mesh.n_model if mesh is not None else 1
    writer = pmesh.process_index() == 0

    t_run0 = time.time()
    rng = np.random.default_rng(cfg.seed)
    key = key_from_seed(cfg.seed)
    # read the resume payload before the output directory is emptied (by
    # rank 0, once every rank has read it)
    ck_resume = load_checkpoint(cfg.resume) if cfg.resume else None
    pmesh.barrier()
    out_dir = (prepare_output_dir(cfg.model_dir) if writer
               else os.path.join(cfg.model_dir, "latest_model"))
    logger = JsonlLogger(cfg.log_jsonl if writer else None)

    if dataset is None:
        if cfg.data.startswith("synth:"):
            n_synth = int(cfg.data.split(":", 1)[1])
            print(f"[train] synthesising {n_synth} samples on device")
            dataset = dpipe.synthetic_dataset(
                n_synth, seed=cfg.seed, whiten=cfg.whiten,
                sigma_mode=cfg.sigma_mode, device=dev)
        elif cfg.streaming:
            if cfg.max_len:
                raise ValueError(
                    "--max-len is only supported by the non-streaming loader")
            meta_scale = compute_meta_scale(cfg.data)
            dataset = dpipe.StreamingDataset(
                cfg.data, whiten=cfg.whiten, whiten_mode=cfg.whiten_mode,
                sigma_mode=cfg.sigma_mode, sigma_fixed=cfg.sigma_fixed,
                include_metadata=True, mass_scale=meta_scale.get("M", 80.0),
                chunk=cfg.stream_chunk)
        else:
            meta_scale = compute_meta_scale(cfg.data)
            dataset = dpipe.prepare_dataset(
                cfg.data, whiten=cfg.whiten, whiten_mode=cfg.whiten_mode,
                sigma_mode=cfg.sigma_mode, sigma_fixed=cfg.sigma_fixed,
                include_metadata=True, mass_scale=meta_scale.get("M", 80.0),
                max_len=cfg.max_len or None)
    meta_scale = dataset.meta_scale
    wm_resolved = getattr(dataset, "whiten_mode_resolved",
                          "train" if cfg.whiten else "none")
    data_fs = float(getattr(dataset, "fs", 0.0))

    c_meta = dpipe.meta_dim(dataset)
    n_batches = dpipe.num_batches(dataset, cfg.batch_size)
    total_steps = n_batches * cfg.epochs

    key, k_init = split_key(key)
    model, schedule, optimizer, lr_sched, state, (in_ch, cond_in_ch) = (
        build_model_and_state(cfg, c_meta, total_steps, k_init, dev))
    print(f"[train] dataset n={dataset.n} buckets={dataset.bucket_lengths} "
          f"meta_scale={meta_scale}")
    print(f"[train] C_meta={c_meta} cond_in_ch={cond_in_ch} in_ch={in_ch} "
          f"batches/epoch={n_batches} device={dev}"
          + (f" mesh={mesh.shape} rank={mesh.rank}" if mesh is not None
             else ""))

    # analytic MFU: forward + ~2x backward + the self-conditioning forward
    # on p_selfcond of the steps; the FLOPs the port runs (no folded decoder)
    fwd_flops = unet_flops_per_sample(
        dataset.bucket_lengths[0], in_ch, cfg.base_ch, cfg.depth,
        cond_ch=cond_in_ch, fast_decoder=False,
        use_attention=cfg.use_attention)
    train_flops_per_sample = (3.0 + float(cfg.p_selfcond)) * fwd_flops
    peak = peak_for(torch.cuda.get_device_name(dev)) if dev.type == "cuda" \
        else None

    step_fn = make_train_step(model, schedule, cfg, optimizer, lr_sched, mesh)
    probe_fn = (make_probe_fn(model, schedule, cfg)
                if cfg.probe_cond and writer else None)
    debug_x0_fn = None
    side_gen = torch.Generator(device=dev)

    start_epoch = 1
    if ck_resume is not None:
        step_restored = restore_state(state, optimizer, ck_resume, n_batches)
        if "rng_key" in ck_resume:
            key = key_from_array(ck_resume["rng_key"])
        start_epoch = int(ck_resume.get("epoch", 0)) + 1
        print(f"[train] resumed from {cfg.resume} at epoch {start_epoch} "
              f"(global step {step_restored})")
    if mesh is not None:
        # the weights stay whole on every rank (shard_params_tp); the
        # optimizer state and the step are replicated with them
        pmesh.shard_params_tp([state.params.flat, state.ema_params], mesh)
        pmesh.replicate_tree([*state.opt_state, state.step], mesh)
        tp_on = mesh.n_model > 1
        print(f"[train] mesh {mesh.shape}"
              + (" (tensor-parallel conv channels)" if tp_on else ""))
        if tp_on:
            split, whole = model.tensor_parallel_plan(mesh.n_model)
            print(f"[train] split over the model axis: {', '.join(split)}; "
                  f"whole on every model rank: {', '.join(whole) or 'none'}")

    if cfg.t_min_frac > 0:
        print(f"[train] WARNING: t_min_frac={cfg.t_min_frac} — timesteps "
              f"t < {int(cfg.t_min_frac * cfg.T)} will be untrained; "
              f"full-range sampling from noise requires t_min_frac=0")

    dev_buckets = None
    if cfg.device_data and not cfg.streaming:
        dev_buckets = dpipe.upload_buckets(dataset, dev)
        if dev_buckets is not None:
            mb = sum(v.numel() * v.element_size() for b in dev_buckets.values()
                     for v in b.values()) / 1e6
            print(f"[train] dataset resident on device ({mb:.0f} MB); "
                  f"on-device batch gather (no per-step H2D)")

    history = []
    global_step = (start_epoch - 1) * n_batches
    prof = None
    for epoch in range(start_epoch, cfg.epochs + 1):
        t_min_epoch = int(max(0, min(cfg.T - 1, int(cfg.t_min_frac * cfg.T))))
        p_u = 0.0 if epoch <= cfg.force_cond_epochs else cfg.p_uncond
        p_sc = 0.0 if epoch <= cfg.force_cond_epochs else cfg.p_selfcond
        print(f"[train] epoch {epoch}/{cfg.epochs} p_uncond={p_u:.2f} "
              f"p_selfcond={p_sc:.2f} t_min={t_min_epoch}")

        sum_loss_w, sum_w, batch_losses, skipped = 0.0, 0, [], 0
        t_epoch0 = time.time()
        if dev_buckets is not None:
            batches = dpipe.device_resident_batches(
                dataset, cfg.batch_size, rng, dev_buckets)
        elif (cfg.streaming and cfg.device_data
              and hasattr(dataset, "iter_batches_device")):
            # chunks resident on the device: no copy after the first epoch
            batches = dataset.iter_batches_device(cfg.batch_size, rng,
                                                  device=dev)
        else:
            batches = dpipe.prefetch_to_device(
                dpipe.iterate_batches(dataset, cfg.batch_size, rng),
                size=2, device=dev)
        pending = []   # metrics stay on the device until the epoch's end
        for i, jb in enumerate(batches):
            if (cfg.profile_dir and writer
                    and global_step == cfg.profile_steps[0]):
                prof = _start_profiler(dev)
            key, k_step = split_key(key)
            m = step_fn(state, jb, k_step, t_min_epoch, p_u, p_sc)
            pending.append((global_step, i, m))
            global_step += 1
            if prof is not None and global_step >= cfg.profile_steps[1]:
                _stop_profiler(prof, dev, cfg.profile_dir)
                prof = None

            # probes and the debug dump run on rank 0, but every rank
            # splits their keys, so the step keys stay the same everywhere
            if cfg.probe_cond and (i % max(1, cfg.probe_interval) == 0):
                sigma_ = jb["sigma"].reshape(-1, 1, 1)
                c0 = (jb["clean"] / sigma_)[:1]
                y0 = (jb["noisy"] / sigma_)[:1]
                meta0 = _broadcast_meta(jb.get("meta"), c0.shape[-1])
                meta0 = meta0[:1] if meta0 is not None else None
                for t_pick in cfg.probe_t:
                    key, k_p = split_key(key)
                    if probe_fn is None:
                        continue
                    side_gen.manual_seed(k_p)
                    pm = probe_fn(c0, y0, meta0,
                                  int(np.clip(t_pick, 0, cfg.T - 1)), side_gen)
                    logger.log({"phase": "probe", "epoch": epoch, "batch": i,
                                "t": int(t_pick),
                                **{k: float(v) for k, v in pm.items()}})

            if cfg.debug_first and i == 0 and (
                    epoch == 1 or (cfg.debug_first_every
                                   and epoch % cfg.debug_first_every == 0)):
                key, k_dbg = split_key(key)
                if writer:
                    if debug_x0_fn is None:
                        debug_x0_fn = make_debug_x0_fn(model, schedule, cfg)
                    side_gen.manual_seed(k_dbg)
                    x0m = debug_x0_fn(jb["clean"], jb["noisy"], jb["sigma"],
                                      jb["mask"], jb.get("meta"), cfg.T // 2,
                                      side_gen)
                    _first_batch_debug(jb, m, out_dir, epoch, x0m)

        # the epoch's metrics in one device-to-host copy
        table = _metric_table(pending) if pending else np.zeros((0, 7))
        for (gs, i, m), row in zip(pending, table):
            loss, grad_norm, lr, ok, t_lo, t_mean, t_hi = row
            loss = float(loss)
            if not ok:
                skipped += 1
                print(f"[warn] batch {i} skipped (loss={loss:.3e})")
            else:
                batch_losses.append(loss)
                sum_loss_w += loss * m["bsz_eff"]
                sum_w += m["bsz_eff"]
            logger.log({
                "phase": "train_batch", "step": gs, "epoch": epoch,
                "batch": i, "t_min": int(t_lo), "t_mean": float(t_mean),
                "t_max": int(t_hi), "loss": loss,
                "grad_norm": float(grad_norm), "lr": float(lr),
            })

        # a majority-skipped epoch means divergence or broken data: stop
        n_seen = len(batch_losses) + skipped
        if cfg.skip_bad_batches and n_seen >= 4 and skipped > n_seen // 2:
            if writer:
                _save(out_dir, state, cfg, in_ch, cond_in_ch, c_meta,
                      meta_scale, epoch, name="model_diffusion_aborted.msgpack",
                      key=key, whiten_mode_resolved=wm_resolved,
                      data_fs=data_fs, optimizer=optimizer)
            raise RuntimeError(
                f"epoch {epoch}: {skipped}/{n_seen} batches skipped "
                f"(non-finite or above loss threshold) — aborting; last "
                f"state saved to model_diffusion_aborted.msgpack")

        avg = sum_loss_w / max(1, sum_w)
        mean_b = float(np.mean(batch_losses)) if batch_losses else float("nan")
        med_b = float(np.median(batch_losses)) if batch_losses else float("nan")
        dt_epoch = max(1e-9, time.time() - t_epoch0)
        steps_per_s = n_batches / dt_epoch
        samples_per_s = steps_per_s * cfg.batch_size
        mfu_est = (train_flops_per_sample * samples_per_s / n_chips / peak[0]
                   if peak else None)
        print(f"[train] epoch {epoch}: avg/sample={avg:.6f} mean/batch={mean_b:.6f} "
              f"median/batch={med_b:.6f} skipped={skipped} "
              f"({steps_per_s:.2f} steps/s, {samples_per_s:.1f} samples/s, "
              f"{samples_per_s / n_chips:.1f} samples/s/chip"
              + (f", MFU~{mfu_est:.3f}" if mfu_est is not None else "") + ")")
        logger.log({"phase": "epoch_end", "epoch": epoch, "avg_per_sample": avg,
                    "mean_per_batch": mean_b, "median_per_batch": med_b,
                    "skipped_batches": skipped,
                    "steps_per_sec": steps_per_s,
                    "samples_per_sec": samples_per_s,
                    "samples_per_sec_per_chip": samples_per_s / n_chips,
                    "mfu_est": mfu_est,
                    "elapsed_s": time.time() - t_run0,
                    **{k: getattr(dataset, a) for k, a in (
                        ("h2d_bytes", "h2d_bytes_epoch"),
                        ("peak_live_samples", "peak_live_samples"))
                       if hasattr(dataset, a)}})
        history.append({"epoch": epoch, "avg_per_sample": avg})

        if (cfg.save_every_epochs and epoch % cfg.save_every_epochs == 0
                and writer):
            _save(out_dir, state, cfg, in_ch, cond_in_ch, c_meta, meta_scale,
                  epoch, name=f"model_diffusion_ep{epoch}.msgpack", key=key,
                  whiten_mode_resolved=wm_resolved, data_fs=data_fs,
                  optimizer=optimizer)

    if prof is not None:
        _stop_profiler(prof, dev, cfg.profile_dir)
    save_path = os.path.join(out_dir, "model_diffusion.msgpack")
    if writer:
        _save(out_dir, state, cfg, in_ch, cond_in_ch, c_meta, meta_scale,
              cfg.epochs, key=key, whiten_mode_resolved=wm_resolved,
              data_fs=data_fs, optimizer=optimizer)
        print(f"[train] saved model to {save_path}")
    return {
        "state": state, "model": model, "schedule": schedule,
        "checkpoint": save_path, "history": history, "out_dir": out_dir,
        "in_ch": in_ch, "cond_in_ch": cond_in_ch,
    }


def _start_profiler(dev):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profiler(prof, dev, profile_dir: str) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prof.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"[train] profiler trace -> {path}")


def _save(out_dir, state: TrainState, cfg, in_ch, cond_in_ch, c_meta,
          meta_scale, epoch, name="model_diffusion.msgpack", key=None,
          whiten_mode_resolved: str = "", data_fs: float = 0.0,
          optimizer: Optional[ClipAdamW] = None):
    """Write the checkpoint: parameters, EMA, the optimizer state in optax's
    layout, the step and the key."""
    path = os.path.join(out_dir, name)
    flatp = state.params
    save_checkpoint(
        path,
        model_state=flatp.views(flatp.flat),
        args=checkpoint_args(cfg, in_ch, cond_in_ch, c_meta, meta_scale,
                             whiten_mode_resolved=whiten_mode_resolved,
                             data_fs=data_fs),
        epoch=epoch,
        model_ema_state=(flatp.views(state.ema_params)
                         if state.ema_params is not None else None),
        opt_state=(optimizer.state_tree(state.opt_state, flatp)
                   if optimizer is not None else None),
        global_step=int(state.step),
        rng_key=key_to_array(key) if key is not None else None,
    )
    return path


def _first_batch_debug(jb, metrics, out_dir, epoch, x0m=None):
    """First-batch statistics, the one-step-x0 quality and .npy dumps."""
    def host(a):
        return a.detach().float().cpu().numpy() if isinstance(
            a, torch.Tensor) else np.asarray(a)

    def stats(name, a):
        a = host(a).astype(np.float64)
        print(f"[DEBUG] {name}: min={a.min():.3e} max={a.max():.3e} "
              f"mean={a.mean():.3e} std={a.std():.3e}")

    sigma = host(jb["sigma"])
    print(f"[DEBUG] sigma[min/mean/max]={sigma.min():.3e}/{sigma.mean():.3e}/"
          f"{sigma.max():.3e}")
    stats("clean", jb["clean"])
    stats("noisy", jb["noisy"])
    if x0m is not None:
        x0m = {k: host(v) for k, v in x0m.items()}
        print(f"[DEBUG] valid_frac={float(x0m['valid_frac']):.3f} , "
              f"corr_masked(x0_norm, clean_norm)="
              f"{float(x0m['corr_x0_norm']):.3f} "
              f"corr_masked(x0, clean)={float(x0m['corr_x0_white']):.3f} , "
              f"MSE_masked_norm={float(x0m['mse_x0_norm']):.3e} , "
              f"MSE_masked_white={float(x0m['mse_x0_white']):.3e}")
    if epoch == 1:
        try:
            dbg = os.path.join(out_dir, "debug_batch0")
            os.makedirs(dbg, exist_ok=True)
            np.save(os.path.join(dbg, "clean_raw.npy"),
                    host(jb["clean"][0]).ravel())
            np.save(os.path.join(dbg, "y_norm.npy"),
                    (host(jb["noisy"][0]) / max(sigma[0], 1e-30)).ravel())
            if x0m is not None:
                np.save(os.path.join(dbg, "x0_hat.npy"),
                        x0m["x0_hat_sample0"].ravel())
            print(f"[DEBUG] wrote debug npys -> {dbg}")
        except OSError as e:
            print("[DEBUG] npy-dump skipped:", e)
