"""Progressive distillation on the GPU: halve the sampler's steps, keep its
quality (counterpart of the JAX package's ``training/distill.py``; the
same recipe, configuration and checkpoints).

Salimans & Ho, "Progressive Distillation for Fast Sampling of Diffusion
Models" (ICLR 2022), for this conditional denoiser.  Per stage (teacher
with a 2N-step ladder -> student with N steps):

1. ``x_t = q_sample(x0, t_i)`` at a random student-ladder time ``t_i``;
2. the TEACHER runs two deterministic DDIM sub-steps ``t_i -> t_mid ->
   t_next`` with classifier-free guidance folded in at weight ``w``
   (out = w out_c + (1 - w) out_u, cond and uncond as one doubled batch)
   and the deployment clamps applied;
3. the x0 the student must predict to land on the teacher's endpoint in
   one DDIM step:
       x0_tgt = (sb_i * x'' - sb_n * x_t) / (sa_n * sb_i - sb_n * sa_i)
   with sa = sqrt(alpha_bar), sb = sqrt(1 - alpha_bar) at (i = t_i,
   n = t_next); past the ladder's end alpha_bar = 1 and x0_tgt = x'';
4. the student's x0 regresses on x0_tgt with the truncated-SNR weight
   max(alpha_bar / (1 - alpha_bar), 1), masked to valid samples.

Teacher and student run with a ZERO self-conditioning channel; stage
checkpoints record ``selfcond_mode='zero'`` and ``distilled_steps`` /
``distilled_cfg_scale`` / ``distilled_ladder`` / ``distilled_start_t``, so
``gw-infer`` and ``gw-grid`` pick the deployment knobs themselves.

How it runs on the card: the teacher is a second ``UNet1D`` called under
``torch.no_grad()``; both forwards of the teacher and the student's launch
the port's kernels (K1 in every ConvBlock, K2 on an attention model), and
the student's backward launches the ops' backward kernels (K1B, K2B).  The
student's parameters, the EMA and the teacher are flat float32 buffers
(``training/train.py``'s :class:`FlatParams`): the EMA student becomes the
next teacher by one copy.  The optimizer is :class:`ClipAdamW` (optax's
clip + AdamW arithmetic and state layout, the clip stage always in the
chain) on optax's ``warmup_cosine_decay_schedule``; the bad-batch gate is branchless, as in
the trainer.  Each step's parts run in ``torch.profiler`` ranges named
``distill/...``.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..ops.schedules import (
    DiffusionSchedule,
    build_lambda_t_schedule,
    build_t_schedule,
)
from ..utils.checkpoint import save_checkpoint
from ..utils.device import resolve_device
from ..utils.jsonl import JsonlLogger
from .train import (
    ClipAdamW,
    FlatParams,
    TrainState,
    _broadcast_meta,
    key_from_seed,
    split_key,
)


@dataclasses.dataclass
class DistillConfig:
    """Distillation run parameters, field for field those of the JAX
    package (everything else inherits from the teacher checkpoint's args)."""

    teacher: str                       # checkpoint path (.msgpack or .pth)
    data: str                          # .h5 corpus or its .npz twin
    model_dir: str = "distilled"
    # halving chain: first entry = the TEACHER's sampling steps for stage 1;
    # each subsequent entry is a student. [64, 32, 16, 8, 4] runs 4 stages.
    steps_schedule: Optional[List[int]] = None
    epochs_per_stage: int = 4
    batch_size: int = 64
    lr: float = 1e-4
    weight_decay: float = 0.0
    clip_grad: float = 1.0
    cfg_scale: float = 1.5             # guidance folded into the student
    ladder: str = "lambda"             # deployment ladder family
    start_t: Optional[int] = 999       # top-of-chain (full-range sampling)
    ema: bool = True
    ema_decay: float = 0.999
    seed: int = 42
    device_data: bool = True
    log_jsonl: Optional[str] = None
    save_every_stage: bool = True

    def __post_init__(self):
        if self.steps_schedule is None:
            self.steps_schedule = [64, 32, 16, 8, 4]


def _teacher_ladder(schedule: DiffusionSchedule, n_student: int, ladder: str,
                    start_t: Optional[int]) -> np.ndarray:
    """Teacher ladder = the student's DEPLOYMENT ladder interleaved with
    lambda-midpoints (length exactly 2x the student's), built from the
    samplers' own ladder builders; the final segment ends on the virtual
    alpha_bar = 1 point and its midpoint is halfway to t = 0."""
    if ladder == "lambda":
        stud = build_lambda_t_schedule(schedule, n_student, start_t)
    else:
        stud = build_t_schedule(schedule.T, n_student, start_t)
    stud = np.asarray(stud, np.int64)
    ab = np.asarray(schedule.alpha_bar, np.float64).clip(1e-12, 1 - 1e-12)
    lam = 0.5 * (np.log(ab) - np.log1p(-ab))
    s = int(stud[0])
    rev_lam = lam[s::-1]
    rev_t = np.arange(s, -1, -1, dtype=np.float64)
    out = []
    for i, t_i in enumerate(stud):
        out.append(int(t_i))
        if i + 1 < len(stud):
            mid_lam = 0.5 * (lam[t_i] + lam[stud[i + 1]])
            t_mid = int(round(float(np.interp(mid_lam, rev_lam, rev_t))))
            out.append(int(np.clip(t_mid, stud[i + 1], t_i)))
        else:
            out.append(int(t_i) // 2)
    return np.asarray(out, np.int64)


def distill_lr_schedule(lr: float, total: int):
    """optax's ``warmup_cosine_decay_schedule(0, lr, warmup, total,
    0.1 lr)`` with warmup = min(100, max(1, total // 20)), as a float32
    function of the step count (a tensor or an int)."""
    warmup = min(100, max(1, total // 20))
    decay = total - warmup
    if not decay > 0:
        raise ValueError(f"the cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay}")
    end = lr * 0.1
    alpha = 0.0 if lr == 0.0 else end / lr

    def sched(count):
        c = torch.as_tensor(count).to(torch.float32)
        frac = 1.0 - torch.clamp(c, 0, warmup) / warmup
        linear = (0.0 - lr) * frac + lr
        cd = torch.clamp(c - warmup, max=float(decay))
        cosine = 0.5 * (1.0 + torch.cos(math.pi * cd / float(decay)))
        cos_val = lr * ((1.0 - alpha) * cosine + alpha)
        return torch.where(c < warmup, linear, cos_val)

    return sched


def distill_optimizer(cfg: DistillConfig, total: int) -> ClipAdamW:
    """A stage's ``optax.chain(clip_by_global_norm(clip_grad), adamw(...))``
    over ``total`` steps: the clip stage is always there, as in JAX's chain,
    so ``clip_grad`` 0 zeroes the gradients (weight decay still applies)."""
    return ClipAdamW(distill_lr_schedule(cfg.lr, total), cfg.clip_grad,
                     cfg.weight_decay, clip_stage=True)


def make_distill_step(model, schedule: DiffusionSchedule, cfg: DistillConfig,
                      optimizer: ClipAdamW, teacher_ladder: np.ndarray,
                      pred_type: str, clamp_inputs: float = 10.0,
                      x0_clip: float = 10.0):
    """The distillation step over a fixed teacher ladder of 2N entries:

        step(state, teacher, batch, key) -> metrics

    ``model`` is the student (its parameters ``state.params``), ``teacher``
    a ``UNet1D`` of the same architecture; ``batch``: tensors on the
    model's device (clean, noisy, mask (B, 1, L), sigma (B,), meta (B, C);
    ``j_inject`` (B,) and ``eps0_inject`` (B, 1, L) replace the draws of
    the student segments and the forward noise); ``key``: an int from
    :func:`split_key`.  Updates ``state`` in place and returns device
    scalars loss, grad_norm and ok."""
    tl = np.asarray(teacher_ladder, np.int64)
    n2 = len(tl)
    if n2 % 2:
        raise ValueError("teacher ladder length must be even (2x student)")
    n_student = n2 // 2
    ab_np = np.asarray(schedule.alpha_bar, np.float64).clip(1e-12, 1.0)
    # alpha_bar along the ladder, with the virtual final point ab=1
    ab_ext = np.concatenate([ab_np[tl], [1.0]]).astype(np.float32)
    w = float(cfg.cfg_scale)
    # a duplicate-collapsed segment (tiny T grids) has no usable DDIM
    # inversion: its loss weight is zero instead of a division by ~0
    seg_valid = (ab_ext[2::2][:n_student]
                 - ab_ext[0:-1:2][:n_student]) > 1e-5

    dev = next(model.parameters()).device
    ts_d = torch.as_tensor(tl, dtype=torch.int64, device=dev)
    ab_d = torch.as_tensor(ab_ext, device=dev)
    valid_d = torch.as_tensor(seg_valid.astype(np.float32), device=dev)
    gen = torch.Generator(device=dev)

    def x0_eps(out, x_t, ab):
        sa = torch.sqrt(ab)
        sb = torch.sqrt(torch.clamp(1.0 - ab, min=0.0))
        if pred_type == "v":
            return sa * x_t - sb * out, sb * x_t + sa * out
        return (x_t - sb * out) / torch.clamp(sa, min=1e-6), out

    @torch.no_grad()
    def teacher_fwd(teacher, x_t, t_b, cond_c, cond_u, sc):
        """Deployed-teacher forward: folded CFG + deployment clamps."""
        if clamp_inputs > 0:
            x_t = torch.clamp(x_t, -clamp_inputs, clamp_inputs)
        B = x_t.shape[0]
        net_c = torch.cat([x_t, cond_c, sc], dim=1)
        if w != 1.0:
            net_u = torch.cat([x_t, cond_u, sc], dim=1)
            out2 = teacher(torch.cat([net_c, net_u], dim=0),
                           torch.cat([t_b, t_b], dim=0))
            return w * out2[:B] + (1.0 - w) * out2[B:]
        return teacher(net_c, t_b)

    def ddim_to(x0, eps, ab):
        return torch.sqrt(ab) * x0 + torch.sqrt(torch.clamp(1.0 - ab, min=0.0)) * eps

    def step(state: TrainState, teacher, batch: Dict[str, torch.Tensor],
             key: int):
        gen.manual_seed(key)
        clean = batch["clean"].float()
        noisy = batch["noisy"].float()
        sigma = batch["sigma"].float().reshape(-1, 1, 1)
        mask = batch["mask"].float()
        B, _, L = clean.shape

        clean_n = torch.clamp(clean / sigma, -clamp_inputs, clamp_inputs)
        y_n = torch.clamp(noisy / sigma, -clamp_inputs, clamp_inputs)
        meta_bc = _broadcast_meta(batch.get("meta"), L)
        cond_c = (torch.cat([y_n, meta_bc], dim=1)
                  if meta_bc is not None else y_n)
        # folded-CFG unconditional stack: y dropped, metadata kept
        cond_u = (torch.cat([torch.zeros_like(y_n), meta_bc], dim=1)
                  if meta_bc is not None else torch.zeros_like(y_n))
        sc = torch.zeros_like(clean_n)

        # per-item student segment j: from ladder[2j] to ladder[2j + 2]
        if "j_inject" in batch:
            j = batch["j_inject"].long()
        else:
            j = torch.randint(0, n_student, (B,), generator=gen, device=dev)
        t_in, t_mid = ts_d[2 * j], ts_d[2 * j + 1]
        ab_in = ab_d[2 * j].reshape(-1, 1, 1)
        ab_mid = ab_d[2 * j + 1].reshape(-1, 1, 1)
        ab_out = ab_d[2 * j + 2].reshape(-1, 1, 1)
        eps0 = (batch["eps0_inject"].float() if "eps0_inject" in batch
                else torch.randn(clean_n.shape, generator=gen, device=dev))
        x_t = torch.sqrt(ab_in) * clean_n + torch.sqrt(1.0 - ab_in) * eps0

        # teacher: two deterministic DDIM sub-steps, no gradient
        with record_function("distill/teacher_forward"):
            out1 = teacher_fwd(teacher, x_t, t_in, cond_c, cond_u, sc)
            x0_1, eps_1 = x0_eps(out1, x_t, ab_in)
            if x0_clip > 0:
                x0_1 = torch.clamp(x0_1, -x0_clip, x0_clip)
            x_mid = ddim_to(x0_1, eps_1, ab_mid)
            out2 = teacher_fwd(teacher, x_mid, t_mid, cond_c, cond_u, sc)
            x0_2, eps_2 = x0_eps(out2, x_mid, ab_mid)
            if x0_clip > 0:
                x0_2 = torch.clamp(x0_2, -x0_clip, x0_clip)
            x_out = ddim_to(x0_2, eps_2, ab_out)

            # one-step student target (exact DDIM inversion)
            sa_i = torch.sqrt(ab_in)
            sb_i = torch.sqrt(torch.clamp(1.0 - ab_in, min=0.0))
            sa_n = torch.sqrt(ab_out)
            sb_n = torch.sqrt(torch.clamp(1.0 - ab_out, min=0.0))
            denom = sa_n * sb_i - sb_n * sa_i        # > 0: ab_out > ab_in
            x0_tgt = ((sb_i * x_out - sb_n * x_t)
                      / torch.clamp(denom, min=1e-6)).detach()
            # truncated-SNR loss weight, zero on degenerate segments
            w_t = (torch.clamp(ab_in / torch.clamp(1.0 - ab_in, min=1e-6),
                               min=1.0) * valid_d[j].reshape(-1, 1, 1))

        with record_function("distill/student_forward"):
            out_s = model(torch.cat([x_t, cond_c, sc], dim=1), t_in)
            x0_s, _ = x0_eps(out_s, x_t, ab_in)
            se = (x0_s - x0_tgt) ** 2 * mask * w_t
            loss = se.sum() / torch.clamp(mask.sum(), min=1.0)
        flatp = state.params
        with record_function("distill/backward"):
            flatp.grad.zero_()
            loss.backward()
        loss = loss.detach()

        with record_function("distill/optimizer"):
            grad_norm = torch.linalg.vector_norm(flatp.grad)
            new_params, new_opt = optimizer.update(
                flatp.grad, state.opt_state, flatp.flat, grad_norm)
            ok = torch.isfinite(loss) & torch.isfinite(grad_norm)
            # the gate: a refused batch changes nothing
            if cfg.ema:
                d = cfg.ema_decay
                new_ema = d * state.ema_params + (1.0 - d) * new_params
                state.ema_params.copy_(
                    torch.where(ok, new_ema, state.ema_params))
            flatp.flat.copy_(torch.where(ok, new_params, flatp.flat))
            for old, new in zip(state.opt_state, new_opt):
                old.copy_(torch.where(ok, new, old))
            state.step.add_(ok.to(torch.int32))
        return {"loss": loss, "grad_norm": grad_norm, "ok": ok}

    return step


def _prepare(cfg: DistillConfig, ck: dict):
    """The teacher's training domain over ``cfg.data`` (.h5 or .npz)."""
    from ..data import pipeline as dpipe
    from ..data.hdf5io import compute_meta_scale

    meta_scale = compute_meta_scale(cfg.data)
    return dpipe.prepare_dataset(
        cfg.data,
        whiten=bool(ck.get("whiten", 0)),
        # the teacher's RESOLVED training domain, not its request
        whiten_mode=(str(ck["whiten_mode_resolved"])
                     if ck.get("whiten_mode_resolved")
                     in ("model", "welch", "train")
                     else str(ck.get("whiten_mode", "auto"))),
        sigma_mode=str(ck.get("sigma_mode", "std")),
        sigma_fixed=float(ck.get("sigma_fixed", 1.0)),
        include_metadata=bool(ck.get("meta_enabled", True)),
        mass_scale=float(ck.get("meta_scale", {}).get("M", 80.0)),
    )


def distill(cfg: DistillConfig, dataset=None, device=None) -> Dict[str, Any]:
    """Run the progressive-distillation stage chain on ``device`` (default:
    the GPU); returns {checkpoints, history, model, schedule, args}.

    The student inherits the teacher's architecture and domain contract
    (whiten/sigma/meta/pred_type); each stage halves the sampler steps.
    ``dataset``: a ready ``PreparedDataset``, else ``cfg.data`` is read."""
    from ..data import pipeline as dpipe
    from ..inference import load_model

    chain = list(cfg.steps_schedule)
    if len(chain) < 2:
        raise ValueError("steps_schedule needs >= 2 entries (teacher, "
                         "student, ...)")
    for a, b in zip(chain, chain[1:]):
        if a != 2 * b:
            raise ValueError(f"steps_schedule must halve: {a} -> {b}")

    dev = resolve_device(device)
    teacher, schedule, ck = load_model(cfg.teacher, use_ema=True, device=dev)
    student = copy.deepcopy(teacher)
    teacher_flat = FlatParams(teacher, dev)
    student_flat = FlatParams(student, dev)
    pred_type = str(ck.get("pred_type", "eps"))
    os.makedirs(cfg.model_dir, exist_ok=True)
    logger = JsonlLogger(cfg.log_jsonl)

    if dataset is None:
        dataset = _prepare(cfg, ck)
    n_batches = dpipe.num_batches(dataset, cfg.batch_size)
    dev_buckets = (dpipe.upload_buckets(dataset, dev)
                   if cfg.device_data else None)

    rng = np.random.default_rng(cfg.seed)
    key = key_from_seed(cfg.seed)
    history = []
    stage_paths = []
    for stage, (n_teach, n_stud) in enumerate(zip(chain, chain[1:]), 1):
        t_ladder = _teacher_ladder(schedule, n_stud, cfg.ladder, cfg.start_t)
        total = n_batches * cfg.epochs_per_stage
        optimizer = distill_optimizer(cfg, total)
        # student initialised FROM its teacher (paper Sec. 3)
        student_flat.flat.copy_(teacher_flat.flat)
        state = TrainState(
            params=student_flat,
            ema_params=teacher_flat.flat.clone(),
            opt_state=optimizer.init(student_flat.flat),
            step=torch.zeros((), dtype=torch.int32, device=dev))
        step_fn = make_distill_step(
            student, schedule, cfg, optimizer, t_ladder, pred_type,
            clamp_inputs=float(ck.get("clamp_inputs", 10.0)))

        print(f"[distill] stage {stage}: {n_teach} -> {n_stud} steps, "
              f"{cfg.epochs_per_stage} epochs x {n_batches} batches")
        for epoch in range(1, cfg.epochs_per_stage + 1):
            t0 = time.time()
            if dev_buckets is not None:
                batches = dpipe.device_resident_batches(
                    dataset, cfg.batch_size, rng, dev_buckets)
            else:
                batches = ({k: torch.from_numpy(v).to(dev)
                            for k, v in b.items() if k != "index"}
                           for b in dpipe.iterate_batches(
                               dataset, cfg.batch_size, rng))
            pending = []
            for jb in batches:
                key, k = split_key(key)
                pending.append(step_fn(state, teacher, jb, k))
            fetched = (torch.stack([torch.stack([m["loss"], m["ok"].float()])
                                    for m in pending]).cpu().numpy()
                       if pending else np.zeros((0, 2)))
            losses = [float(lo) for lo, ok in fetched if ok]
            avg = float(np.mean(losses)) if losses else float("nan")
            dt = time.time() - t0
            print(f"[distill] stage {stage} epoch {epoch}: loss={avg:.6f} "
                  f"({n_batches / max(dt, 1e-9):.1f} steps/s)")
            logger.log({"phase": "distill_epoch", "stage": stage,
                        "teacher_steps": n_teach, "student_steps": n_stud,
                        "epoch": epoch, "loss": avg,
                        "steps_per_sec": n_batches / max(dt, 1e-9)})
            history.append({"stage": stage, "epoch": epoch, "loss": avg})

        # the stage checkpoint with its deployment metadata
        args = dict(ck)
        args.update({
            "distilled_steps": n_stud,
            "distilled_cfg_scale": cfg.cfg_scale,
            "distilled_ladder": cfg.ladder,
            "distilled_start_t": cfg.start_t,
            "selfcond_mode": "zero",
            "distilled_from": cfg.teacher,
            "distill_stage": stage,
        })
        path = os.path.join(cfg.model_dir,
                            f"model_distilled_{n_stud}step.msgpack")
        save_checkpoint(
            path,
            model_state=student_flat.views(student_flat.flat),
            args=args,
            epoch=cfg.epochs_per_stage,
            model_ema_state=(student_flat.views(state.ema_params)
                             if cfg.ema else None),
            global_step=int(state.step),
        )
        stage_paths.append(path)
        print(f"[distill] stage {stage} saved -> {path}")
        # the EMA student becomes the next teacher
        teacher_flat.flat.copy_(state.ema_params if cfg.ema
                                else student_flat.flat)

    return {"checkpoints": stage_paths, "history": history,
            "model": student, "schedule": schedule, "args": ck}
