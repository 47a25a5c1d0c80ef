"""Timing entry point of the port: the twin of the root
``__graft_entry__.py``'s ``entry()``.

``entry()`` -> ``(denoise_step, example_args)``: one conditioned eps
prediction and the x0 conversion (the sampler's inner step) on the pn128
flagship (base_ch 128, depth 3, time_dim 128, y + 4 metadata channels and
the self-conditioning slot, bf16), batch 8 of 4096 samples, on the GPU, with
seeded random weights.  ``denoise_step(*example_args)`` returns x0_hat
(8, 1, 4096).

``dryrun_multichip(n, device=None)``, the twin of the root file's: n
processes joined in a gloo group (JAX forces n host devices) on a dp x tp
mesh, tp = 2 where it divides n (``dryrun 2`` is 1x2 tensor-parallel,
``dryrun 4`` 2x2), run one training step through ``train(mesh=)`` (the
blocks that JAX shards split over the model axis), ``reconstruct_batch``
and a tiled forward over the data axis, and the pod-serving artifact:
``export_sampler(dp=n)`` on rank 0, then ``load_exported`` and one call on
every rank, on tiny shapes.  The ranks run on the GPUs (several ranks
share a card: gloo, not NCCL, which refuses that) unless ``device="cpu"``
asks for the CPU; without a GPU the default raises.

    python -m diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.graft_entry
    python -m diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.graft_entry dryrun 2 [cpu]
"""
from __future__ import annotations

import os
import shutil
import socket
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .models.unet import UNet1D
from .ops.schedules import make_schedule
from .utils.device import resolve_device
from .utils.weights import randomize_


def entry(device=None):
    dev = resolve_device(device)
    in_ch, cond_in_ch = 7, 5
    B, L = 8, 4096
    model = UNet1D(in_ch=in_ch, base_ch=128, time_dim=128, depth=3,
                   t_embed_max_time=999.0, cond_in_ch=cond_in_ch,
                   use_selfcond=True, dtype=torch.bfloat16, device=dev).eval()
    randomize_(model, 1)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((B, in_ch, L), generator=g, device=dev)
    t = torch.zeros((B,), dtype=torch.int64, device=dev)
    alpha_bar = make_schedule(1000, "cosine").alpha_bar.to(dev)

    @torch.no_grad()
    def denoise_step(model, x, t):
        """One conditioned eps-prediction + x0 conversion."""
        eps_hat = model(x, t)
        ab = alpha_bar[t].reshape(-1, 1, 1)
        x_t = x[:, :1, :]
        return (x_t - torch.sqrt(1.0 - ab) * eps_hat) / torch.sqrt(ab)

    return denoise_step, (model, x, t)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run :func:`_dryrun_rank` in ``n_devices`` spawned processes on
    ``device``'s type (default the GPU); raises if any of them fails."""
    import torch.multiprocessing as mp

    dev_type = resolve_device(device).type
    mp.start_processes(_dryrun_rank, args=(n_devices, _free_port(), dev_type),
                       nprocs=n_devices, start_method="spawn")


def _dryrun_rank(rank: int, n: int, port: int, dev_type: str) -> None:
    from .data.pipeline import dataset_from_arrays
    from .inference import reconstruct_batch
    from .ops.sampling import SamplerConfig
    from .parallel.mesh import make_mesh
    from .parallel.seqtile import tiled_apply
    from .serving import export_sampler, load_exported
    from .training.train import TrainConfig, train

    dev = torch.device(dev_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank)
    # dp x tp, tp = 2 where it divides n (JAX's __graft_entry__ mesh)
    n_model = 2 if n % 2 == 0 and n >= 2 else 1
    n_data = n // n_model
    mesh = make_mesh(n_data=n_data, n_model=n_model)
    say = print if rank == 0 else (lambda *a: None)
    B, L = 2 * n_data, 256
    rng = np.random.default_rng(0)
    clean = rng.normal(size=(B, L)).astype(np.float32)
    noisy = clean + rng.normal(size=(B, L)).astype(np.float32)
    meta = rng.uniform(size=(B, 4)).astype(np.float32)
    ds = dataset_from_arrays(clean, noisy, fs=4096.0, meta=meta)
    # one directory for every rank: rank 0 writes the checkpoint and the
    # artifact there, every rank reads them
    box = [tempfile.mkdtemp(prefix="gw-dryrun-") if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    d = box[0]
    # one batch x one epoch: one step through the trainer (q_sample, CFG
    # dropout, self-conditioning, loss, the model axis's sum and the data
    # axis's mean of the gradient, clip, AdamW, EMA, the gate), full-range t
    cfg = TrainConfig(model_dir=d, epochs=1, batch_size=B, T=50,
                      base_ch=16, time_dim=16, depth=2, bf16=False,
                      ema=True, warmup_steps=2, clip_grad=1.0,
                      p_uncond=0.2, p_selfcond=0.5, tp=n_model,
                      t_min_frac=0.0)
    out = train(cfg, dataset=ds, mesh=mesh, device=dev)
    loss = float(out["history"][0]["avg_per_sample"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss in dryrun: {loss}")
    say(f"[dryrun_multichip] mesh=({n_data}x{n_model}) trainer step ok, "
        f"loss={loss:.4f}")

    # the EMA weights, as JAX samples its state's ema_params
    state, model = out["state"], out["model"]
    with torch.no_grad():
        state.params.flat.copy_(state.ema_params)
    model.eval()
    Bs = max(n_data, 2)
    cond = rng.normal(size=(Bs, out["cond_in_ch"], L)).astype(np.float32)
    scfg = SamplerConfig(steps=3, cfg_scale=1.5, use_selfcond=True,
                         pred_type="eps")
    with torch.no_grad():
        x0 = reconstruct_batch(model, out["schedule"], cond,
                               np.ones((Bs,), np.float32), scfg,
                               torch.Generator(dev).manual_seed(0),
                               mesh=mesh, device=dev)
    if not (np.isfinite(x0).all() and x0.shape == (Bs, L)):
        raise RuntimeError("data-parallel sampler: bad output")
    say(f"[dryrun_multichip] dp-sharded sampler ok ({Bs} samples, "
        f"3 DDIM steps)")

    Lt = 2048
    xt = torch.from_numpy(rng.normal(size=(1, out["in_ch"], Lt)).astype(
        np.float32)).to(dev)
    with torch.no_grad():
        yt = tiled_apply(model, xt, torch.zeros(1, dtype=torch.long,
                                                device=dev),
                         chunk=256, mesh=mesh)
    if not (bool(torch.isfinite(yt).all()) and yt.shape == (1, 1, Lt)):
        raise RuntimeError("tiled forward: bad output")
    say(f"[dryrun_multichip] sequence-parallel tiled forward ok "
        f"(L={Lt}, chunk=256)")

    # the pod-serving artifact: exported once, served by every rank
    art = os.path.join(d, "pod.pt2")
    if rank == 0:
        export_sampler(out["checkpoint"], art, batch=n, length=L,
                       device=dev, steps=3, avg_seeds=1, amp_calib="mf",
                       use_ema=False, dp=n)
    dist.barrier()
    call, _ = load_exported(art, device=dev)
    condp = rng.normal(size=(n, out["cond_in_ch"], L)).astype(np.float32)
    x0p = call(condp, np.ones(n, np.float32), 0)
    if not (bool(torch.isfinite(x0p).all()) and tuple(x0p.shape) == (n, L)):
        raise RuntimeError("pod-serving artifact: bad output")
    say(f"[dryrun_multichip] pod-serving artifact ok (dp={n}, "
        f"batch sharded over 'data')")
    dist.barrier()          # no rank leaves while another still talks
    if rank == 0:
        shutil.rmtree(d, ignore_errors=True)
    # the rank leaves without the interpreter's teardown, in which a gloo
    # process sometimes aborted ("terminate called without an active
    # exception")
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "dryrun":
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 2,
                         sys.argv[3] if len(sys.argv) > 3 else None)
    else:
        fn, args = entry()
        print("entry ok:", tuple(fn(*args).shape))
