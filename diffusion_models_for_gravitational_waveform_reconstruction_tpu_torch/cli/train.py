"""``gw-train``: train the conditional DDPM denoiser (counterpart of the JAX
package's ``cli/train.py``: the same flags and defaults, and
``config_from_args`` gives the same ``TrainConfig``).

    python -m diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli.train \\
        --data synth:64 --epochs 5 --pred_type v --t_min_frac 0

``--device`` takes ``cuda`` (the default: the GPU, an error without one) or
``cpu``.  ``--num_workers`` and ``--amp`` are accepted and change nothing
(bf16 activations are the default; ``--no-bf16`` turns them off).
``--data synth:N`` synthesises N samples on the device; any other ``--data``
is an HDF5 corpus, which needs h5py, or its ``.npz`` twin (either form).
``--streaming`` reads it a chunk of ``--stream-chunk`` samples at a time;
``--tp`` > 1 is not ported and raises.

Data parallelism runs one process per GPU:

    torchrun --nproc-per-node N -m \
        diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli.train ...

Each process joins the NCCL group, takes its rows of every global batch and
averages the gradient with the others; only rank 0 writes the checkpoint
and the logs.  One process that sees several GPUs with data parallelism on
raises and names this command (``--no-data-parallel`` trains on one).
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from ..training.train import TrainConfig, train


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gw-train", description="Train the conditional DDPM denoiser.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--data", type=str, required=True,
                   help=".h5 file or directory (most recent .h5 wins), or "
                        "synth:N.")
    p.add_argument("--model_dir", type=str, default="model")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--T", type=int, default=1000)
    p.add_argument("--base_ch", type=int, default=64)
    p.add_argument("--time_dim", type=int, default=128)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--schedule", choices=["cosine", "linear"], default="cosine")
    p.add_argument("--use-attention", action="store_true",
                   help="Bottleneck self-attention.")
    p.add_argument("--seed", type=int, default=42)

    p.add_argument("--device", type=str, default=None,
                   help="cuda or cpu; default: the GPU.")
    p.add_argument("--num_workers", type=int, default=0, help="(ignored)")
    p.add_argument("--amp", action="store_true",
                   help="bf16 activations (default on — use --no-bf16 to "
                        "disable)")
    p.add_argument("--no-bf16", action="store_true")

    p.add_argument("--p_uncond", type=float, default=0.2)
    p.add_argument("--p_selfcond", type=float, default=0.5)
    p.add_argument("--t_min_frac", type=float, default=0.5,
                   help="Train only on t >= frac*T (full-range DDIM sampling "
                        "from noise requires 0.0).")
    p.add_argument("--force_cond_epochs", type=int, default=0)
    p.add_argument("--dropout_y_only", type=int, default=1)
    p.add_argument("--t_cover", choices=["rand", "strat"], default="rand")
    p.add_argument("--t_bins", type=int, default=0)
    p.add_argument("--t_multi", type=int, default=1)
    p.add_argument("--pred_type", choices=["eps", "v"], default="eps",
                   help="Training parametrisation: eps or v.")
    p.add_argument("--loss", choices=["huber", "mse"], default="huber")
    p.add_argument("--huber_beta", type=float, default=0.5)
    p.add_argument("--clip_grad", type=float, default=1.0)
    p.add_argument("--clamp_inputs", type=float, default=10.0)
    p.add_argument("--skip_bad_batches", type=int, default=1)
    p.add_argument("--skip_loss_threshold", type=float, default=50.0)
    p.add_argument("--loss_weight_power", type=float, default=0.0)
    p.add_argument("--ema", type=int, default=1)
    p.add_argument("--ema_decay", type=float, default=0.999)
    p.add_argument("--warmup_steps", type=int, default=1000)
    p.add_argument("--cosine_decay", type=int, default=1)
    p.add_argument("--min_lr_scale", type=float, default=0.1)
    p.add_argument("--whiten", type=int, default=0)
    p.add_argument("--streaming", action="store_true",
                   help="Lazy chunked loading of the HDF5 corpus or its "
                        ".npz twin (corpora larger than host memory).")
    p.add_argument("--no-device-data", action="store_true",
                   help="Keep the dataset on the host and copy each batch "
                        "to the device.")
    p.add_argument("--stream-chunk", type=int, default=512,
                   help="Samples prepared per streaming chunk.")
    p.add_argument("--whiten_mode", choices=["auto", "model", "welch", "train"],
                   default="auto")
    p.add_argument("--sigma_mode", choices=["std", "mad", "fixed"], default="std")
    p.add_argument("--sigma_fixed", type=float, default=1.0)
    p.add_argument("--init-from", type=str, default=None)
    p.add_argument("--resume", type=str, default=None,
                   help="Full-state resume (params/EMA/optimizer/epoch) from "
                        "a checkpoint of either package.")
    p.add_argument("--save-every-epochs", type=int, default=0,
                   help="Periodic checkpoints (0 = final only).")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="Write a torch.profiler trace of a few train steps.")
    p.add_argument("--log-jsonl", type=str, default=None)
    p.add_argument("--probe-cond", action="store_true")
    p.add_argument("--probe-t", type=int, nargs="+",
                   default=[24, 50, 200, 500, 800])
    p.add_argument("--probe-interval", type=int, default=50)
    p.add_argument("--debug_first", action="store_true")
    p.add_argument("--debug_first_every", type=int, default=0)
    p.add_argument("--tp", type=int, default=1,
                   help="Tensor-parallel size (> 1 not ported: raises).")
    p.add_argument("--no-data-parallel", action="store_true",
                   help="No batch sharding over devices.")
    p.add_argument("--remat", action="store_true",
                   help="Recompute the forward in the backward "
                        "(activation memory relief).")
    p.add_argument("--max-len", type=int, default=0,
                   help="LEFT-truncate samples longer than this (the merger "
                        "at the right end is kept). 0 = off.")
    return p


def config_from_args(args) -> TrainConfig:
    return TrainConfig(
        data=args.data, model_dir=args.model_dir, epochs=args.epochs,
        batch_size=args.batch_size, lr=args.lr,
        weight_decay=args.weight_decay, T=args.T, base_ch=args.base_ch,
        time_dim=args.time_dim, depth=args.depth, seed=args.seed,
        schedule=args.schedule, use_attention=args.use_attention,
        p_uncond=args.p_uncond, p_selfcond=args.p_selfcond,
        t_min_frac=args.t_min_frac, force_cond_epochs=args.force_cond_epochs,
        dropout_y_only=bool(args.dropout_y_only), t_cover=args.t_cover,
        t_bins=args.t_bins, t_multi=args.t_multi, loss=args.loss,
        pred_type=args.pred_type,
        huber_beta=args.huber_beta, clip_grad=args.clip_grad,
        clamp_inputs=args.clamp_inputs,
        skip_bad_batches=bool(args.skip_bad_batches),
        skip_loss_threshold=args.skip_loss_threshold,
        loss_weight_power=args.loss_weight_power, ema=bool(args.ema),
        ema_decay=args.ema_decay, warmup_steps=args.warmup_steps,
        cosine_decay=bool(args.cosine_decay), min_lr_scale=args.min_lr_scale,
        whiten=bool(args.whiten), whiten_mode=args.whiten_mode,
        sigma_mode=args.sigma_mode, sigma_fixed=args.sigma_fixed,
        bf16=not args.no_bf16, data_parallel=not args.no_data_parallel,
        remat=args.remat,
        log_jsonl=args.log_jsonl, probe_cond=args.probe_cond,
        probe_t=tuple(args.probe_t), probe_interval=args.probe_interval,
        debug_first=args.debug_first, debug_first_every=args.debug_first_every,
        init_from=args.init_from, save_every_epochs=args.save_every_epochs,
        resume=args.resume, profile_dir=args.profile_dir,
        streaming=args.streaming, stream_chunk=args.stream_chunk,
        max_len=args.max_len,
        device_data=not args.no_device_data,
        tp=args.tp,
    )


def main(argv: Optional[List[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    return train(config_from_args(args), device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
