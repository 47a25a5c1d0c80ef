"""Progressive-distillation CLI (``gw-distill``; counterpart of the JAX
package's ``cli/distill.py``: the same flags, defaults and checkpoints).

Chains halving stages teacher -> student (see ``training/distill.py``);
each stage checkpoint records its deployment contract (steps / ladder /
folded CFG / zero self-cond), so ``gw-infer`` and ``gw-grid`` pick the
right knobs themselves:

    python -m diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli.distill \\
        --teacher model.msgpack --data train.npz --model_dir distilled \\
        --steps-schedule 64,32,16,8,4 --epochs 4

``--data`` takes an HDF5 corpus (needs h5py) or its ``.npz`` twin.
``--device`` takes ``cuda`` (the default: the GPU, an error without one) or
``cpu``.  Under ``torchrun`` every process joins the group
(``multihost_init``) and runs the same chain on its own GPU, as JAX's
processes do; only rank 0 writes files.
"""
from __future__ import annotations

import argparse
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gw-distill",
        description="Progressive distillation to few-step samplers.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--teacher", type=str, required=True,
                   help="Teacher checkpoint (.msgpack or reference .pth).")
    p.add_argument("--data", type=str, required=True,
                   help="Training HDF5 or its .npz twin (same domain as "
                        "the teacher).")
    p.add_argument("--model_dir", type=str, default="distilled")
    p.add_argument("--steps-schedule", type=str, default="64,32,16,8,4",
                   help="Comma-separated halving chain; first entry is the "
                        "teacher's sampling steps.")
    p.add_argument("--epochs", type=int, default=4,
                   help="Epochs per stage.")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--clip_grad", type=float, default=1.0)
    p.add_argument("--cfg-scale", type=float, default=1.5,
                   help="Guidance weight folded into the student.")
    p.add_argument("--ladder", choices=["t", "lambda"], default="lambda")
    p.add_argument("--start-t", type=int, default=999,
                   help="Top of the distilled ladder (full-range noise "
                        "init; matches the measured best eval recipe).")
    p.add_argument("--no-ema", dest="ema", action="store_false", default=True)
    p.add_argument("--ema_decay", type=float, default=0.999)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no-device-data", dest="device_data",
                   action="store_false", default=True)
    p.add_argument("--log-jsonl", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="'cuda' (the default; an error without a GPU) or "
                        "'cpu' (the plain PyTorch path).")
    return p


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the stage chain; returns ``distill()``'s result."""
    args = build_parser().parse_args(argv)

    from ..parallel.mesh import multihost_init, rank0_writes
    from ..training.distill import DistillConfig, distill

    multihost_init(args.device)
    rank0_writes(args, "model_dir", "log_jsonl")
    chain = [int(x) for x in args.steps_schedule.split(",") if x]
    cfg = DistillConfig(
        teacher=args.teacher, data=args.data, model_dir=args.model_dir,
        steps_schedule=chain, epochs_per_stage=args.epochs,
        batch_size=args.batch_size, lr=args.lr,
        weight_decay=args.weight_decay, clip_grad=args.clip_grad,
        cfg_scale=args.cfg_scale, ladder=args.ladder, start_t=args.start_t,
        ema=args.ema, ema_decay=args.ema_decay, seed=args.seed,
        device_data=args.device_data, log_jsonl=args.log_jsonl)
    res = distill(cfg, device=args.device)
    print(f"[distill] done; checkpoints: {res['checkpoints']}")
    return res


if __name__ == "__main__":
    main()
