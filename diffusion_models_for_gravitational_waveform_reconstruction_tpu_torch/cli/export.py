"""``gw-export``: a checkpoint's deployment sampler as a serving artifact
(a ``torch.export`` program, ``.pt2``, and its JSON sidecar).

Counterpart of the JAX package's ``cli/export.py``, with the same flags
except two: ``--device`` (default: the GPU) names the device the program is
traced for and served on, in place of ``--platforms``, and ``--dp`` above 1
raises (P10).  The artifact holds the weights and the whole recipe (ladder,
CFG, self-conditioning, seed averaging, sigma rescale, MF amplitude
calibration); a CUDA artifact launches the port's kernels through their
registered ops.  Sampler knobs left unset resolve from the checkpoint as in
``gw-infer``.

    python -m diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli.export \\
        --model ck.msgpack --output sampler.pt2 [--device cpu] [--validate]
"""
import argparse
import sys

from ..serving import export_sampler, validate_export


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "gw-export", description=__doc__.split("\n")[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--model", required=True, help="Checkpoint (.msgpack/.pth)")
    p.add_argument("--output", required=True,
                   help="Artifact path (writes OUTPUT and OUTPUT.json)")
    p.add_argument("--batch-size", type=int, default=64,
                   help="Static serving batch size")
    p.add_argument("--length", type=int, default=4096,
                   help="Static segment length (samples)")
    p.add_argument("--device", default=None,
                   help="Device the artifact is traced for and served on "
                        "(default: the GPU; 'cpu' traces the plain versions)")
    p.add_argument("--sampler", default="ddim",
                   choices=["ddim", "ddpm", "dpmpp"])
    p.add_argument("--steps", type=int, default=None,
                   help="None = checkpoint contract / reference default")
    p.add_argument("--ladder", default=None, choices=["t", "lambda"])
    p.add_argument("--cfg-scale", type=float, default=None)
    p.add_argument("--start-t", type=int, default=None,
                   help="None = top of chain (T-1; serving samples from noise)")
    p.add_argument("--eta", type=float, default=0.0)
    p.add_argument("--avg-seeds", type=int, default=8)
    p.add_argument("--avg-mode", default="mean",
                   choices=["mean", "median", "mf"])
    p.add_argument("--amp-calib", default="mf", choices=["none", "mf"])
    p.add_argument("--no-ema", action="store_true",
                   help="Export raw (non-EMA) weights")
    p.add_argument("--dp", type=int, default=1,
                   help="Cards to shard the batch over: only 1 is ported")
    p.add_argument("--validate", action="store_true",
                   help="Load and replay the artifact on random inputs "
                        "after the export")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    contract = export_sampler(
        args.model, args.output,
        batch=args.batch_size, length=args.length, device=args.device,
        sampler=args.sampler, steps=args.steps, ladder=args.ladder,
        cfg_scale=args.cfg_scale, start_t=args.start_t, eta=args.eta,
        avg_seeds=args.avg_seeds, avg_mode=args.avg_mode,
        amp_calib=args.amp_calib, use_ema=not args.no_ema, dp=args.dp)
    k = contract["knobs"]
    print(f"[export] {args.output}: {contract['artifact_bytes'] / 1e6:.1f} MB"
          f", platforms={contract['platforms']}, dp={contract['dp']}"
          f", sampler={k['sampler']}"
          f"@{k['steps']} ladder={k['ladder']} avg_seeds={k['avg_seeds']}"
          f" amp_calib={k['amp_calib']}")
    if args.validate:
        peak = validate_export(args.output, device=contract["platforms"][0])
        print(f"[export] validate OK (max|x0_white| = {peak:.4g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
