"""``gw-soup``: average checkpoint weights into a single "model soup"
(counterpart of the JAX package's ``cli/soup.py``: the same flags, output
and refusals).

    python -m diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli.soup \\
        --inputs a.msgpack b.msgpack --output soup.msgpack

Parameter averaging across checkpoints of one run (or of runs fine-tuned
from a shared init) is a quality lever (Wortsman et al. 2022): members must
live in the same loss basin.  Distinct from ``gw-grid --model a,b``
ensembling, which averages member reconstructions at N x the sampling
cost; the soup averages weights once (float64, cast back to each leaf's
dtype).  The output is a standard checkpoint (msgpack + ``.args.json``
sidecar) carrying ``soup_members``/``soup_weights`` provenance, byte-equal
to the JAX package's soup of the same members.  Runs on the host only.
"""
import argparse
import sys

from ..utils.checkpoint import average_checkpoints, save_checkpoint


def _state_dict(tree):
    """``{"params": nested}`` -> dotted names, each leaf as it is (the
    averaged dtype kept), as :func:`save_checkpoint` takes it."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[f"{prefix}{k}"] = v

    walk(tree["params"], "")
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "gw-soup", description=__doc__.split("\n")[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--inputs", nargs="+", required=True,
                   help="2+ member checkpoints (.msgpack), same architecture.")
    p.add_argument("--output", required=True,
                   help="Path for the averaged checkpoint.")
    p.add_argument("--weights", type=float, nargs="+", default=None,
                   help="Per-member weights (normalised); default uniform.")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        payload = average_checkpoints(args.inputs, args.weights)
    except ValueError as e:
        print(f"[soup] ERROR: {e}", file=sys.stderr)
        return 2
    ema = payload.get("model_ema_state")
    save_checkpoint(
        args.output,
        _state_dict(payload["model_state"]),
        payload["args"],
        payload["epoch"],
        model_ema_state=None if ema is None else _state_dict(ema),
    )
    n = len(args.inputs)
    print(f"[soup] averaged {n} checkpoints -> {args.output} "
          f"(epoch={payload['epoch']}, ema={'model_ema_state' in payload})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
