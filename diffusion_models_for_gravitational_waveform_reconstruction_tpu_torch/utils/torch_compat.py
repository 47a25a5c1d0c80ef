"""Reference torch checkpoints (``.pth``) into the flax parameter layout
(counterpart of the JAX package's ``utils/torch_compat.py``).

Name mapping (reference ``UNet1D`` state_dict -> flax / port names):
    time_mlp.1            -> time_dense            (Linear: kernel = W^T)
    encoders.{i}.0 / .1   -> enc{i}/conv, enc{i}/norm (Conv1d (O,I,k)->(k,I,O))
    mid.0 / mid.1         -> mid/conv, mid/norm
    decoders.{i}.0 / .1   -> dec{i}/conv, dec{i}/norm
    final                 -> final
    tproj_enc.{i}.1, tproj_mid.1, tproj_dec.{i}.1 -> tproj_enc{i}, ...
    cond_enc.{i}, cond_mid, cond_dec.{i} (1x1 Conv1d) -> Dense
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _conv1d(w: np.ndarray) -> np.ndarray:
    """torch Conv1d weight (O, I, k) -> flax Conv kernel (k, I, O)."""
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


def _linear(w: np.ndarray) -> np.ndarray:
    """torch Linear weight (O, I) -> flax Dense kernel (I, O)."""
    return np.ascontiguousarray(w.T)


def torch_state_dict_to_flax(sd: Dict[str, np.ndarray], depth: int) -> dict:
    """A reference UNet1D ``state_dict`` (numpy leaves) ->
    ``{'params': {...}}`` in float32."""
    p: Dict[str, dict] = {}

    def put(mod: str, **leaves):
        p.setdefault(mod, {}).update(leaves)

    put("time_dense", kernel=_linear(sd["time_mlp.1.weight"]),
        bias=sd["time_mlp.1.bias"])

    for i in range(depth):
        p[f"enc{i}"] = {
            "conv": {"kernel": _conv1d(sd[f"encoders.{i}.0.weight"]),
                     "bias": sd[f"encoders.{i}.0.bias"]},
            "norm": {"scale": sd[f"encoders.{i}.1.weight"],
                     "bias": sd[f"encoders.{i}.1.bias"]},
        }
        p[f"dec{i}"] = {
            "conv": {"kernel": _conv1d(sd[f"decoders.{i}.0.weight"]),
                     "bias": sd[f"decoders.{i}.0.bias"]},
            "norm": {"scale": sd[f"decoders.{i}.1.weight"],
                     "bias": sd[f"decoders.{i}.1.bias"]},
        }
        put(f"tproj_enc{i}", kernel=_linear(sd[f"tproj_enc.{i}.1.weight"]),
            bias=sd[f"tproj_enc.{i}.1.bias"])
        put(f"tproj_dec{i}", kernel=_linear(sd[f"tproj_dec.{i}.1.weight"]),
            bias=sd[f"tproj_dec.{i}.1.bias"])
        if f"cond_enc.{i}.weight" in sd:
            put(f"cond_enc{i}", kernel=_linear(sd[f"cond_enc.{i}.weight"][:, :, 0]),
                bias=sd[f"cond_enc.{i}.bias"])
            put(f"cond_dec{i}", kernel=_linear(sd[f"cond_dec.{i}.weight"][:, :, 0]),
                bias=sd[f"cond_dec.{i}.bias"])

    p["mid"] = {
        "conv": {"kernel": _conv1d(sd["mid.0.weight"]),
                 "bias": sd["mid.0.bias"]},
        "norm": {"scale": sd["mid.1.weight"], "bias": sd["mid.1.bias"]},
    }
    put("tproj_mid", kernel=_linear(sd["tproj_mid.1.weight"]),
        bias=sd["tproj_mid.1.bias"])
    if "cond_mid.weight" in sd:
        put("cond_mid", kernel=_linear(sd["cond_mid.weight"][:, :, 0]),
            bias=sd["cond_mid.bias"])
    put("final", kernel=_conv1d(sd["final.weight"]), bias=sd["final.bias"])

    def _cast32(tree):
        # every leaf, nested ones too: a float64 / float16 .pth must not
        # leave a mixed-dtype tree
        if isinstance(tree, dict):
            return {k: _cast32(v) for k, v in tree.items()}
        return np.asarray(tree, np.float32)

    return {"params": _cast32(p)}


def load_torch_checkpoint_as_flax(pth_path: str, depth=None,
                                  use_ema: bool = True):
    """A reference ``.pth`` checkpoint: ``(weights, args, used_ema)``, the
    weights (EMA preferred) as ``{'params': {...}}``; ``depth`` defaults to
    the checkpoint's own (else 3)."""
    import torch

    payload = torch.load(pth_path, map_location="cpu", weights_only=False)
    args = dict(payload.get("args", {}))
    used_ema = use_ema and "model_ema_state" in payload
    sd = {k: v.detach().cpu().numpy() for k, v in payload[
        "model_ema_state" if used_ema else "model_state"].items()}
    if depth is None:
        depth = int(args.get("depth", 3))
    return torch_state_dict_to_flax(sd, depth), args, used_ema
