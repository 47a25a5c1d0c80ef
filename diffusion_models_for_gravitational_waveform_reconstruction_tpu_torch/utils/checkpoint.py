"""Checkpoint save / load in the JAX package's format (counterpart of its
``utils/checkpoint.py``).

A checkpoint is one flax-msgpack payload (``utils/msgpack.py``) with the keys
``model_state``, optional ``model_ema_state`` / ``optimizer_state`` /
``global_step`` / ``rng_key``, ``epoch`` and ``args_json`` (the architecture,
domain and sampler contract as JSON), plus a readable ``<path>.args.json``
sidecar.  :func:`average_checkpoints` makes a model soup of several.
Parameter trees are flax's nested layout, ``{"params": {"enc0":
{"conv": {"kernel": ...}}}}``: the port's ``UNet1D`` keeps flax's names and
layouts, so a ``state_dict`` nests by splitting its dotted names, and the JAX
package's ``load_checkpoint`` reads what this module writes.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from . import msgpack


def state_dict_to_flax(state_dict: Mapping[str, Any]) -> dict:
    """A flat ``state_dict`` -> ``{"params": nested}`` with numpy leaves
    (bfloat16 tensors stay tensors: numpy has no bfloat16)."""
    tree: Dict[str, Any] = {}
    for name, v in state_dict.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _to_host(v)
    return {"params": tree}


def _to_host(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v if v.dtype == torch.bfloat16 else v.numpy()
    return v


def _tree_to_host(node):
    """Host leaves; lists and tuples become maps keyed "0", "1", ..., as
    flax's ``to_state_dict`` writes them."""
    if isinstance(node, Mapping):
        return {k: _tree_to_host(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return {str(i): _tree_to_host(v) for i, v in enumerate(node)}
    return _to_host(node)


def save_checkpoint(
    path: str,
    model_state: Mapping[str, Any],
    args: Dict[str, Any],
    epoch: int,
    model_ema_state: Mapping[str, Any] = None,
    opt_state=None,
    global_step: int | None = None,
    rng_key=None,
) -> None:
    """Write the checkpoint to ``path``: ``model_state`` and
    ``model_ema_state`` are ``state_dict``s, ``opt_state`` a tree of
    dicts, lists, arrays and None in flax's state-dict form.  The payload
    goes to ``path + ".tmp"`` and is renamed over ``path``, so a reader
    never sees a partial file."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    payload = {
        "model_state": state_dict_to_flax(model_state),
        "epoch": int(epoch),
        "args_json": json.dumps(args, sort_keys=True, default=str),
    }
    if global_step is not None:
        payload["global_step"] = int(global_step)
    if rng_key is not None:
        payload["rng_key"] = np.asarray(_to_host(rng_key))
    if model_ema_state is not None:
        payload["model_ema_state"] = state_dict_to_flax(model_ema_state)
    if opt_state is not None:
        payload["optimizer_state"] = _tree_to_host(opt_state)
    blob = msgpack.packb(payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(blob)
    os.replace(tmp, path)
    with open(path + ".args.json", "w") as fh:
        json.dump(args, fh, indent=2, sort_keys=True, default=str)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload as a dict: ``model_state`` (nested), optional
    ``model_ema_state`` / ``optimizer_state``, ``epoch``, and ``args`` (the
    decoded ``args_json``).  Array leaves are read-only numpy views of the
    file's bytes."""
    with open(path, "rb") as fh:
        payload = msgpack.unpackb(fh.read())
    out = dict(payload)
    out["args"] = json.loads(out.pop("args_json"))
    return out


def select_weights(ckpt: Dict[str, Any], use_ema: bool = True):
    """EMA-preferred weight selection: (weights, used_ema)."""
    if use_ema and "model_ema_state" in ckpt:
        return ckpt["model_ema_state"], True
    return ckpt["model_state"], False


_ARCH_KEYS = ("base_ch", "in_ch", "cond_in_ch", "T", "schedule", "pred_type",
              "use_attention", "selfcond_mode")


def _structure(tree):
    if isinstance(tree, Mapping):
        return tuple(sorted((k, _structure(v)) for k, v in tree.items()))
    return None


def _weighted_mean_tree(trees, weights):
    """Leaf-wise weighted mean over structurally identical nested dicts,
    accumulated in float64 and cast back to the first tree's leaf dtype
    (a bfloat16 tensor leaf stays a bfloat16 tensor)."""
    if len({_structure(t) for t in trees}) != 1:
        raise ValueError("checkpoints have different parameter structures")
    w = np.asarray(weights, np.float64)
    w = w / w.sum()

    def f64(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().cpu().to(torch.float64).numpy()
        return np.asarray(leaf, np.float64)

    def avg(leaves):
        shapes = {tuple(np.shape(leaf)) for leaf in leaves}
        if len(shapes) != 1:
            raise ValueError(f"leaf shape mismatch across members: {shapes}")
        acc = sum(wi * f64(leaf) for wi, leaf in zip(w, leaves))
        if isinstance(leaves[0], torch.Tensor):
            return torch.from_numpy(acc).to(leaves[0].dtype)
        return acc.astype(np.asarray(leaves[0]).dtype)

    def walk(nodes):
        if isinstance(nodes[0], Mapping):
            return {k: walk([n[k] for n in nodes]) for k in nodes[0]}
        return avg(nodes)

    return walk(list(trees))


def average_checkpoints(paths, weights=None) -> Dict[str, Any]:
    """Uniform/weighted parameter averaging across checkpoints (a model
    soup, Wortsman et al. 2022).

    Averages ``model_state`` and, when ALL members carry one,
    ``model_ema_state``.  Members must share the architecture contract
    (validated on the load-bearing args keys) and the exact parameter tree.
    Returns a payload dict shaped like :func:`load_checkpoint` output, with
    ``args`` taken from the first member plus ``soup_members``/``soup_weights``
    provenance; epoch is the max member epoch.
    """
    if len(paths) < 2:
        raise ValueError("need at least 2 checkpoints to average")
    if weights is None:
        weights = [1.0] * len(paths)
    if len(weights) != len(paths):
        raise ValueError("len(weights) != len(paths)")
    cks = [load_checkpoint(p) for p in paths]
    a0 = cks[0]["args"]
    for p, ck in zip(paths[1:], cks[1:]):
        for k in _ARCH_KEYS:
            if ck["args"].get(k) != a0.get(k):
                raise ValueError(
                    f"{p}: args[{k!r}]={ck['args'].get(k)!r} differs from "
                    f"{paths[0]}: {a0.get(k)!r} — cannot average across "
                    f"architectures/domains")
    out: Dict[str, Any] = {
        "model_state": _weighted_mean_tree(
            [ck["model_state"] for ck in cks], weights),
        "epoch": max(int(ck.get("epoch", 0)) for ck in cks),
    }
    if all("model_ema_state" in ck for ck in cks):
        out["model_ema_state"] = _weighted_mean_tree(
            [ck["model_ema_state"] for ck in cks], weights)
    args = dict(a0)
    args["soup_members"] = [os.path.basename(p) for p in paths]
    args["soup_weights"] = [float(w) for w in weights]
    out["args"] = args
    return out
