"""Weights shared with the JAX package.

The port's ``UNet1D`` keeps every parameter in flax layout under the flax
path (``enc0.conv.kernel`` is the (3, Cin, Cout) conv kernel,
``tproj_mid.kernel`` the (in, out) Dense kernel), so a flax parameter tree
maps onto its ``state_dict`` by flattening the names alone.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params': {...}}`` (or the inner dict) of numpy-convertible or
    tensor leaves -> a float32 ``state_dict`` for
    :class:`models.unet.UNet1D`."""
    if "params" in tree:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}{k}"
            if isinstance(v, Mapping):
                walk(v, name + ".")
            elif isinstance(v, torch.Tensor):
                out[name] = v.detach().to(torch.float32, copy=True)
            else:
                out[name] = torch.from_numpy(np.array(v, dtype=np.float32))

    walk(tree, "")
    return out


def randomize_(model: torch.nn.Module, seed: int) -> None:
    """Fill every parameter of ``model`` from a generator seeded with
    ``seed`` (the init leaves the final conv and the biases at zero):
    kernels N(0, 1/fan_in), GroupNorm scales 1 + N(0, 0.1^2), biases
    N(0, 0.1^2).  Random weights for timing and smoke runs."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            z = torch.randn(p.shape, generator=g)
            if name.endswith("kernel"):
                z = z / float(np.prod(p.shape[:-1])) ** 0.5
            elif name.endswith("scale"):
                z = 1.0 + 0.1 * z
            else:
                z = 0.1 * z
            p.copy_(z)
