"""What the port's registered torch ops share.

Each CUDA launch of the port is a ``torch.library.custom_op`` in one
namespace, so ``torch.export`` records it as one node of the exported graph
(its fake implementation gives the output's shape and dtype) and a replay of
that graph launches the kernel.  The ops define no backward yet: the
kernels' backward comes with training (``ROADMAP.md``, P8), and until then
a wrapper refuses a forward that autograd would record.
"""
from __future__ import annotations

import torch

NAMESPACE = "gwport"


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would record ``NAMESPACE::name`` on ``tensors``:
    the op has no backward, so its output would be cut off from them."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{NAMESPACE}::{name} has no backward on CUDA yet (the kernels' "
            f"backward comes with P8, training): run the forward under "
            f"torch.no_grad(), or on the CPU, whose plain version "
            f"backpropagates")
