"""What the port's registered torch ops share.

Each CUDA launch of the port is a ``torch.library.custom_op`` in one
namespace, so ``torch.export`` records it as one node of the exported graph
(its fake implementation gives the output's shape and dtype) and a replay of
that graph launches the kernel.  Each kernel's op carries a backward
registered with ``torch.library.register_autograd``: the plain PyTorch
gradient of the kernel's plain version, written beside it in the kernel's
module.  A forward that autograd records therefore still launches the
kernel; only the backward runs plain.
"""
from __future__ import annotations

NAMESPACE = "gwport"
