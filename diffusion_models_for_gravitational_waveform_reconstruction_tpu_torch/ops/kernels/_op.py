"""What the port's registered torch ops share.

Each CUDA launch of the port is a ``torch.library.custom_op`` in one
namespace, so ``torch.export`` records it as one node of the exported graph
(its fake implementation gives the output's shape and dtype) and a replay of
that graph launches the kernel.  Each forward kernel's op carries a
backward registered with ``torch.library.register_autograd`` that calls the
op of its backward kernel (``conv_gn_silu_backward``,
``flash_attention_backward``), so a training step on the card launches a
hand-written kernel forward and backward; the plain backwards beside them
serve the CPU and the checks.
"""
from __future__ import annotations

NAMESPACE = "gwport"
