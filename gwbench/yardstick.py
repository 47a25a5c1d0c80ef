"""The benchmark's fixed arithmetic: the card's published peaks, the
operations and bytes of each hand-written kernel (K1, K2, K1B, K2B) from
its shapes, and the bounds of a forward's launches; the analytic FLOP
count of a model and the shapes of its launches are its architecture's
(``arch/<arch>.py``).

Frozen here so that a change to the program cannot change the yardstick it
is measured with.  The kernels' counts are those of the port's
``tools/bench_kernels.py`` rows: every input read once, every output
written once.
"""
from __future__ import annotations

from typing import Dict, Tuple

from . import arch

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# bytes of one bf16 element: the configurations' compute dtype
ESIZE = 2


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the bf16 tensor-core peak and the bytes at the memory peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def model_flops_per_sample(model: dict, L: int) -> float:
    """The analytic forward FLOPs of one row of a configuration's ``model``
    block: its architecture's ``flops_per_sample``."""
    return arch.of(model).flops_per_sample(model, L)


def k1_cost(B: int, L: int, Cin: int, Cout: int) -> Tuple[float, float]:
    """K1 (conv k=3 + GroupNorm + SiLU): FLOPs and bytes (x, the f32
    weights and three f32 vectors read, y written)."""
    e = ESIZE
    flops = 2.0 * B * L * 3 * Cin * Cout
    nbytes = B * L * Cin * e + 3 * Cin * Cout * 4 + 3 * Cout * 4 \
        + B * L * Cout * e
    return flops, float(nbytes)


def k1b_cost(B: int, L: int, Cin: int, Cout: int) -> Tuple[float, float]:
    """K1B: the recompute, dx and dW products; x and dout read, dx written,
    the parameters read and their gradients written."""
    e = ESIZE
    flops = 3 * 2.0 * B * L * 3 * Cin * Cout
    nbytes = 2 * B * L * Cin * e + B * L * Cout * e \
        + 2 * (3 * Cin * Cout + 3 * Cout) * 4
    return flops, float(nbytes)


def k2_cost(B: int, H: int, L: int, D: int) -> Tuple[float, float]:
    """K2 (attention): Q K^T and P V; q, k, v read, the output written."""
    return 4.0 * B * H * L * L * D, float(4 * B * H * L * D * ESIZE)


def k2b_cost(B: int, H: int, L: int, D: int) -> Tuple[float, float]:
    """K2B: five products (S recomputed, dP, dV, dK, dQ); q, k, v, the
    output and dout read, dq, dk, dv written."""
    return 10.0 * B * H * L * L * D, float(8 * B * H * L * D * ESIZE)


def forward_bounds(model: dict, L: int, rows: int) -> Dict[str, float]:
    """The least seconds of one forward's K1 launches and K2 launches, and
    of one backward's K1B and K2B launches, at ``rows`` rows, at the shapes
    that the architecture's ``kernel_shapes`` gives."""
    shapes = arch.of(model).kernel_shapes(model, L, rows)
    k1, k2 = shapes.get("k1", []), shapes.get("k2", [])
    return {"k1": sum((bound_s(*k1_cost(*s)) for s in k1), 0.0),
            "k2": sum((bound_s(*k2_cost(*s)) for s in k2), 0.0),
            "k1b": sum((bound_s(*k1b_cost(*s)) for s in k1), 0.0),
            "k2b": sum((bound_s(*k2b_cost(*s)) for s in k2), 0.0)}


# the program's kernel names: K1's passes (its weight pack, its conv on any
# route, the group statistics, normalise + affine + SiLU), K2's forward;
# K1B and K2B are every kernel launched inside their ops' profiler ranges
K1_KERNELS = ("pack_weights", "conv3_", "group_stats", "gn_affine_silu")
K2_KERNELS = ("flash_fwd",)
K1B_RANGE = "gwport::conv_gn_silu_backward"
K2B_RANGE = "gwport::flash_attention_backward"
MATMUL_KERNELS = ("gemm", "nvjet", "xmma", "cutlass")


def kernel_class(name: str, inner_range: str) -> str:
    """``k1``, ``k2``, ``k1b``, ``k2b``, ``matmul`` or ``rest`` of a device
    operation by its name and the innermost profiler range it was launched
    in."""
    if inner_range == K1B_RANGE:
        return "k1b"
    if inner_range == K2B_RANGE:
        return "k2b"
    if any(k in name for k in K1_KERNELS):
        return "k1"
    if any(k in name for k in K2_KERNELS):
        return "k2"
    if any(k in name.lower() for k in MATMUL_KERNELS):
        return "matmul"
    return "rest"


def device_seconds(trace: dict) -> dict:
    """A traced window's device seconds by kernel class."""
    out = dict.fromkeys(("k1", "k2", "k1b", "k2b", "matmul", "rest"), 0.0)
    for name, inner, s, _ in trace["ops"]:
        out[kernel_class(name, inner)] += s
    return out
