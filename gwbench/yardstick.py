"""The benchmark's fixed arithmetic: the card's published peaks, the
analytic U-Net FLOP count, and the operations and bytes of each hand-written
kernel (K1, K2, K1B, K2B) from its shapes.

Frozen here so that a change to the program cannot change the yardstick it
is measured with.  ``unet_flops_per_sample`` is a copy of the port's
``utils/roofline.py::unet_flops_per_sample`` (conv, conditioning Dense and
attention FLOPs, a MAC counting 2; GroupNorm, SiLU, FiLM, resizes and the
time MLP left out) with the port's unfolded decoder.  The kernels' counts
are those of the port's ``tools/bench_kernels.py`` rows: every input read
once, every output written once.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# bytes of one bf16 element: the configurations' compute dtype
ESIZE = 2


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the bf16 tensor-core peak and the bytes at the memory peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def unet_flops_per_sample(L: int, in_ch: int, base_ch: int, depth: int = 3,
                          cond_ch: int = 0, kernel: int = 3,
                          use_attention: bool = False) -> float:
    """Forward FLOPs of one U-Net application on one length-``L`` sample."""
    chs = [base_ch * (2 ** i) for i in range(depth)]
    f = 0.0
    c_in = in_ch
    for i, c in enumerate(chs):
        Li = L >> i
        f += Li * kernel * c_in * c * 2
        f += Li * cond_ch * c * 2
        c_in = c
    Lb = L >> depth
    f += Lb * kernel * chs[-1] * chs[-1] * 2
    f += Lb * cond_ch * chs[-1] * 2
    if use_attention:
        C = chs[-1]
        f += 4 * Lb * C * C * 2
        f += 2 * Lb * Lb * C * 2
    c_h = chs[-1]
    for i, c_s in enumerate(reversed(chs)):
        Ls = L >> (depth - 1 - i)
        f += Ls * kernel * (c_h + c_s) * c_s * 2
        f += Ls * cond_ch * c_s * 2
        c_h = c_s
    f += L * kernel * (chs[0] + 1) * 1 * 2
    return float(f)


def model_flops_per_sample(model: dict, L: int) -> float:
    """``unet_flops_per_sample`` of a configuration's ``model`` block."""
    return unet_flops_per_sample(L, model["in_ch"], model["base_ch"],
                                 model["depth"], cond_ch=model["cond_in_ch"],
                                 use_attention=model["use_attention"])


def convblock_shapes(model: dict, L: int) -> List[Tuple[int, int, int]]:
    """(L, Cin, Cout) of each ConvBlock of one forward, in launch order:
    the encoder, the bottleneck, the decoder (its input the upsampled h
    concatenated with the skip)."""
    d, base = model["depth"], model["base_ch"]
    chs = [base * (2 ** i) for i in range(d)]
    out, cin = [], model["in_ch"]
    for i, c in enumerate(chs):
        out.append((L >> i, cin, c))
        cin = c
    out.append((L >> d, chs[-1], chs[-1]))
    c_h = chs[-1]
    for i, c_s in enumerate(reversed(chs)):
        out.append((L >> (d - 1 - i), c_h + c_s, c_s))
        c_h = c_s
    return out


def attention_shape(model: dict, L: int, rows: int):
    """(B, H, L, D) of the bottleneck attention, or None without one:
    min(4, C // 32) heads, lowered until they divide C."""
    if not model["use_attention"]:
        return None
    C = model["base_ch"] * 2 ** (model["depth"] - 1)
    heads = max(1, min(4, C // 32 if C >= 32 else 1))
    while C % heads:
        heads -= 1
    return rows, heads, L >> model["depth"], C // heads


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
    """The least seconds of one forward's K1 launches and K2 launch, and of
    one backward's K1B and K2B launches, at ``rows`` rows."""
    k1 = sum(bound_s(*k1_cost(rows, l, ci, co))
             for l, ci, co in convblock_shapes(model, L))
    k1b = sum(bound_s(*k1b_cost(rows, l, ci, co))
              for l, ci, co in convblock_shapes(model, L))
    att = attention_shape(model, L, rows)
    k2 = bound_s(*k2_cost(*att)) if att else 0.0
    k2b = bound_s(*k2b_cost(*att)) if att else 0.0
    return {"k1": k1, "k2": k2, "k1b": k1b, "k2b": k2b}


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
