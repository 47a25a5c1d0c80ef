"""Card peaks and the analytic U-Net FLOP count, for MFU accounting
(counterpart of the JAX package's ``utils/roofline.py``, without JAX).

``unet_flops_per_sample`` is the JAX package's closed form unchanged:
conv, conditioning-bias Dense and attention FLOPs (a MAC counts 2);
GroupNorm, SiLU, FiLM, resizes and the time MLP are left out.  The port has
no folded decoder, so its callers pass ``fast_decoder=False``: each decoder
ConvBlock convolves the concatenated (h, skip) input, as the port runs it.
"""
from __future__ import annotations

from typing import Optional, Tuple

# device name substring (``torch.cuda.get_device_name``) ->
# (peak dense bf16 FLOP/s, peak device-memory bytes/s); the H100 SXM's
# published figures (NVIDIA data sheet), at its 700 W limit
PEAKS = {
    "h100": (989e12, 3.35e12),
}


def peak_for(device_kind: str) -> Optional[Tuple[float, float]]:
    kind = device_kind.lower()
    for k, v in PEAKS.items():
        if k in kind:
            return v
    return None


def unet_flops_per_sample(
    L: int,
    in_ch: int,
    base_ch: int,
    depth: int = 3,
    cond_ch: int = 0,
    kernel: int = 3,
    fast_decoder: bool = True,
    use_attention: bool = False,
    attn_heads: int = 4,
) -> float:
    """Forward FLOPs of one ``UNet1D`` application on one length-``L``
    sample (conv + cond-bias Dense + attention)."""
    chs = [base_ch * (2 ** i) for i in range(depth)]
    f = 0.0
    # encoder
    c_in = in_ch
    for i, c in enumerate(chs):
        Li = L >> i
        f += Li * kernel * c_in * c * 2          # ConvBlock
        f += Li * cond_ch * c * 2                # cond_bias Dense
        c_in = c
    # bottleneck
    Lb = L >> depth
    f += Lb * kernel * chs[-1] * chs[-1] * 2
    f += Lb * cond_ch * chs[-1] * 2
    if use_attention:
        C = chs[-1]
        f += 4 * Lb * C * C * 2                  # qkv + out projections
        f += 2 * Lb * Lb * C * 2                 # scores + weighted sum
    # decoder (skip lengths L>>i for i = depth-1 .. 0)
    c_h = chs[-1]
    for i, c_s in enumerate(reversed(chs)):
        Ls = L >> (depth - 1 - i)
        if fast_decoder and kernel == 3:
            f += Ls * kernel * c_s * c_s * 2     # skip branch, k=3 at Ls
            f += Ls * 2 * c_h * c_s * 2          # h branch: 2 k=2 convs at Ls/2
        else:
            f += Ls * kernel * (c_h + c_s) * c_s * 2
        f += Ls * cond_ch * c_s * 2              # cond_bias Dense
        c_h = c_s
    # head: conv3 over [h, x_t]
    f += L * kernel * (chs[0] + 1) * 1 * 2
    return float(f)
