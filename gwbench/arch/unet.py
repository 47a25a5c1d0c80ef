"""The conditional 1D U-Net (the port's ``models/unet.py::UNet1D``): its
build, its frozen FLOP count and its kernels' launch shapes.

``unet_flops_per_sample`` is a copy of the port's
``utils/roofline.py::unet_flops_per_sample`` (conv, conditioning Dense and
attention FLOPs, a MAC counting 2; GroupNorm, SiLU, FiLM, resizes and the
time MLP left out) with the port's unfolded decoder.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .. import port

# depth sets the levels, and with them the channel widths: no key is cut
CUTTABLE: Tuple[str, ...] = ()

# the port's spans of ``UNet1D.forward``: the forward, and its parts that
# launch elementwise work beside K1 and K2
FORWARD = "unet/forward"
SPANS: Tuple[str, ...] = ("unet/film", "unet/cond_bias", "unet/resample",
                          "unet/attn")


def build(config: dict, params: Dict, device):
    """The port's ``UNet1D`` of the configuration with ``params`` copied
    in, for inference (no gradients)."""
    m = config["model"]
    model = port._m("models.unet").UNet1D(
        in_ch=m["in_ch"], base_ch=m["base_ch"], time_dim=m["time_dim"],
        depth=m["depth"], t_embed_max_time=m["t_embed_max_time"],
        cond_in_ch=m["cond_in_ch"], use_selfcond=m["use_selfcond"],
        use_attention=m["use_attention"], dtype=port.dtype_of(config),
        device=device)
    model.load_state_dict(params, strict=True)
    model.eval()
    for p in model.parameters():
        p.requires_grad_(False)
    return model


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


def flops_per_sample(model: dict, L: int) -> float:
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


def kernel_shapes(model: dict, L: int, rows: int) -> Dict[str, List[tuple]]:
    """One forward's K1 launches (a ConvBlock each) and K2 launch (the
    bottleneck attention, where there is one) at ``rows`` rows."""
    att = attention_shape(model, L, rows)
    return {"k1": [(rows, *s) for s in convblock_shapes(model, L)],
            "k2": [att] if att else []}
