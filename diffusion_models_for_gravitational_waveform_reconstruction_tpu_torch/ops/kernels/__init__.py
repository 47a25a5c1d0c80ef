"""Hand-written Hopper kernels of the port, each beside its plain version:
K1 (the fused ConvBlock) and K2 (flash attention), and their backwards K1B
and K2B.

Each wrapper carries a plain integer ``launches`` that its registered op
raises by one each time it launches the kernel (never for the plain
version), so a replay of an exported program counts too.  K1's wrapper
carries ``epilogue_launches`` and ``decoder_launches`` besides: its
launches with the conditioning epilogue and those on the decoder route,
which count under ``conv_gn_silu`` too.
"""
from .conv_gn_silu import (
    conv3_same,
    conv_route,
    decoder_conv_passes,
    decoder_input,
    epilogue,
    fix_len,
    fused_conv_gn_silu,
    fused_conv_gn_silu_backward,
    fused_conv_gn_silu_grad,
    fused_conv_gn_silu_reference,
    group_norm,
    pack_decoder_weights_reference,
    pack_weights_reference,
    takes_decoder_route,
)
from .flash_attention import (
    attention_route,
    flash_attention,
    flash_attention_backward,
    flash_attention_grad,
    flash_attention_reference,
)

# counter -> (the wrapper that carries it, its attribute)
_COUNTERS = {"conv_gn_silu": (fused_conv_gn_silu, "launches"),
             "flash_attention": (flash_attention, "launches"),
             "conv_gn_silu_backward": (fused_conv_gn_silu_grad, "launches"),
             "flash_attention_backward": (flash_attention_grad, "launches"),
             "conv_gn_silu_epilogue": (fused_conv_gn_silu,
                                       "epilogue_launches"),
             "conv_gn_silu_decoder": (fused_conv_gn_silu,
                                      "decoder_launches")}


def reset_launch_counts() -> None:
    for fn, attr in _COUNTERS.values():
        setattr(fn, attr, 0)


def launch_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _COUNTERS.items()}


__all__ = ["attention_route", "conv3_same", "conv_route",
           "decoder_conv_passes", "decoder_input", "epilogue", "fix_len",
           "flash_attention", "flash_attention_backward",
           "flash_attention_grad", "flash_attention_reference",
           "fused_conv_gn_silu", "fused_conv_gn_silu_backward",
           "fused_conv_gn_silu_grad", "fused_conv_gn_silu_reference",
           "group_norm", "launch_counts", "pack_decoder_weights_reference",
           "pack_weights_reference", "reset_launch_counts",
           "takes_decoder_route"]
