"""Share (%) of K1's (the fused ConvBlock) least time (the larger of its
FLOPs at the bf16 peak and its bytes at the memory peak) in its device
time, over the traced window's forward launches."""
from gwbench.metrics._shared import is_serving, roofline


def read(run):
    return roofline(run, "k1", "conv_gn_silu") if is_serving(run) else None
