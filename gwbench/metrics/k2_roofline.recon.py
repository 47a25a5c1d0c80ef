"""Share (%) of K2's (flash attention) least time (the larger of its
FLOPs at the bf16 peak and its bytes at the memory peak) in its device
time, over the traced window's forward launches."""
from gwbench.metrics._shared import is_serving, roofline


def read(run):
    return roofline(run, "k2", "flash_attention") if is_serving(run) else None
