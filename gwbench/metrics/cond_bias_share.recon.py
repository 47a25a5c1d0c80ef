"""Share (%) of the traced serving window's device time under the U-Net's
conditioning bias: the conditioning resized to each stage's length, its
projection's product and the add."""
from gwbench.metrics._spans import share, under


def read(run):
    return share(run, under(["unet/cond_bias"]))
