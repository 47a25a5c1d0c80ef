"""Share (%) of the traced serving window's device time under the U-Net's
FiLM, ``h * (1 + gamma) + beta``, its time projections' products
included."""
from gwbench.metrics._spans import share, under


def read(run):
    return share(run, under(["unet/film"]))
