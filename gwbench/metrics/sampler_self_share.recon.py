"""Share (%) of the traced serving window's device time that the sampler
launches itself, outside the U-Net: the call's inputs, seed aggregation
and calibration, the ladder's start, and each step's network input, CFG
combination and update."""
from gwbench.metrics._spans import SAMPLER, share, under


def read(run):
    return share(run, under(SAMPLER))
