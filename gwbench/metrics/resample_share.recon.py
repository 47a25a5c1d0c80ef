"""Share (%) of the traced serving window's device time under the U-Net's
resampling: the encoder's average pooling, and the decoder's upsampling,
padding or cropping and skip concatenation."""
from gwbench.metrics._spans import share, under


def read(run):
    return share(run, under(["unet/resample"]))
