"""Share (%) of the traced serving window's device time under the U-Net's
bottleneck attention outside K2: GroupNorm, the qkv and output
projections' products, the head split copies and the residual add."""
from gwbench import yardstick
from gwbench.metrics._spans import share

SPAN = "unet/attn"


def _seconds(tr):
    if SPAN not in tr["range_s"]:
        return None
    k2 = sum(s for name, inner, s, _ in tr["ops"]
             if inner == SPAN and yardstick.kernel_class(name, inner) == "k2")
    return tr["range_s"][SPAN] - k2


def read(run):
    return share(run, _seconds)
