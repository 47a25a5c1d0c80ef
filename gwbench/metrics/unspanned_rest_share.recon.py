"""Share (%) of the traced serving window's device time that is of the
``rest`` class (outside K1, K2 and the matrix products) and launched
outside every leaf span of the served path: the U-Net's stem and head,
and any elementwise work that no span names yet.  None on a program
without the U-Net's span."""
from gwbench import yardstick
from gwbench.metrics._spans import LEAVES, share


def _seconds(tr):
    if "unet/forward" not in tr["range_s"]:
        return None
    return sum(s for name, inner, s, _ in tr["ops"]
               if inner not in LEAVES
               and yardstick.kernel_class(name, inner) == "rest")


def read(run):
    return share(run, _seconds)
