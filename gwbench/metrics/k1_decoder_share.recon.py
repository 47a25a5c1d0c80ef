"""Share (%) of the traced window's launches of K1 (the fused ConvBlock)
that took K1's decoder route, reading the half-length h and the skip as two
sources: the program's counters ``conv_gn_silu_decoder`` over
``conv_gn_silu`` (``launch_counts()``); None where the program keeps no
such counter or K1 did not run."""
from gwbench.metrics._shared import is_serving


def read(run):
    tr = run.get("trace")
    if not tr or not is_serving(run):
        return None
    k1 = tr["launches"].get("conv_gn_silu", 0)
    decoder = tr["launches"].get("conv_gn_silu_decoder")
    if decoder is None or k1 <= 0:
        return None
    return 100.0 * decoder / k1
