"""The window's analytic forward FLOPs (the architecture's count at every
row of every forward) over its seconds, as a share (%) of one card's bf16
peak."""
from gwbench import yardstick
from gwbench.metrics._shared import is_serving


def read(run):
    if not is_serving(run):
        return None
    cfg = run["config"]
    f = yardstick.model_flops_per_sample(cfg["model"], cfg["segment_len"])
    return 100.0 * f * run["forward_rows"] / run["window_s"] / (
        yardstick.PEAK_BF16_FLOPS * run["chips"])
