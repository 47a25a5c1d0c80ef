"""Share (%) of the traced serving window's device time outside K1, K2 and
the matrix products: FiLM, casts, concatenation copies, the sampler's
arithmetic, the attention's GroupNorm."""
from gwbench import yardstick
from gwbench.metrics._shared import is_serving


def read(run):
    tr = run.get("trace")
    if not tr or not is_serving(run):
        return None
    s = yardstick.device_seconds(tr)
    total = sum(s.values())
    return 100.0 * s["rest"] / total if total > 0 else None
