"""What the readers of the per-layer metrics share."""
from __future__ import annotations

from gwbench import yardstick


def is_serving(run) -> bool:
    return run["traffic"]["kind"] == "serve_batch"


def roofline(run, cls: str, launches_key: str):
    """The share (%) of the least time of the traced window's launches of
    one kernel (``cls``: k1, k2, k1b, k2b) in its device time: the launches
    counted by the program's counter, at the shapes of one forward (or one
    backward) at the cell's rows; None where the kernel did not run."""
    tr = run.get("trace")
    if not tr:
        return None
    t = yardstick.device_seconds(tr)[cls]
    n = tr["launches"].get(launches_key, 0)
    if t <= 0 or n <= 0:
        return None
    cfg = run["config"]
    model, L = cfg["model"], cfg["segment_len"]
    per = yardstick.forward_bounds(model, L, run["rows_per_forward"])[cls]
    per_launch = len(yardstick.convblock_shapes(model, L)) \
        if cls in ("k1", "k1b") else 1
    return 100.0 * (n / per_launch) * per / t


def idle(run):
    tr = run.get("trace")
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
