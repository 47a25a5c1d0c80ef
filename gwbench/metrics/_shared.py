"""What the readers of the per-layer metrics share."""
from __future__ import annotations

from gwbench import arch, yardstick


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
    model, L, rows = cfg["model"], cfg["segment_len"], run["rows_per_forward"]
    per = yardstick.forward_bounds(model, L, rows)[cls]
    # a forward's launches of the class: its architecture's shapes of K1
    # or K2, one K1B or K2B launch for each
    per_launch = len(arch.of(model).kernel_shapes(model, L, rows)
                     .get(cls[:2], []))
    if per_launch == 0:
        raise ValueError(f"{launches_key} launched {n} times in a window of "
                         f"an architecture that lists no {cls[:2]} shapes")
    return 100.0 * (n / per_launch) * per / t


def idle(run):
    tr = run.get("trace")
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
