"""What the readers of the program's spans share: the leaf spans of the
served path, each a share (%) of the traced window's device seconds (the
base of ``elementwise_share.recon``: every class of
``yardstick.device_seconds``).

The names are the program's (``utils/spans.py::SPANS`` of the port),
copied into the benchmark so that it imports nothing of the program: the
sampler's here, a forward's in its architecture's ``arch/<arch>.py``."""
from __future__ import annotations

from gwbench import yardstick
from gwbench.arch import unet
from gwbench.metrics._shared import is_serving

# the sampler's own work: the call's inputs, seed aggregation and
# calibration; the ladder's start; each step's network input, CFG
# combination and update
SAMPLER = ("serve/inputs", "serve/aggregate", "serve/calibrate",
           "sampler/start", "sampler/net_in", "sampler/guide",
           "sampler/update")
# the U-Net's parts that launch elementwise work beside K1 and K2, as its
# architecture declares them
UNET = unet.SPANS
LEAVES = SAMPLER + UNET


def share(run, seconds):
    """``seconds(trace)`` as a share (%) of the traced window's device
    seconds; None without a trace, outside a serving cell, where
    ``seconds`` gives None (the spans are not in the trace) or where the
    window has no device time."""
    tr = run.get("trace")
    if not tr or not is_serving(run):
        return None
    s = seconds(tr)
    total = sum(yardstick.device_seconds(tr).values())
    if s is None or total <= 0:
        return None
    return 100.0 * s / total


def under(names):
    """Device seconds launched inside any of ``names``, at any depth; None
    where none of them is in the trace."""
    def seconds(tr):
        found = [tr["range_s"][n] for n in names if n in tr["range_s"]]
        return sum(found) if found else None
    return seconds
