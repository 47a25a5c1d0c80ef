"""Share (%) of the traced window in which no kernel, copy or memset ran
on the card (the mean over the cards used)."""
from gwbench.metrics._shared import is_serving, idle


def read(run):
    return idle(run) if is_serving(run) else None
