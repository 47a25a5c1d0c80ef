"""Profiler ranges at the served path's layer boundaries.

``with span(name):`` opens a ``torch.profiler.record_function`` range while a
profiler is recording, and otherwise is one shared no-op context.  The gate
is a read of the autograd profiler's flag: on an H100 machine's host a
span entered and left costs 0.2 us with the profiler off, where an
unrecorded ``record_function`` costs 10.5 us, and a pn128 serving call
opens about 5,000.  The ranges go to the profiler's own trace, on the clock
of its device events.

A serving call opens, from the outside in: ``serve/call`` (``serving.py``;
its ``args`` give rows, seeds and steps), ``serve/inputs``,
``serve/aggregate`` and ``serve/calibrate`` beside the sampler;
``sampler/start`` and one ``sampler/step`` a ladder step
(``ops/sampling.py``), a step holding ``sampler/net_in``, the U-Net's
``unet/forward``, ``sampler/guide`` and ``sampler/update``; inside the
forward (``models/unet.py``) ``unet/film``, ``unet/cond_bias``,
``unet/resample`` and ``unet/attn``, the stem and the head directly under
``unet/forward``.  No range opens inside an autograd backward.

``torch.export`` keeps none of these ranges, so an exported program's
replay carries only the ranges its caller opens.
"""
from __future__ import annotations

import contextlib
from typing import Optional

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

SPANS = (
    "serve/call", "serve/inputs", "serve/aggregate", "serve/calibrate",
    "sampler/start", "sampler/step", "sampler/net_in", "sampler/guide",
    "sampler/update",
    "unet/forward", "unet/film", "unet/cond_bias", "unet/resample",
    "unet/attn",
)

_OFF = contextlib.nullcontext()


def span(name: str, args: Optional[str] = None):
    """A context manager: the profiler range ``name`` (one of ``SPANS``)
    while a profiler records, else the shared no-op context."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name, args)
    return _OFF
