"""Each architecture a configuration can name, as the program side of the
benchmark builds and counts it: ``arch/<arch>.py`` beside its plain
reference ``reference/<arch>.py``, both found by the name in the
configuration's ``model`` block (``arch``; the U-Net where it names none).

An ``arch/<arch>.py`` holds

- ``build(config, params, device)``: the port's inference module with the
  benchmark's weights copied in, the port imported only through
  ``port._m``;
- ``flops_per_sample(model, L)``: the frozen analytic forward FLOPs of one
  row of length ``L`` that ``mfu.recon`` reads;
- ``kernel_shapes(model, L, rows)``: one forward's launches of each
  hand-written kernel class, a list of shapes a class (``"k1"``: (B, L,
  Cin, Cout); ``"k2"``: (B, H, L, D)); the backward launches one K1B or
  K2B for each;
- ``CUTTABLE``: the ``model`` keys that a configuration may list in
  ``reduced``: depth, or the chip's share of a layer, never a width;

and, where the port's forward of the architecture opens profiler spans
(the port's ``utils/spans.py::SPANS``),

- ``FORWARD``: the name of the span around one forward;
- ``SPANS``: the names of its leaf spans inside it, in the port's order.

A module that declares neither has no spans.
"""
from __future__ import annotations

import importlib
import re
from typing import List

from ..reference import arch_name

# key names of widths, which no configuration cuts: widths, sizes of
# channels, hidden, intermediate, latent, state or projection spaces, head
# sizes, expansion factors and ratios, experts per token
WIDTH = re.compile(r"(width|_ch|_dim|_rank|_size|hidden|intermediate|latent"
                   r"|state|proj|expan|ratio|per_tok)")


def of(model: dict):
    """``arch/<arch>.py`` of a configuration's ``model`` block."""
    return importlib.import_module(f"{__name__}.{arch_name(model)}")


def reduced_faults(entry: dict, data: dict) -> List[str]:
    """What a configuration breaks of the rule on ``reduced`` (``entry``:
    its line in ``BENCHMARK.json``; ``data``: its file), none where it
    keeps it: the two lists alike; each key a key of the ``model`` block
    that its architecture's ``CUTTABLE`` names and no width; the key's
    published value under ``published``, not the value run; and the
    deployment that the cut stands for under ``deployment``."""
    reduced, model = data.get("reduced", []), data["model"]
    faults = []
    if entry["reduced"] != reduced:
        faults.append(f"BENCHMARK.json lists {entry['reduced']}, the file "
                      f"{reduced}")
    cuttable = of(model).CUTTABLE
    published = data.get("published", {})
    for key in reduced:
        if WIDTH.search(key):
            faults.append(f"{key}: a width")
        if key not in cuttable:
            faults.append(f"{key}: not in {arch_name(model)}'s CUTTABLE "
                          f"{list(cuttable)}")
        if key not in model:
            faults.append(f"{key}: no key of the model block")
        if key not in published:
            faults.append(f"{key}: no published value")
        elif published[key] == model.get(key):
            faults.append(f"{key}: run at its published value")
    if reduced and not data.get("deployment"):
        faults.append("no deployment")
    return faults
