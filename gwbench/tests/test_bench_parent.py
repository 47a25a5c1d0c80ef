"""The U-Net cells read what they read at commit 96bca5c, the tree before
architectures were looked up by name: the tiny cell's weights, inputs,
program answers and reference answers, bit for bit, and the flagships'
FLOP counts and kernel bounds.  The checksums and values were read from
that tree's ``gwbench/`` on the CPU (the same at 1 and 4 threads)."""
import hashlib
import json

import pytest
import torch

from gwbench import cell, inputs, yardstick
from gwbench.drivers import serve_batch
from gwbench.tests import tiny

# dtype -> sha256 (first 16 hex digits) of the weights, the measurement
# pool (cond, sigma), the program's and the reference's answers to call 0,
# and that call's rel_err
PARENT = {
    "float32": ("d6298978e2c05639", "255a150e037832fd", "926f826095bba572",
                "d88d3a43fb43b4e3", 3.1178342820361724e-07),
    "bfloat16": ("d6298978e2c05639", "255a150e037832fd", "c3c4bf3fbcf98dd4",
                 "d88d3a43fb43b4e3", 0.01154070917961781),
}
# (config, rows) -> forward FLOPs of a row, and the bounds of one forward's
# (and one backward's) launches in seconds
PARENT_COUNTS = {
    ("pn128", 128): (8917639168.0, {
        "k1": 0.0012009432800161779, "k2": 0.0,
        "k1b": 0.0034839024649349413, "k2b": 0.0}),
    ("pn128", 64): (8917639168.0, {
        "k1": 0.0006006208841871935, "k2": 0.0,
        "k1b": 0.0017419549005271721, "k2b": 0.0}),
    ("attn16k", 64): (37281267712.0, {
        "k1": 0.0014918232518829513, "k2": 0.0011117407763154702,
        "k1b": 0.003633073909302265, "k2b": 0.0027793519407886755}),
    ("attn16k", 32): (37281267712.0, {
        "k1": 0.0007460969775832666, "k2": 0.0005558703881577351,
        "k1b": 0.0018166128376362074, "k2b": 0.0013896759703943377}),
    ("attn16k", 16): (37281267712.0, {
        "k1": 0.0003732338404334244, "k2": 0.00027793519407886755,
        "k1b": 0.0009083823018031783, "k2b": 0.0006948379851971689}),
}
CONFIGS = {c["name"]: json.loads((cell.ROOT / c["file"]).read_text())
           for c in cell.benchmark()["configs"]}


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(torch.as_tensor(t).detach().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("dtype", sorted(PARENT))
def test_tiny_cell_draws_and_answers_as_the_parent(dtype):
    ctx = tiny.context(dtype)
    B = ctx.traffic["measurements_per_call"]
    params, model, fn, cond, sig = serve_batch.setup(ctx)
    seed0 = inputs.call_seed(ctx.seed, 0)
    got = fn(model, cond[:B], sig[:B], seed0)
    want = serve_batch.reference(ctx, params, torch.as_tensor(cond[:B]),
                                 torch.as_tensor(sig[:B]), seed0)
    assert (_sha(params.values()), _sha([cond, sig]), _sha([got]),
            _sha([want]), serve_batch.rel_err(got, want)) == PARENT[dtype]


@pytest.mark.parametrize("name,rows", sorted(PARENT_COUNTS))
def test_flagship_counts_equal_the_parents(name, rows):
    cfg = CONFIGS[name]
    m, L = cfg["model"], cfg["segment_len"]
    flops, bounds = PARENT_COUNTS[(name, rows)]
    assert yardstick.model_flops_per_sample(m, L) == flops
    assert yardstick.forward_bounds(m, L, rows) == bounds
