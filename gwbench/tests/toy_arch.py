"""The toy architecture's program side, as ``arch/toy.py`` would hold it:
each block one call of the port's K1 with its FiLM epilogue, built from
the benchmark's weights through ``port._m``.  Beside it what the tests
need to enter it: the configuration that ``configs/toy.json`` would hold,
cut in depth, and :func:`register`, which puts this module and
``toy_reference`` where the harness looks the architecture up."""
from __future__ import annotations

import sys
from typing import Dict, List

import torch
import torch.nn.functional as F

from gwbench import port
from gwbench.tests import toy_reference

CUTTABLE = ("num_blocks",)

CONFIG = {
    "name": "toy", "source": "https://arxiv.org/abs/2212.09748",
    "model": {"arch": "toy", "in_ch": 7, "cond_in_ch": 5,
              "use_selfcond": True, "width": 8, "num_blocks": 2,
              "time_dim": 16, "t_embed_max_time": 999.0},
    "T": 1000, "schedule": "cosine", "pred_type": "v", "dtype": "float32",
    "segment_len": 256, "fs": 256,
    "reduced": ["num_blocks"], "published": {"num_blocks": 28},
    "deployment": "2 of 28 blocks: one of 14 pipeline stages",
}


def register(monkeypatch) -> None:
    """The toy's pair in ``sys.modules`` as ``gwbench.reference.toy`` and
    ``gwbench.arch.toy``, for the test that ``monkeypatch`` serves."""
    monkeypatch.setitem(sys.modules, "gwbench.reference.toy", toy_reference)
    monkeypatch.setitem(sys.modules, "gwbench.arch.toy", sys.modules[__name__])


class Toy(torch.nn.Module):
    def __init__(self, config: dict, params: Dict[str, torch.Tensor], device):
        super().__init__()
        self.model = config["model"]
        self.dtype = port.dtype_of(config) or torch.float32
        self.P = {k: v.detach().to(device) for k, v in params.items()}
        self.k1 = port._m("ops.kernels").fused_conv_gn_silu

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        m, P, dt = self.model, self.P, self.dtype
        temb = toy_reference.time_embedding(t, m["time_dim"],
                                            m["t_embed_max_time"]).to(dt)
        h = x.transpose(1, 2).to(dt)                         # (B, L, C)
        for i in range(m["num_blocks"]):
            name = f"block{i}"
            film = temb @ P[f"{name}.film.kernel"].to(dt) \
                + P[f"{name}.film.bias"].to(dt)
            h = self.k1(h, P[f"{name}.conv.kernel"], P[f"{name}.conv.bias"],
                        P[f"{name}.norm.scale"], P[f"{name}.norm.bias"],
                        toy_reference.GROUPS, film=film)
        W = P["final.kernel"].to(dt).permute(2, 1, 0)
        y = F.conv1d(h.transpose(1, 2), W, padding=1) \
            + P["final.bias"].to(dt)[None, :, None]
        return y.float()


def build(config: dict, params: Dict[str, torch.Tensor], device) -> Toy:
    return Toy(config, params, device)


def flops_per_sample(model: dict, L: int) -> float:
    """The convolutions' FLOPs, a MAC counting 2."""
    w = model["width"]
    macs = 3 * L * (model["in_ch"] * w + (model["num_blocks"] - 1) * w * w
                    + w)
    return 2.0 * macs


def kernel_shapes(model: dict, L: int, rows: int) -> Dict[str, List[tuple]]:
    w = model["width"]
    return {"k1": [(rows, L, model["in_ch"] if i == 0 else w, w)
                   for i in range(model["num_blocks"])],
            "k2": []}
