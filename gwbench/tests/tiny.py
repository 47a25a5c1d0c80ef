"""Cells at a size a CPU test can hold: a two-level attention U-Net of
base width 8 at L 256, with the benchmark's traffic mixes cut to a few
rows and steps."""
from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from gwbench import cell

HERE = Path(__file__).resolve().parents[1]

MODEL = {"in_ch": 7, "cond_in_ch": 5, "use_selfcond": True, "base_ch": 8,
         "depth": 2, "time_dim": 16, "t_embed_max_time": 999.0,
         "use_attention": True}


def config(dtype: str = "float32") -> dict:
    return {"name": "tiny", "model": dict(MODEL), "T": 1000,
            "schedule": "cosine", "pred_type": "v", "dtype": dtype,
            "segment_len": 256, "fs": 256}


def traffic() -> dict:
    t = json.loads((HERE / "traffic" / "recon_b4_s50.json").read_text())
    t.update(measurements_per_call=2, steps=4, avg_seeds=2, pool_calls=3,
             reference_row_block=0)
    return t


LIMITS = {"numbers": {"rel_err": {"limit": 1e-3}}}


def context(dtype: str = "float32", seed: int = 3_000_000_019,
            seconds: float = 0.3) -> cell.Context:
    name = "tiny.recon"
    return cell.Context(name=name, workload={"name": name, "chips": 1},
                        config=config(dtype), traffic=traffic(),
                        limits=LIMITS, seed=seed, seconds=seconds,
                        trace=False, device=torch.device("cpu"),
                        started=time.time())


def bench_for(ctx: cell.Context) -> dict:
    """``BENCHMARK.json``'s metrics, each applied to ``ctx``'s cell where it
    applies to a reconstruction cell."""
    bench = cell.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [ctx.name] if any(
                "recon" in w for w in m["workloads"]) else []
    return bench
