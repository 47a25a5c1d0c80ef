"""A cell of ``BENCHMARK.json`` resolved to its files: the configuration
(``configs/<config>.json``, whose ``model`` block's ``arch`` names the pair
``reference/<arch>.py`` and ``arch/<arch>.py``; the U-Net where it names
none), the traffic mix (``traffic/<traffic>.json``, whose ``kind`` names
its driver, ``drivers/<kind>.py``), the limits of its correctness numbers
(``limits/<cell>.json``) and the readers of its metrics
(``metrics/<metric>.py``), each found by name."""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may load: JAX, its libraries and the
# JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax",
             "diffusion_models_for_gravitational_waveform_reconstruction_tpu")


def forbidden_modules() -> List[str]:
    """The forbidden top-level names loaded in this process, compared
    whole (the port's name begins with the JAX package's)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metric_reader(name: str) -> Callable[[dict], Optional[float]]:
    """``read(run) -> value or None`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"gwbench.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's files, the run's arguments, the device
    and the clock of the run's set-up."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float
    root: Path = ROOT

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def clock(self) -> float:
        """Seconds since the process started."""
        return time.time() - self.started

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def context(name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", started: Optional[float] = None,
            root=ROOT) -> Context:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` for one run, its
    files under ``root/gwbench``."""
    root = Path(root)
    files = root / "gwbench"
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    traffic = _json(files / "traffic" / f"{w['traffic']}.json")
    return Context(name=name, workload=w,
                   config=_json(files / "configs" / f"{w['config']}.json"),
                   traffic=traffic,
                   limits=_json(files / "limits" / f"{name}.json"),
                   seed=int(seed), seconds=float(seconds), trace=bool(trace),
                   device=dev,
                   started=time.time() if started is None else started,
                   root=root)


def driver(ctx: Context):
    return importlib.import_module(f"gwbench.drivers.{ctx.traffic['kind']}")


def metrics_of(ctx: Context, bench: dict) -> List[dict]:
    """The cell's metrics of this run: its end-to-end metrics, or with
    ``--trace 1`` its per-layer metrics."""
    group = bench["per_layer"] if ctx.trace else bench["end_to_end"]
    return [m for m in group if applies(m, ctx.name)]


def read_metrics(ctx: Context, bench: dict, rec: dict) -> Dict[str, dict]:
    """Each metric's reading, by its reader; a reader that finds nothing
    to read leaves its metric out."""
    out = {}
    for m in metrics_of(ctx, bench):
        v = metric_reader(m["name"])(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
