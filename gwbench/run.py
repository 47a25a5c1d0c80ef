"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m gwbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  With ``--trace 0`` the line's metrics are the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, read
from a traced window after the measured one.  Every run ends by comparing
what the window produced with the plain reference and prints each number
compared beside its limit, on standard error and as the line's last key.
Progress goes to standard error; the result is the last line of standard
output.  Without the cards the cell asks for, or with JAX or the JAX
package loaded, the run prints no result and exits with a code other than
0.
"""
from __future__ import annotations

import os
import time


def process_start() -> float:
    """The wall-clock time this process started, from ``/proc``."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fh:
            boot = next(int(line.split()[1]) for line in fh
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


STARTED = process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def result_line(ctx, bench: dict, rec: dict) -> dict:
    """The result line of a finished run."""
    import torch

    from . import cell

    rec.update(config=ctx.config, traffic=ctx.traffic, chips=ctx.chips)
    metrics = cell.read_metrics(ctx, bench, rec)
    numbers = rec.get("numbers", {})
    compared = {k: {"value": numbers.get(k), "limit": v["limit"]}
                for k, v in ctx.limits["numbers"].items()}
    correct = (rec["failed"] == 0 and bool(compared) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in compared.values()))
    device = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(ctx.device)
                       if ctx.device.type == "cuda" else "cpu"),
              "count": ctx.chips,
              "memory_peak_bytes": rec["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": rec["attempted"],
            "failed": rec["failed"], "metrics": metrics, "device": device}
    if ctx.trace:
        tr = rec["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["compared"] = compared
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from . import cell

    bench = cell.benchmark()
    chips = {w["name"]: int(w["chips"])
             for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" available")
        return 2
    ctx = cell.context(args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", STARTED)
    log(f"[gwbench] {ctx.name} seed {ctx.seed} seconds {ctx.seconds} "
        f"trace {int(ctx.trace)} on {torch.cuda.get_device_name(ctx.device)}")
    rec = cell.driver(ctx).run(ctx)
    found = cell.forbidden_modules()
    if found:
        log(f"[gwbench] loaded, and must not be: {', '.join(found)}")
        return 3
    line = result_line(ctx, bench, rec)
    log(f"[gwbench] setup_s {rec['setup_s']:.3f} window_s "
        f"{rec['window_s']:.3f} units {rec['units']} reference_s "
        f"{rec.get('reference_s', 0.0):.3f}")
    for name, c in line["compared"].items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
