"""A traced window: ``torch.profiler`` over a callable, reduced to device
seconds by kernel and by the program's profiler ranges, the busy time, and
the longest idle gaps by what the host was doing.

The trace is written to ``TMPDIR``, read and deleted.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, Dict

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def traced(fn: Callable[[], dict]) -> dict:
    """Run ``fn`` (it returns what it did, a dict) under the profiler, the
    device drained before and after; returns that dict with the trace's
    summary under ``"trace"``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        did = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    did["trace"] = summarize(events, wall)
    return did


def _short(name: str) -> str:
    return name.replace("void ", "").replace(
        "(anonymous namespace)::", "").split("(")[0].split("<")[0][:80]


def summarize(events, wall_s: float) -> dict:
    """Device seconds by (kernel, innermost range) and by range at any depth,
    busy seconds, the window, and the idle gaps' seconds by the innermost
    host operation open at each gap's middle (the 200 longest gaps)."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
              for e in events if e.get("cat") == "user_annotation"
              and e.get("ph") == "X"]
    r_lo = np.array([r[0] for r in ranges]) if ranges else np.zeros(0)
    r_hi = np.array([r[1] for r in ranges]) if ranges else np.zeros(0)
    ops: Dict[tuple, list] = {}
    any_range: Dict[str, float] = {}
    for e in dev:
        dur = float(e["dur"]) * 1e-6
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        inner = ""
        if ts is not None and len(ranges):
            idx = np.nonzero((r_lo <= ts) & (ts <= r_hi))[0]
            if len(idx):
                for i in idx:
                    any_range[ranges[i][2]] = any_range.get(ranges[i][2],
                                                            0.0) + dur
                inner = ranges[idx[np.argmin(r_hi[idx] - r_lo[idx])]][2]
        key = (e["name"], inner)
        acc = ops.setdefault(key, [0.0, 0])
        acc[0] += dur
        acc[1] += 1
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev)
    busy, end, gaps = 0.0, None, []
    for ts, te in spans:
        if end is None or ts >= end:
            if end is not None and ts > end:
                gaps.append((ts - end, 0.5 * (ts + end)))
            busy += te - ts
            end = te
        elif te > end:
            busy += te - end
            end = te
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "user_annotation",
                                 "cuda_runtime", "cuda_driver")]
    h_lo = np.array([float(e["ts"]) for e in host]) if host else np.zeros(0)
    h_hi = (h_lo + np.array([float(e["dur"]) for e in host])
            if host else np.zeros(0))
    by_host: Dict[str, float] = {}
    for g, mid in sorted(gaps, reverse=True)[:200]:
        idx = np.nonzero((h_lo <= mid) & (mid <= h_hi))[0] if len(h_lo) else []
        label = (host[idx[np.argmin(h_hi[idx] - h_lo[idx])]]["name"]
                 if len(idx) else "(no host operation)")
        by_host[label] = by_host.get(label, 0.0) + g * 1e-6
    by_name: Dict[str, float] = {}
    for (name, _), (s, _) in ops.items():
        by_name[_short(name)] = by_name.get(_short(name), 0.0) + s
    return {
        "window_s": wall_s,
        "busy_s": busy * 1e-6,
        "ops": [[name, inner, s, n] for (name, inner), (s, n) in ops.items()],
        "range_s": any_range,
        "device_ops": sorted(([k, v] for k, v in by_name.items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(([k, v] for k, v in by_host.items()),
                            key=lambda kv: -kv[1])[:10],
    }
