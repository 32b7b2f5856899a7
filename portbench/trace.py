"""A profiled window and its reduction to device busy time, kernel count,
the device operations that took most time, and the idle gaps by what the
host was doing.

`torch.profiler` records host operations and device activity (CUPTI);
its Chrome trace, written to a fixed file in the checkout, is read back
and deleted. The window is a `record_function` span around the traced
work, closed after a synchronize, so every device operation it caused
lies inside it.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10


def profile(fn, trace_file: Path) -> dict:
    """Run `fn()` then synchronize, under the profiler; reduce its trace."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    trace_file.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_file))
    try:
        with open(trace_file) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(trace_file)
    return reduce(events)


def _union(intervals):
    """Merged, sorted [start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events: list) -> dict:
    """busy_s, window_s, kernels, device_ops and idle_gaps of the window
    (times in the trace are microseconds)."""
    spans = [e for e in events if e.get("ph") == "X"]
    win = [e for e in spans if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise ValueError(f"the trace holds {len(win)} windows named {WINDOW!r}")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [e for e in spans if e.get("cat") in DEVICE_CATS and w0 <= e["ts"] < w1]
    busy = _union((e["ts"], min(e["ts"] + e["dur"], w1)) for e in dev)
    by_name: dict = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6

    gaps, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    host = sorted((e for e in spans if e.get("cat") in HOST_CATS and e.get("tid") == win[0].get("tid")
                   and e.get("pid") == win[0].get("pid") and e.get("name") != WINDOW),
                  key=lambda e: (e["ts"], -e["dur"]))
    idle: dict = {}
    stack, i = [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while i < len(host) and host[i]["ts"] <= mid:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= host[i]["ts"]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= mid:
            stack.pop()
        name = stack[-1]["name"] if stack else "(host between operations)"
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "kernels": sum(1 for e in dev if e["cat"] == "kernel"),
        "device_ops": top(by_name),
        "idle_gaps": top(idle),
    }
