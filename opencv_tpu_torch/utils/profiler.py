"""Region tracing/profiling (CV_INSTRUMENT_REGION / CV_TRACE analog,
reference core/src/trace.cpp; env-gated like OPENCV_TRACE,
trace.cpp:76-88). Port of opencv_tpu/utils/profiler.py.

`profile_region` both opens a `torch.profiler.record_function` range (so
regions show up in a torch.profiler trace beside the card's kernels) and
accumulates host wall time per region name. `OPENCV_TPU_TRACE=1`
enables the wall-time accumulation. `start_device_trace` and
`stop_device_trace` wrap a `torch.profiler.profile` of the CPU and, where
there is one, the card, and write its Chrome trace into `logdir`.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

_ENABLED = os.environ.get("OPENCV_TPU_TRACE", "0") not in ("0", "")
_TOTALS: dict[str, float] = defaultdict(float)
_COUNTS: dict[str, int] = defaultdict(int)
_TRACE: dict = {}


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


@contextlib.contextmanager
def profile_region(name: str):
    """with profile_region("orb.detect"): ... — nestable region marker."""
    with torch.profiler.record_function(name):
        if not _ENABLED:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _TOTALS[name] += time.perf_counter() - t0
            _COUNTS[name] += 1


def report() -> dict[str, tuple[float, int]]:
    """{region: (total_seconds, calls)} accumulated so far."""
    return {k: (_TOTALS[k], _COUNTS[k]) for k in sorted(_TOTALS)}


def reset() -> None:
    _TOTALS.clear()
    _COUNTS.clear()


def start_device_trace(logdir: str) -> None:
    """Begin a torch.profiler trace of the CPU and the card (if any)."""
    if _TRACE:
        raise RuntimeError("a device trace is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _TRACE.update(prof=prof, logdir=logdir)


def stop_device_trace() -> str:
    """End the trace and write it to <logdir>/trace_<pid>_<n>.json (Chrome
    trace format); returns the file's path."""
    prof, logdir = _TRACE.pop("prof"), _TRACE.pop("logdir")
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    n = len([f for f in os.listdir(logdir) if f.startswith("trace_")])
    path = os.path.join(logdir, f"trace_{os.getpid()}_{n}.json")
    prof.export_chrome_trace(path)
    return path
