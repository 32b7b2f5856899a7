"""Region tracing/profiling (CV_INSTRUMENT_REGION / CV_TRACE analog,
reference core/src/trace.cpp; env-gated like OPENCV_TRACE,
trace.cpp:76-88). Port of opencv_tpu/utils/profiler.py.

One switch, `OPENCV_TPU_TRACE=1` or `enable()`, turns the recorder on.

- Off, `profile_region` checks the flag and opens a
  `torch.profiler.record_function` range only while a torch profiler is
  listening (so regions still show up in `start_device_trace`'s trace);
  `count` and `keep` check the flag and return.
- On, each region is also kept in memory as a span: its name, id, the
  id of the span it opened inside, and its host start and end in ns of
  the Unix clock, the clock torch.profiler's trace uses (an exported
  trace's `ts` is microseconds after its `baseTimeNanoseconds`). Given a
  CUDA `device`, a span also records a pair of timing events on that
  device's current stream; their elapsed time is read only when `spans()`
  or `report()` is called, which must come after the caller's own
  synchronize. The recorder never synchronizes, reads no device value
  and launches no kernel. Spans and counters are per process and assume
  one thread opens them; `reset()` drops them.

Counters: `count(name, n)` adds host integers; `keep(name, tensor)`
keeps a reference to a device scalar the program computes anyway and
reads it only in `counters()`.

`start_device_trace` and `stop_device_trace` wrap a `torch.profiler.profile`
of the CPU and, where there is one, the card, and write its Chrome trace
into `logdir`.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time

import torch

_ENABLED = os.environ.get("OPENCV_TPU_TRACE", "0") not in ("0", "")
_SPANS: list = []  # every span opened since the last reset, in the order they opened
_OPEN: list = []  # the spans open now, innermost last
_IDS = itertools.count()
_COUNTERS: dict[str, int] = {}
_KEPT: dict[str, list] = {}
_OFF = contextlib.nullcontext()
_TRACE: dict = {}


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


class _Span:
    __slots__ = ("name", "device", "id", "parent", "start_ns", "end_ns", "events", "_rf")

    def __init__(self, name: str, device):
        self.name, self.device = name, device
        self.end_ns = self.events = self._rf = None

    def __enter__(self):
        self.start_ns = time.time_ns()
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.id = next(_IDS)
        self.parent = _OPEN[-1].id if _OPEN else None
        _SPANS.append(self)
        _OPEN.append(self)
        if self.device is not None and torch.device(self.device).type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        self.end_ns = time.time_ns()
        _OPEN.remove(self)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def profile_region(name: str, device=None):
    """with profile_region("orb.detect"): ... — nestable region marker.
    `device` is where the region's work runs: a CUDA device adds the
    span's device time while the recorder is on."""
    if _ENABLED:
        return _Span(name, device)
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add `n` to the host counter `name` while the recorder is on."""
    if _ENABLED:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def keep(name: str, value: torch.Tensor) -> None:
    """Add the scalar tensor `value` to the counter `name` while the
    recorder is on: a reference is kept, and read in `counters()`."""
    if _ENABLED:
        _KEPT.setdefault(name, []).append(value)


def counters() -> dict:
    """{counter: total} since the last reset (kept tensors read now)."""
    out = dict(_COUNTERS)
    for name, values in _KEPT.items():
        out[name] = out.get(name, 0) + sum(v.item() for v in values)
    return dict(sorted(out.items()))


def spans() -> list[dict]:
    """The spans opened since the last reset, in the order they opened:
    name, id, parent (None at the top), start_ns and end_ns (None while
    open) on the Unix clock, and device_ms (None without CUDA events or
    while open)."""
    return [{"name": s.name, "id": s.id, "parent": s.parent, "start_ns": s.start_ns, "end_ns": s.end_ns,
             "device_ms": s.events[0].elapsed_time(s.events[1]) if s.events and s.end_ns is not None else None}
            for s in _SPANS]


def report() -> dict[str, tuple[float, int]]:
    """{region: (total_seconds, calls)} of the closed spans: device time
    where the span has it, host time otherwise."""
    out: dict = {}
    for s in spans():
        if s["end_ns"] is None:
            continue
        sec = s["device_ms"] * 1e-3 if s["device_ms"] is not None else (s["end_ns"] - s["start_ns"]) * 1e-9
        total, calls = out.get(s["name"], (0.0, 0))
        out[s["name"]] = (total + sec, calls + 1)
    return dict(sorted(out.items()))


def reset() -> None:
    _SPANS.clear()
    _COUNTERS.clear()
    _KEPT.clear()


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
