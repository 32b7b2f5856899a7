"""The card a run measures on. Every reading goes through torch.cuda and
raises without a card: a run on the CPU never reports a device number."""

from __future__ import annotations

import statistics
from pathlib import Path

import torch

from portbench import trace


class NoCard(RuntimeError):
    pass


class Card:
    device = "cuda"

    def require(self, chips: int) -> None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise NoCard(f"this cell needs {chips} CUDA device(s); {n} found")

    def sync(self) -> None:
        torch.cuda.synchronize()

    def reset_peak(self) -> None:
        torch.cuda.reset_peak_memory_stats()

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated()

    def kind(self) -> str:
        return torch.cuda.get_device_name(0)

    def median_ms(self, fn, reps: int) -> list:
        """Device ms of each of `reps` back-to-back calls of `fn`, by CUDA
        events around each, after one call untimed."""
        fn()
        marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(reps)]
        for a, b in marks:
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in marks)

    def profile(self, fn, trace_file: Path) -> dict:
        return trace.profile(fn, trace_file)
