"""Helpers for the harness's CPU tests: a stand-in for the card, and a
copy of the benchmark's files that a test may add to."""

from __future__ import annotations

import json
import shutil
import statistics
import time
from pathlib import Path

import pytest

from portbench import roofline

REPO = Path(__file__).resolve().parents[2]
FAKE_KIND = "CPU stand-in for a card"


class FakeCard:
    """Runs on the CPU and returns placeholder device readings: only for
    driving the rest of a run in tests."""

    device = "cpu"

    def require(self, chips):
        pass

    def sync(self):
        pass

    def reset_peak(self):
        pass

    def memory_peak(self):
        return 0

    def kind(self):
        return FAKE_KIND

    def median_ms(self, fn, reps):
        fn()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    def profile(self, fn, trace_file):
        t0 = time.perf_counter()
        fn()
        w = time.perf_counter() - t0
        return {"busy_s": 0.5 * w, "window_s": w, "kernels": 1000, "device_ops": [["op", 0.5 * w]],
                "idle_gaps": [["gap", 0.5 * w]]}


# Tiny deployments shaped as the two configurations: (new config, the
# configuration it copies, its one problem and counts).
TINY = [
    ("tiny-seq07", "kitti07-orbslam2", "seq-tiny07", {"cameras": 160, "points": 300, "observations": 2400}),
    ("tiny-seq00", "kitti00-orbslam2", "seq-tiny00", {"cameras": 200, "points": 400, "observations": 3200}),
]
# What a tiny cell reports: every metric listed for the cells but the
# program's span metrics, which need the card's events (no tail metric
# exists).
TINY_METRICS = {"ba_solve_s", "normal_eq_ms", "schur_solve_ms", "cg_roofline", "device_idle_pct",
                "kernels_per_lm_iter"}
# Over 16 seeds on the CPU (with and without Huber weights) the program reads at most 3.9e-5
# (cost) and 2.0e-5 (residual); the control at least 0.78 and 8.9e-3, the altered point 1.0e-3.
TINY_LIMITS = {"cost_gap": 5e-4, "residual_gap": 5e-4}


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setitem(roofline.PEAKS, FAKE_KIND, {"hbm_byte_s": 1e11})
    return FakeCard()


def add_cell(root: Path, cell: str, config: dict, traffic: dict) -> None:
    """Add `cell` to the copy under `root` as a later change adds a cell:
    new configuration and traffic files, and entries in BENCHMARK.json
    (the cell listed in TINY_METRICS)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    name = config["name"]
    (root / "portbench" / "configs" / f"{name}.json").write_text(json.dumps(config))
    bench["configs"].append({"name": name, "source": "a test", "file": f"portbench/configs/{name}.json",
                             "reduced": [], "why": "a test's tiny deployment"})
    (root / "portbench" / "traffic" / f"{cell}.json").write_text(json.dumps(traffic))
    bench["workloads"].append({"name": cell, "config": name, "traffic": cell, "chips": 1, "why": "a test's tiny cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and m["name"] in TINY_METRICS:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def tiny_config(like: str, name: str, problem: str, counts: dict) -> dict:
    cfg = json.loads((REPO / "portbench" / "configs" / f"{like}.json").read_text())
    return dict(cfg, name=name, problems={problem: counts})


def tiny_traffic(problem: str) -> dict:
    return {"problem": problem, "solver": "cg", "lm_iters": 10, "cg_iters": 60, "huber_delta_px": None,
            "lambda0": 0.0001, "check_samples": 3, "trace_solves": 2, "layer_reps": 2, "limits": TINY_LIMITS}


@pytest.fixture
def bench_root(tmp_path):
    """A copy of BENCHMARK.json and portbench/ to which tiny cells are
    added as a later change adds a cell: new configuration and traffic
    files, and entries in BENCHMARK.json; no file already there changes."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, like, problem, counts in TINY:
        add_cell(tmp_path, f"tiny.{name}", tiny_config(like, name, problem, counts), tiny_traffic(problem))
    return tmp_path
