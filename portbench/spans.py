"""The program's own spans and counters of bundle adjustment, reduced to
per-layer numbers, and a tool that records them on a cell's problem:

    python3 -m portbench.spans --workload <cell> --seed <n>

A `program` record is {"spans": profiler.spans(), "counters":
profiler.counters()} of opencv_tpu_torch/utils/profiler.py, taken over
whole solves with the recorder on (`recorded`). The readers
portbench/metrics/*_span_ms.py and lm_accepted_pct.py take it as
`record["program"]`, which a --trace 1 run of portbench/run.py records.

The tool generates the cell's problem from --seed as a run does, then
runs, recorder on where named: the warm solve, on (host seconds by span,
first LM step against the rest); a solve, on (the readers' numbers, each
root's and step's coverage by its children); a solve under
torch.profiler, off (its kernels); a solve under the profiler, on (the
readers' numbers there, the window's idle gaps by the innermost program
span open on the host, synchronizations and device-to-host copies inside
`ba.bundle_adjust`, its kernels); and run.py's replica timings of the two
layers. It prints the notes on stderr and one JSON line. Not run by the
benchmark.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import sys
import time
from pathlib import Path

from portbench import trace

ROOT, STEP = "ba.bundle_adjust", "ba.step"
STEP_PARTS = ("ba.normal_eq", "ba.schur", "ba.update")
METRICS = ("normal_eq_span_ms", "schur_span_ms", "cg_smv_span_ms", "lm_update_span_ms", "lm_accepted_pct")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
BEFORE = "(before the first step)"


def recorded(fn, card) -> tuple:
    """(fn()'s result, the program record of it): the recorder on from a
    reset, then the card synchronized before its spans are read.

    Earlier work's garbage is collected first: a profiler's session leaves
    cycles whose collection, where it fell inside a recorded solve, held
    the host for 0.24-0.33 s in one LM step's normal equations (KITTI 00's
    cell on an H100), and their span with it."""
    from opencv_tpu_torch.utils import profiler

    gc.collect()
    profiler.reset()
    profiler.enable(True)
    try:
        out = fn()
        card.sync()
        return out, {"spans": profiler.spans(), "counters": profiler.counters()}
    finally:
        profiler.enable(False)
        profiler.reset()


def _timed(program) -> bool:
    """The record holds spans, each with its device time."""
    return bool(program and program["spans"]) and all(s["device_ms"] is not None for s in program["spans"])


def per_step_ms(program, name: str):
    """Device ms of all `name` spans over the LM steps attempted
    (`ba.lm_steps`); None without a record, such spans or device times."""
    if not _timed(program) or not program["counters"].get("ba.lm_steps"):
        return None
    ms = [s["device_ms"] for s in program["spans"] if s["name"] == name]
    return sum(ms) / program["counters"]["ba.lm_steps"] if ms else None


def accepted_pct(program):
    """100 x `ba.lm_accepted` / `ba.lm_steps`; None off the card."""
    if not _timed(program) or not program["counters"].get("ba.lm_steps"):
        return None
    c = program["counters"]
    return 100.0 * c.get("ba.lm_accepted", 0) / c["ba.lm_steps"]


def coverage(program) -> dict:
    """The least share, over the roots, of a root's device time that its
    `ba.step` children cover, and over the steps, of a step's that its
    three parts cover."""
    by_parent: dict = {}
    for s in program["spans"]:
        by_parent.setdefault(s["parent"], []).append(s)

    def least(name, parts):
        shares = [sum(c["device_ms"] for c in by_parent.get(s["id"], []) if c["name"] in parts) / s["device_ms"]
                  for s in program["spans"] if s["name"] == name]
        return min(shares) if shares else None

    return {"root_by_steps": least(ROOT, (STEP,)), "step_by_parts": least(STEP, STEP_PARTS)}


def warm_split(spans: list) -> dict:
    """{span name: [host s inside the first `ba.step` of its solve, host s
    inside the later steps]}, and under BEFORE the host seconds from each
    root's start to its first step (the first cost)."""
    by_id = {s["id"]: s for s in spans}
    first = {}
    for s in sorted((s for s in spans if s["name"] == STEP), key=lambda s: s["start_ns"]):
        first.setdefault(s["parent"], s)
    out: dict = {BEFORE: [0.0, 0.0]}
    for s in spans:
        if s["name"] == ROOT:
            if s["id"] in first:
                out[BEFORE][0] += (first[s["id"]]["start_ns"] - s["start_ns"]) * 1e-9
            continue
        step = s
        while step is not None and step["name"] != STEP:
            step = by_id.get(step["parent"])
        if step is not None:
            split = out.setdefault(s["name"], [0.0, 0.0])
            split[0 if first.get(step["parent"]) is step else 1] += (s["end_ns"] - s["start_ns"]) * 1e-9
    return out


def idle_by_span(events: list, names) -> list:
    """The window's idle gaps credited to the innermost span named in
    `names` open on the host at each gap's midpoint: trace.reduce's rule,
    applied to the trace with every other host event left out.
    [[name, seconds], ...], largest first; they sum to reduce's idle time."""
    names = set(names) | {trace.WINDOW}
    kept = [e for e in events if e.get("cat") in trace.DEVICE_CATS
            or (e.get("cat") == "user_annotation" and e.get("name") in names)]
    return trace.reduce(kept)["idle_gaps"]


def syncs_inside(events: list, name: str = ROOT) -> dict:
    """{call: count} of the synchronizations and device-to-host copies the
    host issued inside the spans `name` of a trace."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") == name]
    inside = [e for e in events if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
              and any(a <= e["ts"] < b for a, b in spans)]
    corr = {e.get("args", {}).get("correlation") for e in inside}
    out: dict = {}
    for e in inside:
        if e["name"] in SYNCS:
            out[e["name"]] = out.get(e["name"], 0) + 1
    for e in events:
        if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"] and e.get("args", {}).get("correlation") in corr:
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def profiled_events(fn, trace_file: Path) -> list:
    """The trace events of `fn()` then a synchronize, under the profiler,
    inside trace.WINDOW (as trace.profile records, keeping the events)."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=acts) as prof:
        if cuda:  # a kernel before the window: a second profile in a process can miss its first kernels
            torch.ones(1, device="cuda").sum()
            torch.cuda.synchronize()
        with record_function(trace.WINDOW):
            fn()
            if cuda:
                torch.cuda.synchronize()
    trace_file.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_file))
    try:
        with open(trace_file) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(trace_file)


def _kernels(events: list) -> dict:
    out: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def measure(cell, seed: int, card, trace_file: Path) -> tuple:
    """(result, notes) of the tool on `cell`'s problem from `seed`."""
    import torch

    from opencv_tpu_torch.optim import ba
    from portbench.run import _no_tf32

    tr, kw = cell.traffic, cell.lm_settings()
    p = ba.BAProblem(**cell.make_problem(seed, card.device))
    solve = functools.partial(ba.bundle_adjust, p, solver="cg", **kw)
    lm_iters = tr["lm_iters"]

    card.sync()
    t0 = time.perf_counter()
    _, warm_program = recorded(solve, card)
    warm_s = time.perf_counter() - t0
    warm = warm_split(warm_program["spans"])
    _, program = recorded(solve, card)
    off_events = profiled_events(solve, trace_file)
    off, off_kernels = trace.reduce(off_events), _kernels(off_events)
    del off_events
    events, traced = recorded(lambda: profiled_events(solve, trace_file), card)
    on, on_kernels = trace.reduce(events), _kernels(events)
    idle = idle_by_span(events, {s["name"] for s in traced["spans"]})
    syncs = syncs_inside(events)
    del events

    lam = torch.tensor(tr["lambda0"], dtype=torch.float32, device=card.device)
    _no_tf32()
    eqs = ba.normal_equations(p, kw["huber_delta"])
    replica = {"normal_eq_ms": card.median_ms(lambda: ba.normal_equations(p, kw["huber_delta"]), tr["layer_reps"]),
               "schur_solve_ms": card.median_ms(lambda: ba.schur_cg_solve(
                   eqs, p.obs_cam, p.obs_pt, lam, p.fixed_cams, tr["cg_iters"]), tr["layer_reps"])}
    result = {
        "workload": cell.name, "seed": seed, "kind": card.kind(),
        "metrics": {m: cell.reader(m)({"program": program}) for m in METRICS},
        "metrics_under_the_profiler": {m: cell.reader(m)({"program": traced}) for m in METRICS},
        "replica": replica,
        "counters": program["counters"],
        "coverage": coverage(program) if _timed(program) else None,
        "syncs_inside_root": syncs,
        "kernels_per_lm_iter": {"recorder_on": on["kernels"] / lm_iters, "recorder_off": off["kernels"] / lm_iters},
        "kernels_that_differ": {n: [on_kernels.get(n, 0), off_kernels.get(n, 0)]
                                for n in sorted(set(on_kernels) | set(off_kernels))
                                if on_kernels.get(n, 0) != off_kernels.get(n, 0)},
        "device_idle_pct": 100.0 * (1.0 - on["busy_s"] / on["window_s"]),
        "idle_by_span": idle,
        "warm": {"seconds": warm_s, "host_s_first_step_and_rest": warm},
    }
    notes = ["idle by span: " + ", ".join(f"{n} {s!r}" for n, s in idle),
             "warm solve %r s; host s by span, first LM step / the rest: " % warm_s
             + ", ".join(f"{n} {a!r} / {b!r}" for n, (a, b) in sorted(warm.items()))]
    return result, notes


def main(argv=None) -> int:
    from portbench.card import Card
    from portbench.run import BUILD, Cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    cell = Cell(Path(os.getcwd()).resolve(), args.workload)
    card = Card()
    card.require(cell.entry["chips"])
    result, notes = measure(cell, args.seed, card, BUILD / "spans_trace.json")
    for n in notes:
        print(n, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
