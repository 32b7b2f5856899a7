"""The port's span and counter recorder (utils/profiler.py) and the spans
and counters that bundle adjustment places (optim/ba.py), on the CPU: span
counts and nesting per solve through both solvers, the counters against
the LM state, outputs bit for bit with the recorder on and off, nothing
recorded and no `record_function` opened while it is off and no profiler
listens, and spans on the clock of a torch.profiler trace.

Imports neither jax nor the JAX package."""

import json
from collections import Counter

import pytest
import torch

from opencv_tpu_torch import convert
from opencv_tpu_torch.optim import ba
from opencv_tpu_torch.utils import profiler

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

# Eight LM steps of five CG iterations from a small lambda0: some steps are
# rejected (5 of 8 accepted through the CG solver on this scene).
SETTINGS = dict(iters=8, cg_iters=5, lambda0=1e-8)
PARENT = {"ba.bundle_adjust": None, "ba.step": "ba.bundle_adjust", "ba.normal_eq": "ba.step",
          "ba.schur": "ba.step", "ba.update": "ba.step", "ba.cg.wtx": "ba.schur", "ba.cg.wz": "ba.schur",
          "ba.cg.smv": "ba.schur"}


@pytest.fixture(scope="module")
def problem():
    import chip_smoke

    return convert.ba_problem(chip_smoke.ba_scene(n_cams=6, n_pts=60, views=4), device="cpu")


@pytest.fixture()
def recorder():
    profiler.reset()
    profiler.enable(True)
    yield
    profiler.enable(False)
    profiler.reset()


def _solve(p, solver):
    return ba.bundle_adjust(p, solver=solver, **SETTINGS)


@pytest.mark.parametrize("solver", ["cg", "dense"])
def test_span_counts_per_solve(problem, recorder, solver):
    for _ in range(2):
        _solve(problem, solver)
    steps = 2 * SETTINGS["iters"]
    want = {"ba.bundle_adjust": 2, "ba.step": steps, "ba.normal_eq": steps, "ba.schur": steps, "ba.update": steps}
    if solver == "cg":
        # W z for the right-hand side, S p once per CG iteration, W^T x in
        # the back-substitution
        want["ba.cg.wtx"] = want["ba.cg.wz"] = steps
        want["ba.cg.smv"] = steps * SETTINGS["cg_iters"]
    assert Counter(s["name"] for s in profiler.spans()) == want


@pytest.mark.parametrize("solver", ["cg", "dense"])
def test_parents_follow_nesting(problem, recorder, solver):
    _solve(problem, solver)
    spans = profiler.spans()
    by_id = {s["id"]: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        parent = by_id[s["parent"]] if s["parent"] is not None else None
        assert (parent and parent["name"]) == PARENT[s["name"]]
        assert s["start_ns"] <= s["end_ns"] and s["device_ms"] is None
        if parent:
            assert parent["start_ns"] <= s["start_ns"] and s["end_ns"] <= parent["end_ns"]
    for step in (s for s in spans if s["name"] == "ba.step"):
        children = [s["name"] for s in spans if s["parent"] == step["id"]]
        assert children == ["ba.normal_eq", "ba.schur", "ba.update"]


@pytest.mark.parametrize("solver", ["cg", "dense"])
def test_counters_follow_the_lm_state(problem, recorder, solver):
    profiler.enable(False)
    state = ba.BAStepState(problem=problem, lam=torch.tensor(SETTINGS["lambda0"]), cost=ba.cost(problem),
                           n_accepted=torch.tensor(0, dtype=torch.int32))
    for _ in range(SETTINGS["iters"]):
        state = ba.ba_step(state, solver=solver, cg_iters=SETTINGS["cg_iters"])
    assert profiler.counters() == {}
    profiler.enable(True)
    for _ in range(2):
        _solve(problem, solver)
    accepted = int(state.n_accepted)
    assert 0 < accepted < SETTINGS["iters"]
    assert profiler.counters() == {"ba.lm_accepted": 2 * accepted, "ba.lm_steps": 2 * SETTINGS["iters"]}


@pytest.mark.parametrize("solver", ["cg", "dense"])
def test_outputs_bit_for_bit_with_the_recorder_on_and_off(problem, solver):
    off = _solve(problem, solver)
    profiler.reset()
    profiler.enable(True)
    try:
        on = _solve(problem, solver)
        assert profiler.spans()
    finally:
        profiler.enable(False)
        profiler.reset()
    assert all(torch.equal(a, b) for a, b in zip(off[0], on[0])) and torch.equal(off[1], on[1])


def test_off_without_a_profiler_records_nothing(problem, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with no profiler listening")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiler.reset()
    profiler.enable(False)
    _solve(problem, "cg")
    profiler.count("a")
    profiler.keep("b", torch.tensor(1))
    assert profiler.spans() == [] and profiler.counters() == {} and profiler.report() == {}


def test_spans_share_the_profilers_clock(problem, recorder, tmp_path):
    profiler.start_device_trace(str(tmp_path))
    ba.bundle_adjust(problem, iters=2, solver="cg", cg_iters=3)
    with open(profiler.stop_device_trace()) as f:
        trace = json.load(f)
    # a trace's ts are microseconds after its baseTimeNanoseconds
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    events = sorted((e for e in trace["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                     and e["name"] in PARENT), key=lambda e: e["ts"])
    spans = sorted(profiler.spans(), key=lambda s: s["start_ns"])
    assert [e["name"] for e in events] == [s["name"] for s in spans] and len(spans) == 1 + 2 * (4 + 2 + 3)
    for e, s in zip(events, spans):
        assert abs(base_us + e["ts"] - s["start_ns"] / 1e3) < 1000.0
        assert abs(base_us + e["ts"] + e["dur"] - s["end_ns"] / 1e3) < 1000.0


def test_counters_add_host_counts_and_kept_scalars(recorder):
    profiler.count("a")
    profiler.count("a", 2)
    profiler.keep("b", torch.tensor(3, dtype=torch.int32))
    profiler.keep("b", torch.tensor(4, dtype=torch.int32))
    assert profiler.counters() == {"a": 3, "b": 7}
    profiler.reset()
    assert profiler.counters() == {}


def test_report_sums_the_spans(recorder):
    for _ in range(3):
        with profiler.profile_region("outer"):
            with profiler.profile_region("inner", "cpu"):
                sum(range(1000))
    spans = profiler.spans()
    rep = profiler.report()
    assert set(rep) == {"outer", "inner"} and rep["outer"][1] == rep["inner"][1] == 3
    for name, (sec, calls) in rep.items():
        assert sec == pytest.approx(sum(s["end_ns"] - s["start_ns"] for s in spans if s["name"] == name) * 1e-9)
