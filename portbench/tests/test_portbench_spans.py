"""The readers of the program's spans and counters on hand-made records,
the reductions of portbench/spans.py on synthetic traces, and the tool
end to end on a tiny cell on the CPU."""

import importlib.util

import pytest

from conftest import REPO
from portbench import spans, trace


def _reader(metric):
    spec = importlib.util.spec_from_file_location(metric, REPO / "portbench" / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(i, name, parent, t0, t1, ms):
    return {"name": name, "id": i, "parent": parent, "start_ns": t0, "end_ns": t1, "device_ms": ms}


def _program(timed=True):
    """Two LM steps of one solve: each step's parts; inside the Schur
    solve the right-hand side's W z, two CG products S p and the
    back-substitution's W^T x."""
    out, i = [_span(0, "ba.bundle_adjust", None, 0, 1000, 100.0)], 1
    for k in range(2):
        step = i
        out.append(_span(step, "ba.step", 0, 10 + 490 * k, 490 + 490 * k, 49.0))
        i += 1
        for name, ms in (("ba.normal_eq", 5.0), ("ba.schur", 40.0), ("ba.update", 3.5)):
            part = i
            out.append(_span(part, name, step, 20 + 490 * k, 30 + 490 * k, ms))
            i += 1
            if name == "ba.schur":
                for child, cms in (("ba.cg.wz", 1.0), ("ba.cg.smv", 20.0), ("ba.cg.smv", 12.0), ("ba.cg.wtx", 1.5)):
                    out.append(_span(i, child, part, 21, 22, cms))
                    i += 1
    if not timed:
        out = [dict(s, device_ms=None) for s in out]
    return {"spans": out, "counters": {"ba.lm_accepted": 1, "ba.lm_steps": 2}}


def test_readers_on_a_hand_made_record():
    rec = {"program": _program()}
    want = {"normal_eq_span_ms": 5.0, "schur_span_ms": 40.0, "cg_smv_span_ms": 32.0, "lm_update_span_ms": 3.5,
            "lm_accepted_pct": 50.0}
    assert {m: _reader(m)(rec) for m in spans.METRICS} == pytest.approx(want)


@pytest.mark.parametrize("record", [{}, {"program": _program(timed=False)},
                                    {"program": {"spans": [], "counters": {}}}])
def test_readers_without_device_times_read_nothing(record):
    assert all(_reader(m)(record) is None for m in spans.METRICS)


def test_coverage():
    assert spans.coverage(_program()) == pytest.approx({"root_by_steps": 0.98, "step_by_parts": 48.5 / 49.0})


def test_warm_split():
    got = spans.warm_split(_program()["spans"])
    assert got[spans.BEFORE] == pytest.approx([10e-9, 0.0]) and "ba.bundle_adjust" not in got
    assert got["ba.step"] == pytest.approx([480e-9, 480e-9]) and got["ba.normal_eq"] == pytest.approx([10e-9, 10e-9])


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": 1, "args": args}


def _events():
    """A window [0, 100) us: kernels at [10, 20), [30, 50), [60, 100);
    program spans ba.step [0, 70) around ba.schur [15, 55) around
    ba.cg.wz [25, 35); a host op inside ba.cg.wz and a copy back."""
    return [
        _x(trace.WINDOW, "user_annotation", 0, 100),
        _x("k1", "kernel", 10, 10), _x("k2", "kernel", 30, 20), _x("k3", "kernel", 60, 40),
        _x("ba.step", "user_annotation", 0, 70), _x("ba.schur", "user_annotation", 15, 40),
        _x("ba.cg.wz", "user_annotation", 25, 10), _x("other", "user_annotation", 1, 8),
        _x("aten::mm", "cpu_op", 22, 6), _x("cudaLaunchKernel", "cuda_runtime", 4, 2, correlation=7),
        _x("cudaMemcpyAsync", "cuda_runtime", 26, 1, correlation=8),
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 58, 1, correlation=8),
        _x("cudaStreamSynchronize", "cuda_runtime", 80, 5),
    ]


def test_idle_by_span_credits_the_innermost_program_span():
    ev = _events()
    got = dict(spans.idle_by_span(ev, {"ba.step", "ba.schur", "ba.cg.wz"}))
    # gaps [0, 10) mid 5 -> ba.step ("other" is no program span), [20, 30) mid 25 -> ba.cg.wz
    # (aten::mm is no span), [50, 58) mid 54 -> ba.schur, [59, 60) mid 59.5 -> ba.step
    assert got == pytest.approx({"ba.step": 11e-6, "ba.cg.wz": 10e-6, "ba.schur": 8e-6})
    red = trace.reduce(ev)
    assert sum(got.values()) == pytest.approx(red["window_s"] - red["busy_s"])
    assert sum(v for _, v in red["idle_gaps"]) == pytest.approx(sum(got.values()))


def test_syncs_inside_the_root():
    ev = [dict(e, name="ba.bundle_adjust") if e["name"] == "ba.step" else e for e in _events()]
    # the synchronize at 80 us lies outside [0, 70); the copy's call at 26 us inside
    assert spans.syncs_inside(ev) == {"Memcpy DtoH (Device -> Pageable)": 1}
    ev.append(_x("cudaDeviceSynchronize", "cuda_runtime", 40, 3))
    assert spans.syncs_inside(ev)["cudaDeviceSynchronize"] == 1


def test_tool_on_a_tiny_cell(bench_root, fake_card, tmp_path):
    from portbench.run import Cell

    cell = Cell(bench_root, "tiny.tiny-seq07")
    result, notes = spans.measure(cell, 2**31 + 5, fake_card, tmp_path / "trace.json")
    lm = cell.traffic["lm_iters"]
    assert result["counters"]["ba.lm_steps"] == lm and 0 < result["counters"]["ba.lm_accepted"] <= lm
    assert result["metrics"] == {m: None for m in spans.METRICS} and result["coverage"] is None
    assert result["syncs_inside_root"] == {} and set(result["replica"]) == {"normal_eq_ms", "schur_solve_ms"}
    warm = result["warm"]["host_s_first_step_and_rest"]
    assert set(warm) == {spans.BEFORE, "ba.step", *spans.STEP_PARTS, "ba.cg.wtx", "ba.cg.wz", "ba.cg.smv"}
    # on the CPU the whole window is one gap, credited to the span open at its midpoint
    assert notes[0].startswith("idle by span: ba.") and notes[1].startswith("warm solve ")
    assert not (tmp_path / "trace.json").exists()
