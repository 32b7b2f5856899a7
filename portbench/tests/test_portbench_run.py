"""The harness end to end on the CPU: a stand-in for the card drives the
rest of a run (tiny cells added as files and entries); without a card,
and with the real card readings on the CPU, a run fails and prints no
result; planted faults and the control make `correct` false."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import REPO
from portbench import faults, run
from portbench.card import Card
from portbench.reference import ba_lm as ref

opencv_ba = pytest.importorskip("opencv_tpu_torch.optim.ba")
SEED = str(2**31 + 123)


def _run(root, card, cell, trace, capsys):
    rc = run.main(["--workload", cell, "--seed", SEED, "--seconds", "1", "--trace", str(trace)],
                  root=root, card=card)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err


@pytest.mark.parametrize("cell", ["tiny.tiny-seq07", "tiny.tiny-seq00"])
@pytest.mark.parametrize("trace", [0, 1])
def test_new_cell_from_files(bench_root, fake_card, cell, trace, capsys):
    rc, line, err = _run(bench_root, fake_card, cell, trace, capsys)
    assert rc == 0 and line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "check" and set(line["check"]) == {"cost_gap", "residual_gap"}
    bench = json.loads((bench_root / "BENCHMARK.json").read_text())
    listed = [m for m in bench["end_to_end" if trace == 0 else "per_layer"] if cell in m.get("workloads", [cell])]
    assert set(line["metrics"]) == {m["name"] for m in listed}
    assert all(line["metrics"][m["name"]]["unit"] == m["unit"] for m in listed)
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"]) and set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert err.strip().splitlines()[-1].startswith("check residual_gap ")


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_planted_fault_is_not_correct(bench_root, fake_card, fault, monkeypatch, capsys):
    monkeypatch.setattr(opencv_ba, "bundle_adjust", faults.FAULTS[fault](opencv_ba.bundle_adjust))
    rc, line, _ = _run(bench_root, fake_card, "tiny.tiny-seq07", 0, capsys)
    assert rc == 0 and line["correct"] is False


def test_control_in_the_programs_place_is_not_correct(bench_root, fake_card, monkeypatch, capsys):
    def control(p, iters, lambda0, huber_delta, solver, cg_iters):
        rvec, tvec, pts, c = ref.bundle_adjust(p._asdict(), iters, lambda0, huber_delta, cg_iters,
                                               ar=ref.Arith(torch.float32, tf32=True))
        return p._replace(cam_rvec=rvec, cam_tvec=tvec, points=pts), c

    monkeypatch.setattr(opencv_ba, "bundle_adjust", control)
    rc, line, _ = _run(bench_root, fake_card, "tiny.tiny-seq00", 0, capsys)
    assert rc == 0 and line["correct"] is False


def test_card_readings_fail_on_the_cpu(bench_root, monkeypatch, capsys):
    monkeypatch.setattr(Card, "require", lambda self, chips: None)
    with pytest.raises((AssertionError, AttributeError, RuntimeError)):
        run.main(["--workload", "tiny.tiny-seq00", "--seed", SEED, "--seconds", "1", "--trace", "0"],
                 root=bench_root)
    assert capsys.readouterr().out == ""


def test_a_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "ba.kitti07.cg",
                          "--seed", SEED, "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == "" and "CUDA device" in out.stderr


def test_loaded_jax_fails_the_run(bench_root, fake_card, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    rc, line, err = _run(bench_root, fake_card, "tiny.tiny-seq00", 0, capsys)
    assert rc != 0 and line is None and "jax" in err


def test_only_the_benchmarks_files_are_not_enough(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text((REPO / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(REPO / "portbench"), str(tmp_path / "portbench")], check=True)
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "ba.kitti07.cg",
                          "--seed", SEED, "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""

