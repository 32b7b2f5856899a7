"""A configuration brings its own problem generator, plain reference and
solved fields as files and entries alone; the default generator gives the
loop's tensors bit for bit; `check.compare` judges every solved field;
a traced run records the program's spans and counters."""

import json

import pytest
import torch

from conftest import TINY, add_cell, tiny_config, tiny_traffic
from portbench import check, generate
from portbench.faults import FAULTS
from portbench.reference import ba_lm
from portbench.run import Cell, camera_params, main

opencv_ba = pytest.importorskip("opencv_tpu_torch.optim.ba")
SEED = 2**31 + 321
NAME, LIKE, PROBLEM, COUNTS = TINY[0]

PERMUTED = '''"""The closed road loop with its observations in an order drawn from the seed."""

import torch

from portbench.generate import make_problem as loop


def make_problem(config, traffic, seed, device):
    p = loop(config, traffic, seed, device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 62) + 1)
    order = torch.randperm(p["obs_cam"].shape[0], generator=g, device=device)
    return dict(p, **{k: p[k][order] for k in ("obs_cam", "obs_pt", "obs_uv", "obs_valid")})
'''

REVERSED = '''"""The plain reference with its solved fields returned last first."""

from portbench.reference import ba_lm
from portbench.reference.ba_lm import Arith, residuals  # noqa: F401


def bundle_adjust(problem, *args, **kw):
    rvec, tvec, pts, c = ba_lm.bundle_adjust(problem, *args, **kw)
    return pts, tvec, rvec, c
'''

# A metric a later change could add: the LM steps the program counted.
LM_STEPS_READER = '''def read(record):
    p = record.get("program")
    return None if p is None else p["counters"]["ba.lm_steps"]
'''


def _run(root, card, cell, trace, capsys):
    rc = main(["--workload", cell, "--seed", str(SEED), "--seconds", "1", "--trace", str(trace)], root=root, card=card)
    out, _ = capsys.readouterr()
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("name,like,problem,counts", TINY)
def test_default_generator_gives_the_loop_bit_for_bit(bench_root, name, like, problem, counts):
    cell = Cell(bench_root, f"tiny.{name}")
    assert "generator" not in cell.config
    got = cell.make_problem(SEED, "cpu")
    want = generate.make_problem(cell.config, cell.traffic, SEED, "cpu")
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert cell.solved == check.SOLVED and camera_params(got, cell.solved) == 6


def test_cell_with_its_own_generator(bench_root, fake_card, capsys):
    (bench_root / "portbench" / "loop_permuted.py").write_text(PERMUTED)
    cfg = dict(tiny_config(LIKE, "tiny-permuted", PROBLEM, COUNTS), generator="loop_permuted")
    add_cell(bench_root, "tiny.permuted", cfg, tiny_traffic(PROBLEM))
    mine = Cell(bench_root, "tiny.permuted").make_problem(SEED, "cpu")
    loop = Cell(bench_root, f"tiny.{NAME}").make_problem(SEED, "cpu")
    assert not torch.equal(mine["obs_pt"], loop["obs_pt"]) and torch.equal(mine["obs_pt"].sort().values, loop["obs_pt"])
    for trace in (0, 1):
        line = _run(bench_root, fake_card, "tiny.permuted", trace, capsys)
        assert line["correct"] is True and line["failed"] == 0, line


def test_solved_fields_in_another_order(bench_root, fake_card, capsys):
    (bench_root / "portbench" / "reference" / "ba_lm_reversed.py").write_text(REVERSED)
    cfg = dict(tiny_config(LIKE, "tiny-reversed", PROBLEM, COUNTS), reference="ba_lm_reversed",
               solved=["points", "cam_tvec", "cam_rvec"])
    add_cell(bench_root, "tiny.reversed", cfg, tiny_traffic(PROBLEM))
    cell = Cell(bench_root, "tiny.reversed")
    assert camera_params(cell.make_problem(SEED, "cpu"), cell.solved) == 6
    mine = _run(bench_root, fake_card, "tiny.reversed", 1, capsys)
    default = _run(bench_root, fake_card, f"tiny.{NAME}", 1, capsys)
    assert mine["correct"] is True and mine["check"] == default["check"]
    assert set(mine["metrics"]) == set(default["metrics"])


class _FocalRef:
    """A toy reference whose residuals also use a per-camera focal length."""

    Arith = ba_lm.Arith

    @staticmethod
    def residuals(p, ar):
        X = p["points"][p["obs_pt"]]
        return p["cam_focal"][p["obs_cam"], None] * X[:, :2] / X[:, 2:] - p["obs_uv"]


def test_compare_judges_every_solved_field():
    g = torch.Generator().manual_seed(5)
    C, P = 4, 6
    obs_cam, obs_pt = torch.arange(12) % C, torch.arange(12) % P
    points = torch.rand(P, 3, generator=g) + torch.tensor([0.0, 0.0, 2.0])
    start, solved = torch.ones(C), torch.full((C,), 1.25)
    X = points[obs_pt]
    inputs = {"cam_focal": start, "points": points, "obs_cam": obs_cam, "obs_pt": obs_pt,
              "obs_uv": solved[obs_cam, None] * X[:, :2] / X[:, 2:]}
    ref_out = (solved, points, torch.tensor(0.5))
    fields = ("cam_focal", "points")
    at_start = check.compare(inputs, [(start, points, 0.5)], ref_out, _FocalRef, fields)
    at_solved = check.compare(inputs, [(solved, points, 0.5)], ref_out, _FocalRef, fields)
    assert at_start["residual_gap"] > 0.1 and at_start["cost_gap"] == 0.0
    assert at_solved == {"cost_gap": 0.0, "residual_gap": 0.0}
    cams = {"cam_rvec": torch.zeros(C, 3), "cam_tvec": torch.zeros(C, 3), "cam_focal": start}
    assert camera_params(cams, ("cam_rvec", "cam_tvec", "cam_focal", "points")) == 7


def test_traced_run_records_the_program(bench_root, fake_card, capsys):
    (bench_root / "portbench" / "metrics" / "lm_steps_seen.py").write_text(LM_STEPS_READER)
    bench = json.loads((bench_root / "BENCHMARK.json").read_text())
    cell = f"tiny.{NAME}"
    bench["per_layer"].append({"name": "lm_steps_seen", "unit": "steps", "better": "higher", "source": "program_counter",
                               "layer": "LM update", "moves": "ba_solve_s", "workloads": [cell]})
    (bench_root / "BENCHMARK.json").write_text(json.dumps(bench))
    tr = Cell(bench_root, cell).traffic
    line = _run(bench_root, fake_card, cell, 1, capsys)
    assert line["correct"] is True
    assert line["metrics"]["lm_steps_seen"]["value"] == tr["lm_iters"] * tr["trace_solves"] == 20
    assert "lm_steps_seen" not in _run(bench_root, fake_card, cell, 0, capsys)["metrics"]


def test_readings_of_a_tiny_cell(bench_root, fake_card, capsys):
    from portbench.readings import readings

    cell = Cell(bench_root, f"tiny.{NAME}")
    (row,) = readings(cell, [SEED], 1, True, fake_card)
    capsys.readouterr()
    limits = cell.traffic["limits"]
    assert check.judge(row["program"], limits)[0]
    for name in ("control", *FAULTS):
        assert not check.judge(row[name], limits)[0], name
