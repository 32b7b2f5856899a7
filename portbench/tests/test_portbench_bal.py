"""BAL's 9-parameter cameras in the harness, added as files and entries
alone: a tiny cell of the Venice configuration (its own generator,
reference and solved fields) run with the stand-in card; the three new
readers on hand-made records; the generator's counts, tracks and
geometry; and the benchmark's reference against the tests' copy."""

import importlib.util
import json

import numpy as np
import pytest
import torch

from conftest import REPO, add_cell
from portbench import generate_bal, run
from portbench.faults import FAULTS
from portbench.generate import track_lengths
from portbench.reference import ba_bal

opencv_ba = pytest.importorskip("opencv_tpu_torch.optim.ba")
SEED = 2**31 + 977
VENICE = json.loads((REPO / "portbench" / "configs" / "bal-venice-1778.json").read_text())
TINY_COUNTS = {"cameras": 60, "points": 2000, "observations": 10060}
# Over 10 seeds and two scenes on the CPU the program reads at most 4.8e-7
# (cost) and 1.4e-3 px (residual); the control at least 1.5e-2 and 0.83 px.
TINY_BAL_LIMITS = {"cost_gap": 1e-4, "residual_gap": 2e-2}


def _tiny_config(name="tiny-venice"):
    return dict(VENICE, name=name, problems={"tiny": TINY_COUNTS})


def _tiny_traffic():
    tr = json.loads((REPO / "portbench" / "traffic" / "venice.global-ba.json").read_text())
    return dict(tr, problem="tiny", trace_solves=2, layer_reps=2, limits=TINY_BAL_LIMITS)


@pytest.fixture
def bal_root(bench_root):
    add_cell(bench_root, "tiny.venice", _tiny_config(), _tiny_traffic())
    bench = json.loads((bench_root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in ("cg_roofline_bal", "jac_span_ms", "cg_global_pass_pct"):
            m["workloads"].append("tiny.venice")
    (bench_root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench_root


def _run(root, card, trace, capsys):
    rc = run.main(["--workload", "tiny.venice", "--seed", str(SEED), "--seconds", "1", "--trace", str(trace)],
                  root=root, card=card)
    out, _ = capsys.readouterr()
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_venice_cell_is_correct(bal_root, fake_card, trace, capsys):
    cell = run.Cell(bal_root, "tiny.venice")
    assert cell.solved == ("cam_rvec", "cam_tvec", "cam_intr", "points")
    assert run.camera_params(cell.make_problem(SEED, "cpu"), cell.solved) == 9
    line = _run(bal_root, fake_card, trace, capsys)
    assert line["correct"] is True and line["failed"] == 0, line
    if trace:
        # off the card the spans carry no device times: the span reader reads nothing
        assert "cg_roofline_bal" in line["metrics"] and "jac_span_ms" not in line["metrics"]
    else:
        assert set(line["metrics"]) == {"ba_solve_s", "setup_s"}


def test_readings_of_the_tiny_venice_cell(bal_root, fake_card, capsys):
    from portbench.check import judge
    from portbench.readings import readings

    cell = run.Cell(bal_root, "tiny.venice")
    (row,) = readings(cell, [SEED], 1, True, fake_card)
    capsys.readouterr()
    assert judge(row["program"], TINY_BAL_LIMITS)[0], row
    for name in ("control", *FAULTS):
        assert not judge(row[name], TINY_BAL_LIMITS)[0], (name, row[name])


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(i, name, ms):
    return {"id": i, "parent": None, "name": name, "device_ms": ms, "start_ns": i, "end_ns": i + 1}


def test_readers_on_hand_made_records():
    jac, glob, roof = _reader("jac_span_ms"), _reader("cg_global_pass_pct"), _reader("cg_roofline_bal")
    program = {"spans": [_span(0, "ba.jac", 30.0), _span(1, "ba.jac", 50.0), _span(2, "ba.normal_eq", 90.0)],
               "counters": {"ba.lm_steps": 2, "ba.cg.pass.global": 124, "ba.cg.pass.smem": 0, "ba.lm_accepted": 2}}
    assert jac({"program": program}) == 40.0
    assert glob({"program": program}) == 100.0
    mixed = dict(program, counters={"ba.lm_steps": 2, "ba.cg.pass.global": 31, "ba.cg.pass.smem": 93})
    assert glob({"program": mixed}) == 25.0
    shapes = {"cg_iters": 60, "observations": 5_001_946, "camera_params": 9}
    got = roof({"spans": {"schur_cg_solve": 20.0}, "shapes": shapes, "kind": "NVIDIA H100 80GB HBM3"})
    assert got == pytest.approx(100.0 * 60 * 5_001_946 * 124 / 3.35e12 / 20e-3)
    # inputs missing: no record, spans without device times, no passes, no replica
    untimed = dict(program, spans=[dict(s, device_ms=None) for s in program["spans"]])
    assert jac({}) is None and jac({"program": untimed}) is None
    assert jac({"program": dict(program, spans=[_span(0, "ba.normal_eq", 1.0)])}) is None
    assert glob({}) is None and glob({"program": dict(program, counters={"ba.lm_steps": 2})}) is None
    assert roof({"shapes": shapes, "kind": "NVIDIA H100 80GB HBM3"}) is None


def test_venice_counts_and_tracks():
    c = VENICE["problems"]["venice"]
    assert (c["cameras"], c["points"], c["observations"]) == (1778, 993_923, 5_001_946)
    L = track_lengths(c["points"], c["observations"], VENICE["tracks"]["min_views"], c["cameras"])
    assert len(L) == c["points"] and L.sum() == c["observations"] and L.min() == 2
    assert abs(L.mean() - 5.03) < 0.005 and L.max() < c["cameras"]


def _tiny(seed):
    cfg = _tiny_config()
    return cfg, generate_bal.make_problem(cfg, {"problem": "tiny"}, seed, "cpu")


def test_generated_problem_keeps_the_geometry():
    cfg, p = _tiny(SEED)
    C, P, O = TINY_COUNTS["cameras"], TINY_COUNTS["points"], TINY_COUNTS["observations"]
    assert p["cam_intr"].shape == (C, 3) and p["obs_uv"].shape == (O, 2) and p["points"].shape == (P, 3)
    assert not bool(p["fixed_cams"].any())  # Ceres's bundle_adjuster holds no camera constant
    assert bool((p["cam_intr"][:, 1:] == 0).all())  # Bundler's start: no distortion
    views = torch.bincount(p["obs_pt"], minlength=P)
    assert views.sum() == O and views.min() >= 2
    pairs = p["obs_pt"] * C + p["obs_cam"]
    assert pairs.unique().numel() == O  # a point's cameras are distinct
    # every observation in front of its camera and inside the image, at the start
    R = ba_bal.rodrigues(p["cam_rvec"].double(), ba_bal.Arith())
    pix, z = generate_bal.bal_pixels(R[p["obs_cam"]], p["cam_tvec"].double()[p["obs_cam"]],
                                     p["cam_intr"].double()[p["obs_cam"]], p["points"].double()[p["obs_pt"]])
    assert float(z.max()) < -cfg["layout"]["near"]
    img = cfg["image"]
    assert float(p["obs_uv"][:, 0].abs().max()) <= img["width"] / 2 and float(p["obs_uv"][:, 1].abs().max()) <= img["height"] / 2
    # rays that meet at the least parallax, from the start's centres (within 0.1 m of the true ones)
    centres = -torch.einsum("cji,cj->ci", R, p["cam_tvec"].double())
    ray = p["points"].double()[p["obs_pt"]] - centres[p["obs_cam"]]
    ray = ray / ray.norm(dim=1, keepdim=True)
    first = (torch.cumsum(views, 0) - views)[p["obs_pt"]]
    cos_min = torch.ones(P, dtype=torch.float64).scatter_reduce_(0, p["obs_pt"], (ray * ray[first]).sum(1), "amin")
    assert float(torch.rad2deg(torch.acos(cos_min)).min()) > 0.9 * cfg["layout"]["min_parallax_deg"]
    # uneven, heavy-tailed views a camera
    per_cam = torch.bincount(p["obs_cam"], minlength=C).double()
    med = float(per_cam.median())
    assert float(per_cam.max()) > 3 * med and float(per_cam.min()) < med / 3


def test_seed_decides_the_noise_and_start_not_the_scene():
    _, a = _tiny(5)
    _, b = _tiny(5)
    _, d = _tiny(6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    for k in ("obs_uv", "cam_rvec", "cam_tvec", "cam_intr", "points"):
        assert not torch.equal(a[k], d[k]), k
    for k in ("obs_cam", "obs_pt", "obs_valid", "fixed_cams"):  # the same work, observation by observation
        assert torch.equal(a[k], d[k]), k
    assert float((a["obs_uv"] - d["obs_uv"]).abs().max()) < 10.0  # the same scene, other noise


def test_rvec_of_inverts_rodrigues():
    g = torch.Generator().manual_seed(3)
    R = torch.linalg.qr(torch.randn(500, 3, 3, generator=g, dtype=torch.float64))[0]
    R = R * torch.linalg.det(R).sign()[:, None, None]
    v = generate_bal.rvec_of(R)
    assert float(v.norm(dim=1).max()) <= np.pi + 1e-12
    assert float((ba_bal.rodrigues(v, ba_bal.Arith()) - R).abs().max()) < 1e-12

