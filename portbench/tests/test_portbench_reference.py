"""The plain reference against the program's `bundle_adjust` at tiny
sizes on the CPU, and the control (the reference with TF32 products)
against the same limits."""

import json

import pytest
import torch

from conftest import REPO, TINY, TINY_LIMITS
from portbench import check
from portbench.generate import make_problem
from portbench.reference import ba_lm as ref

opencv_ba = pytest.importorskip("opencv_tpu_torch.optim.ba")
KW = dict(iters=10, lambda0=1e-4, huber_delta=None, cg_iters=60)
CASES = TINY


def _tiny(like, problem, counts, seed):
    cfg = json.loads((REPO / "portbench" / "configs" / f"{like}.json").read_text())
    cfg["problems"] = {problem: counts}
    return make_problem(cfg, {"problem": problem}, seed, "cpu")


@pytest.mark.parametrize("name,like,problem,counts", CASES)
@pytest.mark.parametrize("huber_px", [None, 2.4474])
def test_reference_follows_the_program(name, like, problem, counts, huber_px):
    for seed in (21, 22):
        inputs = _tiny(like, problem, counts, seed)
        kw = dict(KW, huber_delta=None if huber_px is None else huber_px / 707.0912)
        q, c = opencv_ba.bundle_adjust(opencv_ba.BAProblem(**inputs), solver="cg", **kw)
        out = ref.bundle_adjust(inputs, **kw)
        gaps = check.compare(inputs, [(q.cam_rvec, q.cam_tvec, q.points, c)], out, ref)
        assert check.judge(gaps, TINY_LIMITS)[0], gaps
        assert float(out[3]) < 0.05 * float(ref.cost(dict(inputs), ref.Arith(torch.float32)))


@pytest.mark.parametrize("name,like,problem,counts", CASES)
def test_control_is_not_correct(name, like, problem, counts):
    for seed in (21, 22, 23):
        inputs = _tiny(like, problem, counts, seed)
        out = ref.bundle_adjust(inputs, **KW)
        ctl = ref.bundle_adjust(inputs, ar=ref.Arith(torch.float32, tf32=True), **KW)
        assert not check.judge(check.compare(inputs, [ctl], out, ref), TINY_LIMITS)[0]


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-12, -3.0 - 2.0**-20])
    got = ref.Arith(torch.float32, tf32=True).round(x)
    assert got.tolist() == [1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, -3.0]


def test_rodrigues_derivative_against_autograd():
    v = torch.tensor([[0.3, -1.2, 2.9], [1e-4, 2e-4, -1e-4], [0.0, 3.1, 0.0]], dtype=torch.float64)
    ar = ref.Arith()
    R = ref.rodrigues(v, ar)
    jac = torch.func.vmap(torch.func.jacfwd(lambda w: ref.rodrigues(w[None], ar)[0]))(v)
    assert torch.allclose(ref.rodrigues_derivative(v, R, ar), jac, atol=1e-7)
