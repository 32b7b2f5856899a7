"""Bundle adjustment of the PyTorch port against the JAX package on the
CPU: one `bundle_adjust` call on the same perturbed problem, through the
dense-Schur and the matrix-free CG solvers, and the closed-form
per-observation Jacobians against torch.func.jacfwd of the residual."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.geometry.rotation import rodrigues as jrodrigues
from opencv_tpu.optim import ba as jba
from opencv_tpu_torch.optim import ba as tba

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

N_CAMS, N_PTS = 5, 80


def _problem(rng, pad_cams=1):
    """N_CAMS live cameras along x (plus `pad_cams` fixed dummies without
    observations, as the engine pads its window), N_PTS points seen by
    every live camera, 1e-3 image noise, perturbed start."""
    pts = np.stack([rng.uniform(-2, 2, N_PTS), rng.uniform(-1.5, 1.5, N_PTS),
                    rng.uniform(5, 9, N_PTS)], 1).astype(np.float32)
    C = N_CAMS + pad_cams
    rv = np.zeros((C, 3), np.float32)
    tv = np.zeros((C, 3), np.float32)
    rv[:N_CAMS, 1] = np.linspace(0, 0.08, N_CAMS)
    tv[:N_CAMS, 0] = -np.linspace(0, 0.8, N_CAMS)
    cam, pt, uv = [], [], []
    for c in range(N_CAMS):
        R = np.asarray(jrodrigues(jnp.asarray(rv[c])))
        pc = pts @ R.T + tv[c]
        cam += [c] * N_PTS
        pt += list(range(N_PTS))
        uv.append(pc[:, :2] / pc[:, 2:3])
    uv = np.concatenate(uv) + rng.normal(0, 1e-3, (N_CAMS * N_PTS, 2))
    valid = rng.random(N_CAMS * N_PTS) > 0.05
    fixed = np.ones(C, bool)
    fixed[2:N_CAMS] = False  # gauge + scale: the first two cameras stay
    start_rv = rv + np.where(fixed[:, None], 0, rng.normal(0, 0.01, rv.shape)).astype(np.float32)
    start_tv = tv + np.where(fixed[:, None], 0, rng.normal(0, 0.05, tv.shape)).astype(np.float32)
    start_pts = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    return dict(cam_rvec=start_rv, cam_tvec=start_tv, points=start_pts,
                obs_cam=np.asarray(cam), obs_pt=np.asarray(pt), obs_uv=uv.astype(np.float32),
                obs_valid=valid, fixed_cams=fixed)


def _jax_problem(d):
    return jba.BAProblem(**{k: jnp.asarray(v.astype(np.int32) if k.startswith("obs_") and
                                            v.dtype.kind == "i" else v) for k, v in d.items()})


def _torch_problem(d):
    return tba.BAProblem(**{k: torch.as_tensor(v) for k, v in d.items()})


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_bundle_adjust_equals_jax(rng, solver):
    d = _problem(rng)
    huber = 3.0 / 500.0
    run = jax.jit(functools.partial(jba.bundle_adjust, iters=6, huber_delta=huber, solver=solver))
    pj, cj = run(_jax_problem(d))
    pt, ct = tba.bundle_adjust(_torch_problem(d), iters=6, huber_delta=huber, solver=solver)
    c0 = float(jba.cost(_jax_problem(d)))
    assert float(ct) < 0.1 * c0  # the solve converged, not just agreed
    # six LM steps in f32 with sums in another order: measured <= 4.2e-7
    # on cameras, 3.8e-6 on points of depth 5-9 and 1.9e-6 relative on
    # the cost; bounds at about ten times that
    np.testing.assert_allclose(float(ct), float(cj), rtol=2e-5)
    np.testing.assert_allclose(pt.cam_rvec.numpy(), np.asarray(pj.cam_rvec), atol=5e-6)
    np.testing.assert_allclose(pt.cam_tvec.numpy(), np.asarray(pj.cam_tvec), atol=5e-6)
    np.testing.assert_allclose(pt.points.numpy(), np.asarray(pj.points), atol=5e-5)
    np.testing.assert_array_equal(pt.cam_rvec.numpy()[d["fixed_cams"]],
                                  d["cam_rvec"][d["fixed_cams"]])


def test_block_jacobians_equal_jacfwd(rng):
    d = _problem(rng, pad_cams=0)
    p = _torch_problem(d)
    r, Jc, Jp = tba._blocks(p, None)

    def res(cam6, pt3):
        R = tba.rodrigues(cam6[:3])
        pc = R @ pt3 + cam6[3:]
        return pc[:2] / pc[2]

    cams = torch.cat([p.cam_rvec, p.cam_tvec], 1)[p.obs_cam]
    pts = p.points[p.obs_pt]
    jc, jp = torch.func.vmap(torch.func.jacfwd(res, argnums=(0, 1)))(cams, pts)
    w = p.obs_valid.float()[:, None, None]
    np.testing.assert_allclose(Jc.numpy(), (jc * w).numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(Jp.numpy(), (jp * w).numpy(), rtol=1e-4, atol=1e-6)


def test_solver_rule_equals_jax():
    for C, P in ((6, 2048), (64, 100000), (200, 9500)):
        shapes = dict(cam_rvec=np.zeros((C, 3)), points=np.zeros((P, 3)))
        pj = jba.BAProblem(**{f: shapes.get(f) for f in jba.BAProblem._fields})
        pt = tba.BAProblem(**{f: None for f in tba.BAProblem._fields})._replace(
            cam_rvec=torch.zeros((C, 3)), points=torch.zeros((P, 3)))
        assert tba._resolve_solver("auto", pt) == jba._resolve_solver("auto", pj)
