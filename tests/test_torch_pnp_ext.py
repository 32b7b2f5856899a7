"""EPnP, DLT-PnP, AP3P, VVS refinement, EPnP/DLT RANSAC, IPPE and optimal
match correction of the PyTorch port against the JAX package on the CPU.

Eigenvector signs may differ between the LAPACK builds of the two
packages; every solver reads them sign-invariantly, and AP3P's up to four
candidates agree as a set. RANSAC runs on the subsets JAX drew (injected
into the port).

EPnP: the JAX solver works in f32, where the eigenvectors of its Gram
matrix M^T M carry M's condition number squared: on these scenes (6 to
200 points, noise-free or with 5e-4 noise) its pose sits up to 3e-4 rad
and 3e-3 in t from the same algorithm in f64, and where two of the four
candidates reproject almost equally well it may pick the other one
(measured: 8e-3 in t_z on 8 noisy points). The port computes in f64. Its
pose also depends on which side of the centroid each control point lies,
that is on the signs of the principal axes, which the JAX package leaves
to its eigensolver (torch's and JAX's CPU eigh agree in sign on 88 % of
random 3x3 matrices, cuSOLVER otherwise again); the port fixes them. So
the control points are compared up to those signs, and the rest of the
solver runs on JAX's control points: poses to 5e-4 rad and 1e-2 in t
(|t| ~ 0.43), reprojecting no worse than JAX's, from 8 points up (on 32
scenes of 8 to 60 points the largest gaps were 9.3e-5 rad and 4.9e-4;
at 6 coplanar points the f32 and f64 solvers picked different candidates
once, 1.6e-2 rad apart). The other solvers: 1e-4 or tighter.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.core.config import RansacConfig as JRansacConfig
from opencv_tpu.geometry import ap3p as jap3p
from opencv_tpu.geometry import epipolar as jepi
from opencv_tpu.geometry import epnp as jepnp
from opencv_tpu.geometry import ippe as jippe
from opencv_tpu.geometry import pnp as jpnp
from opencv_tpu.geometry import ransac as jransac
from opencv_tpu.geometry import rotation as jrot
from opencv_tpu_torch.core.config import RansacConfig
from opencv_tpu_torch.geometry import ap3p as tap3p
from opencv_tpu_torch.geometry import epipolar as tepi
from opencv_tpu_torch.geometry import epnp as tepnp
from opencv_tpu_torch.geometry import ippe as tippe
from opencv_tpu_torch.geometry import pnp as tpnp

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

R_TRUE = np.array([0.05, -0.12, 0.03], np.float32)
T_TRUE = np.array([0.4, -0.1, 0.15], np.float32)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def J(x):
    return jnp.asarray(np.asarray(x))


def _project(X, rvec, tvec):
    pc = X @ np.asarray(jrot.rodrigues(J(rvec))).T + tvec
    return (pc[:, :2] / pc[:, 2:3]).astype(np.float32)


def _scene(rng, n, noise=5e-4, planar=False, outliers=0.0):
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 8, n)], 1)
    if planar:
        X[:, 2] = 6.0 + 0.3 * X[:, 0] - 0.2 * X[:, 1]
    X = X.astype(np.float32)
    img = _project(X, R_TRUE, T_TRUE) + rng.normal(0, noise, (n, 2)).astype(np.float32)
    bad = rng.random(n) < outliers
    img[bad] = rng.uniform(-0.4, 0.4, (bad.sum(), 2)).astype(np.float32)
    return X, img


@pytest.mark.parametrize("planar", [False, True], ids=["general", "planar"])
def test_epnp_equals_jax(rng, planar, monkeypatch):
    for n in (8, 30, 60):
        X, img = _scene(rng, n, planar=planar)
        cj = np.asarray(jepnp._control_points(J(X)))
        ct = tepnp._control_points(T(X)).numpy()
        np.testing.assert_allclose(ct[0], cj[0], atol=1e-6)  # the centroid
        np.testing.assert_allclose(np.abs(ct[1:] - ct[0]), np.abs(cj[1:] - cj[0]), atol=1e-4)
        monkeypatch.setattr(tepnp, "_control_points", lambda obj, cj=cj: torch.tensor(cj).to(obj))
        rj, tj, okj = jepnp.epnp(J(X), J(img))
        rt, tt, okt = tepnp.epnp(T(X), T(img))
        monkeypatch.undo()
        assert bool(okj) and bool(okt)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=5e-4)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-2)
        np.testing.assert_allclose(rt.numpy(), R_TRUE, atol=2e-2)
        ej, et = (np.mean((_project(X, r, t) - img) ** 2) for r, t in ((np.asarray(rj), np.asarray(tj)),
                                                                      (rt.numpy(), tt.numpy())))
        assert et <= 1.1 * ej + 1e-9  # the port's pick reprojects no worse


def test_epnp_ignores_eigenvector_signs(rng, monkeypatch):
    """Eigenvectors with every other sign flipped (as another eigensolver
    may return them) give the same poses: the card and the CPU agree."""
    X, img = _scene(rng, 200)
    idx = np.stack([rng.choice(200, 8, replace=False) for _ in range(64)])
    want, _ = tepnp.epnp_kernel(T(X)[idx], T(img)[idx])
    eigh = torch.linalg.eigh

    def flipped(S):
        w, v = eigh(S)
        return w, v * torch.tensor([-1.0, 1.0] * 6, dtype=v.dtype)[: v.shape[-1]]

    monkeypatch.setattr(torch.linalg, "eigh", flipped)
    got, _ = tepnp.epnp_kernel(T(X)[idx], T(img)[idx])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_epnp_batched_equals_single(rng):
    X, img = _scene(rng, 40)
    idx = np.stack([rng.choice(40, 8, replace=False) for _ in range(6)])
    mb, okb = tepnp.epnp_kernel(T(X)[idx], T(img)[idx])
    for i in range(6):
        m1, ok1 = tepnp.epnp_kernel(T(X[idx[i]]), T(img[idx[i]]))
        assert bool(ok1) == bool(okb[i])
        # batched and single eigh take other LAPACK paths: f32 spread
        np.testing.assert_allclose(mb[i].numpy(), m1.numpy(), atol=5e-4)


def test_dlt_pnp_equals_jax(rng):
    X, img = _scene(rng, 30)
    rj, tj, okj = jpnp.dlt_pnp(J(X), J(img))
    rt, tt, okt = tpnp.dlt_pnp(T(X), T(img))
    assert bool(okj) and bool(okt)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)


def test_ap3p_solutions_and_kernel_equal_jax(rng):
    X, img = _scene(rng, 40, noise=0.0)
    idx = np.stack([rng.choice(40, 4, replace=False) for _ in range(16)])
    rays = np.concatenate([img[idx][:, :3], np.ones((16, 3, 1), np.float32)], -1)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    Rt, tt, vt = tap3p.ap3p_solutions(T(X[idx][:, :3]), T(rays))
    Rj, tj, vj = jax.jit(jax.vmap(jap3p.ap3p_solutions))(J(X[idx][:, :3]), J(rays))
    Rj, tj, vj = np.asarray(Rj), np.asarray(tj), np.asarray(vj)
    Rt, tt, vt = Rt.numpy(), tt.numpy(), vt.numpy()
    np.testing.assert_array_equal(vt.sum(1), vj.sum(1))
    for i in range(16):
        # the same set of poses: each valid JAX pose has a port pose
        for k in np.flatnonzero(vj[i]):
            d = np.abs(tt[i] - tj[i, k]).max(-1) + np.abs(Rt[i] - Rj[i, k]).max((-1, -2))
            assert d[vt[i]].min() < 1e-4
    mj, okj = jax.jit(jax.vmap(jap3p.ap3p_kernel))(J(X[idx]), J(img[idx]))
    mt, okt = tap3p.ap3p_kernel(T(X[idx]), T(img[idx]))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-4)


def test_refine_pose_vvs_equals_jax(rng):
    X, img = _scene(rng, 50)
    w = (rng.random(50) > 0.2).astype(np.float32)
    r0, t0 = R_TRUE + 0.02, T_TRUE - np.float32(0.03)
    rj, tj = jpnp.refine_pose_vvs(J(r0), J(t0), J(X), J(img), J(w))
    rt, tt = tpnp.refine_pose_vvs(T(r0), T(t0), T(X), T(img), T(w))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)


@pytest.mark.parametrize("kernel,subset", [("epnp", 5), ("dlt", 6)])
def test_solve_pnp_ransac_kernels_with_jax_subsets(rng, kernel, subset):
    X, img = _scene(rng, 200, outliers=0.3)
    valid = rng.random(200) > 0.05
    cfg = dict(n_hypotheses=128, threshold=3e-3)
    key = jax.random.PRNGKey(5)
    sub = jransac._sample_subsets(key, 200, J(valid), 128, subset)
    rj = jax.jit(functools.partial(jpnp.solve_pnp_ransac, cfg=JRansacConfig(**cfg), kernel=kernel,
                                   adaptive=False))(key, J(X), J(img), J(valid))
    rt = tpnp.solve_pnp_ransac(None, T(X), T(img), T(valid), cfg=RansacConfig(**cfg), kernel=kernel,
                               adaptive=False, subsets=T(np.asarray(sub).astype(np.int64)))
    assert bool(rt.ok) and bool(rj.ok)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    np.testing.assert_allclose(rt.rvec.numpy(), np.asarray(rj.rvec), atol=5e-5)
    np.testing.assert_allclose(rt.tvec.numpy(), np.asarray(rj.tvec), atol=5e-5)


def test_solve_pnp_ippe_equals_jax(rng):
    obj = np.zeros((30, 3), np.float32)
    obj[:, :2] = rng.uniform(-0.5, 0.5, (30, 2))
    pc = obj @ np.asarray(jrot.rodrigues(J(np.float32([0.3, -0.2, 0.1])))).T + [0.1, 0.05, 2.0]
    img = (pc[:, :2] / pc[:, 2:3] + rng.normal(0, 1e-3, (30, 2))).astype(np.float32)
    valid = rng.random(30) > 0.1
    for o in (obj, obj[:, :2]):
        a = jippe.solve_pnp_ippe(J(o), J(img), J(valid))
        b = tippe.solve_pnp_ippe(T(o), T(img), T(valid))
        np.testing.assert_allclose(b.rvecs.numpy(), np.asarray(a.rvecs), atol=1e-4)
        np.testing.assert_allclose(b.tvecs.numpy(), np.asarray(a.tvecs), atol=1e-4)
        np.testing.assert_allclose(b.errors.numpy(), np.asarray(a.errors), rtol=1e-3, atol=1e-9)


def test_correct_matches_equals_jax(rng):
    X, x2 = _scene(rng, 64, noise=2e-3)
    x1 = (X[:, :2] / X[:, 2:3] + rng.normal(0, 2e-3, (64, 2))).astype(np.float32)
    E = np.asarray(jrot.hat(J(T_TRUE))) @ np.asarray(jrot.rodrigues(J(R_TRUE)))
    F = (E / np.linalg.norm(E)).astype(np.float32)
    aj, bj = jax.jit(jepi.correct_matches)(J(F), J(x1), J(x2))
    at, bt = tepi.correct_matches(T(F), T(x1), T(x2))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-5)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-5)
    # the corrected matches satisfy the epipolar constraint
    h = np.concatenate([at.numpy(), np.ones((64, 1), np.float32)], 1)
    g = np.concatenate([bt.numpy(), np.ones((64, 1), np.float32)], 1)
    assert np.abs(np.einsum("ni,ij,nj->n", g, F, h)).max() < 1e-5
