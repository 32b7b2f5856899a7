"""Engine geometry of the PyTorch port against the JAX package on the CPU.

RANSAC draws its subsets from `jax.random` in JAX and from a
`torch.Generator` in the port, so the stage tests draw them once with
the JAX package's own `_sample_subsets(key, ...)` and inject them into
the port: the JAX function, called with the same key and adaptive=False,
scores exactly those subsets. Both sides then run the same hypotheses
through the same f32 arithmetic in another operation order, so poses
and models are held to stated tolerances (a few 1e-5 on unit-scale
quantities, the f32 rounding of Gauss-Newton and SVD polishes), inlier
sets to exact or near-exact agreement.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from opencv_tpu.core.config import RansacConfig as JRansacConfig
from opencv_tpu.geometry import decompose as jdec
from opencv_tpu.geometry import epipolar as jepi
from opencv_tpu.geometry import homography as jhom
from opencv_tpu.geometry import p3p as jp3p
from opencv_tpu.geometry import pnp as jpnp
from opencv_tpu.geometry import ransac as jransac
from opencv_tpu.geometry import rotation as jrot
from opencv_tpu.optim import pose_graph as jpg
from opencv_tpu.slam import loop_closure as jlc
from opencv_tpu_torch.core.config import RansacConfig
from opencv_tpu_torch.geometry import decompose as tdec
from opencv_tpu_torch.geometry import epipolar as tepi
from opencv_tpu_torch.geometry import homography as thom
from opencv_tpu_torch.geometry import p3p as tp3p
from opencv_tpu_torch.geometry import pnp as tpnp
from opencv_tpu_torch.geometry import ransac as transac
from opencv_tpu_torch.geometry import rotation as trot
from opencv_tpu_torch.optim import pose_graph as tpg
from opencv_tpu_torch.slam import loop_closure as tlc

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

R_TRUE = np.array([0.05, -0.12, 0.03], np.float32)
T_TRUE = np.array([0.4, -0.1, 0.15], np.float32)


def T(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def J(x):
    return jnp.asarray(np.asarray(x))


def _rot(rvec):
    return np.asarray(jrot.rodrigues(jnp.asarray(rvec, jnp.float32)))


def _project(X, rvec, tvec):
    pc = X @ _rot(rvec).T + tvec
    return (pc[:, :2] / pc[:, 2:3]).astype(np.float32)


def _pnp_data(rng, n=200, outliers=0.3, noise=5e-4):
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 8, n)], 1)
    X = X.astype(np.float32)
    img = _project(X, R_TRUE, T_TRUE) + rng.normal(0, noise, (n, 2)).astype(np.float32)
    bad = rng.random(n) < outliers
    img[bad] = rng.uniform(-0.4, 0.4, (bad.sum(), 2)).astype(np.float32)
    valid = rng.random(n) > 0.05
    return X, img, valid


def _jax_subsets(seed, n, valid, h, s):
    key = jax.random.PRNGKey(seed)
    sub = jransac._sample_subsets(key, n, jnp.asarray(valid), h, s)
    return key, torch.from_numpy(np.asarray(sub).astype(np.int64))


# ------------------------------------------------------------ rotations


def test_rotation_maps_equal_jax(rng):
    rv = rng.normal(0, 1.0, (64, 3)).astype(np.float32)
    rv[0] = 0.0
    rv[1] = [1e-5, -2e-5, 0.0]
    rv[2] = [np.pi - 1e-4, 0.0, 0.0]  # near-pi branch of the log map
    Rj = np.asarray(jax.vmap(jrot.rodrigues)(J(rv)))
    Rt = trot.rodrigues(T(rv)).numpy()
    np.testing.assert_allclose(Rt, Rj, atol=2e-6)
    back_j = np.asarray(jax.vmap(jrot.rodrigues_inv)(J(Rj)))
    back_t = trot.rodrigues_inv(T(Rj)).numpy()
    np.testing.assert_allclose(back_t, back_j, atol=2e-5)
    M = rng.normal(0, 1.0, (64, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        trot.project_to_rotation(T(M)).numpy(),
        np.asarray(jax.vmap(jrot.project_to_rotation)(J(M))), atol=2e-5)


def test_rodrigues_jacobian_equals_jacfwd(rng):
    rv = rng.normal(0, 0.7, (16, 3)).astype(np.float32)
    rv[0] = 0.0  # the guarded small-angle branch
    want = np.asarray(jax.jit(jax.vmap(jax.jacfwd(jrot.rodrigues)))(J(rv)))
    np.testing.assert_allclose(trot.rodrigues_jacobian(T(rv)).numpy(), want, atol=2e-6)


# ------------------------------------------------------------ PnP


def test_gn_refine_jacobian_equals_jacfwd(rng):
    X, img, _ = _pnp_data(rng, n=12, outliers=0.0)
    params = T(np.concatenate([R_TRUE + 0.01, T_TRUE - 0.02]))
    w = T(rng.uniform(0.5, 1.0, 12).astype(np.float32))

    def res(p):
        return tpnp._residuals_and_jacobian(p, T(X), T(img), w)[0]

    _, Jc = tpnp._residuals_and_jacobian(params, T(X), T(img), w)
    np.testing.assert_allclose(Jc.numpy(), torch.func.jacfwd(res)(params).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_gn_refine_pose_equals_jax(rng):
    X, img, _ = _pnp_data(rng, n=60, outliers=0.0)
    w = (rng.random(60) > 0.2).astype(np.float32)
    r0, t0 = R_TRUE + 0.03, T_TRUE + np.float32(0.05)
    rj, tj = jpnp.gn_refine_pose(J(r0), J(t0), J(X), J(img), J(w), 10)
    rt, tt = tpnp.gn_refine_pose(T(r0), T(t0), T(X), T(img), T(w), 10)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=2e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=2e-5)


def test_p3p_kernel_equals_jax_on_inlier_samples(rng):
    X, img, _ = _pnp_data(rng, n=120, outliers=0.0, noise=0.0)
    idx = np.stack([rng.choice(120, 4, replace=False) for _ in range(64)])
    mj, okj = jax.jit(jax.vmap(jp3p.p3p_kernel))(J(X[idx]), J(img[idx]))
    mt, okt = tp3p.p3p_kernel(T(X[idx]), T(img[idx]))
    # `ok` is a knife edge on ill-conditioned samples (a Durand-Kerner root
    # near the realness bound): measured 1 of 64 apart
    both = np.asarray(okj) & okt.numpy()
    assert both.mean() > 0.9
    # noise-free samples: both recover the true pose to f32 rounding
    # (Durand-Kerner on a scaled quartic + 3 GN steps)
    np.testing.assert_allclose(mt.numpy()[both], np.asarray(mj)[both], atol=1e-4)


def test_solve_pnp_ransac_with_jax_subsets(rng):
    X, img, valid = _pnp_data(rng)
    cfg = dict(n_hypotheses=128, threshold=3e-3)
    key, sub = _jax_subsets(3, X.shape[0], valid, 128, 4)
    rj = jax.jit(functools.partial(jpnp.solve_pnp_ransac, cfg=JRansacConfig(**cfg),
                                   adaptive=False))(key, J(X), J(img), J(valid))
    rt = tpnp.solve_pnp_ransac(None, T(X), T(img), T(valid), cfg=RansacConfig(**cfg),
                               adaptive=False, subsets=sub)
    assert bool(rt.ok) and bool(rj.ok)
    np.testing.assert_allclose(rt.rvec.numpy(), np.asarray(rj.rvec), atol=5e-5)
    np.testing.assert_allclose(rt.tvec.numpy(), np.asarray(rj.tvec), atol=5e-5)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    np.testing.assert_allclose(rt.rvec.numpy(), R_TRUE, atol=2e-3)


def test_ransac_adaptive_and_fixed_find_the_pose(rng):
    X, img, valid = _pnp_data(rng, outliers=0.2)
    gen = torch.Generator().manual_seed(0)
    for adaptive in (True, False):
        res = tpnp.solve_pnp_ransac(gen, T(X), T(img), T(valid), adaptive=adaptive,
                                    cfg=RansacConfig(n_hypotheses=256, threshold=3e-3))
        assert bool(res.ok)
        np.testing.assert_allclose(res.rvec.numpy(), R_TRUE, atol=2e-3)
        np.testing.assert_allclose(res.tvec.numpy(), T_TRUE, atol=1e-2)


def test_sample_subsets_distinct_and_valid():
    valid = torch.rand(50, generator=torch.Generator().manual_seed(1)) > 0.3
    sub = transac.sample_subsets(torch.Generator().manual_seed(2), 50, valid, 200, 8)
    assert sub.shape == (200, 8)
    assert bool(valid[sub].all())
    assert all(len(set(r.tolist())) == 8 for r in sub)


# ------------------------------------------------------------ two-view


def _two_view(rng, n=300, outliers=0.2, noise=3e-4, planar=False):
    x = rng.uniform(-1.5, 1.5, n)
    y = rng.uniform(-1.0, 1.0, n)
    z = 6.0 + 0.2 * x if planar else rng.uniform(4, 9, n)
    X = np.stack([x, y, z], 1).astype(np.float32)
    x1 = _project(X, np.zeros(3, np.float32), np.zeros(3, np.float32))
    x2 = _project(X, R_TRUE, T_TRUE)
    x1 += rng.normal(0, noise, x1.shape).astype(np.float32)
    x2 += rng.normal(0, noise, x2.shape).astype(np.float32)
    bad = rng.random(n) < outliers
    x2[bad] = rng.uniform(-0.4, 0.4, (bad.sum(), 2)).astype(np.float32)
    return x1, x2, rng.random(n) > 0.05


def _same_up_to_sign(a, b, atol):
    err = min(np.abs(a - b).max(), np.abs(a + b).max())
    assert err < atol, err


def test_eight_point_and_triangulation_equal_jax(rng):
    x1, x2, _ = _two_view(rng, outliers=0.0)
    idx = np.stack([rng.choice(300, 8, replace=False) for _ in range(32)])
    Ej, okj = jax.jit(jax.vmap(functools.partial(jepi.eight_point, essential=True)))(
        J(x1[idx]), J(x2[idx]))
    Et, okt = tepi.eight_point(T(x1[idx]), T(x2[idx]), essential=True)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    for a, b in zip(Et.numpy(), np.asarray(Ej)):
        _same_up_to_sign(a, b, 1e-3)  # minimal samples: QR nullspace, f32
    w = (rng.random(300) > 0.3).astype(np.float32)
    Ej, _ = jepi.eight_point(J(x1), J(x2), essential=True, weights=J(w))
    Et, _ = tepi.eight_point(T(x1), T(x2), essential=True, weights=T(w))
    _same_up_to_sign(Et.numpy(), np.asarray(Ej), 1e-4)
    R = _rot(R_TRUE)
    Xj = np.asarray(jepi.triangulate_normalized(J(R), J(T_TRUE), J(x1), J(x2)))
    Xt = tepi.triangulate_normalized(T(R), T(T_TRUE), T(x1), T(x2)).numpy()
    np.testing.assert_allclose(Xt, Xj, rtol=1e-4, atol=1e-4)


def test_find_essential_ransac_with_jax_subsets(rng):
    """In f64 both packages run the same arithmetic, so E, inliers and
    the recovered pose agree to rounding. In f32 they part: the RANSAC
    winner and the IRLS refits still agree to ~2e-6, but the Sampson
    polish's normal matrix is singular along vec(E) (the residual ignores
    scale) and damped by only 1e-8, so the LU solves amplify f32 rounding
    (measured on this data: final E 1.4e-3 apart, 106 vs 201 inliers).
    The f32 run is therefore held against the true pose."""
    x1, x2, valid = _two_view(rng)
    cfg = dict(n_hypotheses=128, threshold=1e-3)
    f64 = np.float64
    with jax.enable_x64(True):
        key, sub64 = _jax_subsets(5, 300, valid, 128, 8)
        ej = jax.jit(functools.partial(jepi.find_essential_ransac, cfg=JRansacConfig(**cfg),
                                       adaptive=False))(key, J(x1.astype(f64)),
                                                        J(x2.astype(f64)), J(valid))
        pj = jepi.recover_pose(ej.model, J(x1.astype(f64)), J(x2.astype(f64)), ej.inliers)
        E_j, inl_j, R_j, t_j = (np.asarray(a) for a in (ej.model, ej.inliers, pj.R, pj.t))
    a1, a2 = T(x1, torch.float64), T(x2, torch.float64)
    et = tepi.find_essential_ransac(None, a1, a2, T(valid), cfg=RansacConfig(**cfg),
                                    adaptive=False, subsets=sub64)
    pt = tepi.recover_pose(et.model, a1, a2, et.inliers)
    assert bool(et.ok) and bool(ej.ok)
    _same_up_to_sign(et.model.numpy(), E_j, 1e-9)
    np.testing.assert_array_equal(et.inliers.numpy(), inl_j)
    np.testing.assert_allclose(pt.R.numpy(), R_j, atol=1e-9)
    np.testing.assert_allclose(pt.t.numpy(), t_j, atol=1e-9)

    _, sub = _jax_subsets(5, 300, valid, 128, 8)
    e32 = tepi.find_essential_ransac(None, T(x1), T(x2), T(valid), cfg=RansacConfig(**cfg),
                                     adaptive=False, subsets=sub)
    p32 = tepi.recover_pose(e32.model, T(x1), T(x2), e32.inliers)
    # 128 eight-point hypotheses at this noise: measured 7.5e-3 (R) and
    # 5.3e-2 (unit t) from the truth
    np.testing.assert_allclose(p32.R.numpy(), _rot(R_TRUE), atol=2e-2)
    np.testing.assert_allclose(p32.t.numpy(), T_TRUE / np.linalg.norm(T_TRUE), atol=0.1)


def test_homography_ransac_and_decomposition_equal_jax(rng):
    x1, x2, valid = _two_view(rng, planar=True)
    cfg = dict(n_hypotheses=128, threshold=2e-3)
    key, sub = _jax_subsets(9, 300, valid, 128, 4)
    hj = jax.jit(functools.partial(jhom.find_homography_ransac,
                                   cfg=JRansacConfig(**cfg)))(key, J(x1), J(x2), J(valid))
    ht = thom.find_homography_ransac(None, T(x1), T(x2), T(valid), cfg=RansacConfig(**cfg),
                                     subsets=sub)
    assert bool(ht.ok) and bool(hj.ok)
    np.testing.assert_allclose(ht.model.numpy(), np.asarray(hj.model), atol=1e-4)
    np.testing.assert_array_equal(ht.inliers.numpy(), np.asarray(hj.inliers))
    # decomposition: the same four candidates, up to order (eigh signs)
    dj = jdec.decompose_homography(hj.model, jnp.eye(3))
    dt = tdec.decompose_homography(ht.model, torch.eye(3))
    Rj, tj = np.asarray(dj.R), np.asarray(dj.t)
    for R, t in zip(dt.R.numpy(), dt.t.numpy()):
        d = [np.abs(R - a).max() + np.abs(t - b).max() for a, b in zip(Rj, tj)]
        assert min(d) < 2e-4, d


# ------------------------------------------------------------ pose graph


def _chain(rng, k=10):
    rv = (np.cumsum(rng.normal(0, 0.05, (k, 3)), 0)).astype(np.float32)
    tv = (np.cumsum(rng.normal(0, 0.3, (k, 3)), 0)).astype(np.float32)
    rv[0] = 0.0
    tv[0] = 0.0
    return rv, tv


def test_pose_graph_optimize_equals_jax(rng):
    rv, tv = _chain(rng)
    k = rv.shape[0]
    noisy_rv = rv + rng.normal(0, 0.02, rv.shape).astype(np.float32)
    noisy_tv = tv + rng.normal(0, 0.05, tv.shape).astype(np.float32)
    noisy_rv[0] = 0.0
    noisy_tv[0] = 0.0
    ei = np.array(list(range(k - 1)) + [0, 2])
    ej = np.array(list(range(1, k)) + [k - 1, 7])
    rr, tt = jax.vmap(jpg.relative_pose)(J(rv[ei]), J(tv[ei]), J(rv[ej]), J(tv[ej]))
    meas = np.concatenate([np.asarray(rr), np.asarray(tt)], 1).astype(np.float32)
    wts = np.ones(len(ei), np.float32)
    fixed = np.zeros(k, bool)
    fixed[0] = True
    gj = jpg.PoseGraph(J(noisy_rv), J(noisy_tv), J(ei.astype(np.int32)), J(ej.astype(np.int32)),
                       J(meas), J(wts), J(fixed))
    gt = tpg.PoseGraph(T(noisy_rv), T(noisy_tv), T(ei), T(ej), T(meas), T(wts), T(fixed))
    oj, cj = jax.jit(jpg.optimize, static_argnums=1)(gj, 10)
    ot, ct = tpg.optimize(gt, iters=10)
    np.testing.assert_allclose(ot.rvec.numpy(), np.asarray(oj.rvec), atol=5e-5)
    np.testing.assert_allclose(ot.tvec.numpy(), np.asarray(oj.tvec), atol=5e-5)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-3, atol=1e-9)


def test_correct_poses_equals_jax(rng):
    rv, tv = _chain(rng, 12)
    drift_rv = rv + np.linspace(0, 0.05, 12)[:, None].astype(np.float32)
    drift_tv = tv + np.linspace(0, 0.4, 12)[:, None].astype(np.float32)
    loop = jlc.relative_from_world_poses(rv[1], tv[1], rv[11], tv[11])
    loop_t = tlc.relative_from_world_poses(rv[1], tv[1], rv[11], tv[11], device="cpu")
    np.testing.assert_allclose(loop_t[0], loop[0], atol=1e-6)
    np.testing.assert_allclose(loop_t[1], loop[1], atol=1e-6)
    nj = jlc.correct_poses(drift_rv, drift_tv, 1, 11, loop)
    nt = tlc.correct_poses(drift_rv, drift_tv, 1, 11, loop, device="cpu")
    # 20 LM steps in f32 on positions of order 1: measured 1.1e-4 apart
    np.testing.assert_allclose(nt[0], nj[0], atol=2e-4)
    np.testing.assert_allclose(nt[1], nj[1], atol=2e-4)


def test_retrieve_candidates_equals_jax(rng):
    db = rng.integers(0, 2 ** 32, size=(8, 64, 8), dtype=np.uint64).astype(np.uint32)
    dbv = rng.random((8, 64)) > 0.1
    q = db[3].copy()
    q[:, 0] ^= np.uint32(1)
    qv = np.ones(64, bool)
    cj = jlc.retrieve_candidates(q, qv, db, dbv, exclude_recent=2, min_votes=10)
    ct = tlc.retrieve_candidates(q, qv, db, dbv, exclude_recent=2, min_votes=10, device="cpu")
    assert [tuple(c) for c in ct] == [tuple(c) for c in cj]
    assert ct[0].kf_index == 3
