"""The 5-point solver and the 5-point RANSAC of the PyTorch port against
the JAX package on the CPU.

`five_point` sums its constraint polynomials in another order than the
JAX solver (einsums against 0/1 product tensors instead of scatter-adds),
and its roots come from an f32 Durand-Kerner iteration; an ill-
conditioned root amplifies the difference. So candidates are compared as
sets: every valid JAX E has a port E within 1e-3 up to sign, except at
most one candidate per sample (a root at the realness or residual knife
edge). 1e-3, not 1e-4: the JAX solver itself, jitted against eager on
the same 12 exact samples, moved 12 of 56 valid candidates by more than
1e-4 (none by more than 3e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from opencv_tpu.core.config import RansacConfig as JRansacConfig
from opencv_tpu.geometry import epipolar as jepi
from opencv_tpu.geometry import five_point as jfive
from opencv_tpu.geometry import ransac as jransac
from opencv_tpu_torch.core.config import RansacConfig
from opencv_tpu_torch.geometry import epipolar as tepi
from opencv_tpu_torch.geometry import five_point as tfive

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)
from test_geometry import make_scene


def _unmatched(Ej, vj, Et, vt, atol=1e-3):
    """Valid JAX candidates with no valid port candidate within atol up to
    sign, per sample."""
    out = []
    for s in range(Ej.shape[0]):
        port = Et[s][vt[s]]
        miss = 0
        for E in Ej[s][vj[s]]:
            d = np.minimum(np.abs(port - E).max(axis=(1, 2)), np.abs(port + E).max(axis=(1, 2)))
            miss += not (d.size and d.min() < atol)
        out.append(miss)
    return np.asarray(out)


def _samples(rng, n_samples, noise):
    x1s, x2s = [], []
    for _ in range(n_samples):
        _, x1, x2, _, _ = make_scene(rng, n=5, rot_deg=rng.uniform(2, 15))
        x1s.append(x1 + rng.normal(0, noise, x1.shape).astype(np.float32))
        x2s.append(x2)
    return np.stack(x1s), np.stack(x2s)


def test_householder_basis_equals_lapack_qr(rng):
    """The port's four nullspace columns are LAPACK's complete-QR columns
    (numpy's, the same geqrf/orgqr the JAX solver calls)."""
    from opencv_tpu_torch.geometry.epipolar import _householder_null

    A = rng.normal(size=(16, 5, 9)).astype(np.float32)
    got = _householder_null(torch.from_numpy(A), cols=4).numpy()
    for a, g in zip(A, got):
        q, _ = np.linalg.qr(a.T.astype(np.float64), mode="complete")
        np.testing.assert_allclose(g, q[:, 5:9], atol=2e-6)
        np.testing.assert_allclose(a @ g, 0.0, atol=2e-6)


def test_five_point_candidate_sets_equal_jax(rng):
    solve = jax.jit(jfive.five_point)
    for noise in (0.0, 1e-3):
        x1, x2 = _samples(rng, 8, noise)
        rj = [solve(jnp.asarray(a), jnp.asarray(b)) for a, b in zip(x1, x2)]
        rt = tfive.five_point(torch.from_numpy(x1), torch.from_numpy(x2))
        vj = np.stack([np.asarray(r.valid) for r in rj])
        vt = rt.valid.numpy()
        assert rt.E.shape == (8, 10, 3, 3) and vt.sum(1).min() > 0
        miss = _unmatched(np.stack([np.asarray(r.E) for r in rj]), vj, rt.E.numpy(), vt)
        assert miss.max() <= 1, (noise, miss)
        # the count of valid candidates flips only at those knife edges
        assert np.abs(vj.sum(1) - vt.sum(1)).max() <= 1


def test_five_point_recovers_the_true_essential_matrix(rng):
    from opencv_tpu_torch.geometry.rotation import hat

    for _ in range(5):
        _, x1, x2, R, t = make_scene(rng, n=5, rot_deg=rng.uniform(2, 15))
        res = tfive.five_point(torch.from_numpy(x1), torch.from_numpy(x2))
        Et = hat(torch.from_numpy(t)).numpy() @ R
        Et /= np.linalg.norm(Et)
        E = res.E.numpy()[res.valid.numpy()]
        best = np.minimum(np.abs(E - Et).max(axis=(1, 2)), np.abs(E + Et).max(axis=(1, 2))).min()
        assert best < 5e-3


def test_find_essential_ransac_5pt_equals_jax(rng):
    _, x1, x2, _, _ = make_scene(rng, n=300)
    n_bad = 120  # 40 % outliers
    x2 = x2.copy()
    x2[:n_bad] = rng.uniform(-0.5, 0.5, (n_bad, 2)).astype(np.float32)
    valid = np.ones(300, bool)
    key = jax.random.PRNGKey(4)
    sub = jransac._sample_subsets(key, 300, jnp.asarray(valid), 64, 5)
    rj = jepi.find_essential_ransac_5pt(key, jnp.asarray(x1), jnp.asarray(x2),
                                       cfg=JRansacConfig(n_hypotheses=64, threshold=2e-3))
    rt = tepi.find_essential_ransac_5pt(
        None, torch.from_numpy(x1), torch.from_numpy(x2),
        cfg=RansacConfig(n_hypotheses=64, threshold=2e-3),
        subsets=torch.from_numpy(np.asarray(sub).astype(np.int64)),
    )
    assert bool(rj.ok) and bool(rt.ok)
    agree = (np.asarray(rj.inliers) == rt.inliers.numpy()).mean()
    assert agree >= 0.99, agree
    Ej, Et = np.asarray(rj.model), rt.model.numpy()
    assert min(np.abs(Ej - Et).max(), np.abs(Ej + Et).max()) < 1e-3
    assert rt.inliers.numpy()[n_bad:].mean() > 0.9


def test_normalize_pixels_equals_jax(rng):
    K = np.array([[500.0, 0, 320.5], [0, 505.0, 240.25], [0, 0, 1]], np.float32)
    px = rng.uniform(0, 640, (50, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tepi.normalize_pixels(torch.from_numpy(px), torch.from_numpy(K)).numpy(),
        np.asarray(jepi.normalize_pixels(jnp.asarray(px), jnp.asarray(K))))
