"""LSH matching, radius matching, affine/similarity and fundamental RANSAC,
loop-candidate verification and the general minimizers of the PyTorch
port against the JAX package on the CPU.

LSH and radius matching are integer Hamming work: equal exactly. The
RANSAC stages run on the subsets JAX drew, injected into the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from opencv_tpu.core.config import MatchConfig as JMatchConfig
from opencv_tpu.core.config import RansacConfig as JRansacConfig
from opencv_tpu.geometry import affine2d as jaff
from opencv_tpu.geometry import homography as jhom
from opencv_tpu.geometry import ransac as jransac
from opencv_tpu.geometry import rotation as jrot
from opencv_tpu.ops import lsh as jlsh
from opencv_tpu.ops import matching as jmatch
from opencv_tpu.optim import minimize as jmin
from opencv_tpu.slam import loop_closure as jlc
from opencv_tpu_torch.core.config import MatchConfig
from opencv_tpu_torch.core.config import RansacConfig
from opencv_tpu_torch.geometry import affine2d as taff
from opencv_tpu_torch.geometry import homography as thom
from opencv_tpu_torch.ops import lsh as tlsh
from opencv_tpu_torch.ops import matching as tmatch
from opencv_tpu_torch.optim import minimize as tmin
from opencv_tpu_torch.slam import loop_closure as tlc

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)
from test_lsh import _flip_bits, _random_desc


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def J(x):
    return jnp.asarray(np.asarray(x))


def _words(desc):
    return T(desc.view(np.int32))


def _jax_subsets(key, n, valid, h, s):
    return T(np.asarray(jransac._sample_subsets(key, n, J(valid), h, s)).astype(np.int64))


# ------------------------------------------------------------ LSH / matching


def test_build_lsh_index_equals_jax(rng):
    train = _random_desc(rng, 6000)
    for kw in (dict(), dict(n_tables=5, key_bits=9, bucket_capacity=8, seed=3)):
        a = jlsh.build_lsh_index(train, **kw)
        b = tlsh.build_lsh_index(train, device="cpu", **kw)
        np.testing.assert_array_equal(b.buckets.numpy(), np.asarray(a.buckets))
        np.testing.assert_array_equal(b.bit_words.numpy(), np.asarray(a.bit_words))
        np.testing.assert_array_equal(b.bit_shifts.numpy(), np.asarray(a.bit_shifts))
        np.testing.assert_array_equal(b.train.numpy().view(np.uint32), train)
        assert b.key_bits == a.key_bits
    # int32 words build the same index
    c = tlsh.build_lsh_index(train.view(np.int32), device="cpu")
    np.testing.assert_array_equal(c.buckets.numpy(), np.asarray(jlsh.build_lsh_index(train).buckets))


def test_popcount_of_every_bit_pattern_class(rng):
    x = rng.integers(0, 2 ** 32, 4096, dtype=np.uint32)
    x[:4] = [0, 1, 0x80000000, 0xFFFFFFFF]
    want = np.array([bin(int(v)).count("1") for v in x])
    np.testing.assert_array_equal(tlsh.popcount32(T(x.view(np.int32))).numpy(), want)


def test_knn_match_lsh_equals_jax(rng):
    train = _random_desc(rng, 8192)
    q_idx = rng.choice(8192, 256, replace=False)
    query = _flip_bits(rng, train[q_idx], 12)
    query[:20] = _random_desc(rng, 20)  # no near neighbour: mostly empty buckets
    qvalid = rng.random(256) > 0.1
    for kw, cfg in ((dict(n_tables=10, key_bits=12), (0.9, 64.0)),
                    (dict(n_tables=4, key_bits=14, bucket_capacity=4), (0.8, 256.0))):
        a = jlsh.build_lsh_index(train, **kw)
        b = tlsh.build_lsh_index(train, device="cpu", **kw)
        ma = jlsh.knn_match_lsh(a, J(query), J(qvalid), JMatchConfig(ratio=cfg[0], max_distance=cfg[1]))
        mb = tlsh.knn_match_lsh(b, _words(query), T(qvalid), MatchConfig(ratio=cfg[0], max_distance=cfg[1]))
        np.testing.assert_array_equal(mb.train_idx.numpy(), np.asarray(ma.train_idx))
        np.testing.assert_array_equal(mb.distance.numpy(), np.asarray(ma.distance))
        np.testing.assert_array_equal(mb.valid.numpy(), np.asarray(ma.valid))
        assert mb.valid.numpy().mean() > 0.5


def test_radius_match_mask_equals_jax(rng):
    train = _random_desc(rng, 300)
    query = _flip_bits(rng, train[:100], 20)
    qv, tv = rng.random(100) > 0.1, rng.random(300) > 0.1
    for r in (0.0, 20.0, 110.0, 128.0):
        want = np.asarray(jmatch.radius_match_mask(J(query), J(train), r, J(qv), J(tv)))
        got = tmatch.radius_match_mask(_words(query), _words(train), r, T(qv), T(tv)).numpy()
        np.testing.assert_array_equal(got, want)
    assert got.any()


# ------------------------------------------------------------ RANSAC


def _affine_data(rng, n=200, similarity=False):
    src = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    a = np.float32([[1.05, -0.1], [0.1, 1.05]]) if similarity else np.float32([[1.02, 0.08], [-0.05, 0.97]])
    dst = (src @ a.T + [12.0, -7.0] + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    bad = rng.random(n) < 0.3
    dst[bad] = rng.uniform(0, 640, (bad.sum(), 2)).astype(np.float32)
    return src, dst, rng.random(n) > 0.05


def test_estimate_affine_equals_jax(rng):
    for jfn, tfn, s in ((jaff.estimate_affine_2d, taff.estimate_affine_2d, 3),
                        (jaff.estimate_affine_partial_2d, taff.estimate_affine_partial_2d, 2)):
        src, dst, valid = _affine_data(rng, similarity=s == 2)
        key = jax.random.PRNGKey(s)
        ra = jfn(key, J(src), J(dst), J(valid))
        rb = tfn(None, T(src), T(dst), T(valid), subsets=_jax_subsets(key, 200, valid, 512, s))
        assert bool(ra.ok) and bool(rb.ok)
        np.testing.assert_array_equal(rb.inliers.numpy(), np.asarray(ra.inliers))
        np.testing.assert_allclose(rb.M.numpy(), np.asarray(ra.M), rtol=1e-4, atol=1e-4)


def test_find_fundamental_ransac_equals_jax(rng):
    X = np.stack([rng.uniform(-2, 2, 200), rng.uniform(-1.5, 1.5, 200), rng.uniform(4, 9, 200)], 1)
    K = np.float32([[500, 0, 320], [0, 500, 240], [0, 0, 1]])
    R = np.asarray(jrot.rodrigues(J(np.float32([0.05, -0.12, 0.03]))))

    def px(P):
        h = P @ K.T
        return (h[:, :2] / h[:, 2:]).astype(np.float32)

    x1 = px(X) + rng.normal(0, 0.3, (200, 2)).astype(np.float32)
    x2 = px(X @ R.T + [0.4, -0.1, 0.15]) + rng.normal(0, 0.3, (200, 2)).astype(np.float32)
    bad = rng.random(200) < 0.25
    x2[bad] = rng.uniform(0, 640, (bad.sum(), 2)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    cfg = dict(n_hypotheses=128, threshold=1.0)
    ra = jhom.find_fundamental_ransac(key, J(x1), J(x2), cfg=JRansacConfig(**cfg))
    rb = thom.find_fundamental_ransac(None, T(x1), T(x2), cfg=RansacConfig(**cfg),
                                      subsets=_jax_subsets(key, 200, np.ones(200, bool), 128, 8))
    assert bool(ra.ok) and bool(rb.ok)
    np.testing.assert_array_equal(rb.inliers.numpy(), np.asarray(ra.inliers))
    Fa, Fb = np.asarray(ra.model), rb.model.numpy()
    assert min(np.abs(Fa - Fb).max(), np.abs(Fa + Fb).max()) < 1e-4


def test_verify_candidate_equals_jax(rng):
    m = 300
    pos = np.stack([rng.uniform(-2, 2, m), rng.uniform(-1.5, 1.5, m), rng.uniform(4, 8, m)], 1)
    pos = pos.astype(np.float32)
    desc = _random_desc(rng, m)
    lm_valid = rng.random(m) > 0.05
    rv, tv = np.float32([0.04, -0.08, 0.02]), np.float32([0.3, -0.05, 0.1])
    pick = rng.choice(m, 200, replace=False)
    pc = pos[pick] @ np.asarray(jrot.rodrigues(J(rv))).T + tv
    qxy = (pc[:, :2] / pc[:, 2:3] + rng.normal(0, 3e-4, (200, 2))).astype(np.float32)
    qdesc = _flip_bits(rng, desc[pick], 6)
    qdesc[:30] = _random_desc(rng, 30)  # unmatched queries
    qxy[30:60] = rng.uniform(-0.4, 0.4, (30, 2))  # matched, wrong position
    qvalid = np.ones(200, bool)
    key = jax.random.PRNGKey(11)
    a = jlc.verify_candidate(key, qxy, qdesc, qvalid, pos, desc, lm_valid)
    # JAX's adaptive RANSAC scores one chunk of 128 drawn from split(key)[1]
    # at this inlier ratio; the port scores those subsets
    mv = np.asarray(jmatch.knn_match(J(qdesc), J(desc), J(qvalid), J(lm_valid),
                                     JMatchConfig(cross_check=False)).valid)
    sub = _jax_subsets(jax.random.split(key)[1], 200, mv, 128, 4)
    b = tlc.verify_candidate(None, qxy, qdesc, qvalid, pos, desc, lm_valid, device="cpu", subsets=sub)
    assert a is not None and b is not None
    np.testing.assert_allclose(b[0], a[0], atol=1e-3)
    np.testing.assert_allclose(b[1], a[1], atol=1e-3)
    assert abs(b[2] - a[2]) <= 1
    np.testing.assert_allclose(b[0], rv, atol=5e-3)
    # too few matches: both refuse
    assert jlc.verify_candidate(key, qxy, qdesc, qvalid, pos, desc, lm_valid, min_inliers=500) is None
    assert tlc.verify_candidate(None, qxy, qdesc, qvalid, pos, desc, lm_valid, min_inliers=500,
                                device="cpu", subsets=sub) is None


# ------------------------------------------------------------ minimizers


def _rosen(x):
    return (1 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


def test_downhill_simplex_equals_jax():
    a = jmin.downhill_simplex(_rosen, jnp.asarray([-1.2, 1.0]), init_step=0.5, iters=400)
    b = tmin.downhill_simplex(_rosen, torch.tensor([-1.2, 1.0]), init_step=0.5, iters=400)
    np.testing.assert_allclose(b.x.numpy(), np.asarray(a.x), atol=1e-5)
    assert float(b.fun) < 1e-3


def test_conjugate_gradient_equals_jax(rng):
    a_ = rng.normal(0, 1, (6, 6)).astype(np.float32)
    Q = a_ @ a_.T + 6 * np.eye(6, dtype=np.float32)
    bv = rng.normal(0, 1, 6).astype(np.float32)
    ra = jmin.conjugate_gradient(lambda x: 0.5 * x @ J(Q) @ x - J(bv) @ x, jnp.zeros(6), iters=60)
    rb = tmin.conjugate_gradient(lambda x: 0.5 * x @ T(Q) @ x - T(bv) @ x, torch.zeros(6), iters=60)
    np.testing.assert_allclose(rb.x.numpy(), np.asarray(ra.x), atol=1e-4)
    np.testing.assert_allclose(rb.x.numpy(), np.linalg.solve(Q, bv), atol=1e-2)
    # Rosenbrock: both reach the minimum; the f32 line searches part
    # within 1e-5 of it
    ra = jmin.conjugate_gradient(_rosen, jnp.asarray([-1.2, 1.0]), iters=200)
    rb = tmin.conjugate_gradient(_rosen, torch.tensor([-1.2, 1.0]), iters=200)
    assert float(rb.fun) < 1e-4 and float(ra.fun) < 1e-4
    np.testing.assert_allclose(rb.x.numpy(), np.asarray(ra.x), atol=1e-4)


def test_solve_lp_equals_jax():
    for c, A, b in (([3.0, 1.0, 2.0], [[1, 1, 3], [2, 2, 5], [4, 1, 2]], [30, 24, 36]),
                    ([1.0], [[-1.0]], [1.0]),
                    ([1.0, 1.0], [[1, 0], [0, 1], [-1, -1]], [2, 3, -10])):
        ra = jmin.solve_lp(c, A, b)
        rb = tmin.solve_lp(c, A, b, device="cpu")
        assert rb.status == ra.status
        np.testing.assert_array_equal(rb.x.numpy(), np.asarray(ra.x))
        assert float(rb.value) == float(ra.value)
