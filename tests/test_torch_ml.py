"""The ml module of the PyTorch port (classifiers, clustering, trees and
boosting) against the JAX package on the CPU, on the data of
tests/test_ml.py and tests/test_ml2.py, with the JAX-drawn random values
injected: k-means++'s picks (recovered as the rows of x that JAX's
seeds are), the MLP's initial normal draws, SVMSGD's sample indices and
the forest's Poisson weights and feature masks.

Tolerances, and why:
- quantile bin edges, single trees, random forests, AdaBoost's trees and
  GBT's tree structures: exact (the port takes jnp.percentile's and the
  jitted tree's arithmetic as XLA compiles them on the CPU, and XLA's
  in-order scatter-add); forest probabilities within 1e-6, AdaBoost's
  stage weights and leaf masses within 1e-6 (its exp and log are taken
  in f64 and rounded once, XLA's f32 ones are not correctly rounded, so
  the sample weights differ in the last bit), GBT's leaf masses within
  1e-4 and log-odds within 1e-5;
- k-means and GMM: labels equal, centres, weights, means and variances
  within 1e-5, inertia and log-likelihood within 1e-5 relative (sums over
  all samples in another order);
- kNN: predictions equal, on blobs and on an integer grid full of
  distance ties (`lax.top_k` keeps the lower index, so does the port's
  stable sort);
- linear SVM, logistic regression, naive Bayes and the kernel SVM:
  parameters within 1e-5, predictions equal;
- MLP: parameters equal within 1e-6 for 100 RPROP iterations; at the
  JAX test's 400, predictions equal and probabilities within 0.02 (RPROP
  steps by the sign of each gradient, so a last-bit difference in a
  gradient near zero flips a step of up to eta and the weights part);
- SVMSGD: weights and shift within 1e-4, predictions equal.
Every JAX-trained model also crosses over through `convert.ml_model` and
predicts as JAX does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.ml import classifiers as JC
from opencv_tpu.ml import clustering as JCL
from opencv_tpu.ml import trees as JT
from opencv_tpu_torch import convert
from opencv_tpu_torch.ml import classifiers as TC
from opencv_tpu_torch.ml import clustering as TCL
from opencv_tpu_torch.ml import trees as TT

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)


def three_blobs(rng, n=150):
    c = np.array([[0.0, 0.0], [5.0, 5.0], [-4.0, 6.0]])
    x = np.concatenate([rng.normal(ci, 0.5, size=(n, 2)) for ci in c])
    y = np.repeat(np.arange(3), n)
    return x.astype(np.float32), y


def two_moons(rng, n=200, noise=0.12):
    t = rng.uniform(0, np.pi, n)
    x0 = np.stack([np.cos(t), np.sin(t)], 1)
    x1 = np.stack([1 - np.cos(t), 0.5 - np.sin(t)], 1)
    x = np.concatenate([x0, x1]).astype(np.float32)
    x += rng.normal(0, noise, x.shape).astype(np.float32)
    y = np.concatenate([np.zeros(n), np.ones(n)]).astype(np.int32)
    p = rng.permutation(2 * n)
    return x[p], y[p]


def jax_pp_picks(key, x, k):
    """The rows of x that JAX's k-means++ picked, in order."""
    centers = np.asarray(JCL.kmeans_pp_init(key, jnp.asarray(x), k))
    return [int(np.flatnonzero((x == c).all(1))[0]) for c in centers]


def jax_mlp_draws(key, sizes):
    keys = jax.random.split(key, len(sizes) - 1)
    return [np.array(jax.random.normal(k, (i, o))) for k, i, o in zip(keys, sizes[:-1], sizes[1:])]


def jax_forest_draws(key, n, f, n_trees, feature_frac):
    ws, fms = [], []
    for k in jax.random.split(key, n_trees):
        kw, kf = jax.random.split(k)
        ws.append(np.array(jax.random.poisson(kw, 1.0, (n,)).astype(jnp.float32)))
        fm = jax.random.uniform(kf, (f,)) < feature_frac
        fms.append(np.array(fm.at[jax.random.randint(kf, (), 0, f)].set(True)))
    return np.stack(ws), np.stack(fms)


# ------------------------------------------------------------ clustering


def test_kmeans_with_jax_picks(rng):
    x, _ = three_blobs(rng)
    key = jax.random.PRNGKey(0)
    want = JCL.kmeans(key, jnp.asarray(x), 3)
    got = TCL.kmeans(None, _t(x), 3, picks=jax_pp_picks(key, x, 3))
    np.testing.assert_array_equal(_np(got.labels), np.asarray(want.labels))
    np.testing.assert_allclose(_np(got.centers), np.asarray(want.centers), atol=1e-5)
    np.testing.assert_allclose(float(got.inertia), float(want.inertia), rtol=1e-5)
    back = convert.ml_model(want, device="cpu")
    assert isinstance(back, TCL.KMeansResult)
    np.testing.assert_array_equal(_np(back.centers), np.asarray(want.centers))


def test_kmeans_pp_picks_from_a_generator(rng):
    """Drawn from a torch.Generator: distinct rows, the same picks for the
    same seed, and the blobs recovered."""
    x, y = three_blobs(rng)
    a = TCL.kmeans_pp_picks(torch.Generator().manual_seed(3), _t(x), 3)
    b = TCL.kmeans_pp_picks(torch.Generator().manual_seed(3), _t(x), 3)
    assert torch.equal(a, b) and len(set(a.tolist())) == 3
    res = TCL.kmeans(torch.Generator().manual_seed(3), _t(x), 3)
    labels = _np(res.labels)
    for cls in range(3):
        _, counts = np.unique(labels[y == cls], return_counts=True)
        assert counts.max() / counts.sum() > 0.98


def test_gmm_em_with_jax_picks(rng):
    x, _ = three_blobs(rng)
    key = jax.random.PRNGKey(1)
    want = JCL.gmm_em(key, jnp.asarray(x), 3, iters=40)
    got = TCL.gmm_em(None, _t(x), 3, iters=40, picks=jax_pp_picks(key, x, 3))
    for f in ("weights", "means", "variances"):
        np.testing.assert_allclose(_np(getattr(got, f)), np.asarray(getattr(want, f)), atol=1e-5)
    np.testing.assert_allclose(float(got.log_likelihood), float(want.log_likelihood), rtol=1e-5)
    back = convert.ml_model(want, device="cpu")
    np.testing.assert_array_equal(_np(back.means), np.asarray(want.means))


def test_chip_smoke_keeps_jax_picks():
    """chip_smoke's JAX_PICKS_SLICE11 are the JAX package's k-means++
    picks of its two clusterings (GMM's k-means of the letter rows with
    PRNGKey(1), k-means of the descriptor rows with PRNGKey(0)): from
    them the card's inertia and log-likelihood are held to the JAX
    package's figures."""
    import chip_smoke as cs

    x, _ = cs.letter_data()
    picks = cs.JAX_PICKS_SLICE11
    assert jax_pp_picks(jax.random.PRNGKey(1), x[:cs.ML_TRAIN], cs.ML_GMM_K) == picks["gmm_letters"]
    assert jax_pp_picks(jax.random.PRNGKey(0), cs.bow_data(), cs.ML_BOW["k"]) == picks["kmeans_bow"]


# ----------------------------------------------------------- classifiers


def test_knn_equals_jax(rng):
    x, y = three_blobs(rng)
    q, _ = three_blobs(np.random.default_rng(99), n=30)
    want = JC.knn_classify(jnp.asarray(x), jnp.asarray(y), jnp.asarray(q), k=7)
    got = TC.knn_classify(_t(x), _t(y), _t(q), k=7)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_knn_ties_take_the_lower_index(rng, monkeypatch):
    """On an integer grid most distances tie; chunked queries too."""
    x = rng.integers(0, 4, (80, 2)).astype(np.float32)
    y = rng.integers(0, 3, 80)
    q = rng.integers(0, 4, (40, 2)).astype(np.float32)
    monkeypatch.setattr(TC, "KNN_QUERY_CHUNK", 16)
    for k in (1, 4, 5):
        want = JC.knn_classify(jnp.asarray(x), jnp.asarray(y), jnp.asarray(q), k=k)
        got = TC.knn_classify(_t(x), _t(y), _t(q), k=k, n_classes=3)
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_linear_svm_equals_jax(rng):
    n = 200
    x = rng.normal(size=(n, 2)).astype(np.float32)
    y = np.where(x[:, 0] + 0.5 * x[:, 1] > 0.2, 1.0, -1.0).astype(np.float32)
    want = JC.train_linear_svm(jnp.asarray(x), jnp.asarray(y), iters=2000)
    got = TC.train_linear_svm(_t(x), _t(y), iters=2000)
    np.testing.assert_allclose(_np(got.w), np.asarray(want.w), atol=1e-5)
    np.testing.assert_allclose(float(got.b), float(want.b), atol=1e-5)
    np.testing.assert_array_equal(np.sign(_np(TC.svm_predict(got, _t(x)))),
                                  np.sign(np.asarray(JC.svm_predict(want, jnp.asarray(x)))))
    back = convert.ml_model(want, device="cpu")
    np.testing.assert_allclose(_np(TC.svm_predict(back, _t(x))),
                               np.asarray(JC.svm_predict(want, jnp.asarray(x))), atol=1e-5)


def test_logistic_regression_equals_jax(rng):
    n = 300
    x = rng.normal(size=(n, 3)).astype(np.float32)
    logit = 2.0 * x[:, 0] - 1.0 * x[:, 2] + 0.5
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    want = JC.train_logistic_regression(jnp.asarray(x), jnp.asarray(y))
    got = TC.train_logistic_regression(_t(x), _t(y))
    np.testing.assert_allclose(_np(got.w), np.asarray(want.w), atol=1e-5)
    np.testing.assert_allclose(float(got.b), float(want.b), atol=1e-5)
    pj = np.asarray(JC.logistic_predict_proba(want, jnp.asarray(x)))
    np.testing.assert_array_equal(_np(TC.logistic_predict_proba(got, _t(x))) > 0.5, pj > 0.5)
    back = convert.ml_model(want, device="cpu")
    np.testing.assert_allclose(_np(TC.logistic_predict_proba(back, _t(x))), pj, atol=1e-6)


def test_mlp_equals_jax_for_100_iterations(rng):
    x, y = two_moons(rng)
    key = jax.random.PRNGKey(1)
    init = jax_mlp_draws(key, (2, 24, 2))
    want = JC.train_mlp(key, jnp.asarray(x), jnp.asarray(y), hidden=(24,), iters=100)
    got = TC.train_mlp(None, _t(x), _t(y), hidden=(24,), iters=100, init=init)
    for a, b in zip(got.weights + got.biases, want.weights + want.biases):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-6)


def test_mlp_predictions_equal_jax(rng):
    x, y = two_moons(rng)
    key = jax.random.PRNGKey(1)
    init = jax_mlp_draws(key, (2, 24, 2))
    want = JC.train_mlp(key, jnp.asarray(x), jnp.asarray(y), hidden=(24,), iters=400)
    got = TC.train_mlp(None, _t(x), _t(y), hidden=(24,), iters=400, init=init)
    pj = np.asarray(JC.mlp_predict_proba(want, jnp.asarray(x)))
    pt = _np(TC.mlp_predict_proba(got, _t(x)))
    np.testing.assert_array_equal(pt.argmax(1), pj.argmax(1))
    np.testing.assert_allclose(pt, pj, atol=0.02)
    assert (pt.argmax(1) == y).mean() > 0.95
    back = convert.ml_model(want, device="cpu")
    np.testing.assert_allclose(_np(TC.mlp_predict_proba(back, _t(x))), pj, atol=1e-6)


def test_mlp_from_a_generator(rng):
    x, y = two_moons(rng)
    a = TC.train_mlp(torch.Generator().manual_seed(0), _t(x), _t(y), hidden=(8,), iters=50)
    b = TC.train_mlp(torch.Generator().manual_seed(0), _t(x), _t(y), hidden=(8,), iters=50)
    assert all(torch.equal(p, q) for p, q in zip(a.weights, b.weights))


@pytest.mark.parametrize("kind", ["rbf", "linear", "poly", "rbf_default_gamma"])
def test_kernel_svm_equals_jax(rng, kind):
    x, y = two_moons(rng)
    kw = {"rbf": dict(c=4.0, kind="rbf", gamma=2.0, iters=500),
          "linear": dict(kind="linear", iters=300),
          "poly": dict(kind="poly", gamma=0.5, degree=3, iters=200),
          "rbf_default_gamma": dict(iters=300)}[kind]
    want = JC.train_kernel_svm(jnp.asarray(x), jnp.asarray(y), **kw)
    got = TC.train_kernel_svm(_t(x), _t(y), **kw)
    assert got.gamma == want.gamma
    np.testing.assert_allclose(_np(got.alpha), np.asarray(want.alpha), atol=1e-5)
    dj = np.asarray(JC.kernel_svm_decision(want, jnp.asarray(x)))
    np.testing.assert_array_equal(_np(TC.kernel_svm_decision(got, _t(x))) > 0, dj > 0)
    back = convert.ml_model(want, device="cpu")
    assert back.kind == want.kind
    np.testing.assert_allclose(_np(TC.kernel_svm_decision(back, _t(x))), dj, rtol=1e-5, atol=1e-4)


def test_naive_bayes_equals_jax(rng):
    x = np.concatenate([rng.normal([-2, 0], 0.6, (80, 2)),
                        rng.normal([2, 1], 0.6, (80, 2))]).astype(np.float32)
    y = np.concatenate([np.zeros(80), np.ones(80)]).astype(np.int32)
    want = JC.train_naive_bayes(jnp.asarray(x), jnp.asarray(y))
    got = TC.train_naive_bayes(_t(x), _t(y))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5)
    lj = np.asarray(JC.naive_bayes_predict_log_proba(want, jnp.asarray(x)))
    np.testing.assert_array_equal(_np(TC.naive_bayes_predict_log_proba(got, _t(x))).argmax(1),
                                  lj.argmax(1))
    back = convert.ml_model(want, device="cpu")
    np.testing.assert_allclose(_np(TC.naive_bayes_predict_log_proba(back, _t(x))), lj, atol=1e-4)


@pytest.mark.parametrize("svmsgd_type,margin_type", [("asgd", "soft"), ("sgd", "hard")])
def test_svmsgd_equals_jax(rng, svmsgd_type, margin_type):
    x, y = two_moons(rng)
    ys = np.where(y > 0, 1, -1)
    iters = 20000
    idx = np.array(jax.random.randint(jax.random.PRNGKey(0), (iters,), 0, x.shape[0]))
    want = JC.train_svmsgd(jnp.asarray(x), jnp.asarray(ys), svmsgd_type=svmsgd_type,
                           margin_type=margin_type, iters=iters)
    got = TC.train_svmsgd(_t(x), _t(ys), svmsgd_type=svmsgd_type, margin_type=margin_type,
                          iters=iters, indices=idx)
    np.testing.assert_allclose(_np(got.weights), np.asarray(want.weights), atol=1e-4)
    np.testing.assert_allclose(float(got.shift), float(want.shift), atol=1e-4)
    pj = np.asarray(JC.svmsgd_predict(want, jnp.asarray(x)))
    np.testing.assert_array_equal(_np(TC.svmsgd_predict(got, _t(x))), pj)
    back = convert.ml_model(want, device="cpu")
    np.testing.assert_array_equal(_np(TC.svmsgd_predict(back, _t(x))), pj)


# ----------------------------------------------------------------- trees


@pytest.mark.parametrize("n,n_bins", [(5, 16), (160, 16), (401, 10), (1000, 7), (333, 32)])
def test_quantile_bins_equal_jax(rng, n, n_bins):
    x = (rng.normal(size=(n, 3)) * rng.uniform(0.1, 100)).astype(np.float32)
    x[: n // 3, 0] = np.round(x[: n // 3, 0])  # repeated values
    np.testing.assert_array_equal(_np(TT.quantile_bins(_t(x), n_bins)),
                                  np.asarray(JT.quantile_bins(jnp.asarray(x), n_bins)))


def _same_tree(got, want, value_atol=0.0):
    for f in ("feature", "bin", "is_leaf", "thresholds"):
        np.testing.assert_array_equal(_np(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(_np(got.value), np.asarray(want.value), atol=value_atol, rtol=0)


def test_single_tree_equals_jax(rng):
    x = np.concatenate([rng.normal(-2, 0.5, (80, 3)), rng.normal(2, 0.5, (80, 3))]).astype(np.float32)
    y = np.concatenate([np.zeros(80), np.ones(80)]).astype(np.int32)
    want = JT.fit_tree(jnp.asarray(x), jnp.asarray(y), depth=3, n_classes=2)
    got = TT.fit_tree(_t(x), _t(y), depth=3, n_classes=2)
    _same_tree(got, want)
    np.testing.assert_array_equal(_np(TT.tree_predict_proba(got, _t(x), 3)),
                                  np.asarray(JT.tree_predict_proba(want, jnp.asarray(x), 3)))


def test_weighted_masked_multiclass_tree_equals_jax(rng):
    """Non-integer weights, a feature mask and 4 classes, depth 4."""
    x = rng.normal(size=(300, 5)).astype(np.float32)
    y = (np.digitize(x[:, 0] + 0.5 * x[:, 3], [-1, 0, 1])).astype(np.int32)
    w = rng.uniform(0.01, 1.0, 300).astype(np.float32)
    fm = np.array([True, False, True, True, True])
    want = JT.fit_tree(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), depth=4, n_classes=4,
                       feature_mask=jnp.asarray(fm))
    got = TT.fit_tree(_t(x), _t(y), _t(w), depth=4, n_classes=4, feature_mask=_t(fm))
    _same_tree(got, want)


def test_random_forest_equals_jax(rng):
    x, y = two_moons(rng)
    key = jax.random.PRNGKey(0)
    want = JT.fit_random_forest(key, jnp.asarray(x), jnp.asarray(y), n_trees=12, depth=5)
    draws = jax_forest_draws(key, x.shape[0], 2, 12, 0.7)
    got = TT.fit_random_forest(None, _t(x), _t(y), n_trees=12, depth=5, draws=draws)
    _same_tree(got.trees, want.trees)
    pj = np.asarray(JT.forest_predict_proba(want, jnp.asarray(x)))
    pt = _np(TT.forest_predict_proba(got, _t(x)))
    np.testing.assert_allclose(pt, pj, atol=1e-6)
    np.testing.assert_array_equal(pt.argmax(1), pj.argmax(1))
    back = convert.ml_model(want, device="cpu")
    assert back.depth == 5 and back.n_classes == 2
    np.testing.assert_allclose(_np(TT.forest_predict_proba(back, _t(x))), pj, atol=1e-6)


def test_random_forest_from_a_generator(rng):
    x, y = two_moons(rng)
    a = TT.fit_random_forest(torch.Generator().manual_seed(5), _t(x), _t(y), n_trees=4, depth=4)
    b = TT.fit_random_forest(torch.Generator().manual_seed(5), _t(x), _t(y), n_trees=4, depth=4)
    assert all(torch.equal(p, q) for p, q in zip(a.trees, b.trees))
    acc = (_np(TT.forest_predict_proba(a, _t(x))).argmax(1) == y).mean()
    assert acc > 0.9


def test_adaboost_equals_jax(rng):
    x, y = two_moons(rng)
    want = JT.fit_adaboost(jnp.asarray(x), jnp.asarray(y), n_rounds=24, depth=2)
    got = TT.fit_adaboost(_t(x), _t(y), n_rounds=24, depth=2)
    _same_tree(got.trees, want.trees, value_atol=1e-6)
    np.testing.assert_allclose(_np(got.alpha), np.asarray(want.alpha), atol=1e-6)
    dj = np.asarray(JT.adaboost_decision(want, jnp.asarray(x)))
    np.testing.assert_array_equal(_np(TT.adaboost_decision(got, _t(x))) > 0, dj > 0)
    back = convert.ml_model(want, device="cpu")
    np.testing.assert_allclose(_np(TT.adaboost_decision(back, _t(x))), dj, atol=1e-5)


def test_gbt_equals_jax(rng):
    x, y = two_moons(rng)
    want = JT.fit_gbt(jnp.asarray(x), jnp.asarray(y), n_rounds=40, depth=3)
    got = TT.fit_gbt(_t(x), _t(y), n_rounds=40, depth=3)
    _same_tree(got.trees, want.trees, value_atol=1e-4)
    dj = np.asarray(JT.gbt_decision(want, jnp.asarray(x)))
    dt = _np(TT.gbt_decision(got, _t(x)))
    np.testing.assert_allclose(dt, dj, atol=1e-5)
    np.testing.assert_array_equal(dt > 0, dj > 0)
    back = convert.ml_model(want, device="cpu")
    np.testing.assert_allclose(_np(TT.gbt_decision(back, _t(x))), dj, atol=1e-5)
