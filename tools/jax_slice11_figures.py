"""The JAX package's own [ml] figures on chip_smoke.py's seeded data, on the CPU.

    python tools/jax_slice11_figures.py

chip_smoke.py's `[ml]` path fits every classifier of the ml module at
letter_recog's settings on `letter_data()` (20 000 x 16, 26 overlapping
classes; the first 16 000 rows train, the last 4 000 test) and the two
clusterings on `bow_data()` and the letter features, and holds each
accuracy within ML_ACC_TOL of the JAX package's. This script runs the
JAX package's functions at the same settings with their own draws
(PRNGKey(0) for the MLP, the forest and k-means, PRNGKey(1) for GMM,
SVMSGD's seed 0) and prints the dictionary that chip_smoke.py keeps as
`JAX_FIGURES_SLICE11`: accuracies, k-means inertia and GMM
log-likelihood; then the k-means++ picks of the two clusterings, as row
indices, which chip_smoke.py keeps as `JAX_PICKS_SLICE11`: from them the
card's inertia and log-likelihood are held to the JAX package's.
The machine with the card has no JAX. Takes a few minutes; the forest's
100 trees are one vmap (a few GB of host memory).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from opencv_tpu.ml import classifiers as C  # noqa: E402
from opencv_tpu.ml import clustering as CL  # noqa: E402
from opencv_tpu.ml import trees as T  # noqa: E402


def accuracy(pred, truth) -> float:
    return float(np.mean(np.asarray(pred) == np.asarray(truth)))


def pp_picks(key, x: np.ndarray, k: int) -> list[int]:
    """The rows of x that the JAX package's k-means++ picks with `key`, in
    order (each pick is a row of x; the rows here are distinct)."""
    centers = np.asarray(CL.kmeans_pp_init(key, jnp.asarray(x), k))
    return [int(np.flatnonzero((x == c).all(1))[0]) for c in centers]


def clustering_picks() -> dict:
    """JAX's k-means++ picks of chip_smoke's two clusterings: k-means of
    bow_data() with PRNGKey(0) and GMM EM's k-means of the letter training
    rows with PRNGKey(1), as kmeans() and gmm_em() draw them."""
    x, _ = cs.letter_data()
    return {"kmeans_bow": pp_picks(jax.random.PRNGKey(0), cs.bow_data(), cs.ML_BOW["k"]),
            "gmm_letters": pp_picks(jax.random.PRNGKey(1), x[:cs.ML_TRAIN], cs.ML_GMM_K)}


def main():
    t0 = time.perf_counter()
    x, y = cs.letter_data()
    xtr, ytr = jnp.asarray(x[:cs.ML_TRAIN]), jnp.asarray(y[:cs.ML_TRAIN])
    xte, yte = jnp.asarray(x[cs.ML_TRAIN:]), y[cs.ML_TRAIN:]
    btr, bte = (ytr == 0).astype(jnp.int32), (yte == 0).astype(np.int64)
    sgn_tr, sgn_te = 2 * btr - 1, 2 * bte - 1
    key = jax.random.PRNGKey(0)
    out = {}

    def note(name, value):
        out[name] = round(float(value), 6)
        print(f"{name}: {out[name]} ({time.perf_counter() - t0:.1f} s)", file=sys.stderr, flush=True)

    note("knn", accuracy(C.knn_classify(xtr, ytr, xte, k=cs.ML_KNN_K, n_classes=cs.ML_CLASSES), yte))
    nb = C.train_naive_bayes(xtr, ytr, cs.ML_CLASSES)
    note("naive_bayes", accuracy(jnp.argmax(C.naive_bayes_predict_log_proba(nb, xte), 1), yte))
    mlp = C.train_mlp(key, xtr, ytr, hidden=cs.ML_MLP_HIDDEN, n_classes=cs.ML_CLASSES,
                      iters=cs.ML_MLP_ITERS)
    note("mlp", accuracy(jnp.argmax(C.mlp_predict_proba(mlp, xte), 1), yte))
    forest = T.fit_random_forest(key, xtr, ytr, n_trees=cs.ML_FOREST["n_trees"],
                                 depth=cs.ML_FOREST["depth"], n_classes=cs.ML_CLASSES,
                                 feature_frac=cs.ML_FOREST["feature_frac"])
    note("random_forest", accuracy(jnp.argmax(T.forest_predict_proba(forest, xte), 1), yte))
    lsvm = C.train_linear_svm(xtr, sgn_tr.astype(jnp.float32))
    note("linear_svm", accuracy(jnp.where(C.svm_predict(lsvm, xte) > 0, 1, -1), sgn_te))
    lr = C.train_logistic_regression(xtr, btr)
    note("logistic", accuracy(C.logistic_predict_proba(lr, xte) > 0.5, bte))
    ksvm = C.train_kernel_svm(xtr[:cs.ML_KSVM_ROWS], btr[:cs.ML_KSVM_ROWS], kind="rbf")
    note("kernel_svm_rbf", accuracy(C.kernel_svm_decision(ksvm, xte) > 0, bte))
    sgd = C.train_svmsgd(xtr, sgn_tr)
    note("svmsgd", accuracy(C.svmsgd_predict(sgd, xte), sgn_te))
    ada = T.fit_adaboost(xtr, btr, **cs.ML_ADA)
    note("adaboost", accuracy(T.adaboost_decision(ada, xte) > 0, bte))
    gbt = T.fit_gbt(xtr, btr)
    note("gbt", accuracy(T.gbt_decision(gbt, xte) > 0, bte))
    km = CL.kmeans(key, jnp.asarray(cs.bow_data()), cs.ML_BOW["k"])
    note("kmeans_bow", km.inertia)
    gmm = CL.gmm_em(jax.random.PRNGKey(1), xtr, cs.ML_GMM_K)
    note("gmm_letters", gmm.log_likelihood)
    print(json.dumps(out))
    print(json.dumps({"picks": clustering_picks()}))


if __name__ == "__main__":
    main()
