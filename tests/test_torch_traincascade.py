"""The cascade trainer of the PyTorch port against the JAX package on the
CPU (tests/test_traincascade.py's ring objects and backgrounds, 16x16
windows).

Tolerances, and where the two packages part:
- Feature pools and corner matrices: equal.
- `_sample_features` on 8-bit (integer-valued) samples: bit-equal. XLA's
  f32 product ii_flat @ M is exact there, and the port's f64 product
  rounded once is exact everywhere. On non-integer samples XLA's blocked
  dot rounds in its own order: corner terms of ~1e5 carry XLA's f32
  rounding of ~1e-2, and the normalization 1/(narea * std) ~ 1e-4 makes
  that ~1e-6 on values of 0.01-1, so they are held at atol 1e-5.
- `_fit_stumps_all` / `_fit_lbp_stumps_all` (jitted in JAX) on the same
  values and weights: bit-equal (histograms in XLA's in-order scatter
  order, its cumulative-sum and reduction orders, its fused
  multiply-add of the threshold).
- A 2-stage x 4-weak training, Haar and LBP: bit-equal stumps, leaves and
  thresholds on 8-bit samples. The port's exp is f64 rounded once, XLA's
  f32 exp is not correctly rounded, so the weights after the first weak
  classifier may differ in the last bit; these trainings do not move.
- The XML writers: byte-equal files.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.ml import traincascade as jt
from opencv_tpu_torch.ml import traincascade as tt

from test_traincascade import WIN, _make_background, _make_object


def _data(seed: int, n_pos: int, n_bg: int, integer: bool = True):
    rng = np.random.default_rng(seed)
    pos = np.stack([_make_object(rng) for _ in range(n_pos)])
    negs = [_make_background(rng) for _ in range(n_bg)]
    if integer:
        pos, negs = np.round(pos), [np.round(n) for n in negs]
    return pos, negs


def test_feature_pools():
    for win, step in ((WIN, 3), ((24, 24), 3), ((20, 16), 2)):
        rects = jt.haar_feature_pool(win, step, step)
        np.testing.assert_array_equal(tt.haar_feature_pool(win, step, step), rects)
        np.testing.assert_array_equal(tt._corner_matrix(rects, win), jt._corner_matrix(rects, win))
        np.testing.assert_array_equal(tt.lbp_feature_pool(win, 2), jt.lbp_feature_pool(win, 2))


@pytest.mark.parametrize("integer", [True, False])
def test_sample_features(integer):
    pos, negs = _data(0, 64, 4, integer)
    crops = np.concatenate([pos, np.stack([n[:16, :16] for n in negs])])
    M = jt._corner_matrix(jt.haar_feature_pool(WIN), WIN)
    wv, wn = (np.asarray(a) for a in jt._sample_features(crops, jnp.asarray(M), WIN))
    gv, gn = tt._sample_features(crops, torch.from_numpy(M).double(), WIN)
    np.testing.assert_array_equal(gn.numpy(), wn)
    if integer:
        np.testing.assert_array_equal(gv.numpy(), wv)
    else:
        np.testing.assert_allclose(gv.numpy(), wv, rtol=0, atol=1e-5)
    rects = jt.lbp_feature_pool(WIN, 2)
    np.testing.assert_array_equal(tt._lbp_codes(crops, rects, "cpu").numpy(),
                                  np.asarray(jt._lbp_codes(crops, rects)))


def test_fit_stumps_all_equal():
    """One fit on seeded values, labels and weights (with repeated values,
    so bins tie): every output bit-equal to the jitted JAX fit."""
    rng = np.random.default_rng(3)
    n, f = 300, 120
    vals = (rng.normal(0, 1, (n, f)) * rng.uniform(1e-3, 10, f)).astype(np.float32)
    vals[:, :10] = np.round(vals[:, :10])
    y = np.where(rng.random(n) < 0.4, 1.0, -1.0).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    w /= w.sum()
    want = jt._fit_stumps_all_jit(jnp.asarray(vals), jnp.asarray(y), jnp.asarray(w))
    got = tt._fit_stumps_all(torch.from_numpy(vals), torch.from_numpy(y), torch.from_numpy(w))
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    codes = rng.integers(0, 256, (n, f)).astype(np.int32)
    codes[:, :20] = rng.integers(0, 6, (n, 20))  # few codes used: empty bins and ties
    want = jt._fit_lbp_stumps_all_jit(jnp.asarray(codes), jnp.asarray(y), jnp.asarray(w))
    got = tt._fit_lbp_stumps_all(torch.from_numpy(codes), torch.from_numpy(y), torch.from_numpy(w))
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


def _assert_models_equal(got, want):
    assert got.window == tuple(want.window)
    for f in want._fields[1:]:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("kind", ["haar", "lbp"])
def test_small_training_equal(kind, tmp_path):
    """2 stages x 4 weak classifiers at 16x16: the same cascade, and the
    same XML bytes from both writers."""
    pos, negs = _data(9, 150, 15)
    kw = dict(window=WIN, n_stages=2, max_weak_per_stage=4, n_neg_per_stage=200, seed=4)
    if kind == "haar":
        want = jt.train_cascade(pos, negs, pos_step=3, size_step=3, **kw)
        got = tt.train_cascade(pos, negs, pos_step=3, size_step=3, device="cpu", **kw)
        writers = (jt.save_opencv_cascade, tt.save_opencv_cascade)
    else:
        want = jt.train_cascade_lbp(pos, negs, pos_step=3, **kw)
        got = tt.train_cascade_lbp(pos, negs, pos_step=3, device="cpu", **kw)
        writers = (jt.save_opencv_lbp_cascade, tt.save_opencv_lbp_cascade)
    assert len(want.stage_thresholds) == 2
    _assert_models_equal(got, want)
    paths = [str(tmp_path / f"{i}.xml") for i in range(2)]
    writers[0](want, paths[0])
    writers[1](got, paths[1])
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
