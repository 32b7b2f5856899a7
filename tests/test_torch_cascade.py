"""Haar and LBP cascade detection of the PyTorch port against the JAX
package on the CPU.

The cascades are the JAX package's own: tests/test_cascade.py's
hand-built one and cascades the JAX trainer fits on tests/test_traincascade.py's
ring objects (16x16 windows), carried across with
`convert.cascade_model` / `convert.lbp_cascade_model`, or written by the
JAX XML writers and read by the port's loaders.

Tolerances: the dense Haar score map and the LBP accept map are bit-equal
to eager JAX (`jax.disable_jit()`): the integral images take eager JAX's
prefix-sum order and every float sum the JAX function's order. Against
the default (jitted) JAX detectors, where XLA fuses multiply-adds, the
raw hits are held to >= 99.9 % equal and the grouped boxes to equality;
on these scenes they are all equal. group_rectangles is host numpy in
both: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.ml import traincascade as j_train
from opencv_tpu.ops import cascade as jc
from opencv_tpu_torch import convert
from opencv_tpu_torch.ops import cascade as tc

from test_cascade import tiny_model
from test_traincascade import WIN, _make_background, _make_object


@pytest.fixture(scope="module")
def models():
    """(Haar, LBP) cascades of the JAX trainer: 3 stages of up to 6
    stumps on 8-bit (rounded) ring objects."""
    rng = np.random.default_rng(0)
    pos = np.round(np.stack([_make_object(rng) for _ in range(200)]))
    negs = [np.round(_make_background(rng)) for _ in range(20)]
    kw = dict(window=WIN, n_stages=3, max_weak_per_stage=6, n_neg_per_stage=300, seed=1)
    return j_train.train_cascade(pos, negs, **kw), j_train.train_cascade_lbp(pos, negs, **kw)


def _scene(seed: int, integer: bool = True, h: int = 120, w: int = 160):
    """A 120x160 background with ring objects planted at 1x and 2x the
    window."""
    rng = np.random.default_rng(seed)
    img = _make_background(rng, h, w)
    img[20:36, 30:46] = _make_object(rng, 0.0)
    big = np.kron(_make_object(rng, 0.0), np.ones((2, 2), np.float32))
    img[60:92, 100:132] = big
    return np.round(img) if integer else img


@pytest.mark.parametrize("integer", [True, False])
def test_haar_score_map_bit_equal_eager(models, integer):
    haar, _ = models
    scene = _scene(1, integer)
    for model in (haar, tiny_model()):
        with jax.disable_jit():
            want = np.asarray(jc.cascade_score_map(jnp.asarray(scene), model))
        got = tc.cascade_score_map(scene, convert.cascade_model(model), device="cpu").numpy()
        np.testing.assert_array_equal(got, want)
        assert want.any() and not want.all()
    with jax.disable_jit():
        want = np.asarray(jc.cascade_score_map(jnp.asarray(scene), haar, n_stages=1))
    np.testing.assert_array_equal(
        tc.cascade_score_map(scene, haar, n_stages=1, device="cpu").numpy(), want)


@pytest.mark.parametrize("integer", [True, False])
def test_lbp_accept_map_bit_equal_eager(models, integer):
    _, lbp = models
    scene = _scene(2, integer)
    with jax.disable_jit():
        want = np.asarray(jc._lbp_scale_impl(jnp.asarray(scene), lbp))
    got = tc.lbp_score_map(scene, convert.lbp_cascade_model(lbp), device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def _jax_raw_hits(img, model, dense_stages=3, capacity=2048):
    """The raw hits of the JAX detect_multi_scale (its jitted per-scale
    function), before grouping."""
    h, w = img.shape
    wh, ww = model.window
    t = jc._stage_tensors(model)
    fn = jc._get_scale_fn(model, dense_stages, capacity)
    raw = []
    for si in range(24):
        s = 1.2 ** si
        sh, sw = int(h / s), int(w / s)
        if sh < wh + 2 or sw < ww + 2:
            break
        scaled = jc.imgproc.resize_bilinear(jnp.asarray(img), sh, sw) if si else jnp.asarray(img)
        by, bx, alive = (np.asarray(a) for a in fn(scaled, t))
        raw += [(x * s, y * s, ww * s, wh * s) for y, x in zip(by[alive], bx[alive])]
    return raw


def _same_share(a, b) -> float:
    sa, sb = set(map(tuple, np.asarray(a, np.float32))), set(map(tuple, np.asarray(b, np.float32)))
    return len(sa & sb) / max(len(sa | sb), 1)


@pytest.mark.parametrize("capacity", [2048, 64])
def test_haar_detect_multi_scale_equals_jitted(models, capacity):
    """Raw hits >= 99.9 % equal and grouped boxes equal to the jitted JAX
    detector; capacity 64 overflows the survivor compaction at the first
    scales, so the tie order of `masked_top_k` decides which windows
    survive."""
    haar, _ = models
    for seed in (1, 3):
        scene = _scene(seed)
        want_raw = _jax_raw_hits(scene, haar, capacity=capacity)
        got_raw = tc.raw_hits(scene, haar, capacity=capacity, device="cpu")
        assert len(want_raw) > 0 and _same_share(got_raw, want_raw) >= 0.999
        wb, wc = jc.detect_multi_scale(jnp.asarray(scene), haar, capacity=capacity, group_threshold=1)
        gb, gc = tc.detect_multi_scale(scene, haar, capacity=capacity, group_threshold=1, device="cpu")
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gc, wc)


def test_lbp_detect_multi_scale_equals_jitted(models):
    _, lbp = models
    for seed in (1, 3):
        scene = _scene(seed)
        wb, wc = jc.detect_multi_scale_lbp(jnp.asarray(scene), lbp, group_threshold=1)
        gb, gc = tc.detect_multi_scale_lbp(scene, lbp, group_threshold=1, device="cpu")
        assert len(wb) > 0
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("n_clusters,size", [(6, 8), (40, 30)])
def test_group_rectangles_equal(n_clusters, size):
    """Clusters of 1..size-1 jittered rects (the larger case has chains
    that merge clusters in the union-find's order)."""
    rng = np.random.default_rng(5)
    rects = np.concatenate([
        np.column_stack([c + rng.normal(0, 2, (k, 2)), 40 + rng.normal(0, 1, (k, 2))])
        for c, k in zip(rng.uniform(0, 200, (n_clusters, 2)), rng.integers(1, size, n_clusters))
    ]).astype(np.float32)
    for thr, eps in ((0, 0.2), (2, 0.2), (1, 0.5)):
        wb, wc = jc.group_rectangles(rects, thr, eps)
        gb, gc = tc.group_rectangles(rects, thr, eps)
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gc, wc)


def test_xml_from_the_jax_writers(models, tmp_path):
    """XML written by the JAX package's writers reads into an equal model
    with the port's loaders (and equal to the carried-across model)."""
    haar, lbp = models
    hp, lp = str(tmp_path / "haar.xml"), str(tmp_path / "lbp.xml")
    j_train.save_opencv_cascade(haar, hp)
    j_train.save_opencv_lbp_cascade(lbp, lp)
    for got, want, ref in ((tc.load_opencv_cascade(hp), jc.load_opencv_cascade(hp),
                            convert.cascade_model(haar)),
                           (tc.load_opencv_lbp_cascade(lp), jc.load_opencv_lbp_cascade(lp),
                            convert.lbp_cascade_model(lbp))):
        assert got.window == want.window == ref.window
        for f in got._fields[1:]:
            a, b, c = np.asarray(getattr(got, f)), np.asarray(getattr(want, f)), np.asarray(getattr(ref, f))
            assert a.dtype == b.dtype == c.dtype, f
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(a, c, rtol=1e-6)  # the writers print 10 digits
    with pytest.raises(ValueError):
        tc.load_opencv_cascade(lp)
    with pytest.raises(ValueError):
        tc.load_opencv_lbp_cascade(hp)


def test_haar_feature_values_bit_equal_eager(models):
    """Every stump's normalized feature value at every window, the port's
    one-gather stage against eager JAX's rect-by-rect slices, bit for bit,
    on a float scene whose integral of squares passes 2^24 (so the order
    of every add counts; a stump's decision is this value against its
    threshold)."""
    from opencv_tpu.core import imgproc as j_imgproc
    from opencv_tpu_torch.core import imgproc as t_imgproc

    haar, _ = models
    rng = np.random.default_rng(4)
    scene = rng.uniform(0, 255, (200, 260)).astype(np.float32)
    wh, ww = haar.window
    oh, ow = 200 - wh + 1, 260 - ww + 1
    t = torch.from_numpy(scene)
    ii, ii2 = t_imgproc.integral(t), t_imgproc.integral(t * t)
    inv_nf, _ = tc._norm_map(ii, ii2, wh, ww, oh, ow)
    stages = tc._dense_tables(haar, len(haar.stage_thresholds), "cpu")
    with jax.disable_jit():
        img = jnp.asarray(scene)
        jii, jii2 = j_imgproc.integral(img), j_imgproc.integral(img * img)
        jinv, _ = jc._norm_map(jii, jii2, wh, ww, oh, ow)
        np.testing.assert_array_equal(inv_nf.numpy(), np.asarray(jinv))
        for s, st in enumerate(stages):
            got = tc._feature_values(ii, inv_nf, st, oh, ow).numpy()
            for k, g in enumerate(range(haar.stage_offsets[s], haar.stage_offsets[s + 1])):
                fsum = jnp.zeros((oh, ow), jnp.float32)
                for x0, y0, rw, rh, wt in haar.rects[haar.feature[g]]:
                    if wt != 0.0:
                        fsum = fsum + wt * jc._window_sums(jii, int(y0), int(x0), int(rh), int(rw), oh, ow)
                np.testing.assert_array_equal(got[k], np.asarray(fsum * jinv))
