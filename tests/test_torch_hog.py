"""HOG of the PyTorch port (ops/hog.py) against the JAX package on the CPU,
on tests/test_hog.py's images and detector.

Tolerances: the vote map, block features, descriptors and score maps
within 1e-4 (relative to each array's largest magnitude: torch's and
XLA's atan2 and the convolutions' summation orders differ in the last
ulps); `load_opencv_detector` exact (a reshape); `detect_multi_scale`
the same valid boxes and scores within 1e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.ops import hog as jhog
from opencv_tpu_torch import convert
from opencv_tpu_torch.ops import hog as thog

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

from test_hog import make_bar_window


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1.0))


def _images():
    rng = np.random.default_rng(1234)
    scene = rng.uniform(0, 60, size=(160, 96)).astype(np.float32)
    scene[16:106, 40:52] += 150.0
    edges = np.tile(np.repeat(np.array([0.0, 100.0], np.float32), 4)[None, :], (64, 8))
    return {"bar": make_bar_window(rng, True), "noise": make_bar_window(rng, False),
            "scene": scene, "edges": edges}


@pytest.fixture(scope="module")
def images():
    return _images()


@pytest.fixture(scope="module")
def svm():
    """test_hog.py's ridge "SVM", fitted on JAX descriptors."""
    rng = np.random.default_rng(11)
    X, y = [], []
    for _ in range(60):
        for on, label in ((True, 1.0), (False, -1.0)):
            X.append(np.asarray(jhog.compute_descriptor(jnp.asarray(make_bar_window(rng, on)))))
            y.append(label)
    X, y = np.stack(X), np.asarray(y)
    w = np.linalg.solve(X.T @ X + 1e-2 * np.eye(X.shape[1]), X.T @ y)
    return w.astype(np.float32), float(-(X @ w).mean())


@pytest.mark.parametrize("name", ["bar", "noise", "scene", "edges"])
def test_vote_map_and_block_histograms_equal_jax(images, name):
    img = images[name]
    t = torch.from_numpy(img)
    _close(thog.vote_map(t), jhog.vote_map(jnp.asarray(img)))
    _close(thog.block_histograms(t), jhog.block_histograms(jnp.asarray(img)))
    cells = thog.cell_histograms(t)
    _close(cells, jhog.cell_histograms(jnp.asarray(img)))
    _close(thog.block_features(cells), jhog.block_features(jhog.cell_histograms(jnp.asarray(img))))


@pytest.mark.parametrize("name", ["bar", "noise"])
def test_compute_descriptor_equals_jax(images, name):
    got = thog.compute_descriptor(images[name], device="cpu")
    assert got.shape == (3780,)
    _close(got, jhog.compute_descriptor(jnp.asarray(images[name])))
    with pytest.raises(ValueError):
        thog.compute_descriptor(images["scene"], device="cpu")


def test_score_map_equals_jax(images, svm):
    w, b = svm
    tw, tb = convert.hog_detector(w, b, device="cpu")
    want = np.asarray(jhog.score_map(jnp.asarray(images["scene"]), jnp.asarray(w), b))
    got = thog.score_map(torch.from_numpy(images["scene"]), tw, tb)
    _close(got, want)


def test_load_opencv_detector_exact():
    vec = np.random.default_rng(3781).normal(size=3781).astype(np.float32)
    jw, jb = jhog.load_opencv_detector(vec)
    tw, tb = thog.load_opencv_detector(vec, device="cpu")
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tb == jb
    tw, tb = thog.load_opencv_detector(vec[:3780], device="cpu")
    assert tb == 0.0
    with pytest.raises(ValueError):
        thog.load_opencv_detector(vec[:100], device="cpu")


def test_detect_multi_scale_equals_jax(svm):
    """test_hog.py's planted-bar 256x320 scene at n_scales=4."""
    w, b = svm
    rng = np.random.default_rng(1234)
    img = rng.uniform(0, 40, size=(256, 320)).astype(np.float32)
    img[60:150, 140:152] += 160.0
    # jitted: eager JAX takes ~20 s here
    want = jax.jit(functools.partial(jhog.detect_multi_scale, bias=b, n_scales=4,
                                     hit_threshold=0.2))(jnp.asarray(img), jnp.asarray(w))
    tw, tb = convert.hog_detector(w, b, device="cpu")
    got = thog.detect_multi_scale(img, tw, tb, n_scales=4, hit_threshold=0.2, device="cpu")
    valid = np.asarray(want.valid)
    assert valid.sum() >= 1
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.boxes.numpy()[valid], np.asarray(want.boxes)[valid])
    np.testing.assert_allclose(got.scores.numpy()[valid], np.asarray(want.scores)[valid], atol=1e-3)
    x, y, bw, bh = got.boxes.numpy()[0]
    assert x <= 146 <= x + bw and y <= 105 <= y + bh


def test_detect_multi_scale_runs_to_the_last_scale_that_fits(svm):
    """480x640 at the reference's 64 levels stops after 28 scales; the last
    score maps hold fewer than max_detections positions (where the JAX
    function raises), and the record keeps its max_detections rows."""
    w, b = svm
    img = np.random.default_rng(0).uniform(0, 40, size=(480, 640)).astype(np.float32)
    img[100:190, 300:312] += 160.0
    det = thog.detect_multi_scale(img, w, b, n_scales=64, device="cpu")
    assert det.boxes.shape == (64, 4) and det.scores.shape == (64,) and det.valid.shape == (64,)
    assert det.valid.any()
    assert float(det.boxes[det.valid][:, 3].max()) <= 128 * 1.05 ** 27 + 1e-3
