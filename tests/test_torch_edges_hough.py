"""Canny and the Hough line transforms of the PyTorch port (ops/edges.py,
ops/hough.py) against the JAX package on the CPU, on the scenes of
tests/test_edges_hough.py and on the lane scene of
examples/lane_detection.py (circles and the generalized transform:
tests/test_torch_hough2.py).

Tolerances: Canny masks equal. The port takes the theta table's cos/sin
in f64 rounded to f32; XLA's f32 cos/sin differ from that by at most an
ulp at a few of the 180 thetas (held below), so a pixel whose rho lies
within an ulp of a bin edge can vote one bin over. The accumulators may
differ by one moved vote per 10 000 (an L1 distance of 2 per moved
vote); lines equal; segment ends within 0.5 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.core import imgproc as jimg
from opencv_tpu.ops import edges as jedges
from opencv_tpu.ops import hough as jhough
from opencv_tpu_torch.core import imgproc as timg
from opencv_tpu_torch.ops import edges as tedges
from opencv_tpu_torch.ops import hough as though

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

from test_edges_hough import draw_line


def _canny_images():
    img_step = np.zeros((64, 64), np.float32)
    img_step[:, 32:] = 200.0
    img_hyst = np.zeros((64, 64), np.float32)
    ramp = np.concatenate([np.full(20, 60.0), np.full(24, 200.0), np.full(20, 60.0)])
    img_hyst[:, 32:] = ramp[:, None]
    noise = np.random.default_rng(1234).normal(0, 2.0, size=(64, 64)).astype(np.float32)
    return {"step": (img_step, 40, 100), "hysteresis": (img_hyst, 20, 100),
            "noise": (noise, 40, 100), "noise_low": (noise * 20, 20, 60)}


@pytest.mark.parametrize("name", ["step", "hysteresis", "noise", "noise_low"])
@pytest.mark.parametrize("l2", [False, True])
def test_canny_equals_jax(name, l2):
    img, lo, hi = _canny_images()[name]
    want = np.asarray(jedges.canny(jnp.asarray(img), lo, hi, l2_gradient=l2))
    got = tedges.canny(torch.from_numpy(img), lo, hi, l2_gradient=l2).numpy()
    np.testing.assert_array_equal(got, want)


def test_canny_long_weak_chain():
    """A weak edge reached from a strong end only after many trips (more
    than one convergence check's worth)."""
    img = np.zeros((40, 200), np.float32)
    img[20:, :] = 60.0
    img[20:, :3] = 200.0
    want = np.asarray(jedges.canny(jnp.asarray(img), 20, 100))
    got = tedges.canny(torch.from_numpy(img), 20, 100).numpy()
    assert want.sum() > 150
    np.testing.assert_array_equal(got, want)


def _line_images():
    a = np.zeros((100, 100), np.float32)
    draw_line(a, 10, 80, 90, 80)
    draw_line(a, 40, 5, 40, 95)
    b = np.zeros((100, 100), np.float32)
    draw_line(b, 20, 30, 70, 30)
    c = np.zeros((100, 100), np.float32)
    draw_line(c, 10, 50, 40, 50)
    draw_line(c, 44, 50, 80, 50)
    d = np.zeros((90, 130), np.float32)
    draw_line(d, 5, 80, 120, 12)
    draw_line(d, 30, 3, 70, 85)
    noise = np.random.default_rng(1234).random((100, 100)) > 0.9
    return {"cross": a > 100, "segment": b > 100, "gap": c > 100, "oblique": d > 100,
            "noise": noise}


def _moved_votes(got, want):
    return np.abs(got - want).sum() / 2


def test_theta_table_within_an_ulp_of_xla():
    """The port's cos/sin of the theta grid (f64, rounded to f32) against
    XLA's f32 cos/sin: at most one ulp apart, at a few of the 180 thetas."""
    thetas = np.asarray(jnp.arange(180, dtype=jnp.float32) * (np.pi / 180))
    for jfn, tfn in ((jnp.cos, torch.cos), (jnp.sin, torch.sin)):
        want = np.asarray(jfn(jnp.asarray(thetas))).view(np.int32).astype(np.int64)
        got = though._f32(tfn, torch.from_numpy(thetas.copy())).numpy().view(np.int32)
        ulps = np.abs(got.astype(np.int64) - want)
        assert ulps.max() <= 1 and (ulps > 0).sum() <= 8


@pytest.mark.parametrize("name", ["cross", "segment", "gap", "oblique", "noise"])
def test_accumulator_and_lines_equal_jax(name):
    e = _line_images()[name]
    jacc, jth, jrho = (np.asarray(a) for a in jhough.hough_lines_accumulator(jnp.asarray(e)))
    tacc, tth, trho = (a.numpy() for a in though.hough_lines_accumulator(torch.from_numpy(e)))
    np.testing.assert_array_equal(tth, jth)
    np.testing.assert_array_equal(trho, jrho)
    assert tacc.sum() == jacc.sum() == 180 * e.sum()
    assert _moved_votes(tacc, jacc) <= 1e-4 * jacc.sum()
    jl, jv = (np.asarray(a) for a in jhough.hough_lines(jnp.asarray(e), 30.0, 8))
    tl, tv = (a.numpy() for a in though.hough_lines(torch.from_numpy(e), 30.0, 8))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tl[tv], jl[jv])


@pytest.mark.parametrize("name,kw", [
    ("segment", dict(min_line_length=30, max_line_gap=3)),
    ("gap", dict(min_line_length=50, max_line_gap=6)),
    ("oblique", dict(min_line_length=40, max_line_gap=2)),
    ("cross", dict(min_line_length=20, max_line_gap=0)),
])
def test_segments_equal_jax(name, kw):
    e = _line_images()[name]
    want = jhough.hough_segments(jnp.asarray(e), threshold=30.0, **kw)
    got = though.hough_segments(torch.from_numpy(e), threshold=30.0, **kw)
    valid = np.asarray(want.valid)
    assert valid.any()
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_allclose(got.xyxy.numpy()[valid], np.asarray(want.xyxy)[valid], atol=0.5)


def lane_image(h=240, w=320, s=1):
    """examples/lane_detection.py's road (two lanes on noise), its lane
    coordinates scaled by `s`."""
    rng = np.random.default_rng(0)
    img = rng.uniform(20, 60, size=(h, w)).astype(np.float32)
    for x0, y0, x1, y1 in ((80, 230, 150, 120), (260, 230, 180, 120)):
        n = int(max(abs(x1 - x0), abs(y1 - y0)) * s * 2 + 1)
        t = np.linspace(0, 1, n)
        xs = np.round(s * (x0 + t * (x1 - x0))).astype(int)
        ys = np.round(s * (y0 + t * (y1 - y0))).astype(int)
        for d in range(2):
            img[np.clip(ys, 0, h - 1), np.clip(xs + d, 0, w - 1)] = 220.0
    return img


def _has_segment_near(xyxy, p, q, tol=12):
    p, q = np.asarray(p, np.float64), np.asarray(q, np.float64)
    for sgm in xyxy:
        a, b = sgm[:2], sgm[2:]
        if min(np.linalg.norm(a - p) + np.linalg.norm(b - q),
               np.linalg.norm(a - q) + np.linalg.norm(b - p)) < 2 * tol:
            return True
    return False


def test_lane_flow_finds_both_lanes_in_both_packages():
    img = lane_image()
    kw = dict(threshold=30.0, min_line_length=60, max_line_gap=5, max_lines=16)
    je = jedges.canny(jimg.gaussian_blur(jnp.asarray(img), 5, 1.5), 60, 120)
    te = tedges.canny(timg.gaussian_blur(torch.from_numpy(img), 5, 1.5), 60, 120)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    js = jhough.hough_segments(je, **kw)
    ts = though.hough_segments(te, **kw)
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    for segs in (np.asarray(js.xyxy)[np.asarray(js.valid)], ts.xyxy.numpy()[ts.valid.numpy()]):
        assert _has_segment_near(segs, (80, 230), (150, 120))
        assert _has_segment_near(segs, (260, 230), (180, 120))
    np.testing.assert_allclose(ts.xyxy.numpy()[ts.valid.numpy()],
                               np.asarray(js.xyxy)[np.asarray(js.valid)], atol=0.5)


def test_box_filter_equals_jax():
    img = np.random.default_rng(9).uniform(0, 9, (33, 47)).astype(np.float32)
    np.testing.assert_array_equal(timg.box_filter(torch.from_numpy(img), 3).numpy(),
                                  np.asarray(jimg.box_filter(jnp.asarray(img), 3)))
