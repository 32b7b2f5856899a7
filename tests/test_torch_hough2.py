"""Hough circles and the generalized Hough transform of the PyTorch port
(ops/hough.py) against the JAX package on the CPU, on the scenes of
tests/test_hough2.py.

Tolerance: equal detections, R-tables and votes. The centre and vote
indices are the same f32 arithmetic in both; the port's sqrt and atan2
are taken in f64 and rounded to f32, which on these scenes equals XLA's
f32 results.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.ops import hough as jhough
from opencv_tpu_torch.ops import hough as though

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

from test_hough2 import _disk_image


def test_hough_circles_equal_jax():
    img = _disk_image([(40, 40, 12), (110, 70, 18), (60, 100, 9)])
    kw = dict(min_radius=6, max_radius=24, acc_threshold=12.0, min_dist=12, max_circles=8)
    want = jhough.hough_circles(jnp.asarray(img), **kw)
    got = though.hough_circles(torch.from_numpy(img), **kw)
    valid = np.asarray(want.valid)
    assert valid.sum() >= 3
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.xyr.numpy(), np.asarray(want.xyr))
    np.testing.assert_array_equal(got.votes.numpy(), np.asarray(want.votes))


def _template():
    t = np.full((40, 40), 20.0, np.float32)
    t[8:32, 8:14] = 220.0
    t[26:32, 8:30] = 220.0
    return t


@pytest.mark.parametrize("rotated", [False, True])
def test_generalized_hough_equals_jax(rotated):
    t = _template()
    img = np.full((120, 150), 20.0, np.float32)
    if rotated:
        img[40:80, 60:100] = np.rot90(t)
        angles = (0.0, np.pi / 2, np.pi, 3 * np.pi / 2)
    else:
        img[50:90, 80:120] = t
        img[15:25, 15:25] = 220.0
        angles = (0.0,)
    jtab = jhough.build_r_table(jnp.asarray(t), n_bins=24, cap=48)
    ttab = though.build_r_table(torch.from_numpy(t), n_bins=24, cap=48)
    np.testing.assert_array_equal(ttab.count.numpy(), np.asarray(jtab.count))
    np.testing.assert_array_equal(ttab.disp.numpy(), np.asarray(jtab.disp))
    want = jhough.generalized_hough(jnp.asarray(img), jtab, vote_threshold=40.0,
                                    max_detections=4, angles=angles)
    got = though.generalized_hough(torch.from_numpy(img), ttab, vote_threshold=40.0,
                                   max_detections=4, angles=angles)
    valid = np.asarray(want.valid)
    assert valid.any()
    for field in ("valid", "xy", "votes", "angle", "scale"):
        np.testing.assert_array_equal(getattr(got, field).numpy()[valid],
                                      np.asarray(getattr(want, field))[valid], err_msg=field)
