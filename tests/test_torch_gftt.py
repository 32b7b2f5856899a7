"""goodFeaturesToTrack of the PyTorch port (ops/gftt.py) against the JAX
package on the CPU, on the checker image and on a rendered frame.

The corner response is bit-equal to eager JAX: its block sums run in the
order XLA's CPU backend gives jnp.cumsum (blocks of 16, then the block
totals), and its square root is correctly rounded, as XLA's is. So the
corners, their order, their responses and the valid mask are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.core import imgproc as jimg
from opencv_tpu.ops import gftt as jgftt
from opencv_tpu_torch.core import imgproc as timg
from opencv_tpu_torch.ops import gftt as tgftt

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

from test_torch_orb import _frame


@pytest.fixture(scope="module")
def images(checker_image):
    return {"checker": np.array(checker_image), "frame": _frame()}


def _corners(kp):
    xy = np.asarray(kp.xy)
    valid = np.asarray(kp.valid)
    resp = np.asarray(kp.response)
    return {tuple(p): r for p, r in zip(xy[valid], resp[valid])}, valid


@pytest.mark.parametrize("name", ["checker", "frame"])
@pytest.mark.parametrize("kw", [
    dict(max_corners=300, min_distance=7.0),
    dict(max_corners=512, min_distance=7.0, quality_level=0.01),
    dict(max_corners=1000, min_distance=10.0),
    dict(max_corners=2000, min_distance=0.0),
    dict(max_corners=200, min_distance=7.0, use_harris=True),
], ids=["grid7", "lk_path", "grid10_all", "no_grid", "harris"])
def test_same_corners_as_jax(images, name, kw):
    img = images[name]
    want = jgftt.good_features_to_track(jnp.asarray(img), **kw)
    got = tgftt.good_features_to_track(img, device="cpu", **kw)
    assert np.asarray(want.valid).sum() > 20
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.xy.numpy(), np.asarray(want.xy))
    np.testing.assert_array_equal(got.response.numpy(), np.asarray(want.response))


def test_min_eig_response_within_prefix_sum_rounding(images):
    img = images["frame"]
    want = np.asarray(jimg.min_eig_response(jnp.asarray(img)))
    got = timg.min_eig_response(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 7, 16, 17, 100, 257, 645, 4100])
def test_block_scan_is_xla_cumsum(rng, n):
    x = (rng.standard_normal((3, n)) * 1000).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1))
    np.testing.assert_array_equal(timg._block_scan(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("ksize", [3, 5, 7])
def test_box_sums_in_xla_order_bit_equal(images, ksize):
    img = images["frame"]
    np.testing.assert_array_equal(
        timg.box_sum_integral(torch.from_numpy(img), ksize, xla_order=True).numpy(),
        np.asarray(jimg.box_sum_integral(jnp.asarray(img), ksize)))
    np.testing.assert_array_equal(
        timg.harris_response(torch.from_numpy(img), ksize, deriv="sobel", xla_order=True).numpy(),
        np.asarray(jimg.harris_response(jnp.asarray(img), ksize, deriv="sobel")))


def test_record_layout_and_default_device(images, monkeypatch):
    kp = tgftt.good_features_to_track(images["checker"], max_corners=50, device="cpu")
    assert kp.xy.shape == (50, 2) and kp.valid.dtype == torch.bool
    assert torch.all(kp.response[:-1] >= kp.response[1:])  # strongest first
    assert torch.all(kp.size == 3.0) and torch.all(kp.level == 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgftt.good_features_to_track(images["checker"])
