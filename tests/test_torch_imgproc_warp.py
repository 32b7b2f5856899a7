"""The rest of imgproc in the PyTorch port (to_gray, threshold, Otsu,
integral, the affine, perspective and polar warps) against the JAX
package on the CPU.

Tolerances. Bit-equal to eager JAX: to_gray (XLA's FMA chain, rounded
the same way), the 5 threshold kinds, otsu_threshold (exact histogram,
prefix sums in XLA's order), integral (the same), warp_affine and
warp_perspective (each product and sum rounded as eager JAX rounds it,
then the shared bilinear sampler). The polar warps call exp, log, cos,
sin, sqrt and atan2, which the port takes in f64 rounded to f32 and XLA
in its own f32 versions: they differ by an ulp at some pixels, which
moves a sample by ~1e-5 px; measured <= 2e-3 grey levels on noise
images, asserted at 1e-2.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.core import imgproc as jimg
from opencv_tpu_torch.core import imgproc as timg

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)


def _noise(rng, shape, integer=True):
    img = rng.uniform(0, 255, shape).astype(np.float32)
    return np.round(img) if integer else img


@pytest.mark.parametrize("integer", [True, False])
def test_to_gray_bit_equal(rng, integer):
    rgb = _noise(rng, (61, 83, 3), integer)
    np.testing.assert_array_equal(timg.to_gray(torch.from_numpy(rgb)).numpy(),
                                  np.asarray(jimg.to_gray(jnp.asarray(rgb))))
    gray = rgb[..., 0]
    np.testing.assert_array_equal(timg.to_gray(gray).numpy(), gray)


@pytest.mark.parametrize("kind", ["binary", "binary_inv", "trunc", "tozero", "tozero_inv"])
def test_threshold_bit_equal(rng, kind):
    img = _noise(rng, (40, 52))
    for thresh in (0.0, 100.0, 127.5):
        np.testing.assert_array_equal(
            timg.threshold(torch.from_numpy(img), thresh, 200.0, kind).numpy(),
            np.asarray(jimg.threshold(jnp.asarray(img), thresh, 200.0, kind)))
    with pytest.raises(ValueError):
        timg.threshold(torch.from_numpy(img), 1.0, kind="otsu")


def _bimodal(rng, h=480, w=640):
    img = np.concatenate([rng.normal(60, 20, (h // 2, w)), rng.normal(180, 25, (h - h // 2, w))])
    return np.round(np.clip(img, 0, 255)).astype(np.float32)


@pytest.mark.parametrize("name", ["bimodal_480x640", "uniform_480x640", "small", "constant"])
def test_otsu_threshold_bit_equal(rng, name):
    """At 480x640 the level-weighted prefix sum passes 2^24."""
    img = {"bimodal_480x640": lambda: _bimodal(rng),
           "uniform_480x640": lambda: _noise(rng, (480, 640)),
           "small": lambda: _bimodal(rng, 30, 40),
           "constant": lambda: np.full((20, 30), 77.0, np.float32)}[name]()
    got = timg.otsu_threshold(torch.from_numpy(img))
    want = jimg.otsu_threshold(jnp.asarray(img))
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == float(want)


@pytest.mark.parametrize("shape", [(1, 1), (17, 33), (480, 640), (2, 37, 41)])
def test_integral_bit_equal(rng, shape):
    img = _noise(rng, shape, integer=False)
    got = timg.integral(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jimg.integral(jnp.asarray(img))))
    assert got.shape == shape[:-2] + (shape[-2] + 1, shape[-1] + 1)


AFFINE = {
    "identity": [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
    "shift": [[1.0, 0.0, 3.25], [0.0, 1.0, -2.5]],
    "similarity": [[0.9 * math.cos(0.3), -0.9 * math.sin(0.3), 12.0],
                   [0.9 * math.sin(0.3), 0.9 * math.cos(0.3), -4.0]],
    "shear": [[1.02, 0.03, 2.0], [-0.02, 0.98, 1.5]],
}


@pytest.mark.parametrize("name", sorted(AFFINE))
def test_warp_affine_bit_equal(rng, name):
    img = _noise(rng, (50, 70), integer=False)
    m = np.asarray(AFFINE[name], np.float32)
    for out_h, out_w in ((50, 70), (31, 90)):
        np.testing.assert_array_equal(
            timg.warp_affine(torch.from_numpy(img), torch.from_numpy(m), out_h, out_w).numpy(),
            np.asarray(jimg.warp_affine(jnp.asarray(img), jnp.asarray(m), out_h, out_w)))


@pytest.mark.parametrize("persp", [0.0, 1e-4, 2e-3])
def test_warp_perspective_bit_equal(rng, persp):
    img = _noise(rng, (60, 80), integer=False)
    m = np.array([[1.05, 0.04, -3.0], [-0.03, 0.97, 2.5], [persp, -persp / 2, 1.0]], np.float32)
    np.testing.assert_array_equal(
        timg.warp_perspective(torch.from_numpy(img), m, 48, 96).numpy(),
        np.asarray(jimg.warp_perspective(jnp.asarray(img), jnp.asarray(m), 48, 96)))


@pytest.mark.parametrize("log", [False, True], ids=["linear", "log"])
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_warp_polar_close(rng, log, inverse):
    img = _noise(rng, (64, 96), integer=False)
    for dsize, center, max_r in (((64, 96), (40.3, 30.2), 35.0), ((90, 50), (47.5, 31.5), 60.0)):
        got = timg.warp_polar(torch.from_numpy(img), dsize, center, max_r, log, inverse).numpy()
        want = np.asarray(jimg.warp_polar(jnp.asarray(img), dsize, center, max_r, log, inverse))
        assert got.shape == want.shape == dsize
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_linear_and_log_polar_close(rng, inverse):
    img = _noise(rng, (48, 64), integer=False)
    np.testing.assert_allclose(
        timg.linear_polar(torch.from_numpy(img), (30.0, 22.0), 28.0, inverse).numpy(),
        np.asarray(jimg.linear_polar(jnp.asarray(img), (30.0, 22.0), 28.0, inverse)),
        rtol=0, atol=1e-2)
    np.testing.assert_allclose(
        timg.log_polar(torch.from_numpy(img), (30.0, 22.0), 18.0, inverse).numpy(),
        np.asarray(jimg.log_polar(jnp.asarray(img), (30.0, 22.0), 18.0, inverse)),
        rtol=0, atol=1e-2)
