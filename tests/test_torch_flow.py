"""Dense flow of the PyTorch port (Farneback, TV-L1) against the JAX
package on the CPU, on a seeded 64x96 texture moved by a known shift
(Brox: test_torch_brox.py; frame interpolation and super-resolution:
test_torch_interpolate_superres.py).

Tolerances:
- Farneback, TV-L1: mean |flow difference| <= 1e-3 px and max <= 0.05
  px. The JAX functions run their iterations in compiled loops
  (`lax.fori_loop`), where XLA contracts multiply-adds into FMAs; the
  port rounds each operation, and the last-ulp differences pass through
  up to 750 iterations (TV-L1 at 3 levels).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.core import imgproc as jimg
from opencv_tpu.ops import farneback as jfarneback
from opencv_tpu.ops import tvl1 as jtvl1
from opencv_tpu_torch.ops import farneback, tvl1

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)


def texture(seed: int = 0, h: int = 64, w: int = 96) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, size=(h, w)).astype(np.float32)
    return np.asarray(jimg.gaussian_blur(jnp.asarray(img), 7, 2.0))


@pytest.fixture(scope="module")
def moved_pair():
    img = texture()
    return img, np.roll(img, (2, 3), axis=(0, 1))


def _close_flows(got, want):
    d = np.abs(got - want)
    assert d.mean() <= 1e-3 and d.max() <= 0.05, (d.mean(), d.max())


def test_farneback_agrees(moved_pair):
    a, b = moved_pair
    want = np.asarray(jfarneback.calc_optical_flow_farneback(jnp.asarray(a), jnp.asarray(b)))
    got = farneback.calc_optical_flow_farneback(a, b, device="cpu").numpy()
    _close_flows(got, want)
    assert abs(np.median(got[16:-16, 16:-16, 0]) - 3.0) < 0.5


def test_poly_expansion_agrees():
    img = texture(1)
    want = np.asarray(jfarneback.poly_expansion(jnp.asarray(img)))
    got = farneback.poly_expansion(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_tvl1_agrees(moved_pair):
    a, b = moved_pair
    want = np.asarray(jtvl1.calc_optical_flow_tvl1(jnp.asarray(a), jnp.asarray(b), n_levels=3))
    got = tvl1.calc_optical_flow_tvl1(a, b, n_levels=3, device="cpu").numpy()
    _close_flows(got, want)
    assert abs(np.median(got[20:-20, 20:-20, 1]) - 2.0) < 0.4
