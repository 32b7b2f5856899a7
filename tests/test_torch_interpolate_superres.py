"""Frame interpolation and BTV-L1 super-resolution of the PyTorch port
against the JAX package on the CPU, on seeded 64x96 textures.

Tolerances:
- interpolate_frames: within 0.05 grey on average and on 99 % of pixels
  (its Farneback flows agree to 1e-3 px on average,
  test_torch_flow.py).
- btv_l1_superres: equal to eager JAX (`jax.disable_jit`), whose order the
  port follows. BTV-L1 descends along the signs of residuals; against
  the compiled loop a residual at a near tie takes the other sign at a
  few pixels (0.085 grey at the 99th percentile after 20 iterations).
- btv_l1_superres_flow: within 0.05 grey on average and on 99 % of pixels
  of eager JAX: the flows' 2x upscaling is within 1 ulp of JAX's (XLA's
  interpolation einsum may fuse the two taps into an FMA) and the frames'
  mean is a library sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from opencv_tpu.ops import interpolate as jinterp
from opencv_tpu.ops import superres as jsuperres
from opencv_tpu_torch.ops import interpolate, superres

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

from test_torch_flow import texture

ITERS = 8


def _eager(fn, *args, **kw):
    with jax.disable_jit():
        return np.asarray(fn(*args, **kw))


def _close_images(got, want):
    d = np.abs(got - want)
    assert d.mean() <= 0.05 and np.quantile(d, 0.99) <= 0.05, (d.mean(), np.quantile(d, 0.99))


@pytest.mark.parametrize("t", [0.5, 0.25])
def test_interpolate_frames_agrees(t):
    a = texture()
    b = np.roll(a, (2, 3), axis=(0, 1))
    want = np.asarray(jinterp.interpolate_frames(jnp.asarray(a), jnp.asarray(b), t))
    got = interpolate.interpolate_frames(a, b, t, device="cpu").numpy()
    _close_images(got, want)


def _lowres_frames(k: int = 4, seed: int = 2):
    """k shifted copies of a 64x96 texture, each blurred and decimated 2x,
    with their shifts (low-res px)."""
    hi = texture(seed)
    rng = np.random.default_rng(seed)
    shifts = np.concatenate([[[0.0, 0.0]], rng.uniform(-1, 1, (k - 1, 2))]).astype(np.float32)
    frames = []
    for dx, dy in shifts:
        moved = np.asarray(jsuperres._shift_bilinear(jnp.asarray(hi), 2 * dx, 2 * dy))
        frames.append(np.asarray(jsuperres._downsample(jnp.asarray(moved), 2)))
    return np.stack(frames), shifts


def test_btv_l1_superres_agrees():
    frames, shifts = _lowres_frames()
    want = _eager(jsuperres.btv_l1_superres, jnp.asarray(frames), jnp.asarray(shifts), iters=ITERS)
    got = superres.btv_l1_superres(frames, shifts, iters=ITERS, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_btv_l1_superres_flow_agrees():
    frames, shifts = _lowres_frames()
    k, h, w = frames.shape
    flows = np.broadcast_to(shifts[:, None, None, :], (k, h, w, 2)).astype(np.float32)
    flows = flows + np.random.default_rng(5).normal(0, 0.2, flows.shape).astype(np.float32)
    want = _eager(jsuperres.btv_l1_superres_flow, jnp.asarray(frames), jnp.asarray(flows),
                  jnp.asarray(-flows), iters=ITERS)
    got = superres.btv_l1_superres_flow(frames, flows, -flows, iters=ITERS, device="cpu").numpy()
    _close_images(got, want)
