"""ECC alignment and video stabilization of the PyTorch port against the
JAX package on the CPU.

Tolerances.
- find_transform_ecc: the same residual (warp, crop, normalize) and LM
  schedule, forward-mode Jacobians on both sides; the sums run in other
  orders: warp within 1e-4, correlation within 1e-5 (measured ~2e-6).
- estimate_global_motion on one pair, fed the subsets that JAX drew:
  GFTT is bit-equal, LK agrees at 0.05 px on conditioned points, and the
  affine is a least-squares fit over the inliers. Held within 0.05 px
  (the LK rule) at the frame's four corners.
- smooth_trajectory and inpaint_borders are the JAX package's host
  numpy: equal. suppress_wobble and deblur_weiner_gaussian go through
  other FFT codes (pocketfft in both, other plans): within 1e-4 of the
  motions' and 5e-3 of the grey levels' scale.
- stabilize (port only: its RANSAC draws from torch's generator): the
  JAX test's bound, jitter < 0.6 of the input's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.core import imgproc as jimg
from opencv_tpu.core.config import LKConfig as JLKConfig
from opencv_tpu.geometry import ransac as jransac
from opencv_tpu.ops import ecc as jecc
from opencv_tpu.ops import gftt as jgftt
from opencv_tpu.ops import lk as jlk
from opencv_tpu.ops import videostab as jvs
from opencv_tpu_torch.ops import ecc as tecc
from opencv_tpu_torch.ops import videostab as tvs

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)


def _texture(rng, h, w):
    img = rng.uniform(0, 255, size=(h, w)).astype(np.float32)
    return np.asarray(jimg.gaussian_blur(jnp.asarray(img), 7, 2.0))


def _warp(img, m, h, w):
    return np.asarray(jimg.warp_affine(jnp.asarray(img), jnp.asarray(m, jnp.float32), h, w))


ECC_CASES = {
    "translation": [[1.0, 0.0, 3.5], [0.0, 1.0, -2.0]],
    "euclidean": [[math.cos(0.03), -math.sin(0.03), 1.5], [math.sin(0.03), math.cos(0.03), -1.0]],
    "affine": [[1.02, 0.03, 2.0], [-0.02, 0.98, 1.5]],
}


@pytest.mark.parametrize("motion", sorted(ECC_CASES))
def test_find_transform_ecc_close_to_jax(rng, motion):
    img = _texture(rng, 96, 128)
    m = np.asarray(ECC_CASES[motion], np.float32)
    tmpl = _warp(img, m, 96, 128)
    wj, rj = jecc.find_transform_ecc(jnp.asarray(tmpl), jnp.asarray(img), motion)
    wt, rt = tecc.find_transform_ecc(tmpl, img, motion, device="cpu")
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0, atol=1e-4)
    assert abs(float(rt) - float(rj)) < 1e-5
    np.testing.assert_allclose(wt.numpy(), m, rtol=0, atol=0.05)
    assert float(rt) > 0.98
    with pytest.raises(ValueError):
        tecc.find_transform_ecc(tmpl, img, "homography", device="cpu")


def _corner_px(a, b, h, w):
    """Largest distance between two affine maps at a frame's corners."""
    c = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]], np.float64)
    return float(np.abs(c @ np.asarray(a, np.float64).T - c @ np.asarray(b, np.float64).T).max())


def test_estimate_global_motion_close_to_jax(rng):
    """A shifted, slightly rotated crop of a larger texture (no clamped
    border), RANSAC on the subsets JAX draws from its key."""
    big = _texture(rng, 160, 200)
    h, w = 120, 160
    f0 = _warp(big, [[1.0, 0.0, 20.0], [0.0, 1.0, 20.0]], h, w)
    c, s = math.cos(0.01), math.sin(0.01)
    f1 = _warp(big, [[c, -s, 21.7], [s, c, 19.1]], h, w)
    key = jax.random.PRNGKey(3)
    want = jvs.estimate_global_motion(jnp.asarray(f0), jnp.asarray(f1), key)
    kp = jgftt.good_features_to_track(jnp.asarray(f0), 200, 0.01, 12.0)
    _, st, _ = jlk.calc_optical_flow_pyr_lk(jnp.asarray(f0), jnp.asarray(f1), kp.xy, kp.valid,
                                            JLKConfig(n_levels=3))
    subsets = np.asarray(jransac._sample_subsets(key, 200, st & kp.valid, 256, 3))
    got = tvs.estimate_global_motion(f0, f1, subsets=torch.from_numpy(subsets).long(), device="cpu")
    assert got.shape == (2, 3)
    assert _corner_px(got.numpy(), want, h, w) <= 0.05
    # frame1(x) = frame0(M x) in warp_affine's convention: the motion is M^-1
    assert _corner_px(got.numpy(), np.linalg.inv([[c, -s, 1.7], [s, c, -0.9], [0, 0, 1]])[:2],
                      h, w) < 0.2


def test_affine_fit_is_lstsq(rng):
    """The f64 normal equations give lstsq's solution, and its minimum-norm
    one where the weighted rows are rank deficient."""
    p0 = rng.uniform(0, 100, (30, 2)).astype(np.float32)
    p1 = (p0 @ np.array([[1.01, 0.02], [-0.03, 0.99]], np.float32).T + [3.0, -2.0]
          + rng.normal(0, 0.3, p0.shape)).astype(np.float32)
    for w in (np.ones(30), (np.arange(30) < 2).astype(np.float64)):
        a = np.c_[p0, np.ones(30)] * w[:, None]
        want = np.linalg.lstsq(a, p1 * w[:, None], rcond=None)[0].T
        got, ok = tvs._affine_from_pairs(torch.from_numpy(p0), torch.from_numpy(p1),
                                         torch.from_numpy(w).float())
        assert bool(ok)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


def test_smooth_trajectory_and_inpaint_borders_equal_jax(rng):
    motions = rng.normal(0, 1, (15, 2, 3)).astype(np.float32)
    for radius in (1, 4):
        np.testing.assert_array_equal(tvs.smooth_trajectory(motions, radius),
                                      jvs.smooth_trajectory(motions, radius))
    frames = [rng.uniform(0, 255, (24, 32)).astype(np.float32) for _ in range(5)]
    masks = [rng.random((24, 32)) > 0.2 for _ in range(5)]
    for a, b in zip(tvs.inpaint_borders(frames, masks), jvs.inpaint_borders(frames, masks)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("period,strength", [(2, 1.0), (3, 0.5)])
def test_suppress_wobble_close_to_jax(period, strength):
    """tests/test_videostab2.py's drifting, alternating motion sequence."""
    t = np.arange(40)
    motions = np.zeros((40, 2, 3), np.float32)
    motions[:, 0, 2] = 0.5 * np.sin(t / 15.0) + 0.3 * (-1.0) ** t
    motions[:, 1, 2] = 0.02 * t
    motions[:, 0, 0] = 1.0 + 0.01 * np.cos(t / 3.0)
    got = tvs.suppress_wobble(motions, period, strength, device="cpu")
    want = jvs.suppress_wobble(motions, period, strength)
    assert got.shape == (40, 2, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if period == 2 and strength == 1.0:
        assert np.abs(got[5:-5, 0, 2] - 0.5 * np.sin(t[5:-5] / 15.0)).max() < 0.05


@pytest.mark.parametrize("motion_px,angle", [(5.0, 0.0), (3.0, 0.7)])
def test_deblur_weiner_gaussian_close_to_jax(rng, motion_px, angle):
    """tests/test_videostab2.py's 5 px horizontal box blur."""
    img = np.asarray(jimg.gaussian_blur(
        jnp.asarray(rng.uniform(0, 255, (64, 80)).astype(np.float32)), 5, 1.5))
    blurred = np.mean([np.roll(img, i - 2, axis=1) for i in range(5)], axis=0).astype(np.float32)
    got = tvs.deblur_weiner_gaussian(blurred, motion_px, angle, device="cpu").numpy()
    want = np.asarray(jvs.deblur_weiner_gaussian(jnp.asarray(blurred), motion_px, angle))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)
    if angle == 0.0:
        inner = (slice(8, -8), slice(8, -8))
        assert np.abs(got[inner] - img[inner]).mean() < 0.85 * np.abs(blurred[inner] - img[inner]).mean()


def test_stabilize_reduces_jitter(rng):
    """tests/test_photo_videostab.py's jittered texture at its 12 frames
    (on 8 frames both packages reach 0.615 of the input's jitter, above
    the bound)."""
    base = _texture(rng, 80, 100)
    jitter = np.cumsum(rng.normal(0, 1.5, size=(12, 2)), axis=0).astype(np.float32)
    frames = [_warp(base, [[1.0, 0.0, jx], [0.0, 1.0, jy]], 80, 100) for jx, jy in jitter]
    stab = tvs.stabilize(frames, radius=4, device="cpu")
    assert stab.shape == (12, 80, 100)

    def frame_jitter(seq):
        seq = [np.asarray(f) for f in seq]
        return np.mean([np.abs(a[20:-20, 20:-20] - b[20:-20, 20:-20]).mean()
                        for a, b in zip(seq[:-1], seq[1:])])

    assert frame_jitter(stab.numpy()) < frame_jitter(frames) * 0.6
