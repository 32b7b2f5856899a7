"""The LK window sampler of the PyTorch port (K4 and K5, ops/cuda/lk_sample.py)
against the JAX package on the CPU: the plain versions against the Pallas
kernels in interpret mode and against the XLA sampler `lk._sample_at`, on
every case of tests/test_pallas_lk_sample.py.

Tolerance: rtol 1e-5, atol 1e-3, as tests/test_pallas_lk_sample.py holds
the Pallas kernels to the XLA sampler. The plain versions sum the four
taps (K4) or the two row blends (K5) in the Pallas kernels' order with
separate roundings; XLA fuses some of those products into FMAs, which
moves the last bits (measured: at most 3.1e-5 on values near 100). The
win-48 patch extraction samples at integer points, where every product
is exact, and is asserted bit for bit through bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.core import imgproc as jimg
from opencv_tpu.ops import lk as jlk
from opencv_tpu.ops.pallas.lk_sample import (
    sample_channels_pallas,
    sample_single_pallas,
    sample_templates_pallas,
    sample_windows_pallas,
)
from opencv_tpu_torch.ops import cuda as cuda_ops
from opencv_tpu_torch.ops.cuda import lk_sample

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

TOL = dict(rtol=1e-5, atol=1e-3)


def _rand_image(rng, h=96, w=144):
    return rng.normal(0, 50.0, (h, w)).astype(np.float32) + 100.0


def _gold(img, pts, win):
    """The XLA sampler at full f32 precision; non-finite points far outside."""
    pts = np.nan_to_num(pts, nan=-1e6, posinf=1e6, neginf=-1e6)
    return np.asarray(jlk._sample_at(jnp.asarray(img), jnp.asarray(pts), win, "highest"))


def _t(a):
    return torch.from_numpy(np.array(a))


BOUNDARY = [
    [0.0, 0.0], [79.0, 63.0], [0.3, 17.2], [78.6, 30.1], [40.2, 0.7], [39.9, 62.8],
    [-3.5, 12.0], [84.0, 68.0], [-500.0, -500.0], [1e7, 12.0], [np.nan, 5.0],
    [5.0, np.inf], [12.345, 11.875], [33.0, 44.0],
]


def test_interior_templates(rng):
    img = _rand_image(rng)
    dx, dy = (np.asarray(a) for a in jimg.scharr_derivatives(jnp.asarray(img)))
    h, w = img.shape
    pts = np.stack([rng.uniform(0, w - 1, 48), rng.uniform(0, h - 1, 48)], -1).astype(np.float32)
    got = lk_sample.sample_templates(_t(img), _t(dx), _t(dy), _t(pts), 21)
    want = sample_templates_pallas(jnp.asarray(img), jnp.asarray(dx), jnp.asarray(dy),
                                   jnp.asarray(pts), win=21, interpret=True)
    for g, p, src in zip(got, want, (img, dx, dy)):
        np.testing.assert_allclose(g.numpy(), np.asarray(p), **TOL)
        np.testing.assert_allclose(g.numpy(), _gold(src, pts, 21), **TOL)


def test_boundary_outside_and_non_finite(rng):
    """Windows hanging off each border and corner, wholly outside, far
    outside and non-finite points: the zero convention of the XLA
    sampler, and exactly zero windows for the last kind."""
    img = _rand_image(rng, 64, 80)
    pts = np.array(BOUNDARY, np.float32)
    stack = np.stack([img, 0.5 * img])
    got = lk_sample.sample_channels(_t(stack), _t(pts), 21).numpy()
    want = np.asarray(sample_channels_pallas(jnp.asarray(stack), jnp.asarray(pts), win=21,
                                             interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[0], _gold(img, pts, 21), **TOL)
    assert np.all(got[:, 8:12] == 0.0)


def test_odd_point_count(rng):
    img = _rand_image(rng, 72, 96)
    pts = np.stack([rng.uniform(10, 80, 21), rng.uniform(10, 60, 21)], -1).astype(np.float32)
    got = lk_sample.sample_single(_t(img), _t(pts), 15).numpy()
    assert got.shape == (21, 15, 15)
    want = np.asarray(sample_single_pallas(jnp.asarray(img), jnp.asarray(pts), win=15,
                                           interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _gold(img, pts, 15), **TOL)


def test_integer_patch_extraction_bit_equal_through_bf16(rng):
    """win 48 at integer points: the exact pixels, and through bf16 the
    XLA patch gather of `lk._extract_patches` bit for bit."""
    img = _rand_image(rng, 128, 200)
    h, w = img.shape
    p = 48
    jy0 = np.array([0, 13, h - p, 40, 7], np.int32)
    jx0 = np.array([0, 152, w - p, 99, 3], np.int32)
    ctr = np.stack([jx0, jy0], -1).astype(np.float32) + p // 2
    got = lk_sample.sample_single(_t(img), _t(ctr), p)
    exact = np.stack([img[y: y + p, x: x + p] for y, x in zip(jy0, jx0)])
    np.testing.assert_array_equal(got.numpy(), exact)
    gold = np.asarray(jlk._extract_patches(jnp.asarray(img).astype(jnp.bfloat16)[None],
                                           jnp.asarray(jy0), jnp.asarray(jx0), p)[0])
    np.testing.assert_array_equal(got.to(torch.bfloat16).to(torch.float32).numpy(), gold)
    pal = np.asarray(sample_single_pallas(jnp.asarray(img), jnp.asarray(ctr), win=p,
                                          interpret=True))
    np.testing.assert_array_equal(got.numpy(), pal)


def test_edge_clamped_windows(rng):
    """K5 on its documented domain (points half a window inside)."""
    img = _rand_image(rng)
    h, w = img.shape
    pts = np.stack([rng.uniform(12, w - 13, 32), rng.uniform(12, h - 13, 32)], -1).astype(np.float32)
    got = lk_sample.sample_windows(_t(img), _t(pts), 21).numpy()
    want = np.asarray(sample_windows_pallas(jnp.asarray(img), jnp.asarray(pts), win=21, blk=8,
                                            interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _gold(img, pts, 21), **TOL)


def test_edge_clamp_replicates_border_pixels(rng):
    """Outside its domain K5 reads the nearest edge pixel, as the edge
    padding of the Pallas probe does: a window far above-left is the
    corner pixel everywhere."""
    img = _rand_image(rng, 40, 50)
    got = lk_sample.sample_windows(_t(img), _t(np.array([[-100.0, -100.0]], np.float32)), 5)
    np.testing.assert_array_equal(got.numpy(), np.full((1, 5, 5), img[0, 0]))


def test_cpu_tensors_take_the_plain_version_and_count_nothing(rng):
    img = _t(_rand_image(rng, 40, 50))
    pts = _t(np.array([[10.5, 20.25]], np.float32))
    cuda_ops.reset_launch_counts()
    a = lk_sample.sample_channels(torch.stack([img, img]), pts, 7)
    b = lk_sample.sample_channels_plain(torch.stack([img, img]), pts, 7)
    assert torch.equal(a, b)
    lk_sample.sample_windows(img, pts, 7)
    assert cuda_ops.launch_counts["lk_sample"] == cuda_ops.launch_counts["lk_sample_clamp"] == 0


def test_wrapper_rejects_what_the_kernel_does_not_take(rng):
    img = _t(_rand_image(rng, 40, 50))
    pts = _t(np.zeros((3, 2), np.float32))
    with pytest.raises(ValueError, match="1 to 4 channels"):
        lk_sample.sample_channels(torch.stack([img] * 5), pts, 7)
    with pytest.raises(ValueError, match="one \\[H, W\\] shape"):
        lk_sample.sample_channels((img, img[:-1]), pts, 7)
    with pytest.raises(ValueError, match="\\[N, 2\\]"):
        lk_sample.sample_single(img, pts[:, :1], 7)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        lk_sample._launch([img], pts, 7, clamp=False)
