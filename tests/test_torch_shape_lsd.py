"""Shape analysis and the LSD line-segment detector of the PyTorch port
against the JAX package on the CPU.

Tolerances.
- hausdorff_distance: pairwise distances from a true-f32 product and a
  stable sort: relative 1e-6. shape_context: the same bins (JAX's
  linspace arithmetic for the radial edges): equal.
  shape_context_distance: the chi-squared costs summed in the library's
  order, the same assignment: relative 1e-6.
- fit_tps / apply_tps: an LU solve of the TPS system (LAPACK in both, on
  kernel entries whose logs differ by an ulp; the system is ill-
  conditioned, measured 2e-4 on one weight of 0.03): weights within 1e-3
  of their largest magnitude, mapped points within 1e-3 px.
- emd_l1_1d and the 1-D emd_l1: the same prefix sums: relative 1e-6.
  emd_l1 on 2-D histograms: 300 log-domain Sinkhorn steps whose
  logsumexp is the library's: relative 1e-5. emd_exact: the same host
  simplex in f64: equal.
- LSD: the gradient maps: the blur is bit-equal, the 0.8 resize within
  ulps of XLA's einsum, so magnitudes within 1e-4 and, where the
  magnitude exceeds 1 (atan2 is well conditioned there), angles within
  1e-4; given the JAX package's gradient maps, the port's host
  region growing gives the same number of segments within 1e-3 px; on
  the port's own maps, the same (on this scene) and the drawn segments
  within 6 px (tests/test_lsd.py's bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from opencv_tpu.core import imgproc as jimg
from opencv_tpu.ops import lsd as jl
from opencv_tpu.ops import shape as js
from opencv_tpu_torch.ops import lsd as tl
from opencv_tpu_torch.ops import shape as ts

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

CPU = "cpu"


def _ring(rng, n=40, noise=0.5, permute=True):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    a = np.stack([30 + 10 * np.cos(t), 20 + 6 * np.sin(t)], 1).astype(np.float32)
    b = (a + rng.normal(0, noise, a.shape)).astype(np.float32)
    return a, (b[rng.permutation(n)] if permute else b)


def _close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("q", [1.0, 0.8, 0.3])
def test_hausdorff_close_to_jax(rng, q):
    a, b = _ring(rng)
    _close(ts.hausdorff_distance(a, b[:31], q, device=CPU),
           js.hausdorff_distance(jnp.asarray(a), jnp.asarray(b[:31]), q), 1e-6)


def test_shape_context_equals_jax(rng):
    a, b = _ring(rng)
    for p in (a, b):
        np.testing.assert_array_equal(ts.shape_context(p, device=CPU).numpy(),
                                      np.asarray(js.shape_context(jnp.asarray(p))))
    _close(ts.shape_context_distance(a, b, device=CPU),
           js.shape_context_distance(jnp.asarray(a), jnp.asarray(b)), 1e-6)


def test_tps_close_to_jax(rng):
    a, _ = _ring(rng)
    src = a[::4]
    dst = (src * 1.1 + rng.normal(0, 0.3, src.shape)).astype(np.float32)
    for reg in (0.0, 0.1):
        jt = js.fit_tps(jnp.asarray(src), jnp.asarray(dst), reg)
        tt = ts.fit_tps(src, dst, reg, device=CPU)
        wj = np.asarray(jt.weights)
        np.testing.assert_allclose(tt.weights.numpy(), wj, rtol=0, atol=1e-3 * np.abs(wj).max())
        np.testing.assert_allclose(ts.apply_tps(tt, a).numpy(),
                                   np.asarray(js.apply_tps(jt, jnp.asarray(a))), atol=1e-3)
        if reg == 0.0:  # interpolates its control points
            np.testing.assert_allclose(ts.apply_tps(tt, src).numpy(), dst, atol=1e-2)


def test_emd_close_to_jax(rng):
    h1 = rng.uniform(0, 1, 16).astype(np.float32)
    h2 = rng.uniform(0, 1, 16).astype(np.float32)
    h2 *= h1.sum() / h2.sum()
    _close(ts.emd_l1_1d(h1, h2, device=CPU), js.emd_l1_1d(jnp.asarray(h1), jnp.asarray(h2)), 1e-6)
    _close(ts.emd_l1(h1, h2 * 2, device=CPU), js.emd_l1(jnp.asarray(h1), jnp.asarray(h2 * 2)), 1e-6)
    H1 = rng.uniform(0, 1, (4, 5)).astype(np.float32)
    H2 = rng.uniform(0, 1, (4, 5)).astype(np.float32)
    _close(ts.emd_l1(H1, H2, iters=100, device=CPU),
           js.emd_l1(jnp.asarray(H1), jnp.asarray(H2), iters=100), 1e-5)
    w1, w2 = rng.uniform(0, 1, 5), rng.uniform(0, 1, 6)
    w1[2] = 0.0
    p1, p2 = rng.uniform(0, 10, (5, 2)), rng.uniform(0, 10, (6, 2))
    for metric in ("l1", "l2"):
        assert ts.emd_exact(w1, w2, pos1=p1, pos2=p2, metric=metric) == js.emd_exact(
            w1, w2, pos1=p1, pos2=p2, metric=metric)
    cost = rng.uniform(0, 5, (5, 6))
    assert ts.emd_exact(w1, w2, cost=cost) == js.emd_exact(w1, w2, cost=cost)


# -------------------------------------------------------------------- LSD ---

GT = [(20, 30, 130, 30), (30, 100, 120, 55), (145, 15, 145, 105)]


def _line(img, x0, y0, x1, y1, value=220.0, thick=2):
    n = int(max(abs(x1 - x0), abs(y1 - y0)) * 2 + 1)
    t = np.linspace(0, 1, n)
    xs = np.round(x0 + t * (x1 - x0)).astype(int)
    ys = np.round(y0 + t * (y1 - y0)).astype(int)
    for d in range(thick):
        if x0 == x1:
            img[ys, np.clip(xs + d, 0, img.shape[1] - 1)] = value
        else:
            img[np.clip(ys + d, 0, img.shape[0] - 1), xs] = value


def _scene(rng, h=120, w=160):
    """tests/test_lsd.py's scene, drawn with numpy: three 2-px lines of 220
    on 40 with N(0, 2) noise, quantized to u8."""
    img = np.full((h, w), 40, np.float32) + rng.normal(0, 2.0, (h, w)).astype(np.float32)
    img = img.astype(np.uint8).astype(np.float32)
    for seg in GT:
        _line(img, *seg)
    return img


def _jax_maps(img, scale=0.8, sigma_scale=0.6):
    """JAX's gradient stage of detect_lines (opencv_tpu/ops/lsd.py:109-121)."""
    x = jnp.asarray(img, jnp.float32)
    sigma = sigma_scale / scale
    ksize = int(2 * np.ceil(3.0 * sigma) + 1)
    sm = jimg.gaussian_blur(x, ksize, sigma)
    work = jimg.resize_bilinear(sm, int(round(img.shape[0] * scale)), int(round(img.shape[1] * scale)))
    _, _, mag, ang = jl._gradients(work)
    return np.asarray(mag), np.asarray(ang)


def _seg_dist(seg, x1, y1, x2, y2):
    a = np.hypot(seg[0] - x1, seg[1] - y1) + np.hypot(seg[2] - x2, seg[3] - y2)
    b = np.hypot(seg[0] - x2, seg[1] - y2) + np.hypot(seg[2] - x1, seg[3] - y1)
    return min(a, b) / 2


def test_lsd_gradient_maps_close_to_jax(rng):
    img = _scene(rng)
    jmag, jang = _jax_maps(img)
    tmag, tang = tl.gradient_maps(img, device=CPU)
    np.testing.assert_allclose(tmag.numpy(), jmag, rtol=0, atol=1e-4)
    d = np.abs(tang.numpy() - jang)
    assert np.minimum(d, 2 * np.pi - d)[jmag > 1.0].max() < 1e-4


@pytest.mark.parametrize("scale", [0.8, 1.0])
def test_lsd_segments_equal_jax_on_jax_maps(rng, scale):
    img = _scene(rng)
    want = jl.detect_lines(img, scale=scale)
    maps = _jax_maps(img, scale) if scale != 1.0 else tuple(
        np.asarray(m) for m in jl._gradients(jnp.asarray(img))[2:])
    got = tl.segments_from_maps(*maps, scale=scale)
    assert got.shape == want.shape and len(got) >= 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_lsd_finds_drawn_segments(rng):
    img = _scene(rng)
    segs = tl.detect_lines(img, device=CPU)
    want = jl.detect_lines(img)  # on its own maps too, here the same segments
    assert segs.shape == want.shape and len(segs) >= 3
    np.testing.assert_allclose(segs, want, rtol=0, atol=1e-3)
    for gt in GT:
        assert min(_seg_dist(s, *gt) for s in segs) < 6.0, gt


def test_lsd_empty_on_flat(rng):
    flat = (90.0 + rng.normal(0, 0.5, (60, 80))).astype(np.float32)
    assert len(tl.detect_lines(flat, device=CPU)) == 0
