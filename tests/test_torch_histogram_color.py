"""Histograms, colour conversions, colormaps, template matching and phase
correlation of the PyTorch port against the JAX package on the CPU.

Tolerances.
- calc_hist, equalize_hist, clahe: integer bincounts, the JAX order of
  every f32 operation, divisions by tensors and CLAHE's prefix sums in
  XLA's order: equal.
- rgb_to_gray, HSV, YCrCb (both ways), demosaic_bilinear: elementwise in
  the JAX order (gray as XLA's FMA chain, the demosaic's separable
  filter in its tap order): equal. rgb_to_lab: `pow` for the sRGB curve
  and the cube root (XLA has its own `cbrt`): within 1e-4 (L in
  [0, 100], a/b ~ [-128, 127]; a few f32 ulps).
- apply_color_map: a gather of the same LUT: equal. get_gabor_kernel:
  `exp` and `cos` may differ from XLA's by an ulp: within 1e-6.
- match_template: the VALID correlation is F.conv2d (true f32), summed in
  another order than XLA's convolution (measured: 12 at 1.1e7). Scores
  that subtract from it (sqdiff, ccoeff) are held within 4e-6 of the
  correlation's largest magnitude, the normalized ones within 1e-4
  (ccoeff_normed divides by small window variances; measured 4e-5);
  every method finds the same best location.
- create_hanning_window: `cos` by an ulp: within 1e-6.
  phase_correlate: pocketfft against XLA's FFT: the shift within 1e-3
  px, the response within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from opencv_tpu.ops import color as jc
from opencv_tpu.ops import colormap as jcm
from opencv_tpu.ops import histogram as jh
from opencv_tpu.ops import phasecorr as jp
from opencv_tpu.ops import template as jt
from opencv_tpu_torch.ops import color as tc
from opencv_tpu_torch.ops import colormap as tcm
from opencv_tpu_torch.ops import histogram as th
from opencv_tpu_torch.ops import phasecorr as tp
from opencv_tpu_torch.ops import template as tt

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

CPU = "cpu"


def _gray(rng, h=48, w=64, integer=True):
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    return np.round(img) if integer else img


def _scene(h=96, w=128):
    """A smooth scene with edges: sines plus a bright block."""
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    img = 100 + 60 * np.sin(xx / 11) + 40 * np.cos(yy / 7) + 10 * np.sin((xx + yy) / 3)
    img[20:50, 30:80] += 55.0
    return np.clip(img, 0, 255).astype(np.float32)


def _equal(a, b):
    a = np.asarray(a)
    b = b.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------- histogram ---

@pytest.mark.parametrize("bins,value_range", [(256, (0.0, 256.0)), (30, (10.0, 200.0)),
                                              (17, (-5.0, 300.0))])
def test_calc_hist_equals_jax(rng, bins, value_range):
    img = _gray(rng, integer=False)
    _equal(jh.calc_hist(jnp.asarray(img), bins, value_range),
           th.calc_hist(img, bins, value_range, device=CPU))


@pytest.mark.parametrize("integer", [True, False])
def test_equalize_hist_equals_jax(rng, integer):
    img = _gray(rng, integer=integer) * 0.5 + 40.0
    _equal(jh.equalize_hist(jnp.asarray(img)), th.equalize_hist(img, device=CPU))


@pytest.mark.parametrize("clip,grid", [(40.0, (8, 8)), (2.5, (4, 8)), (7.3, (6, 4))])
def test_clahe_equals_jax(clip, grid):
    img = _scene(96, 128)
    _equal(jh.clahe(jnp.asarray(img), clip, grid), th.clahe(img, clip, grid, device=CPU))


# ------------------------------------------------------------------ color ---

@pytest.mark.parametrize("name", ["rgb_to_gray", "rgb_to_hsv", "rgb_to_ycrcb", "gray_to_rgb"])
def test_color_forward_equals_jax(rng, name):
    rgb = rng.uniform(0, 255, (48, 64, 3)).astype(np.float32)
    rgb[:8, :8] = 77.0  # grey: zero chroma
    rgb[8:16, :8] = 0.0  # black: zero value
    x = rgb[..., 0] if name == "gray_to_rgb" else rgb
    _equal(getattr(jc, name)(jnp.asarray(x)), getattr(tc, name)(x, device=CPU))


def test_color_inverses_equal_jax(rng):
    rgb = rng.uniform(0, 255, (48, 64, 3)).astype(np.float32)
    hsv = np.asarray(jc.rgb_to_hsv(jnp.asarray(rgb)))
    _equal(jc.hsv_to_rgb(jnp.asarray(hsv)), tc.hsv_to_rgb(hsv, device=CPU))
    ycc = np.asarray(jc.rgb_to_ycrcb(jnp.asarray(rgb)))
    _equal(jc.ycrcb_to_rgb(jnp.asarray(ycc)), tc.ycrcb_to_rgb(ycc, device=CPU))
    # the round trips return the input
    np.testing.assert_allclose(tc.hsv_to_rgb(tc.rgb_to_hsv(rgb, device=CPU)).numpy(), rgb, atol=1e-3)
    np.testing.assert_allclose(tc.ycrcb_to_rgb(tc.rgb_to_ycrcb(rgb, device=CPU)).numpy(), rgb,
                               atol=1e-2)


def test_rgb_to_lab_close_to_jax(rng):
    rgb = rng.uniform(0, 255, (48, 64, 3)).astype(np.float32)
    rgb[:4, :4] = 2.0  # the linear branches near black
    want = np.asarray(jc.rgb_to_lab(jnp.asarray(rgb)))
    got = tc.rgb_to_lab(rgb, device=CPU).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("pattern", ["RGGB", "BGGR", "GRBG", "GBRG"])
def test_demosaic_equals_jax(rng, pattern):
    raw = _gray(rng, 40, 56)
    _equal(jc.demosaic_bilinear(jnp.asarray(raw), pattern),
           tc.demosaic_bilinear(raw, pattern, device=CPU))


# --------------------------------------------------------------- colormap ---

@pytest.mark.parametrize("name", sorted(jcm._LUTS))
def test_apply_color_map_equals_jax(rng, name):
    img = rng.uniform(-10, 270, (24, 32)).astype(np.float32)
    np.testing.assert_array_equal(tcm._LUTS[name], jcm._LUTS[name])
    _equal(jcm.apply_color_map(jnp.asarray(img), name), tcm.apply_color_map(img, name, device=CPU))


@pytest.mark.parametrize("args", [((21, 21), 4.0, 0.7, 10.0, 0.5), ((0, 0), 3.0, 0.3, 8.0, 0.5),
                                  ((15, 9), 2.0, 1.9, 6.0, 1.0, 0.0)])
def test_gabor_kernel_close_to_jax(args):
    want = np.asarray(jcm.get_gabor_kernel(*args))
    got = tcm.get_gabor_kernel(*args, device=CPU).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# --------------------------------------------------------------- template ---

@pytest.mark.parametrize("method", tt.METHODS)
def test_match_template_close_to_jax(method):
    img = _scene(80, 96)
    tmpl = img[22:42, 35:63].copy()
    want = np.asarray(jt.match_template(jnp.asarray(img), jnp.asarray(tmpl), method))
    got = tt.match_template(img, tmpl, method, device=CPU).numpy()
    corr = np.asarray(jt.match_template(jnp.asarray(img), jnp.asarray(tmpl), "ccorr"))
    atol = 1e-4 if method.endswith("normed") else 4e-6 * np.abs(corr).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    pick = np.argmin if method.startswith("sqdiff") else np.argmax
    assert pick(got) == pick(want)
    if method in ("sqdiff", "sqdiff_normed", "ccoeff_normed"):
        assert np.unravel_index(pick(got), got.shape) == (22, 35)


@pytest.mark.parametrize("method", tt.METHODS)
def test_match_template_nan_where_jax_has_nan(method):
    """A scene of flat blocks on a zero ground, without noise: over its
    all-zero windows the window sum of squares from the integral image
    is a small negative residue in both packages, so the two normed
    methods that take its square root (sqdiff_normed, ccorr_normed) give
    NaN there. The port's NaNs sit at JAX's places, and every method's
    other scores are within the tolerances above (relative to their
    magnitude: a near-zero window divides by a tiny root)."""
    rng = np.random.default_rng(61)
    img = np.zeros((480, 640), np.float32)
    for _ in range(60):
        y, x = rng.integers(0, 440), rng.integers(0, 600)
        img[y:y + rng.integers(8, 40), x:x + rng.integers(8, 40)] = rng.uniform(60, 250)
    tmpl = img[200:264, 300:364].copy()
    want = np.asarray(jt.match_template(jnp.asarray(img), jnp.asarray(tmpl), method))
    got = tt.match_template(img, tmpl, method, device=CPU).numpy()
    nan = np.isnan(want)
    assert nan.any() == (method in ("sqdiff_normed", "ccorr_normed"))
    np.testing.assert_array_equal(np.isnan(got), nan)
    corr = np.asarray(jt.match_template(jnp.asarray(img), jnp.asarray(tmpl), "ccorr"))
    atol = 1e-4 if method.endswith("normed") else 4e-6 * np.abs(corr).max()
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=1e-5, atol=atol)


def test_match_template_unknown_method():
    with pytest.raises(ValueError):
        tt.match_template(np.zeros((8, 8), np.float32), np.zeros((2, 2), np.float32), "nope",
                          device=CPU)


# --------------------------------------------------------------- phasecorr ---

def test_hanning_window_close_to_jax():
    np.testing.assert_allclose(tp.create_hanning_window(48, 64, device=CPU).numpy(),
                               np.asarray(jp.create_hanning_window(48, 64)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shift,windowed", [((3, -2), True), ((-5, 7), False), ((0, 0), True)])
def test_phase_correlate_close_to_jax(shift, windowed):
    a = _scene(64, 80)
    b = np.roll(a, shift, (0, 1))
    win = jp.create_hanning_window(64, 80) if windowed else None
    (jx, jy), jr = jp.phase_correlate(jnp.asarray(a), jnp.asarray(b), win)
    twin = tp.create_hanning_window(64, 80, device=CPU) if windowed else None
    (tx, ty), tr = tp.phase_correlate(a, b, twin, device=CPU)
    assert abs(float(tx) - float(jx)) < 1e-3 and abs(float(ty) - float(jy)) < 1e-3
    assert abs(float(tr) - float(jr)) < 1e-5
    if not windowed:  # a periodic shift, recovered: src2(x) = src1(x - (dx, dy))
        assert abs(float(tx) - shift[1]) < 0.05 and abs(float(ty) - shift[0]) < 0.05
