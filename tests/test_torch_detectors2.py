"""AGAST, BRISK, AKAZE and MSER of the PyTorch port against the JAX package
on the CPU, on seeded 64x96 scenes.

Tolerances:
- AGAST scores (all four kinds), AGAST and BRISK keypoints, MSER regions
  and the constant tables (BRISK's pattern, AKAZE's M-LDB cells and FED
  steps, Farneback's basis): none, asserted equal. Scores are f32
  subtractions and minima; blurs and NMS follow eager JAX's order;
  MSER's labels and sums are integers. One exception: BRISK's responses
  on the odd levels of its sqrt(2) pyramid, whose pixels are within 4
  ulps of 255 of JAX's (XLA's interpolation einsum may fuse the two taps
  into an FMA, test_torch_orb.py holds the same), within 8 such ulps.
- BRISK and AKAZE descriptors: >= 99.5 % of the bits of valid keypoints
  equal, and every differing bit a comparison whose two samples (the
  port's) lie within 1e-4: a near tie. The orientation sums, the
  pattern's 2x2 rotation (an einsum in JAX) and AKAZE's 9-sample cell
  means are reductions whose order is the library's.
- AKAZE: k within 1e-6 relative (the 70th percentile of the gradient
  magnitude, linearly interpolated by `jnp.percentile` and by the port's
  `akaze._quantile_linear` in the same arithmetic); the scale space and responses within 1e-5 of their
  range; keypoints equal slot for slot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.core import imgproc as jimg
from opencv_tpu.ops import agast as jagast
from opencv_tpu.ops import akaze as jakaze
from opencv_tpu.ops import brisk as jbrisk
from opencv_tpu.ops import farneback as jfarneback
from opencv_tpu.ops import mser as jmser
from opencv_tpu_torch.ops import agast, akaze, brisk, farneback, mser
from opencv_tpu_torch.ops.matching import unpack_bits

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)


def scene(seed: int = 0, h: int = 64, w: int = 96) -> np.ndarray:
    """Blurred noise with bright and dark rectangles and disks: corners,
    blobs and texture."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    img = np.asarray(jimg.gaussian_blur(jnp.asarray(img), 5, 1.5)) * 0.6 + 50.0
    yy, xx = np.mgrid[0:h, 0:w]
    img[10:26, 12:34] = 220.0
    img[36:54, 50:80] = 30.0
    img[(yy - 20) ** 2 + (xx - 70) ** 2 <= 49] = 15.0
    img[(yy - 48) ** 2 + (xx - 22) ** 2 <= 36] = 240.0
    return np.round(img).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def _same_keypoints(jkp, tkp, response_atol=0.0):
    np.testing.assert_array_equal(tkp.valid.numpy(), np.asarray(jkp.valid))
    v = np.asarray(jkp.valid)
    np.testing.assert_array_equal(tkp.xy.numpy()[v], np.asarray(jkp.xy)[v])
    np.testing.assert_allclose(tkp.response.numpy()[v], np.asarray(jkp.response)[v], rtol=0,
                               atol=response_atol)
    np.testing.assert_array_equal(tkp.level.numpy()[v], np.asarray(jkp.level)[v])
    np.testing.assert_allclose(tkp.size.numpy()[v], np.asarray(jkp.size)[v], rtol=1e-6)
    return v


def _bits(desc_u32: np.ndarray) -> np.ndarray:
    return unpack_bits(torch.from_numpy(desc_u32.view(np.int32).copy())).numpy()


@pytest.mark.parametrize("kind", ["5_8", "7_12d", "7_12s", "9_16"])
def test_agast_score_bit_equal(kind):
    img = scene()
    want = np.asarray(jagast.agast_score(jnp.asarray(img), kind))
    got = agast.agast_score(t(img), kind).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["9_16", "7_12d"])
def test_agast_keypoints_slot_for_slot(kind):
    img = scene(1)
    jkp = jagast.agast_detect(jnp.asarray(img), 64, threshold=10.0, kind=kind)
    tkp = agast.agast_detect(img, 64, threshold=10.0, kind=kind, device="cpu")
    assert _same_keypoints(jkp, tkp).sum() > 10


def _near_ties(bits_j, bits_t, valid, pair_values):
    """(share of equal bits over valid keypoints, the largest |a - b| of the
    port's two samples over the differing bits)."""
    diff = (bits_j != bits_t) & valid[:, None]
    share = 1.0 - diff.sum() / max(valid.sum() * bits_j.shape[1], 1)
    worst = 0.0
    for k, b in zip(*np.nonzero(diff)):
        a, c = pair_values(k, b)
        worst = max(worst, abs(a - c))
    return share, worst, int(diff.sum())


def test_brisk_keypoints_and_descriptors(monkeypatch):
    # the JAX score jitted: shifts, subtractions and minima round alike under
    # jit, and eager JAX compiles its ops once per level shape (~3 s each)
    monkeypatch.setattr(jagast, "agast_score", jax.jit(jagast.agast_score, static_argnums=1))
    img = scene(2)
    jkp, jdesc = jbrisk.brisk_detect_and_compute(jnp.asarray(img), max_keypoints=128,
                                                threshold=20.0)
    tkp, tdesc = brisk.brisk_detect_and_compute(img, max_keypoints=128, threshold=20.0,
                                                device="cpu")
    # levels 1 and 3 of the sqrt(2) pyramid are within 4 ulps of 255 of the
    # JAX levels (XLA's interpolation einsum may fuse the two taps into an
    # FMA), so their scores, differences of two pixels, within 8
    v = _same_keypoints(jkp, tkp, response_atol=8 * np.spacing(np.float32(255)))
    assert v.sum() > 20
    np.testing.assert_allclose(tkp.angle.numpy()[v], np.asarray(jkp.angle)[v], atol=1e-4)
    # the port's pattern samples at its own angles
    stack = brisk._blur_stack(t(img))
    scale = torch.clamp(tkp.size, min=1.0) / 12.0
    vals = brisk._sample_pattern(stack, tkp.xy, tkp.angle, scale).numpy()

    def pair_values(k, b):
        i, j = brisk.SHORT_PAIRS[b]
        return vals[k, i], vals[k, j]

    share, worst, n = _near_ties(_bits(np.asarray(jdesc)), _bits(tdesc.numpy().view(np.uint32)),
                                 v, pair_values)
    assert share >= 0.995, (share, n)
    assert worst <= 1e-4, (worst, n)


def test_akaze_contrast_scale_space_and_response():
    img = scene(3)
    jk = float(jakaze._contrast_k(jnp.asarray(img, jnp.float32) / 255.0))
    tk = float(akaze.contrast_k(t(img) / 255.0))
    assert abs(tk - jk) <= 1e-6 * abs(jk), (tk, jk)
    jstack, jsig = jakaze.nonlinear_scale_space(jnp.asarray(img), n_levels=6)
    tstack, tsig = akaze.nonlinear_scale_space(t(img), n_levels=6)
    np.testing.assert_array_equal(tsig, jsig)
    js = np.asarray(jstack)
    np.testing.assert_allclose(tstack.numpy(), js, rtol=0, atol=1e-5 * np.abs(js).max())
    jr = np.asarray(jakaze.hessian_response(jstack, jsig))
    tr = akaze.hessian_response(t(js), tsig).numpy()
    np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-5 * np.abs(jr).max())


def test_akaze_keypoints_and_descriptors():
    img = scene(4)
    jkp, jdesc = jakaze.akaze_detect_and_compute(jnp.asarray(img), max_keypoints=96,
                                                 threshold=1e-4, n_levels=6)
    tkp, tdesc = akaze.akaze_detect_and_compute(img, max_keypoints=96, threshold=1e-4,
                                                n_levels=6, device="cpu")
    v = _same_keypoints(jkp, tkp)
    assert v.sum() > 20
    stack, sigmas = akaze.nonlinear_scale_space(t(img), n_levels=6)
    chans = [c.numpy() for c in akaze.mldb_channels(stack, sigmas, tkp)]
    n_pairs = akaze.PAIRS.shape[0]

    def pair_values(k, b):
        ch = chans[b // n_pairs]
        i, j = akaze.PAIRS[b % n_pairs]
        return ch[k, i], ch[k, j]

    bits_j = _bits(np.asarray(jdesc))[:, :akaze.MLDB_BITS]
    bits_t = _bits(tdesc.numpy().view(np.uint32))
    assert not bits_t[:, akaze.MLDB_BITS:].any()
    share, worst, n = _near_ties(bits_j, bits_t[:, :akaze.MLDB_BITS], v, pair_values)
    assert share >= 0.995, (share, n)
    assert worst <= 1e-4, (worst, n)


@pytest.mark.parametrize("dark_on_bright", [True, False])
def test_mser_regions_equal(dark_on_bright):
    img = scene(5)
    kw = dict(max_regions=16, min_area=20.0, max_area=2000.0, dark_on_bright=dark_on_bright)
    want = jmser.mser_detect(jnp.asarray(img), **kw)
    got = mser.mser_detect(img, device="cpu", **kw)
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    assert v.sum() >= 2
    for name in ("xy", "area", "bbox", "threshold", "stability"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[v],
                                      np.asarray(getattr(want, name))[v], err_msg=name)


@pytest.mark.parametrize("name", ["brisk_pattern", "mldb_cells", "fed_taus", "farneback_basis"])
def test_constant_tables_equal(name):
    if name == "brisk_pattern":
        pairs = [(brisk.PATTERN_XY, jbrisk.PATTERN_XY), (brisk.PATTERN_SIGMA, jbrisk.PATTERN_SIGMA),
                 (brisk.SHORT_PAIRS, jbrisk.SHORT_PAIRS), (brisk.LONG_PAIRS, jbrisk.LONG_PAIRS),
                 (brisk.LADDER, jbrisk._LADDER)]
    elif name == "mldb_cells":
        pairs = [(akaze.CELLS, jakaze._CELLS), (akaze.CELL_SIZE, jakaze._CELL_SIZE),
                 (akaze.PAIRS, jakaze._PAIRS), (akaze.SUB, jakaze._SUB)]
    elif name == "fed_taus":
        pairs = [(akaze.fed_taus(tt), jakaze.fed_taus(tt)) for tt in (0.3, 1.7, 12.5)]
    else:
        pairs = list(zip(farneback.poly_exp_setup(5, 1.1), jfarneback._poly_exp_setup(5, 1.1)))
    for a, b in pairs:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
