"""QR encoding, detection and decoding of the PyTorch port against the JAX
package on the CPU.

Tolerances.
- Reed-Solomon, the encoder, the renderer and the bit-level decoder are
  host numpy copied from the JAX package: equal.
- The finder scores: the port sums integers exactly and divides once
  (a box sum and a dilated finder per scale), XLA's convolution sums
  ±1/size terms and rounds as it goes: within 1e-5. The peaks, the
  quads and the decoded texts are asserted equal: no score of these
  scenes sits within 1e-5 of the 0.72 cut or of a neighbour it competes
  with in the NMS.
- Every scene is 260x300, so eager JAX compiles its convolutions once
  (~15 s) and each later detection takes ~1 s.
- test_finder_scores_exact_integers holds the port's scores against the
  correctly rounded integer correlation computed in f64 with numpy:
  equal.
- nms_2d (max pooling in the port, shifted comparisons in JAX) at radii
  3 and 7 with ties, ±inf and NaN: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.core import imgproc as jimg
from opencv_tpu.ops import qrcode as jqr
from opencv_tpu_torch.core import imgproc as timg
from opencv_tpu_torch.ops import qrcode as tqr

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

TEXTS = {1: "HELLO-TPU", 2: "opencv_tpu qr decode 123",
         3: "the quick brown fox jumps over the lazy dog 01234"}  # tests/test_qrcode.py's
H, W = 260, 300


def _paste(img, y0, x0, bg, noise=0.0, seed=0):
    scene = np.full((H, W), bg, np.float32)
    scene[y0:y0 + img.shape[0], x0:x0 + img.shape[1]] = img
    if noise:
        scene += np.random.default_rng(seed).normal(0, noise, scene.shape).astype(np.float32)
    return scene


def _scenes():
    out = {}
    for v, text in TEXTS.items():
        out[f"clean_v{v}"] = (_paste(tqr.render_qr(tqr.encode_qr(text, v), 6), 10, 20, 255.0), text)
    img = tqr.render_qr(tqr.encode_qr("NOISY QR 42", 2), 5)
    out["noisy_offcentre"] = (_paste(img, 40, 60, 200.0, 8.0, 1), "NOISY QR 42")
    img = tqr.render_qr(tqr.encode_qr("opencv_tpu says hi", 2), 5)  # examples/qr_demo.py's
    out["demo"] = (_paste(img, 70, 90, 190.0, 6.0, 0), "opencv_tpu says hi")
    out["blank"] = (np.full((H, W), 180.0, np.float32), None)
    return out


SCENES = _scenes()


@pytest.fixture(scope="module")
def jax_results():
    res = {}
    for name, (scene, _) in SCENES.items():
        quad, ok = jqr.detect_qr(jnp.asarray(scene))
        text = jqr.decode_qr(jnp.asarray(scene), quad) if ok else None
        res[name] = (np.asarray(quad), bool(ok), text)
    return res


def test_rs_with_errors_equals_jax(rng):
    for nsym, n_data in ((7, 19), (10, 34), (15, 55)):
        data = [int(v) for v in rng.integers(0, 256, n_data)]
        ecc = tqr.rs_encode(data, nsym)
        assert ecc == jqr.rs_encode(data, nsym)
        cw = data + ecc
        for n_err in range(nsym // 2 + 2):
            bad = list(cw)
            for pos in rng.choice(len(cw), n_err, replace=False):
                bad[int(pos)] ^= int(rng.integers(1, 256))
            got = tqr.rs_correct(bad, nsym)
            assert got == jqr.rs_correct(bad, nsym)
            if n_err <= nsym // 2:
                assert got == cw


@pytest.mark.parametrize("version", [1, 2, 3])
def test_encode_and_render_equal_jax(version):
    for mask_id in range(8):
        mat = tqr.encode_qr(TEXTS[version], version, mask_id)
        np.testing.assert_array_equal(mat, jqr.encode_qr(TEXTS[version], version, mask_id))
    np.testing.assert_array_equal(tqr.render_qr(mat, 5), jqr.render_qr(mat, 5))


def _jax_scores(scene, scales=(2, 3, 4, 5, 6, 7, 8, 10, 12)):
    """detect_qr's finder score and scale index, as the JAX function
    computes them (its lines, which it does not return)."""
    img = jnp.asarray(scene)
    binary = jnp.where(img <= jimg.otsu_threshold(img), 1.0, -1.0)
    base = np.ones((7, 7), np.float32)
    base[1:6, 1:6] = -1
    base[2:5, 2:5] = 1
    out = []
    for s in scales:
        tpl = np.kron(base, np.ones((s, s), np.float32))
        tpl /= tpl.size
        pad = tpl.shape[0] // 2
        out.append(jax.lax.conv_general_dilated(
            binary[None, None], jnp.asarray(tpl)[None, None], (1, 1), [(pad, pad), (pad, pad)],
            dimension_numbers=("NCHW", "OIHW", "NCHW"))[0, 0][:H, :W])
    stack = jnp.stack(out)
    return np.asarray(jnp.max(stack, axis=0)), np.asarray(jnp.argmax(stack, axis=0))


@pytest.mark.parametrize("name", ["clean_v2", "noisy_offcentre"])
def test_finder_scores_close_to_jax(name):
    scene, _ = SCENES[name]
    score, sidx = tqr.finder_scores(torch.from_numpy(scene), (2, 3, 4, 5, 6, 7, 8, 10, 12))
    want, want_idx = _jax_scores(scene)
    np.testing.assert_allclose(score.numpy(), want, atol=1e-5, rtol=0)
    strong = want > 0.72
    np.testing.assert_array_equal(sidx.numpy()[strong], want_idx[strong])


def test_finder_scores_exact_integers(rng):
    """The port's score is the exact ±1 correlation (f64 numpy over the
    zero-padded image) divided by the size and rounded once to f32."""
    img = np.where(rng.random((23, 31)) < 0.5, 0.0, 255.0).astype(np.float32)
    scales = (2, 3)
    score, sidx = tqr.finder_scores(torch.from_numpy(img), scales)
    binary = np.where(img <= 0.0, 1.0, -1.0)
    base = np.ones((7, 7))
    base[1:6, 1:6] = -1
    base[2:5, 2:5] = 1
    best = None
    for s in scales:
        tpl = np.kron(base, np.ones((s, s)))
        pad = 7 * s // 2
        bp = np.pad(binary, pad)
        corr = np.array([[np.sum(bp[y:y + 7 * s, x:x + 7 * s] * tpl) for x in range(31)]
                         for y in range(23)])
        sc = (corr / tpl.size).astype(np.float32)
        best = sc if best is None else np.maximum(best, sc)
    np.testing.assert_array_equal(score.numpy(), best)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_detect_and_decode_equal_jax(jax_results, name):
    scene, text = SCENES[name]
    quad, ok = tqr.detect_qr(scene, device="cpu")
    jquad, jok, jtext = jax_results[name]
    assert ok == jok == (text is not None)
    np.testing.assert_array_equal(quad, jquad)
    if ok:
        got = tqr.decode_qr(scene, quad, device="cpu")
        assert got == jtext == text


@pytest.mark.parametrize("radius", [3, 7])
def test_nms_2d_equals_jax(rng, radius):
    """The port's pooled NMS (detect_qr's radius 7) against the JAX
    package's shifted comparisons, with integer ties, ±inf and NaN: equal."""
    s = rng.integers(0, 4, (40, 56)).astype(np.float32)
    flat = s.reshape(-1)
    flat[rng.random(flat.shape) < 0.05] = -np.inf
    flat[rng.random(flat.shape) < 0.02] = np.inf
    flat[rng.random(flat.shape) < 0.02] = np.nan
    want = jax.jit(jimg.nms_2d, static_argnums=1)(jnp.asarray(s), radius)
    np.testing.assert_array_equal(timg.nms_2d(torch.from_numpy(s), radius).numpy(),
                                  np.asarray(want))
