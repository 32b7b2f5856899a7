"""Computational photography of the PyTorch port against the JAX package
on the CPU.

Tolerances (images in [0, 255] unless said).
- nl_means_denoise: `exp` by an ulp, summed in the JAX order: 1e-4.
- inpaint_diffusion, seamless_clone: the JAX loops compile their bodies
  whole (FMA contraction) and the initial fill is a mean: 1e-4;
  merge_mertens ([0, 1]) 1e-6.
- calibrate_debevec, on JAX's own pixel samples: the port builds the same
  f32 system and solves it by QR in f64, JAX by an f32 SVD: g within 1e-4
  (measured 3e-5). calibrate_robertson: bin sums in f64 against JAX's
  f32 scatter: relative 1e-5. merge_debevec: relative 1e-5;
  tonemap_reinhard: 1e-3 (a mean of logs over the image).
- align_mtb: bitmaps from JAX's median (the mean of the two middle
  elements of an even count) and integer votes: the aligned stack equal.
- denoise_tvl1 (1 and 3 observations), inpaint_telea (gray and colour):
  compiled JAX loop bodies against plain operations: 1e-3.
- decolor, on JAX's own pixel pairs: the same weights chosen, gray equal
  (XLA's dot order), the colour boost within 1e-4.
- The domain-transform family, in JAX's associative-scan order, against
  the JAX functions compiled whole (eager JAX compiles every level of the
  scan, ~14 s; compiled, XLA contracts multiply-adds into FMAs), with
  `pow` and `exp` by an ulp: edge_preserving_filter and detail_enhance
  1e-3; stylization and pencil_sketch 1e-2 (they divide by the largest
  edge magnitude and scale by 4 and 255; measured 6e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.ops import photo as J
from opencv_tpu_torch.ops import photo as T

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

CPU = "cpu"


def _close(got, want, atol, rtol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def clean():
    yy, xx = np.mgrid[:40, :56].astype(np.float32)
    img = 100 + 60 * np.sin(xx / 13) + 40 * np.cos(yy / 9)
    img[12:28, 18:40] += 55.0
    return np.clip(img, 0, 255).astype(np.float32)


@pytest.fixture(scope="module")
def noisy(clean):
    rng = np.random.default_rng(1)
    return np.clip(clean + rng.normal(0, 15, clean.shape), 0, 255).astype(np.float32)


@pytest.fixture(scope="module")
def hole():
    m = np.zeros((40, 56), bool)
    m[8:18, 6:20] = True
    return m


def test_nl_means_close_to_jax(noisy):
    _close(T.nl_means_denoise(noisy, 8.0, 5, 7, device=CPU),
           J.nl_means_denoise(jnp.asarray(noisy), 8.0, 5, 7), 1e-4)


def test_inpaint_diffusion_and_clone_close_to_jax(clean, noisy, hole):
    _close(T.inpaint_diffusion(noisy, hole, 80, device=CPU),
           J.inpaint_diffusion(jnp.asarray(noisy), jnp.asarray(hole), 80), 1e-4)
    src = np.roll(clean, 5, 1)
    _close(T.seamless_clone(src, noisy, hole, 80, device=CPU),
           J.seamless_clone(jnp.asarray(src), jnp.asarray(noisy), jnp.asarray(hole), 80), 1e-4)
    stack = np.stack([np.clip(clean * s, 0, 255) for s in (0.5, 1.0, 1.6)]).astype(np.float32)
    _close(T.merge_mertens(stack, device=CPU), J.merge_mertens(jnp.asarray(stack)), 1e-6)


GAMMA = 2.2
TIMES = np.array([1 / 60, 1 / 15, 1 / 4, 1.0], np.float32)


def _hdr_stack(rng, times=TIMES, h=40, w=56):
    """tests/test_hdr.py's exposure stack."""
    yy, xx = np.mgrid[0:h, 0:w]
    E = 0.02 + 0.6 * (np.sin(xx / 9.0) * np.cos(yy / 7.0) * 0.5 + 0.5)
    E += np.kron(rng.uniform(0, 0.35, (h // 4 + 1, w // 4 + 1)), np.ones((4, 4)))[:h, :w]
    return np.stack([np.clip(255.0 * np.clip(E * t, 0, None) ** (1 / GAMMA), 0, 255)
                     for t in times]).astype(np.float32), E


def test_hdr_close_to_jax(rng):
    stack, E = _hdr_stack(rng)
    idx = np.asarray(jax.random.choice(jax.random.PRNGKey(0), stack[0].size, (70,), replace=False))
    gj = np.asarray(J.calibrate_debevec(jnp.asarray(stack), jnp.asarray(TIMES)))
    gt = T.calibrate_debevec(stack, TIMES, idx=idx, device=CPU)
    _close(gt, gj, 1e-4)
    zs = np.arange(30, 226)  # tests/test_hdr.py's bound on the log response
    want = GAMMA * np.log(zs / 255.0) - GAMMA * np.log(128 / 255.0)
    assert np.abs(gt.numpy()[zs] - gt.numpy()[128] - want).mean() < 0.15
    _close(T.calibrate_robertson(stack, TIMES, device=CPU),
           J.calibrate_robertson(jnp.asarray(stack), jnp.asarray(TIMES)), 1e-5, 1e-5)
    hj = np.asarray(J.merge_debevec(jnp.asarray(stack), jnp.asarray(TIMES), jnp.asarray(gj)))
    ht = T.merge_debevec(stack, TIMES, gj, device=CPU)
    _close(ht, hj, 0.0, 1e-5)
    _close(T.tonemap_reinhard(hj, device=CPU), J.tonemap_reinhard(jnp.asarray(hj)), 1e-3)


def test_debevec_draws_its_own_samples(rng):
    stack, _ = _hdr_stack(rng)
    g1 = T.calibrate_debevec(stack, TIMES, seed=4, device=CPU)
    g2 = T.calibrate_debevec(stack, TIMES, seed=4, device=CPU)
    assert torch.equal(g1, g2) and abs(float(g1[128])) < 1e-3


def test_align_mtb_equals_jax(rng):
    stack, _ = _hdr_stack(rng, TIMES[1:3])
    shifted = np.stack([stack[0], np.roll(stack[1], (3, -2), (0, 1))])
    want = np.asarray(J.align_mtb(jnp.asarray(shifted), 4))  # two levels
    got = T.align_mtb(shifted, 4, device=CPU).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], stack[1])  # the shift is undone


def test_mtb_bitmaps_take_the_mean_of_the_two_middle_values():
    """An even count whose two middle values differ (10 and 15): JAX's
    median is 12.5, torch.median's 10; the exclusion bitmap |v - med| > 4
    then differs at 15 (and the threshold bitmap at 12)."""
    img = np.array([[0.0, 10.0, 15.0, 30.0], [12.0, 1.0, 40.0, 9.0]], np.float32)
    x = jnp.asarray(img)
    med = jnp.median(x.reshape(-1))
    bits, excl = T._mtb(torch.from_numpy(img))
    assert float(T._median(torch.from_numpy(img))) == float(med) == 11.0
    np.testing.assert_array_equal(bits.numpy(), np.asarray(x > med))
    np.testing.assert_array_equal(excl.numpy(), np.asarray(jnp.abs(x - med) > 4.0))
    assert float(torch.median(torch.from_numpy(img))) != float(med)


def test_denoise_tvl1_close_to_jax(clean, noisy):
    _close(T.denoise_tvl1(noisy, device=CPU), J.denoise_tvl1(jnp.asarray(noisy)), 1e-3)
    rng = np.random.default_rng(2)
    obs = [np.clip(clean + rng.normal(0, 25, clean.shape), 0, 255).astype(np.float32)
           for _ in range(3)]
    _close(T.denoise_tvl1(obs, n_iters=20, device=CPU), J.denoise_tvl1(obs, n_iters=20), 1e-3)


def test_inpaint_telea_close_to_jax(clean, hole):
    corrupted = np.where(hole, 0.0, clean).astype(np.float32)
    _close(T.inpaint_telea(corrupted, hole, device=CPU),
           J.inpaint_telea(jnp.asarray(corrupted), jnp.asarray(hole)), 1e-3)
    rgb = np.stack([clean, np.roll(clean, 7, 1), 255 - clean], -1)
    _close(T.inpaint_telea(rgb, hole, 2.0, device=CPU),
           J.inpaint_telea(jnp.asarray(rgb), jnp.asarray(hole), 2.0), 1e-3)


def _rgb(clean):
    return np.stack([clean, np.roll(clean, 9, 1), 255 - clean], -1).astype(np.float32)


def _small(clean):
    return np.ascontiguousarray(clean[8:32, 12:44])


def test_decolor_close_to_jax(clean):
    rgb = _rgb(clean)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    n = rgb.shape[0] * rgb.shape[1]
    pairs = [np.asarray(jax.random.randint(k, (4096,), 0, n)) for k in (k1, k2)]
    gj, bj = J.decolor(jnp.asarray(rgb))
    gt, bt = T.decolor(rgb, pairs=pairs, device=CPU)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    _close(bt, bj, 1e-4)


@pytest.mark.parametrize("gray", [False, True])
def test_edge_preserving_filter_close_to_jax(clean, gray):
    x = _small(clean) if gray else _rgb(_small(clean))
    _close(T.edge_preserving_filter(x, device=CPU), jax.jit(J.edge_preserving_filter)(x), 1e-3)


def test_npr_family_close_to_jax(clean):
    rgb = _rgb(_small(clean))
    _close(T.detail_enhance(rgb, device=CPU), jax.jit(J.detail_enhance)(rgb), 1e-3)
    _close(T.stylization(rgb, device=CPU), jax.jit(J.stylization)(rgb), 1e-2)
    (sj, cj), (st, ct) = jax.jit(J.pencil_sketch)(rgb), T.pencil_sketch(rgb, device=CPU)
    _close(st, sj, 1e-2)
    _close(ct, cj, 1e-2)
