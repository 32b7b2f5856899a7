"""Descriptor width in the port's Hamming matchers: 512-bit descriptors
(BRISK's and AKAZE's [K, 16] words) against the JAX package, whose
matcher takes the bit count from the descriptors, and the 256-bit (ORB)
results unchanged.

Tolerance: none. Distances are integers computed exactly (+-1 products
summed in f32, or popcounts), so matrices, matches, masks and the
streaming 2-NN are asserted equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.core.config import MatchConfig as JMatchConfig
from opencv_tpu.ops import matching as jmatch
from opencv_tpu_torch.core.config import MatchConfig
from opencv_tpu_torch.ops import matching as tmatch
from opencv_tpu_torch.ops.cuda import knn as tknn

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)


def rand_desc(rng, n, words):
    return rng.integers(0, 2 ** 32, size=(n, words), dtype=np.uint64).astype(np.uint32)


def to_t(desc):
    return torch.from_numpy(np.ascontiguousarray(desc).view(np.int32))


def near_set(rng, nq, nt, words, invalid_share=0.1):
    """Queries that are noisy copies of train rows (a few bits flipped),
    duplicate train rows (ties) and ~invalid_share invalid rows on both
    sides."""
    t = rand_desc(rng, nt, words)
    t[nt // 2: nt // 2 + nt // 8] = t[: nt // 8]
    q = rand_desc(rng, nq, words)
    src = rng.integers(0, nt, nq)
    q[: 3 * nq // 4] = t[src[: 3 * nq // 4]]
    for i in range(3 * nq // 4):
        for b in rng.integers(0, 32 * words, 40 * words // 8):
            q[i, b // 32] ^= np.uint32(1 << (int(b) % 32))
    qv = rng.random(nq) > invalid_share
    tv = rng.random(nt) > invalid_share
    return q, t, qv, tv


@pytest.mark.parametrize("words", [16, 8])
def test_hamming_matrix_equals_jax(rng, words):
    q, t, qv, tv = near_set(rng, 48, 300, words)
    want = np.asarray(jmatch.hamming_matrix(jnp.asarray(q), jnp.asarray(t),
                                            jnp.asarray(qv), jnp.asarray(tv)))
    got = tmatch.hamming_matrix(to_t(q), to_t(t), torch.from_numpy(qv), torch.from_numpy(tv))
    np.testing.assert_array_equal(got.numpy(), want)
    if words == 16:
        assert want.max() == 1024.0  # invalid rows carry 2 * 512


@pytest.mark.parametrize("cross_check", [True, False])
@pytest.mark.parametrize("words", [16, 8])
def test_knn_match_equals_jax(rng, words, cross_check):
    """Random 16-word descriptors: the 256-bit matcher kept 300 of 300
    ratio-test matches here where JAX keeps 292."""
    q = rand_desc(rng, 300, words)
    t = rand_desc(rng, 400, words)
    jcfg = JMatchConfig(ratio=0.8, cross_check=cross_check, max_distance=256.0 * words / 8)
    cfg = MatchConfig(ratio=0.8, cross_check=cross_check, max_distance=256.0 * words / 8)
    jm = jmatch.knn_match(jnp.asarray(q), jnp.asarray(t), config=jcfg)
    tm = tmatch.knn_match(to_t(q), to_t(t), config=cfg)
    np.testing.assert_array_equal(tm.train_idx.numpy(), np.asarray(jm.train_idx))
    np.testing.assert_array_equal(tm.distance.numpy(), np.asarray(jm.distance))
    np.testing.assert_array_equal(tm.valid.numpy(), np.asarray(jm.valid))


@pytest.mark.parametrize("words", [16, 8])
def test_knn_match_with_masks_equals_jax(rng, words):
    q, t, qv, tv = near_set(rng, 64, 256, words)
    jm = jmatch.knn_match(jnp.asarray(q), jnp.asarray(t), jnp.asarray(qv), jnp.asarray(tv))
    tm = tmatch.knn_match(to_t(q), to_t(t), torch.from_numpy(qv), torch.from_numpy(tv))
    np.testing.assert_array_equal(tm.train_idx.numpy(), np.asarray(jm.train_idx))
    np.testing.assert_array_equal(tm.distance.numpy(), np.asarray(jm.distance))
    np.testing.assert_array_equal(tm.valid.numpy(), np.asarray(jm.valid))
    assert int(tm.valid.sum()) > 10


@pytest.mark.parametrize("radius", [64.0, 200.0])
def test_radius_match_mask_equals_jax(rng, radius):
    q, t, qv, tv = near_set(rng, 40, 200, 16)
    want = np.asarray(jmatch.radius_match_mask(jnp.asarray(q), jnp.asarray(t), radius,
                                               jnp.asarray(qv), jnp.asarray(tv)))
    got = tmatch.radius_match_mask(to_t(q), to_t(t), radius, torch.from_numpy(qv),
                                   torch.from_numpy(tv))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()


def test_knn_match_auto_streams_at_512_bits_like_jax(rng):
    """Above the streaming threshold the port runs K3's plain version on a
    CPU tensor; the JAX package runs its dense matcher on a CPU. With
    cross-check off both keep the same matches."""
    nt = tmatch.STREAMING_TRAIN_THRESHOLD + 64
    q, t, qv, tv = near_set(rng, 40, nt, 16)
    jcfg = JMatchConfig(cross_check=False, max_distance=512.0)
    cfg = MatchConfig(cross_check=False, max_distance=512.0)
    jm = jmatch.knn_match_auto(jnp.asarray(q), jnp.asarray(t), jnp.asarray(qv), jnp.asarray(tv),
                               config=jcfg)
    tm = tmatch.knn_match_auto(to_t(q), to_t(t), torch.from_numpy(qv), torch.from_numpy(tv),
                               config=cfg)
    ok = np.asarray(jm.valid)
    np.testing.assert_array_equal(tm.valid.numpy(), ok)
    np.testing.assert_array_equal(tm.train_idx.numpy()[ok], np.asarray(jm.train_idx)[ok])
    np.testing.assert_array_equal(tm.distance.numpy()[ok], np.asarray(jm.distance)[ok])
    assert ok.sum() > 20


@pytest.mark.parametrize("chunk", [64, 8192])
def test_knn2_plain_at_16_words_equals_dense(rng, chunk):
    """K3's plain version at 512 bits against the dense matcher with
    cross-check off: equal d1, i1 and matches wherever d1 is a real
    distance."""
    q, t, qv, tv = near_set(rng, 64, 500, 16)
    d1, d2, i1 = tknn.knn2_hamming_plain(to_t(q), to_t(t), torch.from_numpy(tv), chunk=chunk)
    dist = tmatch.hamming_matrix(to_t(q), to_t(t), None, torch.from_numpy(tv))
    want_d1, want_i1 = torch.min(dist, dim=1)
    np.testing.assert_array_equal(d1.numpy(), want_d1.numpy())
    np.testing.assert_array_equal(i1.numpy(), want_i1.numpy())
    cols = torch.arange(dist.shape[1])[None, :]
    want_d2 = torch.where(cols == want_i1[:, None], float("inf"), dist).amin(dim=1)
    np.testing.assert_array_equal(d2.numpy(), torch.clamp(want_d2, max=tknn.FAR).numpy())
    streamed = tknn.knn_match_streaming(to_t(q), to_t(t), torch.from_numpy(qv),
                                        torch.from_numpy(tv), max_distance=512.0)
    dense = tmatch.knn_match(to_t(q), to_t(t), torch.from_numpy(qv), torch.from_numpy(tv),
                             MatchConfig(cross_check=False, max_distance=512.0))
    np.testing.assert_array_equal(streamed.valid.numpy(), dense.valid.numpy())
    ok = dense.valid.numpy()
    np.testing.assert_array_equal(streamed.train_idx.numpy()[ok], dense.train_idx.numpy()[ok])


def test_widths_other_than_256_and_512_bits_raise_on_the_kernel_path():
    """The CUDA wrapper names the supported widths; here (no card) it is
    reached with a meta tensor standing in for a CUDA one."""
    q = torch.zeros((4, 12), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="8 or 16"):
        tknn.knn2_hamming_cuda(q, q)
