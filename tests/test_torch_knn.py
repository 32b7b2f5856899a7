"""Hamming matching of the PyTorch port: the plain streaming 2-NN (K3)
against the interpret-mode Pallas kernel and the dense JAX matcher, the
dense matcher with cross-check against JAX, all exact. The CUDA kernel
is held against its plain version on a card in test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from opencv_tpu.core.config import MatchConfig as JMatchConfig
from opencv_tpu.ops import matching as jmatch
from opencv_tpu.ops.pallas import knn as jknn
from opencv_tpu_torch.core.config import MatchConfig
from opencv_tpu_torch.ops import cuda as cuda_ops
from opencv_tpu_torch.ops import matching as tmatch
from opencv_tpu_torch.ops.cuda import knn as tknn

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)


def rand_desc(rng, n):
    return rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)


def to_t(desc):
    return torch.from_numpy(desc.view(np.int32))


def tied_set(rng, nq, nt, invalid_share=0.1):
    """Train rows with duplicates (exact distance ties) and near copies as
    queries, ~invalid_share of train rows invalid."""
    t = rand_desc(rng, nt)
    t[nt // 2 : nt // 2 + nt // 8] = t[: nt // 8]
    q = rand_desc(rng, nq)
    q[: nq // 2] = t[rng.integers(0, nt // 8, nq // 2)]
    for i in range(nq // 2):
        b = rng.integers(0, 256)
        q[i, b // 32] ^= np.uint32(1 << (b % 32))
    valid = rng.random(nt) > invalid_share
    return q, t, valid


def _pallas_d1d2i1(q, t, valid, q_tile, t_tile):
    """The Pallas kernel as knn_match_streaming feeds it (validity column)."""
    qs = jmatch.signed_descriptors(jnp.asarray(q))
    ts = jmatch.signed_descriptors(jnp.asarray(t))
    qpad = jnp.zeros((q.shape[0], 128), jnp.bfloat16).at[:, 0].set(1.0)
    pen = jnp.where(jnp.asarray(valid), 0.0, -2048.0).astype(jnp.bfloat16)
    tpad = jnp.zeros((t.shape[0], 128), jnp.bfloat16).at[:, 0].set(pen)
    d1, d2, i1 = jknn.knn2_hamming(
        jnp.concatenate([qs, qpad], 1), jnp.concatenate([ts, tpad], 1),
        q_tile=q_tile, t_tile=t_tile, interpret=True,
    )
    return np.asarray(d1), np.asarray(d2), np.asarray(i1)


@pytest.mark.parametrize("chunk", [32, 8192])
def test_knn2_plain_equals_pallas_interpret(rng, chunk):
    q, t, valid = tied_set(rng, 64, 256)
    d1, d2, i1 = _pallas_d1d2i1(q, t, valid, 32, 32)
    e1, e2, j1 = tknn.knn2_hamming_plain(to_t(q), to_t(t), torch.from_numpy(valid), chunk=chunk)
    np.testing.assert_array_equal(e1.numpy(), d1)
    np.testing.assert_array_equal(e2.numpy(), d2)
    np.testing.assert_array_equal(j1.numpy(), i1)
    assert (d1 == d2).any()  # ties present


def test_knn2_plain_equals_dense_sort(rng):
    q, t, _ = tied_set(rng, 48, 200)
    dense = np.asarray(jmatch.hamming_matrix(jnp.asarray(q), jnp.asarray(t)))
    d1, d2, i1 = tknn.knn2_hamming_plain(to_t(q), to_t(t), chunk=64)
    srt = np.sort(dense, axis=1)
    np.testing.assert_array_equal(d1.numpy(), srt[:, 0])
    np.testing.assert_array_equal(d2.numpy(), srt[:, 1])
    np.testing.assert_array_equal(i1.numpy(), dense.argmin(axis=1))


def test_hamming_matrix_equals_jax(rng):
    q, t, valid = tied_set(rng, 20, 40)
    qv = rng.random(20) > 0.2
    want = np.asarray(jmatch.hamming_matrix(jnp.asarray(q), jnp.asarray(t),
                                            jnp.asarray(qv), jnp.asarray(valid)))
    got = tmatch.hamming_matrix(to_t(q), to_t(t), torch.from_numpy(qv), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cross_check", [True, False])
def test_dense_knn_match_equals_jax(rng, cross_check):
    q, t, valid = tied_set(rng, 96, 160, invalid_share=0.2)
    qv = rng.random(96) > 0.1
    cfg = dict(ratio=0.8, cross_check=cross_check, max_distance=100.0)
    mj = jmatch.knn_match(jnp.asarray(q), jnp.asarray(t), jnp.asarray(qv), jnp.asarray(valid),
                          config=JMatchConfig(**cfg))
    mt = tmatch.knn_match(to_t(q), to_t(t), torch.from_numpy(qv), torch.from_numpy(valid),
                          config=MatchConfig(**cfg))
    np.testing.assert_array_equal(mt.train_idx.numpy(), np.asarray(mj.train_idx))
    np.testing.assert_array_equal(mt.distance.numpy(), np.asarray(mj.distance))
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
    assert mt.valid.any()


def test_streaming_matcher_equals_jax_streaming(rng):
    q, t, valid = tied_set(rng, 64, 256)
    qv = rng.random(64) > 0.1
    mj = jknn.knn_match_streaming(jnp.asarray(q), jnp.asarray(t), jnp.asarray(qv),
                                  jnp.asarray(valid), interpret=True)
    mt = tknn.knn_match_streaming(to_t(q), to_t(t), torch.from_numpy(qv), torch.from_numpy(valid))
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
    np.testing.assert_array_equal(mt.train_idx.numpy(), np.asarray(mj.train_idx))
    np.testing.assert_array_equal(mt.distance.numpy(), np.asarray(mj.distance))


def test_knn_match_auto_dispatch(rng):
    """Below the threshold: the dense matcher. The streaming matcher equals
    the JAX package's forced streaming and, without cross-check, the dense
    matches."""
    q, t, valid = tied_set(rng, 32, 64)
    cfg = MatchConfig(cross_check=False)
    m_auto = tmatch.knn_match_auto(to_t(q), to_t(t), train_valid=torch.from_numpy(valid), config=cfg)
    m_dense = tmatch.knn_match(to_t(q), to_t(t), train_valid=torch.from_numpy(valid), config=cfg)
    assert torch.equal(m_auto.valid, m_dense.valid)
    assert torch.equal(m_auto.train_idx, m_dense.train_idx)
    m_forced = tknn.knn_match_streaming(to_t(q), to_t(t), train_valid=torch.from_numpy(valid),
                                        ratio=cfg.ratio, max_distance=cfg.max_distance)
    mj = jmatch.knn_match_auto(jnp.asarray(q), jnp.asarray(t), train_valid=jnp.asarray(valid),
                               config=JMatchConfig(cross_check=False), force_streaming=True,
                               interpret=True)
    np.testing.assert_array_equal(m_forced.valid.numpy(), np.asarray(mj.valid))
    v = m_dense.valid
    assert torch.equal(m_forced.valid, v)
    assert torch.equal(m_forced.train_idx[v], m_dense.train_idx[v])


def test_retrieval_size_streams_without_launch_on_cpu(rng):
    """At the retrieval threshold the CPU runs K3's plain version: no
    kernel launch is counted."""
    cuda_ops.reset_launch_counts()
    q, t, valid = tied_set(rng, 16, tmatch.STREAMING_TRAIN_THRESHOLD)
    m = tmatch.knn_match_auto(to_t(q), to_t(t), train_valid=torch.from_numpy(valid),
                              config=MatchConfig(cross_check=False))
    assert m.valid.shape == (16,)
    assert cuda_ops.launch_counts["knn2_hamming"] == 0

