"""Hamming matching of the PyTorch port: the plain streaming 2-NN (K3)
against the interpret-mode Pallas kernel and the dense JAX matcher, the
dense matcher with cross-check against JAX, all exact; and a model of the
CUDA kernel's order of work (splits, tiles, accumulator lanes, keys, the
lexicographic lane merge) against the plain version, exact. The CUDA
kernel is held against its plain version on a card in test_torch_cuda.py."""

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



# ------------------------------------------------ the CUDA kernel's order
#
# A model of csrc/knn2_hamming.cu's order of work, held against the plain
# version: the train set cut into splits (the wrapper's _split_plan) and
# tiles of 128 rows; in a tile, column c belongs to lane (c >> 1) & 3 of
# its row (the wgmma accumulator layout: 8j + 2 (lane % 4) + {0, 1}) and
# carries the rank 31 - (2 (c >> 3) + (c & 1)); the accumulator is the key
# 64 (popc(q) - d) + rank, less 130 560 for an invalid row or one past the
# split; each lane keeps the two largest keys of the tile, decodes them and
# folds them into its running (d1, d2, i1); the four lanes of a row merge
# by xor-1 then xor-2 exchanges, lexicographically on (d1, i1); the splits
# fold in ascending order.

KTILE = 128
KFAR = 512
KPEN = 4 * 128 * 255


def _bits(words):
    """uint32 [N, W] -> 0/1 int64 [N, 32 W] (bit order is irrelevant to a distance)."""
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8), axis=1).astype(np.int64)


def _lex_merge(a, b):
    """Merge lane states (d1, d2, i1): the lower (d1, i1) wins, and d2 is the
    second value of the two multisets."""
    a1, a2, ai = a
    b1, b2, bi = b
    take_b = (b1 < a1) | ((b1 == a1) & (bi < ai))
    return (np.where(take_b, b1, a1), np.where(take_b, np.minimum(a1, b2), np.minimum(a2, b1)),
            np.where(take_b, bi, ai))


def _d1_only_merge(a, b):
    """The faulty merge: by d1 alone, so a tie keeps the lane's own index."""
    a1, a2, ai = a
    b1, b2, bi = b
    take_b = b1 < a1
    return (np.where(take_b, b1, a1), np.where(take_b, np.minimum(a1, b2), np.minimum(a2, b1)),
            np.where(take_b, bi, ai))


def kernel_order_2nn(q, t, valid, n_sm, lane_merge=_lex_merge):
    """(d1, d2, i1) of [Nq] by the kernel's order of work on uint32 words."""
    nq, nt = q.shape[0], t.shape[0]
    qb, tb = _bits(q), _bits(t)
    dist = qb @ (1 - tb).T + (1 - qb) @ tb.T  # exact Hamming [nq, nt]
    pq = qb.sum(axis=1)[:, None]
    ok = np.ones(nt, bool) if valid is None else np.asarray(valid, bool)
    rows, splits = tknn._split_plan(nq, nt, KTILE, n_sm)
    c = np.arange(KTILE)
    lane_of = (c >> 1) & 3
    rank = 31 - (2 * (c >> 3) + (c & 1))
    out = [np.full(nq, KFAR), np.full(nq, KFAR), np.zeros(nq, np.int64)]
    for s in range(splits):
        j0, j1 = s * rows, min(nt, (s + 1) * rows)
        lanes = [[np.full(nq, KFAR), np.full(nq, KFAR), np.zeros(nq, np.int64)] for _ in range(4)]
        for base in range(j0, j1, KTILE):
            cols = base + c
            inside = cols < j1
            d = np.zeros((nq, KTILE), np.int64)
            d[:, inside] = dist[:, cols[inside]]
            bad = ~inside | ~ok[np.minimum(cols, nt - 1)]
            key = 64 * (pq - d) + rank[None, :] - KPEN * bad[None, :]
            for lane in range(4):
                kl = np.sort(key[:, lane_of == lane], axis=1)
                k1, k2 = kl[:, -1], kl[:, -2]
                l1, l2 = pq[:, 0] - (k1 >> 6), pq[:, 0] - (k2 >> 6)
                o1 = 31 - (k1 & 63)
                idx = base + 8 * (o1 >> 1) + 2 * lane + (o1 & 1)
                d1, d2, i1 = lanes[lane]
                better = l1 < d1
                lanes[lane] = [np.where(better, l1, d1),
                               np.where(better, np.minimum(d1, l2), np.minimum(d2, l1)),
                               np.where(better, idx, i1)]
        for m in (1, 2):  # butterfly over the four lanes of a row
            lanes = [lane_merge(lanes[lane], lanes[lane ^ m]) for lane in range(4)]
        a1, a2, ai = lanes[0]
        d1, d2, i1 = out
        better = a1 < d1
        out = [np.where(better, a1, d1), np.where(better, np.minimum(d1, a2), np.minimum(d2, a1)),
               np.where(better, ai, i1)]
    return out


def _case(kind, nq, nt, words, seed):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 2 ** 32, size=(nt, words), dtype=np.uint64).astype(np.uint32)
    q = rng.integers(0, 2 ** 32, size=(nq, words), dtype=np.uint64).astype(np.uint32)
    valid = rng.random(nt) > 0.1
    if kind == "duplicates":  # exact duplicate rows, queries one bit off a row
        t[nt // 2: nt // 2 + nt // 4] = t[: nt // 4]
        near = rng.integers(0, max(1, nt // 4), nq)
        q[:] = t[near]
        q[:, 0] ^= np.uint32(1)
    elif kind == "identical":  # every row the same: every distance a tie
        t[:] = t[0]
        q[: nq // 2] = t[0]
    elif kind == "all_invalid":
        valid[:] = False
    elif kind == "single_valid":
        valid[:] = False
        valid[rng.integers(0, nt)] = True
    elif kind == "complement":  # d = bits: at 512 bits d = FAR never enters
        t[: nt // 2] = ~q[np.arange(nt // 2) % nq]
        valid[: nt // 2] = True
    return q, t, valid


RAGGED = [(1, 1), (63, 64), (64, 65), (65, 63), (127, 128), (128, 129), (129, 127), (300, 1000),
          (1000, 300)]


def _assert_model_equals_plain(q, t, valid, n_sm):
    got = kernel_order_2nn(q, t, valid, n_sm)
    want = tknn.knn2_hamming_plain(to_t(q), to_t(t), None if valid is None else torch.from_numpy(valid))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy().astype(np.int64))
    return got


@pytest.mark.parametrize("n_sm", [2, 132])
@pytest.mark.parametrize("words", [8, 16])
@pytest.mark.parametrize("nq,nt", RAGGED)
def test_kernel_order_equals_plain_at_ragged_sizes(nq, nt, words, n_sm):
    q, t, valid = _case("duplicates", nq, nt, words, seed=nq * 1009 + nt)
    _assert_model_equals_plain(q, t, valid, n_sm)
    _assert_model_equals_plain(q, t, None, n_sm)


@pytest.mark.parametrize("words", [8, 16])
@pytest.mark.parametrize("kind", ["duplicates", "identical", "all_invalid", "single_valid",
                                  "complement"])
def test_kernel_order_equals_plain_on_ties_and_masks(kind, words):
    q, t, valid = _case(kind, 300, 1000, words, seed=11)
    d1, d2, i1 = _assert_model_equals_plain(q, t, valid, n_sm=4)
    if kind in ("duplicates", "identical"):
        assert (d1 == d2).any()  # exact ties reach the merge
    if kind == "all_invalid":
        assert (d1 == KFAR).all() and (d2 == KFAR).all() and (i1 == 0).all()
    if kind == "single_valid":
        assert (d2 == KFAR).all()
    if kind == "complement" and words == 16:
        assert (d1 < KFAR).all()  # the complement rows (d = 512) never entered


@pytest.mark.parametrize("words", [8, 16])
def test_lane_merge_by_d1_alone_breaks_ties(words):
    """The lane merge must compare (d1, i1): merged by d1 alone, a row whose
    lowest tied index sits in another lane keeps the wrong index."""
    q, t, valid = _case("identical", 64, 300, words, seed=5)
    valid[:] = True
    valid[:2] = False  # the lowest tied index, 2, is lane 1's; lane 0's first is 8
    want = tknn.knn2_hamming_plain(to_t(q), to_t(t), torch.from_numpy(valid))[2].numpy()
    good = kernel_order_2nn(q, t, valid, 4)[2]
    bad = kernel_order_2nn(q, t, valid, 4, lane_merge=_d1_only_merge)[2]
    np.testing.assert_array_equal(good, want)
    assert (bad != want).any()
