"""CUDA kernels of the PyTorch port against their plain PyTorch versions on
an NVIDIA card: K1/K2 (csrc/fast.cu) and K3 (csrc/knn2_hamming.cu), at
the main path's shapes and at ragged ones, all exact.

This file imports neither jax nor the JAX package, so that it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from opencv_tpu_torch.ops import cuda as cuda_ops
from opencv_tpu_torch.ops.cuda import fast_kernel, knn


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _img(rng, h, w):
    return rng.integers(0, 255, size=(h, w)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern,arc", [(16, 9), (16, 12), (12, 7), (12, 9), (8, 5), (8, 8)])
def test_fast_kernel_equals_plain(card, pattern, arc):
    rng = np.random.default_rng(1234)
    for h, w in ((480, 640), (67, 93), (5, 300)):
        img = _img(rng, h, w)
        img[10:20, 10:40] = 200.0  # plateaus: NMS ties
        x = torch.from_numpy(img).to(card)
        s_k, n_k = fast_kernel.fast_corners_cuda(x, 20.0, arc, pattern)
        s_p, n_p = fast_kernel.fast_corners_plain(x, 20.0, arc, pattern)
        assert torch.equal(s_k, s_p) and torch.equal(n_k, n_p)
        assert torch.equal(fast_kernel.fast_score_cuda(x, arc, pattern),
                           fast_kernel.fast_score_plain(x, arc, pattern))


def _tied_set(rng, nq, nt):
    t = rng.integers(0, 2 ** 32, size=(nt, 8), dtype=np.uint64).astype(np.uint32)
    t[nt // 2: nt // 2 + nt // 8] = t[: nt // 8]  # exact ties across splits
    q = rng.integers(0, 2 ** 32, size=(nq, 8), dtype=np.uint64).astype(np.uint32)
    q[: nq // 2] = t[rng.integers(0, nt // 8, nq // 2)]
    q[: nq // 2, 0] ^= np.uint32(1)
    valid = rng.random(nt) > 0.1
    return (torch.from_numpy(q.view(np.int32)), torch.from_numpy(t.view(np.int32)),
            torch.from_numpy(valid))


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nt", [(2000, 64 * 2000), (37, 1000), (300, 257)])
def test_knn2_kernel_equals_plain(card, nq, nt):
    q, t, v = (a.to(card) for a in _tied_set(np.random.default_rng(7), nq, nt))
    for valid in (v, None):
        got = knn.knn2_hamming_cuda(q, t, valid)
        want = knn.knn2_hamming_plain(q, t, valid)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert bool((got[0] == got[1]).any())  # ties present


@pytest.mark.cuda
def test_wrappers_count_launches(card):
    cuda_ops.reset_launch_counts()
    x = torch.zeros((32, 32), device=card)
    fast_kernel.fast_corners_cuda(x, 20.0)
    fast_kernel.fast_score_cuda(x)
    q, t, v = (a.to(card) for a in _tied_set(np.random.default_rng(0), 8, 64))
    knn.knn_match_streaming(q, t, train_valid=v)
    torch.cuda.synchronize()
    assert cuda_ops.launch_counts == {"fast_corners": 1, "fast_score": 1, "knn2_hamming": 1}
