"""CUDA kernels of the PyTorch port against their plain PyTorch versions on
an NVIDIA card: K1/K2 (csrc/fast.cu; every arc of every ring, one level
and a pyramid per launch), K3 (csrc/knn2_hamming.cu) and K4/K5
(csrc/lk_sample.cu; compiled-in and generic windows, ragged point
counts), at the main path's shapes and at ragged ones, all exact; and the
LK path on the card against the same path on the CPU.

This file imports neither jax nor the JAX package, so that it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from opencv_tpu_torch.ops import cuda as cuda_ops
from opencv_tpu_torch.core.config import LKConfig
from opencv_tpu_torch.ops import lk
from opencv_tpu_torch.ops.cuda import fast_kernel, knn, lk_sample


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
@pytest.mark.parametrize("pattern,arc", [(p, a) for p in (16, 12, 8) for a in range(1, p + 1)])
def test_fast_kernel_equals_plain(card, pattern, arc):
    """Every arc of every ring: the compiled-in default arcs (16/9, 12/7,
    8/5) and the generic instantiation."""
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


def _level_sets():
    from opencv_tpu_torch.core import pyramid

    return {
        "orb_480x640": pyramid.level_shapes(480, 640, 8, 1.2),
        "ragged": [(67, 93), (5, 300), (7, 7), (1, 1)],
        "deeper_than_the_table": pyramid.level_shapes(480, 640, fast_kernel.MAX_LEVELS + 4, 1.2),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["orb_480x640", "ragged", "deeper_than_the_table"])
def test_fast_levels_kernel_equals_plain(card, name):
    """One launch per MAX_LEVELS levels, each level's (score, nms) equal
    to the plain version and to the one-level entry."""
    rng = np.random.default_rng(5)
    shapes = _level_sets()[name]
    levels = []
    for h, w in shapes:
        img = _img(rng, h, w)
        img[: h // 3, : w // 2] = 200.0  # plateaus: NMS ties
        levels.append(torch.from_numpy(img).to(card))
    cuda_ops.reset_launch_counts()
    got = fast_kernel.fast_corners_levels(levels, 20.0)
    torch.cuda.synchronize()
    assert cuda_ops.launch_counts["fast_corners"] == -(-len(levels) // fast_kernel.MAX_LEVELS)
    assert len(got) == len(levels)
    for lvl, (s_k, n_k) in zip(levels, got):
        s_p, n_p = fast_kernel.fast_corners_plain(lvl, 20.0)
        assert torch.equal(s_k, s_p) and torch.equal(n_k, n_p)
        s_1, n_1 = fast_kernel.fast_corners_cuda(lvl, 20.0)
        assert torch.equal(s_k, s_1) and torch.equal(n_k, n_1)


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


def _lk_points(rng, n, h, w, win):
    """Interior subpixel points, then every border, outside, far outside
    and non-finite case of tests/test_pallas_lk_sample.py."""
    pts = np.stack([rng.uniform(0, w - 1, n), rng.uniform(0, h - 1, n)], -1).astype(np.float32)
    odd = np.array([
        [0.0, 0.0], [w - 1.0, h - 1.0], [0.3, 17.2], [w - 1.4, 30.1], [40.2, 0.7],
        [39.9, h - 1.2], [-3.5, 12.0], [w + 4.0, h + 4.0], [-win / 2, -win / 2],
        [-500.0, -500.0], [1e7, 12.0], [np.nan, 5.0], [5.0, np.inf], [-np.inf, 3.0],
        [33.0, 44.0],
    ], np.float32)
    pts[: min(n, len(odd))] = odd[:n]
    return pts


@pytest.mark.cuda
@pytest.mark.parametrize("n_ch,win,n,integer", [
    (3, 21, 2000, False),  # templates of the klt engine's track set
    (3, 21, 512, False),  # templates of the LK path
    (1, 48, 512, True),  # patch extraction at integer origins
    (1, 21, 2000, False),  # polish
    (2, 15, 37, False),  # ragged
])
def test_lk_sample_kernel_equals_plain(card, n_ch, win, n, integer):
    rng = np.random.default_rng(11)
    for h, w in ((480, 640), (67, 93)):
        chans = torch.from_numpy(rng.normal(100, 50, (n_ch, h, w)).astype(np.float32)).to(card)
        pts = _lk_points(rng, n, h, w, win)
        if integer:
            pts = np.round(pts)
        p = torch.from_numpy(pts).to(card)
        got = lk_sample.sample_channels(chans, p, win)
        want = lk_sample.sample_channels_plain(chans, p, win)
        assert got.shape == (n_ch, n, win, win)
        assert torch.equal(got, want)
        assert not got[:, 9:14].any()  # far outside and non-finite: zero windows


@pytest.mark.cuda
@pytest.mark.parametrize("win,n_ch", [(w, c) for w in (7, 15, 21, 23, 48) for c in (1, 2, 3, 4)])
def test_lk_sample_kernel_ragged_counts(card, win, n_ch):
    """Windows 21 and 48 (compiled in) and 7, 15, 23 (generic), C = 1-4,
    at N = 0, 2000 and P - 1, P + 1 for every count P of points a block
    takes at these windows and channels (1, 2, 4, 5, 6, 10, 20: 1024
    outputs or one point), odd points first."""
    rng = np.random.default_rng(win * 10 + n_ch)
    h, w = 67, 93
    chans = torch.from_numpy(rng.normal(100, 50, (n_ch, h, w)).astype(np.float32)).to(card)
    for n in (0, 1, 2, 3, 4, 5, 6, 7, 9, 11, 19, 21, 2000):
        p = torch.from_numpy(_lk_points(rng, n, h, w, win)).to(card)
        got = lk_sample.sample_channels(chans, p, win)
        want = lk_sample.sample_channels_plain(chans, p, win)
        assert got.shape == (n_ch, n, win, win)
        assert torch.equal(got, want), (n, int((got != want).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("win,n_ch", [(201, 1), (238, 1), (239, 1), (119, 4), (120, 4)])
def test_lk_sample_windows_beyond_shared_memory(card, win, n_ch):
    """Generic windows past 48 KB of staged taps (201), at the last width
    whose taps fit in an H100's shared memory (238 for one channel, 119
    for four) and past it, where the taps are read from global memory:
    K4 and (one channel) K5 still equal their plain versions."""
    rng = np.random.default_rng(win)
    h, w = 300, 280
    chans = torch.from_numpy(rng.normal(100, 50, (n_ch, h, w)).astype(np.float32)).to(card)
    p = torch.from_numpy(_lk_points(rng, 17, h, w, win)).to(card)
    got = lk_sample.sample_channels(chans, p, win)
    assert torch.equal(got, lk_sample.sample_channels_plain(chans, p, win))
    if n_ch == 1:
        assert torch.equal(lk_sample.sample_windows(chans[0], p, win),
                           lk_sample.sample_windows_plain(chans[0], p, win))


@pytest.mark.cuda
@pytest.mark.parametrize("win", [21, 15])
def test_lk_windows_kernel_equals_plain(card, win):
    """K5 at the compiled-in win 21 and the generic instantiation."""
    rng = np.random.default_rng(12)
    img = torch.from_numpy(rng.normal(100, 50, (480, 640)).astype(np.float32)).to(card)
    pts = _lk_points(rng, 512, 480, 640, win)
    p = torch.from_numpy(pts).to(card)
    assert torch.equal(lk_sample.sample_windows(img, p, win), lk_sample.sample_windows_plain(img, p, win))


@pytest.mark.cuda
def test_lk_path_on_card_equals_cpu(card):
    """A 304x320 translation: level 0 is over the kernel's 90 000-px gate,
    so K4 runs its three sites once each; the points agree with the CPU
    run of the same path within 0.05 px."""
    rng = np.random.default_rng(3)
    small = rng.uniform(0, 255, (76, 80)).astype(np.float32)
    img = np.kron(small, np.ones((4, 4), np.float32))
    img = lk.imgproc.gaussian_blur(torch.from_numpy(img), 5, 1.2).numpy()
    moved = np.roll(img, (3, 5), axis=(0, 1))
    pts = np.stack([rng.uniform(30, 290, 300), rng.uniform(30, 270, 300)], -1).astype(np.float32)
    cfg = LKConfig(win_size=21, n_levels=3)
    cpu = lk.calc_optical_flow_pyr_lk(img, moved, pts, cfg=cfg, device="cpu")
    cuda_ops.reset_launch_counts()
    gpu = lk.calc_optical_flow_pyr_lk(img, moved, pts, cfg=cfg, device=card)
    torch.cuda.synchronize()
    assert cuda_ops.launch_counts["lk_sample"] == 3
    both = cpu[1] & gpu[1].cpu()
    assert (cpu[1] == gpu[1].cpu()).float().mean() >= 0.99 and both.sum() > 250
    assert float((cpu[0] - gpu[0].cpu())[both].abs().max()) < 0.05
    flow = (gpu[0].cpu() - torch.from_numpy(pts))[both]
    assert float((flow - torch.tensor([5.0, 3.0])).abs().max()) < 0.35


@pytest.mark.cuda
def test_gftt_on_card_equals_cpu(card):
    """The min-eigenvalue response sums in one fixed order of f32 adds, so
    the card's corners are the CPU's bit for bit."""
    from opencv_tpu_torch.ops import gftt

    rng = np.random.default_rng(4)
    img = np.kron(rng.uniform(0, 255, (120, 160)).astype(np.float32), np.ones((4, 4), np.float32))
    img = lk.imgproc.gaussian_blur(torch.from_numpy(img), 5, 1.2)
    assert torch.equal(lk.imgproc.min_eig_response(img.to(card)).cpu(),
                       lk.imgproc.min_eig_response(img))
    cpu = gftt.good_features_to_track(img, 512, 0.01, 7.0, device="cpu")
    gpu = gftt.good_features_to_track(img, 512, 0.01, 7.0, device=card)
    assert int(cpu.valid.sum()) > 100
    for name in ("xy", "response", "valid"):
        assert torch.equal(getattr(cpu, name), getattr(gpu, name).cpu())


@pytest.mark.cuda
def test_wrappers_count_launches(card):
    cuda_ops.reset_launch_counts()
    x = torch.zeros((32, 32), device=card)
    fast_kernel.fast_corners_cuda(x, 20.0)
    fast_kernel.fast_corners_levels([x, x[:16, :8]], 20.0)
    fast_kernel.fast_score_cuda(x)
    q, t, v = (a.to(card) for a in _tied_set(np.random.default_rng(0), 8, 64))
    knn.knn_match_streaming(q, t, train_valid=v)
    pts = torch.zeros((4, 2), device=card)
    lk_sample.sample_templates(x, x, x, pts, 21)
    lk_sample.sample_single(x, pts, 48)
    lk_sample.sample_windows(x, pts, 21)
    torch.cuda.synchronize()
    assert cuda_ops.launch_counts == {"fast_corners": 2, "fast_score": 1, "knn2_hamming": 1,
                                      "lk_sample": 2, "lk_sample_clamp": 1}
