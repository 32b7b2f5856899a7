"""CUDA kernels of the PyTorch port against their plain PyTorch versions on
an NVIDIA card: K1/K2 (csrc/fast.cu; every arc of every ring, one level
and a pyramid per launch), K3 (csrc/knn2_hamming.cu) and K4/K5
(csrc/lk_sample.cu; compiled-in and generic windows, ragged point
counts), at the main path's shapes and at ragged ones, all exact; the LK
path on the card against the same path on the CPU; and the plain PyTorch
modules of the geometry slice (5-point, EPnP, calibration, the
undistortion map and remap, LSH matching), of the tracking-and-lanes
slice, of the calibration-app and video-stabilization slice (the rest
of imgproc, connected components, chessboard and circles-grid
detection, ECC, videostab; K4 at videostab's 200 points) and of the
panorama, QR and segmentation slice (morphology, warps, blends,
exposure, DP seams, stitch_pair with K1, QR detection and decoding, the
push-relabel min-cut with its CUDA graph, GrabCut, watershed, histograms,
mean shift and CamShift) on the card against the CPU; K3 at 512 bits, K2
at BRISK's level shapes, AGAST, BRISK, AKAZE, SGBM and TV-L1, and the
image-processing group (MOG2 and KNN steps, CLAHE, template matching,
phase correlation, the distance transform, NLM and Telea inpainting at
480x640) on the card against the CPU; the cascade trainer, the Haar and
LBP detectors and the dnn importers (the tiny_cnn ONNX fixture, a Darknet
region net) on the card against the CPU; dnn, HOG and template matching
at torch's default TF32 switches, and each dnn product with both TF32
switches on, against the CPU; and every ml model
fitted on the card against the CPU, with SVMSGD's CUDA-graph replays
against its eager steps.

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
from opencv_tpu_torch.ops.matching import unpack_bits


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


def _tied_set(rng, nq, nt, words=8):
    t = rng.integers(0, 2 ** 32, size=(nt, words), dtype=np.uint64).astype(np.uint32)
    t[nt // 2: nt // 2 + nt // 8] = t[: nt // 8]  # exact ties across splits
    q = rng.integers(0, 2 ** 32, size=(nq, words), dtype=np.uint64).astype(np.uint32)
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
@pytest.mark.parametrize("nq,nt", [(2000, 32000), (37, 1000), (300, 257)])
def test_knn2_kernel_at_512_bits_equals_plain(card, nq, nt):
    """K3's 4-chunk instantiation (BRISK's and AKAZE's [N, 16] words)."""
    q, t, v = (a.to(card) for a in _tied_set(np.random.default_rng(8), nq, nt, words=16))
    for valid in (v, None):
        got = knn.knn2_hamming_cuda(q, t, valid)
        want = knn.knn2_hamming_plain(q, t, valid)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert bool((got[0] == got[1]).any())
    with pytest.raises(ValueError, match="8 or 16"):
        knn.knn2_hamming_cuda(q[:, :12].contiguous(), t[:, :12].contiguous())


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
    (3, 21, 200, False),  # videostab's LK (GFTT's 200 corners): templates,
    (1, 48, 200, True),  # patches
    (1, 21, 200, False),  # and polish
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


# ------------------------------------------------ geometry, calibration, LSH


def _five_point_samples(rng, n):
    """n 5-point samples of a two-view scene (the rotation axis varies),
    with the true essential matrix of each (unit norm)."""
    from opencv_tpu_torch.geometry.rotation import hat, rodrigues

    x1s, x2s, Es = [], [], []
    t = np.array([0.4, 0.1, 0.15], np.float32)
    for _ in range(n):
        X = np.stack([rng.uniform(-2, 2, 5), rng.uniform(-1.5, 1.5, 5), rng.uniform(4, 12, 5)], 1)
        axis = rng.normal(size=3)
        R = rodrigues(torch.from_numpy((axis / np.linalg.norm(axis) * 0.1).astype(np.float32))).numpy()
        p2 = X @ R.T + t
        x1s.append(X[:, :2] / X[:, 2:3])
        x2s.append(p2[:, :2] / p2[:, 2:3])
        E = hat(torch.from_numpy(t)).numpy() @ R
        Es.append(E / np.linalg.norm(E))
    return (torch.from_numpy(np.asarray(x1s, np.float32)), torch.from_numpy(np.asarray(x2s, np.float32)),
            np.asarray(Es))


def _nearest_up_to_sign(cands, E):
    """Distance from E to the nearest of cands [K, 3, 3], up to sign."""
    if not len(cands):
        return np.inf
    return float(np.minimum(np.abs(cands - E).max((1, 2)), np.abs(cands + E).max((1, 2))).min())


@pytest.mark.cuda
def test_five_point_on_card_equals_cpu(card):
    """Each device finds the true E (within 5e-3, the JAX package's bound)
    on at least 95 % of 64 exact samples (in f32 the solver misses it on
    one: its realness or residual test rejects the root that the same code
    in f64 finds), and where both find it they agree within 1e-3; all
    valid candidates agree as sets within 1e-3 for at least 90 % of them
    (an ill-conditioned f32 root moves further: on an H100, two of one
    sample's roots did)."""
    from opencv_tpu_torch.geometry import five_point

    x1, x2, Et = _five_point_samples(np.random.default_rng(8), 64)
    cpu = five_point.five_point(x1, x2)
    gpu = five_point.five_point(x1.to(card), x2.to(card))
    Ec, vc = cpu.E.numpy(), cpu.valid.numpy()
    Eg, vg = gpu.E.cpu().numpy(), gpu.valid.cpu().numpy()
    found = {"cpu": 0, "card": 0}
    matched = total = 0
    for s in range(64):
        tc = [E for E in Ec[s][vc[s]] if _nearest_up_to_sign(E[None], Et[s]) < 5e-3]
        tg = [E for E in Eg[s][vg[s]] if _nearest_up_to_sign(E[None], Et[s]) < 5e-3]
        found["cpu"] += bool(tc)
        found["card"] += bool(tg)
        if tc and tg:
            assert _nearest_up_to_sign(np.asarray(tg), tc[0]) < 1e-3, s
        for E in Ec[s][vc[s]]:
            matched += _nearest_up_to_sign(Eg[s][vg[s]], E) < 1e-3
            total += 1
    assert min(found.values()) >= 0.95 * 64, found
    assert matched >= 0.9 * total, (matched, total)


@pytest.mark.cuda
def test_epnp_on_card_equals_cpu(card):
    """EPnP over 256 samples of 8 points (cuSOLVER's batched eigh against
    LAPACK's; the solver runs in f64 with the control points' axis signs
    fixed): poses within 5e-4 rad and 1e-2 on at least 97 % of the
    samples, where a near-tie between two beta cases may be picked
    otherwise, and within 1e-4 in the median."""
    from opencv_tpu_torch.geometry import epnp
    from opencv_tpu_torch.geometry.rotation import rodrigues

    rng = np.random.default_rng(9)
    X = np.stack([rng.uniform(-2, 2, 400), rng.uniform(-1.5, 1.5, 400), rng.uniform(4, 8, 400)], 1)
    R = rodrigues(torch.tensor([0.05, -0.12, 0.03])).numpy()
    pc = X @ R.T + [0.4, -0.1, 0.15]
    img = pc[:, :2] / pc[:, 2:3] + rng.normal(0, 5e-4, (400, 2))
    idx = torch.from_numpy(np.stack([rng.choice(400, 8, replace=False) for _ in range(256)]))
    Xt = torch.from_numpy(X.astype(np.float32))[idx]
    It = torch.from_numpy(img.astype(np.float32))[idx]
    mc, okc = epnp.epnp_kernel(Xt, It)
    mg, okg = epnp.epnp_kernel(Xt.to(card), It.to(card))
    assert bool(okc.all()) and bool(okg.cpu().all())
    d = (mc - mg.cpu()).abs()
    close = (d[:, :3].amax(1) < 5e-4) & (d[:, 3:].amax(1) < 1e-2)
    assert float(close.float().mean()) >= 0.97
    assert float(d[:, 3:].median()) < 1e-4


@pytest.mark.cuda
def test_calibrate_camera_on_card_equals_cpu(card):
    """Host init, LM on the device: K within 0.05 px, RMS within 1e-3 px."""
    from opencv_tpu_torch.geometry import calibration

    rng = np.random.default_rng(10)
    xs, ys = np.meshgrid(np.arange(9), np.arange(6))
    obj = np.stack([xs.ravel() * 0.025, ys.ravel() * 0.025, np.zeros(54)], 1).astype(np.float32)
    K4 = torch.tensor([520.0, 525.2, 326.0, 236.0])
    dist = torch.tensor([-0.2, 0.05, 0.001, -0.001, 0.0])
    imgs = []
    for _ in range(8):
        rv = torch.from_numpy(rng.uniform(-0.35, 0.35, 3).astype(np.float32))
        tv = torch.tensor([rng.uniform(-0.15, 0.0), rng.uniform(-0.1, 0.0), rng.uniform(0.45, 0.7)],
                          dtype=torch.float32)
        uv = calibration.project_points_full(rv, tv, K4, dist, torch.from_numpy(obj)).numpy()
        imgs.append(uv + rng.normal(0, 0.2, uv.shape))
    objs, imgs = np.stack([obj] * 8), np.stack(imgs).astype(np.float32)
    cpu = calibration.calibrate_camera(objs, imgs, device="cpu")
    gpu = calibration.calibrate_camera(objs, imgs, device=card)
    assert np.abs(cpu.K - gpu.K).max() < 0.05 and abs(cpu.rms - gpu.rms) < 1e-3
    assert gpu.rms < 0.35 and abs(gpu.K[0, 0] - 520.0) / 520.0 < 0.01


@pytest.mark.cuda
def test_undistort_map_and_remap_on_card_equal_cpu(card):
    """The map within 1e-3 px; remap on one map bit-equal (the same f32
    elementwise arithmetic, no contraction across eager kernels)."""
    from opencv_tpu_torch.core import imgproc
    from opencv_tpu_torch.geometry import calibration

    rng = np.random.default_rng(12)
    K = np.array([[520.0, 0, 326.0], [0, 525.2, 236.0], [0, 0, 1]], np.float32)
    dist = np.array([-0.2, 0.05, 0.001, -0.001, 0.0], np.float32)
    R = np.array([[0.9998, 0, 0.0175], [0, 1, 0], [-0.0175, 0, 0.9998]], np.float32)
    mc = calibration.init_undistort_rectify_map(K, dist, R, K, (480, 640), device="cpu")
    mg = calibration.init_undistort_rectify_map(K, dist, R, K, (480, 640), device=card)
    assert float((mc - mg.cpu()).abs().max()) < 1e-3
    img = torch.from_numpy(rng.uniform(0, 255, (480, 640)).astype(np.float32))
    assert torch.equal(imgproc.remap(img, mc), imgproc.remap(img.to(card), mc.to(card)).cpu())


@pytest.mark.cuda
def test_knn_match_lsh_on_card_equals_cpu(card):
    """The same index on both devices, integer Hamming: bit-equal."""
    from opencv_tpu_torch.ops import lsh

    rng = np.random.default_rng(13)
    train = rng.integers(0, 2 ** 32, (20000, 8), dtype=np.uint64).astype(np.uint32)
    query = train[rng.choice(20000, 2000, replace=False)].copy()
    for row in query:
        for b in rng.integers(0, 256, 12):
            row[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    query[:100] = rng.integers(0, 2 ** 32, (100, 8), dtype=np.uint64).astype(np.uint32)
    ic = lsh.build_lsh_index(train, device="cpu")
    ig = lsh.build_lsh_index(train, device=card)
    assert torch.equal(ic.buckets, ig.buckets.cpu())
    q = torch.from_numpy(query.view(np.int32))
    mc = lsh.knn_match_lsh(ic, q)
    mg = lsh.knn_match_lsh(ig, q.to(card))
    for name in ("train_idx", "distance", "valid"):
        assert torch.equal(getattr(mc, name), getattr(mg, name).cpu()), name
    assert float(mc.valid.float().mean()) > 0.5


# ------------------------------------------------ tracking and lane detection


def _tbd_app_run(dev, n_frames=40):
    """examples/tbd_app.py's scene under history "7,3" (each step restores
    the snapshot of 1 or 2 frames back): per frame and class the confirmed
    (ids, boxes), and the MOT counters."""
    from opencv_tpu_torch.tbd import MotMetrics, Tracker

    rng = np.random.default_rng(0)
    trackers = [Tracker(device=dev), Tracker(device=dev)]
    metrics = [MotMetrics(device=dev), MotMetrics(device=dev)]
    bufs = [[None, None], [None, None]]
    log = []
    for t in range(n_frames):
        gts = [np.array([[20 + 3.0 * t, 40 + 0.5 * t, 14, 30], [300 - 2.5 * t, 60, 14, 30],
                         [40 + 2.0 * t, 120, 14, 30]], np.float32),
               np.array([[10 + 6.0 * t, 200, 40, 24], [500 - 5.0 * t, 230, 44, 26]], np.float32)]
        dets = []
        for g in gts:
            keep = rng.random(len(g)) > 0.15
            dets.append(g[keep] + rng.normal(0, 0.8, (keep.sum(), 4)).astype(np.float32))
        age = int(rng.choice(2, p=[0.7, 0.3])) + 1
        for c in range(2):
            if t >= age:
                trackers[c].set_tracks(bufs[c][(t - age) % 2])
            else:
                trackers[c].reset()
            conf = trackers[c].step(dets[c])
            bufs[c][t % 2] = trackers[c].get_tracks()
            boxes = np.stack([x.bbox for x in conf]) if conf else np.zeros((0, 4), np.float32)
            log.append(([x.track_id for x in conf], boxes))
            if t >= 5 and conf:
                metrics[c].update(boxes, gts[c])
    return log, [(m.tp, m.fp, m.fn, m.gt) for m in metrics]


@pytest.mark.cuda
def test_tracker_on_card_equals_cpu(card):
    """The same confirmed IDs every frame, boxes within 1e-3 px, equal MOT
    counters (chip_smoke's [tbd] bounds)."""
    gpu_log, gpu_mot = _tbd_app_run(card)
    cpu_log, cpu_mot = _tbd_app_run("cpu")
    assert gpu_mot == cpu_mot
    for (gi, gb), (ci, cb) in zip(gpu_log, cpu_log):
        assert gi == ci
        assert gb.shape == cb.shape and (gb.size == 0 or np.abs(gb - cb).max() <= 1e-3)


def _bar_image(rng, h=480, w=640):
    img = rng.uniform(0, 40, (h, w)).astype(np.float32)
    for x, y in ((40, 20), (232, 20), (352, 300)):
        img[y + 20: y + 110, x + 26: x + 38] += 160.0
    return img


@pytest.mark.cuda
def test_hog_on_card_equals_cpu(card):
    """Score maps within 1e-3 (atan2 and cuDNN's summation order differ
    from the CPU's in the last ulps); detectMultiScale at the reference's
    defaults: the same boxes, scores within 1e-3."""
    from opencv_tpu_torch.ops import hog

    rng = np.random.default_rng(21)
    img = torch.from_numpy(_bar_image(rng))
    w = torch.from_numpy(rng.normal(0, 0.05, 3780).astype(np.float32))
    sc = hog.score_map(img, w, 0.1)
    sg = hog.score_map(img.to(card), w.to(card), 0.1)
    assert float((sg.cpu() - sc).abs().max()) <= 1e-3
    dc = hog.detect_multi_scale(img, w, 0.0, n_scales=64)
    dg = hog.detect_multi_scale(img.to(card), w.to(card), 0.0, n_scales=64)
    assert torch.equal(dg.valid.cpu(), dc.valid)
    assert torch.equal(dg.boxes.cpu()[dc.valid], dc.boxes[dc.valid])
    assert float((dg.scores.cpu() - dc.scores)[dc.valid].abs().max()) <= 1e-3


def _lane_image(rng, h=480, w=640):
    img = rng.uniform(20, 60, (h, w)).astype(np.float32)
    for x0, y0, x1, y1 in ((160, 460, 300, 240), (520, 460, 360, 240)):
        t = np.linspace(0, 1, 2 * max(abs(x1 - x0), abs(y1 - y0)) + 1)
        xs = np.round(x0 + t * (x1 - x0)).astype(int)
        ys = np.round(y0 + t * (y1 - y0)).astype(int)
        img[ys, xs] = img[ys, xs + 1] = 220.0
    return img


@pytest.mark.cuda
def test_canny_and_hough_segments_on_card_equal_cpu(card):
    """Canny masks and Hough accumulators equal (the transcendentals are
    taken in f64), segments within 0.5 px (chip_smoke's [lane] bound)."""
    from opencv_tpu_torch.core import imgproc
    from opencv_tpu_torch.ops import edges, hough

    rng = np.random.default_rng(22)
    img = torch.from_numpy(_lane_image(rng))
    for lo, hi in ((60, 120), (10, 30)):
        ec = edges.canny(imgproc.gaussian_blur(img, 5, 1.5), lo, hi)
        eg = edges.canny(imgproc.gaussian_blur(img.to(card), 5, 1.5), lo, hi)
        assert torch.equal(eg.cpu(), ec)
    assert torch.equal(hough.hough_lines_accumulator(eg)[0].cpu(), hough.hough_lines_accumulator(ec)[0])
    kw = dict(threshold=30.0, min_line_length=120, max_line_gap=5, max_lines=16)
    sc = hough.hough_segments(ec, **kw)
    sg = hough.hough_segments(eg, **kw)
    assert torch.equal(sg.valid.cpu(), sc.valid) and bool(sc.valid.any())
    assert float((sg.xyxy.cpu() - sc.xyxy)[sc.valid].abs().max()) <= 0.5


@pytest.mark.cuda
def test_hough_circles_and_generalized_on_card_equal_cpu(card):
    from opencv_tpu_torch.ops import hough

    h, w = 128, 160
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.full((h, w), 30.0, np.float32)
    for cx, cy, r in ((40, 40, 12), (110, 70, 18), (60, 100, 9)):
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 200.0
    img = torch.from_numpy(img)
    kw = dict(min_radius=6, max_radius=24, acc_threshold=12.0, min_dist=12, max_circles=8)
    cc, cg = hough.hough_circles(img, **kw), hough.hough_circles(img.to(card), **kw)
    for name in ("xyr", "votes", "valid"):
        assert torch.equal(getattr(cg, name).cpu(), getattr(cc, name)), name
    t = torch.full((40, 40), 20.0)
    t[8:32, 8:14] = 220.0
    t[26:32, 8:30] = 220.0
    scene = torch.full((120, 150), 20.0)
    scene[40:80, 60:100] = torch.rot90(t)
    angles = (0.0, np.pi / 2, np.pi, 3 * np.pi / 2)
    dc = hough.generalized_hough(scene, hough.build_r_table(t, n_bins=24, cap=48),
                                 vote_threshold=40.0, max_detections=4, angles=angles)
    dg = hough.generalized_hough(scene.to(card), hough.build_r_table(t.to(card), n_bins=24, cap=48),
                                 vote_threshold=40.0, max_detections=4, angles=angles)
    for name in ("xy", "votes", "angle", "scale", "valid"):
        assert torch.equal(getattr(dg, name).cpu(), getattr(dc, name)), name


@pytest.mark.cuda
def test_detection_based_tracker_on_card_equals_cpu(card):
    """A textured square through the detect-every-4th-frame tracker at
    480x640 (level 0 goes through K4): boxes within 0.05 px (the LK rule)."""
    from opencv_tpu_torch.tbd import DetectionBasedTracker

    rng = np.random.default_rng(23)
    tex = rng.uniform(100, 255, (40, 40)).astype(np.float32)

    def frame(t):
        img = np.full((480, 640), 60.0, np.float32)
        x, y = 100 + 3 * t, 200 + 2 * t
        img[y:y + 40, x:x + 40] = tex
        return img

    def detector(img):
        ys, xs = np.where(np.asarray(img) > 90)
        return np.array([[xs.min(), ys.min(), xs.max() - xs.min(), ys.max() - ys.min()]], np.float32)

    dc = DetectionBasedTracker(detector, device="cpu")
    dg = DetectionBasedTracker(detector, device=card)
    cuda_ops.reset_launch_counts()
    for t in range(8):
        tc, tg = dc.process_frame(frame(t)), dg.process_frame(frame(t))
        assert [x.track_id for x in tg] == [x.track_id for x in tc]
        for a, b in zip(dc.tracker.tracks, dg.tracker.tracks):
            assert np.abs(a.bbox - b.bbox).max() <= 0.05
    assert cuda_ops.launch_counts["lk_sample"] > 0


# ------------------------------------------ calibration app, video stabilization


@pytest.mark.cuda
def test_imgproc_on_card_equals_cpu(card):
    """Elementwise f32 arithmetic in the same order: the card's bits are the
    CPU's; the polar warps within 1e-2, their tolerance against JAX (the
    card's f64 sin, cos and atan2 may differ from the CPU's in the last
    f64 bit, which can round an f32 coordinate the other way: an ulp of a
    coordinate moves a sample of this noise image by up to ~1e-2)."""
    from opencv_tpu_torch.core import imgproc

    rng = np.random.default_rng(31)
    img = torch.from_numpy(np.round(rng.uniform(0, 255, (480, 640))).astype(np.float32))
    rgb = torch.from_numpy(rng.uniform(0, 255, (48, 64, 3)).astype(np.float32))
    g = img.to(card)
    m = torch.tensor([[1.02, 0.03, 2.5], [-0.02, 0.98, 1.5]])
    hm = torch.tensor([[1.02, 0.03, 2.5], [-0.02, 0.98, 1.5], [1e-4, -2e-4, 1.0]])
    pairs = [(imgproc.to_gray(rgb.to(card)), imgproc.to_gray(rgb)),
             (imgproc.otsu_threshold(g), imgproc.otsu_threshold(img)),
             (imgproc.integral(g), imgproc.integral(img)),
             (imgproc.warp_affine(g, m, 480, 640), imgproc.warp_affine(img, m, 480, 640)),
             (imgproc.warp_perspective(g, hm, 480, 640), imgproc.warp_perspective(img, hm, 480, 640))]
    pairs += [(imgproc.threshold(g, 100.0, 200.0, k), imgproc.threshold(img, 100.0, 200.0, k))
              for k in ("binary", "binary_inv", "trunc", "tozero", "tozero_inv")]
    for got, want in pairs:
        assert torch.equal(got.cpu(), want)
    for log in (False, True):
        for inverse in (False, True):
            got = imgproc.warp_polar(g, (360, 240), (320.0, 240.0), 230.0, log, inverse)
            want = imgproc.warp_polar(img, (360, 240), (320.0, 240.0), 230.0, log, inverse)
            assert float((got.cpu() - want).abs().max()) <= 1e-2


def _circles_view(step=110, r=27, h=480, w=640):
    """A 5x4 grid of dark disks (30) on 220 at step 110 px, centred: the
    calibration app's circles view."""
    img = np.full((h, w), 220.0, np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    x0, y0 = (w - 4 * step) // 2, (h - 3 * step) // 2
    for i in range(4):
        for j in range(5):
            img[(yy - (y0 + i * step)) ** 2 + (xx - (x0 + j * step)) ** 2 <= r * r] = 30.0
    return img


@pytest.mark.cuda
def test_ccomp_and_circles_grid_on_card_equal_cpu(card):
    from opencv_tpu_torch.ops import ccomp, chessboard

    rng = np.random.default_rng(32)
    mask = torch.from_numpy(rng.random((480, 640)) > 0.55)
    for conn in (4, 8):
        got = ccomp.connected_components_stats(mask.to(card), conn)
        want = ccomp.connected_components_stats(mask, conn)
        assert torch.equal(got.labels.cpu(), want.labels)
        assert (got.sweeps, got.host_reads) == (want.sweeps, want.host_reads)
    img = _circles_view()
    bg, bc = ccomp.detect_blobs(img, device=card), ccomp.detect_blobs(img, device="cpu")
    for name in ("xy", "area", "circularity", "valid"):
        assert torch.equal(getattr(bg, name).cpu(), getattr(bc, name)), name
    (pg, okg), (pc, okc) = (chessboard.find_circles_grid(img, (5, 4), device=d) for d in (card, "cpu"))
    assert okg and okc
    np.testing.assert_array_equal(pg, pc)


def _board_view(rvec, tvec, dev):
    """examples/calibration_app.py's 7x5 board at a pose, through the
    port's warp_perspective, 480x640."""
    from opencv_tpu_torch.core import imgproc
    from opencv_tpu_torch.geometry.rotation import rodrigues

    sq, cols, rows = 40, 7, 5
    bw, bh = (cols + 1) * sq, (rows + 1) * sq
    board = np.full((bh + 2 * sq, bw + 2 * sq), 210.0, np.float32)
    for i in range(rows + 1):
        for j in range(cols + 1):
            if (i + j) % 2 == 0:
                board[sq * (i + 1):sq * (i + 2), sq * (j + 1):sq * (j + 2)] = 30.0
    K = np.array([[520.0, 0, 326.0], [0, 525.2, 236.0], [0, 0, 1]])
    R = rodrigues(torch.tensor(rvec, dtype=torch.float32)).numpy().astype(np.float64)
    s = 0.1 / sq
    T = np.array([[s, 0, -(bw / 2 + sq) * s], [0, s, -(bh / 2 + sq) * s], [0, 0, 1]])
    hom = K @ np.column_stack([R[:, 0], R[:, 1], tvec]) @ T
    return imgproc.warp_perspective(torch.from_numpy(board).to(dev),
                                    np.linalg.inv(hom).astype(np.float32), 480, 640)


@pytest.mark.cuda
def test_chessboard_on_card_equals_cpu(card):
    """Detected corners within 1e-3 px of the CPU's."""
    from opencv_tpu_torch.ops import chessboard

    for rvec, tvec in (([0.25, -0.30, 0.10], [-0.20, -0.10, 2.6]),
                       ([-0.30, 0.25, -0.05], [0.15, 0.05, 2.4])):
        img = _board_view(rvec, tvec, card)
        assert torch.equal(img.cpu(), _board_view(rvec, tvec, "cpu"))
        got = chessboard.find_chessboard_corners(img, (7, 5), device=card)
        want = chessboard.find_chessboard_corners(img.cpu(), (7, 5), device="cpu")
        assert got is not None and want is not None
        assert np.abs(got - want).max() <= 1e-3


def _stab_pair(dev, angle=0.01, h=480, w=640):
    """A blurred noise texture and its copy moved by (1.7, -0.9) px and
    rotated by `angle` rad, 480x640."""
    from opencv_tpu_torch.core import imgproc

    rng = np.random.default_rng(33)
    big = torch.from_numpy(rng.uniform(0, 255, (h + 40, w + 40)).astype(np.float32)).to(dev)
    big = imgproc.gaussian_blur(big, 7, 2.0)
    c, s = np.cos(angle), np.sin(angle)
    f0 = imgproc.warp_affine(big, [[1.0, 0.0, 20.0], [0.0, 1.0, 20.0]], h, w)
    f1 = imgproc.warp_affine(big, [[c, -s, 21.7], [s, c, 19.1]], h, w)
    return f0, f1


@pytest.mark.cuda
def test_ecc_on_card_equals_cpu(card):
    from opencv_tpu_torch.ops import ecc

    for motion, angle in (("translation", 0.0), ("euclidean", 0.01), ("affine", 0.01)):
        (f0g, f1g), (f0c, f1c) = _stab_pair(card, angle), _stab_pair("cpu", angle)
        wg, rg = ecc.find_transform_ecc(f0g, f1g, motion, device=card)
        wc, rc = ecc.find_transform_ecc(f0c, f1c, motion, device="cpu")
        assert float((wg.cpu() - wc).abs().max()) <= 1e-4
        assert abs(float(rg) - float(rc)) <= 1e-5 and float(rg) > 0.98


@pytest.mark.cuda
def test_videostab_on_card_equals_cpu(card):
    """One 480x640 pair (K4 at level 0, 3 launches): the same seed draws the
    same RANSAC subsets on both devices; the motions agree within 0.05 px
    at the frame's corners. Deblurring and wobble suppression within their
    FFTs' rounding."""
    from opencv_tpu_torch.ops import videostab

    (f0g, f1g), (f0c, f1c) = _stab_pair(card), _stab_pair("cpu")
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    cuda_ops.reset_launch_counts()
    mg = videostab.estimate_global_motion(f0g, f1g, gens[0], device=card).cpu().double()
    torch.cuda.synchronize()
    assert cuda_ops.launch_counts["lk_sample"] == 3
    mc = videostab.estimate_global_motion(f0c, f1c, gens[1], device="cpu").double()
    corners = torch.tensor([[0, 0, 1], [639, 0, 1], [0, 479, 1], [639, 479, 1]], dtype=torch.float64)
    assert float((corners @ mg.T - corners @ mc.T).abs().max()) <= 0.05
    dg = videostab.deblur_weiner_gaussian(f0g, 5.0, 0.3, device=card)
    dc = videostab.deblur_weiner_gaussian(f0c, 5.0, 0.3, device="cpu")
    assert float((dg.cpu() - dc).abs().max()) <= 1e-2
    t = np.arange(40)
    motions = np.zeros((40, 2, 3), np.float32)
    motions[:, 0, 2] = 0.5 * np.sin(t / 15.0) + 0.3 * (-1.0) ** t
    motions[:, 1, 2] = 0.02 * t
    np.testing.assert_allclose(videostab.suppress_wobble(motions, device=card),
                               videostab.suppress_wobble(motions, device="cpu"), rtol=0, atol=1e-5)


# ------------------------------------------------ panorama, QR, segmentation


def _texture(rng, h, w):
    from opencv_tpu_torch.core import imgproc

    return imgproc.gaussian_blur(torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32)), 5, 1.2)


@pytest.mark.cuda
def test_morphology_on_card_equals_cpu(card):
    """Pooling, shifted minima and maxima, sorts: equal bits; the bilateral
    filter within 1e-4 (the card's exp may differ by an ulp)."""
    from opencv_tpu_torch.ops import morphology

    rng = np.random.default_rng(41)
    img = torch.from_numpy(rng.uniform(0, 255, (120, 160)).astype(np.float32))
    g = img.to(card)
    cross = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)
    for op in ("erode", "dilate", "morphology_open", "morphology_close", "morphology_gradient",
               "top_hat", "black_hat"):
        for k in (3, 4, (2, 5)):
            assert torch.equal(getattr(morphology, op)(g, k).cpu(), getattr(morphology, op)(img, k))
    for op in ("erode", "dilate"):
        assert torch.equal(getattr(morphology, op)(g, kernel=cross).cpu(),
                           getattr(morphology, op)(img, kernel=cross))
    assert torch.equal(morphology.median_blur(g, 5).cpu(), morphology.median_blur(img, 5))
    got = morphology.bilateral_filter(g, 9, 30.0, 3.0).cpu()
    assert float((got - morphology.bilateral_filter(img, 9, 30.0, 3.0)).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_warps_blends_and_exposure_on_card_equal_cpu(card):
    """Warps within 1e-2 (f32 trig); distance weights and seams equal;
    blends within 1e-4; gains within 1e-5 relative (matmul sums)."""
    from opencv_tpu_torch.stitching import blend, exposure, global_stitch, warpers

    rng = np.random.default_rng(42)
    a, b = _texture(rng, 90, 120), _texture(rng, 90, 120) + 20.0
    for fn in (warpers.warp_cylindrical, warpers.warp_spherical):
        assert float((fn(a.to(card), 150.0).cpu() - fn(a, 150.0)).abs().max()) <= 1e-2
    ma = torch.zeros((90, 120), dtype=torch.bool)
    mb = torch.zeros((90, 120), dtype=torch.bool)
    ma[:, :70] = True
    mb[4:, 50:] = True
    assert torch.equal(blend.distance_weight(ma.to(card)).cpu(), blend.distance_weight(ma))
    args = ([a, b], [ma, mb])
    dev_args = ([a.to(card), b.to(card)], [ma.to(card), mb.to(card)])
    assert float((blend.feather_blend(*dev_args).cpu() - blend.feather_blend(*args)).abs().max()) <= 1e-4
    assert float((blend.multiband_blend(*dev_args, 3).cpu()
                  - blend.multiband_blend(*args, 3)).abs().max()) <= 1e-4
    _, gg = exposure.gain_compensate(*dev_args)
    _, gc = exposure.gain_compensate(*args)
    assert torch.allclose(gg.cpu(), gc, rtol=1e-5, atol=0)
    _, mg = exposure.block_gain_compensate(*dev_args, block=16)
    _, mc = exposure.block_gain_compensate(*args, block=16)
    assert torch.allclose(mg.cpu(), mc, rtol=1e-5, atol=1e-6)
    cost = torch.where(ma & mb, (a - b).abs(), 1e4)
    assert torch.equal(global_stitch.dp_seam(cost.to(card)).cpu(), global_stitch.dp_seam(cost))
    for got, want in zip(global_stitch.seam_masks(a.to(card), ma.to(card), b.to(card), mb.to(card)),
                         global_stitch.seam_masks(a, ma, b, mb)):
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_stitch_pair_on_card_equals_cpu(card):
    """ORB (K1) and matching are exact; the same seed draws the same RANSAC
    subsets; the DLT solve may differ in ulps: >= 99 % of the composite
    within 0.5 grey levels, K1 launched once per image."""
    from opencv_tpu_torch.stitching import stitcher

    scene = _texture(np.random.default_rng(1234), 240, 400)
    img0, img1 = scene[:, :300], scene[:, 100:]
    cuda_ops.reset_launch_counts()
    got = stitcher.stitch_pair(img0, img1, n_features=1000, device=card)
    assert cuda_ops.launch_counts["fast_corners"] == 2
    want = stitcher.stitch_pair(img0, img1, n_features=1000, device="cpu")
    assert got.shape == want.shape
    assert (np.abs(got - want) <= 0.5).mean() >= 0.99


@pytest.mark.cuda
def test_qr_on_card_equals_cpu(card):
    """Integer box sums and one division: the scores, quads and texts are
    the CPU's."""
    from opencv_tpu_torch.ops import qrcode

    rng = np.random.default_rng(43)
    for version, text in ((1, "HELLO-TPU"), (3, "the quick brown fox jumps over the lazy dog 01234")):
        img = qrcode.render_qr(qrcode.encode_qr(text, version), 5)
        scene = np.full((480, 640), 190.0, np.float32)
        scene[100:100 + img.shape[0], 150:150 + img.shape[1]] = img
        scene += rng.normal(0, 6.0, scene.shape).astype(np.float32)
        sg, sc = qrcode.finder_scores(torch.from_numpy(scene).to(card), (2, 4, 5, 12))
        sgc, scc = qrcode.finder_scores(torch.from_numpy(scene), (2, 4, 5, 12))
        assert torch.equal(sg.cpu(), sgc) and torch.equal(sc.cpu(), scc)
        quad, ok = qrcode.detect_qr(scene, device=card)
        cquad, cok = qrcode.detect_qr(scene, device="cpu")
        assert ok and cok and np.array_equal(quad, cquad)
        assert qrcode.decode_qr(scene, quad, device=card) == qrcode.decode_qr(scene, quad, device="cpu") == text


@pytest.mark.cuda
@pytest.mark.parametrize("k,max_sweeps", [(4, 4096), (8, 4096), (8, 40)])
def test_min_cut_on_card_equals_cpu(card, k, max_sweeps):
    """The card replays a CUDA graph of 16 sweeps after the first 16; f32
    adds, minima and comparisons: labels and sweep counts equal, also at a
    cap that is not a multiple of 16."""
    from opencv_tpu_torch.ops import graphcut

    rng = np.random.default_rng(44)
    h, w = 60, 80
    yy, xx = np.mgrid[0:h, 0:w]
    disc = (yy - 30) ** 2 + (xx - 40) ** 2 < 400
    src = torch.from_numpy((rng.uniform(0, 4, (h, w)) + 6 * disc).astype(np.float32))
    snk = torch.from_numpy((rng.uniform(0, 4, (h, w)) + 6 * ~disc).astype(np.float32))
    caps = torch.from_numpy(rng.uniform(0.5, 3.0, (k, h, w)).astype(np.float32))
    got = graphcut.min_cut_grid_stats(src.to(card), snk.to(card), caps.to(card), max_sweeps)
    want = graphcut.min_cut_grid_stats(src, snk, caps, max_sweeps)
    assert torch.equal(got.labels.cpu(), want.labels)
    assert (got.sweeps, got.capped) == (want.sweeps, want.capped)


@pytest.mark.cuda
def test_grab_cut_and_watershed_on_card_equal_cpu(card):
    """GrabCut: the moments and 3x3 inverses are library sums: >= 99.9 % of
    the mask equal. Watershed: labels and sweeps equal."""
    from opencv_tpu_torch.ops import grabcut, watershed

    rng = np.random.default_rng(0)
    h, w = 70, 90
    img = np.zeros((h, w, 3), np.float32)
    img[..., 1] = 120
    yy, xx = np.mgrid[0:h, 0:w]
    img[((xx - 45) ** 2 / 400 + (yy - 35) ** 2 / 250) < 1] = [40, 40, 200]
    img = np.clip(img + rng.normal(0, 6.0, img.shape).astype(np.float32), 0, 255)
    got = grabcut.grab_cut_stats(img, rect=(18, 10, 58, 52), iter_count=2, device=card)
    want = grabcut.grab_cut_stats(img, rect=(18, 10, 58, 52), iter_count=2, device="cpu")
    assert float((got.mask.cpu() == want.mask).float().mean()) >= 0.999
    surface = (100 - 80 * np.exp(-((xx - 25) ** 2) / 200) - 80 * np.exp(-((xx - 65) ** 2) / 200))
    markers = np.zeros((h, w), np.int32)
    markers[30:34, 20:28] = 1
    markers[30:34, 60:68] = 2
    for im in (surface.astype(np.float32), img):
        wg = watershed.watershed_stats(im, markers, device=card)
        wc = watershed.watershed_stats(im, markers, device="cpu")
        assert torch.equal(wg.labels.cpu(), wc.labels) and wg.sweeps == wc.sweeps


@pytest.mark.cuda
def test_camshift_on_card_equals_cpu(card):
    """Integer histogram counts and XLA-order prefix sums: histograms,
    back-projections, mean-shift windows and CamShift boxes equal."""
    from opencv_tpu_torch.ops import camshift

    rng = np.random.default_rng(45)
    h, w = 480, 640
    yy, xx = np.mgrid[0:h, 0:w]
    frame = np.where((xx - 300) ** 2 + (yy - 200) ** 2 < 56 ** 2, 210.0,
                     rng.uniform(20, 60, (h, w))).astype(np.float32)
    f = torch.from_numpy(frame)
    hist = camshift.calc_hist([f[150:250, 250:350]], [32], [(0, 256)], density=True) * 255.0
    hg = camshift.calc_hist([f.to(card)[150:250, 250:350]], [32], [(0, 256)], density=True) * 255.0
    assert torch.equal(hg.cpu(), hist)
    pc = camshift.calc_back_project([f], hist, [(0, 256)])
    pg = camshift.calc_back_project([f.to(card)], hg, [(0, 256)])
    assert torch.equal(pg.cpu(), pc)
    for win in ((240, 150, 120, 120), (10, 10, 100, 100), (400, 300, 200, 150)):
        assert camshift.mean_shift(pg, win) == camshift.mean_shift(pc, win)
        (cg, sg, ag), wg = camshift.cam_shift(pg, win)
        (cc, sc, ac), wc = camshift.cam_shift(pc, win)
        assert wg == wc and (*cg, *sg, ag) == (*cc, *sc, ac)


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [1, 3, 7])
def test_nms_2d_on_card_equals_cpu(card, radius):
    """The pooled NMS: integer ties, ±inf and NaN give the CPU's mask."""
    from opencv_tpu_torch.core import imgproc

    rng = np.random.default_rng(46)
    s = rng.integers(0, 4, (480, 640)).astype(np.float32)
    flat = s.reshape(-1)
    flat[rng.random(flat.shape) < 0.05] = -np.inf
    flat[rng.random(flat.shape) < 0.02] = np.inf
    flat[rng.random(flat.shape) < 0.02] = np.nan
    t = torch.from_numpy(s)
    assert torch.equal(imgproc.nms_2d(t.to(card), radius).cpu(), imgproc.nms_2d(t, radius))


@pytest.mark.cuda
def test_fast_score_kernel_at_brisk_levels_equals_plain(card):
    """K2 on BRISK's four sqrt(2) levels of a 480x640 frame (AGAST 9_16)."""
    from opencv_tpu_torch.core import pyramid

    rng = np.random.default_rng(47)
    img = torch.from_numpy(_img(rng, 480, 640)).to(card)
    for lvl in pyramid.build_pyramid(img, 4, 2 ** 0.5).levels:
        for ring, arc in ((16, 9), (12, 7), (8, 5)):
            assert torch.equal(fast_kernel.fast_score_cuda(lvl, arc, ring),
                               fast_kernel.fast_score_plain(lvl, arc, ring))


def _scene(rng, h=96, w=128):
    from opencv_tpu_torch.core import imgproc

    img = torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32))
    img = imgproc.gaussian_blur(img, 5, 1.5) * 0.6 + 50.0
    img[10:30, 12:40] = 220.0
    img[50:80, 60:100] = 30.0
    return torch.round(img)


@pytest.mark.cuda
def test_agast_and_brisk_on_card_equal_cpu(card):
    """Scores are exact; keypoints equal slot for slot; descriptors equal
    but for near ties of the pattern samples (<= 0.5 % of the bits)."""
    from opencv_tpu_torch.ops import agast, brisk

    img = _scene(np.random.default_rng(48))
    for kind in agast.KINDS:
        assert torch.equal(agast.agast_score(img.to(card), kind).cpu(), agast.agast_score(img, kind))
    cuda_ops.reset_launch_counts()
    kc, dc = brisk.brisk_detect_and_compute(img, 128, 20.0, device=card)
    assert cuda_ops.launch_counts["fast_score"] == 4
    kp, dp = brisk.brisk_detect_and_compute(img, 128, 20.0, device="cpu")
    assert torch.equal(kc.valid.cpu(), kp.valid) and torch.equal(kc.xy.cpu(), kp.xy)
    v = kp.valid
    assert int(v.sum()) > 20
    assert float((unpack_bits(dc.cpu()) != unpack_bits(dp))[v].float().mean()) <= 0.005


@pytest.mark.cuda
def test_akaze_on_card_equals_cpu(card):
    """k, the scale space and the responses are equal bits (separable sums
    in one order, device-tensor divisors, k's quantile as separate products
    and a sum); keypoints equal slot for slot; descriptors equal but for
    near ties of the cell means (<= 0.5 % of the bits)."""
    from opencv_tpu_torch.ops import akaze

    img = _scene(np.random.default_rng(51))
    gray = lambda x: x / torch.tensor(255.0, device=x.device)
    assert torch.equal(akaze.contrast_k(gray(img.to(card))).cpu(), akaze.contrast_k(gray(img)))
    sc, sig = akaze.nonlinear_scale_space(img.to(card), n_levels=6)
    sp, _ = akaze.nonlinear_scale_space(img, n_levels=6)
    assert torch.equal(sc.cpu(), sp)
    assert torch.equal(akaze.hessian_response(sc, sig).cpu(), akaze.hessian_response(sp, sig))
    kc, dc = akaze.akaze_detect_and_compute(img, 96, threshold=1e-4, n_levels=6, device=card)
    kp, dp = akaze.akaze_detect_and_compute(img, 96, threshold=1e-4, n_levels=6, device="cpu")
    assert torch.equal(kc.valid.cpu(), kp.valid) and torch.equal(kc.xy.cpu(), kp.xy)
    assert torch.equal(kc.level.cpu(), kp.level)
    v = kp.valid
    assert int(v.sum()) > 20
    assert float((unpack_bits(dc.cpu()) != unpack_bits(dp))[v].float().mean()) <= 0.005


@pytest.mark.cuda
def test_sgbm_on_card_equals_cpu(card):
    from opencv_tpu_torch.ops import sgbm

    rng = np.random.default_rng(49)
    right = rng.uniform(0, 255, (64, 96)).astype(np.float32)
    left = np.roll(right, 6, axis=1)
    left[20:40, 30:60] = np.roll(right, 11, axis=1)[20:40, 30:60]
    cfg = sgbm.SGBMConfig(num_disparities=16)
    got = sgbm.compute_disparity_sgbm(left, right, cfg, device=card).cpu()
    want = sgbm.compute_disparity_sgbm(left, right, cfg, device="cpu")
    assert float((got == want).float().mean()) >= 0.995
    assert float((got - want).abs().max()) <= 1.0


@pytest.mark.cuda
def test_tvl1_on_card_equals_cpu(card):
    from opencv_tpu_torch.core import imgproc
    from opencv_tpu_torch.ops import tvl1

    rng = np.random.default_rng(50)
    a = imgproc.gaussian_blur(torch.from_numpy(rng.uniform(0, 255, (64, 96)).astype(np.float32)),
                              7, 2.0)
    b = torch.roll(a, (2, 3), dims=(0, 1))
    got = tvl1.calc_optical_flow_tvl1(a, b, n_levels=3, device=card).cpu()
    want = tvl1.calc_optical_flow_tvl1(a, b, n_levels=3, device="cpu")
    d = (got - want).abs()
    assert float(d.mean()) <= 1e-3 and float(d.max()) <= 0.05


def _scene_480(rng):
    img = np.zeros((480, 640), np.float32)
    for _ in range(60):
        y, x = rng.integers(0, 440), rng.integers(0, 600)
        img[y:y + rng.integers(8, 40), x:x + rng.integers(8, 40)] = rng.uniform(60, 250)
    return img


@pytest.mark.cuda
def test_mog2_and_knn_steps_on_card_equal_cpu(card):
    from opencv_tpu_torch.ops import bgsegm

    rng = np.random.default_rng(60)
    bg = _scene_480(rng)
    frames = [np.clip(bg + rng.normal(0, 2, bg.shape), 0, 255).astype(np.float32) for _ in range(6)]
    frames[-1][100:160, 200:260] = 240.0
    mog = {d: bgsegm.init_state(frames[0], device=d) for d in (card, "cpu")}
    knn = {d: bgsegm.knn_init(frames[0], device=d) for d in (card, "cpu")}
    for f in frames[1:]:
        slot = torch.from_numpy(rng.integers(0, 10, f.shape))
        u = torch.from_numpy(rng.random(f.shape, dtype=np.float32))
        masks = {}
        for d in (card, "cpu"):
            mog[d], m1 = bgsegm.apply(mog[d], f, learning_rate=0.05)
            knn[d], m2 = bgsegm.knn_apply(knn[d], f, slot=slot.to(d), uniform=u.to(d))
            masks[d] = (m1.cpu(), m2.cpu())
        assert float((masks[card][0] == masks["cpu"][0]).float().mean()) >= 0.999
        assert torch.equal(masks[card][1], masks["cpu"][1])
    assert int(masks["cpu"][0][100:160, 200:260].sum()) >= 1800  # the new box


@pytest.mark.cuda
def test_clahe_template_phase_distance_on_card_equal_cpu(card):
    from opencv_tpu_torch.core import imgproc
    from opencv_tpu_torch.ops import distance, histogram, phasecorr, template

    rng = np.random.default_rng(61)
    img = _scene_480(rng) + rng.uniform(0, 20, (480, 640)).astype(np.float32)
    assert torch.equal(histogram.clahe(img, device=card).cpu(), histogram.clahe(img, device="cpu"))
    tmpl = img[200:264, 300:364]
    for m in template.METHODS:
        got = template.match_template(img, tmpl, m, device=card).cpu()
        want = template.match_template(img, tmpl, m, device="cpu")
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()) + 1e-4
    smooth = imgproc.gaussian_blur(torch.from_numpy(img), 7, 2.0)
    moved = torch.roll(smooth, (3, -5), (0, 1))
    win = phasecorr.create_hanning_window(480, 640, device="cpu")
    (gx, gy), gr = phasecorr.phase_correlate(smooth, moved, win, device=card)
    (cx, cy), cr = phasecorr.phase_correlate(smooth, moved, win, device="cpu")
    assert abs(float(gx) - float(cx)) < 1e-3 and abs(float(gy) - float(cy)) < 1e-3
    assert abs(float(gx) + 5) < 0.1 and abs(float(gy) - 3) < 0.1
    mask = img > 100
    assert torch.equal(distance.distance_transform(mask, device=card).cpu(),
                       distance.distance_transform(mask, device="cpu"))


@pytest.mark.cuda
def test_nl_means_and_telea_on_card_equal_cpu(card):
    from opencv_tpu_torch.ops import photo

    rng = np.random.default_rng(62)
    img = _scene_480(rng)
    noisy = (img + rng.normal(0, 10, img.shape)).astype(np.float32)
    crop = np.ascontiguousarray(noisy[:120, :160])
    d = (photo.nl_means_denoise(crop, device=card).cpu() - photo.nl_means_denoise(crop, device="cpu")).abs()
    assert float(d.mean()) <= 1e-3 and float(d.max()) <= 1e-2
    full = photo.nl_means_denoise(noisy, device=card)
    assert full.shape == (480, 640) and bool(torch.isfinite(full).all())
    hole = np.zeros(img.shape, bool)
    hole[200:240, 300:360] = True
    holed = np.where(hole, 0.0, img).astype(np.float32)
    d = (photo.inpaint_telea(holed, hole, device=card).cpu()
         - photo.inpaint_telea(holed, hole, device="cpu")).abs()
    assert float(d.mean()) <= 1e-3 and float(d.max()) <= 1e-2


def _ring(rng, size=16):
    """tests/test_traincascade.py's object (that file imports jax)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cy, cx = size / 2 - 0.5 + rng.uniform(-1, 1), size / 2 - 0.5 + rng.uniform(-1, 1)
    ring = np.exp(-((np.hypot(yy - cy, xx - cx) - 4.5) ** 2) / 3.0)
    return np.round(np.clip(40 + 170 * ring + rng.normal(0, 8, (size, size)), 0, 255)).astype(np.float32)


def _blocks(rng, h=80, w=80):
    img = np.kron(rng.uniform(20, 200, (h // 8, w // 8)).astype(np.float32), np.ones((8, 8), np.float32))
    return np.round(np.clip(img + rng.normal(0, 12, (h, w)), 0, 255)).astype(np.float32)


def _cascade_data(seed=0, n_pos=150, n_bg=15):
    rng = np.random.default_rng(seed)
    return np.stack([_ring(rng) for _ in range(n_pos)]), [_blocks(rng) for _ in range(n_bg)]


@pytest.mark.cuda
def test_cascade_trainings_and_detections_on_card_equal_cpu(card):
    """The trainer on the card gives the CPU's models (Haar and LBP, 3
    stages x <= 6 weak at 16x16), and the detectors' raw hits and grouped
    boxes on a 240x320 scene equal the CPU's."""
    from opencv_tpu_torch.ml import traincascade
    from opencv_tpu_torch.ops import cascade

    pos, negs = _cascade_data()
    kw = dict(window=(16, 16), n_stages=3, max_weak_per_stage=6, n_neg_per_stage=300, seed=1)
    rng = np.random.default_rng(2)
    scene = _blocks(rng, 240, 320)
    scene[50:66, 80:96] = _ring(rng)
    scene[120:152, 200:232] = np.kron(_ring(rng), np.ones((2, 2), np.float32))
    for train, raw, detect in ((traincascade.train_cascade, cascade.raw_hits, cascade.detect_multi_scale),
                               (traincascade.train_cascade_lbp, cascade.raw_hits_lbp,
                                cascade.detect_multi_scale_lbp)):
        m_card, m_cpu = train(pos, negs, device=card, **kw), train(pos, negs, device="cpu", **kw)
        for f in m_cpu._fields[1:]:
            np.testing.assert_array_equal(getattr(m_card, f), getattr(m_cpu, f), err_msg=f)
        hits = raw(torch.from_numpy(scene).to(card), m_cpu)
        assert hits and hits == raw(torch.from_numpy(scene), m_cpu)
        for a, b in zip(detect(torch.from_numpy(scene).to(card), m_cpu), detect(torch.from_numpy(scene), m_cpu)):
            np.testing.assert_array_equal(a, b)


_DNN_CFG = """
[net]
width=64
height=64
channels=3

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=leaky

[maxpool]
size=2
stride=1

[convolutional]
filters=27
size=1
stride=1
pad=1
activation=linear

[region]
anchors = 1.0,1.5, 2.0,2.0, 3.5,2.5
classes=4
num=3
softmax=1
thresh=0.2
"""


@pytest.mark.cuda
def test_dnn_on_card_equals_cpu(card):
    """tests/fixtures/tiny_cnn.onnx on the card within 1e-5 of its expected
    output, and a small Darknet region net (BN, leaky, strided conv,
    2/1 max pool, region decode) within rtol 1e-4 of the CPU's, TF32 off."""
    import os
    import struct

    from opencv_tpu_torch.device import no_tf32
    from opencv_tpu_torch.dnn import load_darknet, load_onnx

    fix = os.path.join(os.path.dirname(__file__), "fixtures")
    x = np.load(os.path.join(fix, "tiny_cnn_input.npy"))
    rng = np.random.default_rng(0)
    arrs = []
    for cout, cin, k, bn in ((16, 3, 3, True), (32, 16, 3, True), (27, 32, 1, False)):
        arrs.append(rng.normal(0, 0.1, cout))
        if bn:
            arrs += [rng.uniform(0.8, 1.2, cout), rng.normal(0, 0.05, cout), rng.uniform(0.8, 1.2, cout)]
        arrs.append(rng.normal(0, np.sqrt(2.0 / (cin * k * k)), (cout, cin, k, k)))
    weights = struct.pack("<3i", 0, 2, 0) + struct.pack("<q", 0) + b"".join(
        np.asarray(a, np.float32).tobytes() for a in arrs)
    img = rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    with no_tf32():
        net = load_onnx(os.path.join(fix, "tiny_cnn.onnx"), device=card)
        net.set_input(x, "input")
        got = net.forward("out").cpu().numpy()
        assert np.abs(got - np.load(os.path.join(fix, "tiny_cnn_expected.npy"))).max() < 1e-5
        outs = []
        for dev in (card, "cpu"):
            dn = load_darknet(_DNN_CFG, weights, device=dev)
            dn.set_input(img)
            outs.append(dn.forward().cpu().numpy())
    np.testing.assert_allclose(outs[0][..., :5], outs[1][..., :5], rtol=1e-4, atol=1e-5)


def _scaled_err(got, want) -> float:
    """Largest |got - want| over want's largest magnitude, in f64 on the CPU."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


_WIDE_CFG = """
[net]
width=40
height=40
channels=64

[convolutional]
filters=64
size=3
stride=1
pad=1
activation=linear
"""


@pytest.mark.cuda
def test_convolutions_hold_to_cpu_under_torch_default_tf32(card):
    """Both switches at torch's defaults (cuDNN TF32 on, matmul TF32 off):
    dnn's convolution layer and forward (a 64-channel Darknet layer, the
    tiny_cnn ONNX fixture and a Darknet region net), HOG's score map and
    match_template still equal the CPU within the bounds of the TF32-off
    tests, because each module turns TF32 off itself (dnn: each
    multiplying layer). The control shows that the switch does bite on
    this card: a bare F.conv2d at these defaults misses the CPU by more
    than 1e-4 of its scale, where dnn's convolution is held to 1e-5.
    match_template is held on a scene with noise and on the same scene
    without it, whose all-zero windows give NaN in the two normed
    methods that take sqrt(window sum of squares) (the integral image's
    difference there is a negative residue, as in the JAX package): the
    NaNs must sit at the same places on both devices."""
    import os
    import struct

    import torch.nn.functional as F

    from opencv_tpu_torch.dnn import layers, load_darknet, load_onnx
    from opencv_tpu_torch.ops import hog, template

    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        rng = np.random.default_rng(5)
        xc = torch.from_numpy(rng.uniform(0, 1, (2, 64, 40, 40)).astype(np.float32))
        wc = torch.from_numpy(rng.normal(0, 0.1, (64, 64, 3, 3)).astype(np.float32))
        assert _scaled_err(F.conv2d(xc.to(card), wc.to(card)), F.conv2d(xc, wc)) > 1e-4
        assert _scaled_err(layers.convolution(xc.to(card), wc.to(card)), layers.convolution(xc, wc)) <= 1e-5
        weights = struct.pack("<3i", 0, 2, 0) + struct.pack("<q", 0) + b"".join(
            np.asarray(a, np.float32).tobytes() for a in (rng.normal(0, 0.1, 64), wc.numpy()))
        outs = []
        for dev in (card, "cpu"):
            wide = load_darknet(_WIDE_CFG, weights, device=dev)
            wide.set_input(xc.numpy())
            outs.append(wide.forward())
        assert _scaled_err(outs[0], outs[1]) <= 1e-5

        fix = os.path.join(os.path.dirname(__file__), "fixtures")
        net = load_onnx(os.path.join(fix, "tiny_cnn.onnx"), device=card)
        net.set_input(np.load(os.path.join(fix, "tiny_cnn_input.npy")), "input")
        got = net.forward("out").cpu().numpy()
        assert np.abs(got - np.load(os.path.join(fix, "tiny_cnn_expected.npy"))).max() < 1e-5
        arrs = []
        for cout, cin, k, bn in ((16, 3, 3, True), (32, 16, 3, True), (27, 32, 1, False)):
            arrs.append(rng.normal(0, 0.1, cout))
            if bn:
                arrs += [rng.uniform(0.8, 1.2, cout), rng.normal(0, 0.05, cout),
                         rng.uniform(0.8, 1.2, cout)]
            arrs.append(rng.normal(0, np.sqrt(2.0 / (cin * k * k)), (cout, cin, k, k)))
        weights = struct.pack("<3i", 0, 2, 0) + struct.pack("<q", 0) + b"".join(
            np.asarray(a, np.float32).tobytes() for a in arrs)
        img = rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
        outs = []
        for dev in (card, "cpu"):
            dn = load_darknet(_DNN_CFG, weights, device=dev)
            dn.set_input(img)
            outs.append(dn.forward().cpu().numpy())
        np.testing.assert_allclose(outs[0][..., :5], outs[1][..., :5], rtol=1e-4, atol=1e-5)

        bars = torch.from_numpy(_bar_image(np.random.default_rng(21)))
        w = torch.from_numpy(np.random.default_rng(22).normal(0, 0.05, 3780).astype(np.float32))
        sc = hog.score_map(bars, w, 0.1)
        assert float((hog.score_map(bars.to(card), w.to(card), 0.1).cpu() - sc).abs().max()) <= 1e-3

        rng = np.random.default_rng(61)
        flat = _scene_480(rng)
        noisy = flat + rng.uniform(0, 20, (480, 640)).astype(np.float32)
        for scene in (noisy, flat):
            tmpl = scene[200:264, 300:364]
            for m in template.METHODS:
                got = template.match_template(scene, tmpl, m, device=card).cpu()
                want = template.match_template(scene, tmpl, m, device="cpu")
                nan = torch.isnan(want)
                assert torch.equal(torch.isnan(got), nan), m
                got, want = got[~nan], want[~nan]
                assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()) + 1e-4, m
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.cuda
def test_dnn_products_hold_to_cpu_with_both_tf32_switches_on(card):
    """Both TF32 switches on, as a caller who wants TF32 everywhere sets
    them: every product of dnn that runs under its own no_tf32 (the
    convolution, fully connected, LSTM and GRU layers, the ONNX MatMul,
    ConvTranspose and linear Resize) is within 1e-5 of its output's
    scale of the CPU, while the same function without its decorator
    (`__wrapped__`) misses by more than 1e-4 on these shapes (large
    enough that cuBLAS and cuDNN take their TF32 kernels)."""
    from opencv_tpu_torch.dnn import layers
    from opencv_tpu_torch.dnn import onnx_importer as oi

    rng = np.random.default_rng(8)

    def t(*shape, s=1.0):
        return torch.from_numpy(rng.normal(0, s, shape).astype(np.float32))

    a, b = t(64, 1024), t(1024, 256)
    cases = {
        "convolution": (layers.convolution, (t(2, 64, 24, 24), t(64, 64, 3, 3, s=0.1))),
        "fully_connected": (layers.fully_connected, (a, b.T.contiguous(), t(256))),
        "lstm": (layers.lstm, (t(4, 64, 256), t(1024, 256, s=0.05), t(1024, 256, s=0.05))),
        "gru": (layers.gru, (t(4, 64, 256), t(768, 256, s=0.05), t(768, 256, s=0.05))),
        "matmul": (oi._matmul, (a, b)),
        "conv_transpose": (oi._conv_transpose, (t(4, 128, 32, 32), t(128, 64, 3, 3, s=0.1), None, (2, 2),
                                                [1, 1, 1, 1], [1, 1], 1)),
        "resize": (oi._resize, (t(2, 8, 96, 96), [1.0, 1.0, 2.0, 2.0], None, "linear", "half_pixel")),
    }

    def run(fn, args, dev):
        out = fn(*[v.to(dev) if isinstance(v, torch.Tensor) else v for v in args])
        return out[0] if isinstance(out, tuple) else out

    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = True, True
    try:
        for name, (fn, args) in cases.items():
            want = run(fn, args, "cpu")
            err = _scaled_err(run(fn, args, card), want)
            bare = _scaled_err(run(fn.__wrapped__, args, card), want)
            assert err <= 1e-5 < 1e-4 < bare, (name, err, bare)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _letters(rng, n=2000, d=16, k=26):
    """Overlapping Gaussian class clusters (chip_smoke's [ml] data, small)."""
    centres = rng.uniform(0, 15, (k, d)).astype(np.float32)
    y = rng.integers(0, k, n)
    x = (centres[y] + rng.normal(0, 2.5, (n, d))).astype(np.float32)
    return x, y


@pytest.mark.cuda
def test_ml_fits_on_card_equal_cpu(card):
    """Every ml model fitted on the card and on the CPU from the same data
    and the same draws: equal labels and predictions; trees, forests and
    boosted trees equal (deterministic in-order histograms, f64-rounded
    transcendental steps); other parameters within 1e-4 of their scale
    (matrix products sum in another order on the card)."""
    from opencv_tpu_torch.ml import classifiers as C
    from opencv_tpu_torch.ml import clustering as CL
    from opencv_tpu_torch.ml import trees as T

    rng = np.random.default_rng(3)
    x_np, y_np = _letters(rng)
    xs = {d: torch.from_numpy(x_np).to(d) for d in (card, "cpu")}
    ys = {d: torch.from_numpy(y_np).to(d) for d in (card, "cpu")}
    yb = {d: (ys[d] == 0).long() for d in ys}

    def both(fn):
        return fn(card), fn("cpu")

    def close(a, b, tol=1e-4):
        a, b = a.cpu().double(), b.double()
        assert float((a - b).abs().max()) <= tol * max(float(b.abs().max()), 1.0)

    picks = CL.kmeans_pp_picks(torch.Generator().manual_seed(0), xs["cpu"], 26)
    g, c = both(lambda d: CL.kmeans(None, xs[d], 26, iters=10, picks=picks))
    assert torch.equal(g.labels.cpu(), c.labels)
    close(g.centers, c.centers)
    g, c = both(lambda d: CL.gmm_em(None, xs[d], 26, iters=10, picks=picks))
    close(g.means, c.means)
    close(g.weights, c.weights)

    g, c = both(lambda d: C.knn_classify(xs[d][:1600], ys[d][:1600], xs[d][1600:], k=10, n_classes=26))
    assert torch.equal(g.cpu(), c)
    g, c = both(lambda d: C.naive_bayes_predict_log_proba(
        C.train_naive_bayes(xs[d][:1600], ys[d][:1600], 26), xs[d][1600:]).argmax(1))
    assert torch.equal(g.cpu(), c)
    init = C.mlp_init_draws(torch.Generator().manual_seed(1), (16, 32, 26))
    g, c = both(lambda d: C.train_mlp(None, xs[d], ys[d], hidden=(32,), n_classes=26, iters=20,
                                      init=init))
    for a, b in zip(g.weights, c.weights):
        close(a, b)

    draws = T.forest_draws(torch.Generator().manual_seed(2), 2000, 16, 4, 0.25)
    g, c = both(lambda d: T.fit_random_forest(None, xs[d], ys[d], n_trees=4, depth=6,
                                              n_classes=26, draws=draws))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(g.trees, c.trees))
    g, c = both(lambda d: T.fit_adaboost(xs[d], yb[d], n_rounds=8, depth=3))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(g.trees, c.trees))
    assert torch.equal(g.alpha.cpu(), c.alpha)
    g, c = both(lambda d: T.fit_gbt(xs[d], yb[d], n_rounds=8, depth=3))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(g.trees, c.trees))

    z = (x_np[:600] - x_np[:600].mean(0)) / x_np[:600].std(0)  # gradient steps want unit scale
    x2 = {d: torch.from_numpy(z.astype(np.float32)).to(d) for d in xs}
    y2 = {d: yb[d][:600] for d in yb}
    g, c = both(lambda d: C.train_linear_svm(x2[d], 2.0 * y2[d] - 1.0, iters=200))
    close(g.w, c.w)
    g, c = both(lambda d: C.train_logistic_regression(x2[d], y2[d], iters=20))
    close(g.w, c.w)
    g, c = both(lambda d: C.train_kernel_svm(x2[d], y2[d], iters=100))
    close(g.alpha, c.alpha)
    idx = C.svmsgd_indices(torch.Generator().manual_seed(4), 600, 2000)
    g, c = both(lambda d: C.train_svmsgd(x2[d], 2 * y2[d] - 1, iters=2000, indices=idx))
    close(g.weights, c.weights)


@pytest.mark.cuda
def test_svmsgd_graph_replays_equal_eager_steps(card, monkeypatch):
    """SVMSGD's CUDA-graph replays run the eager loop's kernels: the same
    weights bit for bit (2 500 steps: two replays of 1 000 and 500 eager)."""
    from opencv_tpu_torch.ml import classifiers as C

    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(500, 16)).astype(np.float32)).to(card)
    y = torch.from_numpy(np.where(rng.random(500) < 0.3, 1, -1)).to(card)
    idx = C.svmsgd_indices(torch.Generator().manual_seed(0), 500, 2500)
    graphed = C.train_svmsgd(x, y, iters=2500, indices=idx)
    monkeypatch.setattr(C, "SGD_GRAPH_STEPS", 10_000)
    eager = C.train_svmsgd(x, y, iters=2500, indices=idx)
    assert torch.equal(graphed.weights, eager.weights) and torch.equal(graphed.shift, eager.shift)
