"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Phases:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: every kernel of csrc/ with nvcc for sm_90a, all in parallel;
  3. kernels vs plain on the card, at the shapes the main paths give them:
     K1 FAST score + NMS at the 8 ORB levels of a 480x640 frame (timed as
     the one multi-level launch ORB makes, and per level through the
     one-level entry), K2 FAST score for rings 16/12/8, K3 streaming 2-NN
     Hamming at 2000 x 128000 with ties and ~10% invalid rows, K4 LK window
     sampling at its three sites on the 480x640 level (templates C=3 win
     21, patches C=1 win 48 at integer origins, polish C=1 win 21; N = 2000
     and 512, with points on every border, outside, far outside and
     non-finite; each site timed beside grid_sample and its bound), K5
     edge-clamped windows (win 21, N = 512, interior points); all exact;
     device times by CUDA events (kernel, plain version, one PyTorch
     library call where one computes the same function) beside the bound,
     and the first designs' times as labelled constants (FIRST_DESIGN_MS);
  4. the three paths, each with the launch counts reset just before a
     warm run and read just after it:
     a. ORB VO: VisualOdometry.process_sequence on a seeded 480x640
        synthetic sequence at bench_config5's engine config
        (ORBConfig(n_features=2000), every other default, chunk=8), cold
        then warm three times (frames/s is the median warm run, printed
        with the range); ATE against ground truth must be < 5 % of the
        path, with >= 10 keyframes and the state `tracking`;
     b. LK: bench.py config 2 on 100 frames of the scene (GFTT 512 corners,
        quality 0.01, min distance 7; LKConfig(win_size=21, n_levels=4);
        build_flow_pyramid once per frame, calc_optical_flow_pyr_lk_pyr,
        re-detection below 500 tracked), cold then warm three times;
        checked against the same path on the CPU on 4 pairs (0.05 px,
        >= 99 % equal status) and on frame 0 shifted by (5, 3) px
        (every tracked corner 48 px inside within 0.35 px);
     c. klt VO: VisualOdometry(tracker="klt", n_features=2000).process_
        sequence over the 120 frames, cold then warm three times (the
        median warm run, with the range); ATE < 5 % of the path, state `tracking`, frames tracked by LK > 0, K4 launched;
  5. profile: torch.profiler over 8 frames of steady tracking of each
     engine (device busy share, kernels per frame, top kernels, top host
     operations).
Prints a JSON line of path results, a JSON line of kernels, the card
line, and last {"ok": true, "device": {...}}. Exits non-zero on any
failure, and without a card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# H100 SXM memory rate (NVIDIA data sheet, at a 700 W limit) and per-SM
# issue rates of compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput), priced at the card's max SM clock
HBM_BYTES_PER_S = 3.35e12
FP32_ADD_PER_CLK_PER_SM = 128  # FADD; f32 min/max (FMNMX) issue no faster
POPC_PER_CLK_PER_SM = 16  # 32-bit __popc

# Device ms of the first designs of K1/K2 (one launch per level, runtime
# arc) and K4/K5 (one block per point), measured by this script before
# their redesign on an NVIDIA H100 80GB HBM3 at 700.00 W. Constants, not
# re-measured (the old kernels are gone): printed, labelled, in the [K…]
# lines beside this run's times, and kept out of the measured `kernels`
# record.
FIRST_DESIGN_MS = {"fast_corners": 0.1119, "fast_score": 0.0179, "lk_sample": 0.0601,
                   "lk_sample_n512": 0.0232, "lk_sample_clamp": 0.0044}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def fast_score_ops(pattern: int = 16, arc: int = 9) -> int:
    """Least f32 operations per pixel of the FAST score, as csrc/fast.cu
    takes it: `pattern` tap differences; per sign (bright: window minima,
    dark: window maxima) the windows of arc-1 taps at the pattern/2 odd
    starts by doubling, one max and one min per pair of starts that share
    such a window, and a tree over the pairs; one negate and the final
    max."""
    inner = arc - 1
    stages = inner.bit_length() - 1 + bin(inner).count("1") - 1
    per_sign = pattern // 2 * stages + pattern + pattern // 2 - 1
    return pattern + 2 * per_sign + 2


def max_abs_err(*pairs) -> float:
    """Largest |kernel - plain| over (kernel, plain) tensor pairs."""
    return max(float((a.double() - b.double()).abs().max()) for a, b in pairs)


def device_time_ms(fn, calls: int = 10, trials: int = 20) -> float:
    """Median device time of one call of `fn`, by CUDA events around
    `calls` back-to-back calls enqueued behind a device sleep (so the
    events time the device work, not the host's enqueue)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_cycles = int((enqueue_s * 2.0 + 2e-3) * 2e9)
    out = []
    for _ in range(trials):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / calls)
    return statistics.median(out)


# ------------------------------------------------------------ synthetic scene


def make_sequence(n_frames: int = 120, h: int = 480, w: int = 640, seed: int = 7,
                  device: str = "cuda"):
    """Seeded splat renderer of tests/test_vo.py, widened to 480x640 and
    densified: points on a smooth relief surface, the camera slides right
    with slight forward motion and yaw. Returns (frames f32 [F,H,W],
    centres [F,3], K)."""
    import torch

    from opencv_tpu_torch.core import imgproc
    from opencv_tpu_torch.slam.vo import _np_rodrigues

    f = 0.82 * w
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(seed)
    n_pts = 12000
    wx = rng.uniform(-6.0, 20.0, n_pts)
    wy = rng.uniform(-4.5, 4.5, n_pts)
    wz = (7.0 + 2.8 * np.sin(0.85 * wx) * np.cos(0.7 * wy)
          + 1.5 * np.cos(1.3 * wx + 0.9 * wy) + 0.1 * wx)
    world = np.stack([wx, wy, wz], axis=1).astype(np.float32)
    inten = rng.uniform(60, 255, n_pts).astype(np.float32)
    raw, centres = [], []
    for i in range(n_frames):
        c = np.array([0.12 * i, 0.0, 0.03 * i], np.float32)
        rvec = np.array([0.0, np.deg2rad(0.15 * i), 0.0], np.float32)
        R = _np_rodrigues(rvec)
        pc = (world - c) @ R.T
        z = pc[:, 2]
        vis = z > 0.5
        u = f * pc[:, 0] / np.where(vis, z, 1.0) + w / 2
        v = f * pc[:, 1] / np.where(vis, z, 1.0) + h / 2
        vis &= (u >= 2) & (u < w - 2) & (v >= 2) & (v < h - 2)
        img = np.zeros((h, w), np.float32)
        uf, vf = u[vis], v[vis]
        u0 = np.floor(uf).astype(int)
        v0 = np.floor(vf).astype(int)
        au, av = uf - u0, vf - v0
        ii = inten[vis]
        np.add.at(img, (v0, u0), ii * (1 - au) * (1 - av))
        np.add.at(img, (v0, u0 + 1), ii * au * (1 - av))
        np.add.at(img, (v0 + 1, u0), ii * (1 - au) * av)
        np.add.at(img, (v0 + 1, u0 + 1), ii * au * av)
        raw.append(img)
        centres.append(c)
    blurred = imgproc.gaussian_blur(torch.from_numpy(np.stack(raw)).to(device), 5, 1.1)
    frames = (blurred * 4.0).clamp(0, 255).cpu().numpy()
    return frames, np.asarray(centres), K


# ------------------------------------------------------------ phases


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no output"
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    ).stdout.split()
    sm_hz = float(clock[0]) * 1e6 if clock and clock[0].isdigit() else 1.98e9  # data sheet
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[device] {card} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()} | {n_sm} SMs, "
          f"max SM clock {sm_hz / 1e6:.0f} MHz", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card, dict(fp32_add=FP32_ADD_PER_CLK_PER_SM * n_sm * sm_hz,
                      popc=POPC_PER_CLK_PER_SM * n_sm * sm_hz)


def phase_build():
    from opencv_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    times = _build.build()
    print(f"[build] {time.perf_counter() - t0:.2f} s wall; per source: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in times.items()), flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)


def phase_kernels(frame0: np.ndarray, rates: dict) -> dict:
    import torch

    from opencv_tpu_torch.core import pyramid
    from opencv_tpu_torch.ops.cuda import fast_kernel, knn

    rows = {}
    dev = torch.device("cuda")

    # K1: FAST score + NMS at the 8 ORB levels of a 480x640 frame: the
    # multi-level entry (one launch, as ORB detects) and the one-level entry
    pyr = pyramid.build_pyramid(torch.from_numpy(frame0).to(dev), 8, 1.2)
    levels = list(pyr.levels)
    multi = fast_kernel.fast_corners_levels(levels, 20.0)
    p_ms = bytes_ = ops = err1 = 0.0
    per_level = []
    for lvl, (s_m, n_m) in zip(levels, multi):
        s_k, n_k = fast_kernel.fast_corners_cuda(lvl, 20.0)
        s_p, n_p = fast_kernel.fast_corners_plain(lvl, 20.0)
        torch.cuda.synchronize()
        err1 = max(err1, max_abs_err((s_k, s_p), (n_k, n_p), (s_m, s_p), (n_m, n_p)))
        for how, s_x, n_x in (("one-level", s_k, n_k), ("multi-level", s_m, n_m)):
            if not (torch.equal(s_x, s_p) and torch.equal(n_x, n_p)):
                bad = (s_x != s_p).sum().item() + (n_x != n_p).sum().item()
                fail(f"K1 ({how}) differs from its plain version at {tuple(lvl.shape)}: {bad} values")
        per_level.append(device_time_ms(lambda lvl=lvl: fast_kernel.fast_corners_cuda(lvl, 20.0)))
        p_ms += device_time_ms(lambda lvl=lvl: fast_kernel.fast_corners_plain(lvl, 20.0), calls=3)
        npx = lvl.numel()
        bytes_ += npx * 4 * 3  # read the level, write score and nms
        ops += npx * (fast_score_ops(16, 9) + 1 + 8)  # score, threshold, 8 NMS compares
    k_ms = device_time_ms(lambda: fast_kernel.fast_corners_levels(levels, 20.0))
    bound1 = max(bytes_ / HBM_BYTES_PER_S, ops / rates["fp32_add"]) * 1e3
    rows["fast_corners"] = dict(
        name="fast_corners (K1: FAST-16 arc-9 score + threshold + border + 3x3 NMS; "
             "the 8 levels of a frame in one launch)",
        route="cuda", source="opencv_tpu_torch/csrc/fast.cu",
        replaces="opencv_tpu/ops/pallas/fast_kernel.py:92",
        max_abs_err=err1, ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=bound1,
        bound_by="bytes" if bytes_ / HBM_BYTES_PER_S >= ops / rates["fp32_add"] else "operations",
        shapes=[tuple(l.shape) for l in levels], one_level_ms=per_level,
        one_level_sum_ms=sum(per_level),
    )
    print("[K1] one-level entry per level: " + ", ".join(
        f"{l.shape[0]}x{l.shape[1]} {t:.4f} ms" for l, t in zip(levels, per_level)), flush=True)
    print(f"[K1] exact at 8 levels (multi-level and one-level entries); 8 levels in one launch "
          f"{k_ms:.4f} ms (first design, a constant: {FIRST_DESIGN_MS['fast_corners']} ms in "
          f"eight launches), one-level calls summed {sum(per_level):.4f} ms, plain {p_ms:.4f} ms, bound "
          f"{bound1:.5f} ms ({rows['fast_corners']['bound_by']})", flush=True)

    # K2: score only, rings 16/12/8 and several arcs, at level 0
    lvl0 = pyr.levels[0]
    err2 = 0.0
    for pattern, arc in ((16, 9), (16, 12), (12, 7), (12, 9), (8, 5), (8, 8)):
        a = fast_kernel.fast_score_cuda(lvl0, arc, pattern)
        b = fast_kernel.fast_score_plain(lvl0, arc, pattern)
        torch.cuda.synchronize()
        err2 = max(err2, max_abs_err((a, b)))
        if not torch.equal(a, b):
            fail(f"K2 differs from its plain version (pattern {pattern}, arc {arc}): "
                 f"{(a != b).sum().item()} values")
    k2_ms = device_time_ms(lambda: fast_kernel.fast_score_cuda(lvl0, 9, 16))
    k2_pl = device_time_ms(lambda: fast_kernel.fast_score_plain(lvl0, 9, 16), calls=3)
    npx = lvl0.numel()
    b2, o2 = npx * 8, npx * fast_score_ops(16, 9)
    rows["fast_score"] = dict(
        name="fast_score (K2: FAST score only, rings 16/12/8)", route="cuda",
        source="opencv_tpu_torch/csrc/fast.cu",
        replaces="opencv_tpu/ops/pallas/fast_kernel.py:51",
        max_abs_err=err2, ms=k2_ms, plain_ms=k2_pl, library_ms=None,
        bound_ms=max(b2 / HBM_BYTES_PER_S, o2 / rates["fp32_add"]) * 1e3,
        bound_by="bytes" if b2 / HBM_BYTES_PER_S >= o2 / rates["fp32_add"] else "operations",
        shapes=[tuple(lvl0.shape)],
    )
    print(f"[K2] exact for rings 16/12/8; kernel {k2_ms:.4f} ms (first design, a "
          f"constant: {FIRST_DESIGN_MS['fast_score']} ms), plain {k2_pl:.4f} ms at 480x640", flush=True)

    # K3: streaming 2-NN at the retrieval shape, with ties and invalid rows
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    nq, nt = 2000, 64 * 2000
    lo, hi = -(2 ** 31), 2 ** 31
    train = torch.randint(lo, hi, (nt, 8), generator=g, device=dev, dtype=torch.int64).to(torch.int32)
    train[64000:66000] = train[0:2000]  # duplicate rows: exact ties across splits
    query = torch.randint(lo, hi, (nq, 8), generator=g, device=dev, dtype=torch.int64).to(torch.int32)
    query[:1000] = train[torch.arange(0, 2000, 2, device=dev)]  # near-exact matches
    query[:1000, 0] ^= 1
    valid = torch.rand(nt, generator=g, device=dev) > 0.1
    d1k, d2k, i1k = knn.knn2_hamming_cuda(query, train, valid)
    d1p, d2p, i1p = knn.knn2_hamming_plain(query, train, valid)
    torch.cuda.synchronize()
    err3 = max_abs_err((d1k, d1p), (d2k, d2p), (i1k, i1p))
    for nm, a, b in (("d1", d1k, d1p), ("d2", d2k, d2p), ("i1", i1k, i1p)):
        if not torch.equal(a, b):
            fail(f"K3 {nm} differs from its plain version: {(a != b).sum().item()} queries")
    n_ties = int((d1k == d2k).sum())
    k3_ms = device_time_ms(lambda: knn.knn2_hamming_cuda(query, train, valid), calls=5)
    k3_pl = device_time_ms(lambda: knn.knn2_hamming_plain(query, train, valid), calls=2, trials=20)
    sq = knn.signed_descriptors(query).to(torch.bfloat16)
    st = knn.signed_descriptors(train).to(torch.bfloat16)
    big = torch.where(valid, 0.0, 1024.0).to(torch.bfloat16)

    def library():
        dist = (256.0 - sq @ st.T) * 0.5 + big
        return torch.topk(dist, 2, dim=1, largest=False)

    lib_ms = device_time_ms(library, calls=3)
    n_valid = int(valid.sum())
    b3 = (nq + nt) * 32 + nt + nq * 12
    o3 = nq * n_valid * 8
    rows["knn2_hamming"] = dict(
        name="knn2_hamming (K3: streaming 2-NN Hamming, ratio test outside)", route="cuda",
        source="opencv_tpu_torch/csrc/knn2_hamming.cu",
        replaces="opencv_tpu/ops/pallas/knn.py:30",
        max_abs_err=err3, ms=k3_ms, plain_ms=k3_pl, library_ms=lib_ms,
        bound_ms=max(b3 / HBM_BYTES_PER_S, o3 / rates["popc"]) * 1e3,
        bound_by="bytes" if b3 / HBM_BYTES_PER_S >= o3 / rates["popc"] else "operations",
        shapes=[(nq, 8), (nt, 8)],
    )
    print(f"[K3] exact on d1/d2/i1 ({n_ties} queries with d1 == d2, {nt - n_valid} invalid "
          f"rows); kernel {k3_ms:.4f} ms, plain {k3_pl:.4f} ms, bf16 matmul+topk "
          f"{lib_ms:.4f} ms", flush=True)
    del sq, st
    torch.cuda.empty_cache()
    rows.update(phase_lk_kernels(lvl0, rates))
    return rows


def lk_points(n: int, h: int, w: int, win: int, seed: int, odd: bool = True) -> np.ndarray:
    """n points on the level: subpixel interior points, then (odd=True)
    every border, outside, far outside and non-finite case of
    tests/test_pallas_lk_sample.py. odd=False keeps all points half a
    window inside (K5's domain)."""
    rng = np.random.default_rng(seed)
    m = win // 2 + 1 if not odd else 0
    pts = np.stack([rng.uniform(m, w - 1 - m, n), rng.uniform(m, h - 1 - m, n)], -1)
    pts = pts.astype(np.float32)
    if odd:
        pts[:16] = [
            [0.0, 0.0], [w - 1.0, h - 1.0], [0.3, 17.2], [w - 1.4, 30.1], [40.2, 0.7],
            [39.9, h - 1.2], [-3.5, 12.0], [w + 4.0, h + 4.0], [-win / 2, -win / 2],
            [-500.0, -500.0], [1e7, 12.0], [np.nan, 5.0], [5.0, np.inf], [-np.inf, 3.0],
            [33.0, 44.0], [w - 1.0, 0.0],
        ]
    return pts


def touched_pixels(pts: np.ndarray, win: int, h: int, w: int) -> int:
    """Distinct level pixels that the bilinear win x win windows at pts
    [N, 2] read with a non-zero weight: rows and columns floor(p - win//2)
    up to win + 1 on (win at a zero fraction), cut to the image; a
    non-finite point reads nothing."""
    mask = np.zeros((h, w), bool)
    start = pts[np.isfinite(pts).all(1)].astype(np.float32) - np.float32(win // 2)
    lo = np.floor(start)
    hi = lo + win + (start > lo)
    lo = np.clip(lo, 0, [w, h]).astype(np.int64)
    hi = np.clip(hi, 0, [w, h]).astype(np.int64)
    for (x0, y0), (x1, y1) in zip(lo, hi):
        mask[y0:y1, x0:x1] = True
    return int(mask.sum())


def window_grid(pts, win: int, h: int, w: int):
    """grid_sample grid [1, N*win, win, 2] of the win x win window
    positions (align_corners=True: -1 and 1 are the outer pixel centres);
    non-finite points moved far outside."""
    import torch

    p = torch.nan_to_num(pts, nan=-1e6, posinf=1e6, neginf=-1e6)
    ar = torch.arange(win, device=pts.device, dtype=torch.float32) - float(win // 2)
    x = (p[:, 0, None, None] + ar[None, None, :]).expand(-1, win, win)
    y = (p[:, 1, None, None] + ar[None, :, None]).expand(-1, win, win)
    g = torch.stack([2.0 * x / (w - 1) - 1.0, 2.0 * y / (h - 1) - 1.0], -1)
    return g.reshape(1, -1, win, 2).contiguous()


def phase_lk_kernels(lvl0, rates: dict) -> dict:
    """K4 at its three sites on the 480x640 level and K5, exact against
    their plain versions, timed beside grid_sample and the bound."""
    import torch
    import torch.nn.functional as F

    from opencv_tpu_torch.core import imgproc
    from opencv_tpu_torch.ops.cuda import lk_sample

    dev = lvl0.device
    h, w = lvl0.shape
    dx, dy = imgproc.scharr_derivatives(lvl0)
    sites = (("templates", (lvl0, dx, dy), 21, False), ("patch", (lvl0,), 48, True),
             ("polish", (lvl0,), 21, False))
    per_n = {}
    err4 = 0.0
    for n in (2000, 512):
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0, sites={})
        for name, chans, win, integer in sites:
            pts = lk_points(n, h, w, win, seed=n + win)
            if integer:
                pts = np.round(np.nan_to_num(pts, nan=-1e6, posinf=1e6, neginf=-1e6))
            p = torch.from_numpy(pts).to(dev)
            got = lk_sample.sample_channels(chans, p, win)
            want = lk_sample.sample_channels_plain(torch.stack(chans), p, win)
            torch.cuda.synchronize()
            err4 = max(err4, max_abs_err((got, want)))
            if not torch.equal(got, want):
                fail(f"K4 ({name}, N={n}) differs from its plain version: "
                     f"{(got != want).sum().item()} values")
            if got[:, 9:14].any():
                fail(f"K4 ({name}, N={n}): a far-outside or non-finite point has a non-zero window")
            stack = torch.stack(chans)[None]
            grid = window_grid(p, win, h, w)
            lib = F.grid_sample(stack, grid, mode="bilinear", padding_mode="zeros",
                                align_corners=True).reshape(len(chans), n, win, win)
            lib_err = float((lib - got).abs().max())
            c = len(chans)
            site = dict(
                ms=device_time_ms(lambda: lk_sample.sample_channels(chans, p, win)),
                plain_ms=device_time_ms(
                    lambda: lk_sample.sample_channels_plain(torch.stack(chans), p, win), calls=3),
                library_ms=device_time_ms(
                    lambda: F.grid_sample(stack, grid, mode="bilinear", padding_mode="zeros",
                                          align_corners=True)),
                bytes=c * touched_pixels(pts, win, h, w) * 4 + n * 8 + c * n * win * win * 4,
                ops=c * n * win * win * 7 + n * 12,  # 4 mul + 3 add per output; weights
            )
            site["bound_ms"] = max(site["bytes"] / HBM_BYTES_PER_S,
                                   site["ops"] / rates["fp32_add"]) * 1e3
            for k in ("ms", "plain_ms", "library_ms", "bytes", "ops"):
                tot[k] += site[k]
            tot["sites"][name] = dict(site, c=c, win=win)
            print(f"[K4] {name} C={c} win {win} N={n}: exact ({int(np.isfinite(pts).all(1).sum())} "
                  f"finite points); kernel {site['ms']:.4f} ms, grid_sample {site['library_ms']:.4f} "
                  f"ms (differs by {lib_err:.3g}), bound {site['bound_ms']:.5f} ms, plain "
                  f"{site['plain_ms']:.4f} ms", flush=True)
        tot["bound_ms"] = max(tot["bytes"] / HBM_BYTES_PER_S, tot["ops"] / rates["fp32_add"]) * 1e3
        tot["bound_by"] = ("bytes" if tot["bytes"] / HBM_BYTES_PER_S >= tot["ops"] / rates["fp32_add"]
                           else "operations")
        per_n[n] = tot
        old = FIRST_DESIGN_MS["lk_sample" if n == 2000 else "lk_sample_n512"]
        print(f"[K4] three sites, N={n}: kernel {tot['ms']:.4f} ms (first design, a constant: "
              f"{old} ms), plain {tot['plain_ms']:.4f} ms, grid_sample {tot['library_ms']:.4f} ms, bound "
              f"{tot['bound_ms']:.4f} ms ({tot['bound_by']})", flush=True)
    t = per_n[2000]
    rows = {"lk_sample": dict(
        name="lk_sample (K4: bilinear LK windows of C channels, zero outside the image; "
             "the three sites of one level-0 track, summed)",
        route="cuda", source="opencv_tpu_torch/csrc/lk_sample.cu",
        replaces="opencv_tpu/ops/pallas/lk_sample.py:165",
        max_abs_err=err4, ms=t["ms"], plain_ms=t["plain_ms"], library_ms=t["library_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        shapes=[[len(ch), h, w, 2000, win] for _, ch, win, _ in sites],
        sites=t["sites"],
        at_n512={k: per_n[512][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                            "sites")},
    )}

    # K5: edge-clamped single-channel windows, its documented domain
    n, win = 512, 21
    pts = lk_points(n, h, w, win, seed=5, odd=False)
    p = torch.from_numpy(pts).to(dev)
    got = lk_sample.sample_windows(lvl0, p, win)
    want = lk_sample.sample_windows_plain(lvl0, p, win)
    torch.cuda.synchronize()
    err5 = max_abs_err((got, want))
    if not torch.equal(got, want):
        fail(f"K5 differs from its plain version: {(got != want).sum().item()} values")
    grid = window_grid(p, win, h, w)
    img4 = lvl0[None, None]
    k5_ms = device_time_ms(lambda: lk_sample.sample_windows(lvl0, p, win))
    k5_pl = device_time_ms(lambda: lk_sample.sample_windows_plain(lvl0, p, win), calls=3)
    k5_lib = device_time_ms(lambda: F.grid_sample(img4, grid, mode="bilinear",
                                                  padding_mode="border", align_corners=True))
    b5 = touched_pixels(pts, win, h, w) * 4 + n * 8 + n * win * win * 4  # interior: no clamping
    o5 = n * win * win * 9 + n * 12  # two row blends and one column blend: 6 mul + 3 add
    rows["lk_sample_clamp"] = dict(
        name="lk_sample_clamp (K5: edge-clamped single-channel LK windows)", route="cuda",
        source="opencv_tpu_torch/csrc/lk_sample.cu",
        replaces="opencv_tpu/ops/pallas/lk_sample.py:47",
        max_abs_err=err5, ms=k5_ms, plain_ms=k5_pl, library_ms=k5_lib,
        bound_ms=max(b5 / HBM_BYTES_PER_S, o5 / rates["fp32_add"]) * 1e3,
        bound_by="bytes" if b5 / HBM_BYTES_PER_S >= o5 / rates["fp32_add"] else "operations",
        shapes=[[1, h, w, n, win]],
    )
    print(f"[K5] exact at N={n} win {win}; kernel {k5_ms:.4f} ms (first design, a "
          f"constant: {FIRST_DESIGN_MS['lk_sample_clamp']} ms), plain {k5_pl:.4f} ms, grid_sample (border) "
          f"{k5_lib:.4f} ms", flush=True)
    return rows


def phase_main_path(frames, centres, K, warm_runs: int = 3) -> dict:
    import torch

    from opencv_tpu_torch.core.config import ORBConfig
    from opencv_tpu_torch.ops import cuda as cuda_ops
    from opencv_tpu_torch.slam.vo import VisualOdometry, VOConfig
    from opencv_tpu_torch.utils.evaluate import ate_rmse

    cfg = VOConfig(orb=ORBConfig(n_features=2000))
    n = frames.shape[0]
    t0 = time.perf_counter()
    VisualOdometry(K, cfg, seed=0).process_sequence(frames, chunk=8)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0

    warm_s, runs = [], []
    for _ in range(warm_runs):
        vo = VisualOdometry(K, cfg, seed=0)
        cuda_ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        traj = vo.process_sequence(frames, chunk=8)
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t0)
        runs.append((vo, traj, dict(cuda_ops.launch_counts)))
        for k in ("fast_corners", "knn2_hamming"):
            if runs[-1][2][k] <= 0:
                fail(f"kernel {k} was not launched on the main path")
    vo, traj, counts = runs[0]
    warm = statistics.median(warm_s)

    if traj.shape != (n, 3) or not np.isfinite(traj).all():
        fail(f"trajectory shape {traj.shape} or non-finite values")
    path = float(np.linalg.norm(np.diff(centres, axis=0), axis=1).sum())
    ate = ate_rmse(traj, centres, with_scale=True)
    res = dict(frames=n, fps_warm=n / warm, fps_warm_runs=[n / t for t in warm_s],
               warm_s=warm, cold_s=cold, ate=ate, path=path,
               ate_pct=100 * ate / path, keyframes=len(vo.keyframes),
               loop_closures=vo.loop_closures, relocalizations=vo.relocalizations,
               state=vo.state, launches=counts)
    print(f"[main] {n} frames 480x640: warm {warm:.3f} s ({n / warm:.2f} frames/s, median "
          f"of {warm_runs} runs, range {n / max(warm_s):.2f} to {n / min(warm_s):.2f}), cold "
          f"{cold:.3f} s; ATE {ate:.5f} = {100 * ate / path:.3f} % of path {path:.3f}; "
          f"{len(vo.keyframes)} keyframes, {vo.loop_closures} loop closures, "
          f"{vo.relocalizations} relocalizations; launches {counts}", flush=True)
    if vo.state != "tracking":
        fail(f"engine state {vo.state}")
    if len(vo.keyframes) < 10:
        fail(f"only {len(vo.keyframes)} keyframes: retrieval never ran")
    if not ate < 0.05 * path:
        fail(f"ATE {ate:.4f} >= 5% of path {path:.3f}")
    return res


def lk_config2_run(frames_dev, cfg, dev):
    """bench.py config 2 on a clip: GFTT, then per frame one pyramid and
    one pyramid-reuse LK call; re-detect when fewer than 500 survive.
    Returns (tracked count per pair, re-detections)."""
    from opencv_tpu_torch.ops import gftt, lk

    def detect(img):
        kp = gftt.good_features_to_track(img, max_corners=512, quality_level=0.01,
                                         min_distance=7.0, device=dev)
        return kp.xy, kp.valid

    pyr_prev = lk.build_flow_pyramid(frames_dev[0], cfg, dev)
    pts, valid = detect(frames_dev[0])
    tracked, redetect = [], 0
    for f in range(1, frames_dev.shape[0]):
        pyr = lk.build_flow_pyramid(frames_dev[f], cfg, dev)
        new, status, _ = lk.calc_optical_flow_pyr_lk_pyr(pyr_prev, pyr, pts, valid, cfg)
        count = int(status.sum())  # the host decides, as bench's lax.cond on device
        tracked.append(count)
        if count < 500:
            pts, valid = detect(frames_dev[f])
            redetect += 1
        else:
            pts, valid = new, status
        pyr_prev = pyr
    return tracked, redetect


def phase_lk_path(frames, warm_runs: int = 3, dev: str = "cuda") -> dict:
    """The LK path (bench.py config 2) on the first 100 frames, and its two
    checks: (a) 4 pairs against the same path on the CPU, (b) frame 0
    rolled by (dx, dy) = (5, 3) px, on corners at least 48 px inside
    (the roll wraps the border, and a coarse level's window reaches it)."""
    import torch

    from opencv_tpu_torch.core.config import LKConfig
    from opencv_tpu_torch.ops import cuda as cuda_ops
    from opencv_tpu_torch.ops import gftt, lk

    cfg = LKConfig(win_size=21, n_levels=4)
    clip = torch.from_numpy(np.ascontiguousarray(frames[:100])).to(dev)
    n = clip.shape[0]
    t0 = time.perf_counter()
    lk_config2_run(clip, cfg, dev)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    warm_s, runs = [], []
    for _ in range(warm_runs):
        cuda_ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracked, redetect = lk_config2_run(clip, cfg, dev)
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t0)
        runs.append((tracked, redetect, dict(cuda_ops.launch_counts)))
        if runs[-1][2]["lk_sample"] <= 0:
            fail("kernel lk_sample was not launched on the LK path")
    tracked, redetect, counts = runs[0]
    warm = statistics.median(warm_s)
    per_pair = counts["lk_sample"] / (n - 1)

    # (a) 4 pairs: the card against the port on the CPU, the same points
    kp = gftt.good_features_to_track(clip[0], max_corners=512, quality_level=0.01,
                                     min_distance=7.0, device=dev)
    pts, valid = kp.xy, kp.valid
    worst, agree, n_both = 0.0, [], 0
    for f in range(4):
        a, b = clip[f], clip[f + 1]
        g_new, g_st, _ = lk.calc_optical_flow_pyr_lk(a, b, pts, valid, cfg, device=dev)
        c_new, c_st, _ = lk.calc_optical_flow_pyr_lk(a.cpu(), b.cpu(), pts.cpu(), valid.cpu(),
                                                     cfg, device="cpu")
        g_new, g_st = g_new.cpu(), g_st.cpu()
        both = g_st & c_st
        agree.append(float((g_st == c_st)[valid.cpu()].float().mean()))
        n_both += int(both.sum())
        if both.any():
            worst = max(worst, float((g_new - c_new)[both].abs().max()))
        pts, valid = g_new.to(dev), g_st.to(dev)
    print(f"[lk] (a) 4 pairs, card vs CPU: {n_both} points tracked in both, largest "
          f"difference {worst:.3g} px, status agreement {min(agree):.4f} (worst pair)", flush=True)
    if not worst <= 0.05:
        fail(f"LK on the card differs from the CPU run by {worst} px (> 0.05)")
    if not min(agree) >= 0.99:
        fail(f"LK status agrees with the CPU run on only {min(agree):.4f} of the points")

    # (b) a known translation: frame 0 rolled by 3 rows and 5 columns
    moved = torch.roll(clip[0], (3, 5), dims=(0, 1))
    h, w = clip.shape[1:]
    kp = gftt.good_features_to_track(clip[0], max_corners=512, quality_level=0.01,
                                     min_distance=7.0, device=dev)
    xy = kp.xy
    inner = kp.valid & (xy[:, 0] >= 48) & (xy[:, 0] <= w - 49) & (xy[:, 1] >= 48) & (xy[:, 1] <= h - 49)
    new, st, _ = lk.calc_optical_flow_pyr_lk(clip[0], moved, xy, inner, cfg, device=dev)
    flow = (new - xy)[st]
    shift_err = float((flow - torch.tensor([5.0, 3.0], device=dev)).abs().max()) if st.any() else float("inf")
    print(f"[lk] (b) shift (5, 3): {int(st.sum())} of {int(inner.sum())} interior corners tracked, "
          f"largest flow error {shift_err:.4f} px", flush=True)
    if not shift_err < 0.35:
        fail(f"LK flow error {shift_err} px on a pure (5, 3) shift (bound 0.35)")

    res = dict(frames=n, fps_warm=n / warm, fps_warm_runs=[n / t for t in warm_s],
               warm_s=warm, cold_s=cold, tracked_mean=float(np.mean(tracked)),
               tracked_min=int(np.min(tracked)), redetections=redetect,
               k4_launches_per_pair=per_pair, cpu_check_max_px=worst,
               cpu_check_status_agreement=min(agree), shift_check_max_px=shift_err,
               launches=counts)
    print(f"[lk] {n} frames 480x640, GFTT 512 + LK win 21 x 4 levels: warm {warm:.3f} s "
          f"({n / warm:.2f} frames/s, median of {warm_runs} runs, range "
          f"{n / max(warm_s):.2f} to {n / min(warm_s):.2f}), cold {cold:.3f} s; tracked per pair "
          f"mean {res['tracked_mean']:.1f}, min {res['tracked_min']}; {redetect} re-detections; "
          f"K4 launches per pair {per_pair:.2f}; launches {counts}", flush=True)
    return res


def phase_klt(frames, centres, K, warm_runs: int = 3) -> dict:
    """The VO engine with the klt tracker, cold then warm `warm_runs`
    times (frames/s is the median warm run, printed with the range)."""
    import torch

    from opencv_tpu_torch.core.config import ORBConfig
    from opencv_tpu_torch.ops import cuda as cuda_ops
    from opencv_tpu_torch.slam.vo import VisualOdometry, VOConfig
    from opencv_tpu_torch.utils.evaluate import ate_rmse

    cfg = VOConfig(orb=ORBConfig(n_features=2000), tracker="klt")
    n = frames.shape[0]
    t0 = time.perf_counter()
    VisualOdometry(K, cfg, seed=0).process_sequence(frames)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    warm_s, runs = [], []
    for _ in range(warm_runs):
        vo = VisualOdometry(K, cfg, seed=0)
        cuda_ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        traj = vo.process_sequence(frames)
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t0)
        runs.append((vo, traj, dict(cuda_ops.launch_counts)))
        if runs[-1][2]["lk_sample"] <= 0:
            fail("kernel lk_sample was not launched by the klt engine")
    vo, traj, counts = runs[0]
    warm = statistics.median(warm_s)
    if traj.shape != (n, 3) or not np.isfinite(traj).all():
        fail(f"klt trajectory shape {traj.shape} or non-finite values")
    path = float(np.linalg.norm(np.diff(centres, axis=0), axis=1).sum())
    ate = ate_rmse(traj, centres, with_scale=True)
    res = dict(frames=n, fps_warm=n / warm, fps_warm_runs=[n / t for t in warm_s],
               warm_s=warm, cold_s=cold, ate=ate, path=path,
               ate_pct=100 * ate / path, keyframes=len(vo.keyframes), lk_tracked=vo.lk_tracked,
               relocalizations=vo.relocalizations, state=vo.state, launches=counts)
    print(f"[klt] {n} frames 480x640: warm {warm:.3f} s ({n / warm:.2f} frames/s, median of "
          f"{warm_runs} runs, range {n / max(warm_s):.2f} to {n / min(warm_s):.2f}), cold "
          f"{cold:.3f} s; ATE {ate:.5f} = {100 * ate / path:.3f} % of path {path:.3f}; "
          f"{len(vo.keyframes)} keyframes, {vo.lk_tracked} frames tracked by LK, "
          f"{vo.relocalizations} relocalizations; launches {counts}", flush=True)
    if vo.state != "tracking":
        fail(f"klt engine state {vo.state}")
    if vo.lk_tracked <= 0:
        fail("the klt engine tracked no frame by LK")
    if not ate < 0.05 * path:
        fail(f"klt ATE {ate:.4f} >= 5% of path {path:.3f}")
    return res


def phase_profile(frames, K, tracker: str = "orb", warmup: int = 40, window: int = 8) -> None:
    """Where the time goes in steady tracking: torch.profiler over frames
    [warmup, warmup + window) of a fresh engine that has tracked the first
    `warmup` frames. Prints the device's busy share of the window's wall
    time (the sum of kernel times: no kernels overlap on one stream), the
    top kernels by device time and the top host operations by their own
    time. The profiler slows the host, so the busy share is a lower bound
    of the unprofiled run's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from opencv_tpu_torch.core.config import ORBConfig
    from opencv_tpu_torch.slam.vo import VisualOdometry, VOConfig

    vo = VisualOdometry(K, VOConfig(orb=ORBConfig(n_features=2000), tracker=tracker), seed=0)
    vo.process_sequence(frames[:warmup], chunk=8)
    torch.cuda.synchronize()
    tag = f"profile {tracker}"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        vo.process_sequence(frames[warmup: warmup + window], chunk=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    print(f"[{tag}] frames {warmup}-{warmup + window}: wall {wall:.3f} s "
          f"({window / wall:.2f} frames/s under the profiler), {launches} kernels "
          f"({launches / window:.0f} per frame)", flush=True)
    if busy <= 0:
        print(f"[{tag}] no kernel time visible to torch.profiler: busy share not measured",
              flush=True)
    else:
        print(f"[{tag}] device busy {busy:.3f} s = {100 * busy / wall:.1f} % of wall", flush=True)
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        print(f"[{tag}] kernel {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x  "
              f"{e.key[:100]}", flush=True)
    for e in sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]:
        print(f"[{tag}] host {e.self_cpu_time_total / 1e3:9.2f} ms {e.count:7d}x  "
              f"{e.key[:100]}", flush=True)


def main():
    card, rates = phase_device()
    try:
        import torch  # noqa: F401

        from opencv_tpu_torch.ops import cuda  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable from {REPO}: {e}")
    phase_build()
    t0 = time.perf_counter()
    frames, centres, K = make_sequence()
    print(f"[scene] {frames.shape[0]} frames {frames.shape[1]}x{frames.shape[2]} rendered in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t_start = time.perf_counter()

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"[time] {name}: {time.perf_counter() - t:.1f} s (total "
              f"{time.perf_counter() - t_start:.1f} s)", flush=True)
        return out

    rows = timed("kernels", phase_kernels, frames[0], rates)
    paths = {"vo_orb": timed("vo_orb", phase_main_path, frames, centres, K),
             "lk": timed("lk", phase_lk_path, frames),
             "vo_klt": timed("vo_klt", phase_klt, frames, centres, K)}
    timed("profile orb", phase_profile, frames, K, "orb")
    timed("profile klt", phase_profile, frames, K, "klt")
    kernels = []
    for key, row in rows.items():
        by_path = {p: res["launches"][key] for p, res in paths.items()}
        kernels.append(dict(row, launches=sum(by_path.values()), launches_by_path=by_path,
                            launches_per_frame={p: by_path[p] / paths[p]["frames"] for p in paths},
                            on_main_path=key not in ("fast_score", "lk_sample_clamp")))
    print(json.dumps({"paths": paths}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    import torch

    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
