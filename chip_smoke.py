"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Phases:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: every kernel of csrc/ with nvcc for sm_90a and the host
     Munkres solver with g++, all in parallel;
  3. kernels vs plain on the card, at the shapes the main paths give them:
     K1 FAST score + NMS at the 8 ORB levels of a 480x640 frame (timed as
     the one multi-level launch ORB makes, and per level through the
     one-level entry), K2 FAST score for rings 16/12/8, K3 streaming 2-NN
     Hamming at 2000 x 128000 with ties and ~10% invalid rows, K4 LK window
     sampling at its three sites on the 480x640 level (templates C=3 win
     21, patches C=1 win 48 at integer origins, polish C=1 win 21; N = 2000
     and 512 (the LK path's), 32 (DetectionBasedTracker's) and 200
     (videostab's), with points
     on every border, outside, far outside and non-finite; each site timed
     beside grid_sample and its bound), K5
     edge-clamped windows (win 21, N = 512, interior points); all exact;
     device times by CUDA events (kernel, plain version, one PyTorch
     library call where one computes the same function) beside the bound,
     and the first designs' times as labelled constants (FIRST_DESIGN_MS);
  4. the fifteen paths, each with the launch counts reset just before each
     warm run and read just after it:
     a. ORB VO: VisualOdometry.process_sequence on a seeded 480x640
        synthetic sequence at bench_config5's engine config
        (ORBConfig(n_features=2000), every other default, chunk=8), cold
        then warm twice (frames/s is the median warm run, printed
        with the range); ATE against ground truth must be < 5 % of the
        path, with >= 10 keyframes and the state `tracking`;
     b. LK: bench.py config 2 on 100 frames of the scene (GFTT 512 corners,
        quality 0.01, min distance 7; LKConfig(win_size=21, n_levels=4);
        build_flow_pyramid once per frame, calc_optical_flow_pyr_lk_pyr,
        re-detection below 500 tracked), cold then warm twice;
        checked against the same path on the CPU on 4 pairs (0.05 px,
        >= 99 % equal status) and on frame 0 shifted by (5, 3) px
        (every tracked corner 48 px inside within 0.35 px);
     c. klt VO: VisualOdometry(tracker="klt", n_features=2000).process_
        sequence over the 120 frames, cold then warm twice (the
        median warm run, with the range); ATE < 5 % of the path, state `tracking`, frames tracked by LK > 0, K4 launched;
     d. twoview: bench.py config 3 with the 5-point and EPnP solvers on
        frames 0 and 8 (ORB, 2-NN, 5-point RANSAC, recoverPose,
        triangulation, correctMatches, EPnP-RANSAC, VVS, AP3P, similarity
        RANSAC), cold then warm three times; rotation < 1 deg and
        translation direction < 3 deg from the truth, EPnP keeping >= 80 %
        of recoverPose's mask, the card within 0.05 / 0.2 deg of the same
        path on the CPU;
     e. calib: 20 views of a 9x6 board: calibrate_camera (RMS < 0.35 px,
        fx and fy within 1 %), IPPE per view, stereo_calibrate of a second
        camera 0.12 m to the right (baseline within 1 %), stereo_rectify,
        both rectification maps, remap of frame 0, calibrate_fisheye; the
        card against the CPU (K 0.05 px, maps 1e-3 px, remap 1e-3);
     f. lsh: an LSH index of the ORB descriptors of frames 0-63 (128 000
        rows); near-duplicate queries (recall > 0.85, false positives
        < 0.05) and frame 64's, against the exact 2-NN through K3; the
        card's matches equal to the CPU's; build and query times;
     g. tbd: examples/tbd_app.py's frame loop (two classes, a Tracker
        each, ground-truth detections jittered by 0.8 px with 15 %
        dropped, MotMetrics from frame 5) on its scene under history
        distributions "1" and "7,3" (MOTA > 0.8 for both classes), then
        a crowd of 32 pedestrians and 8 vehicles over 120 frames; cold
        then warm twice; the CPU's run gives the same confirmed IDs and
        MOT counters and boxes within 1e-3 px; tracking-only frames/s;
     h. hog: the TBD app in HOG mode: a linear SVM fitted on the port's
        descriptors of 60 + 60 bar windows (tests/test_hog.py's), 120
        frames 480x640 of 6 bar pedestrians, detectMultiScale at the
        reference's defaults (scale 1.05, 64 levels: 28 fit) with the
        hits grouped, a Tracker, MOTA against the planted boxes; HOG
        detection and frame frames/s; cold (8 frames) then warm twice;
        4 frames against the CPU (the same boxes, scores within 1e-3);
     i. dbt: DetectionBasedTracker with this detector every 4 frames and
        LK between on the first 32 frames of the scene, cold (8 frames)
        then warm twice; its level-0 LK must launch K4; 5 frames against the CPU
        (the same confirmed IDs, boxes within 0.05 px, the LK rule);
     j. lane: examples/lane_detection.py at 480x640 on 30 frames (blur,
        Canny, Hough segments): both lanes in every frame; cold then warm
        twice; frame 0 against the CPU (equal edges, segments within
        0.5 px);
     k. calibapp: examples/calibration_app.py's flow (8 views of its 7x5
        board rendered with warp_perspective at 480x640, seed 0;
        find_chessboard_corners per view, calibrate_camera, per-view
        reprojection error, the worst view dropped and recalibrated, the
        app's verdict: RMS < 0.8 px, fx and fy within 3 %) and a 5x4
        circles-grid view (find_circles_grid: connected components and
        blobs); every board found, verdict OK, circles within 0.5 px of
        their centres; cold then warm twice; the CPU's corners within
        1e-3 px, its circles grid equal; connected components' sweeps and
        host reads;
     l. stab: videostab.stabilize on 60 frames 480x640 (frame 0 of the
        scene moved by a random walk of N(0, 1.5) px steps; GFTT 200, LK
        at 3 levels: K4 at level 0, affine RANSAC, smoothing radius 5);
        cold then warm twice; jitter below 0.6 of the input's; the first
        5 pairs' motions on the CPU within 0.05 px; find_transform_ecc
        ("affine") on 3 pairs against their RANSAC motion, Wiener
        deblurring of one frame, wobble suppression of the motions;
     m. pano: examples/panorama.py's 3 views of 160x200 on the card and
        on the CPU, 5 views of 480x640 (estimate_panorama and
        stitch_panorama) cold then warm twice, stitch_pair on two of them
        against the CPU; K1 bit for bit against its plain version on
        every view's 4-level ORB pyramid;
     n. qr: examples/qr_demo.py's round trip and 24 scenes of 480x640
        (versions 1-3), detect and decode, every text read, the CPU's
        quads and texts equal;
     o. seg: examples/segmentation_demo.py (GrabCut, watershed, CamShift)
        at its sizes with its verdict, and at 480x640; card against CPU;
  5. profile: torch.profiler over frames 40-44 of steady tracking of the
     ORB engine and of the klt engine, one two-view
     pair, one calibrate_camera of 20 views, one warm HOG-mode frame
     (detect and track), one warm calibration-app run, stabilize over
     8 frames, one 480x640 panorama and one 480x640 GrabCut iteration
     (device busy share, kernels per unit, top kernels, top host
     operations).
Prints a JSON line of path results (each with its unit and unit count),
a JSON line of kernels, the card line, and last {"ok": true, "device":
{...}}. Exits non-zero on any failure, and without a card.
"""

from __future__ import annotations

import contextlib
import functools
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

# K4's point counts: the LK path's 2000 and 512, DetectionBasedTracker's 32,
# videostab's 200 (GFTT's max_corners)
K4_N = (2000, 512, 32, 200)


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


def warm_runs_of(fn, runs: int) -> tuple[list, list, list]:
    """Run `fn()` warm `runs` times, each between a reset of the launch
    counts and a read of them. Returns the results, the seconds and the
    launch counts, one of each per run."""
    import torch

    from opencv_tpu_torch.ops import cuda as cuda_ops

    outs, secs, counts = [], [], []
    for _ in range(runs):
        cuda_ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts.append(dict(cuda_ops.launch_counts))
    return outs, secs, counts


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
    """K4 at its three sites on the 480x640 level, at the LK path's N =
    2000 and 512 and DetectionBasedTracker's N = 32 (its
    max_track_points), and K5, exact against their plain versions, timed
    beside grid_sample and the bound."""
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
    for n in K4_N:
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
        old = FIRST_DESIGN_MS.get({2000: "lk_sample", 512: "lk_sample_n512"}.get(n))
        first = "" if old is None else f" (first design, a constant: {old} ms)"
        print(f"[K4] three sites, N={n}: kernel {tot['ms']:.4f} ms{first}, plain {tot['plain_ms']:.4f} ms, grid_sample {tot['library_ms']:.4f} ms, bound "
              f"{tot['bound_ms']:.4f} ms ({tot['bound_by']})", flush=True)
    t = per_n[2000]
    rows = {"lk_sample": dict(
        name="lk_sample (K4: bilinear LK windows of C channels, zero outside the image; "
             "the three sites of one level-0 track, summed)",
        route="cuda", source="opencv_tpu_torch/csrc/lk_sample.cu",
        replaces="opencv_tpu/ops/pallas/lk_sample.py:165",
        max_abs_err=err4, ms=t["ms"], plain_ms=t["plain_ms"], library_ms=t["library_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        shapes=[[len(ch), h, w, n, win] for n in K4_N for _, ch, win, _ in sites],
        sites=t["sites"],
        **{f"at_n{n}": {k: per_n[n][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                 "bound_by", "sites")} for n in K4_N[1:]},
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


def phase_main_path(frames, centres, K, warm_runs: int = 2) -> dict:
    import torch

    from opencv_tpu_torch.core.config import ORBConfig
    from opencv_tpu_torch.slam.vo import VisualOdometry, VOConfig
    from opencv_tpu_torch.utils.evaluate import ate_rmse

    cfg = VOConfig(orb=ORBConfig(n_features=2000))
    n = frames.shape[0]
    t0 = time.perf_counter()
    VisualOdometry(K, cfg, seed=0).process_sequence(frames, chunk=8)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0

    def run():
        vo = VisualOdometry(K, cfg, seed=0)
        return vo, vo.process_sequence(frames, chunk=8)

    outs, warm_s, runs = warm_runs_of(run, warm_runs)
    for c in runs:
        for k in ("fast_corners", "knn2_hamming"):
            if c[k] <= 0:
                fail(f"kernel {k} was not launched on the main path")
    (vo, traj), counts = outs[0], runs[0]
    warm = statistics.median(warm_s)

    if traj.shape != (n, 3) or not np.isfinite(traj).all():
        fail(f"trajectory shape {traj.shape} or non-finite values")
    path = float(np.linalg.norm(np.diff(centres, axis=0), axis=1).sum())
    ate = ate_rmse(traj, centres, with_scale=True)
    res = dict(frames=n, units=n, unit="frame", fps_warm=n / warm,
               fps_warm_runs=[n / t for t in warm_s],
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


def phase_lk_path(frames, warm_runs: int = 2, dev: str = "cuda") -> dict:
    """The LK path (bench.py config 2) on the first 100 frames, and its two
    checks: (a) 4 pairs against the same path on the CPU, (b) frame 0
    rolled by (dx, dy) = (5, 3) px, on corners at least 48 px inside
    (the roll wraps the border, and a coarse level's window reaches it)."""
    import torch

    from opencv_tpu_torch.core.config import LKConfig
    from opencv_tpu_torch.ops import gftt, lk

    cfg = LKConfig(win_size=21, n_levels=4)
    clip = torch.from_numpy(np.ascontiguousarray(frames[:100])).to(dev)
    n = clip.shape[0]
    t0 = time.perf_counter()
    lk_config2_run(clip, cfg, dev)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    outs, warm_s, runs = warm_runs_of(lambda: lk_config2_run(clip, cfg, dev), warm_runs)
    if any(c["lk_sample"] <= 0 for c in runs):
        fail("kernel lk_sample was not launched on the LK path")
    (tracked, redetect), counts = outs[0], runs[0]
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

    res = dict(frames=n, units=n, unit="frame", fps_warm=n / warm,
               fps_warm_runs=[n / t for t in warm_s],
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


def phase_klt(frames, centres, K, warm_runs: int = 2) -> dict:
    """The VO engine with the klt tracker, cold then warm `warm_runs`
    times (frames/s is the median warm run, printed with the range)."""
    import torch

    from opencv_tpu_torch.core.config import ORBConfig
    from opencv_tpu_torch.slam.vo import VisualOdometry, VOConfig
    from opencv_tpu_torch.utils.evaluate import ate_rmse

    cfg = VOConfig(orb=ORBConfig(n_features=2000), tracker="klt")
    n = frames.shape[0]
    t0 = time.perf_counter()
    VisualOdometry(K, cfg, seed=0).process_sequence(frames)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    def run():
        vo = VisualOdometry(K, cfg, seed=0)
        return vo, vo.process_sequence(frames)

    outs, warm_s, runs = warm_runs_of(run, warm_runs)
    if any(c["lk_sample"] <= 0 for c in runs):
        fail("kernel lk_sample was not launched by the klt engine")
    (vo, traj), counts = outs[0], runs[0]
    warm = statistics.median(warm_s)
    if traj.shape != (n, 3) or not np.isfinite(traj).all():
        fail(f"klt trajectory shape {traj.shape} or non-finite values")
    path = float(np.linalg.norm(np.diff(centres, axis=0), axis=1).sum())
    ate = ate_rmse(traj, centres, with_scale=True)
    res = dict(frames=n, units=n, unit="frame", fps_warm=n / warm,
               fps_warm_runs=[n / t for t in warm_s],
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


# ------------------------------------------------------------ geometry slice


def _angle_deg(a, b) -> float:
    """Angle between two directions, up to sign, in degrees."""
    a = np.asarray(a, np.float64) / np.linalg.norm(a)
    b = np.asarray(b, np.float64) / np.linalg.norm(b)
    return float(np.degrees(np.arccos(np.clip(abs(a @ b), -1.0, 1.0))))


def _rot_deg(Ra, Rb) -> float:
    """Angle of Ra^T Rb in degrees, by atan2 of its skew and symmetric
    parts (arccos of the trace loses small angles of f32 rotations)."""
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    w = np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return float(np.degrees(np.arctan2(0.5 * np.linalg.norm(w), 0.5 * (np.trace(M) - 1.0))))


def two_view_pipeline(img0, img1, K: np.ndarray, seed: int = 0) -> dict:
    """bench.py config 3 with the reference's default minimal solvers on
    one pair: ORB (2000 features, 8 levels) on both frames, 2-NN matching
    at ratio 0.75, normalized coords; the 5-point RANSAC (1024 hypotheses,
    threshold 2e-3), recoverPose, triangulation and optimal correction;
    EPnP-RANSAC (1024 hypotheses, threshold 3e-3) of frame 1 against the
    triangulated points, VVS refinement, AP3P over the same 1024 samples
    (their first 4 points), and a similarity RANSAC on the pixel matches.
    The RANSAC samples come from a seeded CPU generator and the valid mask
    of their stage, so the card and the CPU score the same samples where
    their masks agree (each draw reads the mask back to the host)."""
    import torch

    from opencv_tpu_torch.core.config import MatchConfig, ORBConfig, RansacConfig
    from opencv_tpu_torch.geometry import affine2d, ap3p, epipolar, pnp, ransac
    from opencv_tpu_torch.ops import matching, orb

    dev = img0.device
    cfg = ORBConfig(n_features=2000, n_levels=8)
    kp0, d0 = orb.detect_and_compute(img0, cfg)
    kp1, d1 = orb.detect_and_compute(img1, cfg)
    m = matching.knn_match(d0, d1, kp0.valid, kp1.valid, MatchConfig(ratio=0.75))
    Kt = torch.as_tensor(K, device=dev)
    px0, px1 = kp0.xy[m.query_idx], kp1.xy[m.train_idx]
    p0, p1 = epipolar.normalize_pixels(px0, Kt), epipolar.normalize_pixels(px1, Kt)
    n = p0.shape[0]

    def draw(valid, h, size, k):
        g = torch.Generator().manual_seed(seed + k)
        return ransac.sample_subsets(g, n, valid.cpu(), h, size).to(dev)

    ess = epipolar.find_essential_ransac_5pt(None, p0, p1, m.valid, RansacConfig(1024, 2e-3),
                                            subsets=draw(m.valid, 1024, 5, 0))
    rec = epipolar.recover_pose(ess.model, p0, p1, ess.inliers)
    X = epipolar.triangulate_normalized(rec.R, rec.t, p0, p1)
    c0, c1 = epipolar.correct_matches(ess.model, p0, p1)
    sub5 = draw(rec.mask, 1024, 5, 1)
    pose = pnp.solve_pnp_ransac(None, X, p1, valid=rec.mask, cfg=RansacConfig(1024, 3e-3),
                                kernel="epnp", adaptive=False, subsets=sub5)
    rv, tv = pnp.refine_pose_vvs(pose.rvec, pose.tvec, X, p1, pose.inliers.to(torch.float32))
    _, ap3p_ok = ap3p.ap3p_kernel(X[sub5[:, :4]], p1[sub5[:, :4]])
    sim = affine2d.estimate_affine_partial_2d(None, px0, px1, m.valid, subsets=draw(m.valid, 512, 2, 2))
    both = rec.mask
    return dict(n_matches=m.valid.sum(), ess=ess, rec=rec, pose=pose, vvs=(rv, tv),
                ap3p_ok=ap3p_ok.sum(), sim=sim,
                corr_shift=((c0 - p0).abs().amax(-1) + (c1 - p1).abs().amax(-1))[both].max()
                if bool(both.any()) else torch.zeros(()),
                kp0=kp0.xy, mask=rec.mask)


def phase_two_view(frames, K, warm_runs: int = 3, dev: str = "cuda") -> dict:
    """Two-view SfM on frames 0 and 8 of the scene (ground truth from
    make_sequence: frame i has centre (0.12 i, 0, 0.03 i) and yaw 0.15 i
    degrees), cold then warm `warm_runs` times; the same path on the CPU
    with the same samples."""
    import torch

    from opencv_tpu_torch.slam.vo import _np_rodrigues

    a, b = 0, 8
    R_gt = _np_rodrigues(np.array([0.0, np.deg2rad(0.15 * b), 0.0]))
    t_gt = -R_gt @ np.array([0.12 * b, 0.0, 0.03 * b])
    imgs = [torch.from_numpy(np.ascontiguousarray(frames[i])).to(dev) for i in (a, b)]
    t0 = time.perf_counter()
    two_view_pipeline(*imgs, K)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    outs, warm_s, runs = warm_runs_of(lambda: two_view_pipeline(*imgs, K), warm_runs)
    card, counts = outs[0], runs[0]
    if counts["fast_corners"] <= 0:
        fail("kernel fast_corners was not launched on the two-view path")
    t0 = time.perf_counter()
    cpu = two_view_pipeline(*(x.cpu() for x in imgs), K)
    cpu_s = time.perf_counter() - t0

    def summary(o):
        R, t = o["rec"].R.cpu().numpy(), o["rec"].t.cpu().numpy()
        pose_R = _np_rodrigues(o["pose"].rvec.cpu().numpy())
        keep = (o["pose"].inliers & o["mask"]).sum() / max(int(o["mask"].sum()), 1)
        return dict(R=R, t=t, rot_err_deg=_rot_deg(R, R_gt), t_dir_err_deg=_angle_deg(t, t_gt),
                    pnp_rot_err_deg=_rot_deg(pose_R, R_gt), pnp_keeps=float(keep),
                    matches=int(o["n_matches"]), ess_inliers=int(o["ess"].n_inliers),
                    pose_inliers=int(o["rec"].n_good), pnp_inliers=int(o["pose"].n_inliers),
                    ap3p_ok=int(o["ap3p_ok"]), sim_inliers=int(o["sim"].n_inliers),
                    corr_max_shift=float(o["corr_shift"]))

    g, c = summary(card), summary(cpu)
    kp_same = float((card["kp0"].cpu() == cpu["kp0"]).all(-1).float().mean())
    d_rot, d_dir = _rot_deg(g["R"], c["R"]), _angle_deg(g["t"], c["t"])
    warm = statistics.median(warm_s)
    res = dict(units=1, unit="pair", pairs_per_s=1.0 / warm, pairs_per_s_runs=[1.0 / t for t in warm_s],
               warm_s=warm, cold_s=cold, cpu_s=cpu_s, card_vs_cpu_rot_deg=d_rot,
               card_vs_cpu_t_dir_deg=d_dir, kp_equal_share=kp_same, launches=counts,
               **{k: v for k, v in g.items() if k not in ("R", "t")},
               cpu={k: v for k, v in c.items() if k not in ("R", "t")})
    print(f"[twoview] frames {a},{b} 480x640: {g['matches']} matches; 5-point {g['ess_inliers']} inliers, "
          f"recoverPose {g['pose_inliers']}; rotation error {g['rot_err_deg']:.4f} deg, translation "
          f"direction error {g['t_dir_err_deg']:.4f} deg; EPnP-RANSAC {g['pnp_inliers']} inliers "
          f"({100 * g['pnp_keeps']:.1f} % of recoverPose's mask), rotation error "
          f"{g['pnp_rot_err_deg']:.4f} deg; AP3P {g['ap3p_ok']} of 1024 samples solved; similarity "
          f"{g['sim_inliers']} inliers; correction moves a match by at most {g['corr_max_shift']:.2e}",
          flush=True)
    print(f"[twoview] warm {warm:.4f} s ({1.0 / warm:.2f} pairs/s, median of {warm_runs} runs, range "
          f"{1.0 / max(warm_s):.2f} to {1.0 / min(warm_s):.2f}), cold {cold:.3f} s; CPU {cpu_s:.3f} s; "
          f"card vs CPU: rotation {d_rot:.5f} deg, translation direction {d_dir:.5f} deg, keypoints "
          f"equal {100 * kp_same:.2f} %, CPU errors {c['rot_err_deg']:.4f} / {c['t_dir_err_deg']:.4f} "
          f"deg; launches {counts}", flush=True)
    if not (g["rot_err_deg"] < 1.0 and g["t_dir_err_deg"] < 3.0):
        fail(f"two-view pose error {g['rot_err_deg']:.3f} deg / {g['t_dir_err_deg']:.3f} deg "
             "(bounds 1 and 3 deg)")
    if not g["pnp_keeps"] >= 0.8:
        fail(f"EPnP-RANSAC keeps only {g['pnp_keeps']:.3f} of recoverPose's mask (bound 0.8)")
    if not (d_rot < 0.05 and d_dir < 0.2):
        fail(f"two-view card vs CPU: rotation {d_rot} deg (bound 0.05), direction {d_dir} deg (bound 0.2)")
    return res


CALIB_K = np.array([[520.0, 0, 326.0], [0, 525.2, 236.0], [0, 0, 1]], np.float32)
CALIB_DIST = np.array([-0.2, 0.05, 0.001, -0.001, 0.0], np.float32)
FISHEYE_K = np.array([0.08, -0.03, 0.01, 0.0], np.float32)


def calib_views(n_views: int = 20, seed: int = 0):
    """The OpenCV tutorial's 9x6 inner-corner board (0.1 m squares) at the
    distances and offsets of examples/calibration_app.py (2.1-2.9 m,
    +-0.2 / +-0.15 m, roll +-0.35 rad), tilted up to +-0.75 rad about x
    and y (the tutorial asks for views at up to ~45 degrees; the
    example's +-0.35 rad constrains the focal length poorly),
    projected through CALIB_K with CALIB_DIST (camera 1), from a second
    camera 0.12 m to the right with a 1 degree yaw (camera 2), and through
    the fisheye model; 0.2 px of seeded noise on each. Returns (obj
    [V,54,3], img1, img2, fisheye, (R12, T12), true poses)."""
    import torch

    from opencv_tpu_torch.geometry import calibration
    from opencv_tpu_torch.slam.vo import _np_rodrigues, _np_rodrigues_inv

    rng = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.arange(9), np.arange(6))
    obj = np.zeros((54, 3), np.float32)
    obj[:, 0] = jj.reshape(-1) * 0.1
    obj[:, 1] = ii.reshape(-1) * 0.1
    R12 = _np_rodrigues(np.array([0.0, np.deg2rad(1.0), 0.0]))
    T12 = -R12 @ np.array([0.12, 0.0, 0.0])
    k4 = torch.tensor([CALIB_K[0, 0], CALIB_K[1, 1], CALIB_K[0, 2], CALIB_K[1, 2]])
    o = torch.from_numpy(obj)
    img1, img2, fish, poses = [], [], [], []
    for _ in range(n_views):
        rv = np.concatenate([rng.uniform(-0.75, 0.75, 2), rng.uniform(-0.35, 0.35, 1)])
        tv = np.array([rng.uniform(-0.2, 0.2), rng.uniform(-0.15, 0.15), rng.uniform(2.1, 2.9)])
        R2 = R12 @ _np_rodrigues(rv)
        views = [(rv, tv), (_np_rodrigues_inv(R2), R12 @ tv + T12)]
        for out, (r, t) in zip((img1, img2), views):
            uv = calibration.project_points_full(torch.tensor(r, dtype=torch.float32),
                                                 torch.tensor(t, dtype=torch.float32), k4,
                                                 torch.from_numpy(CALIB_DIST), o).numpy()
            out.append(uv + rng.normal(0, 0.2, uv.shape))
        uv = calibration.fisheye_project_points(torch.tensor(rv, dtype=torch.float32),
                                                torch.tensor(tv, dtype=torch.float32), k4,
                                                torch.from_numpy(FISHEYE_K), o).numpy()
        fish.append(uv + rng.normal(0, 0.2, uv.shape))
        poses.append((rv, tv))
    f32 = lambda x: np.stack(x).astype(np.float32)  # noqa: E731
    return np.stack([obj] * n_views), f32(img1), f32(img2), f32(fish), (R12, T12), poses


def calib_pipeline(objs, img1, img2, fish, frame, dev) -> dict:
    """calibrate_camera, IPPE per view on the undistorted corners,
    stereo_calibrate with the calibrated lens on both cameras,
    stereo_rectify, both rectification maps, remap of the frame, and
    calibrate_fisheye."""
    import torch

    from opencv_tpu_torch.core import imgproc
    from opencv_tpu_torch.geometry import calibration, decompose, ippe

    cal = calibration.calibrate_camera(objs, img1, device=dev)
    Kt = torch.from_numpy(cal.K).to(dev)
    dt = torch.from_numpy(cal.dist).to(dev)
    und = calibration.undistort_points(torch.from_numpy(img1).to(dev), Kt, dt)
    o = torch.from_numpy(objs[0]).to(dev)
    ippe_r = torch.stack([ippe.solve_pnp_ippe(o, und[v]).rvecs[0] for v in range(objs.shape[0])])
    st = calibration.stereo_calibrate(objs, img1, img2, cal.K, cal.dist, cal.K, cal.dist, device=dev)
    rect = decompose.stereo_rectify(Kt, Kt, torch.from_numpy(st.R).to(dev), torch.from_numpy(st.T).to(dev),
                                    frame.shape[-2:])
    maps = [calibration.init_undistort_rectify_map(Kt, dt, R, P[:, :3], tuple(frame.shape[-2:]))
            for R, P in ((rect.R1, rect.P1), (rect.R2, rect.P2))]
    rectified = [imgproc.remap(frame, m) for m in maps]
    fe = calibration.calibrate_fisheye(objs, fish, device=dev)
    return dict(cal=cal, ippe_r=ippe_r.cpu().numpy(), st=st, maps=maps, rectified=rectified, fe=fe,
                lens=(Kt, dt), rect=rect)


def phase_calib(frame0, warm_runs: int = 1, dev: str = "cuda") -> dict:
    """Camera, stereo and fisheye calibration of 20 views at 480x640, then
    rectification of frame 0; on the card (cold, then warm) and once on
    the CPU."""
    import torch

    from opencv_tpu_torch.core import imgproc
    from opencv_tpu_torch.geometry import calibration
    from opencv_tpu_torch.slam.vo import _np_rodrigues

    objs, img1, img2, fish, (R12, T12), poses = calib_views()
    frame = torch.from_numpy(np.ascontiguousarray(frame0)).to(dev)
    t0 = time.perf_counter()
    calib_pipeline(objs, img1, img2, fish, frame, dev)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    outs, secs, runs = warm_runs_of(lambda: calib_pipeline(objs, img1, img2, fish, frame, dev), warm_runs)
    g, counts, warm = outs[0], runs[0], statistics.median(secs)
    t0 = time.perf_counter()
    c = calib_pipeline(objs, img1, img2, fish, frame.cpu(), "cpu")
    cpu_s = time.perf_counter() - t0

    K, st, fe = g["cal"].K, g["st"], g["fe"]
    f_err = [abs(K[0, 0] - CALIB_K[0, 0]) / CALIB_K[0, 0], abs(K[1, 1] - CALIB_K[1, 1]) / CALIB_K[1, 1]]
    base = float(np.linalg.norm(st.T))
    ippe_err = max(_rot_deg(_np_rodrigues(r), _np_rodrigues(p[0])) for r, p in zip(g["ippe_r"], poses))
    stereo_rot = _rot_deg(st.R, R12)
    d_K = float(np.abs(K - c["cal"].K).max())
    # the maps on both devices from the card's calibration, and remap on
    # both devices of the card's maps (bit-equal: the same f32 ops); each
    # device's own calibration and maps, printed beside
    Kt, dt = (x.cpu() for x in g["lens"])
    rect = g["rect"]
    cpu_maps = [calibration.init_undistort_rectify_map(Kt, dt, R.cpu(), P[:, :3].cpu(),
                                                       tuple(frame.shape[-2:]))
                for R, P in ((rect.R1, rect.P1), (rect.R2, rect.P2))]
    d_map = max(float((a.cpu() - b).abs().max()) for a, b in zip(g["maps"], cpu_maps))
    same_map = max(float((imgproc.remap(frame.cpu(), m.cpu()) - r.cpu()).abs().max())
                   for m, r in zip(g["maps"], g["rectified"]))
    own_maps = max(float((a.cpu() - b).abs().max()) for a, b in zip(g["maps"], c["maps"]))
    own_map = max(float((a.cpu() - b).abs().max()) for a, b in zip(g["rectified"], c["rectified"]))
    d_dist = float(np.abs(g["cal"].dist - c["cal"].dist).max())
    res = dict(units=objs.shape[0], unit="view", warm_s=warm, cold_s=cold, cpu_s=cpu_s,
               rms=g["cal"].rms, fx_rel_err=float(f_err[0]), fy_rel_err=float(f_err[1]),
               dist=g["cal"].dist.tolist(), ippe_max_rot_err_deg=ippe_err, stereo_rms=st.rms,
               baseline=base, stereo_rot_err_deg=stereo_rot, fisheye_rms=fe.rms,
               fisheye_f_rel_err=float(abs(fe.K[0, 0] - CALIB_K[0, 0]) / CALIB_K[0, 0]),
               card_vs_cpu_K_px=d_K, card_vs_cpu_dist=d_dist, card_vs_cpu_map_px=d_map,
               card_vs_cpu_remap=same_map, own_calibrations_map_px=own_maps,
               own_calibrations_remap=own_map, launches=counts)
    print(f"[calib] 20 views x 54 corners: RMS {g['cal'].rms:.4f} px, fx {K[0, 0]:.3f} fy {K[1, 1]:.3f} "
          f"(truth {CALIB_K[0, 0]:.1f} / {CALIB_K[1, 1]:.1f}; {100 * f_err[0]:.3f} / {100 * f_err[1]:.3f} %), "
          f"cx {K[0, 2]:.3f} cy {K[1, 2]:.3f}, dist {np.round(g['cal'].dist, 4).tolist()}; IPPE rotation "
          f"error <= {ippe_err:.4f} deg; stereo RMS {st.rms:.4f} px, baseline {base:.5f} m (truth 0.12), "
          f"rotation error {stereo_rot:.4f} deg; fisheye RMS {fe.rms:.4f} px, fx {fe.K[0, 0]:.3f}", flush=True)
    print(f"[calib] card {warm:.3f} s warm, {cold:.3f} s cold; CPU {cpu_s:.3f} s; card vs CPU: K "
          f"{d_K:.2e} px, dist {d_dist:.2e}; maps from the card's calibration {d_map:.2e} px; remap "
          f"of the card's maps {same_map:.2e}; from each device's own calibration: maps "
          f"{own_maps:.2e} px, remap {own_map:.2e}; launches {counts}", flush=True)
    if not g["cal"].rms < 0.35:
        fail(f"calibration RMS {g['cal'].rms:.4f} px (bound 0.35)")
    if not max(f_err) < 0.01:
        fail(f"calibrated focal lengths off by {max(f_err):.4f} (bound 1 %)")
    if not abs(base - 0.12) < 0.0012:
        fail(f"stereo baseline {base:.5f} m (truth 0.12, bound 1 %)")
    if not (d_K < 0.05 and d_map < 1e-3 and same_map < 1e-3):
        fail(f"calibration card vs CPU: K {d_K} px, maps {d_map} px, remap {same_map}")
    return res


def phase_lsh(frames, n_db: int = 64, dev: str = "cuda") -> dict:
    """A map-scale LSH index: the ORB descriptors of frames 0..n_db-1 (the
    VO engine's retrieval database of 64 keyframes x 2000) with JAX's
    defaults (8 tables, 14 key bits, capacity 64). Queries (a): 2000 rows
    with 12 of 256 bits flipped; (b): frame n_db's ORB descriptors. Each
    against the exact 2-NN through K3 (ratio 0.9, max distance 64); the
    card's matches against the CPU's for the same index; query times."""
    import torch

    from opencv_tpu_torch.core.config import MatchConfig, ORBConfig
    from opencv_tpu_torch.ops import cuda as cuda_ops
    from opencv_tpu_torch.ops import lsh, matching, orb
    from opencv_tpu_torch.ops.cuda import knn

    cfg = MatchConfig(ratio=0.9, max_distance=64.0, cross_check=False)
    orb_cfg = ORBConfig(n_features=2000)
    rng = np.random.default_rng(64)
    cuda_ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    descs, valids = [], []
    for f in range(n_db + 1):
        kp, d = orb.detect_and_compute(torch.from_numpy(np.ascontiguousarray(frames[f])).to(dev), orb_cfg)
        descs.append(d)
        valids.append(kp.valid)
    torch.cuda.synchronize()
    orb_s = time.perf_counter() - t0
    db = torch.cat(descs[:n_db])[torch.cat(valids[:n_db])]
    train_np = db.cpu().numpy().view(np.uint32)
    t0 = time.perf_counter()
    index = lsh.build_lsh_index(train_np, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    qa = train_np[rng.choice(train_np.shape[0], 2000, replace=False)].copy()
    for row in qa:
        for bit in rng.integers(0, 256, 12):
            row[bit // 32] ^= np.uint32(1) << np.uint32(bit % 32)
    queries = {"a": (torch.from_numpy(qa.view(np.int32)).to(dev), None),
               "b": (descs[n_db], valids[n_db])}
    out = {}
    for name, (q, qv) in queries.items():
        exact = matching.knn_match_auto(q, db, qv, None, cfg)
        approx = lsh.knn_match_lsh(index, q, qv, cfg)
        ev, av = exact.valid.cpu().numpy(), approx.valid.cpu().numpy()
        agree = (exact.train_idx == approx.train_idx).cpu().numpy()
        out[name] = dict(exact=exact, approx=approx, recall=float((av & agree)[ev].mean()),
                         false_pos=float((av & ~ev).mean()), exact_valid=int(ev.sum()),
                         lsh_valid=int(av.sum()))
    torch.cuda.synchronize()
    counts = dict(cuda_ops.launch_counts)
    if counts["knn2_hamming"] <= 0 or counts["fast_corners"] <= 0:
        fail(f"the LSH path did not launch K1 and K3: {counts}")

    t0 = time.perf_counter()
    index_cpu = lsh.build_lsh_index(train_np, device="cpu")
    cpu_build_s = time.perf_counter() - t0
    if not torch.equal(index_cpu.buckets, index.buckets.cpu()):
        fail("LSH tables built for the card and the CPU differ")
    for name, (q, qv) in queries.items():
        cm = lsh.knn_match_lsh(index_cpu, q.cpu(), None if qv is None else qv.cpu(), cfg)
        gm = out[name]["approx"]
        for field in ("train_idx", "distance", "valid"):
            if not torch.equal(getattr(cm, field), getattr(gm, field).cpu()):
                fail(f"LSH matches of queries ({name}) differ between the card and the CPU ({field})")
    q_a = queries["a"][0]
    lsh_ms = device_time_ms(lambda: lsh.knn_match_lsh(index, q_a, None, cfg), calls=5)
    k3_ms = device_time_ms(lambda: knn.knn2_hamming_cuda(q_a, db), calls=5)
    a, b = out["a"], out["b"]
    res = dict(units=4000, unit="query", db_rows=int(db.shape[0]), orb_s=orb_s, build_s=build_s,
               cpu_build_s=cpu_build_s, lsh_query_ms=lsh_ms, k3_query_ms=k3_ms,
               **{f"{k}_{n}": out[n][k] for n in ("a", "b")
                  for k in ("recall", "false_pos", "exact_valid", "lsh_valid")},
               launches=counts)
    print(f"[lsh] index of {db.shape[0]} ORB descriptors (frames 0-{n_db - 1}; ORB {orb_s:.2f} s for "
          f"{n_db + 1} frames), 8 tables x 14 bits x 64: built in {build_s:.3f} s (CPU {cpu_build_s:.3f} s), "
          f"tables equal on both devices; (a) 2000 rows with 12 bits flipped: recall {a['recall']:.4f}, "
          f"false positives {a['false_pos']:.4f} (exact {a['exact_valid']}, LSH {a['lsh_valid']} valid); "
          f"(b) frame {n_db}: recall {b['recall']:.4f}, false positives {b['false_pos']:.4f} (exact "
          f"{b['exact_valid']}, LSH {b['lsh_valid']}); card matches equal the CPU's; 2000 queries: LSH "
          f"{lsh_ms:.4f} ms, K3 exact {k3_ms:.4f} ms; launches {counts}", flush=True)
    if not (a["recall"] > 0.85 and a["false_pos"] < 0.05):
        fail(f"LSH near-duplicate recall {a['recall']:.4f} (bound 0.85) or false positives "
             f"{a['false_pos']:.4f} (bound 0.05)")
    return res


# ------------------------------------------------------------ tracking and lanes slice

WARM_RUNS = 2  # warm runs of each path of this slice, after one cold run
# hog's and dbt's cold run takes the scene's first 8 frames: they load every
# kernel and cuDNN plan of the warm runs (all 28 scales; detector frames
# and LK frames) at a fraction of a whole run's time
COLD_FRAMES = 8
METRICS_FROM = 5  # MotMetrics from this frame on, as examples/tbd_app.py


def _sum_counts(*counts: dict) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def tbd_app_gt() -> list[np.ndarray]:
    """examples/tbd_app.py's scene over 60 frames: [T, N, 4] boxes of its
    three pedestrians (class 0) and two vehicles (class 1)."""
    t = np.arange(60, dtype=np.float32)[:, None]
    one = np.ones_like(t)
    peds = np.stack([np.concatenate([20 + 3.0 * t, 40 + 0.5 * t, 14 * one, 30 * one], 1),
                     np.concatenate([300 - 2.5 * t, 60 * one, 14 * one, 30 * one], 1),
                     np.concatenate([40 + 2.0 * t, 120 * one, 14 * one, 30 * one], 1)], 1)
    veh = np.stack([np.concatenate([10 + 6.0 * t, 200 * one, 40 * one, 24 * one], 1),
                    np.concatenate([500 - 5.0 * t, 230 * one, 44 * one, 26 * one], 1)], 1)
    return [peds.astype(np.float32), veh.astype(np.float32)]


def crowd_gt() -> list[np.ndarray]:
    """A MOT17-like crowd on a 480x640 frame over 120 frames: 32
    pedestrians 18-28 x 44-64 px walking at 0.3-1.5 px/frame and 8
    vehicles 48-72 x 28-40 px at 2-5 px/frame, each at constant velocity,
    bouncing off the frame's edges. [T, N, 4] boxes per class."""
    rng = np.random.default_rng(17)
    h, w = 480, 640
    out = []
    for n, (w_lo, w_hi), (h_lo, h_hi), (s_lo, s_hi) in (
            (32, (18, 28), (44, 64), (0.3, 1.5)), (8, (48, 72), (28, 40), (2.0, 5.0))):
        size = np.stack([rng.uniform(w_lo, w_hi, n), rng.uniform(h_lo, h_hi, n)], 1)
        pos = rng.uniform(0, 1, (n, 2)) * ([w, h] - size)
        ang = rng.uniform(0, 2 * np.pi, n)
        vel = rng.uniform(s_lo, s_hi, n)[:, None] * np.stack([np.cos(ang), 0.4 * np.sin(ang)], 1)
        boxes = []
        for _ in range(120):
            boxes.append(np.concatenate([pos, size], 1))
            pos = pos + vel
            hi = [w, h] - size
            vel = np.where((pos < 0) | (pos > hi), -vel, vel)
            pos = np.clip(pos, 0, hi)
        out.append(np.stack(boxes).astype(np.float32))
    return out


def tbd_run(gts: list[np.ndarray], history: str = "1", dev: str = "cuda") -> dict:
    """examples/tbd_app.py's frame loop on ground-truth boxes `gts` (one
    [T, N, 4] array per class, one Tracker each): detections are the boxes
    jittered by 0.8 px with 15 % dropped; under a history distribution
    such as "7,3" each step restores the track snapshot of 1 or 2 frames
    back (the ISORC'20 stale-state experiment, tbd.cpp:173,645-704);
    MotMetrics from frame METRICS_FROM. Returns the metrics, the
    tracking-only seconds and each frame's confirmed (ids, boxes)."""
    from opencv_tpu_torch.tbd import MotMetrics, TbdConfig, Tracker

    rng = np.random.default_rng(0)
    dist = np.array([float(v) for v in history.split(",")], np.float64)
    dist /= dist.sum()
    hlen = len(dist)
    trackers = [Tracker(TbdConfig(), device=dev) for _ in gts]
    metrics = [MotMetrics(device=dev) for _ in gts]
    bufs = [[None] * hlen for _ in gts]
    log, t_track = [], 0.0
    for t in range(gts[0].shape[0]):
        dets = []
        for g in gts:
            keep = rng.random(len(g[t])) > 0.15
            dets.append(g[t][keep] + rng.normal(0, 0.8, (keep.sum(), 4)).astype(np.float32))
        age = int(rng.choice(hlen, p=dist)) + 1
        t0 = time.perf_counter()
        confirmed = []
        for c, trk in enumerate(trackers):
            if hlen > 1:
                snap = bufs[c][(t - age) % hlen] if t >= age else None
                if snap is not None:
                    trk.set_tracks(snap)
                else:
                    trk.reset()
            confirmed.append(trk.step(dets[c]))
            if hlen > 1:
                bufs[c][t % hlen] = trk.get_tracks()
        t_track += time.perf_counter() - t0
        frame_log = []
        for c, conf in enumerate(confirmed):
            boxes = np.stack([tr.bbox for tr in conf]) if conf else np.zeros((0, 4), np.float32)
            frame_log.append(([tr.track_id for tr in conf], boxes))
            if t >= METRICS_FROM and conf:
                metrics[c].update(boxes, gts[c][t])
        log.append(frame_log)
    return dict(metrics=metrics, t_track=t_track, frames=gts[0].shape[0], log=log)


def _tbd_card_vs_cpu(card: dict, cpu: dict) -> float:
    """Largest box difference (px) between two tbd_run logs; fails on
    other confirmed track IDs or other MOT counters."""
    worst = 0.0
    for t, (fa, fb) in enumerate(zip(card["log"], cpu["log"])):
        for c, ((ia, ba), (ib, bb)) in enumerate(zip(fa, fb)):
            if ia != ib:
                fail(f"tbd: frame {t} class {c}: confirmed IDs {ia} on the card, {ib} on the CPU")
            if len(ba):
                worst = max(worst, float(np.abs(ba - bb).max()))
    for ma, mb in zip(card["metrics"], cpu["metrics"]):
        if (ma.tp, ma.fp, ma.fn, ma.gt) != (mb.tp, mb.fp, mb.fn, mb.gt):
            fail(f"tbd: MOT counters differ: card {(ma.tp, ma.fp, ma.fn, ma.gt)}, "
                 f"CPU {(mb.tp, mb.fp, mb.fn, mb.gt)}")
    return worst


def phase_tbd(dev: str = "cuda") -> dict:
    """The TBD app (examples/tbd_app.py) on ground-truth detections: its
    scene under history distributions "1" and "7,3" (MOTA > 0.8 for both
    classes, the app's own bound), then a crowd of 32 pedestrians and 8
    vehicles over 120 frames; each cold, then warm WARM_RUNS times, then
    on the CPU: the same confirmed IDs, equal MOT counters, boxes within
    1e-3 px."""
    import torch

    scenes = {"app_history_1": (tbd_app_gt(), "1"), "app_history_7_3": (tbd_app_gt(), "7,3"),
              "crowd_32_8": (crowd_gt(), "1")}
    res, all_counts, frames = {}, [], 0
    for name, (gts, history) in scenes.items():
        t0 = time.perf_counter()
        tbd_run(gts, history, dev=dev)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        outs, secs, runs = warm_runs_of(lambda: tbd_run(gts, history, dev=dev), WARM_RUNS)
        all_counts.append(runs[0])
        card = outs[0]
        worst = _tbd_card_vs_cpu(card, tbd_run(gts, history, dev="cpu"))
        n = card["frames"]
        frames += n
        m = card["metrics"]
        track_fps = [o["frames"] / o["t_track"] for o in outs]
        res[name] = dict(frames=n, history=history, mota=[x.mota for x in m], motp=[x.motp for x in m],
                         counters=[dict(tp=x.tp, fp=x.fp, fn=x.fn, gt=x.gt) for x in m],
                         tracking_fps=statistics.median(track_fps), tracking_fps_runs=track_fps,
                         frame_fps=n / statistics.median(secs), cold_s=cold, card_vs_cpu_px=worst)
        print(f"[tbd] {name}: {n} frames, {sum(g.shape[1] for g in gts)} objects in {len(gts)} classes, "
              f"history '{history}': MOTA {', '.join(f'{x.mota:.4f}' for x in m)}, MOTP "
              f"{', '.join(f'{x.motp:.4f}' for x in m)} (classes 0, 1); counters "
              f"{res[name]['counters']}; tracking-only {res[name]['tracking_fps']:.1f} frames/s (median of "
              f"{WARM_RUNS}, range {min(track_fps):.1f} to {max(track_fps):.1f}), whole loop "
              f"{res[name]['frame_fps']:.1f} frames/s, cold {cold:.3f} s; card vs CPU: IDs and counters "
              f"equal, boxes within {worst:.2e} px", flush=True)
        if not worst <= 1e-3:
            fail(f"tbd {name}: card boxes {worst} px from the CPU's (bound 1e-3)")
        if name.startswith("app") and not min(x.mota for x in m) > 0.8:
            fail(f"tbd {name}: MOTA {[x.mota for x in m]} (bound 0.8 for both classes)")
    return dict(units=frames, unit="frame", scenes=res, launches=_sum_counts(*all_counts))


def make_bar_window(rng, on: bool = True) -> np.ndarray:
    """tests/test_hog.py's 64x128 training window: a bright vertical bar
    (a crude pedestrian) on noise, or noise blobs."""
    img = rng.uniform(0, 40, size=(128, 64)).astype(np.float32)
    if on:
        x = rng.integers(24, 40)
        wbar = rng.integers(10, 16)
        img[20:110, x - wbar // 2: x + wbar // 2] += rng.uniform(120, 200)
    else:
        for _ in range(6):
            y, x = rng.integers(10, 110), rng.integers(5, 55)
            img[y: y + 8, x: x + 8] += rng.uniform(60, 150)
    return img


@functools.lru_cache(maxsize=None)
def fit_bar_svm(dev: str) -> tuple[np.ndarray, float]:
    """tests/test_hog.py's linear "SVM": ridge regression (lambda 1e-2, in
    f64 on the host) on the port's descriptors of 60 + 60 windows. Fitted
    once per device: the hog path times the fit, later users share it."""
    from opencv_tpu_torch.ops import hog

    rng = np.random.default_rng(11)
    X, y = [], []
    for _ in range(60):
        for on, label in ((True, 1.0), (False, -1.0)):
            X.append(hog.compute_descriptor(make_bar_window(rng, on), device=dev).cpu().numpy())
            y.append(label)
    X, y = np.stack(X).astype(np.float64), np.asarray(y)
    w = np.linalg.solve(X.T @ X + 1e-2 * np.eye(X.shape[1]), X.T @ y)
    return w.astype(np.float32), float(-(X @ w).mean())


def bar_scene(n_frames: int = 120):
    """Six window-sized bar pedestrians on fresh noise each 480x640 frame,
    in two rows of three: the top row walks right at 1.0 px/frame, the
    bottom row left, both down at 0.1 px/frame; boxes stay a window apart.
    Returns (frames f32 [T, H, W], boxes [T, 6, 4])."""
    rng = np.random.default_rng(5)
    starts = np.array([(40, 20), (232, 20), (424, 20), (160, 300), (352, 300), (544, 300)], np.float64)
    vel = np.array([(1.0, 0.1)] * 3 + [(-1.0, 0.1)] * 3)
    frames = rng.uniform(0, 40, size=(n_frames, 480, 640)).astype(np.float32)
    boxes = np.zeros((n_frames, 6, 4), np.float32)
    for t in range(n_frames):
        for i, (x, y) in enumerate(starts + t * vel):
            xi, yi = int(round(x)), int(round(y))
            frames[t, yi + 20: yi + 110, xi + 26: xi + 38] += 160.0
            boxes[t, i] = (x, y, 64, 128)
    return frames, boxes


def group_detections(boxes: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """The app's merge of overlapping hits: the reference's
    detectMultiScale groups the windows of neighbouring positions and
    scales (groupRectangles); here greedily, best score first, a box
    overlapping a kept one by IoU > 0.3 is dropped."""
    order = np.argsort(-scores, kind="stable")
    kept = []
    for i in order:
        b = boxes[i]
        ok = True
        for k in kept:
            x1, y1 = max(b[0], k[0]), max(b[1], k[1])
            x2, y2 = min(b[0] + b[2], k[0] + k[2]), min(b[1] + b[3], k[1] + k[3])
            inter = max(x2 - x1, 0) * max(y2 - y1, 0)
            if inter / (b[2] * b[3] + k[2] * k[3] - inter) > 0.3:
                ok = False
                break
        if ok:
            kept.append(b)
    return np.array(kept, np.float32).reshape(-1, 4)


HOG_KW = dict(scale0=1.05, n_scales=64, hit_threshold=0.0)  # the reference cuda HOG's defaults


def hog_detect(img, w, b):
    """One frame's grouped HOG detections [D, 4] on the host."""
    from opencv_tpu_torch.ops import hog

    det = hog.detect_multi_scale(img, w, b, **HOG_KW)
    valid = det.valid.cpu().numpy()
    return group_detections(det.boxes.cpu().numpy()[valid], det.scores.cpu().numpy()[valid])


def hog_app_run(frames_dev, gt: np.ndarray, w, b) -> dict:
    """The TBD app in HOG mode: per frame detectMultiScale on the card,
    the grouped hits to a Tracker, MotMetrics against the planted boxes
    from frame METRICS_FROM. Returns the metrics, the detection seconds
    (hogWorkFps's span, synchronised) and the seconds of the whole loop."""
    import torch

    from opencv_tpu_torch.tbd import MotMetrics, TbdConfig, Tracker

    dev = frames_dev.device
    trk, mot = Tracker(TbdConfig(), device=dev), MotMetrics(device=dev)
    t_det, n_det = 0.0, 0
    t_all = time.perf_counter()
    for t in range(frames_dev.shape[0]):
        t0 = time.perf_counter()
        det = hog_detect(frames_dev[t], w, b)
        torch.cuda.synchronize()
        t_det += time.perf_counter() - t0
        n_det += len(det)
        conf = trk.step(det)
        if t >= METRICS_FROM and conf:
            mot.update(np.stack([tr.bbox for tr in conf]), gt[t])
    return dict(metrics=mot, det_s=t_det, all_s=time.perf_counter() - t_all,
                detections=n_det / frames_dev.shape[0])


def phase_hog(dev: str = "cuda", n_frames: int = 120) -> dict:
    """The TBD app in HOG mode on the bar scene at 480x640: the SVM fitted
    on the port's descriptors, detectMultiScale at the reference's
    defaults (28 scales fit 480x640), grouped hits, a Tracker, MOTA
    against the planted boxes; HOG detection frames/s and frame frames/s;
    cold on COLD_FRAMES frames, then warm WARM_RUNS times. Card against
    CPU on 4 frames (the same boxes, scores within 1e-3)."""
    import torch

    from opencv_tpu_torch.ops import hog

    t0 = time.perf_counter()
    w_np, b = fit_bar_svm(dev)
    fit_s = time.perf_counter() - t0
    w = torch.from_numpy(w_np).to(dev)
    frames, gt = bar_scene(n_frames)
    frames_dev = torch.from_numpy(frames).to(dev)
    t0 = time.perf_counter()
    hog_app_run(frames_dev[:COLD_FRAMES], gt, w, b)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    outs, _, runs = warm_runs_of(lambda: hog_app_run(frames_dev, gt, w, b), WARM_RUNS)
    run = outs[0]
    m = run["metrics"]
    det_fps = [n_frames / o["det_s"] for o in outs]
    frame_fps = [n_frames / o["all_s"] for o in outs]
    n_scales = sum(1 for si in range(HOG_KW["n_scales"])
                   if int(480 / 1.05 ** si) >= 128 and int(640 / 1.05 ** si) >= 64)

    # card against CPU: the same valid boxes, scores within 1e-3
    worst = 0.0
    w_cpu = w.cpu()
    for t in range(4):
        gd = hog.detect_multi_scale(frames_dev[t], w, b, **HOG_KW)
        cd = hog.detect_multi_scale(frames_dev[t].cpu(), w_cpu, b, **HOG_KW)
        gv, cv = gd.valid.cpu(), cd.valid
        gb, cb = gd.boxes.cpu()[gv], cd.boxes[cv]
        if gb.shape != cb.shape or not torch.equal(gb, cb):
            fail(f"hog: frame {t}: the card's {gb.shape[0]} boxes differ from the CPU's {cb.shape[0]}")
        worst = max(worst, float((gd.scores.cpu()[gv] - cd.scores[cv]).abs().max()))
    if not worst <= 1e-3:
        fail(f"hog: card scores {worst} from the CPU's (bound 1e-3)")

    res = dict(units=n_frames, unit="frame", frames=n_frames, scales=n_scales, svm_fit_s=fit_s,
               mota=m.mota, motp=m.motp, counters=dict(tp=m.tp, fp=m.fp, fn=m.fn, gt=m.gt),
               detections_per_frame=run["detections"],
               hog_detection_fps=statistics.median(det_fps), hog_detection_fps_runs=det_fps,
               frame_fps=statistics.median(frame_fps), frame_fps_runs=frame_fps, cold_s=cold,
               cold_frames=COLD_FRAMES,
               card_vs_cpu_score=worst, launches=runs[0])
    print(f"[hog] SVM fitted on 120 windows in {fit_s:.2f} s; {n_frames} frames 480x640, 6 bar pedestrians, "
          f"detectMultiScale at scale 1.05 x {n_scales} scales, hit threshold 0: "
          f"{run['detections']:.2f} grouped detections per frame; MOTA {m.mota:.4f}, MOTP {m.motp:.4f} "
          f"(TP {m.tp}, FP {m.fp}, FN {m.fn}, GT {m.gt}); HOG detection "
          f"{res['hog_detection_fps']:.2f} frames/s, frame {res['frame_fps']:.2f} frames/s (median of "
          f"{WARM_RUNS}, ranges {min(det_fps):.2f}-{max(det_fps):.2f} and "
          f"{min(frame_fps):.2f}-{max(frame_fps):.2f}), cold {cold:.3f} s on {COLD_FRAMES} frames; "
          f"card vs CPU on 4 frames: "
          f"boxes equal, scores within {worst:.2e}; launches {runs[0]}", flush=True)
    return res


def dbt_run(frames: np.ndarray, gt: np.ndarray, w, b, dev) -> dict:
    """DetectionBasedTracker with the HOG detector every 4 frames and LK
    between, MotMetrics against the planted boxes from frame
    METRICS_FROM. Returns the metrics and each frame's confirmed (ids,
    boxes)."""
    import torch

    from opencv_tpu_torch.tbd import DetectionBasedTracker, MotMetrics

    mot = MotMetrics(device=dev)
    dbt = DetectionBasedTracker(lambda img: hog_detect(torch.from_numpy(img).to(dev), w, b),
                                detect_interval=4, device=dev)
    log = []
    for t in range(frames.shape[0]):
        conf = dbt.process_frame(frames[t])
        boxes = np.stack([tr.bbox for tr in conf]) if conf else np.zeros((0, 4), np.float32)
        log.append(([tr.track_id for tr in conf], boxes))
        if t >= METRICS_FROM and conf:
            mot.update(boxes, gt[t])
    return dict(metrics=mot, log=log)


def phase_dbt(dev: str = "cuda", n_frames: int = 32) -> dict:
    """DetectionBasedTracker on the first `n_frames` frames of the hog
    path's scene at 480x640 with its detector (one GFTT and one LK call
    per box and frame pair: 6 boxes x 3 K4 sites at N = 32), cold on
    COLD_FRAMES frames, then warm WARM_RUNS times; K4 must launch. The
    first 5 frames (two detector runs, four LK passes) against the CPU:
    the same confirmed IDs, boxes within 0.05 px (the LK rule)."""
    import torch

    frames, gt = bar_scene(n_frames)
    w_np, b = fit_bar_svm(dev)
    w = torch.from_numpy(w_np).to(dev)
    t0 = time.perf_counter()
    dbt_run(frames[:COLD_FRAMES], gt, w, b, dev)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    outs, secs, runs = warm_runs_of(lambda: dbt_run(frames, gt, w, b, dev), WARM_RUNS)
    if any(c["lk_sample"] <= 0 for c in runs):
        fail("kernel lk_sample was not launched by the DetectionBasedTracker's LK")

    cpu = dbt_run(frames[:5], gt, w.cpu(), b, "cpu")
    worst = 0.0
    for t, ((ia, ba), (ib, bb)) in enumerate(zip(outs[0]["log"], cpu["log"])):
        if ia != ib:
            fail(f"dbt: frame {t}: confirmed IDs {ia} on the card, {ib} on the CPU")
        if len(ba):
            worst = max(worst, float(np.abs(ba - bb).max()))
    if not worst <= 0.05:
        fail(f"dbt: card boxes {worst} px from the CPU's (bound 0.05)")

    m, pairs, warm = outs[0]["metrics"], n_frames - 1, statistics.median(secs)
    res = dict(units=pairs, unit="frame pair", frames=n_frames, fps_warm=n_frames / warm,
               fps_warm_runs=[n_frames / s for s in secs], cold_s=cold, cold_frames=COLD_FRAMES,
               mota=m.mota, motp=m.motp,
               counters=dict(tp=m.tp, fp=m.fp, fn=m.fn, gt=m.gt), card_vs_cpu_px=worst,
               k4_launches_per_pair=runs[0]["lk_sample"] / pairs, launches=runs[0])
    print(f"[dbt] DetectionBasedTracker (HOG every 4 frames, LK between) on {n_frames} frames 480x640: "
          f"warm {n_frames / warm:.2f} frames/s (median of {WARM_RUNS}, range {n_frames / max(secs):.2f} "
          f"to {n_frames / min(secs):.2f}), cold {cold:.3f} s on {COLD_FRAMES} frames; MOTA {m.mota:.4f}, "
          f"MOTP {m.motp:.4f} (TP {m.tp}, FP {m.fp}, FN {m.fn}, GT {m.gt}); K4 launches per frame pair "
          f"{res['k4_launches_per_pair']:.2f}; card vs CPU on 5 frames: IDs equal, boxes within "
          f"{worst:.2e} px; launches {runs[0]}", flush=True)
    return res


LANES = ((80, 230, 150, 120), (260, 230, 180, 120))  # lane_detection.py's, at 240x320
LANE_SCALE = 2  # the lanes at twice the example's coordinates, on 480x640


def lane_frame(rng) -> np.ndarray:
    """examples/lane_detection.py's road on 480x640 at LANE_SCALE times
    its coordinates: two converging lanes (2 px thick, 220) on uniform
    noise 20-60."""
    h, w = 480, 640
    img = rng.uniform(20, 60, size=(h, w)).astype(np.float32)
    for x0, y0, x1, y1 in LANES:
        x0, y0, x1, y1 = (LANE_SCALE * v for v in (x0, y0, x1, y1))
        n = int(max(abs(x1 - x0), abs(y1 - y0)) * 2 + 1)
        t = np.linspace(0, 1, n)
        xs = np.round(x0 + t * (x1 - x0)).astype(int)
        ys = np.round(y0 + t * (y1 - y0)).astype(int)
        for d in range(2):
            img[np.clip(ys, 0, h - 1), np.clip(xs + d, 0, w - 1)] = 220.0
    return img


def lane_pipeline(img):
    """Gaussian blur (5, 1.5), Canny (60, 120), Hough segments (threshold
    30, min length 120, max gap 5, 16 lines): (edges, segments)."""
    from opencv_tpu_torch.core import imgproc
    from opencv_tpu_torch.ops import edges, hough

    e = edges.canny(imgproc.gaussian_blur(img, 5, 1.5), 60, 120)
    return e, hough.hough_segments(e, threshold=30.0, min_line_length=120, max_line_gap=5,
                                   max_lines=16)


def lanes_found(xyxy: np.ndarray) -> list[bool]:
    """Per lane: are a segment's two ends within 48 px of its ends,
    summed (lane_detection.py's bound of 2 x 12 px, at twice its scale)?"""
    found = []
    for x0, y0, x1, y1 in LANES:
        p, q = LANE_SCALE * np.array([x0, y0], np.float64), LANE_SCALE * np.array([x1, y1], np.float64)
        found.append(any(min(np.linalg.norm(s[:2] - p) + np.linalg.norm(s[2:] - q),
                             np.linalg.norm(s[:2] - q) + np.linalg.norm(s[2:] - p)) < 48.0
                         for s in xyxy))
    return found


def phase_lane(n_frames: int = 30, dev: str = "cuda") -> dict:
    """Lane detection (examples/lane_detection.py) at 480x640 on
    `n_frames` frames of fresh noise: both lanes found in every frame;
    cold, then warm WARM_RUNS times; frame 0 on the CPU: equal edge
    masks, segments within 0.5 px."""
    import torch

    rng = np.random.default_rng(3)
    frames = torch.from_numpy(np.stack([lane_frame(rng) for _ in range(n_frames)])).to(dev)

    def run():
        out = []
        for t in range(n_frames):
            e, seg = lane_pipeline(frames[t])
            out.append((int(e.sum()), seg.xyxy.cpu().numpy()[seg.valid.cpu().numpy()]))
        return out

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    outs, secs, runs = warm_runs_of(run, WARM_RUNS)
    found = [lanes_found(xyxy) for _, xyxy in outs[0]]
    e_g, s_g = lane_pipeline(frames[0])
    e_c, s_c = lane_pipeline(frames[0].cpu())
    if not torch.equal(e_g.cpu(), e_c):
        fail(f"lane: edge masks differ on {int((e_g.cpu() != e_c).sum())} pixels between the card "
             "and the CPU")
    if not torch.equal(s_g.valid.cpu(), s_c.valid):
        fail("lane: valid segments differ between the card and the CPU")
    seg_px = float((s_g.xyxy.cpu() - s_c.xyxy)[s_c.valid].abs().max()) if s_c.valid.any() else 0.0
    warm = statistics.median(secs)
    res = dict(units=n_frames, unit="frame", fps_warm=n_frames / warm,
               fps_warm_runs=[n_frames / s for s in secs], cold_s=cold,
               edge_px_mean=float(np.mean([n for n, _ in outs[0]])),
               segments_mean=float(np.mean([len(x) for _, x in outs[0]])),
               frames_both_lanes=sum(all(f) for f in found), card_vs_cpu_segment_px=seg_px,
               launches=runs[0])
    print(f"[lane] {n_frames} frames 480x640 (blur 5/1.5, Canny 60/120, Hough segments 30/120/5/16): "
          f"both lanes found in {res['frames_both_lanes']} of {n_frames} frames; "
          f"{res['edge_px_mean']:.0f} edge px and {res['segments_mean']:.1f} segments per frame; warm "
          f"{n_frames / warm:.2f} frames/s (median of {WARM_RUNS}, range {n_frames / max(secs):.2f} to "
          f"{n_frames / min(secs):.2f}), cold {cold:.3f} s; card vs CPU on frame 0: edge masks equal, "
          f"segments within {seg_px:.2e} px; launches {runs[0]}", flush=True)
    if res["frames_both_lanes"] != n_frames:
        fail(f"lane: both lanes found in only {res['frames_both_lanes']} of {n_frames} frames")
    if not seg_px <= 0.5:
        fail(f"lane: card segments {seg_px} px from the CPU's (bound 0.5)")
    return res


# ------------------------------------------------------------ calibration app and video stabilization slice

APP_COLS, APP_ROWS, APP_SQ = 7, 5, 40  # examples/calibration_app.py's board (inner corners, px)
APP_SQUARE_WORLD = 0.1
APP_K = np.array([[520.0, 0, 326.0], [0, 525.2, 236.0], [0, 0, 1]])  # the app's K_GT
CIRCLES_STEP, CIRCLES_R = 110, 27  # a 5x4 grid of dark disks filling 480x640


def calibapp_views(n_views: int = 8, seed: int = 0, dev: str = "cuda"):
    """examples/calibration_app.py's views: its 7x5 board (40 px squares,
    0.1 m) rendered with warp_perspective through the app's K_GT at its
    seeded poses (roll, pitch, yaw up to +-0.35 rad, 2.1-2.9 m), 480x640;
    and one circles-grid view: tests/test_msseg_circles.py's `_grid_image`
    drawing (dark disks of 30 on 220) for a 5x4 grid at step 110 px and
    radius 27, centred in 480x640. Returns (board views on the
    device, board object points [35, 3], circles view, true centres)."""
    import torch

    from opencv_tpu_torch.core import imgproc
    from opencv_tpu_torch.geometry.rotation import rodrigues

    bw, bh = (APP_COLS + 1) * APP_SQ, (APP_ROWS + 1) * APP_SQ
    board = np.full((bh + 2 * APP_SQ, bw + 2 * APP_SQ), 210.0, np.float32)
    for i in range(APP_ROWS + 1):
        for j in range(APP_COLS + 1):
            if (i + j) % 2 == 0:
                board[APP_SQ * (i + 1):APP_SQ * (i + 2), APP_SQ * (j + 1):APP_SQ * (j + 2)] = 30.0
    board_t = torch.from_numpy(board).to(dev)
    s = APP_SQUARE_WORLD / APP_SQ
    to_world = np.array([[s, 0, -(bw / 2 + APP_SQ) * s], [0, s, -(bh / 2 + APP_SQ) * s], [0, 0, 1]])
    rng = np.random.default_rng(seed)
    views = []
    for _ in range(n_views):
        rvec = rng.uniform(-0.35, 0.35, 3).astype(np.float32)
        tvec = np.array([rng.uniform(-0.2, 0.2), rng.uniform(-0.15, 0.15), rng.uniform(2.1, 2.9)])
        R = rodrigues(torch.from_numpy(rvec)).numpy().astype(np.float64)
        hom = APP_K @ np.column_stack([R[:, 0], R[:, 1], tvec]) @ to_world
        img = imgproc.warp_perspective(board_t, np.linalg.inv(hom).astype(np.float32), 480, 640)
        views.append(img.clamp(0.0, 255.0))
    obj = np.zeros((APP_ROWS * APP_COLS, 3), np.float32)
    jj, ii = np.meshgrid(np.arange(APP_COLS), np.arange(APP_ROWS))
    obj[:, 0] = jj.reshape(-1) * APP_SQUARE_WORLD
    obj[:, 1] = ii.reshape(-1) * APP_SQUARE_WORLD

    h, w = 480, 640
    x0, y0 = (w - 4 * CIRCLES_STEP) // 2, (h - 3 * CIRCLES_STEP) // 2
    yy, xx = np.mgrid[0:h, 0:w]
    circles = np.full((h, w), 220.0, np.float32)
    centres = []
    for i in range(4):
        for j in range(5):
            cx, cy = x0 + j * CIRCLES_STEP, y0 + i * CIRCLES_STEP
            circles[(yy - cy) ** 2 + (xx - cx) ** 2 <= CIRCLES_R ** 2] = 30.0
            centres.append((cx, cy))
    return views, obj, torch.from_numpy(circles).to(dev), np.asarray(centres, np.float32)


def calibapp_run(views, obj, circles, dev: str = "cuda") -> dict:
    """The calibration app's flow: find_chessboard_corners on each view,
    calibrate_camera over the views found, each view's mean reprojection
    error, drop the worst view and recalibrate, the app's verdict (RMS <
    0.8 px, fx and fy within 3 %); then find_circles_grid on the circles
    view. Per-view detection seconds and the calibrations' wall seconds by
    the host clock around synchronised work."""
    import torch

    from opencv_tpu_torch.geometry import calibration
    from opencv_tpu_torch.ops import chessboard

    found, det_s = [], []
    for img in views:
        t0 = time.perf_counter()
        c = chessboard.find_chessboard_corners(img, (APP_COLS, APP_ROWS), device=dev)
        det_s.append(time.perf_counter() - t0)
        found.append(c)
    pts = [c for c in found if c is not None]
    if len(pts) < 4:
        return dict(found=found, det_s=det_s, ok=False)

    def calib(p):
        return calibration.calibrate_camera(np.stack([obj] * len(p)), np.stack(p), device=dev)

    t0 = time.perf_counter()
    res = calib(pts)
    o = torch.from_numpy(obj).to(dev)
    k4 = torch.tensor([res.K[0, 0], res.K[1, 1], res.K[0, 2], res.K[1, 2]], device=dev)
    uv = calibration.project_points_full(torch.from_numpy(res.rvecs).to(dev),
                                         torch.from_numpy(res.tvecs).to(dev), k4,
                                         torch.from_numpy(res.dist).to(dev), o).cpu().numpy()
    per_view = [float(np.linalg.norm(uv[v] - p, axis=1).mean()) for v, p in enumerate(pts)]
    worst = int(np.argmax(per_view))
    res2 = calib([p for i, p in enumerate(pts) if i != worst])
    calib_s = time.perf_counter() - t0
    best = res2 if res2.rms < res.rms else res
    ok = bool(best.rms < 0.8 and abs(best.K[0, 0] - APP_K[0, 0]) < 0.03 * APP_K[0, 0]
              and abs(best.K[1, 1] - APP_K[1, 1]) < 0.03 * APP_K[1, 1])
    t0 = time.perf_counter()
    grid, grid_ok = chessboard.find_circles_grid(circles, (5, 4), device=dev)
    circles_s = time.perf_counter() - t0
    return dict(found=found, det_s=det_s, res=res, res2=res2, per_view=per_view, worst=worst,
                calib_s=calib_s, ok=ok, grid=grid, grid_ok=grid_ok, circles_s=circles_s)


def phase_calibapp(dev: str = "cuda") -> dict:
    """examples/calibration_app.py's flow at its own sizes (8 views of
    480x640, a 7x5 board, seed 0) plus one 5x4 circles-grid view; cold,
    then warm WARM_RUNS times. Every view's board must be found, the app's
    verdict OK; the circles grid found within 0.5 px of its centres; the
    CPU's corners within 1e-3 px of the card's, its circles grid equal."""
    import torch

    from opencv_tpu_torch.ops import ccomp, chessboard
    from opencv_tpu_torch.ops.chessboard import median

    views, obj, circles, centres = calibapp_views(dev=dev)
    n_units = len(views) + 1
    t0 = time.perf_counter()
    calibapp_run(views, obj, circles, dev)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    outs, secs, runs = warm_runs_of(lambda: calibapp_run(views, obj, circles, dev), WARM_RUNS)
    g = outs[0]
    n_found = sum(c is not None for c in g["found"])
    if n_found != len(views):
        fail(f"calibapp: the board was found in {n_found} of {len(views)} views")
    if not g["ok"]:
        fail(f"calibapp: the app's verdict is DEGRADED (RMS {g['res2'].rms:.4f} px, K {g['res2'].K.tolist()})")
    worst_px = 0.0
    for img, c in zip(views, g["found"]):
        cpu = chessboard.find_chessboard_corners(img.cpu(), (APP_COLS, APP_ROWS), device="cpu")
        if cpu is None:
            fail("calibapp: the CPU found no board where the card found one")
        worst_px = max(worst_px, float(np.abs(c - cpu).max()))
    if not worst_px <= 1e-3:
        fail(f"calibapp: the card's corners are {worst_px} px from the CPU's (bound 1e-3)")
    grid_err = float(np.linalg.norm(g["grid"][:, None] - centres[None], axis=-1).min(1).max())
    if not (g["grid_ok"] and grid_err <= 0.5):
        fail(f"calibapp: circles grid ok={g['grid_ok']}, {grid_err} px from the centres (bound 0.5)")
    cpu_grid, cpu_ok = chessboard.find_circles_grid(circles.cpu(), (5, 4), device="cpu")
    if not (cpu_ok and np.array_equal(cpu_grid, g["grid"])):
        fail("calibapp: the CPU's circles grid differs from the card's")
    lab = ccomp.connected_components_stats(circles < median(circles))
    r1, r2 = g["res"], g["res2"]
    det = [float(np.mean(o["det_s"])) for o in outs]
    res = dict(units=n_units, unit="view", views=len(views), found=n_found,
               fps_warm=n_units / statistics.median(secs),
               fps_warm_runs=[n_units / t for t in secs], cold_s=cold,
               rms=r1.rms, rms_after_drop=r2.rms, dropped_view=g["worst"],
               per_view_err_px=g["per_view"], K=r1.K.tolist(), K_after_drop=r2.K.tolist(), ok=g["ok"],
               detect_s_per_view=statistics.median(det), detect_s_per_view_runs=det,
               calib_s=statistics.median(o["calib_s"] for o in outs),
               circles_s=statistics.median(o["circles_s"] for o in outs), circles_err_px=grid_err,
               ccomp_sweeps=lab.sweeps, ccomp_host_reads=lab.host_reads,
               card_vs_cpu_corners_px=worst_px, launches=runs[0])
    print(f"[calibapp] {n_found} of {len(views)} views 480x640: board found; RMS {r1.rms:.4f} px, fx "
          f"{r1.K[0, 0]:.2f} (truth {APP_K[0, 0]:.1f}) fy {r1.K[1, 1]:.2f} (truth {APP_K[1, 1]:.1f}) cx "
          f"{r1.K[0, 2]:.2f} cy {r1.K[1, 2]:.2f}; per-view error {np.round(g['per_view'], 4).tolist()} "
          f"-> view {g['worst']} dropped, RMS {r2.rms:.4f} px, fx {r2.K[0, 0]:.2f} fy {r2.K[1, 1]:.2f}; "
          f"verdict {'OK' if g['ok'] else 'DEGRADED'}", flush=True)
    print(f"[calibapp] circles 5x4: found, {grid_err:.2e} px from the centres; connected components "
          f"{lab.sweeps} sweeps, {lab.host_reads} host reads; detection {1e3 * res['detect_s_per_view']:.1f} "
          f"ms per board view (median of {WARM_RUNS} runs, runs {[round(1e3 * d, 1) for d in det]}), "
          f"circles view {1e3 * res['circles_s']:.1f} ms, both calibrations {res['calib_s']:.3f} s; "
          f"{res['fps_warm']:.2f} views/s, cold {cold:.3f} s; card vs CPU: corners within "
          f"{worst_px:.2e} px, circles grid equal; launches {runs[0]}", flush=True)
    return res


def stab_frames(base: np.ndarray, n_frames: int = 60, seed: int = 0, dev: str = "cuda"):
    """tests/test_photo_videostab.py's jittered sequence at 480x640: `base`
    moved by a random walk of N(0, 1.5) px steps with warp_affine
    (edge-clamped). Returns frames [F, H, W] on the device."""
    import torch

    from opencv_tpu_torch.core import imgproc

    rng = np.random.default_rng(seed)
    jitter = np.cumsum(rng.normal(0, 1.5, size=(n_frames, 2)), axis=0).astype(np.float32)
    b = torch.from_numpy(np.ascontiguousarray(base)).to(dev)
    h, w = base.shape
    return torch.stack([imgproc.warp_affine(b, [[1.0, 0.0, jx], [0.0, 1.0, jy]], h, w)
                        for jx, jy in jitter])


def frame_jitter(seq) -> float:
    """tests/test_photo_videostab.py's measure: the mean absolute
    difference of consecutive frames, 20 px inside."""
    return float(np.mean([np.abs(a[20:-20, 20:-20] - b[20:-20, 20:-20]).mean()
                          for a, b in zip(seq[:-1], seq[1:])]))


def corners_px(a, b, h: int = 480, w: int = 640) -> float:
    """Largest distance between two affine maps [2, 3] at a frame's corners."""
    c = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]], np.float64)
    return float(np.abs(c @ np.asarray(a, np.float64).T - c @ np.asarray(b, np.float64).T).max())


def phase_stab(base: np.ndarray, n_frames: int = 60, dev: str = "cuda") -> dict:
    """Video stabilization: stabilize (GFTT 200, LK at 3 levels, affine
    RANSAC per pair, Gaussian smoothing radius 5, compensating warps) on
    `n_frames` jittered 480x640 frames, cold, then warm WARM_RUNS times;
    the jitter must fall below 0.6 of the input's; K4 must launch. Then
    find_transform_ecc("affine") on 3 pairs against their RANSAC motion,
    deblur_weiner_gaussian on one frame, suppress_wobble on the motions;
    the first 5 pairs' motions on the CPU within 0.05 px of the card's
    (the same seed draws the same RANSAC subsets on both)."""
    import torch

    from opencv_tpu_torch.ops import ecc, videostab

    frames = stab_frames(base, n_frames, dev=dev)
    t0 = time.perf_counter()
    videostab.stabilize(frames, device=dev)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    outs, secs, runs = warm_runs_of(lambda: videostab.stabilize(frames, device=dev), WARM_RUNS)
    if any(c["lk_sample"] <= 0 for c in runs):
        fail("kernel lk_sample was not launched by videostab's LK")
    raw = frames.cpu().numpy()
    ratio = frame_jitter(outs[0].cpu().numpy()) / frame_jitter(raw)

    motions = videostab.estimate_motions(frames, device=dev)
    cpu = videostab.estimate_motions(frames[:6].cpu(), device="cpu")
    card_vs_cpu = max(corners_px(a, b) for a, b in zip(motions[1:6], cpu[1:6]))
    ecc_rho, ecc_px, ecc_s = [], [], []
    for i in (1, n_frames // 2, n_frames - 1):
        t0 = time.perf_counter()
        warp, rho = ecc.find_transform_ecc(frames[i - 1], frames[i], "affine", device=dev)
        ecc_rho.append(float(rho))
        ecc_s.append(time.perf_counter() - t0)
        ecc_px.append(corners_px(warp.cpu().numpy(), motions[i]))
    deblur_s = []  # the first call includes cuFFT's plans
    for _ in range(2):
        t0 = time.perf_counter()
        deblurred = videostab.deblur_weiner_gaussian(frames[0], 5.0, device=dev)
        deblur_ok = bool(torch.isfinite(deblurred).all())
        deblur_s.append(time.perf_counter() - t0)
    wobble = videostab.suppress_wobble(motions, device=dev)
    pairs = n_frames - 1
    warm = statistics.median(secs)
    res = dict(units=n_frames, unit="frame", frames=n_frames, fps_warm=n_frames / warm,
               fps_warm_runs=[n_frames / t for t in secs], cold_s=cold, jitter_ratio=ratio,
               card_vs_cpu_motion_px=card_vs_cpu, ecc_rho=ecc_rho, ecc_vs_ransac_px=ecc_px,
               ecc_s=ecc_s, deblur_s=deblur_s,
               wobble_change_px=float(np.abs(wobble - motions)[:, :, 2].max()),
               k4_launches_per_pair=runs[0]["lk_sample"] / pairs, launches=runs[0])
    print(f"[stab] stabilize {n_frames} frames 480x640: warm {n_frames / warm:.2f} frames/s (median of "
          f"{WARM_RUNS}, range {n_frames / max(secs):.2f} to {n_frames / min(secs):.2f}), cold {cold:.3f} s; "
          f"jitter ratio {ratio:.4f} (stabilised over raw); K4 launches per frame pair "
          f"{res['k4_launches_per_pair']:.2f}; card vs CPU motions on 5 pairs within {card_vs_cpu:.2e} px",
          flush=True)
    print(f"[stab] ECC affine on pairs (0,1), ({n_frames // 2 - 1},{n_frames // 2}), ({n_frames - 2},"
          f"{n_frames - 1}): correlation {[round(r, 5) for r in ecc_rho]}, warp vs RANSAC motion "
          f"{[round(p, 4) for p in ecc_px]} px, {[round(t, 3) for t in ecc_s]} s; Wiener deblur "
          f"{1e3 * deblur_s[1]:.1f} ms (first call {1e3 * deblur_s[0]:.1f} ms; finite: {deblur_ok}); wobble suppression moves the translations "
          f"by up to {res['wobble_change_px']:.4f} px; launches {runs[0]}", flush=True)
    if not ratio < 0.6:
        fail(f"stab: jitter ratio {ratio:.4f} (bound 0.6)")
    if not card_vs_cpu <= 0.05:
        fail(f"stab: card motions {card_vs_cpu} px from the CPU's (bound 0.05)")
    if not (deblur_ok and np.isfinite(wobble).all() and np.isfinite(ecc_rho).all()):
        fail("stab: a non-finite deblurred frame, wobble-suppressed motion or ECC correlation")
    return res


# ------------------------------------------------------------ panorama, QR and segmentation slice

# examples/panorama.py's scene (a) and its 480x640 counterpart (b): a plane
# at z = 1 textured by a bilinearly upsampled uniform(30, 225) grid, seen by
# pure rotations about y; (b) keeps (a)'s 1:1 sampling (ts / (2 span) = F)
# and 8-px blobs
PANO_A = dict(F=200.0, h=160, w=200, yaws=(-0.45, 0.0, 0.45), ts=720, span=1.8, n_features=700)
PANO_B = dict(F=600.0, h=480, w=640, yaws=(-0.6, -0.3, 0.0, 0.3, 0.6), ts=2880, span=2.4,
              n_features=2000)


@contextlib.contextmanager
def torch_threads(n: int):
    """PyTorch's CPU thread count set to n inside the block: the CPU
    references of small images run many small operations, which more
    threads only slow down."""
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def pano_views(cfg: dict, dev: str = "cuda"):
    """Render the pure-rotation views of examples/panorama.py with the
    port's warp_perspective. Returns (views [list of f32 [H, W] on dev],
    rotations [N, 3, 3])."""
    import torch

    from opencv_tpu_torch.core import imgproc
    from opencv_tpu_torch.geometry.rotation import rodrigues

    rng = np.random.default_rng(3)
    ts, span, F, h, w = cfg["ts"], cfg["span"], cfg["F"], cfg["h"], cfg["w"]
    tex = torch.from_numpy(rng.uniform(30, 225, (ts // 8, ts // 8)).astype(np.float32)).to(dev)
    tex = imgproc.resize_bilinear(tex, ts, ts)
    S = np.array([[ts / (2 * span), 0, ts / 2], [0, ts / (2 * span), ts / 2], [0, 0, 1]])
    K = np.array([[F, 0, w / 2], [0, F, h / 2], [0, 0, 1]])
    views, Rs = [], []
    for yaw in cfg["yaws"]:
        R = rodrigues(torch.tensor([0.0, yaw, 0.0])).double().numpy()
        views.append(imgproc.warp_perspective(tex, (S @ np.linalg.inv(K @ R)).astype(np.float32), h, w))
        Rs.append(R)
    return views, np.stack(Rs)


def pano_geometry_errors(R: np.ndarray, Rs: np.ndarray, f: float, F: float):
    """(relative focal error, per-view relative rotation errors in degrees
    against view 0, as tests/test_global_stitch.py measures them)."""
    rel = [_rot_deg(R[k] @ R[0].T, Rs[k] @ Rs[0].T) for k in range(1, len(Rs))]
    return abs(f - F) / F, rel


def pano_run(views, cfg: dict, dev: str):
    """The example's flow: estimate_panorama, then stitch_panorama (which
    estimates again), both seeded 1, two bands."""
    from opencv_tpu_torch.stitching import global_stitch as gs

    R, f, diag = gs.estimate_panorama(views, n_features=cfg["n_features"], seed=1, device=dev)
    pano = gs.stitch_panorama(views, n_features=cfg["n_features"], seed=1, blend_bands=2, device=dev)
    return R, f, diag, pano


def k1_exact_on_orb_pyramid(view, n_features: int) -> float:
    """K1 held against its plain version, level by level and bit for bit,
    at the launch the panorama's ORB makes for `view`: its pyramid
    (ORBConfig with 4 levels, as estimate_panorama and stitch_pair build
    it) in one call of the multi-level entry. Fails on any difference;
    returns the largest |kernel - plain| (0.0)."""
    import torch

    from opencv_tpu_torch.core import pyramid
    from opencv_tpu_torch.core.config import ORBConfig
    from opencv_tpu_torch.ops import orb
    from opencv_tpu_torch.ops.cuda import fast_kernel

    cfg = ORBConfig(n_features=n_features, n_levels=4)
    pyr = pyramid.build_pyramid(view.to(torch.float32), cfg.n_levels, cfg.scale_factor)
    budgets = orb.level_budgets(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    levels = [pyr.levels[lvl] for lvl in range(cfg.n_levels) if budgets[lvl] > 0]
    err = 0.0
    for lvl, (s_k, n_k) in zip(levels, fast_kernel.fast_corners_levels(levels, cfg.fast_threshold)):
        s_p, n_p = fast_kernel.fast_corners_plain(lvl, cfg.fast_threshold)
        err = max(err, max_abs_err((s_k, s_p), (n_k, n_p)))
        if not (torch.equal(s_k, s_p) and torch.equal(n_k, n_p)):
            bad = (s_k != s_p).sum().item() + (n_k != n_p).sum().item()
            fail(f"K1 differs from its plain version on a panorama view's pyramid at "
                 f"{tuple(lvl.shape)}: {bad} values")
    return err


def phase_pano(dev: str = "cuda") -> dict:
    """[pano] (a) examples/panorama.py: 3 views of 160x200 (F = 200, yaws
    -0.45/0/0.45, 700 features, seed 1, 2 bands); (b) 5 views of 480x640
    (F = 600, yaws -0.6..0.6, 2000 features), cold, then warm WARM_RUNS
    times; stitch_pair on views 2 and 3 of (b). Bounds: focal within 12 %,
    relative rotations < 3 deg, (a)'s tree of 2 edges
    (tests/test_global_stitch.py:70-79). The CPU gets the same RANSAC
    subsets (one CPU generator per call): on (a), focal within 1e-3
    relative, rotations within 0.05 deg, and (a)'s panorama composed from
    the card's rotations on both devices with >= 99 % of its pixels within
    0.5 grey levels; stitch_pair the same pixel rule. (b) on the card
    alone: the port's CPU run of it takes minutes."""
    import torch

    from opencv_tpu_torch.stitching import global_stitch as gs
    from opencv_tpu_torch.stitching import stitcher

    def pixel_share(a, b, tol=0.5):
        return float((np.abs(a - b) <= tol).mean()) if a.shape == b.shape else 0.0

    # (a): the example at its own size, on the card and on the CPU
    va, Rs_a = pano_views(PANO_A, dev)
    t0 = time.perf_counter()
    Ra, fa, diag_a, pano_a = pano_run(va, PANO_A, dev)
    a_s = time.perf_counter() - t0
    ferr_a, rot_a = pano_geometry_errors(Ra, Rs_a, fa, PANO_A["F"])
    with torch_threads(1):
        Rc, fc, diag_c, _ = pano_run([v.cpu() for v in va], PANO_A, "cpu")
        comp_cpu = gs.compose_panorama([v.cpu() for v in va], Ra, fa, blend_bands=2).numpy()
    comp_card = gs.compose_panorama(va, Ra, fa, blend_bands=2).cpu().numpy()
    a_cpu = dict(focal_rel=abs(fa - fc) / fc, rot_deg=max(_rot_deg(x, y) for x, y in zip(Ra, Rc)),
                 tree_equal=diag_a["tree"] == diag_c["tree"],
                 pixels_within_0_5=pixel_share(comp_card, comp_cpu))
    print(f"[pano] (a) examples/panorama.py 3 views 160x200: focal {fa:.2f} (truth {PANO_A['F']}, "
          f"{100 * ferr_a:.2f} %), relative rotations {[round(r, 4) for r in rot_a]} deg, "
          f"{len(diag_a['edges'])} confident pairs, tree {diag_a['tree']}; panorama "
          f"{pano_a.shape[1]}x{pano_a.shape[0]}, covered {(pano_a > 1.0).mean():.3f}; {a_s:.2f} s "
          f"(cold); card vs CPU: focal {a_cpu['focal_rel']:.2e} relative, rotations "
          f"{a_cpu['rot_deg']:.2e} deg, trees equal {a_cpu['tree_equal']}, composed pixels within "
          f"0.5: {a_cpu['pixels_within_0_5']:.5f}", flush=True)
    if not (ferr_a < 0.12 and max(rot_a) < 3.0 and len(diag_a["tree"]) == 2):
        fail(f"pano (a): focal error {ferr_a:.4f}, rotation errors {rot_a} deg, tree {diag_a['tree']}")
    if not (a_cpu["focal_rel"] <= 1e-3 and a_cpu["rot_deg"] <= 0.05 and a_cpu["tree_equal"]
            and a_cpu["pixels_within_0_5"] >= 0.99):
        fail(f"pano (a): the card differs from the CPU: {a_cpu}")

    # (b): 5 views of 480x640 on the card, cold then warm
    vb, Rs_b = pano_views(PANO_B, dev)
    t0 = time.perf_counter()
    pano_run(vb, PANO_B, dev)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    outs, secs, runs = warm_runs_of(lambda: pano_run(vb, PANO_B, dev), WARM_RUNS)
    Rb, fb, diag_b, pano_b = outs[0]
    ferr_b, rot_b = pano_geometry_errors(Rb, Rs_b, fb, PANO_B["F"])

    # stitch_pair on views 2 and 3 of (b), card and CPU
    stitcher.stitch_pair(vb[2], vb[3], n_features=2000, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pair = stitcher.stitch_pair(vb[2], vb[3], n_features=2000, device=dev)
    pair_s = time.perf_counter() - t0
    pair_cpu = stitcher.stitch_pair(vb[2].cpu(), vb[3].cpu(), n_features=2000, device="cpu")
    pair_share = pixel_share(pair, pair_cpu)
    warm = statistics.median(secs)
    res = dict(units=1, unit="panorama", views=len(vb), focal=fb, focal_rel_err=ferr_b,
               rel_rot_deg=rot_b, edges=diag_b["edges"], tree=diag_b["tree"],
               pano_hw=list(pano_b.shape), covered=float((pano_b > 1.0).mean()),
               s_warm=warm, s_warm_runs=secs, cold_s=cold, pair_s=pair_s,
               pair_hw=list(pair.shape), pair_card_vs_cpu_within_0_5=pair_share,
               example_a=dict(focal=fa, focal_rel_err=ferr_a, rel_rot_deg=rot_a, tree=diag_a["tree"],
                              pano_hw=list(pano_a.shape), card_vs_cpu=a_cpu),
               launches=runs[0])
    print(f"[pano] (b) 5 views 480x640: focal {fb:.2f} (truth {PANO_B['F']}, {100 * ferr_b:.2f} %), "
          f"relative rotations {[round(r, 4) for r in rot_b]} deg, pairs {diag_b['edges']}, tree "
          f"{diag_b['tree']}; panorama {pano_b.shape[1]}x{pano_b.shape[0]}, covered "
          f"{res['covered']:.3f}; warm {warm:.3f} s per panorama (estimate_panorama + stitch_panorama; "
          f"median of {WARM_RUNS}, runs {[round(t, 3) for t in secs]}), cold {cold:.3f} s; K1 launches "
          f"{runs[0]['fast_corners']}; launches {runs[0]}", flush=True)
    print(f"[pano] stitch_pair views 2-3 of (b): {pair.shape[1]}x{pair.shape[0]}, warm {pair_s:.3f} s; "
          f"card vs CPU pixels within 0.5: {pair_share:.5f}", flush=True)
    if not (ferr_b < 0.12 and max(rot_b) < 3.0):
        fail(f"pano (b): focal error {ferr_b:.4f}, rotation errors {rot_b} deg")
    if not pair_share >= 0.99:
        fail(f"pano: stitch_pair on the card differs from the CPU ({pair_share:.5f} within 0.5)")
    if any(r["fast_corners"] <= 0 for r in runs):
        fail("kernel fast_corners was not launched by the panorama's ORB")
    # K1 at the panorama's own launches: every view's 4-level pyramid of (a) and (b)
    k1_err = max(k1_exact_on_orb_pyramid(v, cfg["n_features"])
                 for views, cfg in ((va, PANO_A), (vb, PANO_B)) for v in views)
    res["k1_pyramid_max_abs_err"] = k1_err
    print(f"[pano] K1 exact against its plain version on the 4-level pyramids of all "
          f"{len(va) + len(vb)} views (160x200 and 480x640): max_abs_err {k1_err}", flush=True)
    return res


QR_TEXTS = {1: "HELLO-TPU", 2: "opencv_tpu qr decode 123",
            3: "the quick brown fox jumps over the lazy dog 01234"}  # tests/test_qrcode.py:28-32


def qr_scenes(n: int = 24, h: int = 480, w: int = 640, seed: int = 0):
    """n scenes of h x w: grey 190, N(0, 6) noise; n/3 codes each of
    versions 1, 2 and 3 (QR_TEXTS), module sizes cycling 4-8 px, seeded
    offsets that keep the code inside the frame. Returns (scenes [n, h, w]
    f32, texts)."""
    from opencv_tpu_torch.ops import qrcode

    rng = np.random.default_rng(seed)
    scenes, texts = [], []
    for i in range(n):
        version = 1 + (3 * i) // n
        img = qrcode.render_qr(qrcode.encode_qr(QR_TEXTS[version], version), 4 + i % 5)
        y0 = int(rng.integers(0, h - img.shape[0] + 1))
        x0 = int(rng.integers(0, w - img.shape[1] + 1))
        scene = np.full((h, w), 190.0, np.float32)
        scene[y0:y0 + img.shape[0], x0:x0 + img.shape[1]] = img
        scene += rng.normal(0, 6.0, scene.shape).astype(np.float32)
        scenes.append(scene)
        texts.append(QR_TEXTS[version])
    return np.stack(scenes), texts


def qr_demo_scene():
    """examples/qr_demo.py's scene: version 2, 5-px modules, 300x340."""
    from opencv_tpu_torch.ops import qrcode

    img = qrcode.render_qr(qrcode.encode_qr("opencv_tpu says hi", version=2), module_px=5)
    rng = np.random.default_rng(0)
    scene = np.full((300, 340), 190.0, np.float32)
    scene[70:70 + img.shape[0], 90:90 + img.shape[1]] = img
    scene += rng.normal(0, 6.0, scene.shape).astype(np.float32)
    return scene


def qr_read(scenes, dev: str):
    """detect_qr + decode_qr of every scene: [(quad, ok, text)]."""
    from opencv_tpu_torch.ops import qrcode

    out = []
    for scene in scenes:
        quad, ok = qrcode.detect_qr(scene, device=dev)
        out.append((quad, ok, qrcode.decode_qr(scene, quad, device=dev) if ok else None))
    return out


def phase_qr(dev: str = "cuda") -> dict:
    """[qr] (a) examples/qr_demo.py's round trip; (b) 24 scenes of 480x640
    (qr_scenes), detect and decode, cold, then warm WARM_RUNS times. Every
    code must decode to its text; the CPU's quads and texts equal the
    card's on every scene."""
    import torch

    demo = torch.from_numpy(qr_demo_scene()).to(dev)
    (quad, ok, text), = qr_read([demo], dev)
    (cquad, cok, ctext), = qr_read([demo.cpu()], "cpu")
    print(f"[qr] (a) examples/qr_demo.py: detected {ok}, decoded {text!r}; card vs CPU quad equal "
          f"{np.array_equal(quad, cquad)}, text equal {text == ctext}", flush=True)
    if text != "opencv_tpu says hi":
        fail(f"qr (a): round trip failed ({text!r})")
    if not (np.array_equal(quad, cquad) and ctext == text):
        fail("qr (a): the CPU's quad or text differs from the card's")

    scenes_np, texts = qr_scenes()
    scenes = torch.from_numpy(scenes_np).to(dev)
    t0 = time.perf_counter()
    qr_read(scenes, dev)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    outs, secs, runs = warm_runs_of(lambda: qr_read(scenes, dev), WARM_RUNS)
    got = outs[0]
    decoded = sum(t == want for (_, _, t), want in zip(got, texts))
    cpu = qr_read(torch.from_numpy(scenes_np), "cpu")
    same = sum(np.array_equal(q, cq) and t == ct for (q, _, t), (cq, _, ct) in zip(got, cpu))
    n = len(texts)
    warm = statistics.median(secs)
    res = dict(units=n, unit="frame", decoded=decoded, total=n, fps_warm=n / warm,
               fps_warm_runs=[n / s for s in secs], cold_s=cold, card_equals_cpu=same,
               per_scene=[dict(version=1 + (3 * i) // n, module_px=4 + i % 5, text_ok=t == want)
                          for i, ((_, _, t), want) in enumerate(zip(got, texts))],
               launches=runs[0])
    print(f"[qr] (b) 24 scenes 480x640 (versions 1-3, modules 4-8 px, N(0, 6) noise): decoded "
          f"{decoded}/{n}; warm {n / warm:.2f} frames/s detect + decode (median of {WARM_RUNS}, range "
          f"{n / max(secs):.2f} to {n / min(secs):.2f}), cold {cold:.3f} s; card vs CPU quads and texts "
          f"equal on {same}/{n}; launches {runs[0]}", flush=True)
    if decoded != n:
        misses = [(r["version"], r["module_px"]) for r in res["per_scene"] if not r["text_ok"]]
        fail(f"qr (b): decoded {decoded} of {n} (missed version, module px: {misses})")
    if same != n:
        fail(f"qr (b): the CPU's quads or texts differ from the card's on {n - same} scenes")
    return res


SEG_SCALE = 480 / 70  # the grabcut and watershed scenes of examples/segmentation_demo.py, at 480x640


def grabcut_scene(h: int, w: int, s: float, rng):
    """examples/segmentation_demo.py's GrabCut scene with its geometry
    scaled by s: a red-ish ellipse (centre (45, 35) s, semi-axes 20 s and
    sqrt(250) s) on green, N(0, 6) noise, clipped; its rect (18, 10, 58,
    52) s. Returns (img [h, w, 3], truth mask, rect)."""
    img = np.zeros((h, w, 3), np.float32)
    img[..., 1] = 120
    yy, xx = np.mgrid[0:h, 0:w]
    blob = ((xx - 45 * s) ** 2 / (400 * s * s) + (yy - 35 * s) ** 2 / (250 * s * s)) < 1
    img[blob] = [40, 40, 200]
    img += rng.normal(0, 6.0, img.shape).astype(np.float32)
    rect = tuple(int(round(v * s)) for v in (18, 10, 58, 52))
    return np.clip(img, 0, 255), blob, rect


def watershed_scene(h: int, w: int, s: float):
    """The demo's two-basin surface and markers, scaled by s."""
    xx = np.mgrid[0:h, 0:w][1]
    surface = (100 - 80 * np.exp(-((xx - 25 * s) ** 2) / (200 * s * s))
               - 80 * np.exp(-((xx - 65 * s) ** 2) / (200 * s * s))).astype(np.float32)
    markers = np.zeros((h, w), np.int32)
    r = [int(round(v * s)) for v in (30, 34, 20, 28, 60, 68)]
    markers[r[0]:r[1], r[2]:r[3]] = 1
    markers[r[0]:r[1], r[4]:r[5]] = 2
    return surface, markers


def _reflect(v: float, lo: float, hi: float) -> float:
    """v folded into [lo, hi] (a path bouncing off the borders)."""
    span = hi - lo
    m = (v - lo) % (2 * span)
    return lo + (m if m <= span else 2 * span - m)


def camshift_scene(n_frames: int, s: int, rng):
    """The demo's CamShift frames scaled by s: uniform(20, 60) noise and a
    disc of radius 14 s at 210 moving (9 s, 4 s) px per frame from (40 s,
    50 s); the path bounces off the frame's borders (at s = 4 the demo's
    motion leaves a 640-px frame after 13 frames). Returns (frames,
    centres, window (25, 35, 30, 30) s)."""
    h, w, r = 120 * s, 160 * s, 14 * s
    yy, xx = np.mgrid[0:h, 0:w]
    frames, centres = [], []
    for t in range(n_frames):
        cx = _reflect(40 * s + 9 * s * t, r, w - 1 - r)
        cy = _reflect(50 * s + 4 * s * t, r, h - 1 - r)
        f = rng.uniform(20, 60, (h, w)).astype(np.float32)
        frames.append(np.where((xx - cx) ** 2 + (yy - cy) ** 2 < r * r, 210.0, f).astype(np.float32))
        centres.append((cx, cy))
    return frames, centres, tuple(v * s for v in (25, 35, 30, 30))


def camshift_track(frames, win, dev: str):
    """The demo's tracker: a 32-bin density histogram of frame 0's window
    (x 255), then back-projection and CamShift over the rest."""
    import torch

    from opencv_tpu_torch.ops import camshift

    f0 = torch.as_tensor(frames[0], device=dev)
    tmpl = f0[win[1]:win[1] + win[3], win[0]:win[0] + win[2]]
    hist = camshift.calc_hist([tmpl], [32], [(0, 256)], density=True) * 255.0
    return camshift.track_window_sequence([[f] for f in frames[1:]], hist, [(0, 256)], win, device=dev)


def centre_error(track, centres) -> float:
    return float(np.mean([np.hypot(b[0][0] - c[0], b[0][1] - c[1])
                          for (b, _), c in zip(track, centres[1:])]))


def seg_part_a(dev: str) -> dict:
    """examples/segmentation_demo.py's three parts at its sizes and with its
    one generator (seed 0): GrabCut 70x90 (4 iterations), watershed 70x90,
    CamShift over 7 frames of 120x160."""
    from opencv_tpu_torch.ops import grabcut, watershed

    rng = np.random.default_rng(0)
    img, blob, rect = grabcut_scene(70, 90, 1.0, rng)
    gc = grabcut.grab_cut_stats(img, rect=rect, iter_count=4, device=dev)
    fg = gc.mask.cpu().numpy() % 2 == 1
    iou = float((fg & blob).sum() / max((fg | blob).sum(), 1))
    surface, markers = watershed_scene(70, 90, 1.0)
    ws = watershed.watershed_stats(surface, markers, device=dev)
    lab = ws.labels.cpu().numpy()
    sizes = {k: int((lab == k).sum()) for k in (1, 2)}
    frames, centres, win = camshift_scene(7, 1, rng)
    track = camshift_track(frames, win, dev)
    err = centre_error(track, centres)
    ok = iou > 0.8 and err < 6 and sizes[1] > 500 and sizes[2] > 500
    return dict(img=img, rect=rect, mask=gc.mask.cpu().numpy(), iou=iou, sweeps=gc.sweeps,
                surface=surface, markers=markers, labels=lab, sizes=sizes, ws_sweeps=ws.sweeps,
                dams=int((lab == -1).sum()), frames=frames, win=win, track=track, err=err, ok=ok)


def seg_run_b(scenes, dev: str) -> dict:
    """One 480x640 run of the three parts: GrabCut (4 iterations),
    watershed, CamShift over 30 frames; seconds per part."""
    import torch

    from opencv_tpu_torch.ops import grabcut, watershed

    (img, rect), (surface, markers), (frames, win) = scenes
    out, secs = {}, {}
    t0 = time.perf_counter()
    out["grabcut"] = grabcut.grab_cut_stats(img, rect=rect, iter_count=4, device=dev)
    torch.cuda.synchronize()
    secs["grabcut"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["watershed"] = watershed.watershed_stats(surface, markers, device=dev)
    torch.cuda.synchronize()
    secs["watershed"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["camshift"] = camshift_track(frames, win, dev)
    secs["camshift"] = time.perf_counter() - t0
    out["secs"] = secs
    return out


def phase_seg(dev: str = "cuda") -> dict:
    """[seg] (a) examples/segmentation_demo.py at its sizes: its verdict
    (IoU > 0.8, mean centre error < 6 px, basins > 500 px) must be OK;
    the CPU's GrabCut mask >= 99.9 % equal, watershed labels and CamShift
    windows equal. (b) the same scenes at 480x640 (GrabCut and watershed
    scaled by 480/70, CamShift by 4 over 30 frames), cold, then warm
    WARM_RUNS times, on the card; CamShift also on the CPU (windows
    equal). GrabCut on the card against the CPU also at 120x160 (one
    iteration): >= 99.9 % equal."""
    import torch

    from opencv_tpu_torch.ops import grabcut

    t0 = time.perf_counter()
    a = seg_part_a(dev)
    a_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch_threads(1):
        c = seg_part_a("cpu")
    a_cpu_s = time.perf_counter() - t0
    a_cmp = dict(grabcut_equal=float((a["mask"] == c["mask"]).mean()),
                 watershed_equal=bool(np.array_equal(a["labels"], c["labels"])),
                 camshift_windows_equal=[w for _, w in a["track"]] == [w for _, w in c["track"]])
    print(f"[seg] (a) examples/segmentation_demo.py: grabcut IoU {a['iou']:.4f} (sweeps per cut "
          f"{a['sweeps']}), watershed basins {a['sizes']} with {a['dams']} dam px in {a['ws_sweeps']} "
          f"sweeps, camshift mean centre error {a['err']:.3f} px over 6 frames; verdict "
          f"{'OK' if a['ok'] else 'DEGRADED'}; {a_s:.2f} s on the card, {a_cpu_s:.2f} s on the CPU; card "
          f"vs CPU: grabcut mask equal on {a_cmp['grabcut_equal']:.5f}, watershed equal "
          f"{a_cmp['watershed_equal']}, camshift windows equal {a_cmp['camshift_windows_equal']}",
          flush=True)
    if not a["ok"]:
        fail(f"seg (a): the demo's verdict is DEGRADED (IoU {a['iou']}, error {a['err']}, basins {a['sizes']})")
    if not (a_cmp["grabcut_equal"] >= 0.999 and a_cmp["watershed_equal"]
            and a_cmp["camshift_windows_equal"]):
        fail(f"seg (a): the card differs from the CPU: {a_cmp}")

    rng = np.random.default_rng(1)
    s = SEG_SCALE
    img_b, blob_b, rect_b = grabcut_scene(480, 640, s, rng)
    surface_b, markers_b = watershed_scene(480, 640, s)
    frames_b, centres_b, win_b = camshift_scene(31, 4, rng)
    scenes = ((img_b, rect_b), (surface_b, markers_b), (frames_b, win_b))
    t0 = time.perf_counter()
    seg_run_b(scenes, dev)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    outs, secs, runs = warm_runs_of(lambda: seg_run_b(scenes, dev), WARM_RUNS)
    b = outs[0]
    fg = b["grabcut"].mask.cpu().numpy() % 2 == 1
    iou_b = float((fg & blob_b).sum() / max((fg | blob_b).sum(), 1))
    lab_b = b["watershed"].labels.cpu().numpy()
    sizes_b = {k: int((lab_b == k).sum()) for k in (1, 2)}
    err_b = centre_error(b["camshift"], centres_b)
    cam_cpu = camshift_track(frames_b, win_b, "cpu")
    cam_equal = [w for _, w in b["camshift"]] == [w for _, w in cam_cpu]

    img_s, _, rect_s = grabcut_scene(120, 160, 120 / 70, np.random.default_rng(2))
    gc_card = grabcut.grab_cut_stats(img_s, rect=rect_s, iter_count=1, device=dev)
    with torch_threads(1):
        gc_cpu = grabcut.grab_cut_stats(img_s, rect=rect_s, iter_count=1, device="cpu")
    small_equal = float((gc_card.mask.cpu() == gc_cpu.mask).float().mean())
    part_s = {k: statistics.median(o["secs"][k] for o in outs) for k in b["secs"]}
    warm = statistics.median(secs)
    res = dict(units=1, unit="run", s_warm=warm, s_warm_runs=secs, cold_s=cold, part_s=part_s,
               grabcut_iou=iou_b, grabcut_sweeps=b["grabcut"].sweeps,
               grabcut_capped=b["grabcut"].capped, watershed_sweeps=b["watershed"].sweeps,
               watershed_host_reads=b["watershed"].host_reads, basins=sizes_b,
               dams=int((lab_b == -1).sum()), camshift_err_px=err_b, camshift_card_equals_cpu=cam_equal,
               grabcut_120x160_card_vs_cpu_equal=small_equal, grabcut_120x160_sweeps=gc_card.sweeps,
               example_a=dict(iou=a["iou"], sweeps=a["sweeps"], basins=a["sizes"],
                              ws_sweeps=a["ws_sweeps"], camshift_err_px=a["err"], ok=a["ok"],
                              card_vs_cpu=a_cmp, card_s=a_s, cpu_s=a_cpu_s),
               launches=runs[0])
    print(f"[seg] (b) 480x640: grabcut IoU {iou_b:.4f}, sweeps per cut {b['grabcut'].sweeps} (capped "
          f"{b['grabcut'].capped}); watershed basins {sizes_b}, {res['dams']} dam px, "
          f"{b['watershed'].sweeps} sweeps, {b['watershed'].host_reads} host reads; camshift mean "
          f"centre error {err_b:.3f} px over 30 frames; seconds per part {{"
          + ", ".join(f"{k}: {v:.3f}" for k, v in part_s.items()) + f"}} (median of {WARM_RUNS}); warm "
          f"run {warm:.3f} s, cold {cold:.3f} s; card vs CPU: camshift windows equal {cam_equal}, "
          f"grabcut 120x160 (1 iteration, {gc_card.sweeps} sweeps) mask equal on {small_equal:.5f}; "
          f"launches {runs[0]}", flush=True)
    if not (cam_equal and small_equal >= 0.999):
        fail(f"seg (b): the card differs from the CPU (camshift windows equal {cam_equal}, grabcut "
             f"120x160 {small_equal:.5f})")
    if not all(np.isfinite([iou_b, err_b])):
        fail("seg (b): a non-finite IoU or centre error")
    return res


def phase_profile_slice7() -> None:
    """Where the time goes in one warm 480x640 panorama (estimate_panorama
    and stitch_panorama of 5 views) and in one 480x640 GrabCut iteration
    (one full min-cut)."""
    import torch

    from opencv_tpu_torch.ops import grabcut

    vb, _ = pano_views(PANO_B)
    pano_run(vb, PANO_B, "cuda")
    profile_report("profile pano 480x640", lambda: pano_run(vb, PANO_B, "cuda"), 1, "panorama")
    img, _, rect = grabcut_scene(480, 640, SEG_SCALE, np.random.default_rng(1))
    sweeps = grabcut.grab_cut_stats(img, rect=rect, iter_count=1).sweeps[0]
    torch.cuda.synchronize()
    profile_report("profile grabcut 480x640 1 iteration",
                   lambda: grabcut.grab_cut_stats(img, rect=rect, iter_count=1), sweeps, "sweep")


def phase_profile_slice6(base: np.ndarray) -> None:
    """Where the time goes in one warm run of the calibration app (8 board
    views, two calibrations, the circles view) and in stabilize over 8
    frames."""
    import torch

    from opencv_tpu_torch.ops import videostab

    views, obj, circles, _ = calibapp_views()
    calibapp_run(views, obj, circles)
    profile_report("profile calibapp", lambda: calibapp_run(views, obj, circles), len(views) + 1, "view")
    frames = stab_frames(base, 8)
    videostab.stabilize(frames)
    torch.cuda.synchronize()
    profile_report("profile stab", lambda: videostab.stabilize(frames), 8, "frame")


def profile_report(tag: str, fn, units: int, unit: str) -> None:
    """torch.profiler around one call of `fn` (which does `units` units of
    work): the device's busy share of the call's wall time (the sum of
    kernel times: no kernels overlap on one stream), launches per unit,
    the top kernels by device time and the top host operations by their
    own time. The profiler slows the host, so the busy share is a lower
    bound of the unprofiled run's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    print(f"[{tag}] wall {wall:.3f} s ({units / wall:.2f} {unit}s/s under the profiler), "
          f"{launches} kernels ({launches / units:.0f} per {unit})", flush=True)
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


def phase_profile(frames, K, tracker: str = "orb", warmup: int = 40, window: int = 8) -> None:
    """Where the time goes in steady tracking: profile_report over frames
    [warmup, warmup + window) of a fresh engine that has tracked the first
    `warmup` frames."""
    import torch

    from opencv_tpu_torch.core.config import ORBConfig
    from opencv_tpu_torch.slam.vo import VisualOdometry, VOConfig

    vo = VisualOdometry(K, VOConfig(orb=ORBConfig(n_features=2000), tracker=tracker), seed=0)
    vo.process_sequence(frames[:warmup], chunk=8)
    torch.cuda.synchronize()
    profile_report(f"profile {tracker} frames {warmup}-{warmup + window}",
                   lambda: vo.process_sequence(frames[warmup: warmup + window], chunk=8), window, "frame")


def phase_profile_geometry(frames, K) -> None:
    """Where the time goes in one warm two-view pair and in one warm
    calibrate_camera of the calib path's 20 views (its LM is the pattern
    of the stereo and fisheye refinements; profiling all three takes the
    profiler minutes to post-process)."""
    import torch

    from opencv_tpu_torch.geometry import calibration

    imgs = [torch.from_numpy(np.ascontiguousarray(frames[i])).to("cuda") for i in (0, 8)]
    two_view_pipeline(*imgs, K)
    profile_report("profile twoview", lambda: two_view_pipeline(*imgs, K), 1, "pair")
    objs, img1, _, _, _, _ = calib_views()
    calibration.calibrate_camera(objs, img1, device="cuda")
    profile_report("profile calibrate_camera",
                   lambda: calibration.calibrate_camera(objs, img1, device="cuda"), objs.shape[0], "view")


def phase_profile_hog() -> None:
    """Where the time goes in one warm HOG-mode frame of the TBD app
    (detectMultiScale over 28 scales, grouping, one Tracker step)."""
    import torch

    from opencv_tpu_torch.tbd import TbdConfig, Tracker

    w_np, b = fit_bar_svm("cuda")
    w = torch.from_numpy(w_np).to("cuda")
    frames, _ = bar_scene(8)
    frames = torch.from_numpy(frames).to("cuda")
    trk = Tracker(TbdConfig(), device="cuda")
    for t in range(7):
        trk.step(hog_detect(frames[t], w, b))
    torch.cuda.synchronize()
    profile_report("profile hog frame", lambda: trk.step(hog_detect(frames[7], w, b)), 1, "frame")


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
             "vo_klt": timed("vo_klt", phase_klt, frames, centres, K),
             "twoview": timed("twoview", phase_two_view, frames, K),
             "calib": timed("calib", phase_calib, frames[0]),
             "lsh": timed("lsh", phase_lsh, frames),
             "tbd": timed("tbd", phase_tbd),
             "hog": timed("hog", phase_hog),
             "dbt": timed("dbt", phase_dbt),
             "lane": timed("lane", phase_lane),
             "calibapp": timed("calibapp", phase_calibapp),
             "stab": timed("stab", phase_stab, frames[0]),
             "pano": timed("pano", phase_pano),
             "qr": timed("qr", phase_qr),
             "seg": timed("seg", phase_seg)}
    timed("profile orb", phase_profile, frames, K, "orb", 40, 4)
    timed("profile klt", phase_profile, frames, K, "klt", 40, 4)
    timed("profile geometry", phase_profile_geometry, frames, K)
    timed("profile hog", phase_profile_hog)
    timed("profile calibapp and stab", phase_profile_slice6, frames[0])
    timed("profile pano and grabcut", phase_profile_slice7)
    kernels = []
    for key, row in rows.items():
        by_path = {p: res["launches"][key] for p, res in paths.items()}
        kernels.append(dict(row, launches=sum(by_path.values()), launches_by_path=by_path,
                            launches_per_unit={p: by_path[p] / paths[p]["units"] for p in paths},
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
