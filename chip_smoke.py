"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --measure  # two warm runs a path, and the profiles

Phases:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: every kernel of csrc/ with nvcc for sm_90a and the host
     Munkres solver with g++, all in parallel;
  3. kernels vs plain on the card, at the shapes the main paths give them:
     K1 FAST score + NMS at the 8 ORB levels of a 480x640 frame (timed as
     the one multi-level launch ORB makes, and per level through the
     one-level entry), K2 FAST score for rings 16/12/8 (and at the shapes
     of [feat2]: BRISK's four sqrt(2) levels, rings 12 and 8 at 480x640),
     K3 streaming 2-NN Hamming at 2000 x 128000 x 256 bits and at 2000 x
     32000 x 512 bits, with ties and ~10% invalid rows, K4 LK window
     sampling at its three sites on the 480x640 level (templates C=3 win
     21, patches C=1 win 48 at integer origins, polish C=1 win 21; N = 2000
     and 512 (the LK path's), 32 (DetectionBasedTracker's) and 200
     (videostab's), with points
     on every border, outside, far outside and non-finite; each site timed
     beside grid_sample and its bound), K5
     edge-clamped windows (win 21, N = 512, interior points); all exact;
     device times by CUDA events (kernel, plain version, one PyTorch
     library call where one computes the same function; for K3 a bf16
     matmul and an int8 torch._int_mm, each with topk) beside the bound
     (K3's: the int8 tensor-core operations of its +-1 product), and the
     first designs' times as labelled constants (FIRST_DESIGN_MS); K6,
     the Schur-CG point pass, at the start problems of the benchmark's two
     cells on the CG's own inputs, every product and the group's halves
     within K6_RTOL of the plain version (k6_cell), timed beside the plain
     S p, the einsums alone and its byte bound;
  4. the twenty-seven paths, each cold, then warm WARM_RUNS times (once;
     twice with --measure, and then "the median" is of two), with the
     launch counts reset just before each warm run and read just after it:
     a. ORB VO: VisualOdometry.process_sequence on a seeded 480x640
        synthetic sequence at bench_config5's engine config
        (ORBConfig(n_features=2000), every other default, chunk=8), cold
        on the first COLD_FRAMES frames, then warm over all 120
        (frames/s is the median warm run, printed
        with the range); ATE against ground truth must be < 5 % of the
        path, with >= 10 keyframes and the state `tracking`;
     b. LK: bench.py config 2 on 100 frames of the scene (GFTT 512 corners,
        quality 0.01, min distance 7; LKConfig(win_size=21, n_levels=4);
        build_flow_pyramid once per frame, calc_optical_flow_pyr_lk_pyr,
        re-detection below 500 tracked), cold on COLD_FRAMES frames, then
        warm;
        checked against the same path on the CPU on 4 pairs (0.05 px,
        >= 99 % equal status) and on frame 0 shifted by (5, 3) px
        (every tracked corner 48 px inside within 0.35 px);
     c. klt VO: VisualOdometry(tracker="klt", n_features=2000).process_
        sequence over the 120 frames, cold on COLD_FRAMES frames, then warm
        (the median warm run, with the range); ATE < 5 % of the path,
        state `tracking`, frames tracked by LK > 0, K4 launched;
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
        then warm; the CPU's run gives the same confirmed IDs and
        MOT counters and boxes within 1e-3 px; tracking-only frames/s;
     h. hog: the TBD app in HOG mode: a linear SVM fitted on the port's
        descriptors of 60 + 60 bar windows (tests/test_hog.py's), 120
        frames 480x640 of 6 bar pedestrians, detectMultiScale at the
        reference's defaults (scale 1.05, 64 levels: 28 fit) with the
        hits grouped, a Tracker, MOTA against the planted boxes; HOG
        detection and frame frames/s; cold (8 frames) then warm;
        4 frames against the CPU (the same boxes, scores within 1e-3);
     i. dbt: DetectionBasedTracker with this detector every 4 frames and
        LK between on the first 32 frames of the scene, cold (8 frames)
        then warm; its level-0 LK must launch K4; 5 frames against the CPU
        (the same confirmed IDs, boxes within 0.05 px, the LK rule);
     j. lane: examples/lane_detection.py at 480x640 on 30 frames (blur,
        Canny, Hough segments): both lanes in every frame; cold then warm;
        frame 0 against the CPU (equal edges, segments within
        0.5 px);
     k. calibapp: examples/calibration_app.py's flow (8 views of its 7x5
        board rendered with warp_perspective at 480x640, seed 0;
        find_chessboard_corners per view, calibrate_camera, per-view
        reprojection error, the worst view dropped and recalibrated, the
        app's verdict: RMS < 0.8 px, fx and fy within 3 %) and a 5x4
        circles-grid view (find_circles_grid: connected components and
        blobs); every board found, verdict OK, circles within 0.5 px of
        their centres; cold then warm; the CPU's corners within
        1e-3 px, its circles grid equal; connected components' sweeps and
        host reads;
     l. stab: videostab.stabilize on 60 frames 480x640 (frame 0 of the
        scene moved by a random walk of N(0, 1.5) px steps; GFTT 200, LK
        at 3 levels: K4 at level 0, affine RANSAC, smoothing radius 5);
        cold then warm; jitter below 0.6 of the input's; the first
        5 pairs' motions on the CPU within 0.05 px; find_transform_ecc
        ("affine") on 3 pairs against their RANSAC motion, Wiener
        deblurring of one frame, wobble suppression of the motions;
     apps: the port's seven applications (opencv_tpu_torch/examples/)
        through their main() on the card, once each, at their defaults,
        and vo_synthetic also at --frames 60 (where its loop closure
        retrieves keyframes through K3); each must be ok, with its figures
        within their bounds of the JAX examples' own on a CPU
        (JAX_FIGURES_SLICE13, from tools/jax_slice13_figures.py); K1 and K3
        bit for bit against their plain versions at the apps' own calls;
     m. pano: the panorama app's card run from [apps] against the app on
        the CPU, 5 views of 480x640 (estimate_panorama and
        stitch_panorama) cold then warm, stitch_pair on two of them
        against the CPU; K1 bit for bit against its plain version on
        every view's 4-level ORB pyramid;
     n. qr: the qr_demo app's card run from [apps] against the app on
        the CPU, and 24 scenes of 480x640 (versions 1-3), detect and
        decode, every text read, the CPU's quads and texts equal;
     o. seg: the segmentation_demo app's card run from [apps] (GrabCut,
        watershed, CamShift at its sizes, its verdict) against the app on
        the CPU, and the scenes at 480x640; card against CPU;
     p. feat2: AGAST (four kinds), BRISK and AKAZE (matched 0<->8, the
        share within 2 px of the true epipolar line), MSER on frames 0
        and 8, and frame 24's AKAZE rows against those of frames 0-15
        through knn_match_auto (K3 at 512 bits, equal to the dense
        matcher); K2 and K3 launched; card against CPU;
     q. stereo: BM, SGBM, BP and CSBP on a rectified 480x640 pair (8, 24
        and 40 px, 64 disparities): bad-pixel rates within the JAX tests'
        bounds or at the JAX package's own figure (JAX_FIGURES, from
        tools/jax_slice8_figures.py), SGBM reprojected to 3D; card
        against CPU at 120x160;
     r. flow: Farneback, TV-L1 and Brox on frame 0 and frame 0 moved by
        (3, 2) px and 0.5 deg (endpoint errors, interior medians within
        the JAX tests' bounds), interpolate_frames at t = 0.5, BTV-L1
        super-resolution of 8 frames of 240x320 with Farneback flows;
        card against CPU at 240x320;
     s. bgfg: video analytics on crowd_gt()'s 40 boxes painted over frame 0
        (120 frames 480x640, N(0, 2) noise): MOG2, KNN, GMG and FGD per
        frame, MOG2's mask opened (3), contours, boxes of area >= 50 px;
        box recall and precision at IoU >= 0.5 beside the JAX package's;
        card against CPU on 10 frames from one state;
     t. photo: NLM, Telea and diffusion inpainting, seamless cloning, the
        HDR chain (MTB alignment, Debevec and Robertson responses, merge,
        tonemap, Mertens), TV-L1 denoising, decolor and the four
        domain-transform filters at 480x640, each figure against the JAX
        tests' bound; card against CPU on 120x160;
     u. imgops: histograms and CLAHE, colour round trips, template
        matching, phase correlation, distance transform, flood fill,
        mean-shift segmentation, LSD and shape distances at 480x640;
        card against CPU;
     v. cascade: a Haar and an LBP cascade trained on the card at the
        trainer's defaults (24x24, 8 stages) on 1 000 ring objects, written
        to XML and read back, detect_multi_scale / _lbp on 60 seeded 480x640
        scenes (recall, precision, frames/s; card against CPU on 3 scenes),
        tests/test_traincascade.py's small trainings on the card and the
        CPU (equal models);
     w. dnn: tests/fixtures/tiny_cnn.onnx against its expected output, and
        darknet's YOLOv2-tiny-VOC at 416x416 with seeded weights through
        load_darknet, region decode and NMS at batch 1 and 8 (images/s,
        FLOPs, share of the f32 peak; card against CPU); then at torch's
        default TF32 switches: the unguarded layers' error and forward
        time (what TF32 would give), and the repaired Net.forward held to
        the CPU;
     x. clip: bench.py config 2 on the first 100 frames of the committed
        benchmarks/data/megamind_gray.avi at 528x720, decoded by the
        port's reader with PIL blocked and held to the JAX reader's
        SHA-256; K4 launched; 4 pairs against the CPU (the LK rule);
     y. ml: letter_recog's models at its size on seeded data (kNN, naive
        Bayes, MLP, random forest; linear and RBF SVM, logistic
        regression, SVMSGD, AdaBoost and GBT on one letter against the
        rest), k-means of 100 000 descriptor rows, GMM EM; accuracies
        within 0.01 of the JAX package's (tools/jax_slice11_figures.py);
        card against CPU on a 2 000-row subset with the same draws;
     z. dist: parallel/ on torch.distributed at the JAX package's global-BA
        scale (100 keyframes x 100 000 points, 8 views a point, 800 000
        observations): (a) bundle_adjust_sharded at world 1 over NCCL
        against the single-device CG solver, the same bits under
        deterministic algorithms; (b) two ranks sharing the card over gloo,
        against the single-device solver within 4x its sensitivity to its
        summation order (or 1e-3);
        (c) the map-sharded 2-NN at world 1, 2000 x 128 000 x 256 bits,
        through K3 equal to knn_match_auto and through the dense block
        equal to knn_match; (d) dryrun_multichip(1); each rank process
        under a timeout;
  5. profile (with --measure only): torch.profiler over frames 24-25 of steady tracking of the
     ORB engine and of the klt engine, one two-view
     pair, one calibrate_camera of 20 views, one warm HOG-mode frame
     (detect and track), one warm calibration-app run, stabilize over
     4 frames, one 480x640 panorama, one 480x640 GrabCut iteration, one
     480x640 SGBM disparity, one 480x640 TV-L1 pair at one warp a level,
     one [bgfg] frame
     and one 480x640 nl_means_denoise, one 480x640 Haar detection, one
     YOLOv2-tiny-VOC image and one LM iteration of [dist]'s CG solver (device busy
     share, kernels per unit, top kernels, top host operations).
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
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# H100 SXM memory rate (NVIDIA data sheet, at a 700 W limit) and per-SM
# issue rates of compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput), priced at the card's max SM clock
HBM_BYTES_PER_S = 3.35e12
FP32_ADD_PER_CLK_PER_SM = 128  # FADD; f32 min/max (FMNMX) issue no faster
POPC_PER_CLK_PER_SM = 16  # 32-bit __popc: the ceiling of K3's first design
INT8_TOPS = 1.979e15  # dense int8 tensor-core operations per second (data sheet, 700 W)

# Warm runs of each path after its cold run: one in the default run (the
# smoke check must end inside its time limit on a slow host), two with
# --measure (the median and range that PERF.md records, and the profiles)
WARM_RUNS = 1

# Device ms of the first designs of K1/K2 (one launch per level, runtime
# arc), K4/K5 (one block per point) and K3 (a CUDA-core thread per query,
# popcounts; at 2000 x 128 000 x 256 and 2000 x 32 000 x 512 bits),
# measured by this script before their redesign on an NVIDIA H100 80GB
# HBM3 at 700.00 W. Constants, not
# re-measured (the old kernels are gone): printed, labelled, in the [K…]
# lines beside this run's times, and kept out of the measured `kernels`
# record.
FIRST_DESIGN_MS = {"fast_corners": 0.1119, "fast_score": 0.0179, "lk_sample": 0.0601,
                   "lk_sample_n512": 0.0232, "lk_sample_clamp": 0.0044,
                   "knn2_hamming": 0.6271, "knn2_hamming_512": 0.3071}

# SHA-256 of the first 100 frames of benchmarks/data/megamind_gray.avi as
# the JAX package's reader (PIL) decodes them, uint8 [100, 528, 720] in C
# order; [clip] holds the port's decode on the card's host to it, and
# tests/test_torch_io.py holds it to the JAX reader
CLIP_SHA256 = "91a889b955006465fafa0f4c1d981b35fbca642ea72cdca41652e3698d89486f"

# K4's point counts: the LK path's 2000 and 512, DetectionBasedTracker's 32,
# videostab's 200 (GFTT's max_corners)
K4_N = (2000, 512, 32, 200)

# K6 at the start problems of the benchmark's cells (BENCHMARK.json's
# configurations and traffic, portbench/generate.py at this seed), and
# its tolerance against the plain version: each product's entries within
# K6_RTOL of its largest (f32 sums in another order; a missed or doubled
# observation moves an entry by ~1e-2 of it)
K6_CELLS = {"ba.kitti07.cg": ("kitti07-orbslam2", "seq-07.global-ba"),
            "ba.kitti00.cg": ("kitti00-orbslam2", "seq-00.global-ba")}
K6_SEED = 2147483649
K6_RTOL = 1e-4
K6_LAUNCH_KEYS = ("schur_cg_full", "schur_cg_hz", "schur_cg_back", "schur_cg_g", "schur_cg_update")


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
    try:
        import PIL

        pil = f"PIL {PIL.__version__} imports"
    except ImportError:
        pil = "PIL does not import"
    print(f"[device] {card} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()} | {n_sm} SMs, "
          f"max SM clock {sm_hz / 1e6:.0f} MHz | {pil}", flush=True)
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
    lib_ms, lib8_ms = k3_library_ms(query, train, valid)
    n_valid = int(valid.sum())
    b3 = (nq + nt) * 32 + nt + nq * 16
    o3 = 2 * nq * n_valid * 256  # the +-1 product's int8 operations
    bound = max(b3 / HBM_BYTES_PER_S, o3 / INT8_TOPS) * 1e3
    rows["knn2_hamming"] = dict(
        name="knn2_hamming (K3: streaming 2-NN Hamming, ratio test outside)", route="cuda",
        source="opencv_tpu_torch/csrc/knn2_hamming.cu",
        replaces="opencv_tpu/ops/pallas/knn.py:30",
        max_abs_err=err3, ms=k3_ms, plain_ms=k3_pl, library_ms=lib_ms, library_int8_ms=lib8_ms,
        bound_ms=bound, bound_by="bytes" if b3 / HBM_BYTES_PER_S >= o3 / INT8_TOPS else "operations",
        shapes=[(nq, 8), (nt, 8)],
    )
    print(f"[K3] exact on d1/d2/i1 ({n_ties} queries with d1 == d2, {nt - n_valid} invalid "
          f"rows); kernel {k3_ms:.4f} ms (first design, a constant: "
          f"{FIRST_DESIGN_MS['knn2_hamming']} ms; its popcount ceiling "
          f"{nq * n_valid * 8 / rates['popc'] * 1e3:.4f} ms), int8 tensor-core bound {bound:.4f} ms "
          f"({100 * bound / k3_ms:.1f} % of it), plain {k3_pl:.4f} ms, bf16 matmul+topk {lib_ms:.4f} ms, "
          f"int8 _int_mm+topk {lib8_ms:.4f} ms", flush=True)
    phase_kernels_slice8(lvl0, rates, rows)
    rows.update(phase_lk_kernels(lvl0, rates))
    rows["schur_cg"] = phase_k6_kernel()
    return rows


def k6_bound_bytes(n_obs: int, n_pts: int, n_cams: int) -> int:
    """The bytes a Schur-CG product must move: A (72 B) and its camera
    (4 B) an observation, the point offsets (4 B) and V^-1 (36 B) a
    point, x and h (24 B each) a camera."""
    return n_obs * 76 + n_pts * 40 + n_cams * 48


def k6_cell(cell: str) -> dict:
    """K6 at `cell`'s start problem (K6_SEED), on the CG's own inputs: the
    right-hand side, the first search direction p0 (S p0) and the dc of a
    whole `schur_cg_solve` (the back-substitution). Every product, S p and
    the back-substitution also by the halves a process group runs (the
    fused pass's bits: the world-1 sharded solver relies on it), against
    the plain version in float64 within K6_RTOL; then device times (the
    plain S p in float32, as the solver ran it before K6)."""
    import torch

    from opencv_tpu_torch.device import no_tf32
    from opencv_tpu_torch.ops.cuda import schur_cg
    from opencv_tpu_torch.optim import ba
    from portbench.generate import make_problem

    dev = torch.device("cuda")
    cfg_name, traffic_name = K6_CELLS[cell]
    with open(os.path.join(REPO, "portbench", "configs", f"{cfg_name}.json")) as f:
        config = json.load(f)
    with open(os.path.join(REPO, "portbench", "traffic", f"{traffic_name}.json")) as f:
        traffic = json.load(f)
    p = ba.BAProblem(**make_problem(config, traffic, K6_SEED, dev))
    C, P, O = p.cam_rvec.shape[0], p.points.shape[0], p.obs_cam.shape[0]
    lam = torch.tensor(traffic["lambda0"], dtype=torch.float32, device=dev)
    with no_tf32():
        eqs = ba.normal_equations(p)
        Ud = eqs.U + lam * torch.eye(6, device=dev)[None]
        Vinv = torch.linalg.inv_ex(eqs.V + lam * torch.eye(3, device=dev)[None])[0]
        Minv = torch.linalg.inv_ex(Ud)[0]
        mask = torch.where(p.fixed_cams, 0.0, 1.0)[:, None]
        A, cam, pt = eqs.A, p.obs_cam, p.obs_pt

        def layout():
            return schur_cg.SchurProducts(A, cam, pt, Vinv, mask, C, P)

        k = layout()
        h_bp = k.w_vinv(eqs.bp)
        rhs = k.finish(h_bp, base=eqs.bc)
        x = k.cg_start(rhs, Minv).p.clone()
        dc, _ = ba.schur_cg_solve(eqs, cam, pt, lam, p.fixed_cams, traffic["cg_iters"])
        g = k.wt_x(x)
        got = {"smv": k.smv(x, Ud), "smv_halves": k.finish(k.w_vinv(g), ud=Ud, x=x), "rhs": rhs,
               "back": k.back(dc, eqs.bp), "back_halves": k.apply_vinv(eqs.bp - k.wt_x(dc)),
               "wt_x": g, "w_vinv": h_bp}

        def plain(dt):
            """Every product by the plain version, in dtype dt."""
            A_, Vinv_, Ud_, mask_, x_, dc_, bp, bc = (t.to(dt) for t in (A, Vinv, Ud, mask, x, dc, eqs.bp, eqs.bc))

            def w_vinv(gv):
                return schur_cg.w_z_plain(A_, cam, pt, torch.einsum("pij,pj->pi", Vinv_, gv), C)

            xm = x_ * mask_
            g_ = schur_cg.wt_x_plain(A_, cam, pt, xm, P)
            out = {"smv": (torch.einsum("cij,cj->ci", Ud_, xm) - w_vinv(g_)) * mask_,
                   "rhs": (bc - w_vinv(bp)) * mask_,
                   "back": torch.einsum("pij,pj->pi", Vinv_, bp - schur_cg.wt_x_plain(A_, cam, pt, dc_ * mask_, P)),
                   "wt_x": g_, "w_vinv": w_vinv(bp)}
            out["smv_halves"], out["back_halves"] = out["smv"], out["back"]
            return out

        # against the plain version in float64: the kernel's own rounding, not the plain f32's too
        want = plain(torch.float64)
        torch.cuda.synchronize()
        rel = {n: float((got[n].double() - w).abs().max() / w.abs().max()) for n, w in want.items()}
        abs_err = max_abs_err(*((got[n], w) for n, w in want.items()))
        halves_equal = {n: bool(torch.equal(got[f"{n}_halves"], got[n])) for n in ("smv", "back")}
        del want
        xm = x * mask
        z = torch.einsum("pij,pj->pi", Vinv, schur_cg.wt_x_plain(A, cam, pt, xm, P))

        def plain_smv():
            g_ = schur_cg.wt_x_plain(A, cam, pt, xm, P)
            h_ = schur_cg.w_z_plain(A, cam, pt, torch.einsum("pij,pj->pi", Vinv, g_), C)
            return (torch.einsum("cij,cj->ci", Ud, xm) - h_) * mask

        hbuf = k.h_buffer()
        ms = {"pass": device_time_ms(lambda: k.launch("full", x=x, mask=k.mask_c, hout=hbuf)),
              "smv": device_time_ms(lambda: k.smv(x, Ud)),
              "rhs": device_time_ms(lambda: k.finish(k.w_vinv(eqs.bp), base=eqs.bc)),
              "back": device_time_ms(lambda: k.back(dc, eqs.bp)),
              "plain_smv": device_time_ms(plain_smv, calls=3),
              "library": device_time_ms(lambda: (torch.einsum("oij,oi->oj", A, xm[cam]),
                                                 torch.einsum("oij,oj->oi", A, z[pt])), calls=3),
              "layout": device_time_ms(layout, calls=3)}
    bound_ms = 1e3 * k6_bound_bytes(O, P, C) / HBM_BYTES_PER_S
    out = dict(cameras=C, points=P, observations=O, accumulator=k.acc, stages=k.stages, blocks=k.blocks,
               rel_err=rel, max_abs_err=abs_err, halves_bits_equal=halves_equal, ms=ms, bound_ms=bound_ms,
               pass_of_bound_pct=100 * bound_ms / ms["pass"])
    print(f"[K6] {cell}: {C} cameras, {P} points, {O} observations, accumulator {k.acc} ({k.stages} stages, "
          f"{k.blocks} blocks); largest error of each product against the plain version, over its largest "
          f"entry: " + ", ".join(f"{n} {e:.2e}" for n, e in rel.items()) + f" (bound {K6_RTOL:g}); the "
          f"halves give the fused pass's bits: {halves_equal}; FULL pass {ms['pass']:.4f} ms = "
          f"{out['pass_of_bound_pct']:.1f} % of its bound {bound_ms:.5f} ms (bytes), S p with the reduce "
          f"{ms['smv']:.4f} ms, right-hand side {ms['rhs']:.4f} ms, back-substitution {ms['back']:.4f} ms, "
          f"layout {ms['layout']:.4f} ms; plain S p {ms['plain_smv']:.4f} ms, the two einsums alone (cuBLAS's "
          f"batched gemv) {ms['library']:.4f} ms", flush=True)
    bad = [n for n, e in rel.items() if not e <= K6_RTOL] + [f"{n} by the halves" for n, eq in halves_equal.items()
                                                            if not eq and k.acc != "global"]
    if bad:
        fail(f"K6 at {cell}: {bad} (errors {rel}, halves equal {halves_equal})")
    return out


def phase_k6_kernel() -> dict:
    """K6's row: k6_cell at both cells; the row's times are kitti07's."""
    import torch

    cells = {}
    for cell in K6_CELLS:
        cells[cell] = k6_cell(cell)
        torch.cuda.empty_cache()
    first = cells["ba.kitti07.cg"]
    return dict(
        name="schur_cg (K6: the Schur-CG point pass, S p in one read of A (FULL mode); camera reduce; "
             "one-block CG update)",
        route="cuda", source="opencv_tpu_torch/csrc/schur_cg.cu",
        replaces="none: no Pallas kernel (the JAX package's XLA gathers and segment-sums in "
                 "opencv_tpu/optim/ba.py schur_cg_solve)",
        max_abs_err=max(c["max_abs_err"] for c in cells.values()), ms=first["ms"]["pass"],
        plain_ms=first["ms"]["plain_smv"], library_ms=first["ms"]["library"], bound_ms=first["bound_ms"],
        bound_by="bytes", shapes=[(c["observations"], 6, 3) for c in cells.values()], cells=cells,
        launch_keys=K6_LAUNCH_KEYS)


def phase_kernels_slice8(lvl0, rates: dict, rows: dict) -> None:
    """K2 at the shapes of the [feat2] path: BRISK's four sqrt(2) levels of
    a 480x640 frame (ring 16, arc 9: AGAST 9_16) and rings 12/7 and 8/5
    (AGAST 7_12s and 5_8) at 480x640; K3 at 512 bits (2000 x 32 000, with
    ties and ~10 % invalid rows). All exact against the plain versions,
    timed beside their bounds; the figures join the rows of K2 and K3."""
    import torch

    from opencv_tpu_torch.core import pyramid
    from opencv_tpu_torch.ops.cuda import fast_kernel, knn

    dev = lvl0.device

    def k2_case(levels, ring, arc):
        err = 0.0
        for lvl in levels:
            a = fast_kernel.fast_score_cuda(lvl, arc, ring)
            b = fast_kernel.fast_score_plain(lvl, arc, ring)
            torch.cuda.synchronize()
            err = max(err, max_abs_err((a, b)))
            if not torch.equal(a, b):
                fail(f"K2 differs from its plain version at {tuple(lvl.shape)} (ring {ring}, arc "
                     f"{arc}): {(a != b).sum().item()} values")
        ms = sum(device_time_ms(lambda lvl=lvl: fast_kernel.fast_score_cuda(lvl, arc, ring))
                 for lvl in levels)
        plain = sum(device_time_ms(lambda lvl=lvl: fast_kernel.fast_score_plain(lvl, arc, ring), calls=3)
                    for lvl in levels)
        npx = sum(lvl.numel() for lvl in levels)
        b_s, o_s = npx * 8 / HBM_BYTES_PER_S, npx * fast_score_ops(ring, arc) / rates["fp32_add"]
        return err, ms, plain, max(b_s, o_s) * 1e3, "bytes" if b_s >= o_s else "operations"

    brisk_levels = list(pyramid.build_pyramid(lvl0, 4, 2 ** 0.5).levels)
    row = rows["fast_score"]
    for key, levels, ring, arc in (("brisk_levels", brisk_levels, 16, 9), ("ring12", [lvl0], 12, 7),
                                   ("ring8", [lvl0], 8, 5)):
        err, ms, plain, bound, by = k2_case(levels, ring, arc)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row.update({f"{key}_ms": ms, f"{key}_plain_ms": plain, f"{key}_bound_ms": bound,
                    f"{key}_bound_by": by, f"{key}_shapes": [tuple(x.shape) for x in levels]})
        print(f"[K2] {key} ({', '.join(f'{x.shape[0]}x{x.shape[1]}' for x in levels)}; ring {ring}, arc "
              f"{arc}): exact; kernel {ms:.4f} ms ({len(levels)} launches), plain {plain:.4f} ms, bound "
              f"{bound:.5f} ms ({by})", flush=True)

    g = torch.Generator(device=dev)
    g.manual_seed(4)
    nq, nt = 2000, 32000
    lo, hi = -(2 ** 31), 2 ** 31
    train = torch.randint(lo, hi, (nt, 16), generator=g, device=dev, dtype=torch.int64).to(torch.int32)
    train[16000:18000] = train[0:2000]  # duplicate rows: exact ties across splits
    query = torch.randint(lo, hi, (nq, 16), generator=g, device=dev, dtype=torch.int64).to(torch.int32)
    query[:1000] = train[torch.arange(0, 2000, 2, device=dev)]
    query[:1000, 0] ^= 1
    valid = torch.rand(nt, generator=g, device=dev) > 0.1
    got = knn.knn2_hamming_cuda(query, train, valid)
    want = knn.knn2_hamming_plain(query, train, valid)
    torch.cuda.synchronize()
    err = max_abs_err(*zip(got, want))
    for nm, a, b in zip(("d1", "d2", "i1"), got, want):
        if not torch.equal(a, b):
            fail(f"K3 at 512 bits: {nm} differs from its plain version: {(a != b).sum().item()} queries")
    ms = device_time_ms(lambda: knn.knn2_hamming_cuda(query, train, valid), calls=5)
    plain = device_time_ms(lambda: knn.knn2_hamming_plain(query, train, valid), calls=2)
    lib_ms, lib8_ms = k3_library_ms(query, train, valid)
    n_valid = int(valid.sum())
    b_s = ((nq + nt) * 64 + nt + nq * 16) / HBM_BYTES_PER_S
    o_s = 2 * nq * n_valid * 512 / INT8_TOPS  # the +-1 product's int8 operations
    bound = max(b_s, o_s) * 1e3
    row = rows["knn2_hamming"]
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row.update(ms_512=ms, plain_ms_512=plain, library_ms_512=lib_ms, library_int8_ms_512=lib8_ms,
               bound_ms_512=bound, bound_by_512="bytes" if b_s >= o_s else "operations",
               shapes_512=[(nq, 16), (nt, 16)])
    print(f"[K3] 512 bits, {nq} x {nt}: exact on d1/d2/i1 ({int((got[0] == got[1]).sum())} queries with "
          f"d1 == d2, {nt - n_valid} invalid rows); kernel {ms:.4f} ms (first design, a constant: "
          f"{FIRST_DESIGN_MS['knn2_hamming_512']} ms), int8 tensor-core bound {bound:.4f} ms "
          f"({100 * bound / ms:.1f} % of it; {row['bound_by_512']}), plain {plain:.4f} ms, bf16 "
          f"matmul+topk {lib_ms:.4f} ms, int8 _int_mm+topk {lib8_ms:.4f} ms", flush=True)


def k3_library_ms(query, train, valid) -> tuple[float, float]:
    """Device ms of the same 2-NN through one PyTorch product and topk(2),
    invalid rows pushed beyond FAR: the +-1 codes as a bf16 matmul, and as
    int8 through torch._int_mm. Yardsticks only; the port calls neither."""
    import torch

    from opencv_tpu_torch.ops.cuda import knn

    bits = 32 * query.shape[1]
    sq = knn.signed_descriptors(query)
    st = knn.signed_descriptors(train)
    big = torch.where(valid, 0.0, 4.0 * bits)
    sq16, st16, big16 = sq.to(torch.bfloat16), st.to(torch.bfloat16), big.to(torch.bfloat16)

    def bf16():
        return torch.topk((bits - sq16 @ st16.T) * 0.5 + big16, 2, dim=1, largest=False)

    sq8, st8, big32 = sq.to(torch.int8), st.to(torch.int8), big.to(torch.int32)
    del sq, st

    def int8():
        return torch.topk((bits - torch._int_mm(sq8, st8.T)) // 2 + big32, 2, dim=1, largest=False)

    out = device_time_ms(bf16, calls=3), device_time_ms(int8, calls=3)
    del bf16, int8, sq16, st16, big16, sq8, st8, big32
    torch.cuda.empty_cache()
    return out


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


def phase_main_path(frames, centres, K) -> dict:
    import torch

    from opencv_tpu_torch.core.config import ORBConfig
    from opencv_tpu_torch.slam.vo import VisualOdometry, VOConfig
    from opencv_tpu_torch.utils.evaluate import ate_rmse

    cfg = VOConfig(orb=ORBConfig(n_features=2000))
    n = frames.shape[0]
    t0 = time.perf_counter()
    VisualOdometry(K, cfg, seed=0).process_sequence(frames[:COLD_FRAMES], chunk=8)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0

    def run():
        vo = VisualOdometry(K, cfg, seed=0)
        return vo, vo.process_sequence(frames, chunk=8)

    outs, warm_s, runs = warm_runs_of(run, WARM_RUNS)
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
               warm_s=warm, cold_s=cold, cold_frames=COLD_FRAMES, ate=ate, path=path,
               ate_pct=100 * ate / path, keyframes=len(vo.keyframes),
               loop_closures=vo.loop_closures, relocalizations=vo.relocalizations,
               state=vo.state, launches=counts)
    print(f"[main] {n} frames 480x640: warm {warm:.3f} s ({n / warm:.2f} frames/s, median "
          f"of {WARM_RUNS} runs, range {n / max(warm_s):.2f} to {n / min(warm_s):.2f}), cold "
          f"{cold:.3f} s on {COLD_FRAMES} frames; ATE {ate:.5f} = {100 * ate / path:.3f} % of path {path:.3f}; "
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


def lk_card_vs_cpu(clip, cfg, dev: str, n_pairs: int = 4):
    """The first `n_pairs` pairs of `clip` through calc_optical_flow_pyr_lk
    on the card and on the CPU from the same GFTT corners, each pair
    starting from the card's tracks. Returns (largest difference in px
    over points tracked in both, status agreement per pair, points
    tracked in both)."""
    from opencv_tpu_torch.ops import gftt, lk

    kp = gftt.good_features_to_track(clip[0], max_corners=512, quality_level=0.01,
                                     min_distance=7.0, device=dev)
    pts, valid = kp.xy, kp.valid
    worst, agree, n_both = 0.0, [], 0
    for f in range(n_pairs):
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
    return worst, agree, n_both


def phase_lk_path(frames, dev: str = "cuda") -> dict:
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
    lk_config2_run(clip[:COLD_FRAMES], cfg, dev)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    outs, warm_s, runs = warm_runs_of(lambda: lk_config2_run(clip, cfg, dev), WARM_RUNS)
    if any(c["lk_sample"] <= 0 for c in runs):
        fail("kernel lk_sample was not launched on the LK path")
    (tracked, redetect), counts = outs[0], runs[0]
    warm = statistics.median(warm_s)
    per_pair = counts["lk_sample"] / (n - 1)

    # (a) 4 pairs: the card against the port on the CPU, the same points
    worst, agree, n_both = lk_card_vs_cpu(clip, cfg, dev)
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
               warm_s=warm, cold_s=cold, cold_frames=COLD_FRAMES, tracked_mean=float(np.mean(tracked)),
               tracked_min=int(np.min(tracked)), redetections=redetect,
               k4_launches_per_pair=per_pair, cpu_check_max_px=worst,
               cpu_check_status_agreement=min(agree), shift_check_max_px=shift_err,
               launches=counts)
    print(f"[lk] {n} frames 480x640, GFTT 512 + LK win 21 x 4 levels: warm {warm:.3f} s "
          f"({n / warm:.2f} frames/s, median of {WARM_RUNS} runs, range "
          f"{n / max(warm_s):.2f} to {n / min(warm_s):.2f}), cold {cold:.3f} s on {COLD_FRAMES} frames; tracked per pair "
          f"mean {res['tracked_mean']:.1f}, min {res['tracked_min']}; {redetect} re-detections; "
          f"K4 launches per pair {per_pair:.2f}; launches {counts}", flush=True)
    return res


def phase_klt(frames, centres, K) -> dict:
    """The VO engine with the klt tracker, cold then warm WARM_RUNS
    times (frames/s is the median warm run, printed with the range)."""
    import torch

    from opencv_tpu_torch.core.config import ORBConfig
    from opencv_tpu_torch.slam.vo import VisualOdometry, VOConfig
    from opencv_tpu_torch.utils.evaluate import ate_rmse

    cfg = VOConfig(orb=ORBConfig(n_features=2000), tracker="klt")
    n = frames.shape[0]
    t0 = time.perf_counter()
    VisualOdometry(K, cfg, seed=0).process_sequence(frames[:COLD_FRAMES])
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    def run():
        vo = VisualOdometry(K, cfg, seed=0)
        return vo, vo.process_sequence(frames)

    outs, warm_s, runs = warm_runs_of(run, WARM_RUNS)
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
               warm_s=warm, cold_s=cold, cold_frames=COLD_FRAMES, ate=ate, path=path,
               ate_pct=100 * ate / path, keyframes=len(vo.keyframes), lk_tracked=vo.lk_tracked,
               relocalizations=vo.relocalizations, state=vo.state, launches=counts)
    print(f"[klt] {n} frames 480x640: warm {warm:.3f} s ({n / warm:.2f} frames/s, median of "
          f"{WARM_RUNS} runs, range {n / max(warm_s):.2f} to {n / min(warm_s):.2f}), cold "
          f"{cold:.3f} s on {COLD_FRAMES} frames; ATE {ate:.5f} = {100 * ate / path:.3f} % of path {path:.3f}; "
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

# hog's and dbt's cold run takes the scene's first 8 frames: they load every
# kernel and cuDNN plan of the warm runs (all 28 scales; detector frames
# and LK frames) at a fraction of a whole run's time
COLD_FRAMES = 8
METRICS_FROM = 5  # MotMetrics from this frame on, as examples/tbd_app.py


def _sum_counts(*counts: dict) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def tbd_app_gt() -> list[np.ndarray]:
    """The tbd app's scene (opencv_tpu_torch/examples/tbd_app.py) over 60
    frames: [T, N, 4] boxes of its three pedestrians (class 0) and two
    vehicles (class 1)."""
    from opencv_tpu_torch.examples.tbd_app import gt_boxes

    boxes = [gt_boxes(t) for t in range(60)]
    return [np.stack([b[c] for b in boxes]) for c in (0, 1)]


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
    """The lane app's road (opencv_tpu_torch/examples/lane_detection.py)
    on 480x640 at LANE_SCALE times its coordinates: two converging lanes
    (2 px thick, 220) on uniform noise 20-60."""
    from opencv_tpu_torch.examples.lane_detection import draw_line

    img = rng.uniform(20, 60, size=(480, 640)).astype(np.float32)
    for lane in LANES:
        draw_line(img, *(LANE_SCALE * v for v in lane))
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
    summed (the lane app's bound of 2 x 12 px, at twice its scale)?"""
    from opencv_tpu_torch.examples.lane_detection import has_segment_near

    return [has_segment_near(xyxy, *(LANE_SCALE * v for v in lane), tol=12 * LANE_SCALE) for lane in LANES]


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

CIRCLES_STEP, CIRCLES_R = 110, 27  # a 5x4 grid of dark disks filling 480x640


def calibapp_views(n_views: int = 8, dev: str = "cuda"):
    """The calibration app's views (opencv_tpu_torch/examples/
    calibration_app.py: its 7x5 board, 40 px squares of 0.1 m, rendered
    with warp_perspective through its K_GT at its seeded poses, 480x640),
    and one circles-grid view: tests/test_msseg_circles.py's `_grid_image`
    drawing (dark disks of 30 on 220) for a 5x4 grid at step 110 px and
    radius 27, centred in 480x640. Returns (board views on the device,
    board object points [35, 3], circles view, true centres)."""
    import torch

    from opencv_tpu_torch.examples import calibration_app as app

    views, obj = app.views(n_views, 0.0, dev), app.object_points()
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

    from opencv_tpu_torch.examples.calibration_app import COLS, K_GT, ROWS
    from opencv_tpu_torch.geometry import calibration
    from opencv_tpu_torch.ops import chessboard

    found, det_s = [], []
    for img in views:
        t0 = time.perf_counter()
        c = chessboard.find_chessboard_corners(img, (COLS, ROWS), device=dev)
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
    ok = bool(best.rms < 0.8 and abs(best.K[0, 0] - K_GT[0, 0]) < 0.03 * K_GT[0, 0]
              and abs(best.K[1, 1] - K_GT[1, 1]) < 0.03 * K_GT[1, 1])
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

    from opencv_tpu_torch.examples.calibration_app import COLS, K_GT, ROWS
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
        cpu = chessboard.find_chessboard_corners(img.cpu(), (COLS, ROWS), device="cpu")
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
          f"{r1.K[0, 0]:.2f} (truth {K_GT[0, 0]:.1f}) fy {r1.K[1, 1]:.2f} (truth {K_GT[1, 1]:.1f}) cx "
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


# ------------------------------------------------------------ [apps]: the port's applications

# The port's seven applications (opencv_tpu_torch/examples/) as [apps] runs
# them: each at its defaults, and vo_synthetic also at its own flag
# --frames 60. At its default 20 frames vo_synthetic makes 3 keyframes, and
# its loop closure retrieves keyframes (K3 against the DB of 64 x 600 =
# 38 400 rows) only past loop_exclude_recent + 1 = 9 keyframes: at 60
# frames it makes 11 and retrieves twice.
APP_RUNS = {"tbd_app": [], "lane_detection": [], "vo_synthetic": [], "vo_synthetic_60": ["--frames", "60"],
            "calibration_app": [], "segmentation_demo": [], "qr_demo": [], "panorama": []}

# The JAX package's own figures of its examples/ on a CPU, as each prints
# them (tools/jax_slice13_figures.py): [apps] holds the card's to them
JAX_FIGURES_SLICE13 = {"tbd_app": {"pedestrians": {"mota": 1.0, "motp": 0.884, "tp": 165, "fp": 0, "fn": 0},
                                   "vehicles": {"mota": 1.0, "motp": 0.93, "tp": 110, "fp": 0, "fn": 0},
                                   "ok": True},
                       "lane_detection": {"edge_px": 749, "segments": 16, "left": True, "right": True},
                       "vo_synthetic": {"path": 2.47,
                                        "ate": 0.0097,
                                        "frames": 20,
                                        "state": "tracking",
                                        "keyframes": 3,
                                        "landmarks": 348},
                       "vo_synthetic_60": {"path": 7.67,
                                           "ate": 0.0193,
                                           "frames": 60,
                                           "state": "tracking",
                                           "keyframes": 11,
                                           "landmarks": 1205},
                       "calibration_app": {"found": [True, True, True, True, True, True, True, True],
                                           "first": {"rms": 0.139, "fx": 519.3, "fy": 524.7, "cx": 330.7, "cy": 234.5},
                                           "after_drop": {"rms": 0.105},
                                           "dropped": 7,
                                           "ok": True},
                       "segmentation_demo": {"grabcut_fg_px": 989,
                                             "grabcut_iou": 1.0,
                                             "basin_sizes": {"1": 3850, "2": 2380},
                                             "dam_px": 70,
                                             "camshift_err_px": 0.49,
                                             "camshift_frames": 6,
                                             "ok": True},
                       "qr_demo": {"detected": True,
                                   "quad": [[127.0, 107.0], [217.0, 107.0], [127.0, 197.0], [217.0, 197.0]],
                                   "text": "opencv_tpu says hi",
                                   "ok": True},
                       "panorama": {"focal": 189.1, "pairs": 2, "tree": [[1, 2], [1, 0]], "size": [382, 157]}}


def run_app(name: str, argv: list[str]) -> tuple[dict, list[str], float]:
    """`opencv_tpu_torch.examples.<name>.main(argv)` with its printed lines
    captured: (its result, the lines, wall seconds between synchronised
    points)."""
    import importlib
    import io

    import torch

    mod = importlib.import_module(f"opencv_tpu_torch.examples.{name}")
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = mod.main(argv)
    torch.cuda.synchronize()
    return res, buf.getvalue().splitlines(), time.perf_counter() - t0


def app_checks(key: str, got: dict, jax: dict) -> list[tuple]:
    """(figure, the card's, the JAX example's, the bound, within it) of app
    run `key`: TBD counters equal and MOTA/MOTP within 1e-3; lane segments
    and lanes equal; the QR text equal and its quad within 0.5 px; basins
    equal, GrabCut IoU within 1e-3, CamShift error within 0.05 px; RMS
    within 1e-3 px and K within 0.1 px; the VO's ATE under its own 5 % of
    the path (JAX's beside it); the panorama's pairs and tree equal and its
    focal within 15 px of the true 200 (JAX's beside it)."""
    out = []

    def eq(label, g, w):
        out.append((label, g, w, "equal", g == w))

    def near(label, g, w, tol):
        out.append((label, g, w, f"within {tol}", abs(g - w) <= tol))

    name = key.removesuffix("_60")
    if name == "tbd_app":
        for cls in ("pedestrians", "vehicles"):
            for k in ("tp", "fp", "fn"):
                eq(f"{cls} {k.upper()}", got[cls][k], jax[cls][k])
            for k in ("mota", "motp"):
                near(f"{cls} {k.upper()}", got[cls][k], jax[cls][k], 1e-3)
    elif name == "lane_detection":
        for k in ("segments", "left", "right"):
            eq(k, got[k], jax[k])
    elif name == "qr_demo":
        eq("text", got["text"], jax["text"])
        out.append(("quad px off JAX's", float(np.abs(np.subtract(got["quad"], jax["quad"])).max()), 0.0,
                    "within 0.5", float(np.abs(np.subtract(got["quad"], jax["quad"])).max()) <= 0.5))
    elif name == "segmentation_demo":
        eq("basin sizes", {str(k): v for k, v in got["basin_sizes"].items()},
           {str(k): v for k, v in jax["basin_sizes"].items()})
        near("GrabCut IoU", got["grabcut_iou"], jax["grabcut_iou"], 1e-3)
        near("CamShift error px", got["camshift_err_px"], jax["camshift_err_px"], 0.05)
    elif name == "calibration_app":
        near("RMS px", got["first"]["rms"], jax["first"]["rms"], 1e-3)
        near("RMS after the drop px", got["after_drop"]["rms"], jax["after_drop"]["rms"], 1e-3)
        for k in ("fx", "fy", "cx", "cy"):
            near(f"{k} px", got["first"][k], jax["first"][k], 0.1)
    elif name == "vo_synthetic":
        out.append(("ATE share of the path", got["ate_share"], jax["ate"] / jax["path"], "< 0.05",
                    got["ate_share"] < 0.05))
    elif name == "panorama":
        eq("confident pairs", got["pairs"], jax["pairs"])
        eq("tree", [list(e) for e in got["tree"]], [list(e) for e in jax["tree"]])
        out.append(("focal (truth 200)", got["focal"], jax["focal"], "within 15 of 200",
                    abs(got["focal"] - 200.0) <= 15.0))
    return out


def _jsonable(x):
    return json.loads(json.dumps(x, default=lambda o: o.item() if hasattr(o, "item") else str(o)))


def kernel_calls_exact(calls: dict) -> dict:
    """K1 and K3 held bit for bit against their plain versions at the
    apps' own calls (the first call of each shape, recorded during [apps]):
    each recorded K1 call (a pyramid's levels) through the kernel and the
    plain version level by level, each K3 call likewise; each call's
    device ms through the kernel and through the plain version. These
    launches are checks, outside the path's counted runs. {kernel:
    dict(shapes, max_abs_err, ms=[(kernel, plain) per call])}."""
    import torch

    from opencv_tpu_torch.ops.cuda import fast_kernel, knn

    out = {}
    shapes, err, ms = [], 0.0, []
    for levels, args in calls["fast_corners"]:
        ms.append((device_time_ms(lambda: fast_kernel.fast_corners_levels(levels, *args)),
                   device_time_ms(lambda: [fast_kernel.fast_corners_plain(lvl, *args) for lvl in levels],
                                  calls=3)))
        for lvl, (s_k, n_k) in zip(levels, fast_kernel.fast_corners_levels(levels, *args)):
            s_p, n_p = fast_kernel.fast_corners_plain(lvl, *args)
            torch.cuda.synchronize()
            if not (torch.equal(s_k, s_p) and torch.equal(n_k, n_p)):
                fail(f"[apps] K1 differs from its plain version at {tuple(lvl.shape)}: "
                     f"{(s_k != s_p).sum().item() + (n_k != n_p).sum().item()} values")
            err = max(err, max_abs_err((s_k, s_p), (n_k, n_p)))
        shapes.append([list(lvl.shape) for lvl in levels])
    out["fast_corners"] = dict(shapes=shapes, max_abs_err=err, ms=ms)
    shapes, err, ms = [], 0.0, []
    for q, t, v in calls["knn2_hamming"]:
        ms.append((device_time_ms(lambda: knn.knn2_hamming_cuda(q, t, v), calls=5),
                   device_time_ms(lambda: knn.knn2_hamming_plain(q, t, v), calls=2)))
        got, want = knn.knn2_hamming_cuda(q, t, v), knn.knn2_hamming_plain(q, t, v)
        torch.cuda.synchronize()
        for nm, a, b in zip(("d1", "d2", "i1"), got, want):
            if not torch.equal(a, b):
                fail(f"[apps] K3 {nm} differs from its plain version at {tuple(q.shape)} x "
                     f"{tuple(t.shape)}: {(a != b).sum().item()} queries")
        err = max(err, max_abs_err(*zip(got, want)))
        shapes.append([list(q.shape), list(t.shape), int(v.sum()) if v is not None else None])
    out["knn2_hamming"] = dict(shapes=shapes, max_abs_err=err, ms=ms)
    return out


def phase_apps(dev: str = "cuda") -> dict:
    """[apps] each of the port's applications once through its `main()`, on
    the card, at its defaults (APP_RUNS): each must return ok, and its
    figures are held to the JAX example's (JAX_FIGURES_SLICE13) by
    `app_checks`; the launch counts are reset before each run and read
    after it. The first K1 and K3 call of each shape is recorded (the
    kernel still runs) and afterwards held bit for bit against the plain
    version (`kernel_calls_exact`). Returns the figures, seconds and
    launches of each run, the results of the runs that [pano], [qr] and
    [seg] check against the CPU ("results"), and the kernel checks
    ("kernel_checks")."""
    import torch

    from opencv_tpu_torch.ops import cuda as cuda_ops
    from opencv_tpu_torch.ops.cuda import fast_kernel, knn

    calls = {"fast_corners": [], "knn2_hamming": []}
    seen = set()
    k1, k3 = fast_kernel.fast_corners_levels, knn.knn2_hamming_cuda

    def record_k1(levels, *args):
        levels = list(levels)
        key = ("k1", tuple(tuple(lvl.shape) for lvl in levels), args)
        if key not in seen:
            seen.add(key)
            calls["fast_corners"].append(([lvl.clone() for lvl in levels], args))
        return k1(levels, *args)

    def record_k3(query, train, train_valid=None):
        key = ("k3", tuple(query.shape), tuple(train.shape))
        if key not in seen:
            seen.add(key)
            calls["knn2_hamming"].append((query.clone(), train.clone(),
                                          None if train_valid is None else train_valid.clone()))
        return k3(query, train, train_valid)

    runs, results, total = {}, {}, {k: 0 for k in cuda_ops.launch_counts}
    with tempfile.TemporaryDirectory() as tmp:
        fast_kernel.fast_corners_levels, knn.knn2_hamming_cuda = record_k1, record_k3
        try:
            for key, argv in APP_RUNS.items():
                name = key.removesuffix("_60")
                argv = argv + (["--out", os.path.join(tmp, "panorama.png")] if name == "panorama" else [])
                cuda_ops.reset_launch_counts()
                res, lines, secs = run_app(name, argv)
                counts = dict(cuda_ops.launch_counts)
                for line in lines:
                    print(f"[apps:{key}] {line}", flush=True)
                checks = app_checks(key, res, JAX_FIGURES_SLICE13[key])
                figures = {k: v for k, v in res.items() if not isinstance(v, np.ndarray)}
                runs[key] = _jsonable(dict(figures, run_s=secs, launches=counts, checks=checks))
                results[key] = res
                total = {k: total[k] + counts[k] for k in total}
                print(f"[apps] {key}: {'ok' if res['ok'] else 'NOT ok'}, {secs:.2f} s wall; "
                      + "; ".join(f"{lab} {g} (JAX {w}; {bound}{'' if ok else ': FAILED'})"
                                  for lab, g, w, bound, ok in checks)
                      + f"; K1 {counts['fast_corners']}, K3 {counts['knn2_hamming']}, K6 "
                      f"{sum(v for k, v in counts.items() if k.startswith('schur_cg'))} launches", flush=True)
                if not (res["ok"] and all(c[-1] for c in checks)):
                    fail(f"[apps] {key}: ok={res['ok']}, checks {checks}")
        finally:
            fast_kernel.fast_corners_levels, knn.knn2_hamming_cuda = k1, k3
    torch.cuda.synchronize()
    kchecks = kernel_calls_exact(calls)
    print(f"[apps] {len(runs)} runs ok in {sum(r['run_s'] for r in runs.values()):.1f} s of wall time; "
          f"launches {total}", flush=True)
    for key, what in (("fast_corners", "K1 at the pyramid"),
                      ("knn2_hamming", "K3 at ([query], [train], valid rows)")):
        for shape, (k_ms, p_ms) in zip(kchecks[key]["shapes"], kchecks[key]["ms"]):
            print(f"[apps] {what} {shape}: exact; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms", flush=True)
    for k in ("fast_corners", "knn2_hamming"):
        if total[k] <= 0:
            fail(f"[apps] kernel {k} was not launched by the applications")
    return dict(units=len(runs), unit="app run", runs=runs, launches=total, results=results,
                kernel_checks=kchecks)


# ------------------------------------------------------------ panorama, QR and segmentation slice

# examples/panorama.py's scene (a) and its 480x640 counterpart (b): a plane
# at z = 1 textured by a bilinearly upsampled uniform(30, 225) grid, seen by
# pure rotations about y; (b) keeps (a)'s 1:1 sampling (ts / (2 span) = F)
# and 8-px blobs
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
    """Render pure-rotation views of examples/panorama.py's scene at
    `cfg`'s size with the port's warp_perspective. Returns (views [list of f32 [H, W] on dev],
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


def phase_pano(app: dict, dev: str = "cuda") -> dict:
    """[pano] (a) the port's panorama app (opencv_tpu_torch/examples/
    panorama.py: 3 views of 160x200, F = 200, yaws -0.45/0/0.45, 700
    features, seed 1, 2 bands): its card run `app` from [apps], and the app
    run again on the CPU; (b) 5 views of 480x640 (F = 600, yaws -0.6..0.6,
    2000 features), cold, then warm WARM_RUNS times; stitch_pair on views 2
    and 3 of (b). Bounds: focal within 12 %, relative rotations < 3 deg,
    (a)'s tree of 2 edges (tests/test_global_stitch.py:70-79). The CPU gets
    the same RANSAC subsets (one CPU generator per call): on (a), focal
    within 1e-3 relative, rotations within 0.05 deg, and (a)'s panorama
    composed from the card's rotations on both devices with >= 99 % of its
    pixels within 0.5 grey levels; stitch_pair the same pixel rule. (b) on
    the card alone: the port's CPU run of it takes minutes."""
    import torch

    from opencv_tpu_torch.examples import panorama
    from opencv_tpu_torch.geometry.rotation import rodrigues
    from opencv_tpu_torch.stitching import global_stitch as gs
    from opencv_tpu_torch.stitching import stitcher

    def pixel_share(a, b, tol=0.5):
        return float((np.abs(a - b) <= tol).mean()) if a.shape == b.shape else 0.0

    # (a): the app's card run, against the app on the CPU
    va = panorama.render_views(dev)
    Rs_a = np.stack([rodrigues(torch.tensor([0.0, yaw, 0.0])).double().numpy() for yaw in panorama.YAWS])
    Ra, fa = np.asarray(app["rotations"]), app["focal"]
    ferr_a, rot_a = pano_geometry_errors(Ra, Rs_a, fa, panorama.F)
    with torch_threads(1), tempfile.TemporaryDirectory() as tmp:
        cpu, _, _ = run_app("panorama", ["--cpu", "--out", os.path.join(tmp, "panorama.png")])
        comp_cpu = gs.compose_panorama([v.cpu() for v in va], Ra, fa, blend_bands=2).numpy()
    comp_card = gs.compose_panorama(va, Ra, fa, blend_bands=2).cpu().numpy()
    a_cpu = dict(focal_rel=abs(fa - cpu["focal"]) / cpu["focal"],
                 rot_deg=max(_rot_deg(x, y) for x, y in zip(Ra, np.asarray(cpu["rotations"]))),
                 tree_equal=app["tree"] == cpu["tree"],
                 pixels_within_0_5=pixel_share(comp_card, comp_cpu))
    print(f"[pano] (a) the panorama app's card run ([apps]), 3 views 160x200: focal {fa:.2f} (truth "
          f"{panorama.F}, {100 * ferr_a:.2f} %), relative rotations {[round(r, 4) for r in rot_a]} deg, "
          f"{app['pairs']} confident pairs, tree {app['tree']}; panorama {app['size'][0]}x{app['size'][1]}; "
          f"card vs the app on the CPU: focal {a_cpu['focal_rel']:.2e} relative, rotations "
          f"{a_cpu['rot_deg']:.2e} deg, trees equal {a_cpu['tree_equal']}, composed pixels within "
          f"0.5: {a_cpu['pixels_within_0_5']:.5f}", flush=True)
    if not (ferr_a < 0.12 and max(rot_a) < 3.0 and len(app["tree"]) == 2):
        fail(f"pano (a): focal error {ferr_a:.4f}, rotation errors {rot_a} deg, tree {app['tree']}")
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
               example_a=dict(focal=fa, focal_rel_err=ferr_a, rel_rot_deg=rot_a, tree=app["tree"],
                              pano_wh=app["size"], card_vs_cpu=a_cpu),
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
    k1_err = max(k1_exact_on_orb_pyramid(v, n) for views, n in
                 ((va, panorama.N_FEATURES), (vb, PANO_B["n_features"])) for v in views)
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


def qr_read(scenes, dev: str):
    """detect_qr + decode_qr of every scene: [(quad, ok, text)]."""
    from opencv_tpu_torch.ops import qrcode

    out = []
    for scene in scenes:
        quad, ok = qrcode.detect_qr(scene, device=dev)
        out.append((quad, ok, qrcode.decode_qr(scene, quad, device=dev) if ok else None))
    return out


def phase_qr(app: dict, dev: str = "cuda") -> dict:
    """[qr] (a) the port's qr_demo app's card run `app` from [apps] (its
    round trip: a version-2 code in a 300x340 scene), against the app run
    again on the CPU; (b) 24 scenes of 480x640 (qr_scenes), detect and
    decode, cold, then warm WARM_RUNS times. Every code must decode to its
    text; the CPU's quads and texts equal the card's on every scene."""
    import torch

    cpu, _, _ = run_app("qr_demo", ["--cpu"])
    print(f"[qr] (a) the qr_demo app's card run ([apps]): detected {app['detected']}, decoded "
          f"{app['text']!r}; card vs the app on the CPU: quad equal {app['quad'] == cpu['quad']}, text "
          f"equal {app['text'] == cpu['text']}", flush=True)
    if not app["ok"]:
        fail(f"qr (a): round trip failed ({app['text']!r})")
    if not (app["quad"] == cpu["quad"] and app["text"] == cpu["text"]):
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


def phase_seg(app: dict, dev: str = "cuda") -> dict:
    """[seg] (a) the port's segmentation_demo app's card run `app` from
    [apps] (GrabCut 70x90 with 4 iterations, watershed 70x90, CamShift over
    7 frames of 120x160): its verdict (IoU > 0.8, mean centre error < 6 px,
    basins > 500 px) must be OK; the app run again on the CPU: GrabCut mask
    >= 99.9 % equal, watershed labels and CamShift windows equal. (b) the
    same scenes at 480x640 (GrabCut and watershed scaled by 480/70,
    CamShift by 4 over 30 frames), cold, then warm WARM_RUNS times, on the
    card; CamShift also on the CPU (windows equal). GrabCut on the card
    against the CPU also at 120x160 (one iteration): >= 99.9 % equal."""
    import torch

    from opencv_tpu_torch.ops import grabcut

    with torch_threads(1):
        c, _, a_cpu_s = run_app("segmentation_demo", ["--cpu"])
    a_cmp = dict(grabcut_equal=float((app["mask"] == c["mask"]).mean()),
                 watershed_equal=bool(np.array_equal(app["labels"], c["labels"])),
                 camshift_windows_equal=app["windows"] == c["windows"])
    print(f"[seg] (a) the segmentation_demo app's card run ([apps]): grabcut IoU {app['grabcut_iou']:.4f} "
          f"(sweeps per cut {app['grabcut_sweeps']}), watershed basins {app['basin_sizes']} with "
          f"{app['dam_px']} dam px in {app['watershed_sweeps']} sweeps, camshift mean centre error "
          f"{app['camshift_err_px']:.3f} px over {app['camshift_frames']} frames; verdict "
          f"{'OK' if app['ok'] else 'DEGRADED'}; {a_cpu_s:.2f} s on the CPU; card vs the app on the CPU: "
          f"grabcut mask equal on {a_cmp['grabcut_equal']:.5f}, watershed equal "
          f"{a_cmp['watershed_equal']}, camshift windows equal {a_cmp['camshift_windows_equal']}",
          flush=True)
    if not app["ok"]:
        fail(f"seg (a): the demo's verdict is DEGRADED (IoU {app['grabcut_iou']}, error "
             f"{app['camshift_err_px']}, basins {app['basin_sizes']})")
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
               example_a=dict(iou=app["grabcut_iou"], sweeps=app["grabcut_sweeps"],
                              basins=app["basin_sizes"], ws_sweeps=app["watershed_sweeps"],
                              camshift_err_px=app["camshift_err_px"], ok=app["ok"], card_vs_cpu=a_cmp,
                              cpu_s=a_cpu_s),
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


# ------------------------------------------------------------ detectors, stereo and flow slice


FEAT2_PAIR = (0, 8)  # frames matched 0 <-> 8, as the two-view path
MAP_FRAMES = 16  # AKAZE rows of frames 0-15: 32 000, above the streaming threshold
MAP_QUERY = 24
AGAST_KINDS = ("9_16", "7_12s", "5_8", "7_12d")


def pose_gt(b: int):
    """(R, t) of frame b against frame 0 (make_sequence's motion, as
    phase_two_view takes it)."""
    from opencv_tpu_torch.slam.vo import _np_rodrigues

    R = _np_rodrigues(np.array([0.0, np.deg2rad(0.15 * b), 0.0]))
    return R, -R @ np.array([0.12 * b, 0.0, 0.03 * b])


def epipolar_px(xy0: np.ndarray, xy1: np.ndarray, K: np.ndarray, R, t) -> np.ndarray:
    """Distance in px of each xy1 from the epipolar line of its xy0 under
    the true motion (F = K^-T [t]x R K^-1)."""
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    Ki = np.linalg.inv(K.astype(np.float64))
    F = Ki.T @ tx @ R @ Ki
    h0 = np.concatenate([xy0, np.ones((len(xy0), 1))], 1)
    h1 = np.concatenate([xy1, np.ones((len(xy1), 1))], 1)
    lines = h0 @ F.T
    return np.abs((h1 * lines).sum(1)) / np.linalg.norm(lines[:, :2], axis=1)


def feat2_detect(img, dev, with_mser: bool = True) -> dict:
    """AGAST (four kinds, 2000), BRISK (2000, threshold 30, 4 levels), AKAZE
    (2000, 8 levels) and MSER (dark and bright) on one frame, as a user
    calls them."""
    from opencv_tpu_torch.ops import agast, akaze, brisk, mser

    out = {f"agast_{k}": agast.agast_detect(img, 2000, 10.0, k, device=dev) for k in AGAST_KINDS}
    out["brisk"] = brisk.brisk_detect_and_compute(img, 2000, 30.0, 4, device=dev)
    out["akaze"] = akaze.akaze_detect_and_compute(img, 2000, n_levels=8, device=dev)
    if with_mser:
        out["mser_dark"] = mser.mser_detect(img, device=dev)
        out["mser_bright"] = mser.mser_detect(img, dark_on_bright=False, device=dev)
    return out


MAP_CFG = dict(ratio=0.8, cross_check=False, max_distance=512.0)


def feat2_run(imgs, map_desc, map_valid, query_img, dev) -> dict:
    """[feat2]'s work: detection on both frames, BRISK and AKAZE matched
    0 <-> 8 (ratio 0.8, cross-check), the query frame's AKAZE rows against
    the map through knn_match_auto."""
    from opencv_tpu_torch.core.config import MatchConfig
    from opencv_tpu_torch.ops import akaze, matching

    det = [feat2_detect(x, dev) for x in imgs]
    matches = {}
    for name in ("brisk", "akaze"):
        (k0, d0), (k1, d1) = det[0][name], det[1][name]
        matches[name] = matching.knn_match(d0, d1, k0.valid, k1.valid, MatchConfig(ratio=0.8))
    qk, qd = akaze.akaze_detect_and_compute(query_img, 2000, n_levels=8, device=dev)
    streamed = matching.knn_match_auto(qd, map_desc, qk.valid, map_valid, MatchConfig(**MAP_CFG))
    return dict(det=det, matches=matches, query=(qk, qd), streamed=streamed)


def same_tensors(*pairs) -> bool:
    import torch

    return all(torch.equal(a.cpu(), b.cpu()) for a, b in pairs)


def phase_feat2(frames, K, card: str, dev: str = "cuda") -> dict:
    """[feat2] the remaining feature detectors on frames 0 and 8 of the
    scene: (a) AGAST, all four kinds; (b) BRISK and AKAZE, each matched
    0 <-> 8 by knn_match (ratio 0.8, cross-check) with the share of matches
    within 2 px of the true epipolar line; (c) MSER dark and bright; (d)
    the AKAZE rows of frames 0-15 (32 000) queried by frame 24 through
    knn_match_auto: K3 at 512 bits, equal to the dense matcher with
    cross-check off. Cold, then warm WARM_RUNS times (unit: a frame: the
    pair and the query frame). K2 and K3 must launch. Card against CPU on
    frames 0 and 8 (MSER on their top-left 120x160)."""
    import torch

    from opencv_tpu_torch.core.config import MatchConfig
    from opencv_tpu_torch.ops import akaze, matching, mser

    imgs = [torch.from_numpy(np.ascontiguousarray(frames[i])).to(dev) for i in FEAT2_PAIR]
    t0 = time.perf_counter()
    descs, valids = [], []
    for f in range(MAP_FRAMES):
        kp, d = akaze.akaze_detect_and_compute(
            torch.from_numpy(np.ascontiguousarray(frames[f])).to(dev), 2000, n_levels=8, device=dev)
        descs.append(d)
        valids.append(kp.valid)
    map_desc, map_valid = torch.cat(descs), torch.cat(valids)
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t0
    query = torch.from_numpy(np.ascontiguousarray(frames[MAP_QUERY])).to(dev)

    def run():
        return feat2_run(imgs, map_desc, map_valid, query, dev)

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    outs, secs, runs = warm_runs_of(run, WARM_RUNS)
    o, counts = outs[0], runs[0]
    if counts["fast_score"] <= 0 or counts["knn2_hamming"] <= 0:
        fail(f"[feat2] K2 and K3 must launch on the path: {counts}")

    R, t = pose_gt(FEAT2_PAIR[1])
    match = {}
    for name, m in o["matches"].items():
        (k0, _), (k1, _) = o["det"][0][name], o["det"][1][name]
        ok = m.valid.cpu().numpy()
        xy0 = k0.xy.cpu().numpy()[m.query_idx.cpu().numpy()][ok]
        xy1 = k1.xy.cpu().numpy()[m.train_idx.cpu().numpy()][ok]
        d = epipolar_px(xy0, xy1, K, R, t)
        match[name] = dict(keypoints=[int(o["det"][i][name][0].valid.sum()) for i in (0, 1)],
                           matches=int(ok.sum()), within_2px=float((d < 2.0).mean()) if len(d) else 0.0)
    agast_n = {k: [int(o["det"][i][f"agast_{k}"].valid.sum()) for i in (0, 1)] for k in AGAST_KINDS}
    mser_n = {k: [int(o["det"][i][f"mser_{k}"].valid.sum()) for i in (0, 1)] for k in ("dark", "bright")}

    # (d) the streamed matches against the dense matcher, cross-check off
    qk, qd = o["query"]
    cfg = MatchConfig(**MAP_CFG)
    dense = matching.knn_match(qd, map_desc, qk.valid, map_valid, cfg)
    s = o["streamed"]
    sv = s.valid.cpu().numpy()
    map_equal = bool(np.array_equal(sv, dense.valid.cpu().numpy()) and np.array_equal(
        s.train_idx.cpu().numpy()[sv], dense.train_idx.cpu().numpy()[sv]))
    stream_ms = device_time_ms(lambda: matching.knn_match_auto(qd, map_desc, qk.valid, map_valid, cfg),
                               calls=3)
    dense_ms = device_time_ms(lambda: matching.knn_match(qd, map_desc, qk.valid, map_valid, cfg),
                              calls=3)

    # card against CPU on frames 0 and 8
    t0 = time.perf_counter()
    with torch_threads(1):
        cpu = [feat2_detect(x.cpu(), "cpu", with_mser=False) for x in imgs]  # MSER: a crop below
    cpu_s = time.perf_counter() - t0
    cmp = {"agast_keypoints_equal": [], "brisk_keypoints_equal": [], "akaze_keypoints_equal": [],
           "brisk_bits_equal": [], "akaze_bits_equal": []}
    for g, c in zip(o["det"], cpu):
        cmp["agast_keypoints_equal"].append(all(
            same_tensors((g[f"agast_{k}"].valid, c[f"agast_{k}"].valid), (g[f"agast_{k}"].xy, c[f"agast_{k}"].xy))
            for k in AGAST_KINDS))
        for name in ("brisk", "akaze"):
            (gk, gd), (ck, cd) = g[name], c[name]
            cmp[f"{name}_keypoints_equal"].append(same_tensors((gk.valid, ck.valid), (gk.xy, ck.xy),
                                                               (gk.level, ck.level)))
            v = ck.valid.cpu()
            same = matching.unpack_bits(gd).cpu() == matching.unpack_bits(cd)
            cmp[f"{name}_bits_equal"].append(float(same[v].float().mean()) if v.any() else 1.0)
    crop = imgs[0][:120, :160]
    cmp["mser_120x160_equal"] = []
    for dark in (True, False):
        g = mser.mser_detect(crop, dark_on_bright=dark, device=dev)
        c = mser.mser_detect(crop.cpu(), dark_on_bright=dark, device="cpu")
        cmp["mser_120x160_equal"].append(same_tensors((g.valid, c.valid), (g.area, c.area),
                                                      (g.bbox, c.bbox)))

    warm = statistics.median(secs)
    units = len(FEAT2_PAIR) + 1
    res = dict(units=units, unit="frame", warm_s=warm, warm_s_runs=secs, cold_s=cold,
               frames_per_s=units / warm, map_rows=int(map_desc.shape[0]),
               map_valid=int(map_valid.sum()), map_build_s=map_s, agast_keypoints=agast_n,
               mser_regions=mser_n, matching=match, map_matches=int(sv.sum()),
               map_equals_dense=map_equal, map_stream_ms=stream_ms, map_dense_ms=dense_ms,
               cpu_s=cpu_s, card_vs_cpu=cmp, launches=counts, card=card)
    print(f"[feat2] frames {FEAT2_PAIR[0]},{FEAT2_PAIR[1]} 480x640 | {card}: AGAST keypoints "
          f"(threshold 10) {agast_n}; BRISK keypoints {match['brisk']['keypoints']}, "
          f"{match['brisk']['matches']} matches 0<->8, {100 * match['brisk']['within_2px']:.2f} % within "
          f"2 px of the true epipolar line; AKAZE keypoints {match['akaze']['keypoints']}, "
          f"{match['akaze']['matches']} matches, {100 * match['akaze']['within_2px']:.2f} % within 2 px; "
          f"MSER regions {mser_n}", flush=True)
    print(f"[feat2] (d) map of {map_desc.shape[0]} AKAZE rows (frames 0-{MAP_FRAMES - 1}, "
          f"{int(map_valid.sum())} valid, built in {map_s:.2f} s) queried by frame {MAP_QUERY}: "
          f"{int(sv.sum())} matches through knn_match_auto (K3, 512 bits), equal to the dense matcher: "
          f"{map_equal}; streamed {stream_ms:.4f} ms, dense {dense_ms:.4f} ms | {card}", flush=True)
    print(f"[feat2] warm {warm:.3f} s per run of {units} frames ({units / warm:.2f} frames/s, median "
          f"of {WARM_RUNS}, runs {[round(x, 3) for x in secs]}), cold {cold:.3f} s | {card}; launches "
          f"{counts} (K2 {counts['fast_score']}, K3 {counts['knn2_hamming']}); card vs CPU ({cpu_s:.2f} "
          f"s on the CPU): {cmp}", flush=True)
    if not map_equal:
        fail("[feat2] (d) the streamed map matches differ from the dense matcher's")
    if not all(all(cmp[k]) for k in ("agast_keypoints_equal", "brisk_keypoints_equal",
                                     "akaze_keypoints_equal", "mser_120x160_equal")):
        fail(f"[feat2] the card differs from the CPU: {cmp}")
    if min(cmp["brisk_bits_equal"] + cmp["akaze_bits_equal"]) < 0.995:
        fail(f"[feat2] descriptor bits differ from the CPU's beyond 0.5 %: {cmp}")
    if min(m["matches"] for m in match.values()) < 50:
        fail(f"[feat2] too few matches 0<->8: {match}")
    return res


STEREO_DISP = (8, 24, 40)  # background, block A, block B (px)
STEREO_ND = 64
STEREO_BOUNDS = {"bp": 0.12, "csbp": 0.15}  # tests/test_stereo_bp.py's bad-pixel bounds
# The JAX package's own bad-pixel rates on stereo_pair() (480x640, 64
# disparities), its flow figures on flow_pair() and Brox's own spread on
# that pair's FLOW_CROP, taken on the CPU by tools/jax_slice8_figures.py;
# printed beside the port's.
JAX_FIGURES = {
    "stereo": {"bm": 0.007907, "sgbm": 0.03256, "bp": 2.8e-05, "csbp": 0.0},
    "flow": {
        "farneback": {"epe_px": 0.249639, "median_offset_px": [-0.141791, -0.016158]},
        "tvl1": {"epe_px": 0.025735, "median_offset_px": [-0.003598, 3e-06]},
        "brox": {"epe_px": 0.505522, "median_offset_px": [-0.315726, -0.031649]},
    },
    # Brox on FLOW_CROP of flow_pair(), (mean, max) |flow difference| px
    "brox_scene_crop": {"jax_jit_vs_default": [0.3919775187969208, 34.208858489990234],
                        "port_cpu_one_ulp": [0.3206680417060852, 33.76567077636719]},
}


def stereo_pair(h: int = 480, w: int = 640, disp=STEREO_DISP, seed: int = 0):
    """tests/test_stereo_bp.py's generator, widened: a seeded random
    texture smoothed along rows is the right image; the left image takes
    right[y, x - d(y, x)] with d = disp[0] in the background and disp[1],
    disp[2] in two blocks. Returns (left, right, true disparity)."""
    rng = np.random.default_rng(seed)
    right = rng.uniform(0, 255, (h, w)).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25])
    right = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, right).astype(np.float32)
    gt = np.full((h, w), disp[0], np.int32)
    gt[h * 120 // 480: h * 300 // 480, w * 140 // 640: w * 340 // 640] = disp[1]
    gt[h * 260 // 480: h * 420 // 480, w * 400 // 640: w * 600 // 640] = disp[2]
    xs = np.arange(w)
    left = np.stack([right[y, np.clip(xs - gt[y], 0, w - 1)] for y in range(h)]).astype(np.float32)
    return left, right, gt


def bad_pixel_rate(pred: np.ndarray, gt: np.ndarray, border: int = 12, tol: float = 1.0) -> float:
    """Share of pixels off the truth by more than tol, `border` px inside
    (tests/test_stereo_bp.py's measure; invalid pixels count as bad)."""
    p = pred[border:-border, border:-border]
    return float(np.mean(~(np.abs(p - gt[border:-border, border:-border]) <= tol)))


def stereo_methods(left, right, nd: int, dev) -> dict:
    """{method: (disparity, seconds)}: BM (block 9), SGBM (8 paths, speckle
    filter), BP (6 iterations, 3 levels), CSBP (6 planes, 8 iterations),
    the parameters of tests/test_stereo_bp.py."""
    import torch

    from opencv_tpu_torch.ops import sgbm, stereo, stereo_bp

    calls = {
        "bm": lambda: stereo.compute_disparity_bm(left, right, nd, block_size=9, device=dev),
        "sgbm": lambda: sgbm.compute_disparity_sgbm(left, right, sgbm.SGBMConfig(num_disparities=nd),
                                                    device=dev),
        "bp": lambda: stereo_bp.stereo_bp(left, right, nd, n_iters=6, n_levels=3, device=dev),
        "csbp": lambda: stereo_bp.stereo_csbp(left, right, nd, nr_plane=6, n_iters=8, device=dev),
    }
    out = {}
    for name, fn in calls.items():
        t0 = time.perf_counter()
        d = fn()
        if d.is_cuda:
            torch.cuda.synchronize()
        out[name] = (d, time.perf_counter() - t0)
    return out


def phase_stereo(card: str, dev: str = "cuda") -> dict:
    """[stereo] a rectified 480x640 pair (stereo_pair: background 8 px,
    blocks at 24 and 40 px, 64 disparities): BM, SGBM, BP and CSBP, cold
    then warm WARM_RUNS times (unit: a pair); bad-pixel rates (> 1 px, 12 px
    border) within tests/test_stereo_bp.py's bounds (BP < 0.12, CSBP <
    0.15, SGBM <= BM + 0.02) or at the JAX package's own figure; SGBM
    reprojected to 3D (median depth per region against f B / d). Card
    against CPU on a 120x160 pair (disparities 2/6/10 of 16) for all four,
    and BM at full size."""
    import torch

    from opencv_tpu_torch.ops import stereo

    left, right, gt = stereo_pair()
    lt, rt = torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev)
    t0 = time.perf_counter()
    stereo_methods(lt, rt, STEREO_ND, dev)
    cold = time.perf_counter() - t0
    outs, secs, runs = warm_runs_of(lambda: stereo_methods(lt, rt, STEREO_ND, dev), WARM_RUNS)
    o = outs[0]
    rates = {k: bad_pixel_rate(d.cpu().numpy(), gt) for k, (d, _) in o.items()}
    method_s = {k: statistics.median(run[k][1] for run in outs) for k in o}

    f, base = 0.82 * 640, 0.1
    pts = stereo.reproject_to_3d(o["sgbm"][0], f, base, 320.0, 240.0).cpu().numpy()
    depth = {}
    for i, d in enumerate(STEREO_DISP):
        region = (gt == d) & (pts[..., 2] > 0)
        depth[d] = (float(np.median(pts[..., 2][region])), f * base / d)

    sl, sr, sgt = stereo_pair(120, 160, (2, 6, 10))
    small = {k: v[0].cpu() for k, v in stereo_methods(torch.from_numpy(sl).to(dev),
                                                      torch.from_numpy(sr).to(dev), 16, dev).items()}
    t0 = time.perf_counter()
    with torch_threads(1):
        small_cpu = {k: v[0] for k, v in stereo_methods(torch.from_numpy(sl), torch.from_numpy(sr),
                                                        16, "cpu").items()}
        bm_cpu = stereo.compute_disparity_bm(left, right, STEREO_ND, block_size=9, device="cpu")
    cpu_s = time.perf_counter() - t0
    same = {k: float((torch.nan_to_num(small[k], -2.0) == torch.nan_to_num(small_cpu[k], -2.0))
                     .float().mean()) for k in small}  # BM's parabola leaves NaN at some edges
    bm_full_equal = bool(torch.equal(torch.nan_to_num(o["bm"][0].cpu(), -2.0),
                                     torch.nan_to_num(bm_cpu, -2.0)))
    warm = statistics.median(secs)
    res = dict(units=1, unit="pair", warm_s=warm, warm_s_runs=secs, cold_s=cold, pairs_per_s=1.0 / warm,
               method_s=method_s, bad_pixel_rate=rates, jax_bad_pixel_rate=JAX_FIGURES.get("stereo"),
               sgbm_depth_median_vs_truth=depth, card_vs_cpu_120x160_equal=same,
               bm_480x640_card_equals_cpu=bm_full_equal, cpu_s=cpu_s, launches=runs[0], card=card)
    print(f"[stereo] 480x640, {STEREO_ND} disparities (background {STEREO_DISP[0]} px, blocks "
          f"{STEREO_DISP[1]} and {STEREO_DISP[2]} px) | {card}: bad-pixel rate (> 1 px) "
          + ", ".join(f"{k} {v:.4f}" for k, v in rates.items())
          + f" (the JAX package's on this input: {JAX_FIGURES.get('stereo')}); seconds per method "
          + ", ".join(f"{k} {v:.4f}" for k, v in method_s.items())
          + f" (median of {WARM_RUNS}); warm {warm:.3f} s a pair, cold {cold:.3f} s | {card}", flush=True)
    print(f"[stereo] SGBM reprojected (f {f:.1f}, B {base}): median depth per region (measured, "
          f"f B / d) {depth}; card vs CPU at 120x160: equal share {same}, BM at 480x640 equal "
          f"{bm_full_equal} ({cpu_s:.2f} s on the CPU); launches {runs[0]}", flush=True)
    jax_rates = JAX_FIGURES.get("stereo", {})
    checks = {"bp": rates["bp"] < STEREO_BOUNDS["bp"], "csbp": rates["csbp"] < STEREO_BOUNDS["csbp"],
              "sgbm": rates["sgbm"] <= rates["bm"] + 0.02}
    for k, ok in checks.items():
        if not ok and not (k in jax_rates and abs(rates[k] - jax_rates[k]) <= 0.005):
            fail(f"[stereo] {k} bad-pixel rate {rates[k]:.4f} is outside the JAX tests' bound and "
                 f"away from the JAX package's own figure {jax_rates.get(k)}")
    if not (bm_full_equal and same["bm"] == 1.0 and same["sgbm"] >= 0.995
            and min(same["bp"], same["csbp"]) >= 0.99):
        fail(f"[stereo] the card differs from the CPU: {same}, BM full size equal {bm_full_equal}")
    for d, (got, want) in depth.items():
        if not abs(got - want) <= 0.05 * want:
            fail(f"[stereo] SGBM depth of the {d}-px region {got:.4f} is not within 5 % of {want:.4f}")
    return res


FLOW_SHIFT = (3.0, 2.0)  # px, with a rotation of FLOW_ROT_DEG about the centre
FLOW_ROT_DEG = 0.5
FLOW_MEDIAN_BOUNDS = {"farneback": 0.5, "tvl1": 0.4, "brox": 0.5}  # the JAX tests' bounds
SR_FRAMES = 8
FLOW_CROP = (slice(0, 240), slice(0, 320))  # of flow_pair(): held card against CPU
BROX_SPREAD_FACTOR = 1.5  # tests/test_torch_brox.py's rule against JAX's own spread


def bilinear_np(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """img sampled at (x, y), bilinear, clamped at the edges (f64)."""
    h, w = img.shape
    x = np.clip(x, 0, w - 1)
    y = np.clip(y, 0, h - 1)
    x0 = np.clip(np.floor(x).astype(int), 0, w - 2)
    y0 = np.clip(np.floor(y).astype(int), 0, h - 2)
    fx, fy = x - x0, y - y0
    im = img.astype(np.float64)
    top = im[y0, x0] * (1 - fx) + im[y0, x0 + 1] * fx
    bot = im[y0 + 1, x0] * (1 - fx) + im[y0 + 1, x0 + 1] * fx
    return top * (1 - fy) + bot * fy


def moved_by(img: np.ndarray, frac: float = 1.0):
    """(img moved by frac of the known field, the field's flow [H, W, 2]):
    a point p goes to R(p - c) + c + t (rotation frac * FLOW_ROT_DEG about
    the centre, translation frac * FLOW_SHIFT)."""
    h, w = img.shape
    a = np.deg2rad(FLOW_ROT_DEG * frac)
    ca, sa = np.cos(a), np.sin(a)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    tx, ty = FLOW_SHIFT[0] * frac, FLOW_SHIFT[1] * frac
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    flow = np.stack([ca * (xx - cx) - sa * (yy - cy) + cx + tx - xx,
                     sa * (xx - cx) + ca * (yy - cy) + cy + ty - yy], -1)
    u, v = xx - cx - tx, yy - cy - ty  # the inverse map of each output pixel
    moved = bilinear_np(img, ca * u + sa * v + cx, -sa * u + ca * v + cy)
    return moved.astype(np.float32), flow.astype(np.float32)


def flow_pair(frame0: np.ndarray):
    """(frame 0, frame 0 moved by the field, the field, frame 0 moved by
    half of it: the true frame at t = 0.5)."""
    nxt, flow = moved_by(frame0)
    mid, _ = moved_by(frame0, 0.5)
    return frame0.astype(np.float32), nxt, flow, mid


def sr_frames(hi: np.ndarray, dev, seed: int = 0):
    """SR_FRAMES low-res frames: hi moved by seeded subpixel shifts (U(-1, 1)
    low-res px, the first unmoved), then blurred and decimated 2x (the
    observation model of ops/superres.py)."""
    import torch

    from opencv_tpu_torch.ops import superres

    rng = np.random.default_rng(seed)
    shifts = np.concatenate([[[0.0, 0.0]], rng.uniform(-1, 1, (SR_FRAMES - 1, 2))])
    h, w = hi.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    moved = np.stack([bilinear_np(hi, xx + 2 * dx, yy + 2 * dy) for dx, dy in shifts]).astype(np.float32)
    lo = superres._downsample(torch.from_numpy(moved).to(dev), 2)
    return lo.contiguous(), shifts


def flow_texture_pair(h: int = 240, w: int = 320, seed: int = 0):
    """tests/test_torch_flow.py's texture at 240x320 (seeded noise blurred
    7x7, sigma 2) and itself rolled by (2, 3) px: texture everywhere,
    beside the scene crop FLOW_CROP, whose black ground leaves Brox's
    smoothness term alone to decide much of the flow."""
    import torch

    from opencv_tpu_torch.core import imgproc

    rng = np.random.default_rng(seed)
    img = imgproc.gaussian_blur(torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32)),
                                7, 2.0).numpy()
    return img, np.roll(img, (2, 3), axis=(0, 1))


def flow_run(a, b, lo, dev) -> dict:
    """[flow]'s work: Farneback, TV-L1 and Brox at their defaults on the
    pair, interpolate_frames at t = 0.5, and BTV-L1 super-resolution of the
    low-res frames with Farneback flows to and from frame 0."""
    import torch

    from opencv_tpu_torch.ops import brox, farneback, interpolate, superres, tvl1

    out, secs = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        if out[name].is_cuda:
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0

    timed("farneback", lambda: farneback.calc_optical_flow_farneback(a, b, device=dev))
    timed("tvl1", lambda: tvl1.calc_optical_flow_tvl1(a, b, device=dev))
    timed("brox", lambda: brox.brox_flow(a, b, device=dev))
    timed("interpolate", lambda: interpolate.interpolate_frames(a, b, 0.5, device=dev))

    def sr():
        # frame k (p) = frame 0 (p + flows[k](p)): the flow from frame k to frame 0
        fl = torch.stack([farneback.calc_optical_flow_farneback(x, lo[0], device=dev) for x in lo])
        bf = torch.stack([farneback.calc_optical_flow_farneback(lo[0], x, device=dev) for x in lo])
        return superres.btv_l1_superres_flow(lo, fl, bf, device=dev)

    timed("superres", sr)
    out["secs"] = secs
    return out


def flow_parts(a, b, dev) -> dict:
    """The three flows and the frame interpolated at t = 0.5 of one pair."""
    from opencv_tpu_torch.ops import brox, farneback, interpolate, tvl1

    return {"farneback": farneback.calc_optical_flow_farneback(a, b, device=dev),
            "tvl1": tvl1.calc_optical_flow_tvl1(a, b, device=dev),
            "brox": brox.brox_flow(a, b, device=dev),
            "interpolate": interpolate.interpolate_frames(a, b, 0.5, device=dev)}


def phase_flow(frame0: np.ndarray, card: str, dev: str = "cuda") -> dict:
    """[flow] frame 0 of the scene and frame 0 moved by a known smooth
    field (FLOW_SHIFT plus FLOW_ROT_DEG about the centre): Farneback, TV-L1
    and Brox at their defaults (mean endpoint error 16 px inside the
    border; interior medians against the field's, within the JAX tests'
    bounds 0.5 / 0.4 / 0.5 px), interpolate_frames at t = 0.5 against the
    true middle frame, and BTV-L1 super-resolution (8 frames of 240x320 to
    480x640, Farneback flows) against frame 0 beside bilinear upscaling.
    Cold, then warm WARM_RUNS times (unit: a pair; a frame for
    super-resolution). Card against CPU on the pair's top-left 240x320
    (FLOW_CROP) and on flow_texture_pair (240x320): the three flows and the
    interpolated frame, 0.05 px / grey at most and 1e-3 on average (Brox
    on the texture 8 px inside the border, as tests/test_torch_brox.py).
    Brox on the scene crop is held to BROX_SPREAD_FACTOR times the JAX
    function's own spread there (compiled whole against its default run,
    JAX_FIGURES) where it misses 1e-3 / 0.05: a one-ulp nudge of the input
    moves it as far (tools/jax_slice8_figures.py)."""
    import torch

    from opencv_tpu_torch.core import imgproc

    prev, nxt, field, mid = flow_pair(frame0)
    a, b = torch.from_numpy(prev).to(dev), torch.from_numpy(nxt).to(dev)
    lo, _ = sr_frames(prev, dev)
    t0 = time.perf_counter()
    flow_run(a, b, lo, dev)
    cold = time.perf_counter() - t0
    outs, secs, runs = warm_runs_of(lambda: flow_run(a, b, lo, dev), WARM_RUNS)
    o = outs[0]
    inner = (slice(16, -16), slice(16, -16))
    acc = {}
    for k in ("farneback", "tvl1", "brox"):
        fl = o[k].cpu().numpy()
        epe = float(np.linalg.norm(fl[inner] - field[inner], axis=-1).mean())
        med = [float(np.median(fl[inner][..., i]) - np.median(field[inner][..., i])) for i in (0, 1)]
        acc[k] = dict(epe_px=epe, median_offset_px=med)
    interp_err = float(np.abs(o["interpolate"].cpu().numpy() - mid)[inner].mean())
    blend_err = float(np.abs(0.5 * (prev + nxt) - mid)[inner].mean())
    sr_err = float(np.abs(o["superres"].cpu().numpy() - prev)[inner].mean())
    up = imgproc.resize_bilinear(lo[0], 480, 640).cpu().numpy()
    bil_err = float(np.abs(up - prev)[inner].mean())

    pairs = {"scene": [np.ascontiguousarray(x[FLOW_CROP]) for x in (prev, nxt)],
             "texture": flow_texture_pair()}
    vs_cpu, cpu_s = {}, 0.0
    for where, (x, y) in pairs.items():
        on_card = flow_parts(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev), dev)
        t0 = time.perf_counter()
        with torch_threads(1):
            cpu = flow_parts(torch.from_numpy(x), torch.from_numpy(y), "cpu")
        cpu_s += time.perf_counter() - t0
        for k, c in cpu.items():
            d = (on_card[k].cpu() - c).abs()
            if k == "brox" and where == "texture":
                d = d[8:-8, 8:-8]
            vs_cpu[f"{k}_{where}"] = (float(d.mean()), float(d.max()))
    spread = JAX_FIGURES["brox_scene_crop"]
    part_s = {k: statistics.median(run["secs"][k] for run in outs) for k in o["secs"]}
    warm = statistics.median(secs)
    res = dict(units=1, unit="pair", warm_s=warm, warm_s_runs=secs, cold_s=cold, part_s=part_s,
               pairs_per_s=1.0 / warm, accuracy=acc, interpolate_err=interp_err,
               blend_err=blend_err, superres_err=sr_err, bilinear_err=bil_err,
               superres_frames_per_s=SR_FRAMES / part_s["superres"],
               jax_figures=JAX_FIGURES.get("flow"), card_vs_cpu=vs_cpu, cpu_s=cpu_s,
               launches=runs[0], card=card)
    print(f"[flow] 480x640, frame 0 moved by ({FLOW_SHIFT[0]}, {FLOW_SHIFT[1]}) px and "
          f"{FLOW_ROT_DEG} deg about the centre | {card}: "
          + "; ".join(f"{k} mean endpoint error {v['epe_px']:.4f} px, interior median offsets "
                      f"({v['median_offset_px'][0]:+.4f}, {v['median_offset_px'][1]:+.4f}) px"
                      for k, v in acc.items())
          + f" (the JAX package's on this input: {JAX_FIGURES.get('flow')})", flush=True)
    print(f"[flow] interpolate_frames t=0.5: mean error {interp_err:.4f} grey against the true middle "
          f"frame (a 50/50 blend: {blend_err:.4f}); BTV-L1 {SR_FRAMES} x 240x320 -> 480x640: mean "
          f"error {sr_err:.4f} grey (bilinear upscaling {bil_err:.4f}) | {card}", flush=True)
    print(f"[flow] seconds per part " + ", ".join(f"{k} {v:.4f}" for k, v in part_s.items())
          + f" (median of {WARM_RUNS}); warm run {warm:.3f} s, cold {cold:.3f} s | {card}; card vs "
          f"CPU on the scene's top-left 240x320 and on a 240x320 texture (mean, max) {vs_cpu} "
          f"({cpu_s:.2f} s on the CPU); Brox's own spread on the scene crop (mean, max): {spread}; "
          f"launches {runs[0]}", flush=True)
    for k, v in acc.items():
        if not max(abs(x) for x in v["median_offset_px"]) < FLOW_MEDIAN_BOUNDS[k]:
            fail(f"[flow] {k}: interior median offsets {v['median_offset_px']} beyond "
                 f"{FLOW_MEDIAN_BOUNDS[k]} px")
    if not (interp_err < blend_err and sr_err < bil_err):
        fail(f"[flow] interpolation ({interp_err} against {blend_err}) or super-resolution "
             f"({sr_err} against {bil_err}) does no better than its baseline")
    for k, (mean, mx) in vs_cpu.items():
        if mean <= 1e-3 and mx <= 0.05:
            continue
        jm, jx = spread["jax_jit_vs_default"]
        if k == "brox_scene" and mean <= BROX_SPREAD_FACTOR * jm and mx <= BROX_SPREAD_FACTOR * jx:
            print(f"[flow] brox on the scene crop: card vs CPU (mean {mean}, max {mx}) misses 1e-3 / "
                  f"0.05 px, within {BROX_SPREAD_FACTOR} x the JAX function's own spread ({jm}, {jx})",
                  flush=True)
            continue
        fail(f"[flow] {k} on the card differs from the CPU: mean {mean}, max {mx}")
    return res


# ------------------------------------------------------------ image-processing group slice

BGFG_FRAMES = 120
BGFG_FROM = 20  # box recall and precision over frames 20-119
BGFG_MIN_AREA = 50.0  # px, the contour area a box must reach
BGFG_IOU = 0.5
BGFG_CPU_FROM, BGFG_CPU_FRAMES = 60, 10  # card against CPU from the state after frame 60
# the JAX package's [bgfg] figures on bgfg_scene(), from tools/jax_slice9_figures.py (CPU)
JAX_FIGURES_SLICE9 = {"bgfg": {"recall": 0.55675, "precision": 0.711957}}


def bgfg_scene(base: np.ndarray, seed: int = 5):
    """The crowd of crowd_gt() (32 pedestrians, 8 vehicles, 120 frames) as
    solid boxes at fixed grey levels (uniform 120-250, one per box, later
    boxes over earlier ones) on the static background `base`, each frame
    with N(0, 2) sensor noise, clipped to [0, 255]. Frame 0 is the empty
    background. Returns (frames f32 [121, H, W], ground-truth integer
    boxes (x, y, w, h) [120, 40, 4])."""
    rng = np.random.default_rng(seed)
    boxes = np.concatenate(crowd_gt(), 1)
    levels = rng.uniform(120.0, 250.0, boxes.shape[1])
    h, w = base.shape
    frames = [base + rng.normal(0.0, 2.0, (h, w))]
    gt = np.zeros(boxes.shape, np.int64)
    for t in range(boxes.shape[0]):
        img = base.copy()
        for i, ((x, y, bw, bh), g) in enumerate(zip(boxes[t], levels)):
            x0, y0, x1, y1 = (int(round(v)) for v in (x, y, x + bw, y + bh))
            img[y0:y1, x0:x1] = g
            gt[t, i] = (x0, y0, x1 - x0, y1 - y0)
        frames.append(img + rng.normal(0.0, 2.0, (h, w)))
    return np.clip(np.stack(frames), 0, 255).astype(np.float32), gt


def box_matches(det: np.ndarray, gt: np.ndarray, iou_min: float = BGFG_IOU) -> int:
    """Greedy one-to-one matches of (x, y, w, h) boxes at IoU >= iou_min,
    highest IoU first."""
    if len(det) == 0 or len(gt) == 0:
        return 0
    d = np.asarray(det, np.float64)[:, None, :]
    g = np.asarray(gt, np.float64)[None, :, :]
    iw = np.clip(np.minimum(d[..., 0] + d[..., 2], g[..., 0] + g[..., 2]) - np.maximum(d[..., 0], g[..., 0]), 0, None)
    ih = np.clip(np.minimum(d[..., 1] + d[..., 3], g[..., 1] + g[..., 3]) - np.maximum(d[..., 1], g[..., 1]), 0, None)
    inter = iw * ih
    iou = inter / (d[..., 2] * d[..., 3] + g[..., 2] * g[..., 3] - inter)
    used_d, used_g, n = set(), set(), 0
    for k in np.argsort(-iou, axis=None, kind="stable"):
        i, j = divmod(int(k), iou.shape[1])
        if iou[i, j] < iou_min:
            break
        if i not in used_d and j not in used_g:
            used_d.add(i)
            used_g.add(j)
            n += 1
    return n


def recall_precision(dets: list, gt: np.ndarray) -> tuple[float, float]:
    """Box recall and precision over frames BGFG_FROM.. of the scene."""
    m = sum(box_matches(dets[t], gt[t]) for t in range(BGFG_FROM, len(dets)))
    n_gt = sum(len(gt[t]) for t in range(BGFG_FROM, len(dets)))
    n_det = sum(len(dets[t]) for t in range(BGFG_FROM, len(dets)))
    return m / n_gt, m / max(n_det, 1)


def bgfg_init(frame0, dev):
    from opencv_tpu_torch.ops import bgsegm

    f0 = torch_tensor(frame0, dev)
    h, w = f0.shape
    return (bgsegm.init_state(f0), bgsegm.knn_init(f0), bgsegm.gmg_init(h, w, device=dev),
            bgsegm.fgd_init(f0))


def torch_tensor(x, dev):
    """numpy (or a tensor) as a tensor on `dev`."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.as_tensor(np.ascontiguousarray(x), device=dev)


def bgfg_boxes(mask):
    """MOG2's mask through morphology_open(3), find_contours, and the
    bounding_rect of every outer contour whose contour_area is at least
    BGFG_MIN_AREA (one host read of the stacked figures). Returns (boxes
    int [n, 4], the opened mask, the Contours)."""
    import torch

    from opencv_tpu_torch.ops import contours, morphology

    opened = morphology.morphology_open(mask.to(torch.float32), 3) > 0
    cs = contours.find_contours(opened)
    keep = [i for i in range(cs.points.shape[0]) if cs.valid[i] and not cs.is_hole[i]]
    if not keep:
        return np.zeros((0, 4), np.int64), opened, cs
    n = cs.lengths[keep]
    on_dev = torch_tensor(cs.points[keep, :n.max()], mask.device)  # one upload a frame
    pts = [on_dev[j, :n[j]] for j in range(len(keep))]
    area = torch.stack([contours.contour_area(p) for p in pts])
    rect = torch.stack([contours.bounding_rect(p) for p in pts])
    area, rect = area.cpu().numpy(), rect.cpu().numpy()
    return rect[area >= BGFG_MIN_AREA].astype(np.int64), opened, cs


def bgfg_step(state, frame, gen=None, draws=None):
    """One frame of the four models; (new state, masks, boxes). KNN draws
    from `gen`, or takes `draws` = (slot, uniform)."""
    from opencv_tpu_torch.ops import bgsegm

    mog, knn, gmg, fgd = state
    mog, m_mog = bgsegm.apply(mog, frame)
    if draws is None:
        knn, m_knn = bgsegm.knn_apply(knn, frame, gen)
    else:
        knn, m_knn = bgsegm.knn_apply(knn, frame, slot=draws[0], uniform=draws[1])
    gmg, m_gmg = bgsegm.gmg_apply(gmg, frame)
    fgd, m_fgd = bgsegm.fgd_apply(fgd, frame)
    boxes, opened, cs = bgfg_boxes(m_mog)
    return (mog, knn, gmg, fgd), dict(mog2=m_mog, knn=m_knn, gmg=m_gmg, fgd=m_fgd, opened=opened,
                                      contours=cs), boxes


def bgfg_run(frames_dev, dev, keep_at: int | None = None):
    """The video-analytics loop over the scene: (boxes per frame, model
    foreground shares per frame, the state after frame `keep_at`)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    state = bgfg_init(frames_dev[0], dev)
    dets, kept = [], None
    for t in range(1, frames_dev.shape[0]):
        state, _, boxes = bgfg_step(state, frames_dev[t], gen)
        dets.append(boxes)
        if t == keep_at:
            kept = state
    return dets, kept


def _state_to(state, dev):
    return tuple(type(s)(*(v.to(dev) if hasattr(v, "to") else v for v in s)) for s in state)


def phase_bgfg(base: np.ndarray, card: str, dev: str = "cuda") -> dict:
    """[bgfg] video analytics at 480x640 over bgfg_scene's 120 frames: per
    frame MOG2 (MOG2Config() defaults), KNN, GMG and FGD, then MOG2's mask
    through morphology_open(3), find_contours, bounding_rect and
    contour_area (>= 50 px); box recall and precision at IoU >= 0.5 over
    frames 20-119 beside the JAX package's on the same scene
    (JAX_FIGURES_SLICE9). Cold on the first COLD_FRAMES frames, then warm
    WARM_RUNS times over all 120 (unit: a frame).
    Card against CPU on 10 frames from the card's state after frame 60
    with the same KNN draws: MOG2, GMG and FGD masks >= 99.9 % equal, KNN's
    equal, contours equal wherever the opened masks are."""
    import torch

    frames, gt = bgfg_scene(base)
    fd = torch_tensor(frames, dev)
    t0 = time.perf_counter()
    bgfg_run(fd[:COLD_FRAMES + 1], dev)  # loads every kernel of the warm runs
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    outs, secs, runs = warm_runs_of(lambda: bgfg_run(fd, dev, BGFG_CPU_FROM), WARM_RUNS)
    dets, kept = outs[0]
    recall, precision = recall_precision(dets, gt)
    jax_fig = JAX_FIGURES_SLICE9.get("bgfg")

    rng = np.random.default_rng(9)
    card_state, cpu_state = kept, _state_to(kept, "cpu")
    equal = {k: [] for k in ("mog2", "knn", "gmg", "fgd")}
    contours_checked = contours_equal = 0
    t0 = time.perf_counter()
    for t in range(BGFG_CPU_FROM + 1, BGFG_CPU_FROM + 1 + BGFG_CPU_FRAMES):
        slot = torch.from_numpy(rng.integers(0, 10, frames.shape[1:]))
        u = torch.from_numpy(rng.random(frames.shape[1:], dtype=np.float32))
        card_state, mc, _ = bgfg_step(card_state, fd[t], draws=(slot.to(dev), u.to(dev)))
        with torch_threads(1):
            cpu_state, mp, _ = bgfg_step(cpu_state, torch.from_numpy(frames[t]), draws=(slot, u))
        for k in equal:
            equal[k].append(float((mc[k].cpu() == mp[k]).float().mean()))
        if torch.equal(mc["opened"].cpu(), mp["opened"]):
            contours_checked += 1
            contours_equal += all(np.array_equal(a, b) for a, b in zip(mc["contours"], mp["contours"]))
    cpu_s = time.perf_counter() - t0
    share = {k: min(v) for k, v in equal.items()}
    warm = statistics.median(secs)
    n = BGFG_FRAMES
    res = dict(units=n, unit="frame", fps_warm=n / warm, fps_warm_runs=[n / s for s in secs], cold_s=cold,
               recall=recall, precision=precision, jax_figures=jax_fig,
               boxes_per_frame=float(np.mean([len(d) for d in dets])),
               card_vs_cpu_min_equal_share=share, contours_equal=[contours_equal, contours_checked],
               cpu_s=cpu_s, launches=runs[0], card=card)
    print(f"[bgfg] {n} frames 480x640, 40 boxes (MOG2, KNN, GMG, FGD; MOG2 -> open 3 -> contours -> "
          f"boxes >= {BGFG_MIN_AREA:.0f} px) | {card}: box recall {recall:.4f}, precision {precision:.4f} "
          f"at IoU >= {BGFG_IOU} over frames {BGFG_FROM}-{n - 1} (the JAX package's on this scene: "
          f"{jax_fig}); {res['boxes_per_frame']:.2f} boxes a frame; warm {n / warm:.2f} frames/s "
          f"(median of {WARM_RUNS}, range {n / max(secs):.2f} to {n / min(secs):.2f}), cold {cold:.3f} s "
          f"({COLD_FRAMES} frames)",
          flush=True)
    print(f"[bgfg] card vs CPU on frames {BGFG_CPU_FROM + 1}-{BGFG_CPU_FROM + BGFG_CPU_FRAMES} from the "
          f"same state and KNN draws: least equal mask share {share}; contours equal on "
          f"{contours_equal} of the {contours_checked} frames with equal opened masks ({cpu_s:.2f} s); "
          f"launches {runs[0]}", flush=True)
    if jax_fig is not None and not (abs(recall - jax_fig["recall"]) <= 0.01
                                    and abs(precision - jax_fig["precision"]) <= 0.01):
        fail(f"[bgfg] recall {recall} / precision {precision} away from the JAX package's {jax_fig}")
    if not (share["knn"] == 1.0 and min(share["mog2"], share["gmg"], share["fgd"]) >= 0.999):
        fail(f"[bgfg] the card's masks differ from the CPU's: {share}")
    if contours_checked == 0 or contours_equal != contours_checked:
        fail(f"[bgfg] contours equal on {contours_equal} of {contours_checked} frames")
    return res


PHOTO_HOLE = (slice(200, 240), slice(300, 360))  # 40x60
PHOTO_PATCH = (slice(150, 250), slice(400, 500))  # 100x100 seamless_clone target
HDR_TIMES = np.array([1 / 60, 1 / 15, 1 / 4, 1.0], np.float32)
HDR_SHIFT = (3, -2)  # px, exposure 1 of 4 rolled by it
HDR_GAMMA = 2.2
PHOTO_CROP = (slice(180, 300), slice(280, 440))  # 120x160: card against CPU


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10.0 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def hdr_stack(h: int = 480, w: int = 640, seed: int = 0):
    """tests/test_hdr.py's exposure stack at h x w: a smooth radiance map
    plus blocky texture through z = 255 (E t)^(1/2.2); exposure 1 rolled
    by HDR_SHIFT. Returns (stack f32 [4, H, W], radiance E, unshifted)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    E = 0.02 + 0.6 * (np.sin(xx / 9.0) * np.cos(yy / 7.0) * 0.5 + 0.5)
    E = E + np.kron(rng.uniform(0, 0.35, (h // 4 + 1, w // 4 + 1)), np.ones((4, 4)))[:h, :w]
    clean = np.stack([np.clip(255.0 * np.clip(E * t, 0, None) ** (1 / HDR_GAMMA), 0, 255)
                      for t in HDR_TIMES]).astype(np.float32)
    stack = clean.copy()
    stack[1] = np.roll(clean[1], HDR_SHIFT, (0, 1))
    return stack, E, clean


def photo_inputs(frame0: np.ndarray, seed: int = 11) -> dict:
    """The [photo] inputs from the scene's frame 0: RGB = jet colormap of
    it; frame 0 + N(0, 10) for NLM; a 40x60 hole in frame 0 blurred (25,
    6.0) (inpainting restores smooth content, as the JAX tests' scenes;
    the sparse splats of frame 0 itself it cannot); a 100x100 patch of
    the RGB's green channel rolled by 50 px cloned into frame 0; 4
    observations of frame 0 + N(0, 20); the HDR stack."""
    import torch

    from opencv_tpu_torch.core import imgproc

    rng = np.random.default_rng(seed)
    smooth = imgproc.gaussian_blur(torch.from_numpy(frame0), 25, 6.0).numpy()
    hole = np.zeros(frame0.shape, bool)
    hole[PHOTO_HOLE] = True
    patch = np.zeros(frame0.shape, bool)
    patch[PHOTO_PATCH] = True
    return dict(gray=frame0, noisy=(frame0 + rng.normal(0, 10, frame0.shape)).astype(np.float32),
                smooth=smooth, hole=hole, holed=np.where(hole, 0.0, smooth).astype(np.float32),
                patch=patch,
                obs=np.stack([np.clip(frame0 + rng.normal(0, 20, frame0.shape), 0, 255)
                              for _ in range(4)]).astype(np.float32),
                hdr=hdr_stack())


def photo_run(x: dict, dev, draws=None) -> dict:
    """Every [photo] step once on `dev`; its outputs and seconds per step.
    `draws` = (Debevec's pixel indices, decolor's pixel pairs), else the
    functions draw their own."""
    import torch

    from opencv_tpu_torch.ops import colormap, photo

    out, secs = {}, {}

    def step(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        if str(dev).startswith("cuda"):
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0

    g = torch_tensor(x["gray"], dev)
    step("rgb", lambda: colormap.apply_color_map(g, "jet"))
    step("nlm", lambda: photo.nl_means_denoise(torch_tensor(x["noisy"], dev)))
    hole = torch_tensor(x["hole"], dev)
    step("telea", lambda: photo.inpaint_telea(torch_tensor(x["holed"], dev), hole))
    step("diffusion", lambda: photo.inpaint_diffusion(torch_tensor(x["holed"], dev), hole))
    src = torch.roll(out["rgb"][..., 1], 50, 1)
    step("clone", lambda: photo.seamless_clone(src, g, torch_tensor(x["patch"], dev)))
    stack = torch_tensor(x["hdr"][0], dev)
    times = torch_tensor(HDR_TIMES, dev)
    step("align", lambda: photo.align_mtb(stack))
    idx, pairs = (None, None) if draws is None else draws
    step("debevec", lambda: photo.calibrate_debevec(out["align"], times, idx=idx))
    step("robertson", lambda: photo.calibrate_robertson(out["align"], times))
    step("merge", lambda: photo.merge_debevec(out["align"], times, out["debevec"]))
    step("tonemap", lambda: photo.tonemap_reinhard(out["merge"]))
    step("mertens", lambda: photo.merge_mertens(out["align"]))
    step("tvl1", lambda: photo.denoise_tvl1(torch_tensor(x["obs"], dev)))
    step("decolor", lambda: photo.decolor(out["rgb"], pairs=pairs))
    step("epf", lambda: photo.edge_preserving_filter(out["rgb"]))
    step("detail", lambda: photo.detail_enhance(out["rgb"]))
    step("stylization", lambda: photo.stylization(out["rgb"]))
    step("pencil", lambda: photo.pencil_sketch(out["rgb"]))
    out["secs"] = secs
    return out


def photo_figures(o: dict, x: dict) -> dict:
    """Each [photo] figure, beside the bound of the JAX package's test of
    it where it has one."""
    f0 = x["gray"]
    den = o["nlm"].cpu().numpy()
    fig = {"nlm_psnr_gain_db": psnr(den, f0) - psnr(x["noisy"], f0)}
    fig["nlm_err_ratio"] = float(np.abs(den - f0).mean() / np.abs(x["noisy"] - f0).mean())
    for k in ("telea", "diffusion"):
        fig[f"{k}_hole_err"] = float(np.abs(o[k].cpu().numpy() - x["smooth"])[x["hole"]].mean())
    cl = o["clone"].cpu().numpy()
    src = np.roll(o["rgb"][..., 1].cpu().numpy(), 50, 1)
    inner = (slice(PHOTO_PATCH[0].start + 5, PHOTO_PATCH[0].stop - 5),
             slice(PHOTO_PATCH[1].start + 5, PHOTO_PATCH[1].stop - 5))
    # the cloned patch keeps the source's texture: its gradients, not its level
    fig["clone_grad_err"] = float(np.abs(np.diff(cl[inner], axis=1) - np.diff(src[inner], axis=1)).mean())
    fig["clone_outside_equal"] = bool(np.array_equal(cl[~x["patch"]], f0[~x["patch"]]))
    stack, E, clean = x["hdr"]
    al = o["align"].cpu().numpy()
    fig["align_err"] = float(np.abs(al[1] - clean[1])[16:-16, 16:-16].mean())
    g = o["debevec"].cpu().numpy()
    zs = np.arange(30, 226)
    want = HDR_GAMMA * np.log(zs / 255.0) - HDR_GAMMA * np.log(128 / 255.0)
    fig["debevec_err"] = float(np.abs(g[zs] - g[128] - want).mean())
    gr = o["robertson"].cpu().numpy()
    fig["robertson_monotone"] = bool((np.diff(gr) >= -1e-6).all() and abs(gr[128] - 1.0) < 1e-3)
    hdr = o["merge"].cpu().numpy()
    m = (hdr > 0) & (E > 0.05)
    fig["merge_log_spread"] = float(np.std(np.log(hdr[m] / E[m])))
    ldr = o["tonemap"].cpu().numpy()
    fig["tonemap_range"] = [float(ldr.min()), float(ldr.max())]
    fig["mertens_range"] = [float(o["mertens"].min()), float(o["mertens"].max())]
    fig["tvl1_psnr_gain_db"] = psnr(o["tvl1"].cpu().numpy(), f0) - psnr(x["obs"][0], f0)
    gray, boost = (v.cpu().numpy() for v in o["decolor"])
    fig["decolor_range"] = [float(gray.min()), float(gray.max()), list(boost.shape)]
    sk = o["pencil"][0].cpu().numpy()
    fig["pencil_mean_min"] = [float(sk.mean()), float(sk.min())]
    sty = o["stylization"].cpu().numpy()
    fig["stylization_range"] = [float(sty.min()), float(sty.max())]
    return fig


# each figure's bound: tests/test_photo_videostab.py (NLM 0.45 error ratio, diffusion), test_photo2.py
# (Telea 6.0, TV-L1 +4 dB for several observations, pencil sketch), test_hdr.py (Debevec 0.15,
# merge spread 0.25, Robertson), test_decompose.py (seamless clone)
PHOTO_BOUNDS = {"nlm_err_ratio": 0.45, "telea_hole_err": 6.0, "diffusion_hole_err": 6.0,
                "debevec_err": 0.15, "merge_log_spread": 0.25, "tvl1_psnr_gain_db": 4.0,
                "clone_grad_err": 8.0}
PHOTO_CPU_TOL = {"nlm": 1e-2, "telea": 1e-2, "diffusion": 1e-2, "clone": 1e-2, "align": 0.0,
                 "debevec": 1e-3, "robertson": 1e-4, "merge": 1e-3, "tonemap": 1e-2, "mertens": 1e-4,
                 "tvl1": 1e-2, "decolor": 1e-2, "epf": 1e-2, "detail": 5e-2, "stylization": 5e-2,
                 "pencil": 5e-2, "rgb": 0.0}


def phase_photo(frame0: np.ndarray, card: str, dev: str = "cuda") -> dict:
    """[photo] at 480x640 (RGB = apply_color_map(frame 0, "jet")):
    nl_means_denoise of frame 0 + N(0, 10), inpaint_telea and
    inpaint_diffusion of a 40x60 hole in frame 0 blurred, seamless_clone of a 100x100 patch,
    the HDR chain on 4 exposures with one rolled by (3, -2) px (align_mtb,
    calibrate_debevec, calibrate_robertson, merge_debevec,
    tonemap_reinhard, merge_mertens), denoise_tvl1 of 4 observations,
    decolor and the four domain-transform filters. Each figure against the
    JAX package's test bound (PHOTO_BOUNDS); cold, then warm WARM_RUNS
    times (unit: a run). Card against CPU on PHOTO_CROP (120x160 of every
    input; the HDR chain on its own 120x160 stack; the same Debevec
    samples and decolor pairs, drawn on the host): mean |difference|
    within 1e-3 and max within PHOTO_CPU_TOL per output (grey levels;
    radiance and log response in their units; the align stack equal)."""
    import torch

    x = photo_inputs(frame0)
    t0 = time.perf_counter()
    photo_run(x, dev)
    cold = time.perf_counter() - t0
    outs, secs, runs = warm_runs_of(lambda: photo_run(x, dev), WARM_RUNS)
    o = outs[0]
    fig = photo_figures(o, x)
    step_s = {k: statistics.median(r["secs"][k] for r in outs) for k in o["secs"]}

    crop = {k: (np.ascontiguousarray(v[PHOTO_CROP]) if k not in ("obs", "hdr")
                else np.ascontiguousarray(v[:, PHOTO_CROP[0], PHOTO_CROP[1]]) if k == "obs" else v)
            for k, v in x.items()}
    crop["hdr"] = hdr_stack(120, 160)
    rng = np.random.default_rng(12)
    draws = (rng.permutation(120 * 160)[:70], [rng.integers(0, 120 * 160, 4096) for _ in range(2)])
    c_card = photo_run(crop, dev, draws)
    t0 = time.perf_counter()
    with torch_threads(1):
        c_cpu = photo_run(crop, "cpu", draws)
    cpu_s = time.perf_counter() - t0
    diffs = {}
    for k, tol in PHOTO_CPU_TOL.items():
        a, b = c_card[k], c_cpu[k]
        pairs = list(zip(a, b)) if isinstance(a, tuple) else [(a, b)]
        d = [(ai.cpu().double() - bi.double()).abs() for ai, bi in pairs]
        diffs[k] = (max(float(v.mean()) for v in d), max(float(v.max()) for v in d))
    warm = statistics.median(secs)
    res = dict(units=1, unit="run", warm_s=warm, warm_s_runs=secs, cold_s=cold, step_s=step_s,
               figures=fig, bounds=PHOTO_BOUNDS, card_vs_cpu=diffs, cpu_s=cpu_s, launches=runs[0],
               card=card)
    print(f"[photo] 480x640 (RGB: jet of frame 0) | {card}: figures {json.dumps(fig)}; bounds of the "
          f"JAX package's tests {PHOTO_BOUNDS}", flush=True)
    print(f"[photo] seconds per step " + ", ".join(f"{k} {v:.4f}" for k, v in step_s.items())
          + f" (median of {WARM_RUNS}); warm run {warm:.3f} s, cold {cold:.3f} s | {card}; card vs CPU "
          f"on 120x160 (mean, max |difference|) {diffs} ({cpu_s:.2f} s on the CPU); launches {runs[0]}",
          flush=True)
    bad = [k for k, b in PHOTO_BOUNDS.items()
           if not (fig[k] > b if k == "tvl1_psnr_gain_db" else fig[k] < b)]
    if not (fig["nlm_psnr_gain_db"] > 0 and fig["clone_outside_equal"] and fig["robertson_monotone"]
            and fig["align_err"] < 2.0 and fig["pencil_mean_min"][0] > 150.0):
        bad.append("nlm gain / clone outside / robertson / align / pencil")
    if bad:
        fail(f"[photo] figures beyond their bounds: {bad}: {fig}")
    off = {k: v for k, v in diffs.items() if not (v[0] <= 1e-3 and v[1] <= PHOTO_CPU_TOL[k])}
    if off:
        fail(f"[photo] the card differs from the CPU: {off}")
    return res


TEMPLATE_AT = (200, 300)  # (y, x) of the 64x64 patch cut from frame 0
PHASE_SHIFT = (5.3, -2.7)  # (dx, dy) px: a periodic sub-pixel shift of frame 0 blurred (7, 2.0)
MSS_SIZE = (240, 320)  # mean_shift_segmentation runs on frame 0 resized to this
LSD_NOISE = 2.0  # grey: tests/test_lsd.py's noise level (lane_frame's 20-60 uniform noise buries LSD)


def fourier_shift(img: np.ndarray, dx: float, dy: float) -> np.ndarray:
    """img moved by (dx, dy) px, periodically, by a phase ramp (f64 FFT)."""
    h, w = img.shape
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    ramp = np.exp(-2j * np.pi * (fx * dx + fy * dy))
    return np.real(np.fft.ifft2(np.fft.fft2(img) * ramp)).astype(np.float32)


def lsd_frame(seed: int = 3) -> np.ndarray:
    """lane_frame's two lanes (220, 2 px) on a flat 40 with N(0, 2) noise."""
    rng = np.random.default_rng(seed)
    img = lane_frame(rng)
    return np.where(img >= 200, img, 40.0 + rng.normal(0, LSD_NOISE, img.shape)).astype(np.float32)


def shape_points(mask: np.ndarray, n: int = 64) -> np.ndarray:
    """n points evenly along the first outer contour of `mask`."""
    from opencv_tpu_torch.ops import contours

    cs = contours.find_contours(mask)
    pts = cs.points[0, :cs.lengths[0]].astype(np.float32)
    return pts[np.linspace(0, len(pts) - 1, n).astype(int)]


def shape_masks(h: int = 160, w: int = 200):
    """An ellipse, the same ellipse scaled by 1.05 and moved by (3, 2) px
    (shape contexts are scale- and translation- but not
    rotation-invariant), and a rectangle of about its area."""
    yy, xx = np.mgrid[:h, :w].astype(np.float64)

    def ellipse(s, dx, dy):
        return ((xx - 100 - dx) / (60 * s)) ** 2 + ((yy - 80 - dy) / (30 * s)) ** 2 < 1

    rect = (np.abs(xx - 100) < 48) & (np.abs(yy - 80) < 30)
    return ellipse(1.0, 0, 0), ellipse(1.05, 3, 2), rect


def imgops_run(frame0: np.ndarray, dev) -> dict:
    """Every [imgops] step once on `dev`."""
    import torch

    from opencv_tpu_torch.core import imgproc
    from opencv_tpu_torch.ops import (color, colormap, contours, distance, histogram, lsd, phasecorr,
                                      shape, template)

    out = {}
    g = torch_tensor(frame0, dev)
    out["hist"] = histogram.calc_hist(g)
    out["equalized"] = histogram.equalize_hist(g)
    out["clahe"] = histogram.clahe(g)
    rgb = out["rgb"] = colormap.apply_color_map(g, "jet")
    out["hsv"] = color.rgb_to_hsv(rgb)
    out["hsv_rt"] = color.hsv_to_rgb(out["hsv"])
    out["ycrcb"] = color.rgb_to_ycrcb(rgb)
    out["ycrcb_rt"] = color.ycrcb_to_rgb(out["ycrcb"])
    out["lab"] = color.rgb_to_lab(rgb)
    ty, tx = TEMPLATE_AT
    tmpl = g[ty:ty + 64, tx:tx + 64]
    out["template"] = {m: template.match_template(g, tmpl, m) for m in template.METHODS}
    # tests/test_segmentation2.py's setting: a blurred image and a Hann
    # window (the 5x5 centroid of a sharp peak is biased toward integers)
    smooth = imgproc.gaussian_blur(g, 7, 2.0)
    moved = torch_tensor(fourier_shift(smooth.cpu().numpy(), *PHASE_SHIFT), dev)
    win = phasecorr.create_hanning_window(*frame0.shape, device=dev)
    (dx, dy), resp = phasecorr.phase_correlate(smooth, moved, win)
    out["phase"] = torch.stack([dx, dy, resp])
    mask = g > 20.0
    out["dist"] = distance.distance_transform(mask)
    sy, sx = np.unravel_index(np.argmin(frame0), frame0.shape)
    out["flood"] = distance.flood_fill(g, (int(sx), int(sy)), 255.0, 3.0, 3.0)
    out["mss"] = distance.mean_shift_segmentation(imgproc.resize_bilinear(g, *MSS_SIZE))
    out["lines"] = lsd.detect_lines(torch_tensor(lsd_frame(), dev))
    a_m, b_m, r_m = shape_masks()
    a, b, r = (torch_tensor(shape_points(m), dev) for m in (a_m, b_m, r_m))
    out["scd"] = [shape.shape_context_distance(a, b), shape.shape_context_distance(a, r)]
    out["hausdorff"] = torch.stack([shape.hausdorff_distance(a, b), shape.hausdorff_distance(a, r)])
    tps = shape.fit_tps(a, b, 0.01)
    out["tps"] = shape.apply_tps(tps, a)
    # EMD between 16 of the contour points of each shape, unit weights (a 256-flow LP on the host)
    pa, pb, pr = (p[::4].cpu().numpy() for p in (a, b, r))
    ones = np.ones(len(pa))
    out["emd"] = [shape.emd_exact(ones, ones, pos1=pa, pos2=q) for q in (pb, pr)]
    out["hu"] = [contours.hu_moments(contours.contour_moments(p)) for p in (a, b, r)]
    return out


def _seg_dist(seg, p, q) -> float:
    a = np.hypot(*(seg[:2] - p)) + np.hypot(*(seg[2:] - q))
    b = np.hypot(*(seg[:2] - q)) + np.hypot(*(seg[2:] - p))
    return min(a, b) / 2


def phase_imgops(frame0: np.ndarray, card: str, dev: str = "cuda") -> dict:
    """[imgops] at 480x640 on the scene's frame 0: calc_hist, equalize_hist,
    clahe; HSV and YCrCb round trips and Lab of its jet colormap;
    match_template of a 64x64 patch (every method finds it);
    phase_correlate of frame 0 blurred (7, 2.0) and moved periodically by
    (5.3, -2.7) px, with a Hann window (within 0.1 px);
    distance_transform and flood_fill at full size, mean_shift_segmentation
    at 240x320; detect_lines on lane_frame's lanes at tests/test_lsd.py's
    noise (segments within 6 px of both lanes); shape_context_distance,
    hausdorff_distance, emd_exact, TPS and Hu moments on find_contours
    points of an ellipse, its scaled and moved copy and a rectangle (each
    distance smaller to the copy than to the rectangle). Cold, then warm WARM_RUNS
    times (unit: a run). Card against CPU: histograms, equalized image,
    CLAHE, HSV/YCrCb, distances, flood fill, segmentation labels and LSD
    segment counts equal; Lab, template scores, phase, region means, shape
    figures within IMGOPS_CPU_TOL."""
    import torch

    t0 = time.perf_counter()
    imgops_run(frame0, dev)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    outs, secs, runs = warm_runs_of(lambda: imgops_run(frame0, dev), WARM_RUNS)
    o = outs[0]
    ty, tx = TEMPLATE_AT
    found = {}
    for m, sc in o["template"].items():
        s = sc.cpu().numpy()
        k = np.argmin(s) if m.startswith("sqdiff") else np.argmax(s)
        found[m] = tuple(int(v) for v in np.unravel_index(k, s.shape))
    dx, dy, resp = (float(v) for v in o["phase"].cpu())
    rt = {k: float((o[k + "_rt"] - o["rgb"]).abs().max()) for k in ("hsv", "ycrcb")}
    lines = o["lines"]
    lanes = [(LANE_SCALE * np.array([x0, y0], np.float64), LANE_SCALE * np.array([x1, y1], np.float64))
             for x0, y0, x1, y1 in LANES]
    lane_dist = [min((_seg_dist(s, p, q) for s in lines), default=np.inf) for p, q in lanes]
    labels, _ = o["mss"]
    fig = dict(template_found=found, phase=[dx, dy, resp],
               phase_err=max(abs(dx - PHASE_SHIFT[0]), abs(dy - PHASE_SHIFT[1])), round_trip_max=rt,
               dist_max=float(o["dist"].max()), flood_px=int(o["flood"][1].sum()),
               mss_regions=int(torch.unique(labels).numel()), lsd_segments=len(lines),
               lsd_lane_dist=lane_dist, scd=o["scd"], hausdorff=o["hausdorff"].cpu().tolist(),
               tps_err=float((o["tps"] - torch_tensor(shape_points(shape_masks()[1]), dev)).abs().max()),
               emd=o["emd"], clahe_range=[float(o["clahe"].min()), float(o["clahe"].max())])

    t0 = time.perf_counter()
    with torch_threads(1):
        cpu = imgops_run(frame0, "cpu")
    cpu_s = time.perf_counter() - t0
    same = {k: bool(torch.equal(o[k].cpu(), cpu[k])) for k in ("hist", "equalized", "clahe", "hsv", "ycrcb",
                                                                  "dist")}
    same["flood"] = all(torch.equal(a.cpu(), b) for a, b in zip(o["flood"], cpu["flood"]))
    same["mss_labels"] = bool(torch.equal(o["mss"][0].cpu(), cpu["mss"][0]))
    same["lsd_count"] = len(o["lines"]) == len(cpu["lines"])
    err = {"lab": float((o["lab"].cpu() - cpu["lab"]).abs().max()),
           "template_rel": max(float((o["template"][m].cpu() - cpu["template"][m]).abs().max()
                                     / cpu["template"][m].abs().max()) for m in o["template"]),
           "phase": float((o["phase"].cpu() - cpu["phase"]).abs().max()),
           "mss_means": float((o["mss"][1].cpu() - cpu["mss"][1]).abs().max()),
           "lsd_px": float(np.abs(o["lines"] - cpu["lines"]).max()) if same["lsd_count"] and len(lines) else 0.0,
           "scd": max(abs(a - b) for a, b in zip(o["scd"], cpu["scd"])),
           "hausdorff": float((o["hausdorff"].cpu() - cpu["hausdorff"]).abs().max()),
           "tps": float((o["tps"].cpu() - cpu["tps"]).abs().max()),
           "emd": max(abs(x - y) for x, y in zip(o["emd"], cpu["emd"]))}
    warm = statistics.median(secs)
    res = dict(units=1, unit="run", warm_s=warm, warm_s_runs=secs, cold_s=cold, figures=fig,
               card_vs_cpu_equal=same, card_vs_cpu_err=err, cpu_s=cpu_s, launches=runs[0], card=card)
    print(f"[imgops] 480x640 | {card}: {json.dumps(fig)}; warm run {warm:.3f} s (median of {WARM_RUNS}), "
          f"cold {cold:.3f} s", flush=True)
    print(f"[imgops] card vs CPU: equal {same}; largest differences {err} ({cpu_s:.2f} s on the CPU); "
          f"launches {runs[0]}", flush=True)
    if any(v != TEMPLATE_AT for v in found.values()):
        fail(f"[imgops] match_template missed the patch at {TEMPLATE_AT}: {found}")
    if not fig["phase_err"] < 0.1:
        fail(f"[imgops] phase_correlate found ({dx}, {dy}) for {PHASE_SHIFT}")
    if not max(lane_dist) < 6.0:
        fail(f"[imgops] LSD segments {lane_dist} px from the lanes (bound 6)")
    if not (rt["hsv"] < 1e-2 and rt["ycrcb"] < 5e-2):
        fail(f"[imgops] colour round trips off: {rt}")
    if not (fig["scd"][0] < fig["scd"][1] and fig["hausdorff"][0] < fig["hausdorff"][1]
            and fig["emd"][0] < fig["emd"][1] and fig["tps_err"] < 1.0):
        fail(f"[imgops] shape figures do not tell the moved ellipse from the rectangle: {fig}")
    if not all(same.values()):
        fail(f"[imgops] the card differs from the CPU: {same}")
    off = {k: v for k, v in err.items() if not v <= IMGOPS_CPU_TOL[k]}
    if off:
        fail(f"[imgops] the card differs from the CPU beyond {IMGOPS_CPU_TOL}: {off}")
    return res


IMGOPS_CPU_TOL = {"lab": 1e-3, "template_rel": 1e-5, "phase": 1e-3, "mss_means": 1e-3, "lsd_px": 1e-2,
                  "scd": 1e-4, "hausdorff": 1e-3, "tps": 1e-2, "emd": 1e-6}


# ------------------------------------------------------------ detection and inference slice

CASCADE_WIN = 24  # the trainer's default window
CASCADE_POS = 1000  # positives: ring objects at 24x24
CASCADE_NEG_IMAGES = (40, 240, 320)  # backgrounds the trainer crops its negatives from
CASCADE_SCENES = 60  # 480x640 scenes, 1-6 objects each at 1-4x the window
CASCADE_CPU_SCENES = 3  # card against CPU: raw hits and grouped boxes
CASCADE_IOU = 0.5
CLUTTER_PER_MPX = 2000  # shapes per million pixels of the cascade's backgrounds
# tests/test_traincascade.py's settings (16x16): trained on the card and on the CPU
SMALL_HAAR = dict(n_pos=400, n_bg=40, kw=dict(window=(16, 16), n_stages=5, max_weak_per_stage=12,
                                              n_neg_per_stage=600, pos_step=3, size_step=3, seed=1))
SMALL_LBP = dict(n_pos=300, n_bg=30, kw=dict(window=(16, 16), n_stages=4, max_weak_per_stage=10,
                                             n_neg_per_stage=500, pos_step=2, seed=2))


def ring_object(rng, size: int = CASCADE_WIN, jitter: float = 1.0, ground=None) -> np.ndarray:
    """tests/test_traincascade.py's object (a bright ring, N(0, 8) noise;
    the same draws) drawn at size x size: the ring's radius and width
    scale with size / 16. On its dark ground (grey 40, the test's), or
    blended over `ground` (a crop of a scene, as opencv_createsamples
    pastes an object on backgrounds). Rounded to 8 bits."""
    k = size / 16.0
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cy = size / 2 - 0.5 + rng.uniform(-jitter, jitter) * k
    cx = size / 2 - 0.5 + rng.uniform(-jitter, jitter) * k
    ring = np.exp(-((np.hypot(yy - cy, xx - cx) - 4.5 * k) ** 2) / (3.0 * k * k))
    base = 40.0 if ground is None else ground * (1.0 - ring)
    img = base + (170.0 if ground is None else 210.0) * ring + rng.normal(0, 8, (size, size))
    return np.round(np.clip(img, 0, 255)).astype(np.float32)


def blocky_background(rng, h: int = 80, w: int = 80) -> np.ndarray:
    """tests/test_traincascade.py's background (uniform 20-200 blocks of
    8 px, N(0, 12) noise; the same draws), rounded to 8 bits."""
    img = np.kron(rng.uniform(20, 200, (h // 8, w // 8)).astype(np.float32), np.ones((8, 8), np.float32))
    img += rng.normal(0, 12, (h, w)).astype(np.float32)
    return np.round(np.clip(img, 0, 255)).astype(np.float32)


def cluttered_background(rng, h: int, w: int, per_mpx: int = CLUTTER_PER_MPX) -> np.ndarray:
    """blocky_background's blocks with shapes over them before the noise:
    discs, rectangles and arcs of rings (60-330 degrees), radius 3-20
    px, grey 20-230, `per_mpx` per million pixels. The arcs are the hard
    negatives of a ring detector. Rounded to 8 bits."""
    img = np.kron(rng.uniform(20, 200, (h // 8, w // 8)).astype(np.float32), np.ones((8, 8), np.float32))
    for _ in range(int(per_mpx * h * w / 1e6)):
        kind, r = int(rng.integers(4)), rng.uniform(3, 20)
        cy, cx, grey = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(20, 230)
        y0, y1, x0, x1 = int(max(cy - r - 4, 0)), int(min(cy + r + 4, h)), int(max(cx - r - 4, 0)), int(min(cx + r + 4, w))
        yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
        d = np.hypot(yy - cy, xx - cx)
        if kind == 0:
            mask = d <= r
        elif kind == 1:
            mask = (np.abs(yy - cy) <= r) & (np.abs(xx - cx) <= r * rng.uniform(0.3, 1.0))
        else:
            a0, span, width = rng.uniform(0, 2 * np.pi), rng.uniform(np.pi / 3, 11 * np.pi / 6), rng.uniform(1, 3)
            mask = (np.abs(d - r) <= width) & ((np.arctan2(yy - cy, xx - cx) - a0) % (2 * np.pi) <= span)
        img[y0:y1, x0:x1][mask] = grey
    img += rng.normal(0, 12, (h, w)).astype(np.float32)
    return np.round(np.clip(img, 0, 255)).astype(np.float32)


def cascade_training_set(n_pos: int, n_bg: int, bg_hw=(80, 80), size: int = CASCADE_WIN, seed: int = 0,
                         clutter: bool = True):
    """(positives [n_pos, size, size], n_bg backgrounds of bg_hw):
    cluttered backgrounds, or tests/test_traincascade.py's plain ones."""
    rng = np.random.default_rng(seed)
    if not clutter:
        pos = np.stack([ring_object(rng, size) for _ in range(n_pos)])
        return pos, [blocky_background(rng, *bg_hw) for _ in range(n_bg)]
    grounds = cluttered_background(rng, 480, 640)  # the positives' grounds: crops of another scene
    pos = []
    for _ in range(n_pos):
        y, x = int(rng.integers(0, 480 - size)), int(rng.integers(0, 640 - size))
        pos.append(ring_object(rng, size, ground=grounds[y:y + size, x:x + size]))
    return np.stack(pos), [cluttered_background(rng, *bg_hw) for _ in range(n_bg)]


def cascade_scenes(n: int = CASCADE_SCENES, h: int = 480, w: int = 640, seed: int = 3):
    """n cluttered 480x640 backgrounds, each with 1-6 ring objects of
    24-96 px (1-4x the window), none overlapping. Returns (scenes f32
    [n, h, w], ground-truth (x, y, w, h) boxes per scene)."""
    rng = np.random.default_rng(seed)
    scenes, gts = [], []
    for _ in range(n):
        img, boxes = cluttered_background(rng, h, w), []
        for _ in range(int(rng.integers(1, 7))):
            for _ in range(50):  # a free place
                s = int(round(CASCADE_WIN * rng.uniform(1.0, 4.0)))
                x, y = int(rng.integers(0, w - s)), int(rng.integers(0, h - s))
                if all(x + s <= bx or bx + bs <= x or y + s <= by or by + bs <= y for bx, by, bs, _ in boxes):
                    img[y:y + s, x:x + s] = ring_object(rng, s, 0.0, ground=img[y:y + s, x:x + s])
                    boxes.append((x, y, s, s))
                    break
        scenes.append(img)
        gts.append(np.asarray(boxes, np.float64).reshape(-1, 4))
    return np.stack(scenes), gts


def train_both(dev: str, small: bool = False):
    """(Haar, LBP) cascades trained on `dev` at the trainer's defaults on
    CASCADE_POS positives and CASCADE_NEG_IMAGES backgrounds, each written
    to XML with the trainer's writer and read back with the detector's
    loader, and the seconds each training took. `small`:
    tests/test_traincascade.py's settings and sizes instead."""
    import tempfile

    import torch

    from opencv_tpu_torch.ml import traincascade
    from opencv_tpu_torch.ops import cascade

    out, secs = [], []
    for kind, cfg in (("haar", SMALL_HAAR), ("lbp", SMALL_LBP)):
        if small:
            pos, negs = cascade_training_set(cfg["n_pos"], cfg["n_bg"], size=16, seed=cfg["kw"]["seed"],
                                             clutter=False)
            kw = cfg["kw"]
        else:
            pos, negs = cascade_training_set(CASCADE_POS, CASCADE_NEG_IMAGES[0], CASCADE_NEG_IMAGES[1:], seed=11)
            kw = {}
        train = traincascade.train_cascade if kind == "haar" else traincascade.train_cascade_lbp
        t0 = time.perf_counter()
        model = train(pos, negs, device=dev, **kw)
        if dev != "cpu":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, f"{kind}.xml")
            if kind == "haar":
                traincascade.save_opencv_cascade(model, path)
                out.append(cascade.load_opencv_cascade(path))
            else:
                traincascade.save_opencv_lbp_cascade(model, path)
                out.append(cascade.load_opencv_lbp_cascade(path))
    return out, secs


def same_model(a, b) -> bool:
    return tuple(a.window) == tuple(b.window) and all(
        np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f))) for f in a._fields[1:])


def detect_scenes(scenes_dev, model) -> list:
    from opencv_tpu_torch.ops import cascade

    detect = cascade.detect_multi_scale if isinstance(model, cascade.CascadeModel) \
        else cascade.detect_multi_scale_lbp
    return [detect(s, model)[0] for s in scenes_dev]


def phase_cascade(card: str, dev: str = "cuda") -> dict:
    """[cascade] objdetect's train-then-detect flow: a Haar cascade and an
    LBP cascade trained on `dev` at the trainer's defaults (24x24 window,
    8 stages, <= 25 / 20 weak per stage, 1 000 negatives a stage mined from
    40 backgrounds of 240x320, hit rate 0.995, false alarm 0.5) on 1 000
    ring objects, written to XML and read back (the model read back is
    the one used); detect_multi_scale and detect_multi_scale_lbp at their
    defaults (scale 1.2, groups of > 2) on 60 seeded 480x640 scenes of 1-6
    objects at 1-4x the window: recall and precision at IoU >= 0.5, warm
    frames/s (median of WARM_RUNS over the 60 scenes) and a cold run on
    COLD_FRAMES scenes (unit: a frame). Card against CPU on 3 scenes: raw
    hits of every scale and grouped boxes equal. tests/test_traincascade.py's
    small trainings on `dev` and on the CPU: equal models."""
    import torch

    from opencv_tpu_torch.ops import cascade

    (haar, lbp), train_s = train_both(dev)
    scenes, gts = cascade_scenes(CASCADE_SCENES)
    sd = torch_tensor(scenes, dev)
    res = dict(units=len(scenes), unit="frame", card=card, train_s=train_s,
               stages=[len(haar.stage_thresholds), len(lbp.stage_thresholds)],
               stumps=[int(haar.feature.size), int(lbp.feature.size)], launches={})
    for i, (kind, model) in enumerate((("haar", haar), ("lbp", lbp))):
        t0 = time.perf_counter()
        detect_scenes(sd[:COLD_FRAMES], model)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        outs, secs, runs = warm_runs_of(lambda: detect_scenes(sd, model), WARM_RUNS)
        dets = outs[0]
        m = sum(box_matches(d, g, CASCADE_IOU) for d, g in zip(dets, gts))
        n_gt, n_det = sum(len(g) for g in gts), sum(len(d) for d in dets)
        warm = statistics.median(secs)
        res[kind] = dict(recall=m / n_gt, precision=m / max(n_det, 1), fps_warm=len(scenes) / warm,
                         fps_warm_runs=[len(scenes) / s for s in secs], cold_s=cold, cold_frames=COLD_FRAMES,
                         detections=n_det, objects=n_gt)
        res["launches"] = _sum_counts(res["launches"], runs[0]) if res["launches"] else runs[0]
        raw_fn = cascade.raw_hits if kind == "haar" else cascade.raw_hits_lbp
        t0 = time.perf_counter()
        equal_raw = equal_boxes = 0
        n_raw = []
        for j in range(CASCADE_CPU_SCENES):
            a, b = raw_fn(sd[j], model), raw_fn(sd[j].cpu(), model)
            n_raw.append(len(a))
            equal_raw += a == b
            equal_boxes += np.array_equal(dets[j], detect_scenes(sd[j:j + 1].cpu(), model)[0])
        res[kind].update(cpu_equal_raw=equal_raw, cpu_equal_boxes=equal_boxes, cpu_raw_hits=n_raw,
                         cpu_s=time.perf_counter() - t0)
        r = res[kind]
        print(f"[cascade] {kind}: {res['stages'][i]} stages, {res['stumps'][i]} "
              f"stumps, trained on {dev} in {train_s[i]:.2f} s | {card}; {len(scenes)} scenes "
              f"480x640, {n_gt} objects: recall {r['recall']:.4f}, precision {r['precision']:.4f} at IoU >= "
              f"{CASCADE_IOU} ({n_det} detections); warm {r['fps_warm']:.2f} frames/s (median of {WARM_RUNS}, "
              f"range {min(r['fps_warm_runs']):.2f} to {max(r['fps_warm_runs']):.2f}), cold {cold:.3f} s on "
              f"{COLD_FRAMES} frames; card vs CPU on {CASCADE_CPU_SCENES} scenes: raw hits equal on "
              f"{equal_raw} ({n_raw} hits), grouped boxes equal on {equal_boxes} ({r['cpu_s']:.1f} s)",
              flush=True)
        if equal_raw != CASCADE_CPU_SCENES or equal_boxes != CASCADE_CPU_SCENES:
            fail(f"[cascade] {kind}: the card's hits differ from the CPU's")
        if not r["recall"] > 0 or not r["precision"] > 0:
            fail(f"[cascade] {kind}: nothing found (recall {r['recall']}, precision {r['precision']})")
    t0 = time.perf_counter()
    small_card, _ = train_both(dev, small=True)
    with torch_threads(1):
        small_cpu, _ = train_both("cpu", small=True)
    same = [same_model(a, b) for a, b in zip(small_card, small_cpu)]
    res["small_training_equal"] = same
    print(f"[cascade] tests/test_traincascade.py's trainings (16x16; Haar 5 x <= 12, LBP 4 x <= 10) on "
          f"{dev} and on the CPU: models equal {same}, stages {[len(m.stage_thresholds) for m in small_card]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if not all(same):
        fail("[cascade] the small training on the card differs from the CPU's")
    return res


YOLO_CFG = """
[net]
batch=1
width=416
height=416
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
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=64
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=128
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=256
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=512
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=1

[convolutional]
batch_normalize=1
filters=1024
size=3
stride=1
pad=1
activation=leaky

###########

[convolutional]
batch_normalize=1
size=3
stride=1
pad=1
filters=1024
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=125
activation=linear

[region]
anchors = 1.08,1.19,  3.42,4.41,  6.63,11.38,  9.42,5.11,  16.62,10.52
bias_match=1
classes=20
coords=4
num=5
softmax=1
jitter=.2
rescore=1

object_scale=5
noobject_scale=1
class_scale=1
coord_scale=1

absolute=1
thresh = .6
random=1
"""  # darknet's cfg/yolov2-tiny-voc.cfg (its layers and widths)
FP32_PEAK_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores (NVIDIA data sheet, 700 W)
DNN_ITERS = 10  # timed pipeline runs per batch size, after one warm-up
DNN_RTOL = 1e-4


def yolo_weights(cfg_text: str, seed: int = 0) -> tuple[bytes, float]:
    """A darknet .weights stream (version 0.2, int64 seen counter) for
    `cfg_text` with seeded values: He-scaled kernels, BN scales and
    variances uniform 0.8-1.2, small biases and means. Returns (the
    bytes, the FLOPs of one image: 2 x multiply-adds of every
    convolution at the shapes the cfg gives, VALID max pools)."""
    import struct

    from opencv_tpu_torch.dnn.darknet_importer import parse_cfg

    rng = np.random.default_rng(seed)
    secs = parse_cfg(cfg_text)
    c, h, w = int(secs[0]["channels"]), int(secs[0]["height"]), int(secs[0]["width"])
    chunks, flops = [struct.pack("<3i", 0, 2, 0), struct.pack("<q", 0)], 0.0
    for sec in secs[1:]:
        if sec["type"] == "convolutional":
            n, k, s = int(sec["filters"]), int(sec.get("size", 1)), int(sec.get("stride", 1))
            p = k // 2 if int(sec.get("pad", 0)) else 0
            parts = [rng.normal(0, 0.01, n)]
            if int(sec.get("batch_normalize", 0)):
                parts += [rng.uniform(0.8, 1.2, n), rng.normal(0, 0.05, n), rng.uniform(0.8, 1.2, n)]
            parts.append(rng.normal(0, np.sqrt(2.0 / (c * k * k)), (n, c, k, k)))
            chunks += [np.asarray(a, np.float32).tobytes() for a in parts]
            h, w = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
            flops += 2.0 * n * c * k * k * h * w
            c = n
        elif sec["type"] == "maxpool":
            k, s = int(sec.get("size", 2)), int(sec.get("stride", 2))
            h, w = (h - k) // s + 1, (w - k) // s + 1
    return b"".join(chunks), flops


def yolo_pipeline(net, x):
    """Forward (region decode included), then NMS per image (iou 0.45,
    darknet's) on each box's objectness above 0.5: seeded weights leave
    every class score under the region's 0.6 threshold, so the class
    scores would give NMS no box. (decoded [N, K, 25], (indices, keep)
    per image)."""
    from opencv_tpu_torch.dnn import layers

    net.set_input(x)
    out = net.forward()
    kept = []
    for b in range(out.shape[0]):
        idx, keep = layers.nms_boxes(out[b, :, :4], out[b, :, 4], 0.45, 0.5)
        kept.append((idx, keep))
    return out, kept


def _allclose_scaled(a, b, rtol: float = DNN_RTOL) -> tuple[bool, float]:
    """|a - b| <= rtol * (|b| + max |b|), and the largest |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return bool((np.abs(a - b) <= rtol * (np.abs(b) + scale)).all()), float(np.abs(a - b).max() / max(scale, 1e-30))


def phase_dnn(card: str, dev: str = "cuda", size: int = 416) -> dict:
    """[dnn] (a) tests/fixtures/tiny_cnn.onnx on its input against its
    expected output (within 1e-5, tests/test_dnn_fixture.py's bound) and
    the CPU; (b) darknet's YOLOv2-tiny-VOC cfg (416x416x3, conv 3x3
    16-512 with BN and leaky each followed by a 2/2 max pool, the last
    2/1, conv 1024 twice, a 1x1 conv of 125, [region] 20 classes x 5
    anchors, softmax) through load_darknet with seeded weights, region
    decode and NMS: images/s warm at batch 1 and 8 (the whole pipeline,
    median of DNN_ITERS, and the forward alone by CUDA events), the FLOPs
    from the layer shapes and the share of the card's f32 peak they
    reach (recorded); card against CPU on one image, TF32 off: the last
    convolution and the decoded boxes within rtol 1e-4 of the layer's
    scale. Unit: an image."""
    import torch

    from opencv_tpu_torch.device import no_tf32
    from opencv_tpu_torch.dnn import load_darknet, load_onnx

    fix = os.path.join(REPO, "tests", "fixtures")
    x = np.load(os.path.join(fix, "tiny_cnn_input.npy"))
    with no_tf32():
        outs = []
        for d in (dev, "cpu"):
            net = load_onnx(os.path.join(fix, "tiny_cnn.onnx"), device=d)
            net.set_input(x, "input")
            outs.append(net.forward("out").cpu().numpy())
    fix_err = float(np.abs(outs[0] - np.load(os.path.join(fix, "tiny_cnn_expected.npy"))).max())
    fix_cpu = float(np.abs(outs[0] - outs[1]).max())
    print(f"[dnn] (a) tiny_cnn.onnx on {dev}: largest difference {fix_err:.3g} from the committed "
          f"expected output (bound 1e-5), {fix_cpu:.3g} from the CPU", flush=True)
    if not fix_err < 1e-5:
        fail(f"[dnn] tiny_cnn differs from its expected output by {fix_err}")

    cfg = YOLO_CFG.replace("width=416", f"width={size}").replace("height=416", f"height={size}")
    weights, flops = yolo_weights(cfg)
    rng = np.random.default_rng(1)
    x8 = rng.uniform(0, 1, (8, 3, size, size)).astype(np.float32)
    res = dict(units=8, unit="image", card=card, gflops_per_image=flops / 1e9)
    with no_tf32():
        net = load_darknet(cfg, weights, device=dev)
        for b in (1, 8):
            xb = torch_tensor(x8[:b], dev)
            yolo_pipeline(net, xb)
            torch.cuda.synchronize()
            outs, secs, runs = warm_runs_of(lambda: yolo_pipeline(net, xb), DNN_ITERS)
            fwd_ms = device_time_ms(lambda: (net.set_input(xb), net.forward()), calls=3, trials=10)
            wall = statistics.median(secs)
            out, kept = outs[0]
            n_kept = [int(k.sum()) for _, k in kept]
            share = flops * b / (fwd_ms * 1e-3) / FP32_PEAK_FLOPS
            res[f"batch{b}"] = dict(images_s=b / wall, forward_ms=fwd_ms, forward_images_s=b / (fwd_ms * 1e-3),
                                    f32_peak_share=share, grid=list(out.shape), kept=n_kept)
            if b == 8:
                res["launches"] = runs[0]
            print(f"[dnn] (b) yolov2-tiny-voc {size}x{size} batch {b} on {dev} | {card}: pipeline "
                  f"{b / wall:.2f} images/s (median of {DNN_ITERS}: forward, region decode, NMS), forward "
                  f"{fwd_ms:.3f} ms ({b / (fwd_ms * 1e-3):.1f} images/s, CUDA events); {flops / 1e9:.3f} "
                  f"GFLOP an image from the layer shapes, {100 * share:.2f} % of the f32 peak "
                  f"({FP32_PEAK_FLOPS / 1e12:.0f} TFLOP/s); output {list(out.shape)}, boxes kept {n_kept}",
                  flush=True)
            if not torch.isfinite(out).all():
                fail("[dnn] non-finite detector output")
        last = [n for n in net.layer_names() if n.endswith("_convolutional")][-1]
        got = []
        for n, d in ((net, dev), (load_darknet(cfg, weights, device="cpu"), "cpu")):
            n.set_input(torch_tensor(x8[:1], d))
            got.append((n.forward(last).cpu().numpy(), n.forward().cpu().numpy()))
    ok_conv, err_conv = _allclose_scaled(got[0][0], got[1][0])
    ok_box, err_box = _allclose_scaled(got[0][1][..., :5], got[1][1][..., :5])
    res.update(card_vs_cpu_conv=err_conv, card_vs_cpu_boxes=err_box)
    res["tf32"] = dnn_tf32_figures(net, x8, last, got[1][0], dev, res)
    print(f"[dnn] card vs CPU, one image, TF32 off: {last} largest difference {err_conv:.3g} of its scale, "
          f"decoded boxes and objectness {err_box:.3g} (rtol {DNN_RTOL}); launches {res['launches']}",
          flush=True)
    if not (ok_conv and ok_box):
        fail(f"[dnn] the card's output differs from the CPU's ({err_conv}, {err_box})")
    return res


# ------------------------------------------------------------ [clip], [ml]

CLIP_FRAMES = 100
CLIP_BASELINE_FPS = 83.12  # OpenCV 5.0.0 on a 2-CPU host, benchmarks/baselines_measured.json


@contextlib.contextmanager
def pil_blocked():
    """`import PIL` raises inside the block, whether or not PIL is
    installed: what runs there cannot be using it."""
    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if k == "PIL" or k.startswith("PIL.")}
    sys.modules["PIL"] = None
    try:
        yield
    finally:
        del sys.modules["PIL"]
        sys.modules.update(saved)


def clip_frames() -> tuple[np.ndarray, float]:
    """The first CLIP_FRAMES frames of the committed clip, decoded by the
    port's read_mjpeg_avi with PIL blocked; fails unless their SHA-256 is
    CLIP_SHA256 (the JAX reader's). Returns (u8 [100, 528, 720], host
    seconds of the decode)."""
    import hashlib

    from opencv_tpu_torch.io.video import read_mjpeg_avi

    path = os.path.join(REPO, "benchmarks", "data", "megamind_gray.avi")
    t0 = time.perf_counter()
    with pil_blocked():
        frames = read_mjpeg_avi(path, max_frames=CLIP_FRAMES)
    secs = time.perf_counter() - t0
    digest = hashlib.sha256(np.ascontiguousarray(frames).tobytes()).hexdigest()
    if digest != CLIP_SHA256:
        fail(f"[clip] decoded frames' SHA-256 {digest} is not the JAX reader's {CLIP_SHA256}")
    return frames, secs


def k4_clip_check(clip, cfg, dev) -> dict:
    """K4 held bit for bit against its plain version at the [clip] path's
    own calls: one pair (frames 1 -> 2, from GFTT's 512 points on frame 1;
    frame 0 is black) through calc_optical_flow_pyr_lk with the wrapper's
    calls recorded, then each recorded call (templates, patch and polish at
    levels 0 and 1 of 528x720, the two levels over the gate) replayed
    through the kernel and through sample_channels_plain. Fails on any
    difference or a missing site. These launches are checks, outside the
    path's counted run. Returns dict(shapes=[[C, H, W, N, win], ...],
    max_abs_err)."""
    import torch

    from opencv_tpu_torch.ops import gftt, lk
    from opencv_tpu_torch.ops.cuda import lk_sample

    calls = []
    kernel = lk_sample.sample_channels

    def record(chans, pts, win=21):
        chans = list(chans)
        calls.append((chans, pts.clone(), win))
        return kernel(chans, pts, win)

    kp = gftt.good_features_to_track(clip[1], max_corners=512, quality_level=0.01,
                                     min_distance=7.0, device=dev)
    lk_sample.sample_channels = record
    try:
        lk.calc_optical_flow_pyr_lk(clip[1], clip[2], kp.xy, kp.valid, cfg, device=dev)
    finally:
        lk_sample.sample_channels = kernel
    shapes, err, sites = [], 0.0, set()
    for chans, pts, win in calls:
        got = kernel(chans, pts, win)
        want = lk_sample.sample_channels_plain(torch.stack(chans), pts, win)
        _sync(dev)
        shape = [len(chans), *chans[0].shape, pts.shape[0], win]
        if not torch.equal(got, want):
            fail(f"[clip] K4 at {shape} differs from its plain version: {(got != want).sum().item()} values")
        err = max(err, max_abs_err((got, want)))
        shapes.append(shape)
        site = "templates" if len(chans) == 3 else ("patch" if win != cfg.win_size else "polish")
        sites.add((site, tuple(chans[0].shape)))
    levels = sorted({hw for _, hw in sites}, reverse=True)
    want_sites = {(site, hw) for site in ("templates", "patch", "polish") for hw in levels}
    if len(levels) != 2 or sites != want_sites:
        fail(f"[clip] K4's recorded calls cover {sorted(sites)}, not the three sites at two levels")
    print(f"[clip] K4 bit-equal to its plain version at the path's own {len(calls)} calls of one pair "
          f"([C, H, W, N, win]: {shapes})", flush=True)
    return dict(shapes=shapes, max_abs_err=err)


def phase_clip(dev: str = "cuda") -> dict:
    """[clip] bench.py config 2 (config2_pyrlk_clip100) as bench.py runs it,
    on the first 100 frames of benchmarks/data/megamind_gray.avi at the
    clip's own 528x720 in f32, decoded on the host by the port's reader
    without PIL and held to the JAX reader's digest: GFTT (512, 0.01, 7),
    LKConfig(win_size=21, n_levels=4), re-detection below 500 tracked;
    cold on COLD_FRAMES frames, then warm WARM_RUNS times; K4 must be
    launched; 4 pairs on the card against the CPU (0.05 px, >= 99 % equal
    status), from frame 1 (frame 0 is black, so GFTT finds no corner
    there and the path re-detects on frame 1); K4 bit-equal to its plain
    version at the path's own calls (k4_clip_check). Unit: a frame."""
    import torch

    from opencv_tpu_torch.core.config import LKConfig

    frames, decode_s = clip_frames()
    n = frames.shape[0]
    print(f"[clip] decoded {n} frames {frames.shape[1]}x{frames.shape[2]} of megamind_gray.avi on "
          f"the host with PIL blocked in {decode_s:.2f} s ({1e3 * decode_s / n:.1f} ms a frame); "
          f"SHA-256 equals the JAX reader's", flush=True)
    cfg = LKConfig(win_size=21, n_levels=4)
    clip = torch.from_numpy(frames.astype(np.float32)).to(dev)
    t0 = time.perf_counter()
    lk_config2_run(clip[:COLD_FRAMES], cfg, dev)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    outs, warm_s, runs = warm_runs_of(lambda: lk_config2_run(clip, cfg, dev), WARM_RUNS)
    if any(c["lk_sample"] <= 0 for c in runs):
        fail("kernel lk_sample was not launched on the [clip] path")
    (tracked, redetect), counts = outs[0], runs[0]
    warm = statistics.median(warm_s)
    per_pair = counts["lk_sample"] / (n - 1)
    worst, agree, n_both = lk_card_vs_cpu(clip[1:], cfg, dev)  # frame 0 is black: no corner
    print(f"[clip] pairs 1-5, card vs CPU: {n_both} points tracked in both, largest difference "
          f"{worst:.3g} px, status agreement {min(agree):.4f} (worst pair)", flush=True)
    if not worst <= 0.05:
        fail(f"[clip] LK on the card differs from the CPU run by {worst} px (> 0.05)")
    if not min(agree) >= 0.99:
        fail(f"[clip] LK status agrees with the CPU run on only {min(agree):.4f} of the points")
    k4 = k4_clip_check(clip, cfg, dev)
    res = dict(frames=n, units=n, unit="frame", decode_s=decode_s, fps_warm=n / warm,
               fps_warm_runs=[n / t for t in warm_s], warm_s=warm, cold_s=cold,
               cold_frames=COLD_FRAMES, opencv_baseline_fps=CLIP_BASELINE_FPS,
               tracked_mean=float(np.mean(tracked)), tracked_min=int(np.min(tracked)),
               redetections=redetect, k4_launches_per_pair=per_pair, cpu_check_max_px=worst,
               cpu_check_status_agreement=min(agree), k4_check=k4, launches=counts)
    print(f"[clip] bench config 2 on the committed clip, {n} frames 528x720: warm {warm:.3f} s "
          f"({n / warm:.2f} frames/s, median of {WARM_RUNS} runs, range {n / max(warm_s):.2f} to "
          f"{n / min(warm_s):.2f}; the OpenCV baseline's {CLIP_BASELINE_FPS} frames/s on a 2-CPU "
          f"host is a point of comparison), cold {cold:.3f} s on {COLD_FRAMES} frames; tracked per "
          f"pair mean {res['tracked_mean']:.1f}, min {res['tracked_min']}; {redetect} "
          f"re-detections; K4 launches per pair {per_pair:.2f}; launches {counts}", flush=True)
    return res


# letter_recog's shapes (samples/cpp/letter_recog.cpp on UCI Letter
# Recognition: 20 000 x 16, 26 classes, the first 80 % for training) on
# seeded data, and BOWKMeansTrainer's use of k-means in features2d
ML_ROWS, ML_TRAIN, ML_FEATURES, ML_CLASSES = 20_000, 16_000, 16, 26
ML_SIGMA = 4.0  # class spread: overlapping clusters, kNN accuracy near letter_recog's
ML_KNN_K = 10
ML_MLP_HIDDEN, ML_MLP_ITERS = (100, 100), 300
ML_FOREST = dict(n_trees=100, depth=10, feature_frac=0.25)  # 4 of 16 active variables
ML_ADA = dict(n_rounds=100, depth=5)
ML_KSVM_ROWS = 4000  # the RBF Gram matrix is n^2
ML_BOW = dict(rows=100_000, dim=32, k=256)
ML_GMM_K = 26
ML_SUBSET = 2000  # rows of the card-vs-CPU comparison
ML_SUBSET_TREES, ML_SUBSET_SGD_ITERS, ML_SUBSET_MLP_ITERS = 10, 10_000, 10
ML_ACC_TOL = 0.01  # the card's accuracy against the JAX package's own figure
ML_PARAM_RTOL = 1e-4  # card against CPU, of each parameter's scale
ML_FIGURE_RTOL = 1e-5  # inertia and log-likelihood from JAX's picks against the JAX package's
# The JAX package's own figures on the same seeded data, at the same
# settings with its own draws, on a CPU (tools/jax_slice11_figures.py)
JAX_FIGURES_SLICE11 = {"knn": 0.935, "naive_bayes": 0.94725, "mlp": 0.90075, "random_forest": 0.9105,
                       "linear_svm": 0.98975, "logistic": 0.99, "kernel_svm_rbf": 0.992,
                       "svmsgd": 0.99025, "adaboost": 0.9945, "gbt": 0.9935,
                       "kmeans_bow": 2200924928.0, "gmm_letters": -316965.375}

# The JAX package's k-means++ picks (row indices) of the two clusterings,
# printed by the same tool: from them the port's inertia and log-likelihood
# are held to JAX_FIGURES_SLICE11's within ML_FIGURE_RTOL
JAX_PICKS_SLICE11 = {
    "kmeans_bow": [
        23887, 90933, 28842, 54618, 51393, 98933, 46597, 78346, 37854, 2653, 9433, 1953, 46675,
        3368, 94034, 50393, 67870, 2168, 76794, 87521, 9781, 14242, 85119, 53953, 98162, 31899,
        2849, 27850, 10815, 82834, 7812, 11193, 83199, 64122, 54475, 74117, 75181, 96093, 56959,
        64829, 4725, 65710, 97220, 81716, 96706, 20249, 97660, 54726, 14295, 6466, 28839, 62524,
        75994, 78797, 47738, 30782, 70770, 68470, 32468, 69029, 2818, 97280, 21167, 24303,
        21135, 81419, 65159, 44068, 60982, 40809, 14497, 78961, 92465, 23575, 81921, 63351,
        84420, 14134, 4735, 50222, 10114, 6945, 33508, 76188, 83938, 27681, 23040, 44161, 47862,
        92863, 37439, 57848, 9287, 33945, 56512, 86770, 24779, 40138, 93387, 14963, 23547,
        58138, 82295, 51517, 36043, 31276, 12728, 46301, 67547, 17532, 87958, 98173, 82652,
        34637, 24, 60330, 2427, 62345, 89429, 52172, 65023, 62953, 4411, 30165, 16663, 87516,
        76711, 48564, 77011, 18014, 87416, 90670, 21325, 67752, 8557, 37096, 69241, 52349,
        28718, 77472, 38020, 83759, 40470, 48030, 73292, 24839, 13756, 31226, 59024, 38068,
        9662, 52493, 25882, 61855, 31428, 31766, 18822, 65652, 36640, 39272, 36707, 3323, 17254,
        81441, 98172, 98416, 24116, 26168, 49755, 31321, 37441, 42316, 79843, 58802, 97512,
        69485, 33364, 14465, 21441, 77449, 98857, 97232, 35079, 24947, 42852, 46862, 99409,
        82835, 5342, 15833, 91216, 89491, 35916, 82866, 22792, 51450, 89402, 42012, 39340,
        56465, 85424, 94100, 99363, 31143, 44020, 62225, 36694, 8823, 48189, 80110, 15484,
        62943, 59782, 12350, 77776, 44306, 82725, 91763, 29520, 50035, 41486, 84761, 77574,
        9931, 94205, 95013, 97357, 28531, 47490, 83077, 75990, 75492, 65839, 15060, 34207,
        55023, 76813, 78158, 12205, 26273, 32739, 70780, 56846, 15401, 32974, 35421, 93152,
        57960, 94677, 19435, 33214, 23119, 10774, 82768, 36942, 53519],
    "gmm_letters": [
        4687, 12557, 9075, 12975, 13413, 8542, 1055, 4064, 8224, 1248, 15388, 6123, 2976, 13479,
        7686, 3281, 1509, 1184, 14808, 6574, 2219, 14070, 10471, 13532, 1067, 1949],
}


def letter_data(seed: int = 11) -> tuple[np.ndarray, np.ndarray]:
    """[ML_ROWS, 16] f32 features and [ML_ROWS] labels: 26 Gaussian class
    clusters (centres uniform in 0-15, letter_recog's feature range,
    spread ML_SIGMA) that overlap, standardised by the training rows'
    mean and deviation (ANN_MLP scales its inputs likewise)."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, 15, (ML_CLASSES, ML_FEATURES))
    y = rng.integers(0, ML_CLASSES, ML_ROWS)
    x = centres[y] + rng.normal(0, ML_SIGMA, (ML_ROWS, ML_FEATURES))
    mu, sd = x[:ML_TRAIN].mean(0), x[:ML_TRAIN].std(0)
    return ((x - mu) / sd).astype(np.float32), y.astype(np.int64)


def bow_data(seed: int = 12) -> np.ndarray:
    """[100 000, 32] f32 descriptor-like rows: 256 visual words (centres
    uniform 0-255) with N(0, 20) spread."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, 255, (ML_BOW["k"], ML_BOW["dim"]))
    words = rng.integers(0, ML_BOW["k"], ML_BOW["rows"])
    return (centres[words] + rng.normal(0, 20, (ML_BOW["rows"], ML_BOW["dim"]))).astype(np.float32)


def ml_draws(x_train: np.ndarray, n_forest_trees: int, sgd_iters: int, seed: int = 0) -> dict:
    """Every model's random draws from seeded CPU generators, so that the
    card and the CPU fit from the same values."""
    import torch

    from opencv_tpu_torch.ml import classifiers, trees

    g = torch.Generator().manual_seed(seed)
    n, f = x_train.shape
    sizes = (f,) + ML_MLP_HIDDEN + (ML_CLASSES,)
    return dict(mlp=classifiers.mlp_init_draws(g, sizes),
                forest=trees.forest_draws(g, n, f, n_forest_trees, ML_FOREST["feature_frac"]),
                sgd=classifiers.svmsgd_indices(g, n, sgd_iters))


def _sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def ml_fit_all(xtr, ytr, xte, yte, dev, draws: dict, n_trees: int, sgd_iters: int,
               mlp_iters: int, ksvm_rows: int, counter=None) -> dict:
    """Fit and predict every classifier at letter_recog's settings on
    (xtr, ytr), test on (xte, yte), on `dev` from `draws`. Returns {name:
    dict(fit_s, predict_s, accuracy, model, pred, ops)}: the multi-class
    models on the 26 letters, the binary ones on letter 0 against the
    rest. `counter` (a dispatch counter or None) counts each fit's and
    prediction's device operations."""
    import torch

    from opencv_tpu_torch.ml import classifiers as C
    from opencv_tpu_torch.ml import trees as T

    xtr, xte = torch_tensor(xtr, dev), torch_tensor(xte, dev)
    ytr, yte = torch_tensor(ytr, dev), torch_tensor(yte, dev)
    btr, bte = (ytr == 0).long(), (yte == 0).long()
    sgn_tr, sgn_te = 2 * btr - 1, 2 * bte - 1
    kx, kb = xtr[:ksvm_rows], btr[:ksvm_rows]
    fits = {
        "knn": (lambda: None, lambda m: C.knn_classify(xtr, ytr, xte, k=ML_KNN_K, n_classes=ML_CLASSES), yte),
        "naive_bayes": (lambda: C.train_naive_bayes(xtr, ytr, ML_CLASSES),
                        lambda m: C.naive_bayes_predict_log_proba(m, xte).argmax(1), yte),
        "mlp": (lambda: C.train_mlp(None, xtr, ytr, hidden=ML_MLP_HIDDEN, n_classes=ML_CLASSES,
                                    iters=mlp_iters, init=draws["mlp"]),
                lambda m: C.mlp_predict_proba(m, xte).argmax(1), yte),
        "random_forest": (lambda: T.fit_random_forest(
            None, xtr, ytr, n_trees=n_trees, depth=ML_FOREST["depth"], n_classes=ML_CLASSES,
            feature_frac=ML_FOREST["feature_frac"],
            draws=(draws["forest"][0][:n_trees], draws["forest"][1][:n_trees])),
            lambda m: T.forest_predict_proba(m, xte).argmax(1), yte),
        "linear_svm": (lambda: C.train_linear_svm(xtr, sgn_tr.float()),
                       lambda m: torch.where(C.svm_predict(m, xte) > 0, 1, -1), sgn_te),
        "logistic": (lambda: C.train_logistic_regression(xtr, btr),
                     lambda m: (C.logistic_predict_proba(m, xte) > 0.5).long(), bte),
        "kernel_svm_rbf": (lambda: C.train_kernel_svm(kx, kb, kind="rbf"),
                           lambda m: (C.kernel_svm_decision(m, xte) > 0).long(), bte),
        "svmsgd": (lambda: C.train_svmsgd(xtr, sgn_tr, iters=sgd_iters, indices=draws["sgd"][:sgd_iters]),
                   lambda m: C.svmsgd_predict(m, xte).long(), sgn_te),
        "adaboost": (lambda: T.fit_adaboost(xtr, btr, **ML_ADA),
                     lambda m: (T.adaboost_decision(m, xte) > 0).long(), bte),
        "gbt": (lambda: T.fit_gbt(xtr, btr), lambda m: (T.gbt_decision(m, xte) > 0).long(), bte),
    }
    out = {}
    for name, (fit, predict, truth) in fits.items():
        ops0 = counter.n if counter else 0
        _sync(dev)
        t0 = time.perf_counter()
        model = fit()
        _sync(dev)
        t1 = time.perf_counter()
        pred = predict(model)
        _sync(dev)
        t2 = time.perf_counter()
        acc = float((pred == truth).float().mean())
        out[name] = dict(fit_s=t1 - t0, predict_s=t2 - t1, accuracy=acc, model=model, pred=pred,
                         ops=(counter.n - ops0) if counter else None)
    return out


def ml_picks(name: str, x, dev="cpu"):
    """k-means++ picks of the clustering run `name` from its seeded CPU
    generator."""
    import torch

    from opencv_tpu_torch.ml import clustering as CL

    seed, k = {"kmeans_bow": (1, ML_BOW["k"]), "gmm_letters": (2, ML_GMM_K)}[name]
    return CL.kmeans_pp_picks(torch.Generator().manual_seed(seed), torch_tensor(x, dev), k)


def ml_cluster_all(xb, xl, dev, picks: dict | None = None, counter=None) -> dict:
    """k-means (k = 256, 30 Lloyd iterations) of the descriptor rows and
    GMM EM (k = 26, 50 iterations) of the letter features, from k-means++
    `picks` (drawn here, from seeded CPU generators, when not given; the
    draw is part of the fit's time). Each result's `pred` is the row's
    cluster: the k-means label, the GMM's most likely component."""
    from opencv_tpu_torch.ml import clustering as CL

    out = {}
    for name in ("kmeans_bow", "gmm_letters"):
        x = torch_tensor(xb if name == "kmeans_bow" else xl, dev)
        ops0 = counter.n if counter else 0
        _sync(dev)
        t0 = time.perf_counter()
        pk = ml_picks(name, x, dev) if picks is None else picks[name]
        if name == "kmeans_bow":
            res = CL.kmeans(None, x, ML_BOW["k"], picks=pk)
            pred, figure = res.labels, res.inertia
        else:
            res = CL.gmm_em(None, x, ML_GMM_K, picks=pk)
            pred = CL._log_prob(x, res.means, res.variances, res.weights).argmax(1)
            figure = res.log_likelihood
        _sync(dev)
        out[name] = dict(fit_s=time.perf_counter() - t0, figure=float(figure), model=res, pred=pred,
                         ops=(counter.n - ops0) if counter else None)
    return out


def _op_counter():
    """A dispatch mode that counts the ATen operations run inside it (on
    the card, about one kernel launch each)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCounter(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    return OpCounter()


def _params_close(a, b, rtol: float = ML_PARAM_RTOL) -> float:
    """Largest |a - b| over the tensor leaves of two models, relative to
    each leaf's largest magnitude (at least 1); inf on a structure
    mismatch."""
    import torch

    def leaves(m):
        if isinstance(m, torch.Tensor):
            return [m]
        if isinstance(m, (tuple, list)):
            return [t for v in m for t in leaves(v)]
        return []

    la, lb = leaves(a), leaves(b)
    if len(la) != len(lb):
        return float("inf")
    worst = 0.0
    for x, y in zip(la, lb):
        x, y = x.detach().cpu().double(), y.detach().cpu().double()
        if x.shape != y.shape:
            return float("inf")
        if x.numel():
            worst = max(worst, float((x - y).abs().max()) / max(float(y.abs().max()), 1.0))
    return worst


def phase_ml(card: str, dev: str = "cuda") -> dict:
    """[ml] OpenCV's ml sample (samples/cpp/letter_recog.cpp) at its size on
    seeded data of its shape (20 000 x 16, 26 overlapping classes; 16 000
    to train, 4 000 to test), every model with the sample's settings where
    the function takes them: kNN k = 10, naive Bayes, an MLP 16-100-100-26
    with 300 RPROP iterations, a random forest of 100 trees at depth 10
    with feature_frac 0.25; on letter 0 against the rest the linear SVM,
    logistic regression, the RBF kernel SVM on 4 000 rows, SVMSGD (100 000
    steps), AdaBoost (100 trees at depth 5) and GBT. k-means (k = 256) of
    100 000 x 32 descriptor rows (BOWKMeansTrainer's use) and GMM EM (k =
    26) of the letter features. Each model's test accuracy (inertia or
    log-likelihood), fit and predict seconds; accuracies within
    ML_ACC_TOL of the JAX package's own figures; the two clusterings fitted
    again from the JAX package's own k-means++ picks (JAX_PICKS_SLICE11),
    their inertia and log-likelihood within ML_FIGURE_RTOL of its figures
    (from the port's own draws they are printed, not held: other seeds,
    another optimum). Then the card against
    the CPU on a 2 000-row subset from the same draws (10 trees, 10 000
    SVMSGD steps, 10 MLP iterations: RPROP steps by the sign of each
    gradient, so a last-bit difference in a gradient near zero flips a
    step and parts the two devices' weights after 20-30 iterations, as it
    parts the JAX package's): equal predictions, trees equal, parameters within
    ML_PARAM_RTOL of their scale; the device operations each fit runs
    are counted there. Unit: a model."""
    import torch

    from opencv_tpu_torch.ops import cuda as cuda_ops

    x, y = letter_data()
    xb = bow_data()
    xtr, ytr, xte, yte = x[:ML_TRAIN], y[:ML_TRAIN], x[ML_TRAIN:], y[ML_TRAIN:]
    draws = ml_draws(xtr, ML_FOREST["n_trees"], 100_000)
    cuda_ops.reset_launch_counts()
    fits = ml_fit_all(xtr, ytr, xte, yte, dev, draws, ML_FOREST["n_trees"], 100_000, ML_MLP_ITERS,
                      ML_KSVM_ROWS)
    clus = ml_cluster_all(xb, xtr, dev)
    _sync(dev)
    counts = dict(cuda_ops.launch_counts)
    from_jax = ml_cluster_all(xb, xtr, dev, JAX_PICKS_SLICE11)

    # card against CPU on the subset, the same draws; the card's device operations counted
    sub = ML_SUBSET
    sx, sy, qx, qy = xtr[:sub], ytr[:sub], xte[:sub // 2], yte[:sub // 2]
    sdraws = ml_draws(sx, ML_SUBSET_TREES, ML_SUBSET_SGD_ITERS, seed=1)
    spicks = {"kmeans_bow": ml_picks("kmeans_bow", xb[:sub]), "gmm_letters": ml_picks("gmm_letters", sx)}
    counter = _op_counter()
    with counter:
        on_card = ml_fit_all(sx, sy, qx, qy, dev, sdraws, ML_SUBSET_TREES, ML_SUBSET_SGD_ITERS,
                             ML_SUBSET_MLP_ITERS, sub, counter)
        on_card |= ml_cluster_all(xb[:sub], sx, dev, spicks, counter)
    on_cpu = ml_fit_all(sx, sy, qx, qy, "cpu", sdraws, ML_SUBSET_TREES, ML_SUBSET_SGD_ITERS,
                        ML_SUBSET_MLP_ITERS, sub)
    on_cpu |= ml_cluster_all(xb[:sub], sx, "cpu", spicks)
    res = dict(units=len(fits) + len(clus), unit="model", card=card, launches=counts, models={})
    bad = []
    for name, r in list(fits.items()) + list(clus.items()):
        gc, cc = on_card[name], on_cpu[name]
        same = bool(torch.equal(gc["pred"].cpu(), cc["pred"]))
        perr = _params_close(gc["model"], cc["model"])
        jax_fig = JAX_FIGURES_SLICE11.get(name)
        metric = r.get("accuracy", r.get("figure"))
        res["models"][name] = dict(fit_s=r["fit_s"], predict_s=r.get("predict_s"), metric=metric,
                                   jax_figure=jax_fig, card_vs_cpu_equal=same,
                                   card_vs_cpu_param_rel=perr, subset_ops=gc["ops"])
        what = "accuracy" if "accuracy" in r else ("inertia" if name == "kmeans_bow" else "log-likelihood")
        jax_txt = f" (the JAX package's {jax_fig:.4f})" if jax_fig is not None else ""
        pred_txt = f", predict {r['predict_s']:.3f} s" if "predict_s" in r else ""
        if name in from_jax:
            fig = from_jax[name]["figure"]
            rel = abs(fig - jax_fig) / abs(jax_fig)
            res["models"][name].update(from_jax_picks=fig, from_jax_picks_rel=rel)
            jax_txt += f"; from the JAX package's picks {fig:.4f}, off by {rel:.3g} of it"
            if not rel <= ML_FIGURE_RTOL:
                bad.append(f"{name} {what} {fig} from the JAX package's picks against its {jax_fig}")
        print(f"[ml] {name}: {what} {metric:.4f}{jax_txt}; fit {r['fit_s']:.3f} s{pred_txt} on {dev} "
              f"| {card}; card vs CPU on {sub} rows: {'equal' if same else 'DIFFERENT'} labels, "
              f"parameters within {perr:.3g} of their scale; {gc['ops']} device ops in that fit",
              flush=True)
        if not same or not perr <= ML_PARAM_RTOL:
            bad.append(f"{name} card vs CPU (labels equal {same}, parameters {perr})")
        if "accuracy" in r and jax_fig is not None and not abs(metric - jax_fig) <= ML_ACC_TOL:
            bad.append(f"{name} accuracy {metric} against the JAX package's {jax_fig}")
    print(f"[ml] {len(res['models'])} models; port kernels launched in the full fits {counts}", flush=True)
    if bad:
        fail("[ml] " + "; ".join(bad))
    return res


# ------------------------------------------------------------ [dist]

# The scale the JAX package names for its CG and sharded solver
# (opencv_tpu/optim/ba.py `_resolve_solver`: "100 KFs x 1e5 points"): each
# point seen by 8 consecutive keyframes, 800 000 observations; the solver
# settings of bench.py config 4 (Huber 5e-3) with 10 LM and 60 CG iterations
DIST_BA = dict(n_cams=100, n_pts=100_000, views=8)
DIST_LM = dict(iters=10, huber_delta=5e-3, cg_iters=60)
DIST_KNN = (2000, 128_000)  # queries, 256-bit map rows: K3's table shape, the VO map's scale
DIST_RANK_TIMEOUT_S = 300.0
# The sharded runs against the single-device solver, compared under
# deterministic algorithms. With atomics (index_add_ on CUDA) the solver
# does not repeat itself: 60 f32 CG iterations on the 100-camera chain
# amplify the last bits, so two runs differ on cam_tvec by up to ~2e-3 on an
# H100, and three runs agreeing to 7.4e-5 once made a spread that a run of
# the sharded solver then missed by 30x. Without atomics the solver is
# reproducible: (a) world 1 must give its bits; (b) two ranks sum in
# another order, and are held to DIST_ORDER_FACTOR times the solver's own
# sensitivity to its summation order (the observations permuted), or the
# JAX tests' 1e-3 where that is larger.
DIST_ORDER_FACTOR = 4.0
DIST_JAX_TVEC_BOUND = 1e-3


def _rodrigues_np(r: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(r, axis=1)[:, None, None]
    k = r / np.maximum(th[:, 0], 1e-12)
    K = np.zeros((len(r), 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K = K - K.transpose(0, 2, 1)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def ba_scene(n_cams: int = 100, n_pts: int = 100_000, views: int = 8, noise: float = 1e-3,
             seed: int = 0) -> dict:
    """bench.py config 4's scene (seeded numpy, rotations N(0, 0.01), points
    at depth 4-20, normalised-coordinate noise 1e-3, cameras 0 and 1 fixed),
    widened into a trajectory: cameras 0.5 apart along x, each point seen by
    `views` consecutive keyframes (observations point by point). The start
    moves the free cameras by N(0, 0.002) rad and N(0, 0.02) and every point
    by N(0, 0.2). Fields of a BAProblem as numpy."""
    rng = np.random.default_rng(seed)
    C, P = n_cams, n_pts
    centres = np.stack([0.5 * np.arange(C), np.zeros(C), np.zeros(C)], 1)
    rvec = rng.normal(0, 0.01, (C, 3))
    R = _rodrigues_np(rvec)
    tvec = -np.einsum("cij,cj->ci", R, centres)
    first = rng.integers(0, C - views + 1, P)
    mid = 0.5 * (first + (views - 1) / 2)
    pts = np.stack([mid + rng.uniform(-3, 3, P), rng.uniform(-5, 5, P), rng.uniform(4, 20, P)], 1)
    obs_cam = (first[:, None] + np.arange(views)).reshape(-1)
    obs_pt = np.repeat(np.arange(P), views)
    pc = np.einsum("oij,oj->oi", R[obs_cam], pts[obs_pt]) + tvec[obs_cam]
    uv = pc[:, :2] / pc[:, 2:] + rng.normal(0, noise, (len(obs_cam), 2))
    fixed = np.arange(C) < 2
    free = ~fixed[:, None]
    return dict(cam_rvec=(rvec + free * rng.normal(0, 0.002, (C, 3))).astype(np.float32),
                cam_tvec=(tvec + free * rng.normal(0, 0.02, (C, 3))).astype(np.float32),
                points=(pts + rng.normal(0, 0.2, pts.shape)).astype(np.float32),
                obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=uv.astype(np.float32),
                obs_valid=np.ones(len(obs_cam), bool), fixed_cams=fixed)


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms inside the block (index_add_ sums
    without atomics), warnings only where an operation has none."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _timed_lm(run, dev) -> tuple:
    """(result, seconds) of `run(iters)` for DIST_LM's iterations, after a
    warm `run(1)`."""
    run(1)
    _sync(dev)
    t0 = time.perf_counter()
    out = run(DIST_LM["iters"])
    _sync(dev)
    return out, time.perf_counter() - t0


def dist_rank_main(out_dir: str, dev: str, scene: dict) -> None:
    """One rank of [dist] (b): the full problem (`ba_scene(**scene)`) on
    `dev` for every rank over gloo, this rank's half of the observations;
    all_reduce calls counted. Rank 0 writes its result to out_dir/rank0.npz."""
    import torch.distributed as dist

    from opencv_tpu_torch import convert
    from opencv_tpu_torch.parallel import dist_ba, mesh, multihost

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    multihost.initialize(f"localhost:{os.environ['MASTER_PORT']}", world, rank, backend="gloo")
    try:
        m = mesh.make_mesh(world, device=dev)
        p = convert.ba_problem(ba_scene(**scene), device=dev)
        calls = [0]
        all_reduce = dist.all_reduce

        def counted(*a, **k):
            calls[0] += 1
            return all_reduce(*a, **k)

        dist.all_reduce = counted

        def run(iters):
            calls[0] = 0
            return dist_ba.bundle_adjust_sharded(p, m, iters=iters, huber_delta=DIST_LM["huber_delta"],
                                                 cg_iters=DIST_LM["cg_iters"])

        with deterministic():
            (opt, cost), secs = _timed_lm(run, dev)
        dist.all_reduce = all_reduce
        if rank == 0:
            np.savez(os.path.join(out_dir, "rank0.npz"), tvec=opt.cam_tvec.cpu().numpy(),
                     cost=cost.cpu().numpy(), secs=secs, calls=calls[0])
    finally:
        dist.destroy_process_group()


def phase_dist(card: str, dev: str = "cuda") -> dict:
    """[dist] parallel/ on torch.distributed. (a) bundle_adjust_sharded at
    world 1 (NCCL on the card) on the 800 000-observation scene (DIST_BA,
    DIST_LM; `auto` resolves to CG there) against the single-device
    bundle_adjust(solver="cg"): under deterministic algorithms the same
    bits; LM iterations/s (with atomics, as users run it), cost before and
    after. (b) two ranks on this one card over gloo (rank 0 and rank 1
    each hold half of the observations), under deterministic algorithms,
    held to the single-device solver at the JAX tests' bounds (cam_tvec
    within 1e-3, or DIST_ORDER_FACTOR times the solver's own sensitivity to
    its summation order where that is larger; final cost below 1e-2 of the
    initial); LM iterations/s, collectives a step. (c) sharded_knn_match at
    world 1, 2000 queries against 128 000 256-bit map rows (10 % invalid):
    without cross-check through K3, equal to knn_match_auto; with it through
    the dense block, equal to knn_match. (d) dryrun_multichip(1). Launch
    counts from (a) and (c), the in-process sharded calls. Unit: a sharded
    call."""
    import torch
    import torch.distributed as dist

    from opencv_tpu_torch import convert
    from opencv_tpu_torch.core.config import MatchConfig
    from opencv_tpu_torch.ops import cuda as cuda_ops
    from opencv_tpu_torch.ops import matching
    from opencv_tpu_torch.optim import ba
    from opencv_tpu_torch.parallel import dist_ba, dist_match, dryrun, mesh, multihost

    on_card = torch.device(dev).type == "cuda"
    t0 = time.perf_counter()
    scene = ba_scene(**DIST_BA)
    p = convert.ba_problem(scene, device=dev)
    n_obs = int(p.obs_cam.shape[0])
    print(f"[dist] scene {DIST_BA['n_cams']} cameras x {DIST_BA['n_pts']} points, {n_obs} "
          f"observations, built in {time.perf_counter() - t0:.2f} s; solver "
          f"{ba._resolve_solver('auto', p)} (auto)", flush=True)
    lm = dict(huber_delta=DIST_LM["huber_delta"], cg_iters=DIST_LM["cg_iters"])
    cost0 = float(ba.cost(p))

    it_s = DIST_LM["iters"]

    def single(iters, problem=p):
        return ba.bundle_adjust(problem, iters=iters, solver="cg", **lm)

    (s1, c1), s1_s = _timed_lm(single, dev)
    perm = torch.randperm(n_obs, generator=torch.Generator().manual_seed(13)).to(p.obs_cam.device)
    p_perm = p._replace(obs_cam=p.obs_cam[perm], obs_pt=p.obs_pt[perm], obs_uv=p.obs_uv[perm],
                        obs_valid=p.obs_valid[perm])
    with deterministic():
        sd, cd = single(it_s)
        sp, _ = single(it_s, p_perm)
    order = float((sp.cam_tvec - sd.cam_tvec).abs().max())
    b_bound = max(DIST_JAX_TVEC_BOUND, DIST_ORDER_FACTOR * order)

    g = torch.Generator(device=dev)
    g.manual_seed(12)
    nq, nt = DIST_KNN
    lo, hi = -(2 ** 31), 2 ** 31
    train = torch.randint(lo, hi, (nt, 8), generator=g, device=dev, dtype=torch.int64).to(torch.int32)
    query = torch.randint(lo, hi, (nq, 8), generator=g, device=dev, dtype=torch.int64).to(torch.int32)
    query[: nq // 2] = train[torch.randperm(nt, generator=g, device=dev)[: nq // 2]]
    query[: nq // 2, 0] ^= 1
    tvalid = torch.rand(nt, generator=g, device=dev) > 0.1
    cfgs = {"k3": MatchConfig(cross_check=False), "dense": MatchConfig(cross_check=True)}

    multihost.initialize(f"localhost:{dryrun.free_port()}", 1, 0, "nccl" if on_card else "gloo")
    try:
        m1 = mesh.make_mesh(1, device=dev)
        mm = mesh.make_mesh(1, (mesh.MODEL_AXIS,), device=dev)
        cuda_ops.reset_launch_counts()
        (sh, csh), sh_s = _timed_lm(
            lambda iters: dist_ba.bundle_adjust_sharded(p, m1, iters=iters, **lm), dev)
        with deterministic():
            shd, cshd = dist_ba.bundle_adjust_sharded(p, m1, iters=it_s, **lm)
        got = {k: dist_match.sharded_knn_match(query, train, mm, train_valid=tvalid, config=c)
               for k, c in cfgs.items()}
        _sync(dev)
        counts = dict(cuda_ops.launch_counts)
        knn_ms = {k: 1e3 * min(_secs(lambda: dist_match.sharded_knn_match(
            query, train, mm, train_valid=tvalid, config=c), dev) for _ in range(3))
            for k, c in cfgs.items()}
    finally:
        dist.destroy_process_group()
    a_err = float((sh.cam_tvec - s1.cam_tvec).abs().max())
    a_equal = bool(torch.equal(cshd, cd) and all(torch.equal(x, y) for x, y in zip(shd, sd)))
    want = {"k3": matching.knn_match_auto(query, train, train_valid=tvalid, config=cfgs["k3"]),
            "dense": matching.knn_match(query, train, train_valid=tvalid, config=cfgs["dense"])}
    single_ms = {"k3": 1e3 * min(_secs(lambda: matching.knn_match_auto(
        query, train, train_valid=tvalid, config=cfgs["k3"]), dev) for _ in range(3)),
        "dense": 1e3 * min(_secs(lambda: matching.knn_match(
            query, train, train_valid=tvalid, config=cfgs["dense"]), dev) for _ in range(3))}
    print(f"[dist] (a) world 1 ({'NCCL' if on_card else 'gloo'}) on {dev} | {card}: cost "
          f"{cost0:.6g} -> {float(csh):.6g} (single device {float(c1):.6g}); LM iterations/s "
          f"sharded {it_s / sh_s:.3f}, single device {it_s / s1_s:.3f}; under deterministic "
          f"algorithms the sharded solver {'gives' if a_equal else 'DOES NOT give'} the "
          f"single-device bits (with atomics cam_tvec sharded vs single {a_err:.3g}); the solver's "
          f"sensitivity to its summation order (observations permuted) {order:.3g}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dryrun.run_ranks([sys.executable, os.path.abspath(__file__), "--dist-rank", tmp,
                          "--dist-device", "cuda:0" if on_card else "cpu",
                          "--dist-scene", json.dumps(DIST_BA)], 2, DIST_RANK_TIMEOUT_S)
        b_wall = time.perf_counter() - t0
        b = dict(np.load(os.path.join(tmp, "rank0.npz")))
    b_err = float(np.abs(b["tvec"] - sd.cam_tvec.cpu().numpy()).max())
    b_calls = (int(b["calls"]) - 1) / it_s  # one for the initial cost
    print(f"[dist] (b) two ranks on {'cuda:0' if on_card else 'cpu'} over gloo | {card}: cost "
          f"{cost0:.6g} -> {float(b['cost']):.6g}; LM iterations/s {it_s / float(b['secs']):.3f} "
          f"(deterministic algorithms); {b_calls:g} all_reduce calls a step; cam_tvec vs the "
          f"single-device solver {b_err:.3g} (bound {b_bound:.3g}: the JAX tests' "
          f"{DIST_JAX_TVEC_BOUND:g} or {DIST_ORDER_FACTOR:g}x the order sensitivity); {b_wall:.1f} s "
          f"with the ranks' start-up", flush=True)

    knn_eq = {k: all(torch.equal(getattr(got[k], f), getattr(want[k], f))
                     for f in ("valid", "train_idx", "distance")) for k in cfgs}
    print(f"[dist] (c) world 1, {nq} queries x {nt} map rows of 256 bits | {card}: K3 route "
          f"{'equal to' if knn_eq['k3'] else 'DIFFERENT from'} knn_match_auto "
          f"({int(got['k3'].valid.sum())} matches), {knn_ms['k3']:.3f} ms against "
          f"{single_ms['k3']:.3f} ms; dense route with cross-check "
          f"{'equal to' if knn_eq['dense'] else 'DIFFERENT from'} knn_match "
          f"({int(got['dense'].valid.sum())} matches), {knn_ms['dense']:.3f} ms against "
          f"{single_ms['dense']:.3f} ms; launches {counts}", flush=True)

    t0 = time.perf_counter()
    d = dryrun.dryrun_multichip(1, device=None if on_card else "cpu")
    print(f"[dist] (d) dryrun_multichip(1): cost {d['cost0']:.6g} -> {d['cost']:.6g}, "
          f"{d['accepted']} step accepted, {time.perf_counter() - t0:.1f} s", flush=True)

    bad = []
    if not a_equal:
        bad.append("(a) under deterministic algorithms the sharded solver at world 1 does not give "
                   f"the single-device bits (cam_tvec off by {float((shd.cam_tvec - sd.cam_tvec).abs().max())})")
    if not float(csh) < 1e-2 * cost0:
        bad.append(f"(a) cost {float(csh)} not below 1e-2 of {cost0}")
    if not (b_err <= b_bound and float(b["cost"]) < 1e-2 * cost0):
        bad.append(f"(b) cam_tvec {b_err} from the single-device solver (bound {b_bound}), cost "
                   f"{float(b['cost'])} of {cost0}")
    if not all(knn_eq.values()):
        bad.append(f"(c) sharded 2-NN equal to the single-device matcher: {knn_eq}")
    if on_card and counts["knn2_hamming"] <= 0:
        bad.append("(c) kernel knn2_hamming was not launched on the [dist] path")
    if not np.isfinite(d["cost"]):
        bad.append(f"(d) dry-run cost {d['cost']}")
    if bad:
        fail("[dist] " + "; ".join(bad))
    return dict(units=3, unit="sharded call", card=card, launches=counts, n_obs=n_obs, cost0=cost0,
                a=dict(cost=float(csh), lm_its_s=it_s / sh_s, single_lm_its_s=it_s / s1_s,
                       tvec_vs_single=a_err, deterministic_bits_equal=a_equal,
                       order_sensitivity=order),
                b=dict(cost=float(b["cost"]), lm_its_s=it_s / float(b["secs"]),
                       all_reduce_per_step=b_calls, tvec_vs_single=b_err, tvec_bound=b_bound,
                       wall_s=b_wall),
                c=dict(equal=knn_eq, sharded_ms=knn_ms, single_ms=single_ms,
                       matches={k: int(got[k].valid.sum()) for k in cfgs}),
                d=d)


def _secs(fn, dev) -> float:
    _sync(dev)
    t0 = time.perf_counter()
    fn()
    _sync(dev)
    return time.perf_counter() - t0


@contextlib.contextmanager
def torch_default_tf32(unguard_dnn: bool = False):
    """torch's default switches inside the block (cuDNN TF32 on, matmul
    TF32 off); with `unguard_dnn`, dnn's convolution and fully connected
    layers lose their own no_tf32 (their undecorated `__wrapped__`), as
    the port had them before its TF32 repair: YOLOv2-tiny's products are
    all convolutions."""
    import torch

    from opencv_tpu_torch.dnn import layers

    saved = layers.convolution, layers.fully_connected
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    if unguard_dnn:
        layers.convolution, layers.fully_connected = (f.__wrapped__ for f in saved)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        yield
    finally:
        layers.convolution, layers.fully_connected = saved
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def dnn_tf32_figures(net, x8, last: str, cpu_last, dev, res: dict) -> dict:
    """[dnn] TF32: YOLOv2-tiny-VOC at torch's default switches. (a) The
    port before its repair (dnn's layers unguarded): `last`'s error
    against the CPU and the forward's device time at batch 1 and 8,
    beside the f32 forward's; recorded, not gated. (b) The repaired
    Net.forward at the same switches: within DNN_RTOL of the CPU, or
    fail."""
    with torch_default_tf32(unguard_dnn=True):
        net.set_input(torch_tensor(x8[:1], dev))
        _, err = _allclose_scaled(net.forward(last).cpu().numpy(), cpu_last)
        ms = {}
        for b in (1, 8):
            xb = torch_tensor(x8[:b], dev)
            ms[b] = device_time_ms(lambda: (net.set_input(xb), net.forward()), calls=3, trials=10)
    with torch_default_tf32():
        net.set_input(torch_tensor(x8[:1], dev))
        ok, err_fixed = _allclose_scaled(net.forward(last).cpu().numpy(), cpu_last)
    f32 = {b: res[f"batch{b}"]["forward_ms"] for b in (1, 8)}
    print(f"[dnn] TF32 at torch's default switches (cuDNN on, matmul off), dnn as before its repair: "
          f"{last} differs from the CPU by {err:.3g} of its scale (the f32 bound is {DNN_RTOL}); "
          f"forward {ms[1]:.3f} ms at batch 1 and {ms[8]:.3f} ms at batch 8 against {f32[1]:.3f} and "
          f"{f32[8]:.3f} ms in f32 (x{f32[1] / ms[1]:.2f} and x{f32[8] / ms[8]:.2f}); the repaired "
          f"Net.forward at the same switches: {err_fixed:.3g}", flush=True)
    if not ok:
        fail(f"[dnn] Net.forward at torch's default TF32 switches differs from the CPU by {err_fixed}")
    return dict(err_before_repair=err, forward_ms_b1=ms[1], forward_ms_b8=ms[8], err_repaired=err_fixed)


def phase_profile_dist() -> None:
    """Where the time goes in one LM iteration of the single-device CG
    solver on the [dist] scene (800 000 observations, 60 CG iterations)."""
    from opencv_tpu_torch import convert
    from opencv_tpu_torch.optim import ba

    p = convert.ba_problem(ba_scene(**DIST_BA), device="cuda")
    lm = dict(iters=1, huber_delta=DIST_LM["huber_delta"], cg_iters=DIST_LM["cg_iters"], solver="cg")
    _timed_lm(lambda iters: ba.bundle_adjust(p, **dict(lm, iters=iters)), "cuda")
    profile_report("profile dist ba", lambda: ba.bundle_adjust(p, **lm), 1, "LM iteration")


def phase_profile_slice10() -> None:
    """Where the time goes in one warm Haar detect_multi_scale of a 480x640
    scene and one warm YOLOv2-tiny-VOC image (batch 1, NMS included)."""
    import torch

    from opencv_tpu_torch.device import no_tf32
    from opencv_tpu_torch.dnn import load_darknet
    from opencv_tpu_torch.ml import traincascade
    from opencv_tpu_torch.ops import cascade

    pos, negs = cascade_training_set(300, 20, (240, 320), seed=11)
    haar = traincascade.train_cascade(pos, negs, n_stages=4, device="cuda")
    scene = torch_tensor(cascade_scenes(1)[0][0], "cuda")
    cascade.detect_multi_scale(scene, haar)
    torch.cuda.synchronize()
    profile_report("profile haar 480x640", lambda: cascade.detect_multi_scale(scene, haar), 1, "frame")
    weights, _ = yolo_weights(YOLO_CFG)
    with no_tf32():
        net = load_darknet(YOLO_CFG, weights, device="cuda")
        x = torch.rand((1, 3, 416, 416), device="cuda")
        yolo_pipeline(net, x)
        torch.cuda.synchronize()
        profile_report("profile yolov2-tiny batch 1", lambda: yolo_pipeline(net, x), 1, "image")


def phase_profile_slice9(base: np.ndarray) -> None:
    """Where the time goes in one warm [bgfg] frame (four models, opening,
    contours, boxes) and in one warm 480x640 nl_means_denoise."""
    import torch

    from opencv_tpu_torch.ops import photo

    frames, _ = bgfg_scene(base)
    fd = torch_tensor(frames[:31], "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = bgfg_init(fd[0], "cuda")
    for t in range(1, 30):
        state, _, _ = bgfg_step(state, fd[t], gen)
    torch.cuda.synchronize()
    profile_report("profile bgfg frame", lambda: bgfg_step(state, fd[30], gen), 1, "frame")
    noisy = torch_tensor(photo_inputs(base)["noisy"], "cuda")
    photo.nl_means_denoise(noisy)
    torch.cuda.synchronize()
    profile_report("profile nl_means 480x640", lambda: photo.nl_means_denoise(noisy), 441, "shift")


def phase_profile_slice8() -> None:
    """Where the time goes in one warm SGBM disparity and one warm TV-L1
    pair at 480x640 (one warp a level: the profile's post-processing
    takes ~1 s per thousand kernels, and every warp repeats the same
    primal-dual steps)."""
    import torch

    from opencv_tpu_torch.ops import sgbm, tvl1

    left, right, _ = stereo_pair()
    lt, rt = torch.from_numpy(left).to("cuda"), torch.from_numpy(right).to("cuda")
    cfg = sgbm.SGBMConfig(num_disparities=STEREO_ND)
    sgbm.compute_disparity_sgbm(lt, rt, cfg)
    torch.cuda.synchronize()
    profile_report("profile sgbm 480x640", lambda: sgbm.compute_disparity_sgbm(lt, rt, cfg), 1, "pair")
    frames, _, _ = make_sequence(1)
    prev, nxt, _, _ = flow_pair(frames[0])
    a, b = torch.from_numpy(prev).to("cuda"), torch.from_numpy(nxt).to("cuda")
    tvl1.calc_optical_flow_tvl1(a, b, warps=1)
    torch.cuda.synchronize()
    profile_report("profile tvl1 480x640 1 warp", lambda: tvl1.calc_optical_flow_tvl1(a, b, warps=1), 1, "pair")


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
    views, two calibrations, the circles view) and in stabilize over 4
    frames."""
    import torch

    from opencv_tpu_torch.ops import videostab

    views, obj, circles, _ = calibapp_views()
    calibapp_run(views, obj, circles)
    profile_report("profile calibapp", lambda: calibapp_run(views, obj, circles), len(views) + 1, "view")
    frames = stab_frames(base, 4)
    videostab.stabilize(frames)
    torch.cuda.synchronize()
    profile_report("profile stab", lambda: videostab.stabilize(frames), 4, "frame")


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
    import argparse

    global WARM_RUNS
    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch/CUDA port on one card.")
    ap.add_argument("--measure", action="store_true",
                    help="two warm runs a path (median and range) and the torch.profiler phases")
    ap.add_argument("--dist-rank", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--dist-device", default="cuda:0", help=argparse.SUPPRESS)
    ap.add_argument("--dist-scene", default=json.dumps(DIST_BA), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dist_rank:  # one rank of [dist] (b), started by phase_dist
        dist_rank_main(args.dist_rank, args.dist_device, json.loads(args.dist_scene))
        return
    if args.measure:
        WARM_RUNS = 2
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
             "apps": timed("apps", phase_apps)}
    app_runs = paths["apps"].pop("results")
    paths.update({"pano": timed("pano", phase_pano, app_runs["panorama"]),
                  "qr": timed("qr", phase_qr, app_runs["qr_demo"]),
                  "seg": timed("seg", phase_seg, app_runs["segmentation_demo"]),
                  "feat2": timed("feat2", phase_feat2, frames, K, card),
                  "stereo": timed("stereo", phase_stereo, card),
                  "flow": timed("flow", phase_flow, frames[0], card),
                  "bgfg": timed("bgfg", phase_bgfg, frames[0], card),
                  "photo": timed("photo", phase_photo, frames[0], card),
                  "imgops": timed("imgops", phase_imgops, frames[0], card),
                  "cascade": timed("cascade", phase_cascade, card),
                  "dnn": timed("dnn", phase_dnn, card),
                  "clip": timed("clip", phase_clip),
                  "ml": timed("ml", phase_ml, card),
                  "dist": timed("dist", phase_dist, card)})
    if args.measure:
        timed("profile orb", phase_profile, frames, K, "orb", 24, 2)
        timed("profile klt", phase_profile, frames, K, "klt", 24, 2)
        timed("profile geometry", phase_profile_geometry, frames, K)
        timed("profile hog", phase_profile_hog)
        timed("profile calibapp and stab", phase_profile_slice6, frames[0])
        timed("profile pano and grabcut", phase_profile_slice7)
        timed("profile sgbm and tvl1", phase_profile_slice8)
        timed("profile bgfg and nl_means", phase_profile_slice9, frames[0])
        timed("profile haar and yolo", phase_profile_slice10)
        timed("profile dist ba", phase_profile_dist)
    print(f"[time] total: {time.perf_counter() - t_start:.1f} s of phases", flush=True)
    checks = dict(paths["apps"].pop("kernel_checks"), lk_sample=paths["clip"].pop("k4_check"))
    for key, check in checks.items():
        rows[key]["shapes"] += check["shapes"]
        rows[key]["max_abs_err"] = max(rows[key]["max_abs_err"], check["max_abs_err"])
    kernels = []
    for key, row in rows.items():
        keys = row.pop("launch_keys", (key,))
        by_path = {p: sum(res["launches"][k] for k in keys) for p, res in paths.items()}
        kernels.append(dict(row, launches=sum(by_path.values()), launches_by_path=by_path,
                            launches_per_unit={p: by_path[p] / paths[p]["units"] for p in paths},
                            on_main_path=key != "lk_sample_clamp"))
    print(json.dumps({"paths": paths}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    import torch

    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
