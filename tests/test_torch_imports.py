"""The PyTorch port stands alone: no module of `opencv_tpu_torch/` and not
`chip_smoke.py` imports jax or the JAX package, importing the port does
no device work, its applications parse no argument when imported and
refuse to run without a card unless asked for the CPU, and
`chip_smoke.py` fails without a card or without the repository around
it."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "opencv_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "opencv_tpu")
APPS = ("tbd_app", "lane_detection", "vo_synthetic", "calibration_app", "segmentation_demo",
        "qr_demo", "panorama")  # the JAX package's examples/, ported


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_every_slice_module_is_checked():
    """The import checks below walk the whole package; the LK slice's,
    the geometry slice's, the tracking-and-lanes slice's, the
    calibration-app and video-stabilization slice's, the panorama, QR
    and segmentation slice's, the detectors, stereo and dense-flow
    slice's, the image-processing group's, the detection-and-inference
    slice's, the io, ml and utils slice's, the parallel slice's modules and
    the applications are among them."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for mod in ("ops/lk.py", "ops/gftt.py", "ops/cuda/lk_sample.py", "core/pyramid.py",
                "slam/vo.py", "geometry/five_point.py", "geometry/epnp.py", "geometry/ap3p.py",
                "geometry/ippe.py", "geometry/affine2d.py", "geometry/calibration.py",
                "optim/levmarq.py", "optim/minimize.py", "ops/lsh.py", "ops/kalman.py",
                "tbd/assignment.py", "tbd/tracker.py", "tbd/detection_based.py", "ops/hog.py",
                "ops/edges.py", "ops/hough.py", "core/imgproc.py", "ops/ccomp.py",
                "ops/chessboard.py", "ops/ecc.py", "ops/videostab.py", "ops/morphology.py",
                "stitching/__init__.py", "stitching/warpers.py", "stitching/blend.py",
                "stitching/exposure.py", "stitching/stitcher.py", "stitching/global_stitch.py",
                "ops/qrcode.py", "ops/graphcut.py", "ops/grabcut.py", "ops/watershed.py",
                "ops/camshift.py", "ops/agast.py", "ops/brisk.py", "ops/akaze.py", "ops/mser.py",
                "ops/stereo.py", "ops/sgbm.py", "ops/stereo_bp.py", "ops/farneback.py",
                "ops/tvl1.py", "ops/brox.py", "ops/interpolate.py", "ops/superres.py",
                "ops/histogram.py", "ops/color.py", "ops/colormap.py", "ops/template.py",
                "ops/phasecorr.py", "ops/distance.py", "ops/contours.py", "ops/shape.py",
                "ops/lsd.py", "ops/bgsegm.py", "ops/photo.py", "ops/cascade.py",
                "ml/__init__.py", "ml/traincascade.py", "dnn/__init__.py", "dnn/proto.py",
                "dnn/layers.py", "dnn/net.py", "dnn/onnx_importer.py", "dnn/darknet_importer.py",
                "dnn/caffe_importer.py", "dnn/tf_importer.py", "io/__init__.py", "io/_jpeg.py",
                "io/image.py", "io/video.py", "io/kitti.py", "ml/classifiers.py", "ml/clustering.py",
                "ml/trees.py", "utils/__init__.py", "utils/guard.py", "utils/logger.py",
                "utils/persistence.py", "utils/profiler.py", "utils/synth.py", "utils/viz.py",
                "parallel/__init__.py", "parallel/mesh.py", "parallel/multihost.py",
                "parallel/dist_ba.py", "parallel/dist_match.py", "parallel/dryrun.py",
                "examples/__init__.py", *(f"examples/{app}.py" for app in APPS)):
        assert f"opencv_tpu_torch/{mod}" in names


NUMPY_ENTRY_POINTS = ("calibrate_camera", "stereo_calibrate", "calibrate_fisheye",
                      "init_undistort_rectify_map", "build_lsh_index", "verify_candidate", "solve_lp",
                      "Tracker", "DetectionBasedTracker", "detect_multi_scale",
                      "connected_components", "detect_blobs", "find_chessboard_corners",
                      "find_circles_grid", "find_transform_ecc", "estimate_global_motion", "estimate_motions",
                      "stabilize", "deblur_weiner_gaussian", "suppress_wobble",
                      "estimate_panorama", "refine_rotations_ba", "stitch_panorama", "stitch_pair", "detect_qr", "decode_qr",
                      "grab_cut", "watershed", "track_window_sequence",
                      "agast_detect", "brisk_detect_and_compute", "akaze_detect_and_compute",
                      "mser_detect", "compute_disparity_bm", "compute_disparity_sgbm", "stereo_bp",
                      "stereo_csbp", "calc_optical_flow_farneback", "calc_optical_flow_tvl1",
                      "brox_flow", "interpolate_frames", "btv_l1_superres", "btv_l1_superres_flow",
                      "calc_hist", "equalize_hist", "clahe", "rgb_to_gray", "rgb_to_hsv",
                      "hsv_to_rgb", "rgb_to_ycrcb", "rgb_to_lab", "demosaic_bilinear",
                      "apply_color_map", "get_gabor_kernel", "match_template",
                      "create_hanning_window", "phase_correlate", "distance_transform",
                      "flood_fill", "mean_shift_segmentation", "contour_moments", "image_moments",
                      "contour_area", "arc_length", "bounding_rect", "is_contour_convex",
                      "fit_ellipse", "fit_line", "match_shapes", "point_polygon_test",
                      "hausdorff_distance", "shape_context_distance", "fit_tps", "emd_l1",
                      "detect_lines", "mog2_init_state", "knn_init", "gmg_init", "fgd_init",
                      "background_state", "nl_means_denoise", "inpaint_diffusion", "merge_mertens",
                      "seamless_clone", "calibrate_debevec", "calibrate_robertson", "merge_debevec",
                      "tonemap_reinhard", "align_mtb", "denoise_tvl1", "inpaint_telea", "decolor",
                      "edge_preserving_filter", "detail_enhance", "stylization", "pencil_sketch",
                      "cascade_score_map", "cascade_detect_multi_scale", "lbp_score_map",
                      "detect_multi_scale_lbp", "train_cascade", "train_cascade_lbp", "Net",
                      "load_onnx", "load_darknet", "load_caffe", "load_tf", "prior_box",
                      "camera_matrix", "ml_model", "ba_problem", "initialize", "make_mesh",
                      "make_host_mesh", "simulate_host_mesh", "global_sharded", "replicated",
                      "dryrun_multichip")


def _numpy_entry_points():
    """{name: call} of every entry point that takes numpy and makes
    tensors, each called with no device."""
    from opencv_tpu_torch import convert
    from opencv_tpu_torch.core import types
    from opencv_tpu_torch.geometry import calibration
    from opencv_tpu_torch.ml import classifiers
    from opencv_tpu_torch import dnn
    from opencv_tpu_torch.ml import traincascade
    from opencv_tpu_torch.ops import (agast, akaze, bgsegm, brisk, brox, camshift, cascade, ccomp, chessboard,
                                      color, colormap, contours, distance, ecc, farneback, grabcut,
                                      histogram, hog, interpolate, lsd, lsh, mser, phasecorr, photo,
                                      qrcode, sgbm, shape, stereo, stereo_bp, superres, template, tvl1,
                                      videostab, watershed)
    from opencv_tpu_torch.optim import minimize
    from opencv_tpu_torch.parallel import dryrun, mesh, multihost
    from opencv_tpu_torch.slam import loop_closure
    from opencv_tpu_torch.stitching import global_stitch, stitcher
    from opencv_tpu_torch.tbd import DetectionBasedTracker, Tracker

    obj = np.zeros((2, 6, 3), np.float32)
    obj[:, :, 0] = np.arange(6) % 3
    obj[:, :, 1] = np.arange(6) // 3
    img = obj[..., :2] * 50.0 + 100.0
    K = np.eye(3, dtype=np.float32)
    dist = np.zeros(5, np.float32)
    desc = np.zeros((4, 8), np.uint32)
    xy = np.zeros((4, 2), np.float32)
    ok = np.ones(4, bool)
    frame = np.zeros((32, 32), np.float32)
    rgb = np.zeros((8, 8, 3), np.float32)
    small = np.zeros((8, 8), np.float32)
    poly = np.array([[0, 0], [4, 0], [4, 3], [1, 4], [0, 2]], np.float32)
    hu = np.full(7, 0.1, np.float32)
    stack = np.zeros((2, 8, 8), np.float32)
    times = np.array([0.5, 1.0], np.float32)
    haar = cascade.CascadeModel((4, 4), np.zeros((1, 3, 5), np.float32), np.zeros(1, np.int32),
                                np.zeros(1, np.float32), np.zeros(1, np.float32), np.ones(1, np.float32),
                                np.array([0, 1], np.int32), np.zeros(1, np.float32))
    lbp = cascade.LBPCascadeModel((3, 3), np.array([[0, 0, 1, 1]], np.int32), np.zeros(1, np.int32),
                                  np.zeros((1, 8), np.uint32), np.zeros(1, np.float32),
                                  np.ones(1, np.float32), np.array([0, 1], np.int32),
                                  np.zeros(1, np.float32))
    crops = np.zeros((4, 8, 8), np.float32)
    onnx = dnn.proto.field_bytes(7, b"")
    return {
        "calibrate_camera": lambda: calibration.calibrate_camera(obj, img, refine_iters=1),
        "stereo_calibrate": lambda: calibration.stereo_calibrate(obj, img, img, K, dist, K, dist),
        "calibrate_fisheye": lambda: calibration.calibrate_fisheye(obj, img, refine_iters=1),
        "init_undistort_rectify_map": lambda: calibration.init_undistort_rectify_map(
            K, dist, None, K, (4, 4)),
        "build_lsh_index": lambda: lsh.build_lsh_index(desc, key_bits=4),
        "verify_candidate": lambda: loop_closure.verify_candidate(
            None, xy, desc, ok, np.zeros((4, 3), np.float32), desc, ok),
        "solve_lp": lambda: minimize.solve_lp([1.0], [[1.0]], [1.0]),
        "Tracker": lambda: Tracker().step(np.zeros((1, 4), np.float32)),
        "DetectionBasedTracker": lambda: DetectionBasedTracker(
            lambda img: np.zeros((0, 4), np.float32)).process_frame(np.zeros((16, 16), np.float32)),
        "detect_multi_scale": lambda: hog.detect_multi_scale(
            np.zeros((128, 64), np.float32), np.zeros(3780, np.float32), 0.0),
        "connected_components": lambda: ccomp.connected_components(np.ones((4, 4), bool)),
        "detect_blobs": lambda: ccomp.detect_blobs(np.zeros((8, 8), np.float32)),
        "find_chessboard_corners": lambda: chessboard.find_chessboard_corners(
            np.zeros((32, 32), np.float32), (3, 3)),
        "find_circles_grid": lambda: chessboard.find_circles_grid(np.zeros((32, 32), np.float32),
                                                                   (3, 3)),
        "find_transform_ecc": lambda: ecc.find_transform_ecc(np.zeros((16, 16), np.float32),
                                                             np.zeros((16, 16), np.float32)),
        "estimate_global_motion": lambda: videostab.estimate_global_motion(
            np.zeros((32, 32), np.float32), np.zeros((32, 32), np.float32)),
        "estimate_motions": lambda: videostab.estimate_motions([np.zeros((32, 32), np.float32)] * 2),
        "stabilize": lambda: videostab.stabilize([np.zeros((32, 32), np.float32)] * 2),
        "deblur_weiner_gaussian": lambda: videostab.deblur_weiner_gaussian(
            np.zeros((16, 16), np.float32), 3.0),
        "suppress_wobble": lambda: videostab.suppress_wobble(np.zeros((8, 2, 3), np.float32)),
        "estimate_panorama": lambda: global_stitch.estimate_panorama([np.zeros((16, 16), np.float32)] * 2),
        "refine_rotations_ba": lambda: global_stitch.refine_rotations_ba(
            np.stack([np.eye(3)] * 2), 100.0, [(0, 1, xy, xy, np.ones(4, np.float32))], iters=1),
        "stitch_panorama": lambda: global_stitch.stitch_panorama([np.zeros((16, 16), np.float32)] * 2),
        "stitch_pair": lambda: stitcher.stitch_pair(np.zeros((16, 16), np.float32),
                                                    np.zeros((16, 16), np.float32)),
        "detect_qr": lambda: qrcode.detect_qr(np.zeros((32, 32), np.float32)),
        "decode_qr": lambda: qrcode.decode_qr(np.zeros((32, 32), np.float32),
                                              np.zeros((4, 2), np.float32)),
        "grab_cut": lambda: grabcut.grab_cut(np.zeros((8, 8, 3), np.float32), rect=(1, 1, 4, 4)),
        "watershed": lambda: watershed.watershed(np.zeros((8, 8), np.float32),
                                                 np.zeros((8, 8), np.int32)),
        "track_window_sequence": lambda: camshift.track_window_sequence(
            [[np.zeros((8, 8), np.float32)]], np.ones(4, np.float32), [(0, 256)], (0, 0, 4, 4)),
        "agast_detect": lambda: agast.agast_detect(frame, 4),
        "brisk_detect_and_compute": lambda: brisk.brisk_detect_and_compute(frame, 8),
        "akaze_detect_and_compute": lambda: akaze.akaze_detect_and_compute(frame, 8),
        "mser_detect": lambda: mser.mser_detect(frame),
        "compute_disparity_bm": lambda: stereo.compute_disparity_bm(frame, frame, 8),
        "compute_disparity_sgbm": lambda: sgbm.compute_disparity_sgbm(frame, frame),
        "stereo_bp": lambda: stereo_bp.stereo_bp(frame, frame, 8),
        "stereo_csbp": lambda: stereo_bp.stereo_csbp(frame, frame, 8),
        "calc_optical_flow_farneback": lambda: farneback.calc_optical_flow_farneback(frame, frame),
        "calc_optical_flow_tvl1": lambda: tvl1.calc_optical_flow_tvl1(frame, frame),
        "brox_flow": lambda: brox.brox_flow(frame, frame),
        "interpolate_frames": lambda: interpolate.interpolate_frames(frame, frame),
        "btv_l1_superres": lambda: superres.btv_l1_superres(frame[None], np.zeros((1, 2))),
        "btv_l1_superres_flow": lambda: superres.btv_l1_superres_flow(
            frame[None], np.zeros((1, 32, 32, 2)), np.zeros((1, 32, 32, 2))),
        "calc_hist": lambda: histogram.calc_hist(small),
        "equalize_hist": lambda: histogram.equalize_hist(small),
        "clahe": lambda: histogram.clahe(small, tile_grid=(2, 2)),
        "rgb_to_gray": lambda: color.rgb_to_gray(rgb),
        "rgb_to_hsv": lambda: color.rgb_to_hsv(rgb),
        "hsv_to_rgb": lambda: color.hsv_to_rgb(rgb),
        "rgb_to_ycrcb": lambda: color.rgb_to_ycrcb(rgb),
        "rgb_to_lab": lambda: color.rgb_to_lab(rgb),
        "demosaic_bilinear": lambda: color.demosaic_bilinear(small),
        "apply_color_map": lambda: colormap.apply_color_map(small, "jet"),
        "get_gabor_kernel": lambda: colormap.get_gabor_kernel((5, 5), 1.0, 0.0, 4.0, 0.5),
        "match_template": lambda: template.match_template(small, small[:3, :3]),
        "create_hanning_window": lambda: phasecorr.create_hanning_window(8, 8),
        "phase_correlate": lambda: phasecorr.phase_correlate(small, small),
        "distance_transform": lambda: distance.distance_transform(small > 0),
        "flood_fill": lambda: distance.flood_fill(small, (1, 1), 9.0),
        "mean_shift_segmentation": lambda: distance.mean_shift_segmentation(small, 1, iters=1),
        "contour_moments": lambda: contours.contour_moments(poly),
        "image_moments": lambda: contours.image_moments(small),
        "contour_area": lambda: contours.contour_area(poly),
        "arc_length": lambda: contours.arc_length(poly),
        "bounding_rect": lambda: contours.bounding_rect(poly),
        "is_contour_convex": lambda: contours.is_contour_convex(poly),
        "fit_ellipse": lambda: contours.fit_ellipse(poly),
        "fit_line": lambda: contours.fit_line(poly),
        "match_shapes": lambda: contours.match_shapes(hu, hu),
        "point_polygon_test": lambda: contours.point_polygon_test(poly, poly),
        "hausdorff_distance": lambda: shape.hausdorff_distance(poly, poly),
        "shape_context_distance": lambda: shape.shape_context_distance(poly, poly),
        "fit_tps": lambda: shape.fit_tps(poly, poly),
        "emd_l1": lambda: shape.emd_l1(hu, hu),
        "detect_lines": lambda: lsd.detect_lines(frame),
        "mog2_init_state": lambda: bgsegm.init_state(small),
        "knn_init": lambda: bgsegm.knn_init(small),
        "gmg_init": lambda: bgsegm.gmg_init(8, 8),
        "fgd_init": lambda: bgsegm.fgd_init(small),
        "background_state": lambda: convert.background_state(bgsegm.GMGState(stack, 0)),
        "nl_means_denoise": lambda: photo.nl_means_denoise(small, search_size=3),
        "inpaint_diffusion": lambda: photo.inpaint_diffusion(small, small > 0, 1),
        "merge_mertens": lambda: photo.merge_mertens(stack),
        "seamless_clone": lambda: photo.seamless_clone(small, small, small > 0, 1),
        "calibrate_debevec": lambda: photo.calibrate_debevec(stack, times, n_samples=4),
        "calibrate_robertson": lambda: photo.calibrate_robertson(stack, times, 1),
        "merge_debevec": lambda: photo.merge_debevec(stack, times, np.zeros(256, np.float32)),
        "tonemap_reinhard": lambda: photo.tonemap_reinhard(small),
        "align_mtb": lambda: photo.align_mtb(stack, 2),
        "denoise_tvl1": lambda: photo.denoise_tvl1(small, n_iters=1),
        "inpaint_telea": lambda: photo.inpaint_telea(small, small > 0),
        "decolor": lambda: photo.decolor(rgb, 4),
        "edge_preserving_filter": lambda: photo.edge_preserving_filter(rgb, n_iters=1),
        "detail_enhance": lambda: photo.detail_enhance(rgb),
        "stylization": lambda: photo.stylization(rgb),
        "pencil_sketch": lambda: photo.pencil_sketch(rgb),
        "cascade_score_map": lambda: cascade.cascade_score_map(small, haar),
        "cascade_detect_multi_scale": lambda: cascade.detect_multi_scale(small, haar),
        "lbp_score_map": lambda: cascade.lbp_score_map(small, lbp),
        "detect_multi_scale_lbp": lambda: cascade.detect_multi_scale_lbp(small, lbp),
        "train_cascade": lambda: traincascade.train_cascade(crops, [small], window=(8, 8)),
        "train_cascade_lbp": lambda: traincascade.train_cascade_lbp(crops, [small], window=(8, 8)),
        "Net": lambda: dnn.Net(),
        "load_onnx": lambda: dnn.load_onnx(onnx),
        "load_darknet": lambda: dnn.load_darknet("[net]\n"),
        "load_caffe": lambda: dnn.load_caffe(""),
        "load_tf": lambda: dnn.load_tf(b""),
        "prior_box": lambda: dnn.layers.prior_box(2, 2, 8, 8, 4.0),
        "camera_matrix": lambda: types.camera_matrix(1.0, 1.0, 0.0, 0.0),
        "ml_model": lambda: convert.ml_model(classifiers.LinearModel(np.ones(2, np.float32),
                                                                     np.float32(0))),
        "ba_problem": lambda: convert.ba_problem(dict(
            cam_rvec=np.zeros((2, 3), np.float32), cam_tvec=np.zeros((2, 3), np.float32),
            points=np.zeros((1, 3), np.float32), obs_cam=np.zeros(2, np.int32),
            obs_pt=np.zeros(2, np.int32), obs_uv=np.zeros((2, 2), np.float32),
            obs_valid=np.ones(2, bool), fixed_cams=np.ones(2, bool))),
        "initialize": lambda: multihost.initialize("localhost:1", 2, 0),
        "make_mesh": lambda: mesh.make_mesh(1),
        "make_host_mesh": lambda: multihost.make_host_mesh(),
        "simulate_host_mesh": lambda: multihost.simulate_host_mesh(1),
        "global_sharded": lambda: multihost.global_sharded(None, mesh.DATA_AXIS, np.zeros(4)),
        "replicated": lambda: multihost.replicated(None, np.zeros(4)),
        "dryrun_multichip": lambda: dryrun.dryrun_multichip(1),
    }


@pytest.mark.parametrize("name", NUMPY_ENTRY_POINTS)
def test_numpy_entry_point_raises_without_a_card(monkeypatch, name):
    """No device given and no card: the entry point refuses instead of
    falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _numpy_entry_points()[name]()


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT_FILES[:-1]
        if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from opencv_tpu_torch.ops.cuda import _build\n"
        "bad = [m for m in set(sys.modules) - before\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'opencv_tpu')]\n"
        "assert not bad, bad\n"
        "assert not _build._libs\n"
        "import torch, torch.distributed as dist\n"
        "assert not dist.is_initialized() and not torch.cuda.is_initialized()\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_importing_the_apps_parses_no_argument_and_touches_no_device():
    """An argument that every app's parser refuses is on the command line
    while the apps are imported: none reads it, none touches a device."""
    code = (
        "import importlib, sys\n"
        "sys.argv = [sys.argv[0], '--no-such-flag']\n"
        f"for app in {APPS!r}: importlib.import_module('opencv_tpu_torch.examples.' + app)\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("app", APPS)
def test_app_raises_without_a_card(monkeypatch, app):
    """Without `--cpu` an app runs on the card, and without one it raises
    before any work: no fallback to the CPU."""
    import importlib

    mod = importlib.import_module(f"opencv_tpu_torch.examples.{app}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_chip_smoke_fails_without_card_or_repository(tmp_path):
    """Here there is no card; alone in a directory it has no port either.
    Both runs must exit non-zero and print no result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd in (REPO, tmp_path):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
