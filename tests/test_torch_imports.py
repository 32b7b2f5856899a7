"""The PyTorch port stands alone: no module of `opencv_tpu_torch/` and not
`chip_smoke.py` imports jax or the JAX package, importing the port does
no device work, and `chip_smoke.py` fails without a card or without the
repository around it."""

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
    calibration-app and video-stabilization slice's and the panorama, QR
    and segmentation slice's modules are among them."""
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
                "ops/camshift.py"):
        assert f"opencv_tpu_torch/{mod}" in names


NUMPY_ENTRY_POINTS = ("calibrate_camera", "stereo_calibrate", "calibrate_fisheye",
                      "init_undistort_rectify_map", "build_lsh_index", "verify_candidate", "solve_lp",
                      "Tracker", "DetectionBasedTracker", "detect_multi_scale",
                      "connected_components", "detect_blobs", "find_chessboard_corners",
                      "find_circles_grid", "find_transform_ecc", "estimate_global_motion", "estimate_motions",
                      "stabilize", "deblur_weiner_gaussian", "suppress_wobble",
                      "estimate_panorama", "refine_rotations_ba", "stitch_panorama", "stitch_pair", "detect_qr", "decode_qr",
                      "grab_cut", "watershed", "track_window_sequence")


def _numpy_entry_points():
    """{name: call} of every entry point that takes numpy and makes
    tensors, each called with no device."""
    from opencv_tpu_torch.geometry import calibration
    from opencv_tpu_torch.ops import (camshift, ccomp, chessboard, ecc, grabcut, hog, lsh, qrcode,
                                      videostab, watershed)
    from opencv_tpu_torch.optim import minimize
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
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


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
