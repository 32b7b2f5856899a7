"""The port's segmentation_demo (opencv_tpu_torch/examples/segmentation_demo.py)
against the JAX package's examples/segmentation_demo.py on the CPU.

The JAX example runs as its users run it (a subprocess, `--cpu`); the
port's `main()` is held to its figures under the bounds of the port's
chip check: watershed basin sizes equal, GrabCut IoU within 1e-3 and the
CamShift centre error within 0.05 px (the example prints 3 and 2
decimals); both verdicts OK. The scenes are numpy in both, drawn from one
generator in the example's order: the port's equal the example's.
"""

import numpy as np

from chip_smoke import JAX_FIGURES_SLICE13
from _jax_examples import parse_segmentation_demo, run_jax_example
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)
from opencv_tpu_torch.examples import segmentation_demo as seg


def test_scenes_equal_the_example():
    rng = np.random.default_rng(0)  # examples/segmentation_demo.py:28-67
    h, w = 70, 90
    img = np.zeros((h, w, 3), np.float32)
    img[..., 1] = 120
    yy, xx = np.mgrid[0:h, 0:w]
    blob = ((xx - 45) ** 2 / 400 + (yy - 35) ** 2 / 250) < 1
    img[blob] = [40, 40, 200]
    img += rng.normal(0, 6.0, img.shape).astype(np.float32)
    surface = 100 - 80 * np.exp(-((xx - 25) ** 2) / 200) - 80 * np.exp(-((xx - 65) ** 2) / 200)
    markers = np.zeros((h, w), np.int32)
    markers[30:34, 20:28] = 1
    markers[30:34, 60:68] = 2

    def frame(cx, cy):
        f = rng.uniform(20, 60, (120, 160)).astype(np.float32)
        m = (np.mgrid[0:120, 0:160][1] - cx) ** 2 + (np.mgrid[0:120, 0:160][0] - cy) ** 2 < 14 ** 2
        return np.where(m, 210.0, f).astype(np.float32)

    centers = [(40 + 9 * t, 50 + 4 * t) for t in range(7)]
    frames = [frame(cx, cy) for cx, cy in centers]

    rng2 = np.random.default_rng(0)
    got_img, got_blob = seg.grabcut_scene(rng2)
    np.testing.assert_array_equal(got_img, np.clip(img, 0, 255))
    np.testing.assert_array_equal(got_blob, blob)
    got_surface, got_markers = seg.watershed_scene()
    np.testing.assert_array_equal(got_surface, surface.astype(np.float32))
    np.testing.assert_array_equal(got_markers, markers)
    got_frames, got_centers = seg.camshift_frames(rng2)
    assert got_centers == centers
    for a, b in zip(got_frames, frames):
        np.testing.assert_array_equal(a, b)


def test_figures_match_the_jax_example(tmp_path, capsys):
    want = parse_segmentation_demo(run_jax_example("segmentation_demo", [], tmp_path, timeout=300))
    got = seg.main(["--cpu"])
    printed = parse_segmentation_demo(capsys.readouterr().out)
    assert printed["basin_sizes"] == got["basin_sizes"] == want["basin_sizes"]
    assert abs(got["grabcut_iou"] - want["grabcut_iou"]) <= 1e-3
    assert abs(got["camshift_err_px"] - want["camshift_err_px"]) <= 0.05
    assert got["camshift_frames"] == want["camshift_frames"] == 6
    assert got["ok"] and want["ok"] and printed["ok"]
    kept = dict(JAX_FIGURES_SLICE13["segmentation_demo"])  # chip_smoke's copy (tools/jax_slice13_figures.py)
    kept["basin_sizes"] = {int(k): v for k, v in kept["basin_sizes"].items()}
    assert kept == want
