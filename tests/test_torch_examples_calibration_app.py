"""The port's calibration_app (opencv_tpu_torch/examples/calibration_app.py)
against the JAX package's examples/calibration_app.py on the CPU.

The JAX example runs as its users run it (a subprocess, `--cpu`, 5 views
with `--views 5`); the port's `main()` is held to its figures under the
bounds of the port's chip check: both RMS within 1e-3 px and fx, fy, cx,
cy within 0.1 px (the example prints 3 and 1 decimals), the same views
found and dropped, both verdicts OK.

The views: the port's warp equals the JAX package's given the same
homography, and the view is held to the example's within 0.05 grey. One
view of eight (view 2) differs, by 0.022 grey on 611 pixels (measured):
its rotation, the f32 Rodrigues of the pose, rounds one entry one ulp
otherwise in the two packages.
"""

import jax.numpy as jnp
import numpy as np
import torch

from opencv_tpu.core import imgproc as jimg
from opencv_tpu.geometry.rotation import rodrigues as jrod
from _jax_examples import parse_calibration_app, run_jax_example
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)
from opencv_tpu_torch.core import imgproc as timg
from opencv_tpu_torch.examples import calibration_app as app

ARGS = ["--views", "5"]


def test_views_equal_the_example():
    rng = np.random.default_rng(0)  # examples/calibration_app.py:53-79
    board, bw, bh = app.board_image()
    got = app.views(8, 0.0, "cpu")
    for v in range(8):
        rvec = rng.uniform(-0.35, 0.35, 3).astype(np.float32)
        tvec = np.array([rng.uniform(-0.2, 0.2), rng.uniform(-0.15, 0.15), rng.uniform(2.1, 2.9)])
        R = np.asarray(jrod(jnp.asarray(rvec, jnp.float32)), np.float64)
        s = app.SQUARE_WORLD / app.SQ
        T = np.array([[s, 0, -(bw / 2 + app.SQ) * s], [0, s, -(bh / 2 + app.SQ) * s], [0, 0, 1]])
        hom_inv = np.linalg.inv(app.K_GT @ np.column_stack([R[:, 0], R[:, 1], tvec]) @ T).astype(np.float32)
        want = np.asarray(jimg.warp_perspective(jnp.asarray(board), jnp.asarray(hom_inv), app.H, app.W))
        same_h = timg.warp_perspective(torch.from_numpy(board), hom_inv, app.H, app.W).numpy()
        np.testing.assert_array_equal(same_h, want)
        np.testing.assert_allclose(got[v].numpy(), np.clip(want, 0, 255), rtol=0, atol=0.05)


def test_noise_is_drawn_after_each_pose():
    """`--noise 3`: view 0 (its pose drawn first) carries N(0, 3) noise
    where the clip does not cut it."""
    a, b = app.views(1, 3.0, "cpu")[0].numpy(), app.views(1, 0.0, "cpu")[0].numpy()
    assert 2.9 < (a - b)[(b > 20) & (b < 235)].std() < 3.1


def test_figures_match_the_jax_example(tmp_path, capsys):
    want = parse_calibration_app(run_jax_example("calibration_app", ARGS, tmp_path, timeout=300))
    got = app.main(ARGS + ["--cpu"])
    printed = parse_calibration_app(capsys.readouterr().out)
    assert printed["found"] == got["found"] == want["found"]
    assert printed["dropped"] == got["dropped"] == want["dropped"]
    assert abs(got["first"]["rms"] - want["first"]["rms"]) <= 1e-3
    assert abs(got["after_drop"]["rms"] - want["after_drop"]["rms"]) <= 1e-3
    for k in ("fx", "fy", "cx", "cy"):
        assert abs(got["first"][k] - want["first"][k]) <= 0.1, (k, got["first"], want["first"])
    assert got["ok"] and want["ok"] and printed["ok"]
