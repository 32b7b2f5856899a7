"""Chessboard detection of the PyTorch port (saddle candidates, sub-pixel
refinement, the host lattice ordering) and image-in, K-out calibration
against the JAX package on the CPU, on tests/test_chessboard.py's five
rendered views.

Tolerances. The rendered views are bit-equal (the port's
warp_perspective is eager JAX's arithmetic). saddle_corners is held
against eager JAX (`jax.disable_jit`): the same blurred image and
derivatives bit for bit, and ties of the top-K in `lax.top_k`'s order,
so candidates, scores and the gate are asserted equal. corner_subpix
sums each window in another order than XLA and solves the 2x2 system by
its own LU: asserted within 1e-3 px of eager JAX (measured 0). The
detected grids are held within 1e-3 px of the JAX function as tier-1
runs it, jitted (measured 0). Calibration from the port's own
detections meets tests/test_chessboard.py's bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.ops import chessboard as jcb
from opencv_tpu_torch.core import imgproc as timg
from opencv_tpu_torch.geometry import calibration as tcal
from opencv_tpu_torch.geometry.rotation import rodrigues
from opencv_tpu_torch.ops import chessboard as tcb

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

from test_chessboard import COLS, K_GT, ROWS, SQ, SQUARE_WORLD, VIEWS, _board_image, _render_view


def _port_render(board, bw, bh, rvec, tvec):
    """tests/test_chessboard.py's renderer through the port's rodrigues and
    warp_perspective."""
    R = rodrigues(torch.from_numpy(rvec)).numpy().astype(np.float64)
    s = SQUARE_WORLD / SQ
    T = np.array([[s, 0, -(bw / 2 + SQ) * s], [0, s, -(bh / 2 + SQ) * s], [0, 0, 1]])
    hom = K_GT @ np.column_stack([R[:, 0], R[:, 1], tvec]) @ T
    return timg.warp_perspective(torch.from_numpy(board), np.linalg.inv(hom).astype(np.float32),
                                 480, 640).numpy()


@pytest.fixture(scope="module")
def views():
    board, bw, bh = _board_image()
    out = []
    for rvec, tvec in VIEWS:
        img, _, gt = _render_view(board, bw, bh, rvec, tvec)
        out.append((img, gt, _port_render(board, bw, bh, rvec, tvec)))
    return out


def test_rendered_views_equal_jax(views):
    for img, _, port_img in views:
        np.testing.assert_array_equal(port_img, img)


@pytest.mark.parametrize("view", range(len(VIEWS)))
def test_saddle_corners_equal_eager_jax(views, view):
    img = views[view][0]
    with jax.disable_jit():
        xj, sj, vj = jcb.saddle_corners(jnp.asarray(img))
    xt, st, vt = tcb.saddle_corners(torch.from_numpy(img.copy()))
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert vt.sum() >= ROWS * COLS


def test_corner_subpix_close_to_eager_jax(views, rng):
    img, gt, _ = views[0]
    start = (gt + rng.uniform(-1.5, 1.5, gt.shape)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jcb.corner_subpix(jnp.asarray(img), jnp.asarray(start)))
    got = tcb.corner_subpix(torch.from_numpy(img.copy()), torch.from_numpy(start)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert np.linalg.norm(got - gt, axis=1).mean() < 0.7


@pytest.fixture(scope="module")
def detections(views):
    return [(tcb.find_chessboard_corners(img, (COLS, ROWS), device="cpu"),
             jcb.find_chessboard_corners(img, (COLS, ROWS)), gt) for img, gt, _ in views]


def test_find_chessboard_corners_close_to_jax(detections):
    for got, want, gt in detections:
        assert got is not None and want is not None
        assert got.shape == (ROWS * COLS, 2)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
        g = got.reshape(ROWS, COLS, 2)
        flips = [g, g[::-1], g[:, ::-1], g[::-1, ::-1]]
        assert min(np.linalg.norm(f.reshape(-1, 2) - gt, axis=1).mean() for f in flips) < 0.7


def test_find_chessboard_corners_reports_no_board(rng):
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    assert tcb.find_chessboard_corners(img, (COLS, ROWS), device="cpu") is None


def test_calibration_from_images(detections):
    """Image in, K out: the port's grids through the port's calibrate_camera,
    within tests/test_chessboard.py's bounds."""
    obj = np.zeros((ROWS * COLS, 3), np.float32)
    jj, ii = np.meshgrid(np.arange(COLS), np.arange(ROWS))
    obj[:, 0] = jj.reshape(-1) * SQUARE_WORLD
    obj[:, 1] = ii.reshape(-1) * SQUARE_WORLD
    img_pts = np.stack([got for got, _, _ in detections])
    res = tcal.calibrate_camera(np.stack([obj] * len(detections)), img_pts, device="cpu")
    assert res.rms < 0.6
    assert abs(res.K[0, 0] - K_GT[0, 0]) < 0.02 * K_GT[0, 0]
    assert abs(res.K[1, 1] - K_GT[1, 1]) < 0.02 * K_GT[1, 1]
    assert abs(res.K[0, 2] - K_GT[0, 2]) < 8.0
    assert abs(res.K[1, 2] - K_GT[1, 2]) < 8.0
