"""Camera, fisheye and stereo calibration, undistortion maps, remap,
projection-matrix decomposition, stereo rectification and the generic
Levenberg-Marquardt solver of the PyTorch port against the JAX package
on the CPU.

Both packages run the same closed-form initialization and the same LM
schedule in f32, in another operation order, so the refined parameters
agree to the LM's f32 rounding: K to 0.05 px, pinhole distortion to
1e-4, RMS to 1e-3 px. The fisheye's k1..k4 trade off against each other
(a flat valley of the cost), so the fisheye lens is held by its
distortion function over the image, not coefficient by coefficient. The
bilinear remap is the same f32 arithmetic op for op: bit-equal to eager
JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from opencv_tpu.core import imgproc as jimg
from opencv_tpu.geometry import calibration as jcal
from opencv_tpu.geometry import decompose as jdec
from opencv_tpu.geometry import rotation as jrot
from opencv_tpu.optim import levmarq as jlm
from opencv_tpu_torch.core import imgproc as timg
from opencv_tpu_torch.geometry import calibration as tcal
from opencv_tpu_torch.geometry import decompose as tdec
from opencv_tpu_torch.optim import levmarq as tlm

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)
from test_calibration import DIST_TRUE, K_TRUE, board_points, make_views

K4 = np.array([K_TRUE[0, 0], K_TRUE[1, 1], K_TRUE[0, 2], K_TRUE[1, 2]], np.float32)
FISHEYE_K = np.array([0.1, -0.05, 0.01, 0.0], np.float32)
R_STEREO = np.array([0.0, np.deg2rad(1.0), 0.0], np.float32)
T_STEREO = np.array([-0.12, 0.0, 0.0], np.float32)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def J(x):
    return jnp.asarray(np.asarray(x))


def test_projection_models_equal_jax(rng):
    obj = board_points()
    rv = np.float32([0.2, -0.1, 0.05])
    tv = np.float32([-0.05, -0.03, 0.5])
    np.testing.assert_allclose(
        tcal.project_points_full(T(rv), T(tv), T(K4), T(DIST_TRUE), T(obj)).numpy(),
        np.asarray(jcal.project_points_full(J(rv), J(tv), J(K4), J(DIST_TRUE), J(obj))), atol=1e-4)
    np.testing.assert_allclose(
        tcal.fisheye_project_points(T(rv), T(tv), T(K4), T(FISHEYE_K), T(obj)).numpy(),
        np.asarray(jcal.fisheye_project_points(J(rv), J(tv), J(K4), J(FISHEYE_K), J(obj))), atol=1e-4)
    px = rng.uniform(0, 640, (60, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tcal.undistort_points(T(px), T(K_TRUE), T(DIST_TRUE)).numpy(),
        np.asarray(jcal.undistort_points(J(px), J(K_TRUE), J(DIST_TRUE))), atol=1e-6)
    xy = rng.uniform(-0.6, 0.6, (60, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tcal.fisheye_undistort(tcal.fisheye_distort(T(xy), T(FISHEYE_K)), T(FISHEYE_K)).numpy(),
        np.asarray(jcal.fisheye_undistort(jcal.fisheye_distort(J(xy), J(FISHEYE_K)), J(FISHEYE_K))),
        atol=1e-6)


def test_calibrate_camera_equals_jax(rng):
    objs, imgs = make_views(rng, n_views=5, noise=0.1)  # 5 views x 35 corners
    a = jcal.calibrate_camera(objs, imgs)
    b = tcal.calibrate_camera(objs, imgs, device="cpu")
    np.testing.assert_allclose(b.K, a.K, atol=0.05)
    np.testing.assert_allclose(b.dist, a.dist, atol=1e-4)
    assert abs(b.rms - a.rms) < 1e-3
    np.testing.assert_allclose(b.rvecs, a.rvecs, atol=1e-4)
    np.testing.assert_allclose(b.tvecs, a.tvecs, atol=1e-4)
    assert b.rms < 0.3 and abs(b.K[0, 0] - K_TRUE[0, 0]) / K_TRUE[0, 0] < 0.01


def test_calibrate_fisheye_equals_jax(rng):
    objs, _ = make_views(rng, n_views=5, noise=0.0)
    imgs = []
    for _ in range(5):
        rv = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
        tv = np.float32([rng.uniform(-0.08, 0.0), rng.uniform(-0.06, 0.0), rng.uniform(0.4, 0.6)])
        uv = np.asarray(jcal.fisheye_project_points(J(rv), J(tv), J(K4), J(FISHEYE_K), J(objs[0])))
        imgs.append(uv + rng.normal(0, 0.1, uv.shape))
    imgs = np.stack(imgs).astype(np.float32)
    a = jcal.calibrate_fisheye(objs, imgs)
    b = tcal.calibrate_fisheye(objs, imgs, device="cpu")
    np.testing.assert_allclose(b.K, a.K, atol=0.05)
    assert abs(b.rms - a.rms) < 1e-3
    xy = np.stack(np.meshgrid(np.linspace(-0.5, 0.5, 9), np.linspace(-0.4, 0.4, 7)), -1)
    xy = xy.reshape(-1, 2).astype(np.float32)
    dj = np.asarray(jcal.fisheye_distort(J(xy), J(a.dist)))
    dt = tcal.fisheye_distort(T(xy), T(b.dist)).numpy()
    assert np.abs(dj - dt).max() * K_TRUE[0, 0] < 0.05  # px over the image


def _stereo_views(rng):
    objs, imgs1 = make_views(rng, n_views=5, noise=0.1)
    R12 = np.asarray(jrot.rodrigues(J(R_STEREO)))
    res1 = jcal.calibrate_camera(objs, imgs1)
    imgs2 = []
    for v in range(5):
        R2 = R12 @ np.asarray(jrot.rodrigues(J(res1.rvecs[v])))
        t2 = R12 @ res1.tvecs[v] + T_STEREO
        uv = np.asarray(jcal.project_points_full(jrot.rodrigues_inv(J(R2)), J(t2), J(K4),
                                                 J(DIST_TRUE), J(objs[v])))
        imgs2.append(uv + rng.normal(0, 0.1, uv.shape))
    return objs, imgs1, np.stack(imgs2).astype(np.float32)


def test_stereo_calibrate_and_rectify_equal_jax(rng):
    objs, imgs1, imgs2 = _stereo_views(rng)
    a = jcal.stereo_calibrate(objs, imgs1, imgs2, K_TRUE, DIST_TRUE, K_TRUE, DIST_TRUE)
    b = tcal.stereo_calibrate(objs, imgs1, imgs2, K_TRUE, DIST_TRUE, K_TRUE, DIST_TRUE, device="cpu")
    np.testing.assert_allclose(b.R, a.R, atol=1e-5)
    np.testing.assert_allclose(b.T, a.T, atol=1e-5)
    np.testing.assert_allclose(b.E, a.E, atol=1e-5)
    np.testing.assert_allclose(b.F, a.F, rtol=1e-3, atol=1e-8)
    assert abs(b.rms - a.rms) < 1e-3
    assert abs(np.linalg.norm(b.T) - 0.12) < 0.012
    ra = jdec.stereo_rectify(J(K_TRUE), J(K_TRUE), J(a.R), J(a.T), (480, 640))
    rb = tdec.stereo_rectify(T(K_TRUE), T(K_TRUE), T(a.R), T(a.T), (480, 640))
    for x, y in zip(ra, rb):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5, atol=1e-6)


def test_decompose_projection_matrix_equals_jax(rng):
    R = np.asarray(jrot.rodrigues(J(np.float32([0.1, -0.3, 0.2]))))
    P = (K_TRUE @ np.concatenate([R, np.float32([[0.2], [-0.1], [1.5]])], 1)).astype(np.float32)
    for Pm in (P, rng.normal(size=(3, 4)).astype(np.float32)):
        for x, y in zip(jdec.decompose_projection_matrix(J(Pm)), tdec.decompose_projection_matrix(T(Pm))):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5, atol=1e-5)
    K, Rd, C = tdec.decompose_projection_matrix(T(P))
    np.testing.assert_allclose(K.numpy(), K_TRUE, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(Rd.numpy(), R, atol=1e-5)


def test_undistort_rectify_map_and_remap_equal_jax(rng):
    R = np.asarray(jrot.rodrigues(J(R_STEREO)))
    newK = (K_TRUE * np.float32([[0.1], [0.1], [1.0]])).astype(np.float32)  # a 48x64 camera
    for Rm in (None, R):
        mj = np.asarray(jcal.init_undistort_rectify_map(newK, DIST_TRUE, Rm, newK, (48, 64)))
        mt = tcal.init_undistort_rectify_map(newK, DIST_TRUE, Rm, newK, (48, 64), device="cpu")
        assert mt.shape == (48, 64, 2)
        np.testing.assert_allclose(mt.numpy(), mj, atol=1e-3)
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    # bit-equal on the same map, including points outside (edge clamp)
    xy = rng.uniform(-6.0, 70.0, (48, 64, 2)).astype(np.float32)
    xy[0, :4] = [[0.0, 0.0], [63.0, 47.0], [63.5, 47.9], [np.float32(62.99999), 0.5]]
    np.testing.assert_array_equal(timg.remap(T(img), T(xy)).numpy(),
                                  np.asarray(jimg.remap(J(img), J(xy))))
    np.testing.assert_array_equal(timg.bilinear_sample(T(img), T(xy[:5, 0])).numpy(),
                                  np.asarray(jimg.bilinear_sample(J(img), J(xy[:5, 0]))))
    np.testing.assert_allclose(
        tcal.undistort_image(T(img), newK, DIST_TRUE).numpy(),
        np.asarray(jcal.undistort_image(J(img), J(newK), J(DIST_TRUE))), atol=1e-2)


def test_levmarq_equals_jax(rng):
    rj = jlm.levmarq(lambda x: jnp.array([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]]),
                     jnp.array([-1.2, 1.0]), iters=60)
    rt = tlm.levmarq(lambda x: torch.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]]),
                     torch.tensor([-1.2, 1.0]), iters=60)
    np.testing.assert_allclose(rt.params.numpy(), np.asarray(rj.params), atol=1e-5)
    assert int(rt.n_accepted) == int(rj.n_accepted) and float(rt.cost) < 1e-8
    t = np.linspace(0, 1, 40).astype(np.float32)
    y = 2.0 * np.exp(-1.3 * t) + 0.05 * rng.normal(size=40).astype(np.float32)
    rj = jlm.levmarq(lambda p: p[0] * jnp.exp(p[1] * J(t)) - J(y), jnp.array([1.0, 0.0]), iters=40)
    rt = tlm.levmarq(lambda p: p[0] * torch.exp(p[1] * T(t)) - T(y), torch.tensor([1.0, 0.0]), iters=40)
    np.testing.assert_allclose(rt.params.numpy(), np.asarray(rj.params), atol=1e-5)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-5)
