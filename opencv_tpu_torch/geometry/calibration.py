"""Camera calibration (port of opencv_tpu/geometry/calibration.py):
distortion models, Zhang's closed-form initialization and the joint
Levenberg-Marquardt refinement (cv::calibrateCamera, cv::fisheye::
calibrate, cv::stereoCalibrate with fixed intrinsics), undistortion maps
and whole-image undistortion.

The closed-form initialization (homographies, Zhang's intrinsics, the
per-view extrinsics) runs on the host CPU, so every device starts the
refinement from the same parameters; the refinement runs on the asked
device, its Jacobian by torch.func.jacfwd through the projection model.
The entry points take and return numpy arrays; `device=None` runs the
refinement on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.geometry.homography import dlt_homography
from opencv_tpu_torch.geometry.pnp import project_points
from opencv_tpu_torch.geometry.rotation import project_to_rotation, rodrigues, rodrigues_inv
from opencv_tpu_torch.optim.levmarq import levmarq

def distort(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """(k1, k2, p1, p2, k3) distortion of normalized coords [..., 2]
    (cvProjectPoints2 model)."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xt = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yt = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xt, yt], dim=-1)


def _to_pixels(xd: torch.Tensor, K4: torch.Tensor) -> torch.Tensor:
    return torch.stack([xd[..., 0] * K4[0] + K4[2], xd[..., 1] * K4[1] + K4[3]], dim=-1)


def project_points_full(rvec, tvec, K4, dist, obj_pts) -> torch.Tensor:
    """World [..., N, 3] -> pixels [..., N, 2]; K4 = (fx, fy, cx, cy);
    batched over leading dims of the pose."""
    return _to_pixels(distort(project_points(rvec, tvec, obj_pts), dist), K4)


def undistort_points(pts: torch.Tensor, K: torch.Tensor, dist: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Pixel coords -> undistorted normalized coords (cv::undistortPoints,
    fixed-point inversion of the distortion model)."""
    xd = torch.stack([(pts[..., 0] - K[0, 2]) / K[0, 0], (pts[..., 1] - K[1, 2]) / K[1, 1]], dim=-1)
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x = xd
    for _ in range(iters):
        r2 = (x * x).sum(-1)
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
        dx = torch.stack([
            2.0 * p1 * x[..., 0] * x[..., 1] + p2 * (r2 + 2.0 * x[..., 0] ** 2),
            p1 * (r2 + 2.0 * x[..., 1] ** 2) + 2.0 * p2 * x[..., 0] * x[..., 1],
        ], dim=-1)
        x = (xd - dx) / radial[..., None]
    return x


def _zhang_intrinsics(homographies: list[np.ndarray]) -> np.ndarray:
    """Closed-form (fx, fy, cx, cy) from planar-target homographies
    (Zhang 2000), in f64 on the host."""

    def v(h, i, j):
        return np.array([
            h[0, i] * h[0, j],
            h[0, i] * h[1, j] + h[1, i] * h[0, j],
            h[1, i] * h[1, j],
            h[2, i] * h[0, j] + h[0, i] * h[2, j],
            h[2, i] * h[1, j] + h[1, i] * h[2, j],
            h[2, i] * h[2, j],
        ])

    rows = []
    for h in homographies:
        rows.append(v(h, 0, 1))
        rows.append(v(h, 0, 0) - v(h, 1, 1))
    _, _, vt = np.linalg.svd(np.stack(rows))
    b11, b12, b22, b13, b23, b33 = vt[-1]
    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / (b11 * b22 - b12 * b12)))
    cx = -b13 * fx * fx / lam
    return np.array([fx, fy, cx, cy], np.float32)


def _extrinsics_from_h(h: np.ndarray, K4: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    Kinv = np.linalg.inv(np.array([[K4[0], 0, K4[2]], [0, K4[1], K4[3]], [0, 0, 1]], np.float64))
    a = Kinv @ h
    s = 1.0 / np.linalg.norm(a[:, 0])
    if a[2, 2] * s < 0:  # keep the target in front of the camera
        s = -s
    r1, r2, t = a[:, 0] * s, a[:, 1] * s, a[:, 2] * s
    M = torch.from_numpy(np.stack([r1, r2, np.cross(r1, r2)], 1).astype(np.float32))
    rv = rodrigues_inv(project_to_rotation(M)).numpy()
    return rv.astype(np.float32), t.astype(np.float32)


def _homographies(obj_pts: np.ndarray, img_pts: np.ndarray) -> list[np.ndarray]:
    """Per-view plane -> image DLT homographies, f64 numpy, on the host."""
    H, _ = dlt_homography(torch.from_numpy(np.ascontiguousarray(obj_pts[..., :2], np.float32)),
                          torch.from_numpy(np.ascontiguousarray(img_pts, np.float32)))
    return list(H.numpy().astype(np.float64))


class CalibrationResult(NamedTuple):
    K: np.ndarray  # [3, 3]
    dist: np.ndarray  # [5] (fisheye: [4])
    rvecs: np.ndarray  # [V, 3]
    tvecs: np.ndarray  # [V, 3]
    rms: float  # RMS reprojection error (px)


def _calibrate(project, n_dist, obj_pts, img_pts, refine_iters, device) -> CalibrationResult:
    """Zhang init on the host, then LM over (fx fy cx cy, the lens's
    n_dist coefficients, all extrinsics) through `project` on the device."""
    dev = resolve_device(device)
    obj_pts = np.asarray(obj_pts, np.float32)
    img_pts = np.asarray(img_pts, np.float32)
    V, N, _ = obj_pts.shape
    homs = _homographies(obj_pts, img_pts)
    K4 = _zhang_intrinsics(homs)
    rvecs, tvecs = zip(*[_extrinsics_from_h(h, K4) for h in homs])
    obj_t = torch.from_numpy(obj_pts).to(dev)
    img_t = torch.from_numpy(img_pts).to(dev)
    e = 4 + n_dist

    def residual(params):
        rv = params[e: e + 3 * V].reshape(V, 3)
        tv = params[e + 3 * V:].reshape(V, 3)
        return (project(rv, tv, params[:4], params[4:e], obj_t) - img_t).reshape(-1)

    x0 = torch.from_numpy(np.concatenate([
        K4, np.zeros(n_dist, np.float32), np.stack(rvecs).reshape(-1), np.stack(tvecs).reshape(-1),
    ]).astype(np.float32)).to(dev)
    res = levmarq(residual, x0, iters=refine_iters)
    p = res.params.cpu().numpy()
    return CalibrationResult(
        K=np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1]], np.float32),
        dist=p[4:e].astype(np.float32),
        rvecs=p[e: e + 3 * V].reshape(V, 3).astype(np.float32),
        tvecs=p[e + 3 * V:].reshape(V, 3).astype(np.float32),
        rms=float(np.sqrt(2.0 * float(res.cost) / (V * N))),
    )


def calibrate_camera(
    obj_pts: np.ndarray,  # [V, N, 3] planar target points (z = 0)
    img_pts: np.ndarray,  # [V, N, 2] observed pixels
    refine_iters: int = 40,
    device=None,
) -> CalibrationResult:
    """cv::calibrateCamera analog for a planar target."""
    return _calibrate(project_points_full, 5, obj_pts, img_pts, refine_iters, device)


# ------------------------------------------------------------- fisheye


def _fisheye_poly(th: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    th2 = th * th
    return th * (1.0 + k[0] * th2 + k[1] * th2 ** 2 + k[2] * th2 ** 3 + k[3] * th2 ** 4)


def fisheye_distort(xy: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Equidistant fisheye model (cv::fisheye): normalized pinhole coords ->
    distorted normalized coords, th_d = th (1 + k1 th^2 + ... + k4 th^8)."""
    r = torch.sqrt((xy * xy).sum(-1))
    th_d = _fisheye_poly(torch.atan(r), k)
    scale = torch.where(r > 1e-9, th_d / r.clamp(min=1e-9), torch.ones_like(r))
    return xy * scale[..., None]


def fisheye_undistort(xy_d: torch.Tensor, k: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Invert fisheye_distort by Newton on theta."""
    r_d = torch.sqrt((xy_d * xy_d).sum(-1))
    th = r_d
    for _ in range(iters):
        th2 = th * th
        f = _fisheye_poly(th, k) - r_d
        df = (1.0 + 3 * k[0] * th2 + 5 * k[1] * th2 ** 2 + 7 * k[2] * th2 ** 3 + 9 * k[3] * th2 ** 4)
        th = th - f / torch.where(df.abs() < 1e-9, torch.full_like(df, 1e-9), df)
    scale = torch.where(r_d > 1e-9, torch.tan(th) / r_d.clamp(min=1e-9), torch.ones_like(r_d))
    return xy_d * scale[..., None]


def fisheye_project_points(rvec, tvec, K4, k, obj_pts) -> torch.Tensor:
    """World [..., N, 3] -> fisheye pixels [..., N, 2]."""
    return _to_pixels(fisheye_distort(project_points(rvec, tvec, obj_pts), k), K4)


def calibrate_fisheye(
    obj_pts: np.ndarray, img_pts: np.ndarray, refine_iters: int = 60, device=None,
) -> CalibrationResult:
    """cv::fisheye::calibrate analog: Zhang init on the pinhole
    homographies, then joint LM through the equidistant model. dist is
    (k1, k2, k3, k4)."""
    return _calibrate(fisheye_project_points, 4, obj_pts, img_pts, refine_iters, device)


# ------------------------------------------------- stereo calibration


class StereoCalibrationResult(NamedTuple):
    R: np.ndarray  # [3, 3] rotation cam1 -> cam2
    T: np.ndarray  # [3] translation cam1 -> cam2
    E: np.ndarray  # [3, 3] essential matrix
    F: np.ndarray  # [3, 3] fundamental matrix
    rvecs: np.ndarray  # [V, 3] per-view cam1 extrinsics
    tvecs: np.ndarray  # [V, 3]
    rms: float  # RMS reprojection error over both cameras (px)


def _np_batch_rodrigues(rvecs: np.ndarray) -> np.ndarray:
    return rodrigues(torch.from_numpy(np.asarray(rvecs, np.float32))).numpy()


def stereo_calibrate(
    obj_pts: np.ndarray,  # [V, N, 3] planar target points (z = 0)
    img_pts1: np.ndarray,  # [V, N, 2] pixels in camera 1
    img_pts2: np.ndarray,  # [V, N, 2] pixels in camera 2
    K1: np.ndarray, dist1: np.ndarray,
    K2: np.ndarray, dist2: np.ndarray,
    refine_iters: int = 60,
    device=None,
) -> StereoCalibrationResult:
    """cv::stereoCalibrate analog with fixed intrinsics
    (CALIB_FIX_INTRINSIC): LM over the rig transform (R, T), cam2 =
    R cam1 + T, and the per-view cam1 extrinsics on the stacked
    two-camera reprojection residual. Init on the host: per-view planar
    extrinsics of each camera from its undistorted homographies, the
    chordal mean of the relative rotations and the mean translation."""
    dev = resolve_device(device)
    obj_pts = np.asarray(obj_pts, np.float32)
    V, N, _ = obj_pts.shape
    K1 = np.asarray(K1, np.float32)
    K2 = np.asarray(K2, np.float32)
    dist1 = np.zeros(5, np.float32) if dist1 is None else np.asarray(dist1, np.float32)
    dist2 = np.zeros(5, np.float32) if dist2 is None else np.asarray(dist2, np.float32)

    def view_extrinsics(img_pts, K, dist):
        norm = undistort_points(torch.from_numpy(np.asarray(img_pts, np.float32)),
                                torch.from_numpy(K), torch.from_numpy(dist)).numpy()
        ext = [_extrinsics_from_h(h, np.array([1.0, 1.0, 0.0, 0.0]))
               for h in _homographies(obj_pts, norm)]
        return np.stack([e[0] for e in ext]), np.stack([e[1] for e in ext])

    rv1, tv1 = view_extrinsics(img_pts1, K1, dist1)
    rv2, tv2 = view_extrinsics(img_pts2, K2, dist2)
    R_rels = np.einsum("vij,vkj->vik", _np_batch_rodrigues(rv2), _np_batch_rodrigues(rv1))
    R0 = project_to_rotation(torch.from_numpy(R_rels.mean(axis=0).astype(np.float32)))
    T0 = (tv2 - np.einsum("ij,vj->vi", R0.numpy(), tv1)).mean(axis=0)

    def k4(K):
        return torch.tensor([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], dtype=torch.float32, device=dev)

    K4_1, K4_2 = k4(K1), k4(K2)
    d1 = torch.from_numpy(dist1).to(dev)
    d2 = torch.from_numpy(dist2).to(dev)
    obj_t = torch.from_numpy(obj_pts).to(dev)
    img1 = torch.as_tensor(np.asarray(img_pts1, np.float32), device=dev)
    img2 = torch.as_tensor(np.asarray(img_pts2, np.float32), device=dev)

    def residual(params):
        R_rel = rodrigues(params[:3])
        rv = params[6: 6 + 3 * V].reshape(V, 3)
        tv = params[6 + 3 * V:].reshape(V, 3)
        p1 = project_points_full(rv, tv, K4_1, d1, obj_t)
        R2 = R_rel @ rodrigues(rv)
        t2 = tv @ R_rel.T + params[3:6]
        p2 = project_points_full(rodrigues_inv(R2), t2, K4_2, d2, obj_t)
        return torch.cat([p1 - img1, p2 - img2], dim=1).reshape(-1)

    x0 = torch.from_numpy(np.concatenate([
        rodrigues_inv(R0).numpy(), T0, rv1.reshape(-1), tv1.reshape(-1),
    ]).astype(np.float32)).to(dev)
    res = levmarq(residual, x0, iters=refine_iters)
    p = res.params.cpu().numpy()
    R = _np_batch_rodrigues(p[:3])
    T = p[3:6].astype(np.float32)
    tx = np.array([[0, -T[2], T[1]], [T[2], 0, -T[0]], [-T[1], T[0], 0]], np.float32)
    E = tx @ R
    F = np.linalg.inv(K2).T @ E @ np.linalg.inv(K1)
    F = F / (F[2, 2] if abs(F[2, 2]) > 1e-12 else 1.0)
    return StereoCalibrationResult(
        R=R, T=T, E=E, F=F.astype(np.float32),
        rvecs=p[6: 6 + 3 * V].reshape(V, 3).astype(np.float32),
        tvecs=p[6 + 3 * V:].reshape(V, 3).astype(np.float32),
        rms=float(np.sqrt(2.0 * float(res.cost) / (2 * V * N))),
    )


# --------------------------------------- undistortion map / whole image


def init_undistort_rectify_map(K, dist, R, new_K, size: tuple[int, int], device=None) -> torch.Tensor:
    """cv::initUndistortRectifyMap analog: the [H, W, 2] (x, y) map that,
    fed to core.imgproc.remap, undistorts (and with R rectifies) an image.
    Each destination pixel is back-projected through new_K, rotated by
    R^-1, distorted and projected through K. K, dist, R and new_K may be
    numpy arrays (then `device=None` means the card) or tensors (their
    device is used)."""
    if device is None and torch.is_tensor(K):
        dev = K.device
    else:
        dev = resolve_device(device)

    def t(x):
        return torch.tensor(np.asarray(x.cpu() if torch.is_tensor(x) else x, np.float32), device=dev)

    h, w = size
    K, new_K = t(K), t(new_K)
    dist = torch.zeros(5, device=dev) if dist is None else t(dist)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    x = (xs - new_K[0, 2]) / new_K[0, 0]
    y = (ys - new_K[1, 2]) / new_K[1, 1]
    if R is not None:
        Rinv = torch.linalg.inv(t(R))
        X = Rinv[0, 0] * x + Rinv[0, 1] * y + Rinv[0, 2]
        Y = Rinv[1, 0] * x + Rinv[1, 1] * y + Rinv[1, 2]
        Wc = Rinv[2, 0] * x + Rinv[2, 1] * y + Rinv[2, 2]
        x = X / Wc
        y = Y / Wc
    xd = distort(torch.stack([x, y], dim=-1), dist)
    return torch.stack([xd[..., 0] * K[0, 0] + K[0, 2], xd[..., 1] * K[1, 1] + K[1, 2]], dim=-1)


def undistort_image(img: torch.Tensor, K, dist, new_K=None) -> torch.Tensor:
    """cv::undistort analog: the rectify map with R = I, then the bilinear
    remap; on the device of img."""
    from opencv_tpu_torch.core.imgproc import remap

    h, w = img.shape[-2:]
    m = init_undistort_rectify_map(K, dist, None, K if new_K is None else new_K, (h, w), device=img.device)
    return remap(img, m)
