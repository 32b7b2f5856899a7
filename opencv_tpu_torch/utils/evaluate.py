"""Trajectory evaluation: ATE-RMSE with Sim(3)/SE(3) Umeyama alignment
(host numpy, a copy of opencv_tpu/utils/evaluate.py)."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform aligning src -> dst ([N,3] each).
    Returns (R, t, s) with dst ≈ s * R @ src + t."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    u, d, vt = np.linalg.svd(cov)
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_mat[2, 2] = -1.0
    R = u @ s_mat @ vt
    if with_scale:
        var_s = (xs ** 2).sum() / src.shape[0]
        scale = float(np.trace(np.diag(d) @ s_mat) / var_s) if var_s > 0 else 1.0
    else:
        scale = 1.0
    t = mu_d - scale * R @ mu_s
    return R, t, scale


def ate_rmse(
    estimated: np.ndarray, ground_truth: np.ndarray, with_scale: bool = True
) -> float:
    """Absolute trajectory error RMSE after Umeyama alignment.
    estimated/ground_truth: [N,3] camera centers, time-aligned."""
    R, t, s = umeyama_alignment(estimated, ground_truth, with_scale)
    aligned = (s * (R @ estimated.T)).T + t
    err = aligned - ground_truth
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))
