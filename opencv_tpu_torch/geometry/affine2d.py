"""Robust 2D affine / similarity estimation (port of
opencv_tpu/geometry/affine2d.py; cv::estimateAffine2D /
estimateAffinePartial2D): batched RANSAC over minimal samples, then the
closed-form weighted least-squares refit on the consensus set and the
inlier mask recomputed against it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_tpu_torch.core.config import RansacConfig
from opencv_tpu_torch.geometry import ransac as ransac_mod


class Affine2DResult(NamedTuple):
    M: torch.Tensor  # [2, 3] affine matrix
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor
    ok: torch.Tensor


def _solve_affine_ls(src, dst, w):
    """Weighted least-squares affine on [..., N, 2]: the 3x3 normal
    equations shared by both output rows. Returns ([..., 2, 3], ok)."""
    X = torch.cat([src, torch.ones_like(src[..., :1])], -1)  # [..., N, 3]
    A = X * w[..., None]
    G = A.transpose(-1, -2) @ X
    rhs = A.transpose(-1, -2) @ dst  # [..., 3, 2]
    ok = torch.linalg.det(G).abs() > 1e-8
    okf = ok[..., None, None].to(G.dtype)
    eye = torch.eye(3, dtype=G.dtype, device=G.device)
    sol = torch.linalg.solve_ex(okf * G + (1.0 - okf) * eye, rhs)[0]
    return sol.transpose(-1, -2), ok


def _solve_similarity_ls(src, dst, w):
    """Weighted least-squares similarity [[a, -b], [b, a]] + t (4 dof)."""
    sw = w.sum(-1) + 1e-12
    mu_s = (src * w[..., None]).sum(-2) / sw[..., None]
    mu_d = (dst * w[..., None]).sum(-2) / sw[..., None]
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    denom = (w * (sc * sc).sum(-1)).sum(-1)
    a = (w * (sc * dc).sum(-1)).sum(-1)
    b = (w * (sc[..., 0] * dc[..., 1] - sc[..., 1] * dc[..., 0])).sum(-1)
    ok = denom > 1e-12
    denom = torch.where(ok, denom, torch.ones_like(denom))
    a = a / denom
    b = b / denom
    tx = mu_d[..., 0] - (a * mu_s[..., 0] - b * mu_s[..., 1])
    ty = mu_d[..., 1] - (b * mu_s[..., 0] + a * mu_s[..., 1])
    M = torch.stack([torch.stack([a, -b, tx], -1), torch.stack([b, a, ty], -1)], -2)
    return M, ok


def _apply(M, pts):
    """[..., 2, 3] affine applied to [N, 2] points -> [..., N, 2]."""
    return pts @ M[..., :, :2].transpose(-1, -2) + M[..., None, :, 2]


def _estimate(solver, subset, gen, src, dst, valid, threshold, cfg, subsets):
    n = src.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=src.device)
    if cfg is None:
        cfg = RansacConfig(n_hypotheses=512, threshold=threshold)
    thr2 = cfg.threshold * cfg.threshold

    def model_fn(idx):
        M, ok = solver(src[idx], dst[idx], torch.ones_like(idx, dtype=src.dtype))
        return M.flatten(-2), ok

    def error_fn(models):
        e = _apply(models.unflatten(-1, (2, 3)), src) - dst
        return (e * e).sum(-1)

    res = ransac_mod.ransac(gen, n, valid, subset, model_fn, error_fn,
                            RansacConfig(cfg.n_hypotheses, thr2, cfg.confidence, cfg.seed),
                            subsets=subsets)
    M, _ = solver(src, dst, res.inliers.to(src.dtype))
    e = _apply(M, src) - dst
    inl = ((e * e).sum(-1) < thr2) & valid
    return Affine2DResult(M=M, inliers=inl, n_inliers=inl.sum(), ok=res.ok)


def estimate_affine_2d(
    gen: torch.Generator | None,
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor | None = None,
    threshold: float = 3.0,
    cfg: RansacConfig | None = None,
    subsets: torch.Tensor | None = None,
) -> Affine2DResult:
    """cv::estimateAffine2D analog: full 6-dof affine from 3-point samples;
    threshold is the LINEAR pixel distance. `subsets` [H, 3] injects the
    samples."""
    return _estimate(_solve_affine_ls, 3, gen, src, dst, valid, threshold, cfg, subsets)


def estimate_affine_partial_2d(
    gen: torch.Generator | None,
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor | None = None,
    threshold: float = 3.0,
    cfg: RansacConfig | None = None,
    subsets: torch.Tensor | None = None,
) -> Affine2DResult:
    """cv::estimateAffinePartial2D analog: rotation + uniform scale +
    translation (4 dof) from 2-point samples. `subsets` [H, 2] injects the
    samples."""
    return _estimate(_solve_similarity_ls, 2, gen, src, dst, valid, threshold, cfg, subsets)
