"""Homography estimation: normalized 4-point DLT + RANSAC (the engine's
subset of opencv_tpu/geometry/homography.py)."""

from __future__ import annotations

import torch

from opencv_tpu_torch.core.config import RansacConfig
from opencv_tpu_torch.geometry import ransac as ransac_mod
from opencv_tpu_torch.geometry.epipolar import _hartley_normalize, _nullspace


def dlt_homography(x1: torch.Tensor, x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized DLT homography from [..., N>=4, 2] pairs: x2 ~ H x1.
    Returns (H [..., 3, 3] with H[2,2] = 1, ok [...])."""
    x1n, T1 = _hartley_normalize(x1)
    x2n, T2 = _hartley_normalize(x2)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    one = torch.ones_like(u1)
    zero = torch.zeros_like(u1)
    r1 = torch.stack([u1, v1, one, zero, zero, zero, -u2 * u1, -u2 * v1, -u2], dim=-1)
    r2 = torch.stack([zero, zero, zero, u1, v1, one, -v2 * u1, -v2 * v1, -v2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # [..., 2N, 9]
    Hn = _nullspace(A).reshape(A.shape[:-2] + (3, 3))
    H = torch.linalg.inv_ex(T2)[0] @ Hn @ T1
    h22 = H[..., 2, 2]
    ok = h22.abs() > 1e-12
    H = H / torch.where(ok, h22, torch.ones_like(h22))[..., None, None]
    ok &= torch.isfinite(H).all(dim=(-1, -2))
    return H, ok


def homography_transfer_error(H: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared forward transfer error |x2 - H(x1)|^2. H [..., 3, 3],
    x1/x2 [N, 2] -> [..., N]."""
    ones = torch.ones_like(x1[..., :1])
    p = torch.matmul(torch.cat([x1, ones], dim=-1), H.transpose(-1, -2))
    w = p[..., 2]
    w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    return ((p[..., :2] / w[..., None] - x2) ** 2).sum(-1)


def find_homography_ransac(
    gen: torch.Generator | None,
    x1: torch.Tensor,
    x2: torch.Tensor,
    valid: torch.Tensor | None = None,
    cfg: RansacConfig = RansacConfig(threshold=3.0),
    subsets: torch.Tensor | None = None,
) -> ransac_mod.RansacResult:
    """findHomography(RANSAC) analog; threshold is the LINEAR distance."""
    n = x1.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=x1.device)
    cfg2 = RansacConfig(cfg.n_hypotheses, cfg.threshold ** 2, cfg.confidence, cfg.seed)
    return ransac_mod.ransac(
        gen, n, valid, 4,
        lambda idx: dlt_homography(x1[idx], x2[idx]),
        lambda H: homography_transfer_error(H, x1, x2),
        cfg2, subsets=subsets,
    )
