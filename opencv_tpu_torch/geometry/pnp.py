"""Perspective-n-Point: P3P RANSAC + Gauss-Newton refinement (the engine's
subset of opencv_tpu/geometry/pnp.py).

The Gauss-Newton Jacobian is the chain rule through the projection with
dR/drvec from `rotation.rodrigues_jacobian` (torch.func.jacfwd of the
guarded Rodrigues formula); tests hold it against torch.func.jacfwd of
the whole residual, the JAX package's `jax.jacfwd` form.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_tpu_torch.core.config import RansacConfig
from opencv_tpu_torch.geometry import ransac as ransac_mod
from opencv_tpu_torch.geometry.rotation import rodrigues, rodrigues_jacobian


def project_points(rvec: torch.Tensor, tvec: torch.Tensor, obj_pts: torch.Tensor) -> torch.Tensor:
    """World [..., N, 3] -> normalized image coords [..., N, 2] through
    (rvec [..., 3], tvec [..., 3]); obj_pts broadcasts against the pose
    batch."""
    R = rodrigues(rvec)
    pc = torch.matmul(obj_pts, R.transpose(-1, -2)) + tvec[..., None, :]
    z = pc[..., 2]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    return pc[..., :2] / z[..., None]


def _residuals_and_jacobian(params, obj_pts, img_pts, weights):
    """r [..., 2N] and J [..., 2N, 6] of (project(params) - img) * w."""
    rvec, tvec = params[..., :3], params[..., 3:]
    R = rodrigues(rvec)
    dR = rodrigues_jacobian(rvec)  # [..., 3, 3, 3]
    pc = torch.matmul(obj_pts, R.transpose(-1, -2)) + tvec[..., None, :]  # [..., N, 3]
    z = pc[..., 2]
    guard = z.abs() < 1e-9
    zs = torch.where(guard, torch.full_like(z, 1e-9), z)
    uv = pc[..., :2] / zs[..., None]
    w = weights[..., None]
    r = ((uv - img_pts) * w).flatten(-2)
    inv_z = 1.0 / zs
    zero = torch.zeros_like(zs)
    # d(uv)/d(pc): the z column vanishes where the JAX guard replaced z
    du_dz = torch.where(guard[..., None], zero[..., None], -uv / zs[..., None])
    dproj = torch.stack(
        [torch.stack([inv_z, zero, du_dz[..., 0]], -1),
         torch.stack([zero, inv_z, du_dz[..., 1]], -1)], -2,
    )  # [..., N, 2, 3]
    dpc_dr = torch.einsum("...ijk,...nj->...nik", dR, obj_pts.expand(pc.shape))  # [..., N, 3, 3]
    J = torch.cat([dproj @ dpc_dr, dproj], dim=-1) * w[..., None]  # [..., N, 2, 6]
    return r, J.flatten(-3, -2)


def gn_refine_pose(
    rvec: torch.Tensor,
    tvec: torch.Tensor,
    obj_pts: torch.Tensor,
    img_pts: torch.Tensor,
    weights: torch.Tensor,
    iters: int = 10,
    damping: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted Gauss-Newton on reprojection error (solvePnPRefineLM
    analog), batched over leading dims. weights [..., N] (0 masks)."""
    params = torch.cat([rvec, tvec], dim=-1)
    eye = damping * torch.eye(6, dtype=params.dtype, device=params.device)
    for _ in range(iters):
        r, J = _residuals_and_jacobian(params, obj_pts, img_pts, weights)
        Jt = J.transpose(-1, -2)
        H = Jt @ J + eye
        g = (Jt @ r[..., None])[..., 0]
        step = torch.linalg.solve_ex(H, g[..., None])[0][..., 0]
        params = params - step
    return params[..., :3], params[..., 3:]


class PnPResult(NamedTuple):
    rvec: torch.Tensor
    tvec: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    ok: torch.Tensor


def solve_pnp_ransac(
    gen: torch.Generator | None,
    obj_pts: torch.Tensor,
    img_pts: torch.Tensor,
    valid: torch.Tensor | None = None,
    cfg: RansacConfig = RansacConfig(threshold=2e-3),
    refine_iters: int = 10,
    adaptive: bool = True,
    subsets: torch.Tensor | None = None,
) -> PnPResult:
    """solvePnPRansac analog with the P3P minimal kernel (4-point samples)
    on normalized coords; threshold is the LINEAR reprojection distance.
    The winner is Gauss-Newton-refined on its inliers and the inliers are
    recomputed. `subsets` [H, 4] injects the samples."""
    from opencv_tpu_torch.geometry.p3p import p3p_kernel

    n = obj_pts.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=obj_pts.device)
    thr2 = cfg.threshold * cfg.threshold
    cfg2 = RansacConfig(
        n_hypotheses=cfg.n_hypotheses, threshold=thr2, confidence=cfg.confidence, seed=cfg.seed
    )

    def model_fn(idx):
        return p3p_kernel(obj_pts[idx], img_pts[idx])

    def error_fn(models):
        d = project_points(models[..., :3], models[..., 3:], obj_pts) - img_pts
        return (d * d).sum(-1)

    if adaptive and subsets is None:
        res = ransac_mod.ransac_adaptive(gen, n, valid, 4, model_fn, error_fn, cfg2)
    else:
        res = ransac_mod.ransac(gen, n, valid, 4, model_fn, error_fn, cfg2, subsets=subsets)
    w = res.inliers.to(torch.float32)
    rvec, tvec = gn_refine_pose(res.model[:3], res.model[3:], obj_pts, img_pts, w, refine_iters)
    d = project_points(rvec, tvec, obj_pts) - img_pts
    inliers = ((d * d).sum(-1) < thr2) & valid
    return PnPResult(rvec=rvec, tvec=tvec, inliers=inliers, n_inliers=inliers.sum(), ok=res.ok)
