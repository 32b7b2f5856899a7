"""Perspective-n-Point (port of opencv_tpu/geometry/pnp.py): DLT, virtual
visual servoing refinement, Gauss-Newton refinement and RANSAC with the
P3P, EPnP or DLT minimal kernel.

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
from opencv_tpu_torch.geometry.rotation import (
    hat, project_to_rotation, rodrigues, rodrigues_inv, rodrigues_jacobian,
)


def project_points(rvec: torch.Tensor, tvec: torch.Tensor, obj_pts: torch.Tensor) -> torch.Tensor:
    """World [..., N, 3] -> normalized image coords [..., N, 2] through
    (rvec [..., 3], tvec [..., 3]); obj_pts broadcasts against the pose
    batch."""
    R = rodrigues(rvec)
    pc = torch.matmul(obj_pts, R.transpose(-1, -2)) + tvec[..., None, :]
    z = pc[..., 2]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    return pc[..., :2] / z[..., None]


def dlt_pnp(obj_pts: torch.Tensor, img_pts: torch.Tensor):
    """Direct linear transform PnP on [..., N>=6, 3] / [..., N, 2]
    (normalized coords): P [3, 4] from the design's nullspace, sign and
    scale fixed by cheirality and det, projected onto SO(3). Returns
    (rvec, tvec, ok)."""
    from opencv_tpu_torch.geometry.epipolar import _nullspace

    X = torch.cat([obj_pts, torch.ones_like(obj_pts[..., :1])], -1)  # [..., N, 4]
    zeros = torch.zeros_like(X)
    rows_u = torch.cat([X, zeros, -img_pts[..., 0:1] * X], -1)
    rows_v = torch.cat([zeros, X, -img_pts[..., 1:2] * X], -1)
    p = _nullspace(torch.cat([rows_u, rows_v], -2)).unflatten(-1, (3, 4))
    # cheirality: the majority of depths positive, else flip the sign
    depths = (X * p[..., None, 2, :]).sum(-1)
    p = p * torch.where(torch.sign(depths).sum(-1) >= 0, 1.0, -1.0)[..., None, None]
    M = p[..., :3]
    scale = torch.linalg.det(M)
    ok = scale.abs() > 1e-12
    scale = torch.sign(scale) * scale.abs() ** (1.0 / 3.0)
    scale = torch.where(ok, scale, torch.ones_like(scale))
    R = project_to_rotation(M / scale[..., None, None])
    t = p[..., 3] / scale[..., None]
    ok &= torch.isfinite(R).all(dim=(-1, -2)) & torch.isfinite(t).all(dim=-1)
    return rodrigues_inv(R), t, ok


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


def _exp_se3_inv(twist: torch.Tensor):
    """Inverse SE(3) exponential of [..., 6] = (u, omega) (Eade's V-matrix
    closed form, solvepnp.cpp:576-625). Returns (R [..., 3, 3], t [..., 3])."""
    u, om = twist[..., :3], twist[..., 3:]
    th2 = (om * om).sum(-1)
    th = torch.sqrt(th2)
    small = th < 1e-8
    ths = torch.where(small, torch.ones_like(th), th)
    A = torch.where(small, torch.ones_like(th), torch.sin(ths) / ths)
    B = torch.where(small, torch.full_like(th, 0.5), (1.0 - torch.cos(ths)) / (ths * ths))
    C = torch.where(small, torch.full_like(th, 1.0 / 6.0), (1.0 - A) / (ths * ths))
    W = hat(om)
    W2 = W @ W
    eye = torch.eye(3, dtype=twist.dtype, device=twist.device)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    R1 = R.transpose(-1, -2)
    return R1, -(R1 @ (V @ u[..., None]))[..., 0]


def refine_pose_vvs(
    rvec: torch.Tensor,
    tvec: torch.Tensor,
    obj_pts: torch.Tensor,
    img_pts: torch.Tensor,
    weights: torch.Tensor | None = None,
    iters: int = 20,
    vvs_lambda: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """solvePnPRefineVVS analog (solvepnp.cpp:679-717), batched over
    leading dims: per step the 2x6 point-feature interaction matrix L, the
    damped pseudo-inverse step dq = -lambda L^+ (s - s*), and the pose
    composed with the inverse SE(3) exponential of dq. img_pts are
    normalized coordinates; weights [..., N] (0 masks)."""
    n = obj_pts.shape[-2]
    w = torch.ones_like(obj_pts[..., 0]) if weights is None else weights
    w2 = w.repeat_interleave(2, dim=-1)[..., None]
    eye = 1e-12 * torch.eye(6, dtype=obj_pts.dtype, device=obj_pts.device)
    R, t = rodrigues(rvec), tvec
    for _ in range(iters):
        pc = obj_pts @ R.transpose(-1, -2) + t[..., None, :]
        Z = pc[..., 2]
        Z = torch.where(Z.abs() < 1e-9, torch.full_like(Z, 1e-9), Z)
        x = pc[..., 0] / Z
        y = pc[..., 1] / Z
        iz = 1.0 / Z
        zero = torch.zeros_like(x)
        Lx = torch.stack([-iz, zero, x * iz, x * y, -(1.0 + x * x), y], -1)
        Ly = torch.stack([zero, -iz, y * iz, 1.0 + y * y, -x * y, -x], -1)
        L = torch.stack([Lx, Ly], -2).reshape(Lx.shape[:-2] + (2 * n, 6)) * w2
        e = ((torch.stack([x, y], -1) - img_pts) * w[..., None]).flatten(-2)
        H = L.transpose(-1, -2) @ L + eye
        dq = -vvs_lambda * torch.linalg.solve_ex(H, L.transpose(-1, -2) @ e[..., None])[0][..., 0]
        R1, t1 = _exp_se3_inv(dq)
        R, t = R1 @ R, (R1 @ t[..., None])[..., 0] + t1
    return rodrigues_inv(R), t


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
    kernel: str = "p3p",
    adaptive: bool = True,
    subsets: torch.Tensor | None = None,
) -> PnPResult:
    """solvePnPRansac analog on normalized coords; threshold is the LINEAR
    reprojection distance. kernel: "p3p" (4-point samples, the default),
    "epnp" (5-point samples, the reference's SOLVEPNP_EPNP model) or
    "dlt" (6-point, degenerate on coplanar samples). The winner is
    Gauss-Newton-refined on its inliers and the inliers are recomputed.
    `subsets` [H, S] injects the samples."""
    from opencv_tpu_torch.geometry.epnp import epnp_kernel
    from opencv_tpu_torch.geometry.p3p import p3p_kernel

    def dlt_kernel(obj, img):
        rv, tv, ok = dlt_pnp(obj, img)
        return torch.cat([rv, tv], -1), ok

    subset, fit = {"p3p": (4, p3p_kernel), "epnp": (5, epnp_kernel), "dlt": (6, dlt_kernel)}[kernel]

    n = obj_pts.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=obj_pts.device)
    thr2 = cfg.threshold * cfg.threshold
    cfg2 = RansacConfig(
        n_hypotheses=cfg.n_hypotheses, threshold=thr2, confidence=cfg.confidence, seed=cfg.seed
    )

    def model_fn(idx):
        return fit(obj_pts[idx], img_pts[idx])

    def error_fn(models):
        d = project_points(models[..., :3], models[..., 3:], obj_pts) - img_pts
        return (d * d).sum(-1)

    if adaptive and subsets is None:
        res = ransac_mod.ransac_adaptive(gen, n, valid, subset, model_fn, error_fn, cfg2)
    else:
        res = ransac_mod.ransac(gen, n, valid, subset, model_fn, error_fn, cfg2, subsets=subsets)
    w = res.inliers.to(torch.float32)
    rvec, tvec = gn_refine_pose(res.model[:3], res.model[3:], obj_pts, img_pts, w, refine_iters)
    d = project_points(rvec, tvec, obj_pts) - img_pts
    inliers = ((d * d).sum(-1) < thr2) & valid
    return PnPResult(rvec=rvec, tvec=tvec, inliers=inliers, n_inliers=inliers.sum(), ok=res.ok)
