"""IPPE: infinitesimal plane-based pose estimation (Collins & Bartoli,
IJCV 2014), port of opencv_tpu/geometry/ippe.py (SOLVEPNP_IPPE slot).

For planar object points PnP has exactly two local minima in closed form:
the homography's first-order expansion at the plane centroid gives the
rotation pair, and translation follows by linear least squares. Both
poses are returned, sorted by reprojection error.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_tpu_torch.geometry.homography import dlt_homography
from opencv_tpu_torch.geometry.rotation import hat, rodrigues_inv


class IPPEResult(NamedTuple):
    rvecs: torch.Tensor  # [2, 3]
    tvecs: torch.Tensor  # [2, 3]
    errors: torch.Tensor  # [2] mean squared reprojection error (normalized)


def _rotation_about_axis_to_bearing(p: torch.Tensor) -> torch.Tensor:
    """Rv with Rv @ [0, 0, 1] = normalize([p0, p1, 1])."""
    m = torch.cat([p, torch.ones_like(p[:1])])
    m = m / torch.linalg.vector_norm(m)
    v = torch.linalg.cross(torch.tensor([0.0, 0.0, 1.0], dtype=p.dtype, device=p.device), m)
    s2 = (v * v).sum()
    K = hat(v)
    factor = torch.where(s2 < 1e-12, torch.full_like(s2, 0.5), (1.0 - m[2]) / s2.clamp(min=1e-12))
    return torch.eye(3, dtype=p.dtype, device=p.device) + K + factor * (K @ K)


def _solve_translation(R, obj, img, valid):
    """Least-squares t given R (linear in t): [1, 0, -u] t = u RX_z - RX_x,
    [0, 1, -v] t = v RX_z - RX_y."""
    RX = obj @ R.T
    u, v = img[:, 0], img[:, 1]
    w = valid.to(obj.dtype)
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    A = torch.cat([torch.stack([one, zero, -u], 1) * w[:, None],
                   torch.stack([zero, one, -v], 1) * w[:, None]])
    b = torch.cat([(u * RX[:, 2] - RX[:, 0]) * w, (v * RX[:, 2] - RX[:, 1]) * w])
    AtA = A.T @ A + 1e-12 * torch.eye(3, dtype=obj.dtype, device=obj.device)
    return torch.linalg.solve_ex(AtA, (A.T @ b)[:, None])[0][:, 0]


def solve_pnp_ippe(
    obj_pts: torch.Tensor, img_pts: torch.Tensor, valid: torch.Tensor | None = None,
) -> IPPEResult:
    """Planar PnP, both solutions (cv::solvePnPGeneric SOLVEPNP_IPPE).
    obj_pts [N, 3] on the plane z = 0, or [N, 2]; img_pts [N, 2] NORMALIZED
    image coords. Returns both poses sorted by reprojection error."""
    obj_pts = obj_pts.to(torch.float32)
    if obj_pts.shape[1] == 2:
        obj_pts = torch.cat([obj_pts, torch.zeros_like(obj_pts[:, :1])], 1)
    img_pts = img_pts.to(torch.float32)
    n = obj_pts.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=obj_pts.device)
    w = valid.to(torch.float32)
    wsum = w.sum().clamp(min=1.0)
    ctr = (obj_pts[:, :2] * w[:, None]).sum(0) / wsum
    uv = obj_pts[:, :2] - ctr
    # invalid rows repeat the first valid pair: a consistent constraint
    fv = torch.argmax(valid.to(torch.int32))
    H, _ = dlt_homography(torch.where(valid[:, None], uv, uv[fv]),
                          torch.where(valid[:, None], img_pts, img_pts[fv]))
    H = H / H[2, 2]
    p = H[:2, 2]  # image of the plane origin
    J = torch.stack([H[0, :2] - p[0] * H[2, :2], H[1, :2] - p[1] * H[2, :2]])
    Rv = _rotation_about_axis_to_bearing(p)
    B = torch.stack([Rv[0, :2] - p[0] * Rv[2, :2], Rv[1, :2] - p[1] * Rv[2, :2]])
    detB = B[0, 0] * B[1, 1] - B[0, 1] * B[1, 0]
    Binv = torch.stack([torch.stack([B[1, 1], -B[0, 1]]), torch.stack([-B[1, 0], B[0, 0]])])
    Binv = Binv / torch.where(detB.abs() < 1e-12, torch.ones_like(detB), detB)
    A = Binv @ J
    # largest singular value of A = scale gamma
    AAt = A @ A.T
    tr = AAt[0, 0] + AAt[1, 1]
    det = AAt[0, 0] * AAt[1, 1] - AAt[0, 1] * AAt[1, 0]
    disc = torch.sqrt((tr * tr / 4.0 - det).clamp(min=0.0))
    gamma = torch.sqrt((tr / 2.0 + disc).clamp(min=1e-12))
    B22 = A / gamma
    b1, b2 = B22[:, 0], B22[:, 1]
    c1 = torch.sqrt((1.0 - (b1 * b1).sum()).clamp(min=0.0))
    c2 = torch.sqrt((1.0 - (b2 * b2).sum()).clamp(min=0.0))
    # orthogonality: b1.b2 + c1 c2 = 0 fixes the relative sign
    s = -torch.sign((b1 * b2).sum())
    c2 = torch.where(s == 0, torch.ones_like(s), s) * c2
    obj_c = torch.cat([uv, obj_pts[:, 2:]], 1)

    def build(sign):
        col1 = torch.cat([b1, sign * c1[None]])
        col2 = torch.cat([b2, sign * c2[None]])
        R = Rv @ torch.stack([col1, col2, torch.linalg.cross(col1, col2)], 1)
        t = _solve_translation(R, obj_c, img_pts, valid)
        X = obj_c @ R.T + t
        proj = X[:, :2] / X[:, 2:3].clamp(min=1e-9)
        e = torch.where(valid[:, None], (proj - img_pts) ** 2, torch.zeros_like(proj)).sum() / wsum
        # back to the uncentred object frame: t' = t - R [ctr, 0]
        off = torch.cat([ctr, torch.zeros_like(ctr[:1])])
        return rodrigues_inv(R), t - R @ off, e

    ra, ta, ea = build(1.0)
    rb, tb, eb = build(-1.0)
    first = ea <= eb
    return IPPEResult(
        torch.stack([torch.where(first, ra, rb), torch.where(first, rb, ra)]),
        torch.stack([torch.where(first, ta, tb), torch.where(first, tb, ta)]),
        torch.stack([torch.where(first, ea, eb), torch.where(first, eb, ea)]),
    )
