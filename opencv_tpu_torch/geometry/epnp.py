"""EPnP (Lepetit et al.), batched over leading dimensions (port of
opencv_tpu/geometry/epnp.py).

The n world points become barycentric combinations of 4 control points;
the 4 smallest eigenvectors of the 12x12 M^T M span the camera-frame
control points; the N=1/2/3 beta cases and a plane-homography pose are
all evaluated and the one with the least reprojection error wins.

The solver computes in f64 and returns the input's dtype (f32 Gram
eigenvectors carry M's condition number squared). Eigenvector signs
differ between LAPACK and cuSOLVER; the beta cases, the depth-sign vote
and the planar Procrustes read them sign-invariantly, as in the JAX
solver, but the control points do not: a flipped principal axis puts a
control point on the other side of the centroid, and on noisy points
that moves the pose (on an H100 the card's poses differed from the CPU's
by more than 5e-4 rad on 60 % of 8-point samples). So `_control_points`
fixes each axis's sign (largest component positive), which the JAX
package leaves to its eigensolver. The 6x3 least squares of the N=2 case
takes the normal equations (`torch.linalg.lstsq` on the card only solves
full-rank systems with `gels`).
"""

from __future__ import annotations

import torch

from opencv_tpu_torch.geometry.rotation import project_to_rotation, rodrigues_inv

# index pairs of the 6 control-point distance constraints
_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
_PI = [i for i, _ in _PAIRS]
_PJ = [j for _, j in _PAIRS]
# column order of M: control point k, coordinate c <- source column c*4 + k
_PERM = [coord * 4 + k for k in range(4) for coord in range(3)]


def _gram(A: torch.Tensor) -> torch.Tensor:
    return A.transpose(-1, -2) @ A


def _control_points(obj: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] -> 4 control points [..., 4, 3]: centroid + principal
    axes scaled by the spread, each axis floored at 5 % of the largest."""
    c = obj.mean(dim=-2)
    d = obj - c[..., None, :]
    w, v = torch.linalg.eigh(_gram(d) / obj.shape[-2])  # ascending
    # the pose depends on which side of the centroid each control point
    # lies: fix each axis's sign (largest component positive), which
    # eigensolvers leave to themselves
    big = torch.gather(v, -2, v.abs().argmax(dim=-2, keepdim=True))
    v = v * torch.where(big < 0, -1.0, 1.0)
    floor = 0.05 * w[..., 2:3].clamp(min=1e-9)
    axes = v * torch.sqrt(torch.maximum(w, floor))[..., None, :]
    return torch.stack([c, c + axes[..., :, 2], c + axes[..., :, 1], c + axes[..., :, 0]], dim=-2)


def _barycentric(obj: torch.Tensor, cw: torch.Tensor) -> torch.Tensor:
    """alphas [..., N, 4] with X_i = sum_j alpha_ij C_j, sum_j alpha_ij = 1."""
    T = torch.cat([cw.transpose(-1, -2), torch.ones_like(cw[..., None, :, 0])], dim=-2)  # [..., 4, 4]
    X = torch.cat([obj.transpose(-1, -2), torch.ones_like(obj[..., None, :, 0])], dim=-2)
    return torch.linalg.solve_ex(T, X)[0].transpose(-1, -2)


def _pair_diffs(c: torch.Tensor) -> torch.Tensor:
    """[..., 4, 3] points -> [..., 6, 3] pairwise differences."""
    return c[..., _PI, :] - c[..., _PJ, :]


def _pose_from_betas(betas, V, alphas, obj):
    """Camera-frame control points V @ betas, then Horn (R, t); betas
    [..., K, 4] for K candidates, V [..., 12, 4]."""
    cc = (V[..., None, :, :] @ betas[..., None])[..., 0].unflatten(-1, (4, 3))  # [..., K, 4, 3]
    pc = alphas[..., None, :, :] @ cc  # [..., K, N, 3]
    # sign: depths must be positive
    sign = torch.where(torch.sign(pc[..., 2]).sum(-1) >= 0, 1.0, -1.0)
    pc = pc * sign[..., None, None]
    muW = obj.mean(dim=-2)  # [..., 3]
    muC = pc.mean(dim=-2)  # [..., K, 3]
    H = (pc - muC[..., None, :]).transpose(-1, -2) @ (obj - muW[..., None, :])[..., None, :, :]
    R = project_to_rotation(H)
    t = muC - (R @ muW[..., None, :, None])[..., 0]
    return R, t


def _planar_pose(obj: torch.Tensor, img: torch.Tensor):
    """Pose from a plane-to-image homography (the planar path of the
    reference's solvePnP front door)."""
    c = obj.mean(dim=-2)
    d = obj - c[..., None, :]
    _, v = torch.linalg.eigh(_gram(d))
    B = v[..., :, 1:]  # [..., 3, 2] in-plane basis (two largest axes)
    p = d @ B  # [..., N, 2]
    ph = torch.cat([p, torch.ones_like(p[..., :1])], -1)
    zeros = torch.zeros_like(ph)
    rows_u = torch.cat([ph, zeros, -img[..., 0:1] * ph], -1)
    rows_v = torch.cat([zeros, ph, -img[..., 1:2] * ph], -1)
    A = torch.cat([rows_u, rows_v], -2)
    _, vec = torch.linalg.eigh(_gram(A))
    H = vec[..., :, 0].unflatten(-1, (3, 3))
    depth = (ph * H[..., None, 2, :]).sum(-1)
    H = H * torch.where(torch.sign(depth).sum(-1) >= 0, 1.0, -1.0)[..., None, None]
    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    lam = (0.5 * (torch.linalg.vector_norm(h1, dim=-1) + torch.linalg.vector_norm(h2, dim=-1))).clamp(min=1e-12)
    M = torch.stack([h1, h2], -1) / lam[..., None, None]  # [..., 3, 2]
    uu, _, vvt = torch.linalg.svd(M, full_matrices=False)
    Q = uu @ vvt  # nearest 3x2 with orthonormal columns
    Rb = torch.cat([Q, torch.linalg.cross(Q[..., 0], Q[..., 1])[..., None]], -1)
    Bfull = torch.cat([B, torch.linalg.cross(B[..., 0], B[..., 1])[..., None]], -1)
    R = Rb @ Bfull.transpose(-1, -2)
    t = h3 / lam[..., None] - (R @ c[..., :, None])[..., 0]
    return R, t


def _reproj_err(R, t, obj, img):
    """Mean squared reprojection error per candidate [..., K]; 1e12 where
    the pose or the error is not finite."""
    pc = obj[..., None, :, :] @ R.transpose(-1, -2) + t[..., None, :]
    z = pc[..., 2]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    err = ((pc[..., :2] / z[..., None] - img[..., None, :, :]) ** 2).sum(-1).mean(-1)
    finite = torch.isfinite(R).all(dim=(-1, -2)) & torch.isfinite(t).all(dim=-1) & torch.isfinite(err)
    return torch.where(finite, err, torch.full_like(err, 1e12))


def epnp(obj_pts: torch.Tensor, img_pts: torch.Tensor):
    """EPnP pose from [..., N>=4, 3] world points and [..., N, 2] NORMALIZED
    image coords. Returns (rvec [..., 3], tvec [..., 3], ok [...])."""
    dtype = obj_pts.dtype
    obj_pts, img_pts = obj_pts.double(), img_pts.double()
    cw = _control_points(obj_pts)
    alphas = _barycentric(obj_pts, cw)  # [..., N, 4]
    u, v = img_pts[..., 0:1], img_pts[..., 1:2]
    zeros = torch.zeros_like(alphas)
    row_u = torch.cat([alphas, zeros, -u * alphas], -1)
    row_v = torch.cat([zeros, alphas, -v * alphas], -1)
    M = torch.cat([row_u, row_v], -2)[..., _PERM]  # [..., 2N, 12]
    _, vecs = torch.linalg.eigh(_gram(M))
    V = vecs[..., :, :4]  # 4 smallest: the candidate nullspace [..., 12, 4]

    dc = cw[..., _PI, :] - cw[..., _PJ, :]
    rho = (dc * dc).sum(-1)  # [..., 6]
    d1, d2, d3 = (_pair_diffs(V[..., :, i].unflatten(-1, (4, 3))) for i in range(3))

    def dot(a, b):
        return (a * b).sum(-1)

    zero = torch.zeros_like(rho[..., 0])
    # N=1: beta * v1, beta from the distance ratio
    dd1 = dot(d1, d1)
    b1 = torch.sqrt((dd1 * rho).sum(-1) / (dd1 * dd1).sum(-1).clamp(min=1e-12))
    betas1 = torch.stack([b1, zero, zero, zero], -1)
    # N=2: L [6, 3] (b11, b12, b22) = rho in least squares
    L2 = torch.stack([dd1, 2.0 * dot(d1, d2), dot(d2, d2)], -1)
    sol2 = torch.linalg.solve_ex(_gram(L2), L2.transpose(-1, -2) @ rho[..., None])[0][..., 0]
    b11, b12, b22 = sol2[..., 0], sol2[..., 1], sol2[..., 2]
    beta1 = torch.sqrt(b11.abs())
    beta2 = torch.sqrt(b22.abs()) * torch.sign(b12) * torch.sign(b11)
    betas2 = torch.stack([beta1, beta2, zero, zero], -1)
    # N=3: L [6, 6] (b11, b12, b22, b13, b23, b33) = rho
    L3 = torch.stack([dd1, 2.0 * dot(d1, d2), dot(d2, d2), 2.0 * dot(d1, d3), 2.0 * dot(d2, d3),
                      dot(d3, d3)], -1)
    eye6 = 1e-9 * torch.eye(6, dtype=L3.dtype, device=L3.device)
    sol3 = torch.linalg.solve_ex(L3 + eye6, rho[..., None])[0][..., 0]
    c11, c12, c22, c13 = sol3[..., 0], sol3[..., 1], sol3[..., 2], sol3[..., 3]
    g1 = torch.sqrt(c11.abs())
    g2 = torch.sqrt(c22.abs()) * torch.sign(c12) * torch.sign(c11)
    g3 = c13 / g1.clamp(min=1e-12) * torch.sign(c11)
    betas3 = torch.stack([g1, g2, g3, zero], -1)

    Rb, tb = _pose_from_betas(torch.stack([betas1, betas2, betas3], -2), V, alphas, obj_pts)
    Rp, tp = _planar_pose(obj_pts, img_pts)
    Rs = torch.cat([Rb, Rp[..., None, :, :]], -3)  # [..., 4, 3, 3]
    ts = torch.cat([tb, tp[..., None, :]], -2)
    Rs = torch.where(torch.isfinite(Rs), Rs, torch.zeros_like(Rs))
    ts = torch.where(torch.isfinite(ts), ts, torch.zeros_like(ts))
    errs = _reproj_err(Rs, ts, obj_pts, img_pts)
    best = torch.argmin(errs, dim=-1)
    R = torch.gather(Rs, -3, best[..., None, None, None].expand(best.shape + (1, 3, 3)))[..., 0, :, :]
    t = torch.gather(ts, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    ok = torch.gather(errs, -1, best[..., None])[..., 0] < 1e11
    return rodrigues_inv(R).to(dtype), t.to(dtype), ok


def epnp_kernel(obj_pts: torch.Tensor, img_pts: torch.Tensor):
    """RANSAC kernel adapter: (model [..., 6] = rvec|tvec, ok [...])."""
    rv, tv, ok = epnp(obj_pts, img_pts)
    return torch.cat([rv, tv], -1), ok
