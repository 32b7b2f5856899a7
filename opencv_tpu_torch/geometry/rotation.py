"""Rotation parameterizations (port of opencv_tpu/geometry/rotation.py).

All functions take batched [..., 3] / [..., 3, 3] tensors. The guarded
closed forms (torch.where on small-angle branches) keep
`torch.func.jacfwd` through them finite at theta = 0.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [...,3] -> [...,3,3] with hat(v) @ x = v x x."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zeros = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zeros, -z, y], dim=-1),
            torch.stack([z, zeros, -x], dim=-1),
            torch.stack([-y, x, zeros], dim=-1),
        ],
        dim=-2,
    )


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle [...,3] -> rotation [...,3,3]:
    R = I + sinc(theta) K + (1 - cos theta)/theta^2 K^2, K = hat(rvec)."""
    theta2 = torch.sum(rvec * rvec, dim=-1)[..., None, None]
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    k = hat(rvec)
    k2 = k @ k
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2.clamp(min=1e-16))
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(k.shape)
    return eye + a * k + b * k2


def rodrigues_inv(R: torch.Tensor) -> torch.Tensor:
    """Rotation [...,3,3] -> axis-angle [...,3] (log map), theta by atan2."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    w = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    s2 = torch.sum(w * w, dim=-1)
    small = s2 < 1e-12
    one = torch.ones_like(s2)
    s_safe = torch.sqrt(torch.where(small, one, s2))
    theta = torch.atan2(torch.where(small, torch.zeros_like(s2), s_safe), tr - 1.0)
    scale = torch.where(
        small,
        0.5 + s2 / 24.0,
        theta / torch.where(small, one, 2.0 * torch.sin(theta) + 1e-30),
    )
    near_pi = theta > math.pi - 1e-3
    axis2 = ((torch.diagonal(R, dim1=-2, dim2=-1) + 1.0) * 0.5).clamp(0.0, 1.0)
    axis = torch.sqrt(axis2)
    signs = torch.where(w < 0, -1.0, 1.0)
    pi_vec = axis * signs * theta[..., None]
    return torch.where(near_pi[..., None], pi_vec, w * scale[..., None])


def rodrigues_jacobian(rvec: torch.Tensor) -> torch.Tensor:
    """dR/drvec of `rodrigues`: [..., 3] -> [..., 3, 3, 3] (last index =
    rvec component), by torch.func.jacfwd of the guarded closed form."""
    flat = rvec.reshape(-1, 3)
    jac = torch.func.vmap(torch.func.jacfwd(rodrigues))(flat)
    return jac.reshape(rvec.shape[:-1] + (3, 3, 3))


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of [..., 3, 3]."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    Fv = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(det.abs() < 1e-20, torch.full_like(det, 1e-20), det)
    adj = torch.stack(
        [torch.stack([A, B, C], -1), torch.stack([D, E, Fv], -1), torch.stack([G, H, I], -1)], -2
    )
    return adj / det[..., None, None]


def solve3(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 solve via the adjugate inverse. M [...,3,3], b [...,3]."""
    return torch.einsum("...ij,...j->...i", _inv3(M), b)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (w, x, y, z) -> rotation [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


def project_to_rotation(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation (Frobenius) without an SVD: Horn's quaternion
    matrix, its largest eigenvalue by QCP's Newton iteration on the
    characteristic quartic, the eigenvector as the dominant column of
    adj(K - lambda I). Proper (det +1) and safe on rank-2 inputs."""
    dtype = M.dtype
    H = M.to(torch.float32)
    sxx, sxy, sxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    syx, syy, syz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    szx, szy, szz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    K = torch.stack(
        [
            torch.stack([sxx + syy + szz, szy - syz, sxz - szx, syx - sxy], -1),
            torch.stack([szy - syz, sxx - syy - szz, sxy + syx, sxz + szx], -1),
            torch.stack([sxz - szx, sxy + syx, syy - sxx - szz, syz + szy], -1),
            torch.stack([syx - sxy, sxz + szx, syz + szy, szz - sxx - syy], -1),
        ],
        -2,
    )
    K2 = K @ K
    p2 = torch.diagonal(K2, dim1=-2, dim2=-1).sum(-1)
    p3 = torch.diagonal(K2 @ K, dim1=-2, dim2=-1).sum(-1)
    p4 = torch.diagonal(K2 @ K2, dim1=-2, dim2=-1).sum(-1)
    c2 = -0.5 * p2
    c1 = -p3 / 3.0
    c0 = p2 * p2 / 8.0 - p4 / 4.0
    lam = torch.sqrt(p2.clamp(min=1e-20))
    for _ in range(25):
        f = ((lam * lam + c2) * lam + c1) * lam + c0
        fp = (4.0 * lam * lam + 2.0 * c2) * lam + c1
        lam = lam - f / torch.where(fp.abs() < 1e-12, torch.full_like(fp, 1e-12), fp)

    A = K - lam[..., None, None] * torch.eye(4, dtype=torch.float32, device=M.device)

    def det3(r0, r1, r2, cs):
        a, b, c = cs
        return (
            A[..., r0, a] * (A[..., r1, b] * A[..., r2, c] - A[..., r1, c] * A[..., r2, b])
            - A[..., r0, b] * (A[..., r1, a] * A[..., r2, c] - A[..., r1, c] * A[..., r2, a])
            + A[..., r0, c] * (A[..., r1, a] * A[..., r2, b] - A[..., r1, b] * A[..., r2, a])
        )

    adj_cols = []
    for j in range(4):
        rsub = [r for r in range(4) if r != j]
        col = []
        for i in range(4):
            csub = tuple(c for c in range(4) if c != i)
            col.append((-1.0) ** (i + j) * det3(rsub[0], rsub[1], rsub[2], csub))
        adj_cols.append(torch.stack(col, -1))
    cand = torch.stack(adj_cols, -1)  # [..., 4(vec), 4(col)]
    nrm2 = torch.sum(cand * cand, dim=-2)
    best = torch.argmax(nrm2, dim=-1)
    q = torch.gather(cand, -1, best[..., None, None].expand(cand.shape[:-1] + (1,)))[..., 0]
    qn = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float32, device=M.device)
    q = torch.where(qn > 1e-12, q / qn.clamp(min=1e-20), ident)
    return quat_to_matrix(q).to(dtype)
