"""AP3P slot: the algebraic P3P solver (Lambda-Twist formulation), batched
over leading dimensions (port of opencv_tpu/geometry/ap3p.py).

With unit bearings y_i and depths l_i the camera points l_i y_i keep the
world distances: l^T M_ij l = a_ij. Eliminating the a's gives two
homogeneous quadrics D1, D2; a real root g of the cubic det(D1 + g D2)
makes D1 + g D2 a pair of planes; each plane meets D1 in up to two
directions, a_12 fixes the scale, a few Gauss-Newton steps polish the
depths, and the 3-point Kabsch alignment lifts each to (R, t).

The 3x3 eigenvectors of D1 + g D2 may come back with other signs than in
the JAX package; a sign flip swaps the two planes or the two directions
of a plane, so the set of up to four candidates is the same.
"""

from __future__ import annotations

import torch

from opencv_tpu_torch.geometry.p3p import _kabsch3

# Vandermonde inverse for the nodes {0, 1, -1, 2}: rows give c0..c3
_VINV = [[1.0, 0.0, 0.0, 0.0],
         [-1.0 / 2.0, 1.0, -1.0 / 3.0, -1.0 / 6.0],
         [-1.0, 1.0 / 2.0, 1.0 / 2.0, 0.0],
         [1.0 / 2.0, -1.0 / 2.0, -1.0 / 6.0, 1.0 / 6.0]]


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * x.abs() ** (1.0 / 3.0)


def _where(c, a, b):
    return torch.where(c, a, b if torch.is_tensor(b) else torch.full_like(a, b))


def _cubic_real_root(c3, c2, c1, c0):
    """One real root of c3 g^3 + c2 g^2 + c1 g + c0 (branch-free): Cardano,
    the trigonometric form when there are three real roots, a quadratic
    fallback when c3 ~ 0, then three Newton steps."""
    tiny = 1e-12
    lead = c3.abs() > tiny * (c2.abs() + c1.abs() + c0.abs() + tiny)
    c3s = _where(lead, c3, 1.0)
    p = c2 / c3s
    q = c1 / c3s
    r = c0 / c3s
    # depressed: x^3 + a x + b, g = x - p/3
    a = q - p * p / 3.0
    b = 2.0 * p ** 3 / 27.0 - p * q / 3.0 + r
    disc = (b / 2.0) ** 2 + (a / 3.0) ** 3
    sq = torch.sqrt(disc.clamp(min=0.0))
    x_single = _cbrt(-b / 2.0 + sq) + _cbrt(-b / 2.0 - sq)
    am = a.clamp(max=-tiny)
    rho = 2.0 * torch.sqrt(-am / 3.0)
    arg = (3.0 * b / (am * rho)).clamp(-1.0, 1.0)
    x_trig = rho * torch.cos(torch.acos(arg) / 3.0)
    g = torch.where(disc >= 0.0, x_single, x_trig) - p / 3.0
    # quadratic fallback (c3 ~ 0)
    c2s = _where(c2.abs() > tiny, c2, 1.0)
    qd = torch.sqrt((c1 * c1 - 4.0 * c2 * c0).clamp(min=0.0))
    g_quad = torch.where(c2.abs() > tiny, (-c1 + qd) / (2.0 * c2s),
                         -c0 / _where(c1.abs() > tiny, c1, 1.0))
    g = torch.where(lead, g, g_quad)
    for _ in range(3):
        f = ((c3 * g + c2) * g + c1) * g + c0
        df = (3.0 * c3 * g + 2.0 * c2) * g + c1
        g = g - f / torch.where(df.abs() < tiny, torch.full_like(df, tiny), df)
    return g


def _plane_basis(w: torch.Tensor):
    """Two orthonormal vectors spanning {l : w . l = 0}; w [..., 3]."""
    wn = w / torch.linalg.vector_norm(w, dim=-1, keepdim=True).clamp(min=1e-12)
    e = torch.nn.functional.one_hot(torch.argmin(wn.abs(), dim=-1), 3).to(w.dtype)
    v1 = torch.linalg.cross(wn, e)
    v1 = v1 / torch.linalg.vector_norm(v1, dim=-1, keepdim=True).clamp(min=1e-12)
    return v1, torch.linalg.cross(wn, v1)


def _quad(A, x, y):
    """x^T A y for [..., 3, 3] and [..., 3] vectors."""
    return (x * (A @ y[..., None])[..., 0]).sum(-1)


def ap3p_solutions(obj: torch.Tensor, bearings: torch.Tensor):
    """All algebraic-P3P pose candidates. obj [..., 3, 3] world points,
    bearings [..., 3, 3] unit camera rays. Returns (R [..., 4, 3, 3],
    t [..., 4, 3], valid [..., 4]) with x_cam = R x_world + t."""
    dt, dev = obj.dtype, obj.device
    y0, y1, y2 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]
    b12, b13, b23 = (y0 * y1).sum(-1), (y0 * y2).sum(-1), (y1 * y2).sum(-1)
    a12 = ((obj[..., 0, :] - obj[..., 1, :]) ** 2).sum(-1)
    a13 = ((obj[..., 0, :] - obj[..., 2, :]) ** 2).sum(-1)
    a23 = ((obj[..., 1, :] - obj[..., 2, :]) ** 2).sum(-1)
    one, zero = torch.ones_like(b12), torch.zeros_like(b12)

    def sym(d0, d1, d2, i, j, b):
        rows = [[d0, zero, zero], [zero, d1, zero], [zero, zero, d2]]
        rows[i][j] = rows[j][i] = -b
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    M12 = sym(one, one, zero, 0, 1, b12)
    M13 = sym(one, zero, one, 0, 2, b13)
    M23 = sym(zero, one, one, 1, 2, b23)
    # homogeneous eliminations: l^T D l = 0 on true solutions
    D1 = a23[..., None, None] * M12 - a12[..., None, None] * M23
    D2 = a23[..., None, None] * M13 - a13[..., None, None] * M23
    nodes = torch.tensor([0.0, 1.0, -1.0, 2.0], dtype=dt, device=dev)
    dets = torch.linalg.det(D1[..., None, :, :] + nodes[:, None, None] * D2[..., None, :, :])
    c0, c1, c2, c3 = (torch.tensor(_VINV, dtype=dt, device=dev) @ dets[..., None])[..., 0].unbind(-1)
    g = _cubic_real_root(c3, c2, c1, c0)

    D0 = D1 + g[..., None, None] * D2  # symmetric, (numerically) rank 2
    evals, evecs = torch.linalg.eigh(D0)  # ascending
    s_neg, s_pos = evals[..., 0], evals[..., 2]
    u_neg, u_pos = evecs[..., :, 0], evecs[..., :, 2]
    fact_ok = (s_pos > 0.0) & (s_neg < 0.0)
    sp = torch.sqrt(s_pos.clamp(min=0.0))[..., None]
    sn = torch.sqrt((-s_neg).clamp(min=0.0))[..., None]
    planes = torch.stack([sp * u_pos + sn * u_neg, sp * u_pos - sn * u_neg], -2)  # [..., 2, 3]

    # up to two projective directions in each plane that meet D1
    v1, v2 = _plane_basis(planes)
    D1p = D1[..., None, :, :]
    A, B, C = _quad(D1p, v1, v1), _quad(D1p, v1, v2), _quad(D1p, v2, v2)
    disc = B * B - A * C
    real = disc >= 0.0
    sq = torch.sqrt(disc.clamp(min=0.0))
    As = _where(A.abs() > 1e-12, A, 1.0)
    lin = A.abs() <= 1e-12
    r1 = torch.where(lin, -C / _where(B.abs() > 1e-12, 2.0 * B, 1.0), (-B + sq) / As)
    r2 = torch.where(lin, torch.zeros_like(A), (-B - sq) / As)
    d1 = r1[..., None] * v1 + v2
    d2 = torch.where(lin[..., None], v1, r2[..., None] * v1 + v2)  # A ~ 0: v1 is a root
    dirs = torch.stack([d1, d2], -2).flatten(-3, -2)  # [..., 4, 3]: plane p then plane q
    oks = torch.stack([real | lin, real], -1).flatten(-2) & fact_ok[..., None]

    # orient so depths can be positive, scale by a12, polish
    Ms = [M[..., None, :, :] for M in (M12, M13, M23)]
    avals = [a[..., None] for a in (a12, a13, a23)]
    d = dirs * torch.where(dirs.sum(-1) < 0.0, -1.0, 1.0)[..., None]
    m = _quad(Ms[0], d, d)
    lam = torch.sqrt(avals[0] / _where(m > 1e-12, m, 1.0))[..., None] * d
    oks = oks & (m > 1e-12) & (lam > 1e-9).all(dim=-1)
    eye = 1e-12 * torch.eye(3, dtype=dt, device=dev)
    for _ in range(4):
        f = torch.stack([_quad(M, lam, lam) - a for M, a in zip(Ms, avals)], -1)
        Jm = 2.0 * torch.stack([(M @ lam[..., None])[..., 0] for M in Ms], -2) + eye
        step = torch.linalg.solve_ex(Jm, f[..., None])[0][..., 0]
        lam = (lam - step).clamp(min=1e-9)  # never leave the positive octant
    Y = lam[..., None] * bearings[..., None, :, :]
    R, t = _kabsch3(Y, obj[..., None, :, :].expand_as(Y))
    oks = oks & torch.isfinite(R).all(dim=(-1, -2)) & torch.isfinite(t).all(dim=-1)
    return R, t, oks


def ap3p_kernel(obj: torch.Tensor, img: torch.Tensor):
    """RANSAC minimal kernel: AP3P on points 0-2, disambiguated by point 3,
    then three Gauss-Newton steps on all four. obj [..., 4, 3], img
    [..., 4, 2] normalized. Returns (model [..., 6] = rvec|tvec, ok)."""
    from opencv_tpu_torch.geometry.pnp import gn_refine_pose
    from opencv_tpu_torch.geometry.rotation import rodrigues_inv

    rays = torch.cat([img[..., :3, :], torch.ones_like(img[..., :3, :1])], dim=-1)
    rays = rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)
    R, t, valid = ap3p_solutions(obj[..., :3, :], rays)
    pc = torch.einsum("...rij,...j->...ri", R, obj[..., 3, :]) + t
    z = pc[..., 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    e = ((pc[..., :2] / zs[..., None] - img[..., None, 3, :]) ** 2).sum(-1)
    errs = torch.where(valid & (z > 1e-6), e, torch.full_like(e, float("inf")))
    best = torch.argmin(errs, dim=-1)
    ok = torch.isfinite(torch.gather(errs, -1, best[..., None])[..., 0])
    Rb = torch.gather(R, -3, best[..., None, None, None].expand(best.shape + (1, 3, 3)))[..., 0, :, :]
    tb = torch.gather(t, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    rvec, tvec = gn_refine_pose(rodrigues_inv(Rb), tb, obj, img, torch.ones_like(obj[..., 0]), iters=3)
    model = torch.cat([rvec, tvec], dim=-1)
    ok &= torch.isfinite(model).all(dim=-1)
    return torch.where(ok[..., None], model, torch.zeros_like(model)), ok
