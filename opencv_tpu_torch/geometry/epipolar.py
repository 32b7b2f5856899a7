"""Two-view epipolar geometry (port of opencv_tpu/geometry/epipolar.py):
8-point essential estimation with RANSAC, IRLS refit and Sampson
Gauss-Newton polish, the 5-point RANSAC, E decomposition, recoverPose,
DLT triangulation and optimal match correction. Batched over leading
dimensions.

Numerics follow the JAX package: the minimal-sample nullspace is the last
column(s) of a Householder QR of A^T (written out here, so a batch of 1024
small factorizations is a few dozen batched tensor ops), overdetermined
fits take the SVD, and the 3x3 SVDs are the same one-sided Jacobi.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from opencv_tpu_torch.core.config import RansacConfig
from opencv_tpu_torch.geometry import ransac as ransac_mod
from opencv_tpu_torch.geometry.rotation import solve3


def normalize_pixels(pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel coords [..., 2] -> normalized camera coords (x - c) / f."""
    return torch.stack(
        [(pts[..., 0] - K[0, 2]) / K[0, 0], (pts[..., 1] - K[1, 2]) / K[1, 1]], dim=-1
    )


def _hartley_normalize(
    pts: torch.Tensor, w: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Centre + isotropic scale to mean distance sqrt(2). pts [..., N, 2];
    optional 0/1 weights [..., N]. Returns (normalized, T [..., 3, 3])."""
    if w is None:
        mean = pts.mean(dim=-2)
        d = torch.sqrt(((pts - mean[..., None, :]) ** 2).sum(-1))
        md = d.mean(dim=-1)
    else:
        wsum = w.sum(dim=-1).clamp(min=1e-12)
        mean = (pts * w[..., None]).sum(dim=-2) / wsum[..., None]
        d = torch.sqrt(((pts - mean[..., None, :]) ** 2).sum(-1))
        md = (d * w).sum(dim=-1) / wsum
    scale = math.sqrt(2.0) / md.clamp(min=1e-12)
    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    T = torch.stack(
        [
            torch.stack([scale, zero, -scale * mean[..., 0]], -1),
            torch.stack([zero, scale, -scale * mean[..., 1]], -1),
            torch.stack([zero, zero, one], -1),
        ],
        -2,
    )
    return (pts - mean[..., None, :]) * scale[..., None, None], T


def _householder_null(A: torch.Tensor, cols: int = 1) -> torch.Tensor:
    """The last `cols` columns of the complete QR of A^T for A [..., m, k],
    m < k: the exact nullspace of a minimal sample. [..., k] for one
    column, else [..., k, cols]. Reflectors follow LAPACK's convention
    (v = x + sign(x0) |x| e1), so every device builds the same basis."""
    m, k = A.shape[-2], A.shape[-1]
    X = A.transpose(-1, -2).clone()  # [..., k, m]
    vs = []
    for j in range(m):
        x = X[..., j:, j]
        alpha = torch.linalg.vector_norm(x, dim=-1)
        sign = torch.where(x[..., 0] >= 0, 1.0, -1.0)
        v = x.clone()
        v[..., 0] = v[..., 0] + sign * alpha
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp(min=1e-30)
        sub = X[..., j:, j:]
        X[..., j:, j:] = sub - 2.0 * v[..., :, None] * (v[..., None, :] @ sub)
        vs.append(v)
    q = torch.zeros(A.shape[:-2] + (k, cols), dtype=A.dtype, device=A.device)
    q[..., k - cols :, :] = torch.eye(cols, dtype=A.dtype, device=A.device)
    for j in reversed(range(m)):
        v = vs[j][..., :, None]
        tail = q[..., j:, :]
        q[..., j:, :] = tail - 2.0 * v * (v * tail).sum(-2, keepdim=True)
    return q[..., 0] if cols == 1 else q


def _nullspace(A: torch.Tensor) -> torch.Tensor:
    """Right singular vector of the smallest singular value of [..., M, K]:
    Householder QR for minimal samples (M < K), SVD otherwise."""
    m, k = A.shape[-2], A.shape[-1]
    if m < k:
        return _householder_null(A)
    return torch.linalg.svd(A, full_matrices=False).Vh[..., -1, :]


def _svd3_top2(A: torch.Tensor, sweeps: int = 6):
    """Leading two singular triplets of [..., 3, 3] by one-sided Jacobi.
    Returns (u0, u1, s0, s1, v0, v1) with s0 >= s1."""
    V = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    b = [A[..., :, 0], A[..., :, 1], A[..., :, 2]]
    v = [V[..., :, 0], V[..., :, 1], V[..., :, 2]]
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            bp, bq = b[p], b[q]
            app = (bp * bp).sum(-1)
            aqq = (bq * bq).sum(-1)
            apq = (bp * bq).sum(-1)
            d = aqq - app
            sgn = torch.where(d >= 0.0, 1.0, -1.0)
            t = sgn * 2.0 * apq / (d.abs() + torch.sqrt(d * d + 4.0 * apq * apq) + 1e-30)
            c = (1.0 / torch.sqrt(1.0 + t * t))[..., None]
            s = (t * c[..., 0])[..., None]
            b[p], b[q] = c * bp - s * bq, s * bp + c * bq
            vp, vq = v[p], v[q]
            v[p], v[q] = c * vp - s * vq, s * vp + c * vq
    norms = [torch.sqrt((x * x).sum(-1).clamp(min=0.0)) for x in b]

    def cswap(i, j):
        swap = norms[j] > norms[i]
        sw = swap[..., None]
        b[i], b[j] = torch.where(sw, b[j], b[i]), torch.where(sw, b[i], b[j])
        v[i], v[j] = torch.where(sw, v[j], v[i]), torch.where(sw, v[i], v[j])
        norms[i], norms[j] = torch.where(swap, norms[j], norms[i]), torch.where(swap, norms[i], norms[j])

    cswap(0, 1)
    cswap(0, 2)
    cswap(1, 2)
    u0 = b[0] / norms[0].clamp(min=1e-20)[..., None]
    u1 = b[1] / norms[1].clamp(min=1e-20)[..., None]
    return u0, u1, norms[0], norms[1], v[0], v[1]


def _epipolar_design(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Rows of the DLT system for x2^T E x1 = 0. [..., N, 9]."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = torch.ones_like(u1)
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], dim=-1)


def _outer2(u0, u1, v0, v1, s0, s1):
    return (s0[..., None, None] * u0[..., :, None] * v0[..., None, :]
            + s1[..., None, None] * u1[..., :, None] * v1[..., None, :])


def enforce_essential(E: torch.Tensor) -> torch.Tensor:
    """Project onto the essential manifold: singular values -> (s, s, 0)."""
    u0, u1, s0, s1, v0, v1 = _svd3_top2(E)
    m = (s0 + s1) * 0.5
    return m[..., None, None] * (u0[..., :, None] * v0[..., None, :] + u1[..., :, None] * v1[..., None, :])


def enforce_rank2(F: torch.Tensor) -> torch.Tensor:
    """Rank-2 projection keeping singular values."""
    u0, u1, s0, s1, v0, v1 = _svd3_top2(F)
    return _outer2(u0, u1, v0, v1, s0, s1)


def eight_point(
    x1: torch.Tensor, x2: torch.Tensor, essential: bool = True,
    weights: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized 8-point algorithm on [..., N>=8, 2] correspondences.
    Returns (E_or_F [..., 3, 3] unit Frobenius norm, ok [...])."""
    x1n, T1 = _hartley_normalize(x1, weights)
    x2n, T2 = _hartley_normalize(x2, weights)
    A = _epipolar_design(x1n, x2n)
    if weights is not None:
        A = A * weights[..., None]
    En = _nullspace(A).reshape(A.shape[:-2] + (3, 3))
    if essential:
        # denormalize FIRST: only the original frame is essential
        E = enforce_essential(T2.transpose(-1, -2) @ En @ T1)
    else:
        E = T2.transpose(-1, -2) @ enforce_rank2(En) @ T1
    nrm = torch.linalg.matrix_norm(E)
    ok = (nrm > 1e-12) & torch.isfinite(E).all(dim=(-1, -2))
    return E / nrm.clamp(min=1e-12)[..., None, None], ok


def sampson_error(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance. E [..., 3, 3], x1/x2 [N, 2] -> [..., N]."""
    ones = torch.ones_like(x1[..., :1])
    p1 = torch.cat([x1, ones], dim=-1)
    p2 = torch.cat([x2, ones], dim=-1)
    Ex1 = torch.matmul(p1, E.transpose(-1, -2))
    Etx2 = torch.matmul(p2, E)
    num = (p2 * Ex1).sum(-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / den.clamp(min=1e-12)


def triangulate_normalized(
    R: torch.Tensor, t: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> torch.Tensor:
    """Linear triangulation for P1 = [I|0], P2 = [R|t] (R [..., 3, 3],
    t [..., 3]) of normalized points [N, 2] -> cam-1 points [..., N, 3],
    by the inhomogeneous 3x3 normal equations (cv::triangulatePoints)."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    P1 = torch.cat([eye, torch.zeros((3, 1), dtype=R.dtype, device=R.device)], dim=1)
    P2 = torch.cat([R, t[..., :, None]], dim=-1)  # [..., 3, 4]

    def rows(P, x):
        P = P[..., None, :, :]
        return torch.stack(
            [x[..., 0, None] * P[..., 2, :] - P[..., 0, :],
             x[..., 1, None] * P[..., 2, :] - P[..., 1, :]], dim=-2,
        )  # [..., N, 2, 4]

    r1 = rows(P1, x1)
    r2 = rows(P2, x2)
    A = torch.cat([r1.expand(r2.shape), r2], dim=-2)  # [..., N, 4, 4]
    B = A[..., :3]
    a = A[..., 3]
    BtB = torch.einsum("...ki,...kj->...ij", B, B)
    Bta = torch.einsum("...ki,...k->...i", B, a)
    tr = BtB[..., 0, 0] + BtB[..., 1, 1] + BtB[..., 2, 2]
    return solve3(BtB + (1e-8 * tr)[..., None, None] * eye, -Bta)


def decompose_essential(E: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """E -> (R1, R2, t): R1 = U W V^T, R2 = U W^T V^T, t = u3, with U, V
    completed right-handed from the top-2 Jacobi triplets."""
    u0, u1, _, _, v0, v1 = _svd3_top2(E)
    u = torch.stack([u0, u1, torch.linalg.cross(u0, u1)], dim=-1)
    vt = torch.stack([v0, v1, torch.linalg.cross(v0, v1)], dim=-2)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    return u @ W @ vt, u @ W.T @ vt, u[..., :, 2]


def _correction_cost(t, f1, f2, a, b, c, d):
    """HZ 12.1's squared distance s(t) of a match to the epipolar pencil."""
    num1 = t * t / (1.0 + f1 * f1 * t * t)
    den2 = (a * t + b) ** 2 + f2 * f2 * (c * t + d) ** 2
    return num1 + (c * t + d) ** 2 / den2.clamp(min=1e-20)


def correct_matches(
    F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
    n_grid: int = 64, newton_iters: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Optimal two-view correction (HZ algorithm 12.1, cv::correctMatches):
    move each match [N, 2] the least total squared distance onto
    x2^T F x1 = 0. The cost s(t) is minimized over a tan-space grid of
    `n_grid` samples, then `newton_iters` guarded Newton steps (derivatives
    by torch.func.grad), and compared with the t = inf branch."""
    dt, dev = F.dtype, F.device
    one = torch.ones_like(x1[:, 0])
    zero = torch.zeros_like(one)

    def shift(p):
        return torch.stack([torch.stack([one, zero, p[:, 0]], -1),
                            torch.stack([zero, one, p[:, 1]], -1),
                            torch.stack([zero, zero, one], -1)], -2)

    def rot(e):
        return torch.stack([torch.stack([e[:, 0], e[:, 1], zero], -1),
                            torch.stack([-e[:, 1], e[:, 0], zero], -1),
                            torch.stack([zero, zero, one], -1)], -2)

    T1, T2 = shift(x1), shift(x2)
    Fp = T2.transpose(-1, -2) @ F @ T1
    U, _, Vh = torch.linalg.svd(Fp)
    e1, e2 = Vh[:, -1, :], U[:, :, -1]  # right and left epipoles
    e1 = e1 / torch.sqrt(e1[:, 0] ** 2 + e1[:, 1] ** 2).clamp(min=1e-12)[:, None]
    e2 = e2 / torch.sqrt(e2[:, 0] ** 2 + e2[:, 1] ** 2).clamp(min=1e-12)[:, None]
    R1, R2 = rot(e1), rot(e2)
    Fr = R2 @ Fp @ R1.transpose(-1, -2)
    prm = (e1[:, 2], e2[:, 2], Fr[:, 1, 1], Fr[:, 1, 2], Fr[:, 2, 1], Fr[:, 2, 2])
    f1, f2, a, b, c, d = prm

    theta = torch.linspace(-math.pi / 2 * 0.999, math.pi / 2 * 0.999, n_grid, dtype=dt, device=dev)
    ts = torch.tan(theta)
    cs = _correction_cost(ts[None, :], *(p[:, None] for p in prm))
    t = ts[torch.argmin(cs, dim=1)]
    dc = torch.func.grad(_correction_cost)
    d1 = torch.func.vmap(dc)
    d2 = torch.func.vmap(torch.func.grad(dc))
    for _ in range(newton_iters):
        h = d2(t, *prm)
        step = (d1(t, *prm) / torch.where(h.abs() < 1e-12, torch.full_like(h, 1e-12), h)).clamp(-1e3, 1e3)
        tn = t - step
        t = torch.where(_correction_cost(tn, *prm) < _correction_cost(t, *prm), tn, t)
    cinf = 1.0 / (f1 * f1).clamp(min=1e-20) + c * c / (a * a + f2 * f2 * c * c).clamp(min=1e-20)
    use_inf = (cinf < _correction_cost(t, *prm))[:, None]
    # closest points on l1(t) = (t f1, 1, -t) and l2(t) = Fr (0, t, 1)
    l1 = torch.where(use_inf, torch.stack([f1, zero, -one], -1), torch.stack([t * f1, one, -t], -1))
    xh = torch.where(use_inf, torch.stack([zero, one, zero], -1), torch.stack([zero, t, one], -1))
    l2 = (Fr @ xh[:, :, None])[:, :, 0]

    def closest_to_origin(l):
        s = (l[:, 0] ** 2 + l[:, 1] ** 2).clamp(min=1e-20)
        return torch.stack([-l[:, 0] * l[:, 2] / s, -l[:, 1] * l[:, 2] / s, one], -1)

    q1 = (T1 @ R1.transpose(-1, -2) @ closest_to_origin(l1)[:, :, None])[:, :, 0]
    q2 = (T2 @ R2.transpose(-1, -2) @ closest_to_origin(l2)[:, :, None])[:, :, 0]
    return q1[:, :2] / q1[:, 2:], q2[:, :2] / q2[:, 2:]


class RecoveredPose(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    mask: torch.Tensor  # [N] bool: inliers passing cheirality
    n_good: torch.Tensor


def recover_pose(
    E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
    mask: torch.Tensor | None = None, distance_thresh: float = 50.0,
) -> RecoveredPose:
    """The (R, t) with maximal cheirality support among the four
    decompositions of E (five-point.cpp:461-641)."""
    if mask is None:
        mask = torch.ones(x1.shape[0], dtype=torch.bool, device=x1.device)
    R1, R2, t = decompose_essential(E)
    Rs = torch.stack([R1, R1, R2, R2])
    ts = torch.stack([t, -t, t, -t])
    X = triangulate_normalized(Rs, ts, x1, x2)  # [4, N, 3]
    z1 = X[..., 2]
    z2 = (X @ Rs.transpose(-1, -2) + ts[:, None, :])[..., 2]
    good = (z1 > 0) & (z2 > 0) & (z1 < distance_thresh) & (z2 < distance_thresh) & mask
    counts = good.sum(dim=-1)
    best = torch.argmax(counts)
    return RecoveredPose(R=Rs[best], t=ts[best], mask=good[best], n_good=counts[best])


def _sampson_gn_refine(
    E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor,
    thr2: float = 1.0, iters: int = 4,
) -> torch.Tensor:
    """Gauss-Newton on the signed Sampson residual over vec(E) with
    Tukey-style IRLS weights at the inlier threshold, projected back onto
    the essential manifold (jacobian by torch.func.jacfwd)."""
    ones = torch.ones_like(x1[..., :1])
    p1 = torch.cat([x1, ones], -1)
    p2 = torch.cat([x2, ones], -1)

    def residuals(e):
        Em = e.reshape(3, 3)
        Ex1 = p1 @ Em.T
        Etx2 = p2 @ Em
        num = (p2 * Ex1).sum(-1)
        den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
        return w * num / torch.sqrt(den.clamp(min=1e-12))

    e = E.reshape(-1)
    eye9 = 1e-8 * torch.eye(9, dtype=E.dtype, device=E.device)
    for _ in range(iters):
        r_cur = residuals(e)
        rw = (1.0 - (r_cur * r_cur) / max(thr2, 1e-12)).clamp(0.0, 1.0)
        rw = rw * rw

        def wres(ev, rw=rw):
            return residuals(ev) * rw

        r = wres(e)
        J = torch.func.jacfwd(wres)(e)  # [N, 9]
        H = J.T @ J + eye9
        g = J.T @ r
        e_new = e - torch.linalg.solve_ex(H, g[:, None])[0][:, 0]
        e_new = e_new / torch.linalg.vector_norm(e_new).clamp(min=1e-12)
        e = torch.where(torch.isfinite(e_new).all(), e_new, e)
    return enforce_essential(e.reshape(3, 3))


def find_essential_ransac(
    gen: torch.Generator | None,
    x1: torch.Tensor,
    x2: torch.Tensor,
    valid: torch.Tensor | None = None,
    cfg: RansacConfig = RansacConfig(threshold=1e-3),
    adaptive: bool = True,
    subsets: torch.Tensor | None = None,
) -> ransac_mod.RansacResult:
    """findEssentialMat analog on normalized coords; cfg.threshold is the
    LINEAR Sampson bound. RANSAC with the 8-point kernel, then two
    all-inlier refits and a robust Sampson Gauss-Newton polish, accepted
    unless it collapses the support. `subsets` [H, 8] injects samples."""
    n = x1.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=x1.device)
    thr2 = cfg.threshold * cfg.threshold
    cfg2 = RansacConfig(
        n_hypotheses=cfg.n_hypotheses, threshold=thr2, confidence=cfg.confidence, seed=cfg.seed
    )

    def model_fn(idx):
        return eight_point(x1[idx], x2[idx], essential=True)

    def error_fn(E):
        return sampson_error(E, x1, x2)

    if adaptive and subsets is None:
        res = ransac_mod.ransac_adaptive(gen, n, valid, 8, model_fn, error_fn, cfg2)
    else:
        res = ransac_mod.ransac(gen, n, valid, 8, model_fn, error_fn, cfg2, subsets=subsets)

    inliers = res.inliers
    E = res.model
    for _ in range(2):
        E_ref, ok_ref = eight_point(x1, x2, essential=True, weights=inliers.to(x1.dtype))
        new_inliers = (sampson_error(E_ref, x1, x2) < thr2) & valid
        better = ok_ref & (new_inliers.sum() >= inliers.sum())
        E = torch.where(better, E_ref, E)
        inliers = torch.where(better, new_inliers, inliers)
    E_gn = _sampson_gn_refine(E, x1, x2, inliers.to(x1.dtype), thr2=thr2)
    inl_gn = (sampson_error(E_gn, x1, x2) < thr2) & valid
    n_in = inliers.sum()
    keep_gn = torch.isfinite(E_gn).all() & (
        inl_gn.sum() >= torch.clamp((n_in * 4) // 5, min=8)
    )
    E = torch.where(keep_gn, E_gn, E)
    inliers = torch.where(keep_gn, inl_gn, inliers)
    return ransac_mod.RansacResult(model=E, inliers=inliers, n_inliers=inliers.sum(), ok=res.ok)


def find_essential_ransac_5pt(
    gen: torch.Generator | None,
    x1: torch.Tensor,
    x2: torch.Tensor,
    valid: torch.Tensor | None = None,
    cfg: RansacConfig = RansacConfig(threshold=1e-3),
    subsets: torch.Tensor | None = None,
) -> ransac_mod.RansacResult:
    """findEssentialMat with the 5-point minimal kernel
    (geometry/five_point.py) on normalized coords; cfg.threshold is the
    LINEAR Sampson bound. Every candidate of every subset (H x 10) is
    Sampson-scored in one batch; argmax ties go to the first candidate.
    Then two all-inlier 8-point refits. `subsets` [H, 5] injects samples."""
    from opencv_tpu_torch.geometry.five_point import five_point

    n = x1.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=x1.device)
    thr2 = cfg.threshold * cfg.threshold
    if subsets is None:
        subsets = ransac_mod.sample_subsets(gen, n, valid, cfg.n_hypotheses, 5)
    res = five_point(x1[subsets], x2[subsets])
    Es = res.E.reshape(-1, 3, 3)  # [H*10, 3, 3]
    inlier_mat = (sampson_error(Es, x1, x2) < thr2) & valid[None, :]
    scores = torch.where(res.valid.reshape(-1), inlier_mat.sum(dim=1), -1)
    best = torch.argmax(scores)
    E = Es[best]
    inliers = inlier_mat[best]
    ok = scores[best] >= 5
    for _ in range(2):
        E_ref, ok_ref = eight_point(x1, x2, essential=True, weights=inliers.to(x1.dtype))
        new_inliers = (sampson_error(E_ref, x1, x2) < thr2) & valid
        better = ok_ref & (new_inliers.sum() >= inliers.sum())
        E = torch.where(better, E_ref, E)
        inliers = torch.where(better, new_inliers, inliers)
    return ransac_mod.RansacResult(model=E, inliers=inliers, n_inliers=inliers.sum(), ok=ok)
