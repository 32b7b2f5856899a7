"""Plain reference of global bundle adjustment: Levenberg-Marquardt over
6-parameter cameras (axis-angle, translation) and 3-D points, with Huber
weights, a Schur complement on the camera blocks solved by 60
iterations of block-Jacobi-preconditioned CG, and
OpenCV's accept/reject schedule (levmarq.cpp: lambda / 3 on a decrease,
x 4 otherwise, clamped to [1e-10, 1e10]).

Written from those equations alone: it imports nothing of the program
under test, and takes only the generated problem (the inputs both sides
get). The Rodrigues derivative is the closed form of Gallego and Yezzi
(J. Math. Imaging Vis. 2015), not a derivative taken by autograd.

`Arith` sets the arithmetic: float64 for the reference, or a lower
precision for the control. With `tf32=True` the operands of every product
(each einsum) are rounded to TF32's 10-bit mantissa, as the tensor cores
do, and the products accumulate in float32.
"""

from __future__ import annotations

import torch


class Arith:
    """Working dtype, and whether products take TF32 operands."""

    def __init__(self, dtype: torch.dtype = torch.float64, tf32: bool = False):
        if tf32 and dtype != torch.float32:
            raise ValueError("TF32 rounding applies to float32 operands")
        self.dtype = dtype
        self.tf32 = tf32

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if not self.tf32:
            return x
        i = x.contiguous().view(torch.int32)
        return ((i + 0x1000) & ~0x1FFF).view(torch.float32)

    def ein(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *[self.round(o) for o in ops])


def hat(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def rodrigues(v: torch.Tensor, ar: Arith) -> torch.Tensor:
    """[C,3] axis-angle -> [C,3,3]."""
    th2 = (v * v).sum(-1)[:, None, None]
    th = torch.sqrt(th2)
    small = th2 < 1e-12
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / torch.where(small, 1.0, th))
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / torch.where(small, 1.0, th2))
    K = hat(v)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return eye + a * K + b * ar.ein("cij,cjk->cik", K, K)


def rodrigues_derivative(v: torch.Tensor, R: torch.Tensor, ar: Arith) -> torch.Tensor:
    """dR/dv_i as [C,3,3,3], last index i: (v_i [v]x + [v x (I - R) e_i]x) R / |v|^2,
    and [e_i]x at the identity."""
    th2 = (v * v).sum(-1)
    small = th2 < 1e-12
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    out = []
    for i in range(3):
        col = eye[:, i] - R[:, :, i]
        term = v[:, i, None, None] * hat(v) + hat(torch.linalg.cross(v, col))
        dRi = ar.ein("cij,cjk->cik", term, R) / torch.where(small, 1.0, th2)[:, None, None]
        out.append(torch.where(small[:, None, None], hat(eye[i].expand_as(v)), dRi))
    return torch.stack(out, -1)


def _project(R, t, X, ar: Arith):
    pc = ar.ein("oij,oj->oi", R, X) + t
    z = pc[:, 2]
    guard = z.abs() < 1e-9
    zs = torch.where(guard, torch.full_like(z, 1e-9), z)
    return pc[:, :2] / zs[:, None], zs, guard


def residuals(p: dict, ar: Arith) -> torch.Tensor:
    """[O,2] reprojection residuals, zero on invalid observations."""
    R = rodrigues(p["cam_rvec"], ar)
    uv, _, _ = _project(R[p["obs_cam"]], p["cam_tvec"][p["obs_cam"]], p["points"][p["obs_pt"]], ar)
    r = uv - p["obs_uv"]
    return torch.where(p["obs_valid"][:, None], r, torch.zeros_like(r))


def cost(p: dict, ar: Arith) -> torch.Tensor:
    r = residuals(p, ar)
    return 0.5 * (r * r).sum()


def normal_equations(p: dict, huber_delta, ar: Arith):
    """Huber-weighted blocks: U [C,6,6], V [P,3,3], bc [C,6], bp [P,3] and
    the per-observation coupling A [O,6,3] = Jc^T Jp."""
    cam, pt = p["obs_cam"], p["obs_pt"]
    C, P = p["cam_rvec"].shape[0], p["points"].shape[0]
    R = rodrigues(p["cam_rvec"], ar)
    dR = rodrigues_derivative(p["cam_rvec"], R, ar)
    Ro, X = R[cam], p["points"][pt]
    uv, zs, guard = _project(Ro, p["cam_tvec"][cam], X, ar)
    r = uv - p["obs_uv"]
    iz = 1.0 / zs
    o = torch.zeros_like(zs)
    duz = torch.where(guard[:, None], torch.zeros_like(uv), -uv / zs[:, None])
    dproj = torch.stack([torch.stack([iz, o, duz[:, 0]], -1), torch.stack([o, iz, duz[:, 1]], -1)], -2)
    dpc_dr = ar.ein("oijk,oj->oik", dR[cam], X)
    Jc = torch.cat([ar.ein("oij,ojk->oik", dproj, dpc_dr), dproj], -1)
    Jp = ar.ein("oij,ojk->oik", dproj, Ro)
    w = p["obs_valid"].to(r.dtype)
    if huber_delta is not None:
        w = w * torch.sqrt(torch.clamp(huber_delta / torch.sqrt((r * r).sum(-1) + 1e-18), max=1.0))
    r, Jc, Jp = r * w[:, None], Jc * w[:, None, None], Jp * w[:, None, None]
    dt, dev = r.dtype, r.device
    U = torch.zeros((C, 6, 6), dtype=dt, device=dev).index_add_(0, cam, ar.ein("oij,oik->ojk", Jc, Jc))
    V = torch.zeros((P, 3, 3), dtype=dt, device=dev).index_add_(0, pt, ar.ein("oij,oik->ojk", Jp, Jp))
    bc = torch.zeros((C, 6), dtype=dt, device=dev).index_add_(0, cam, -ar.ein("oij,oi->oj", Jc, r))
    bp = torch.zeros((P, 3), dtype=dt, device=dev).index_add_(0, pt, -ar.ein("oij,oi->oj", Jp, r))
    return U, V, bc, bp, ar.ein("oij,oik->ojk", Jc, Jp)


def solve_cg(p, eqs, lam, cg_iters: int, ar: Arith):
    """`cg_iters` iterations of CG on the Schur complement, preconditioned
    by the inverse damped camera blocks, W applied through A per
    observation; fixed cameras masked out."""
    U, V, bc, bp, A = eqs
    cam, pt = p["obs_cam"], p["obs_pt"]
    C, P = U.shape[0], V.shape[0]
    dt, dev = U.dtype, U.device
    e6, e3 = torch.eye(6, dtype=dt, device=dev), torch.eye(3, dtype=dt, device=dev)
    Ud = U + lam * e6
    Vinv = torch.linalg.inv(V + lam * e3)
    Minv = torch.linalg.inv(Ud)
    mask = torch.where(p["fixed_cams"], 0.0, 1.0).to(dt)[:, None]

    def WT(x):
        return torch.zeros((P, 3), dtype=dt, device=dev).index_add_(0, pt, ar.ein("oij,oi->oj", A, x[cam]))

    def W(z):
        return torch.zeros((C, 6), dtype=dt, device=dev).index_add_(0, cam, ar.ein("oij,oj->oi", A, z[pt]))

    def S(x):
        x = x * mask
        return (ar.ein("cij,cj->ci", Ud, x) - W(ar.ein("pij,pj->pi", Vinv, WT(x)))) * mask

    rhs = (bc - W(ar.ein("pij,pj->pi", Vinv, bp))) * mask
    x = torch.zeros_like(rhs)
    r = rhs
    z = ar.ein("cij,cj->ci", Minv, r) * mask
    d = z
    rz = (r * z).sum()
    for _ in range(cg_iters):
        Sd = S(d)
        den = (d * Sd).sum()
        alpha = torch.where(den.abs() > 1e-30, rz / den, torch.zeros_like(den))
        x = x + alpha * d
        r = r - alpha * Sd
        z = ar.ein("cij,cj->ci", Minv, r) * mask
        rz_new = (r * z).sum()
        beta = torch.where(rz.abs() > 1e-30, rz_new / rz, torch.zeros_like(rz))
        d = z + beta * d
        rz = rz_new
    dc = x * mask
    return dc, ar.ein("pij,pj->pi", Vinv, bp - WT(dc))


def bundle_adjust(problem: dict, iters: int, lambda0: float, huber_delta, cg_iters: int,
                  ar: Arith | None = None):
    """`iters` damped LM steps from `problem` (tensors of the generated
    inputs). Returns (cam_rvec, cam_tvec, points, cost) in `ar.dtype`."""
    ar = ar or Arith()
    p = {k: (v.to(ar.dtype) if v.is_floating_point() else v) for k, v in problem.items()}
    lam = torch.tensor(lambda0, dtype=ar.dtype, device=p["points"].device)
    c = cost(p, ar)
    for _ in range(iters):
        eqs = normal_equations(p, huber_delta, ar)
        dc, dp = solve_cg(p, eqs, lam, cg_iters, ar)
        q = dict(p, cam_rvec=p["cam_rvec"] + dc[:, :3], cam_tvec=p["cam_tvec"] + dc[:, 3:],
                 points=p["points"] + dp)
        c_new = cost(q, ar)
        accept = (c_new < c) & torch.isfinite(c_new)
        for k in ("cam_rvec", "cam_tvec", "points"):
            p[k] = torch.where(accept, q[k], p[k])
        lam = torch.where(accept, lam / 3.0, lam * 4.0).clamp(1e-10, 1e10)
        c = torch.where(accept, c_new, c)
    return p["cam_rvec"], p["cam_tvec"], p["points"], c
