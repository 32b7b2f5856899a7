"""Sparse bundle adjustment with a Schur complement on camera blocks
(port of opencv_tpu/optim/ba.py): dense-Schur and matrix-free CG solvers
with the same `auto` rule, LM accept/reject schedule and Huber weights.

Per-observation Jacobians are the chain rule through the projection with
dR/drvec from torch.func.jacfwd of the guarded Rodrigues formula (once
per camera, not per observation); tests hold them against
torch.func.jacfwd of the whole residual. Block sums are `index_add_`.
All products run in f32 (the JAX package asks for HIGHEST precision;
TF32 stays off: `device.no_tf32`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_tpu_torch.device import no_tf32
from opencv_tpu_torch.geometry.rotation import rodrigues, rodrigues_jacobian


class BAProblem(NamedTuple):
    """cam_rvec [C,3], cam_tvec [C,3] world->camera; points [P,3];
    obs_cam [O] i64, obs_pt [O] i64, obs_uv [O,2] normalized coords,
    obs_valid [O] bool; fixed_cams [C] bool (gauge)."""

    cam_rvec: torch.Tensor
    cam_tvec: torch.Tensor
    points: torch.Tensor
    obs_cam: torch.Tensor
    obs_pt: torch.Tensor
    obs_uv: torch.Tensor
    obs_valid: torch.Tensor
    fixed_cams: torch.Tensor


def _project(R, t, pts):
    """Per-observation projection: R [O,3,3], t [O,3], pts [O,3]."""
    pc = torch.einsum("oij,oj->oi", R, pts) + t
    z = pc[:, 2]
    guard = z.abs() < 1e-9
    zs = torch.where(guard, torch.full_like(z, 1e-9), z)
    return pc[:, :2] / zs[:, None], zs, guard


def residuals(p: BAProblem) -> torch.Tensor:
    """[O,2] masked reprojection residuals."""
    R = rodrigues(p.cam_rvec)
    uv, _, _ = _project(R[p.obs_cam], p.cam_tvec[p.obs_cam], p.points[p.obs_pt])
    r = uv - p.obs_uv
    return torch.where(p.obs_valid[:, None], r, torch.zeros_like(r))


def cost(p: BAProblem) -> torch.Tensor:
    r = residuals(p)
    return 0.5 * (r * r).sum()


def _blocks(p: BAProblem, huber_delta: float | None):
    """r [O,2], Jc [O,2,6], Jp [O,2,3], weighted (masked rows zero)."""
    R = rodrigues(p.cam_rvec)
    dR = rodrigues_jacobian(p.cam_rvec)  # [C,3,3,3]
    Ro = R[p.obs_cam]
    pts = p.points[p.obs_pt]
    uv, zs, guard = _project(Ro, p.cam_tvec[p.obs_cam], pts)
    r = uv - p.obs_uv
    inv_z = 1.0 / zs
    zero = torch.zeros_like(zs)
    du_dz = torch.where(guard[:, None], torch.zeros_like(uv), -uv / zs[:, None])
    dproj = torch.stack(
        [torch.stack([inv_z, zero, du_dz[:, 0]], -1), torch.stack([zero, inv_z, du_dz[:, 1]], -1)], -2
    )  # [O,2,3]
    dpc_dr = torch.einsum("oijk,oj->oik", dR[p.obs_cam], pts)
    Jc = torch.cat([dproj @ dpc_dr, dproj], dim=-1)
    Jp = dproj @ Ro
    w = p.obs_valid.to(r.dtype)
    if huber_delta is not None:
        nrm = torch.sqrt((r * r).sum(-1) + 1e-18)
        w = w * torch.sqrt(torch.clamp(huber_delta / nrm, max=1.0))
    return r * w[:, None], Jc * w[:, None, None], Jp * w[:, None, None]


class BAStepState(NamedTuple):
    problem: BAProblem
    lam: torch.Tensor
    cost: torch.Tensor
    n_accepted: torch.Tensor


class NormalEqs(NamedTuple):
    """U [C,6,6], V [P,3,3], bc [C,6], bp [P,3]; A [O,6,3] = Jc^T Jp."""

    U: torch.Tensor
    V: torch.Tensor
    bc: torch.Tensor
    bp: torch.Tensor
    A: torch.Tensor


def normal_equations(p: BAProblem, huber_delta: float | None = None) -> NormalEqs:
    """Block normal equations in per-observation form."""
    C = p.cam_rvec.shape[0]
    P = p.points.shape[0]
    dev = p.points.device
    r, Jc, Jp = _blocks(p, huber_delta)
    f32 = torch.float32
    U = torch.zeros((C, 6, 6), dtype=f32, device=dev).index_add_(
        0, p.obs_cam, torch.einsum("oij,oik->ojk", Jc, Jc))
    V = torch.zeros((P, 3, 3), dtype=f32, device=dev).index_add_(
        0, p.obs_pt, torch.einsum("oij,oik->ojk", Jp, Jp))
    bc = torch.zeros((C, 6), dtype=f32, device=dev).index_add_(
        0, p.obs_cam, -torch.einsum("oij,oi->oj", Jc, r))
    bp = torch.zeros((P, 3), dtype=f32, device=dev).index_add_(
        0, p.obs_pt, -torch.einsum("oij,oi->oj", Jp, r))
    A = torch.einsum("oij,oik->ojk", Jc, Jp)
    return NormalEqs(U=U, V=V, bc=bc, bp=bp, A=A)


def schur_normal_equations(p: BAProblem, huber_delta: float | None = None):
    """(U, V, W [C,P,6,3], bc, bp) with W materialized."""
    C = p.cam_rvec.shape[0]
    P = p.points.shape[0]
    eqs = normal_equations(p, huber_delta)
    W = torch.zeros((C * P, 6, 3), dtype=torch.float32, device=p.points.device)
    W.index_add_(0, p.obs_cam * P + p.obs_pt, eqs.A)
    return eqs.U, eqs.V, W.reshape(C, P, 6, 3), eqs.bc, eqs.bp


def schur_solve(U, V, W, bc, bp, lam, fixed_cams):
    """Exact damped solve via the explicit Schur complement on cameras,
    S = U - W V^-1 W^T, then point back-substitution. Fixed cameras get a
    huge diagonal and a zeroed update."""
    C = U.shape[0]
    dev = U.device
    eye6 = torch.eye(6, dtype=U.dtype, device=dev)
    eye3 = torch.eye(3, dtype=U.dtype, device=dev)
    big = torch.where(fixed_cams, 1e12, 0.0)[:, None, None] * eye6[None]
    Ud = U + lam * eye6[None] + big
    Vd = V + lam * eye3[None]
    Vinv = torch.linalg.inv_ex(Vd)[0]
    Y = torch.einsum("cpij,pjk->cpik", W, Vinv)
    S = -torch.einsum("cpik,dpjk->cidj", Y, W)
    idx = torch.arange(C, device=dev)
    S[idx, :, idx, :] += Ud
    rhs = bc - torch.einsum("cpik,pk->ci", Y, bp)
    dc = torch.linalg.solve_ex(S.reshape(6 * C, 6 * C), rhs.reshape(6 * C, 1))[0].reshape(C, 6)
    dc = torch.where(fixed_cams[:, None], torch.zeros_like(dc), dc)
    tmp = bp - torch.einsum("cpij,ci->pj", W, dc)
    dp = torch.einsum("pij,pj->pi", Vinv, tmp)
    return dc, dp


def schur_cg_solve(eqs: NormalEqs, obs_cam, obs_pt, lam, fixed_cams, cg_iters: int = 60):
    """Matrix-free block-Jacobi-preconditioned CG on the Schur complement;
    W is applied per observation through A, never materialized."""
    C = eqs.U.shape[0]
    P_pts = eqs.V.shape[0]
    A = eqs.A
    dev = A.device
    eye6 = torch.eye(6, dtype=eqs.U.dtype, device=dev)
    eye3 = torch.eye(3, dtype=eqs.V.dtype, device=dev)
    Ud = eqs.U + lam * eye6[None]
    Vd = eqs.V + lam * eye3[None]
    Vinv = torch.linalg.inv_ex(Vd)[0]
    Minv = torch.linalg.inv_ex(Ud)[0]
    mask = torch.where(fixed_cams, 0.0, 1.0)[:, None]

    def WT_x(x):
        tx = torch.einsum("oij,oi->oj", A, x[obs_cam])
        return torch.zeros((P_pts, 3), dtype=torch.float32, device=dev).index_add_(0, obs_pt, tx)

    def W_z(z):
        wz = torch.einsum("oij,oj->oi", A, z[obs_pt])
        return torch.zeros((C, 6), dtype=torch.float32, device=dev).index_add_(0, obs_cam, wz)

    def S_mv(x):
        x = x * mask
        z = torch.einsum("pij,pj->pi", Vinv, WT_x(x))
        return (torch.einsum("cij,cj->ci", Ud, x) - W_z(z)) * mask

    def precond(r):
        return torch.einsum("cij,cj->ci", Minv, r) * mask

    rhs = (eqs.bc - W_z(torch.einsum("pij,pj->pi", Vinv, eqs.bp))) * mask
    x = torch.zeros_like(rhs)
    r = rhs
    z = precond(r)
    pvec = z
    rz = (r * z).sum()
    for _ in range(cg_iters):
        Sp = S_mv(pvec)
        denom = (pvec * Sp).sum()
        alpha = torch.where(denom.abs() > 1e-30, rz / denom, torch.zeros_like(denom))
        x = x + alpha * pvec
        r = r - alpha * Sp
        z = precond(r)
        rz_new = (r * z).sum()
        beta = torch.where(rz.abs() > 1e-30, rz_new / rz, torch.zeros_like(rz))
        pvec = z + beta * pvec
        rz = rz_new
    dc = x * mask
    dp = torch.einsum("pij,pj->pi", Vinv, eqs.bp - WT_x(dc))
    return dc, dp


def _resolve_solver(solver: str, p: BAProblem) -> str:
    """'auto' -> 'dense' when W [C,P,6,3] fits in 128 MB, else 'cg'
    (the JAX package's rule)."""
    if solver != "auto":
        return solver
    C = p.cam_rvec.shape[0]
    P = p.points.shape[0]
    return "dense" if C * P * 72 <= 128 * 1024 * 1024 else "cg"


def ba_step(state: BAStepState, huber_delta: float | None = None, solver: str = "auto",
            cg_iters: int = 60) -> BAStepState:
    """One damped LM step with accept/reject (levmarq.cpp:88-197)."""
    p = state.problem
    solver = _resolve_solver(solver, p)
    if solver == "cg":
        eqs = normal_equations(p, huber_delta)
        dc, dp = schur_cg_solve(eqs, p.obs_cam, p.obs_pt, state.lam, p.fixed_cams, cg_iters)
    else:
        U, V, W, bc, bp = schur_normal_equations(p, huber_delta)
        dc, dp = schur_solve(U, V, W, bc, bp, state.lam, p.fixed_cams)
    new_p = p._replace(
        cam_rvec=p.cam_rvec + dc[:, :3], cam_tvec=p.cam_tvec + dc[:, 3:], points=p.points + dp
    )
    c_new = cost(new_p)
    accept = (c_new < state.cost) & torch.isfinite(c_new)
    merged = BAProblem(*[torch.where(accept, b, a) for a, b in zip(p, new_p)])
    lam = torch.where(accept, state.lam / 3.0, state.lam * 4.0).clamp(1e-10, 1e10)
    return BAStepState(
        problem=merged, lam=lam, cost=torch.where(accept, c_new, state.cost),
        n_accepted=state.n_accepted + accept.to(torch.int32),
    )


def bundle_adjust(p: BAProblem, iters: int = 20, lambda0: float = 1e-4,
                  huber_delta: float | None = None, solver: str = "auto",
                  cg_iters: int = 60) -> tuple[BAProblem, torch.Tensor]:
    """Run `iters` LM steps. Returns (optimized problem, final cost)."""
    with no_tf32():
        dev = p.points.device
        state = BAStepState(
            problem=p, lam=torch.tensor(lambda0, dtype=torch.float32, device=dev),
            cost=cost(p), n_accepted=torch.tensor(0, dtype=torch.int32, device=dev),
        )
        for _ in range(iters):
            state = ba_step(state, huber_delta, solver=solver, cg_iters=cg_iters)
    return state.problem, state.cost
