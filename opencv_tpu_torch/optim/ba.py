"""Sparse bundle adjustment with a Schur complement on camera blocks
(port of opencv_tpu/optim/ba.py): dense-Schur and matrix-free CG solvers
with the same `auto` rule, LM accept/reject schedule and Huber weights.

Per-observation Jacobians are the chain rule through the projection with
dR/drvec from torch.func.jacfwd of the guarded Rodrigues formula (once
per camera, not per observation); tests hold them against
torch.func.jacfwd of the whole residual. On the card the normal
equations are the hand-written kernel csrc/normal_eq.cu (K7,
ops/cuda/normal_eq.py): a table of the cameras' R, t, dR/drvec (the
closed form of the same guarded formula and its derivative) and
intrinsics, then one pass over the observations that forms each one's
residual, Jacobians and products in registers, writes A and sums U, bc,
V and bp. CPU tensors take the plain version (`_blocks`, einsum and
`index_add_`).
All products run in f32 (the JAX package asks for HIGHEST precision;
TF32 stays off: `device.no_tf32`). With a process group,
`schur_cg_solve` all-reduces its two per-iteration products
(parallel/dist_ba.py), as the JAX solver psums them.

The CG's products over A go through ops/cuda/schur_cg.py. On the card a
point-major layout is built once a solve (a stable sort by point, no
host synchronization) and each product is one pass of the hand-written
kernel csrc/schur_cg.cu over A. A CG iteration is S p (one fused pass of
W^T x, V^-1 and W z; with a group its two halves, an all-reduce after
each), one camera reduce that finishes it, and the CG's vector work in
one one-block launch; under deterministic algorithms every sum takes a
fixed order. CPU tensors take the plain version (einsum and index_add_)
with the CG's vector work in PyTorch.

Cameras are 6 parameters wide (rvec, t) with normalized observations, or,
with `cam_intr`, 9 wide (rvec, t, f, k1, k2) with BAL's projection and
observations in pixels; every block, solver and K6 pass takes the width D
from the Jacobian's or U's last dimension.

Spans and counters (utils/profiler.py, recorded while `OPENCV_TPU_TRACE`
or `profiler.enable()` turns the recorder on): `ba.bundle_adjust` around
a solve, inside it `ba.cost` around the start's cost and `ba.step` around
each LM step, inside that `ba.normal_eq` (the
normal equations of either solver, with `ba.jac` inside: on the card
around K7's camera table (R and dR/drvec a camera), on the CPU around
`_blocks`), `ba.schur` (the Schur solve) and
`ba.update` (the candidate's cost, the accept test, the merge and the
lambda update). Inside `ba.schur` of the CG solver: `ba.cg.wz` around
the right-hand side's W V^-1 bp, `ba.cg.wtx` around the
back-substitution's W^T dc, and `ba.cg.smv` around each CG iteration's
S p; with a group, `ba.cg.wtx` and `ba.cg.wz` around S p's two halves
in its place. No span holds an all-reduce. Counters: `ba.lm_steps` (steps
attempted), `ba.lm_accepted` (the final `n_accepted` of each solve, read
only when asked), and on the card `ba.cg.pass.smem`, `ba.cg.pass.global`
or `ba.cg.pass.ordered`, one per K6 pass, by where the pass kept the
camera sums (ops/cuda/schur_cg.py), and `ba.neq.pass.smem`, `.global` or
`.ordered`, one per K7 pass, by its route (ops/cuda/normal_eq.py).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.distributed as dist

from opencv_tpu_torch.device import no_tf32
from opencv_tpu_torch.geometry.rotation import rodrigues, rodrigues_jacobian
from opencv_tpu_torch.ops.cuda import normal_eq, schur_cg
from opencv_tpu_torch.utils import profiler


class BAProblem(NamedTuple):
    """cam_rvec [C,3], cam_tvec [C,3] world->camera; points [P,3];
    obs_cam [O] i64, obs_pt [O] i64, obs_uv [O,2], obs_valid [O] bool;
    fixed_cams [C] bool (gauge); cam_intr [C,3] or None.

    Without `cam_intr` a camera is calibrated: uv = P.xy / P.z with
    P = R X + t, and obs_uv holds normalized image coordinates. With it,
    each camera also estimates its intrinsics (f, k1, k2), as BAL and
    Bundler define them: p = -P.xy / P.z (the camera looks down -z),
    pixel = f (1 + k1 |p|^2 + k2 |p|^4) p, and obs_uv holds pixels
    measured from the principal point."""

    cam_rvec: torch.Tensor
    cam_tvec: torch.Tensor
    points: torch.Tensor
    obs_cam: torch.Tensor
    obs_pt: torch.Tensor
    obs_uv: torch.Tensor
    obs_valid: torch.Tensor
    fixed_cams: torch.Tensor
    cam_intr: torch.Tensor | None = None


def _fields_held(self: BAProblem) -> dict:
    """The fields the problem holds: `cam_intr` left out where it is None,
    so a calibrated problem's dict is its eight tensors, as before the
    field existed (callers hand the dict to code that reads every value as
    a tensor: the benchmark's plain references). The port itself compares
    problems field by field, None with None."""
    return {k: v for k, v in zip(self._fields, self) if v is not None}


BAProblem._asdict = _fields_held  # NamedTuple forbids the override in the class body


def camera_width(p: BAProblem) -> int:
    """Parameters a camera estimates: 6, or 9 with intrinsics."""
    return 6 if p.cam_intr is None else 6 + p.cam_intr.shape[-1]


def _project(R, t, pts):
    """Per-observation projection: R [O,3,3], t [O,3], pts [O,3]."""
    pc = torch.einsum("oij,oj->oi", R, pts) + t
    z = pc[:, 2]
    guard = z.abs() < 1e-9
    zs = torch.where(guard, torch.full_like(z, 1e-9), z)
    return pc[:, :2] / zs[:, None], zs, guard


def _distort(uv, intr):
    """BAL's pixel of uv = P.xy / P.z, per observation's intrinsics intr
    [O,3] = (f, k1, k2): (pixel, p = -uv, s = |p|^2, d = 1 + k1 s + k2 s^2)."""
    p = -uv
    s = (p * p).sum(-1)
    f, k1, k2 = intr.unbind(-1)
    d = 1.0 + s * (k1 + k2 * s)
    return (f * d)[:, None] * p, p, s, d


def residuals(p: BAProblem) -> torch.Tensor:
    """[O,2] masked reprojection residuals (pixels with intrinsics)."""
    R = rodrigues(p.cam_rvec)
    uv, _, _ = _project(R[p.obs_cam], p.cam_tvec[p.obs_cam], p.points[p.obs_pt])
    if p.cam_intr is not None:
        uv = _distort(uv, p.cam_intr[p.obs_cam])[0]
    r = uv - p.obs_uv
    return torch.where(p.obs_valid[:, None], r, torch.zeros_like(r))


def cost(p: BAProblem) -> torch.Tensor:
    r = residuals(p)
    return 0.5 * (r * r).sum()


def _blocks(p: BAProblem, huber_delta: float | None):
    """r [O,2], Jc [O,2,D], Jp [O,2,3], weighted (masked rows zero). With
    intrinsics, Jc's columns are (rvec, t, f, k1, k2) by the chain rule
    through the distortion: d pixel / d p = f (d I + 2 d' p p^T) with
    d' = k1 + 2 k2 s, and d pixel / d(f, k1, k2) = (d p, f s p, f s^2 p)."""
    R = rodrigues(p.cam_rvec)
    dR = rodrigues_jacobian(p.cam_rvec)  # [C,3,3,3]
    Ro = R[p.obs_cam]
    pts = p.points[p.obs_pt]
    uv, zs, guard = _project(Ro, p.cam_tvec[p.obs_cam], pts)
    if p.cam_intr is None:
        r = uv - p.obs_uv
    else:
        intr = p.cam_intr[p.obs_cam]
        pix, pn, s, d = _distort(uv, intr)
        r = pix - p.obs_uv
    inv_z = 1.0 / zs
    zero = torch.zeros_like(zs)
    du_dz = torch.where(guard[:, None], torch.zeros_like(uv), -uv / zs[:, None])
    dproj = torch.stack(
        [torch.stack([inv_z, zero, du_dz[:, 0]], -1), torch.stack([zero, inv_z, du_dz[:, 1]], -1)], -2
    )  # [O,2,3]: d uv / d P
    dpc_dr = torch.einsum("oijk,oj->oik", dR[p.obs_cam], pts)
    if p.cam_intr is None:
        Jc = torch.cat([dproj @ dpc_dr, dproj], dim=-1)
    else:
        f, k1, k2 = intr.unbind(-1)
        pp = pn[:, :, None] * pn[:, None, :]
        eye2 = torch.eye(2, dtype=uv.dtype, device=uv.device)
        dpix_dp = f[:, None, None] * (d[:, None, None] * eye2 + (2.0 * (k1 + 2.0 * k2 * s))[:, None, None] * pp)
        dproj = -(dpix_dp @ dproj)  # d pixel / d P, through p = -uv
        fs = f * s
        dintr = torch.stack([d[:, None] * pn, fs[:, None] * pn, (fs * s)[:, None] * pn], -1)
        Jc = torch.cat([dproj @ dpc_dr, dproj, dintr], dim=-1)
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
    """U [C,D,D], V [P,3,3], bc [C,D], bp [P,3]; A [O,D,3] = Jc^T Jp."""

    U: torch.Tensor
    V: torch.Tensor
    bc: torch.Tensor
    bp: torch.Tensor
    A: torch.Tensor


def normal_equations(p: BAProblem, huber_delta: float | None = None) -> NormalEqs:
    """Block normal equations in per-observation form: on the card K7's
    camera table (R and dR/drvec a camera) and one K7 pass
    (ops/cuda/normal_eq.py), on the CPU the plain version."""
    dev = p.points.device
    if dev.type != "cuda":
        return normal_equations_plain(p, huber_delta)
    ps = normal_eq.prepare(p.obs_cam, p.obs_pt, p.obs_uv, p.obs_valid, p.points, p.cam_rvec.shape[0],
                           camera_width(p), huber_delta)
    with profiler.profile_region("ba.jac", dev):
        normal_eq.fill_table(ps, p.cam_rvec, p.cam_tvec, p.cam_intr)
    normal_eq.launch(ps)
    return NormalEqs(*normal_eq.finish(ps))


def normal_equations_plain(p: BAProblem, huber_delta: float | None = None) -> NormalEqs:
    """The plain version of `normal_equations`, on any device, in the
    problem's precision: `_blocks`, then einsum and index_add_ per
    observation."""
    C = p.cam_rvec.shape[0]
    P = p.points.shape[0]
    dev = p.points.device
    with profiler.profile_region("ba.jac", dev):
        r, Jc, Jp = _blocks(p, huber_delta)
    D = Jc.shape[-1]
    dt = r.dtype
    U = torch.zeros((C, D, D), dtype=dt, device=dev).index_add_(
        0, p.obs_cam, torch.einsum("oij,oik->ojk", Jc, Jc))
    V = torch.zeros((P, 3, 3), dtype=dt, device=dev).index_add_(
        0, p.obs_pt, torch.einsum("oij,oik->ojk", Jp, Jp))
    bc = torch.zeros((C, D), dtype=dt, device=dev).index_add_(
        0, p.obs_cam, -torch.einsum("oij,oi->oj", Jc, r))
    bp = torch.zeros((P, 3), dtype=dt, device=dev).index_add_(
        0, p.obs_pt, -torch.einsum("oij,oi->oj", Jp, r))
    A = torch.einsum("oij,oik->ojk", Jc, Jp)
    return NormalEqs(U=U, V=V, bc=bc, bp=bp, A=A)


def schur_normal_equations(p: BAProblem, huber_delta: float | None = None):
    """(U, V, W [C,P,D,3], bc, bp) with W materialized."""
    C = p.cam_rvec.shape[0]
    P = p.points.shape[0]
    eqs = normal_equations(p, huber_delta)
    D = eqs.A.shape[1]
    W = torch.zeros((C * P, D, 3), dtype=torch.float32, device=p.points.device)
    W.index_add_(0, p.obs_cam * P + p.obs_pt, eqs.A)
    return eqs.U, eqs.V, W.reshape(C, P, D, 3), eqs.bc, eqs.bp


def schur_solve(U, V, W, bc, bp, lam, fixed_cams):
    """Exact damped solve via the explicit Schur complement on cameras,
    S = U - W V^-1 W^T, then point back-substitution. Fixed cameras get a
    huge diagonal and a zeroed update."""
    C, D = U.shape[0], U.shape[-1]
    dev = U.device
    eyeD = torch.eye(D, dtype=U.dtype, device=dev)
    eye3 = torch.eye(3, dtype=U.dtype, device=dev)
    big = torch.where(fixed_cams, 1e12, 0.0)[:, None, None] * eyeD[None]
    Ud = U + lam * eyeD[None] + big
    Vd = V + lam * eye3[None]
    Vinv = torch.linalg.inv_ex(Vd)[0]
    Y = torch.einsum("cpij,pjk->cpik", W, Vinv)
    S = -torch.einsum("cpik,dpjk->cidj", Y, W)
    idx = torch.arange(C, device=dev)
    S[idx, :, idx, :] += Ud
    rhs = bc - torch.einsum("cpik,pk->ci", Y, bp)
    dc = torch.linalg.solve_ex(S.reshape(D * C, D * C), rhs.reshape(D * C, 1))[0].reshape(C, D)
    dc = torch.where(fixed_cams[:, None], torch.zeros_like(dc), dc)
    tmp = bp - torch.einsum("cpij,ci->pj", W, dc)
    dp = torch.einsum("pij,pj->pi", Vinv, tmp)
    return dc, dp


def schur_cg_solve(eqs: NormalEqs, obs_cam, obs_pt, lam, fixed_cams, cg_iters: int = 60,
                   group=None):
    """Matrix-free block-Jacobi-preconditioned CG on the Schur complement;
    W is applied per observation through A, never materialized.

    On the card the products are K6's point-major passes over A
    (ops/cuda/schur_cg.py, `_cg_on_card`); on the CPU the plain einsum and
    index_add_ version with the CG's vector work in PyTorch.

    With a process `group` (the JAX package's `psum_axis`), A, obs_cam and
    obs_pt are this rank's block of observations, and the [P,3] result of
    W^T x and the [C,D] result of W z are all-reduced over the group: the
    whole of the solver's collective traffic. Everything else runs on
    vectors every rank holds alike, and S p runs as its two halves."""
    C = eqs.U.shape[0]
    P_pts = eqs.V.shape[0]
    A = eqs.A
    dev = A.device
    eyeD = torch.eye(eqs.U.shape[-1], dtype=eqs.U.dtype, device=dev)
    eye3 = torch.eye(3, dtype=eqs.V.dtype, device=dev)
    Ud = eqs.U + lam * eyeD[None]
    Vd = eqs.V + lam * eye3[None]
    Vinv = torch.linalg.inv_ex(Vd)[0]
    Minv = torch.linalg.inv_ex(Ud)[0]
    mask = torch.where(fixed_cams, 0.0, 1.0)[:, None]

    def summed(x):
        if group is not None:
            dist.all_reduce(x, group=group)
        return x

    def span(name):
        return profiler.profile_region(name, dev)

    if dev.type == "cuda":
        k = schur_cg.SchurProducts(A, obs_cam, obs_pt, Vinv, mask, C, P_pts)
        return _cg_on_card(k, eqs, Ud, Minv, mask, cg_iters, group is not None, summed, span)

    def WT_x(x, spanned=True):
        with span("ba.cg.wtx") if spanned else contextlib.nullcontext():
            g = schur_cg.wt_x_plain(A, obs_cam, obs_pt, x, P_pts)
        return summed(g)

    def W_vinv(g, spanned=True):
        with span("ba.cg.wz") if spanned else contextlib.nullcontext():
            h = schur_cg.w_z_plain(A, obs_cam, obs_pt, torch.einsum("pij,pj->pi", Vinv, g), C)
        return summed(h)

    def S_mv(x):
        x = x * mask
        if group is not None:
            return (torch.einsum("cij,cj->ci", Ud, x) - W_vinv(WT_x(x))) * mask
        with span("ba.cg.smv"):
            return (torch.einsum("cij,cj->ci", Ud, x) - W_vinv(WT_x(x, False), False)) * mask

    def precond(r):
        return torch.einsum("cij,cj->ci", Minv, r) * mask

    rhs = (eqs.bc - W_vinv(eqs.bp)) * mask
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


def _cg_on_card(k: schur_cg.SchurProducts, eqs: NormalEqs, Ud, Minv, mask, cg_iters: int, grouped: bool,
                summed, span):
    """schur_cg_solve's CG through K6. A CG iteration is S p, one camera
    reduce that finishes it, and one launch of the CG's vector work. S p
    is one fused pass on one card; with a group its two halves, each
    all-reduced outside the spans, which gives the fused pass's bits at
    world 1 (ops/cuda/schur_cg.py)."""
    with span("ba.cg.wz"):
        h = k.w_vinv(eqs.bp)
    cg = k.cg_start(k.finish(summed(h), base=eqs.bc), Minv)
    for _ in range(cg_iters):
        if grouped:
            with span("ba.cg.wtx"):
                g = k.wt_x(cg.p)
            summed(g)
            with span("ba.cg.wz"):
                h = k.w_vinv(g)
            k.finish(summed(h), ud=Ud, cg=cg)
        else:
            with span("ba.cg.smv"):
                k.smv(cg.p, Ud, cg)
        k.cg_step(cg)
    dc = cg.x * mask
    if not grouped:
        with span("ba.cg.wtx"):
            return dc, k.back(dc, eqs.bp)
    with span("ba.cg.wtx"):
        g = k.wt_x(dc)
    return dc, k.apply_vinv(eqs.bp - summed(g))


def _resolve_solver(solver: str, p: BAProblem) -> str:
    """'auto' -> 'dense' when W [C,P,D,3] fits in 128 MB, else 'cg'
    (the JAX package's rule)."""
    if solver != "auto":
        return solver
    C = p.cam_rvec.shape[0]
    P = p.points.shape[0]
    return "dense" if C * P * 12 * camera_width(p) <= 128 * 1024 * 1024 else "cg"


def candidate(p: BAProblem, dc: torch.Tensor, dp: torch.Tensor) -> BAProblem:
    """The LM step's candidate: dc [C,D] split as rvec, t and, where the
    cameras have them, intrinsics; points moved by dp [P,3]."""
    new = dict(cam_rvec=p.cam_rvec + dc[:, :3], cam_tvec=p.cam_tvec + dc[:, 3:6], points=p.points + dp)
    if p.cam_intr is not None:
        new["cam_intr"] = p.cam_intr + dc[:, 6:]
    return p._replace(**new)


def merge(accept: torch.Tensor, p: BAProblem, new: BAProblem) -> BAProblem:
    """Each field of `new` where the step is accepted, of `p` where it is
    not; a field that is None in `p` stays None."""
    return BAProblem(*[a if a is None else torch.where(accept, b, a) for a, b in zip(p, new)])


def ba_step(state: BAStepState, huber_delta: float | None = None, solver: str = "auto",
            cg_iters: int = 60) -> BAStepState:
    """One damped LM step with accept/reject (levmarq.cpp:88-197)."""
    p = state.problem
    dev = p.points.device
    solver = _resolve_solver(solver, p)
    profiler.count("ba.lm_steps")
    with profiler.profile_region("ba.step", dev):
        if solver == "cg":
            with profiler.profile_region("ba.normal_eq", dev):
                eqs = normal_equations(p, huber_delta)
            with profiler.profile_region("ba.schur", dev):
                dc, dp = schur_cg_solve(eqs, p.obs_cam, p.obs_pt, state.lam, p.fixed_cams, cg_iters)
        else:
            with profiler.profile_region("ba.normal_eq", dev):
                U, V, W, bc, bp = schur_normal_equations(p, huber_delta)
            with profiler.profile_region("ba.schur", dev):
                dc, dp = schur_solve(U, V, W, bc, bp, state.lam, p.fixed_cams)
        with profiler.profile_region("ba.update", dev):
            new_p = candidate(p, dc, dp)
            c_new = cost(new_p)
            accept = (c_new < state.cost) & torch.isfinite(c_new)
            merged = merge(accept, p, new_p)
            lam = torch.where(accept, state.lam / 3.0, state.lam * 4.0).clamp(1e-10, 1e10)
            return BAStepState(
                problem=merged, lam=lam, cost=torch.where(accept, c_new, state.cost),
                n_accepted=state.n_accepted + accept.to(torch.int32),
            )


def bundle_adjust(p: BAProblem, iters: int = 20, lambda0: float = 1e-4,
                  huber_delta: float | None = None, solver: str = "auto",
                  cg_iters: int = 60) -> tuple[BAProblem, torch.Tensor]:
    """Run `iters` LM steps. Returns (optimized problem, final cost)."""
    dev = p.points.device
    with profiler.profile_region("ba.bundle_adjust", dev), no_tf32():
        with profiler.profile_region("ba.cost", dev):
            c0 = cost(p)
        # filled on the device: a host tensor copied in would synchronize
        state = BAStepState(
            problem=p, lam=torch.full((), lambda0, dtype=torch.float32, device=dev),
            cost=c0, n_accepted=torch.zeros((), dtype=torch.int32, device=dev),
        )
        for _ in range(iters):
            state = ba_step(state, huber_delta, solver=solver, cg_iters=cg_iters)
    profiler.keep("ba.lm_accepted", state.n_accepted)
    return state.problem, state.cost
