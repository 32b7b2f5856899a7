"""Pose-graph optimization, the loop-closure back end (port of
opencv_tpu/optim/pose_graph.py): damped Gauss-Newton on the full graph
with dense normal equations and a torch.func.jacfwd Jacobian."""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_tpu_torch.geometry.rotation import rodrigues, rodrigues_inv


class PoseGraph(NamedTuple):
    """Nodes: world->camera poses (rvec [N,3], tvec [N,3]). Edge residual
    log(meas^-1 * (T_i * T_j^-1)); meas [E,6] = (rvec, tvec);
    edge_i/edge_j [E] i64, edge_weight [E] f32 (0 = invalid), fixed [N]."""

    rvec: torch.Tensor
    tvec: torch.Tensor
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    edge_meas: torch.Tensor
    edge_weight: torch.Tensor
    fixed: torch.Tensor


def relative_pose(rv_i, tv_i, rv_j, tv_j) -> tuple[torch.Tensor, torch.Tensor]:
    """T_rel = T_i * T_j^-1 (maps cam-j coords to cam-i coords); batched."""
    Ri = rodrigues(rv_i)
    Rj = rodrigues(rv_j)
    Rrel = Ri @ Rj.transpose(-1, -2)
    trel = tv_i - torch.einsum("...ij,...j->...i", Rrel, tv_j)
    return rodrigues_inv(Rrel), trel


def _edge_residual(rv_i, tv_i, rv_j, tv_j, meas6) -> torch.Tensor:
    """[E,6] log-residuals."""
    Ri = rodrigues(rv_i)
    Rj = rodrigues(rv_j)
    Rrel = Ri @ Rj.transpose(-1, -2)
    trel = tv_i - torch.einsum("...ij,...j->...i", Rrel, tv_j)
    Rm = rodrigues(meas6[..., :3])
    dr = rodrigues_inv(Rm.transpose(-1, -2) @ Rrel)
    return torch.cat([dr, trel - meas6[..., 3:]], dim=-1)


def residuals(g: PoseGraph) -> torch.Tensor:
    r = _edge_residual(
        g.rvec[g.edge_i], g.tvec[g.edge_i], g.rvec[g.edge_j], g.tvec[g.edge_j], g.edge_meas
    )
    return r * g.edge_weight[:, None]


def optimize(g: PoseGraph, iters: int = 15, lambda0: float = 1e-4) -> tuple[PoseGraph, torch.Tensor]:
    """Damped Gauss-Newton (LM schedule) on the whole graph."""
    N = g.rvec.shape[0]

    def flat_residual(xf):
        x = xf.reshape(N, 6)
        return residuals(g._replace(rvec=x[:, :3], tvec=x[:, 3:])).reshape(-1)

    def total_cost(xf):
        r = flat_residual(xf)
        return 0.5 * (r * r).sum()

    x = torch.cat([g.rvec, g.tvec], dim=1).reshape(-1)
    lam = torch.tensor(lambda0, dtype=torch.float32, device=x.device)
    c = total_cost(x)
    fix = g.fixed.repeat_interleave(6)
    for _ in range(iters):
        r = flat_residual(x)
        J = torch.func.jacfwd(flat_residual)(x)
        H = J.T @ J
        gvec = J.T @ r
        H = H + torch.diag(torch.where(fix, 1e12, 0.0) + lam)
        step = torch.linalg.solve_ex(H, gvec[:, None])[0][:, 0]
        step = torch.where(fix, torch.zeros_like(step), step)
        x_new = x - step
        c_new = total_cost(x_new)
        accept = (c_new < c) & torch.isfinite(c_new)
        x = torch.where(accept, x_new, x)
        c = torch.where(accept, c_new, c)
        lam = torch.where(accept, lam / 3.0, lam * 4.0).clamp(1e-10, 1e10)
    x = x.reshape(N, 6)
    return g._replace(rvec=x[:, :3], tvec=x[:, 3:]), c
