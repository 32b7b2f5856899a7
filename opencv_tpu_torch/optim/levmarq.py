"""Dense Levenberg-Marquardt (port of opencv_tpu/optim/levmarq.py; the
reference's LMSolver, calib3d/src/levmarq.cpp:88-197): normal equations,
damped solve, gain-ratio lambda schedule.

The Jacobian comes from torch.func.jacfwd. The loop has a fixed trip
count with masked accept/reject, so no trip reads a value back to the
host; a rejected step re-solves with a larger lambda on the next trip.
The normal equations run with TF32 off (the JAX solver asks for
Precision.HIGHEST).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from opencv_tpu_torch.device import no_tf32


class LMResult(NamedTuple):
    params: torch.Tensor
    cost: torch.Tensor  # final 0.5 * ||r||^2
    n_accepted: torch.Tensor


def levmarq(
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    iters: int = 30,
    lambda0: float = 1e-3,
    lambda_up: float = 4.0,
    lambda_down: float = 1.0 / 3.0,
) -> LMResult:
    """Minimize 0.5 * ||residual_fn(x)||^2 over flat params x [D]."""

    def cost(x):
        r = residual_fn(x)
        return 0.5 * (r * r).sum()

    jac = torch.func.jacfwd(residual_fn)
    x = x0
    lam = torch.tensor(lambda0, dtype=x0.dtype, device=x0.device)
    n_acc = torch.zeros((), dtype=torch.int32, device=x0.device)
    with no_tf32():
        c = cost(x0)
        for _ in range(iters):
            r = residual_fn(x)
            J = jac(x).to(x.dtype)
            H = J.T @ J
            g = J.T @ r
            dH = torch.diagonal(H) + 1e-12
            step = torch.linalg.solve_ex(H + torch.diag(lam * dH), g[:, None])[0][:, 0]
            x_new = x - step
            c_new = cost(x_new)
            # gain ratio: actual reduction / predicted reduction
            pred = 0.5 * (step * (lam * dH * step + g)).sum()
            rho = (c - c_new) / pred.clamp(min=1e-30)
            accept = (c_new < c) & torch.isfinite(x_new).all()
            x = torch.where(accept, x_new, x)
            c = torch.where(accept, c_new, c)
            lam = torch.where(accept, torch.where(rho > 0.75, lam * lambda_down, lam), lam * lambda_up)
            lam = lam.clamp(1e-12, 1e12)
            n_acc = n_acc + accept.to(torch.int32)
    return LMResult(params=x, cost=c, n_accepted=n_acc)
