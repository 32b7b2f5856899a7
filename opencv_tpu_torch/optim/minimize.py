"""General-purpose optimizers (port of opencv_tpu/optim/minimize.py):
downhill simplex (cv::DownhillSolver), nonlinear conjugate gradient
(cv::ConjGradSolver, gradients by torch.func.grad) and a linear program
solver (cv::solveLP).

The iterative solvers run a fixed number of trips with masked
accept/reject, so no trip reads a value back to the host. solve_lp is
the JAX package's host numpy simplex, unchanged; only its outputs become
tensors.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from opencv_tpu_torch.device import resolve_device


class MinimizeResult(NamedTuple):
    x: torch.Tensor
    fun: torch.Tensor


def downhill_simplex(
    f: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    init_step: float = 0.1,
    iters: int = 200,
) -> MinimizeResult:
    """Nelder-Mead (cv::DownhillSolver::minimize analog). x0 [D]."""
    d = x0.shape[0]
    fv = torch.func.vmap(f)
    simplex = torch.cat([x0[None], x0[None] + init_step * torch.eye(d, dtype=x0.dtype, device=x0.device)])
    fvals = fv(simplex)
    for _ in range(iters):
        order = torch.argsort(fvals, stable=True)
        simplex, fvals = simplex[order], fvals[order]
        best, worst, second = fvals[0], fvals[-1], fvals[-2]
        centroid = simplex[:-1].mean(0)
        xr = centroid + (centroid - simplex[-1])  # reflection
        xe = centroid + 2.0 * (centroid - simplex[-1])  # expansion
        xc = centroid - 0.5 * (centroid - simplex[-1])  # contraction
        fr, fe, fc = f(xr), f(xe), f(xc)
        use_e = (fr < best) & (fe < fr)
        use_r = (fr < second) & ~use_e
        use_c = (fc < worst) & ~use_e & ~use_r
        new_pt = torch.where(use_e, xe, torch.where(use_r, xr, torch.where(use_c, xc, simplex[-1])))
        new_f = torch.where(use_e, fe, torch.where(use_r, fr, torch.where(use_c, fc, worst)))
        shrink = ~(use_e | use_r | use_c)
        simplex = torch.cat([simplex[:-1], new_pt[None]])
        fvals = torch.cat([fvals[:-1], new_f[None]])
        # shrink toward the best vertex when nothing helped
        shrunk = simplex[0][None] + 0.5 * (simplex - simplex[0][None])
        simplex = torch.where(shrink, shrunk, simplex)
        fvals = torch.where(shrink, fv(simplex), fvals)
    i = torch.argmin(fvals)
    return MinimizeResult(x=simplex[i], fun=fvals[i])


def conjugate_gradient(
    f: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    iters: int = 100,
    ls_iters: int = 12,
) -> MinimizeResult:
    """Nonlinear CG, Polak-Ribiere with restart (cv::ConjGradSolver analog;
    gradients by torch.func.grad). Backtracking Armijo line search with
    a fixed number of trips."""
    grad = torch.func.grad(f)

    def line_search(x, p):
        g0 = grad(x) @ p
        best_f = f(x)
        t = torch.ones((), dtype=x.dtype, device=x.device)
        best_t = torch.zeros_like(t)
        for _ in range(ls_iters):
            ft = f(x + t * p)
            take = (ft < best_f + 1e-4 * t * g0) & (ft < best_f)
            best_t = torch.where(take, t, best_t)
            best_f = torch.where(take, ft, best_f)
            t = t * 0.5
        return best_t

    x = x0
    g = grad(x0)
    p = -g
    for _ in range(iters):
        x_new = x + line_search(x, p) * p
        g_new = grad(x_new)
        beta = (g_new @ (g_new - g) / (g @ g).clamp(min=1e-20)).clamp(min=0.0)  # Polak-Ribiere+ restart
        x, g, p = x_new, g_new, -g_new + beta * p
    return MinimizeResult(x=x, fun=f(x))


class LPResult(NamedTuple):
    x: torch.Tensor
    value: torch.Tensor
    status: int  # 0 optimal, 1 unbounded, 2 infeasible


def solve_lp(c, A, b, max_pivots: int = 200, device=None) -> LPResult:
    """maximize c@x s.t. A@x <= b, x >= 0 (cv::solveLP semantics). Dense
    simplex with Bland's rule on the host in f64; x and value come back
    as f32 tensors on `device` (None: the card)."""
    dev = resolve_device(device)
    c = np.asarray(c, np.float64)
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64).copy()
    m, n = A.shape

    def result(x, value, status):
        return LPResult(torch.tensor(np.asarray(x, np.float32), device=dev),
                        torch.tensor(np.float32(value), device=dev), status)

    T = np.zeros((m + 1, n + m + 1))
    T[:m, :n] = A
    T[:m, n:n + m] = np.eye(m)
    T[:m, -1] = b
    T[-1, :n] = -c
    basis = list(range(n, n + m))

    # negative right-hand sides: pivot them out first
    if (b < 0).any():
        for _ in range(max_pivots):
            rows = np.where(T[:m, -1] < -1e-9)[0]
            if len(rows) == 0:
                break
            r = rows[0]
            cols = np.where(T[r, :-1] < -1e-9)[0]
            if len(cols) == 0:
                return result(np.zeros(n), 0.0, 2)
            p = cols[0]
            T[r] /= T[r, p]
            for i in range(m + 1):
                if i != r:
                    T[i] -= T[i, p] * T[r]
            basis[r] = p

    for _ in range(max_pivots):
        # Bland: smallest index with a negative reduced cost
        cols = np.where(T[-1, :-1] < -1e-9)[0]
        if len(cols) == 0:
            x = np.zeros(n + m)
            for r, bi in enumerate(basis):
                x[bi] = T[r, -1]
            return result(x[:n], T[-1, -1], 0)
        p = cols[0]
        with np.errstate(divide="ignore", invalid="ignore"):
            ratios = np.where(T[:m, p] > 1e-9, T[:m, -1] / T[:m, p], np.inf)
        if not np.isfinite(ratios).any():
            return result(np.zeros(n), 0.0, 1)
        r = int(np.argmin(ratios))
        T[r] /= T[r, p]
        for i in range(m + 1):
            if i != r:
                T[i] -= T[i, p] * T[r]
        basis[r] = p
    return result(np.zeros(n), 0.0, 2)
