"""Shape analysis (port of opencv_tpu/ops/shape.py; the reference's `shape`
module: Hausdorff distance, shape/src/haus_dis.cpp; shape-context
distance, sc_dis.cpp; thin-plate-spline transformer, tps_trans.cpp; EMD,
emdL1.cpp and imgproc/src/emd.cpp).

Point-set distances are masked pairwise-distance products and the TPS
system one dense solve, all in true f32 (`no_tf32`, the JAX package's
Precision.HIGHEST). Shape-context histograms count one-hot bins (exact
given the same bins). The assignment of the shape-context distance is
the port's `tbd.assignment.linear_assignment`, and the exact EMD the
port's simplex `optim.minimize.solve_lp` on host numpy; neither is
imported from the JAX package. Sorts are stable, as `jnp.sort`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from opencv_tpu_torch.device import no_tf32, on_device, true_div
from opencv_tpu_torch.optim.minimize import solve_lp
from opencv_tpu_torch.tbd.assignment import linear_assignment


def _pairwise_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a2 = (a * a).sum(1, keepdim=True)
    b2 = (b * b).sum(1)[None, :]
    with no_tf32():
        ab = a @ b.T
    return torch.sqrt(torch.clamp(a2 + b2 - 2.0 * ab, min=0.0))


def hausdorff_distance(a, b, rank_quantile: float = 1.0, device=None) -> torch.Tensor:
    """Symmetric (partial) Hausdorff distance between point sets [N,2]/[M,2].
    rank_quantile < 1 gives the partial variant used by
    HausdorffDistanceExtractor (rankProportion)."""
    a = on_device(a, device).to(torch.float32)
    b = on_device(b, a.device).to(torch.float32)
    d = _pairwise_dist(a, b)

    def ranked(v):
        s = torch.sort(v, stable=True).values
        k = min(max(int(rank_quantile * v.shape[0]) - 1, 0), v.shape[0] - 1)
        return s[k]

    return torch.maximum(ranked(d.amin(1)), ranked(d.amin(0)))


def _linspace(bounds: torch.Tensor, num: int) -> torch.Tensor:
    """jnp.linspace(start, stop, num) in f32 as JAX computes it: start * (1
    - s) + stop * s at s = i / (num - 1), then stop itself."""
    div = num - 1
    step = true_div(torch.arange(div, dtype=torch.float32, device=bounds.device), div)
    return torch.cat([bounds[0] * (1 - step) + bounds[1] * step, bounds[1:]])


def shape_context(pts, n_radial: int = 5, n_angular: int = 12, r_min: float = 0.125,
                  r_max: float = 2.0, device=None) -> torch.Tensor:
    """Log-polar shape-context histograms [N, n_radial * n_angular]
    (SCD::extractSCD analog), radii normalized by the mean pairwise
    distance."""
    pts = on_device(pts, device).to(torch.float32)
    dev = pts.device
    n = pts.shape[0]
    diff = pts[None, :, :] - pts[:, None, :]  # [N, N, 2] (j - i)
    dist = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-18))
    mean_d = true_div(dist.sum(), n * (n - 1))
    rnorm = dist / torch.clamp(mean_d, min=1e-9)
    two_pi = torch.full((), 2.0 * math.pi, dtype=torch.float32, device=dev)
    ang = torch.atan2(diff[..., 1], diff[..., 0]) % (2.0 * math.pi)
    r_edges = torch.exp(_linspace(torch.log(torch.tensor([r_min, r_max], device=dev)), n_radial + 1))
    r_bin = (rnorm[..., None] >= r_edges[None, None, :]).sum(-1) - 1
    a_bin = torch.floor(ang / two_pi * n_angular).to(torch.int64).clamp(0, n_angular - 1)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    valid = (r_bin >= 0) & (r_bin < n_radial) & ~eye
    flat_bin = r_bin.clamp(0, n_radial - 1) * n_angular + a_bin
    one_hot = ((flat_bin[..., None] == torch.arange(n_radial * n_angular, device=dev))
               & valid[..., None])
    hist = one_hot.sum(1).to(torch.float32)
    return hist / torch.clamp(hist.sum(1, keepdim=True), min=1.0)


def shape_context_distance(a, b, device=None) -> float:
    """Chi-squared shape-context cost with optimal assignment
    (ShapeContextDistanceExtractor analog; requires len(a) == len(b))."""
    ha = shape_context(a, device=device)
    hb = shape_context(b, device=ha.device)
    num = (ha[:, None, :] - hb[None, :, :]) ** 2
    den = ha[:, None, :] + hb[None, :, :]
    cost = 0.5 * (num / torch.clamp(den, min=1e-9)).sum(-1)
    cost_np = cost.cpu().numpy().astype(np.float64)
    assign = linear_assignment(cost_np)
    return float(np.mean([cost_np[i, j] for i, j in enumerate(assign) if j >= 0]))


class TPSTransform(NamedTuple):
    src: torch.Tensor  # [N, 2] control points
    weights: torch.Tensor  # [N + 3, 2]


def _tps_kernel(r2: torch.Tensor) -> torch.Tensor:
    return torch.where(r2 > 1e-12, 0.5 * r2 * torch.log(torch.clamp(r2, min=1e-12)),
                       torch.zeros_like(r2))


def fit_tps(src, dst, regularization: float = 0.0, device=None) -> TPSTransform:
    """Thin-plate spline mapping src -> dst (TpsTransformer analog)."""
    src = on_device(src, device).to(torch.float32)
    dst = on_device(dst, src.device).to(torch.float32)
    dev = src.device
    n = src.shape[0]
    d = _pairwise_dist(src, src)
    K = _tps_kernel(d * d) + regularization * torch.eye(n, device=dev)
    P = torch.cat([torch.ones((n, 1), device=dev), src], 1)  # [N, 3]
    A = torch.cat([torch.cat([K, P], 1), torch.cat([P.T, torch.zeros((3, 3), device=dev)], 1)], 0)
    rhs = torch.cat([dst, torch.zeros((3, 2), device=dev)], 0)
    return TPSTransform(src=src, weights=torch.linalg.solve(A, rhs))


def apply_tps(tps: TPSTransform, pts) -> torch.Tensor:
    pts = on_device(pts, tps.src.device).to(torch.float32)
    d = _pairwise_dist(pts, tps.src)
    U = _tps_kernel(d * d)  # [M, N]
    P = torch.cat([torch.ones((pts.shape[0], 1), device=pts.device), pts], 1)
    with no_tf32():
        return torch.cat([U, P], 1) @ tps.weights


def emd_l1_1d(h1, h2, device=None) -> torch.Tensor:
    """Exact EMD with L1 ground distance between 1-D histograms of equal
    mass: sum |cumsum(h1 - h2)| (the closed form the tree solver in the
    reference's emdL1.cpp generalizes to 2-D/3-D)."""
    h1 = on_device(h1, device)
    d = h1.reshape(-1) - on_device(h2, h1.device).reshape(-1)
    return torch.cumsum(d[:-1], 0).abs().sum()


def emd_l1(h1, h2, epsilon: float = 0.02, iters: int = 300, device=None) -> torch.Tensor:
    """EMD-L1 between (1-D or 2-D) histograms (cv::EMDL1 analog,
    shape/src/emdL1.cpp): the 1-D closed form, else entropy-regularized
    log-domain Sinkhorn with dense [N, N] kernels, as the JAX function."""
    h1 = on_device(h1, device).to(torch.float32)
    h2 = on_device(h2, h1.device).to(torch.float32)
    if h1.ndim == 1 or (h1.ndim == 2 and 1 in h1.shape):
        s1, s2 = torch.clamp(h1.sum(), min=1e-12), torch.clamp(h2.sum(), min=1e-12)
        return emd_l1_1d(h1 / s1, h2 / s2) * s1

    dev = h1.device
    yy, xx = torch.meshgrid(torch.arange(h1.shape[0], dtype=torch.float32, device=dev),
                            torch.arange(h1.shape[1], dtype=torch.float32, device=dev),
                            indexing="ij")
    pts = torch.stack([yy.reshape(-1), xx.reshape(-1)], 1)  # [N, 2]
    cost = (pts[:, None, :] - pts[None, :, :]).abs().sum(-1)  # L1

    a = h1.reshape(-1)
    b = h2.reshape(-1)
    total = torch.clamp(a.sum(), min=1e-12)
    a = torch.clamp(a / total, min=1e-9)
    b = torch.clamp(b / torch.clamp(b.sum(), min=1e-12), min=1e-9)
    log_a, log_b = torch.log(a), torch.log(b)
    f = torch.zeros_like(a)
    g = torch.zeros_like(b)
    for _ in range(iters):
        f = epsilon * log_a - epsilon * torch.logsumexp(true_div(g[None, :] - cost, epsilon), 1)
        g = epsilon * log_b - epsilon * torch.logsumexp(true_div(f[:, None] - cost, epsilon), 0)
    plan = torch.exp(true_div(f[:, None] + g[None, :] - cost, epsilon))
    return (plan * cost).sum() * total


# ---------------------------------------------------------------------------
# exact EMD — transportation LP (imgproc/src/emd.cpp:1)


def emd_exact(w1, w2, cost=None, pos1=None, pos2=None, metric="l2", max_pivots=5000) -> float:
    """cv::EMD: exact earth mover's distance between two weighted
    signatures (imgproc/src/emd.cpp:1), solved as Rubner's transportation
    LP on the port's exact simplex (`solve_lp`, the cv::solveLP analog):
        min sum c_ij f_ij   s.t.  f >= 0,
        sum_j f_ij <= w1_i,  sum_i f_ij <= w2_j,
        sum_ij f_ij >= min(|w1|, |w2|)
    w1 [M], w2 [N] weights; either cost [M, N] or positions pos1/pos2
    with metric "l1" | "l2". Returns total_cost / max(|w1|, |w2|) (cv2.EMD's
    measured normalization). Host numpy: the pivots are sequential."""
    w1 = np.asarray(w1, np.float64).ravel()
    w2 = np.asarray(w2, np.float64).ravel()
    if cost is None:
        p1 = np.asarray(pos1, np.float64).reshape(len(w1), -1)
        p2 = np.asarray(pos2, np.float64).reshape(len(w2), -1)
        d = p1[:, None, :] - p2[None, :, :]
        cost = np.abs(d).sum(-1) if metric == "l1" else np.sqrt((d * d).sum(-1))
    else:
        cost = np.asarray(cost, np.float64)

    keep1 = w1 > 0
    keep2 = w2 > 0
    w1, w2 = w1[keep1], w2[keep2]
    cost = cost[np.ix_(keep1, keep2)]
    m, n = cost.shape
    total = min(w1.sum(), w2.sum())
    # cv2 normalizes by the LARGER total mass (emd.cpp total_weight after
    # dummy balancing), not Rubner's min — measured convention
    divisor = max(w1.sum(), w2.sum())

    A = np.zeros((m + n + 1, m * n))
    for i in range(m):
        A[i, i * n:(i + 1) * n] = 1.0  # row supply
    for j in range(n):
        A[m + j, j::n] = 1.0  # column demand
    A[m + n, :] = -1.0  # -sum f <= -total
    b = np.concatenate([w1, w2, [-total]])
    res = solve_lp(-cost.ravel(), A, b, max_pivots=max_pivots, device="cpu")
    f = res.x.numpy().astype(np.float64)
    return float(cost.ravel() @ f) / max(divisor, 1e-300)
