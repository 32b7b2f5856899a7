"""Batched-hypothesis RANSAC (port of opencv_tpu/geometry/ransac.py):
generate every hypothesis at once, score every hypothesis at once.

Subsets are drawn by Gumbel-top-k from a `torch.Generator`, or injected
as an [H, S] index tensor. torch cannot replay `jax.random`, so tests
that hold a stage against JAX inject the JAX-drawn subsets.

Model and error functions are batched: model_fn(subsets [H, S]) ->
(models [H, ...], ok [H]); error_fn(models [H, ...]) -> err [H, N].
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from opencv_tpu_torch.core.config import RansacConfig


class RansacResult(NamedTuple):
    model: torch.Tensor  # best model parameters
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor  # scalar i64
    ok: torch.Tensor  # scalar bool


def sample_subsets(
    gen: torch.Generator, n: int, valid: torch.Tensor, n_subsets: int, subset_size: int
) -> torch.Tensor:
    """[H, S] indices of valid points, distinct within each subset
    (Gumbel noise on log-weights, top-S per hypothesis). The noise is
    drawn on the generator's device: a CPU generator gives the same
    subsets for points on the card as on the CPU."""
    u = torch.rand((n_subsets, n), generator=gen, device=gen.device).to(valid.device)
    g = -torch.log(-torch.log(u.clamp(min=1e-20)))
    logw = torch.where(valid, 0.0, -float("inf"))[None, :]
    return torch.topk(g + logw, subset_size, dim=1).indices


def _score(subsets, valid, subset_size, model_fn, error_fn, threshold):
    models, model_ok = model_fn(subsets)
    errs = error_fn(models)  # [H, N]
    inlier_mat = (errs < threshold) & valid[None, :]
    scores = torch.where(model_ok, inlier_mat.sum(dim=1), -1)
    best = torch.argmax(scores)
    return models[best], inlier_mat[best], scores[best]


def ransac(
    gen: torch.Generator | None,
    n_points: int,
    valid: torch.Tensor,
    subset_size: int,
    model_fn: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    error_fn: Callable[[torch.Tensor], torch.Tensor],
    cfg: RansacConfig = RansacConfig(),
    subsets: torch.Tensor | None = None,
) -> RansacResult:
    """Fixed-batch RANSAC over cfg.n_hypotheses hypotheses (or over the
    injected `subsets`). Degenerate samples (model_ok False) score -1."""
    if subsets is None:
        subsets = sample_subsets(gen, n_points, valid, cfg.n_hypotheses, subset_size)
    model, inliers, score = _score(
        subsets, valid, subset_size, model_fn, error_fn, cfg.threshold
    )
    return RansacResult(
        model=model, inliers=inliers, n_inliers=score.clamp(min=0),
        ok=score >= subset_size,
    )


def ransac_adaptive(
    gen: torch.Generator,
    n_points: int,
    valid: torch.Tensor,
    subset_size: int,
    model_fn: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    error_fn: Callable[[torch.Tensor], torch.Tensor],
    cfg: RansacConfig = RansacConfig(),
    chunk: int = 128,
) -> RansacResult:
    """Chunked adaptive RANSAC: `chunk` hypotheses at a time until the
    early-exit rule of RANSACUpdateNumIters (ptsetreg.cpp:53-74) is met
    or cfg.n_hypotheses have been scored. The loop condition reads the
    best count on the host (one sync per chunk)."""
    n_valid = max(int(valid.sum()), 1)
    max_h = cfg.n_hypotheses
    log1mconf = math.log(max(1.0 - cfg.confidence, 1e-12))

    def one_chunk():
        sub = sample_subsets(gen, n_points, valid, chunk, subset_size)
        return _score(sub, valid, subset_size, model_fn, error_fn, cfg.threshold)

    def needed_iters(best_n: int) -> float:
        if best_n <= subset_size:
            return float(max_h)
        w = min(max(best_n / n_valid, 0.0), 1.0 - 1e-6)
        denom = math.log(max(1.0 - w ** subset_size, 1e-12))
        return min(log1mconf / denom, float(max_h))

    model, inliers, best = one_chunk()
    best_n = int(best)
    done = chunk
    while done < needed_iters(best_n) and done < max_h:
        m, inl, nc = one_chunk()
        if int(nc) > best_n:
            model, inliers, best_n = m, inl, int(nc)
        done += chunk
    n = torch.tensor(max(best_n, 0), device=valid.device)
    return RansacResult(
        model=model, inliers=inliers, n_inliers=n,
        ok=torch.tensor(best_n >= subset_size, device=valid.device),
    )
