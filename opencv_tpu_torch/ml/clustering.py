"""Clustering: k-means (cv::kmeans, core/src/kmeans.cpp) and
Gaussian-mixture EM (ml/src/em.cpp). Port of opencv_tpu/ml/clustering.py.

One Lloyd or EM iteration is a few whole-dataset matmuls and reductions,
as in the JAX package; its `fori_loop`s are Python loops here. Products
run inside `device.no_tf32()` (the JAX code's Precision.HIGHEST).

Random draws are injected, as the port's RANSAC takes its subsets:
k-means++ draws its picks from a `torch.Generator` (on the generator's
device, so a CPU generator gives the card and the CPU the same picks),
or takes them as `picks` (the row indices of x that become the seeds, in
order), which is how the tests replay the JAX-drawn ones.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from opencv_tpu_torch.device import no_tf32, true_div


def _pairwise_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[N, K] squared distances via the expansion trick."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    c2 = torch.sum(c * c, dim=1)[None, :]
    with no_tf32():
        xc = x @ c.T
    return torch.clamp(x2 + c2 - 2.0 * xc, min=0.0)


def _generator(gen: torch.Generator | None) -> torch.Generator:
    return gen if gen is not None else torch.Generator().manual_seed(0)


def kmeans_pp_picks(gen: torch.Generator | None, x: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ seeding (kmeans.cpp generateCentersPP): the k row indices
    picked, the first uniformly, each next one with probability
    proportional to its squared distance to the nearest pick so far."""
    gen = _generator(gen)
    x = x.float()
    n = x.shape[0]
    picks = [int(torch.randint(0, n, (1,), generator=gen, device=gen.device))]
    mind = _pairwise_sqdist(x, x[picks[0]][None])[:, 0]
    for _ in range(1, k):
        probs = mind / torch.clamp(mind.sum(), min=1e-12)
        nxt = int(torch.multinomial(probs.to(gen.device), 1, generator=gen))
        picks.append(nxt)
        mind = torch.minimum(mind, _pairwise_sqdist(x, x[nxt][None])[:, 0])
    return torch.tensor(picks, dtype=torch.int64, device=x.device)


def kmeans_pp_init(gen: torch.Generator | None, x: torch.Tensor, k: int,
                   picks=None) -> torch.Tensor:
    """The k-means++ seeds [K, D]: x at `picks` (drawn from `gen` when not
    given)."""
    if picks is None:
        picks = kmeans_pp_picks(gen, x, k)
    return x.float()[torch.as_tensor(picks, dtype=torch.int64, device=x.device)]


class KMeansResult(NamedTuple):
    centers: torch.Tensor  # [K, D]
    labels: torch.Tensor  # [N]
    inertia: torch.Tensor  # sum of squared distances


def kmeans(gen: torch.Generator | None, x: torch.Tensor, k: int, iters: int = 30,
           picks=None) -> KMeansResult:
    """cv::kmeans analog (KMEANS_PP_CENTERS + Lloyd iterations)."""
    x = x.float()
    centers = kmeans_pp_init(gen, x, k, picks)
    ar = torch.arange(k, device=x.device)
    for _ in range(iters):
        labels = torch.argmin(_pairwise_sqdist(x, centers), dim=1)
        one_hot = (labels[:, None] == ar[None, :]).float()
        counts = one_hot.sum(dim=0)
        with no_tf32():
            sums = one_hot.T @ x
        new = sums / torch.clamp(counts[:, None], min=1.0)
        centers = torch.where(counts[:, None] > 0, new, centers)  # empty clusters stay
    d = _pairwise_sqdist(x, centers)
    return KMeansResult(centers=centers, labels=torch.argmin(d, dim=1),
                        inertia=torch.min(d, dim=1).values.sum())


class GMMResult(NamedTuple):
    weights: torch.Tensor  # [K]
    means: torch.Tensor  # [K, D]
    variances: torch.Tensor  # [K, D] diagonal covariances
    log_likelihood: torch.Tensor


def _log_prob(x, means, variances, weights):
    """[N, K] log p(x | comp) + log w."""
    diff2 = (x[:, None, :] - means[None, :, :]) ** 2 / variances[None, :, :]
    ll = -0.5 * (diff2.sum(dim=-1)
                 + torch.log(2.0 * math.pi * variances).sum(dim=-1)[None, :])
    return ll + torch.log(weights)[None, :]


def gmm_em(gen: torch.Generator | None, x: torch.Tensor, k: int, iters: int = 50,
           var_floor: float = 1e-4, picks=None) -> GMMResult:
    """Diagonal-covariance Gaussian mixture EM (EM::trainEM analog,
    ml/src/em.cpp with COV_MAT_DIAGONAL), started from 10 k-means
    iterations on the k-means++ seeds (`picks`, or drawn from `gen`)."""
    x = x.float()
    n = x.shape[0]
    means = kmeans(gen, x, k, iters=10, picks=picks).centers
    weights = torch.full((k,), 1.0 / k, device=x.device)
    variances = torch.var(x, dim=0, unbiased=False)[None, :].repeat(k, 1) + var_floor
    for _ in range(iters):
        resp = torch.softmax(_log_prob(x, means, variances, weights), dim=1)  # [N, K]
        nk = resp.sum(dim=0)
        den = torch.clamp(nk[:, None], min=1e-9)
        with no_tf32():
            means = (resp.T @ x) / den
            diff2 = (x[:, None, :] - means[None, :, :]) ** 2
            variances = torch.einsum("nk,nkd->kd", resp, diff2) / den + var_floor
        weights = true_div(nk, n)
    ll = torch.logsumexp(_log_prob(x, means, variances, weights), dim=1).sum()
    return GMMResult(weights, means, variances, ll)
