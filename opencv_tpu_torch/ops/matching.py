"""Brute-force binary descriptor matching (port of opencv_tpu/ops/matching.py).

Hamming distance between 256-bit descriptors is the +-1 product identity
    hamming(a, b) = (256 - a.b) / 2
computed with an f32 `torch.matmul`: the products are +-1 and every sum
is an integer below 2^24, so the result is exact (TF32 keeps +-1 and the
integer penalties exact as well). Map-scale train sets go to the
streaming kernel K3 (ops/cuda/knn.py) instead.
"""

from __future__ import annotations

import torch

from opencv_tpu_torch.core.config import MatchConfig
from opencv_tpu_torch.core.types import Matches
from opencv_tpu_torch.ops.cuda import knn as knn_kernel
from opencv_tpu_torch.ops.cuda.knn import signed_descriptors

DESC_BITS = 256


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """int32 [N, 8] packed descriptors -> bool [N, 256]."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int32)
    return (((desc[:, :, None] >> shifts) & 1) != 0).reshape(desc.shape[0], -1)


def _hamming(query: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """[Nq, Nt] f32 Hamming distances by the +-1 product."""
    return (DESC_BITS - signed_descriptors(query) @ signed_descriptors(train).T) * 0.5


def _distance(query, train, query_valid, train_valid):
    """[Nq, Nt] f32 Hamming distances; invalid rows/cols carry +512, the
    value the JAX matcher's folded penalty columns give them."""
    dist = _hamming(query, train)
    half_big = float(2 * DESC_BITS)  # 4*bits penalty on the dot = +2*bits distance
    if query_valid is not None:
        dist = dist + torch.where(query_valid, 0.0, half_big)[:, None]
    if train_valid is not None:
        dist = dist + torch.where(train_valid, 0.0, half_big)[None, :]
    return dist


def hamming_matrix(
    query: torch.Tensor, train: torch.Tensor,
    query_valid: torch.Tensor | None = None, train_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pairwise Hamming distances f32 [Nq, Nt]; invalid rows/cols = 512."""
    dist = _hamming(query, train)
    big = float(2 * DESC_BITS)
    if query_valid is not None:
        dist = torch.where(query_valid[:, None], dist, big)
    if train_valid is not None:
        dist = torch.where(train_valid[None, :], dist, big)
    return dist


def knn_match(
    query: torch.Tensor, train: torch.Tensor,
    query_valid: torch.Tensor | None = None, train_valid: torch.Tensor | None = None,
    config: MatchConfig = MatchConfig(),
) -> Matches:
    """2-NN match + Lowe ratio test + optional cross-check, one row per
    query (BFMatcher::knnMatch(k=2) + ratio filter). Argmin ties go to the
    lowest index, as in the JAX matcher."""
    nq = query.shape[0]
    dist = _distance(query, train, query_valid, train_valid)
    d1, best = torch.min(dist, dim=1)
    col = torch.arange(dist.shape[1], device=dist.device)[None, :]
    d2 = torch.where(col == best[:, None], float("inf"), dist).amin(dim=1)
    ok = (d1 <= config.max_distance) & (d1 < config.ratio * d2)
    if query_valid is not None:
        ok &= query_valid
    if config.cross_check:
        best_q_for_t = torch.argmin(dist, dim=0)  # [Nt]
        ok &= best_q_for_t[best] == torch.arange(nq, device=dist.device)
    return Matches(
        query_idx=torch.arange(nq, device=dist.device),
        train_idx=best, distance=d1, valid=ok,
    )


# Map-scale matching: at or beyond this many train descriptors the dense
# [Nq, Nt] distance matrix is replaced by the streaming 2-NN kernel K3.
STREAMING_TRAIN_THRESHOLD = 16384


def knn_match_auto(
    query: torch.Tensor, train: torch.Tensor,
    query_valid: torch.Tensor | None = None, train_valid: torch.Tensor | None = None,
    config: MatchConfig = MatchConfig(),
) -> Matches:
    """knn_match that dispatches large train sets to the streaming 2-NN
    (ratio + max distance, no cross-check). The rule depends on the size
    alone, on every device: a CPU tensor runs the kernel's plain version.
    (The JAX package streams only on a TPU and runs the dense matcher on a
    CPU; with cross_check=False both give the same matches.)"""
    if train.shape[0] < STREAMING_TRAIN_THRESHOLD:
        return knn_match(query, train, query_valid, train_valid, config)
    return knn_kernel.knn_match_streaming(
        query, train, query_valid, train_valid,
        ratio=config.ratio, max_distance=config.max_distance,
    )
