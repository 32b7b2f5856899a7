"""Brute-force binary descriptor matching (port of opencv_tpu/ops/matching.py).

Hamming distance between b-bit descriptors is the +-1 product identity
    hamming(a, b) = (b - a.b) / 2
computed with an f32 `torch.matmul`: the products are +-1 and every sum
is an integer below 2^24, so the result is exact (TF32 keeps +-1 and the
integer penalties exact as well). The bit count comes from the
descriptors, b = 32 * words, as in the JAX matcher: 256 for ORB's
[N, 8] words, 512 for BRISK's and AKAZE's [N, 16]. Map-scale train sets
go to the streaming kernel K3 (ops/cuda/knn.py) instead.
"""

from __future__ import annotations

import torch

from opencv_tpu_torch.core.config import MatchConfig
from opencv_tpu_torch.core.types import Matches
from opencv_tpu_torch.ops.cuda import knn as knn_kernel
from opencv_tpu_torch.ops.cuda.knn import desc_bits

DESC_BITS = 256  # ORB's width; the functions below take the width from the descriptors


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """int32 [N, W] packed descriptors -> bool [N, 32 W]."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int32)
    return (((desc[:, :, None] >> shifts) & 1) != 0).reshape(desc.shape[0], -1)


def signed_descriptors(desc: torch.Tensor) -> torch.Tensor:
    """int32 [N, W] packed descriptors -> +-1 bf16 [N, 32 W] (the JAX
    package's matmul operand form; bit k of word i is column 32 i + k)."""
    return knn_kernel.signed_descriptors(desc).to(torch.bfloat16)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool [N, B] -> int32 [N, B // 32], bit j of word w = bits[:, 32 w + j]
    (the JAX package's uint32 words as int32): `unpack_bits`' inverse."""
    n, b = bits.shape
    words = bits.reshape(n, b // 32, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(
        32, dtype=torch.int64, device=bits.device)
    words = (words * weights).sum(dim=2)  # [0, 2^32)
    return (words - ((words >> 31) << 32)).to(torch.int32)  # two's-complement wrap


def _hamming(query: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """[Nq, Nt] f32 Hamming distances by the +-1 product."""
    signed = knn_kernel.signed_descriptors  # +-1 f32
    return (desc_bits(query) - signed(query) @ signed(train).T) * 0.5


def _distance(query, train, query_valid, train_valid):
    """[Nq, Nt] f32 Hamming distances; invalid rows/cols carry + 2 * bits,
    the value the JAX matcher's folded penalty columns give them."""
    dist = _hamming(query, train)
    half_big = float(2 * desc_bits(query))  # 4*bits penalty on the dot = +2*bits distance
    if query_valid is not None:
        dist = dist + torch.where(query_valid, 0.0, half_big)[:, None]
    if train_valid is not None:
        dist = dist + torch.where(train_valid, 0.0, half_big)[None, :]
    return dist


def hamming_matrix(
    query: torch.Tensor, train: torch.Tensor,
    query_valid: torch.Tensor | None = None, train_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pairwise Hamming distances f32 [Nq, Nt]; invalid rows/cols = 2 * bits."""
    dist = _hamming(query, train)
    big = float(2 * desc_bits(query))
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


def radius_match_mask(
    query: torch.Tensor, train: torch.Tensor, max_distance: float,
    query_valid: torch.Tensor | None = None, train_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Boolean [Nq, Nt]: pairs within `max_distance` Hamming
    (DescriptorMatcher::radiusMatch analog); invalid rows/cols never match
    below 2 * bits. Callers reduce the mask themselves."""
    return hamming_matrix(query, train, query_valid, train_valid) <= max_distance


# Map-scale matching: at or beyond this many train descriptors the dense
# [Nq, Nt] distance matrix is replaced by the streaming 2-NN kernel K3.
STREAMING_TRAIN_THRESHOLD = 16384


def knn_match_auto(
    query: torch.Tensor, train: torch.Tensor,
    query_valid: torch.Tensor | None = None, train_valid: torch.Tensor | None = None,
    config: MatchConfig = MatchConfig(),
    streaming_threshold: int = STREAMING_TRAIN_THRESHOLD,
    force_streaming: bool | None = None,
) -> Matches:
    """knn_match that dispatches train sets of `streaming_threshold` rows
    or more to the streaming 2-NN (ratio + max distance, no cross-check).
    The rule depends on the size alone, on every device: a CPU tensor runs
    the kernel's plain version. (The JAX package streams only on a TPU and
    runs the dense matcher on a CPU; with cross_check=False both give the
    same matches.) `force_streaming` True or False overrides the rule."""
    use_streaming = (train.shape[0] >= streaming_threshold if force_streaming is None
                     else force_streaming)
    if not use_streaming:
        return knn_match(query, train, query_valid, train_valid, config)
    return knn_kernel.knn_match_streaming(
        query, train, query_valid, train_valid,
        ratio=config.ratio, max_distance=config.max_distance,
    )
