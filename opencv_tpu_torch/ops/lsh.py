"""LSH index for binary descriptors, the FlannBasedMatcher/LSH analog
(port of opencv_tpu/ops/lsh.py; flann lsh_index.h + lsh_table.h).

Each of `n_tables` tables hashes `key_bits` randomly chosen descriptor
bits to a bucket; a dense [tables, 2^key_bits, capacity] index tensor
holds the train indices (overflow beyond the capacity is dropped, as
lsh_table.h's bucket limit does). Queries probe one bucket per table and
rank the union by Hamming distance: XOR and a 32-bit popcount on the
words, exact integers, so the matches equal the JAX package's.

The bit positions come from the same `np.random.default_rng(seed)` draws
as in the JAX package; the tables are filled by a stable sort of the
rows by bucket id, which keeps train-index order within a bucket, as the
JAX package's row-by-row loop does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opencv_tpu_torch.core.config import MatchConfig
from opencv_tpu_torch.core.types import Matches
from opencv_tpu_torch.device import resolve_device


class LSHIndex(NamedTuple):
    train: torch.Tensor      # [N, W] int32 descriptor words
    buckets: torch.Tensor    # [T, 2^k, C] int64 train indices (-1 = empty)
    bit_words: torch.Tensor  # [T, k] word index of each hashed bit
    bit_shifts: torch.Tensor # [T, k] shift of each hashed bit
    key_bits: int


def build_lsh_index(
    train: np.ndarray,
    n_tables: int = 8,
    key_bits: int = 14,
    bucket_capacity: int = 64,
    seed: int = 0,
    device=None,
) -> LSHIndex:
    """Build the multi-table index (LshIndex::buildIndex analog) on the
    host; the tables go to `device` (None: the card). train: uint32 or
    int32 words [N, W]."""
    dev = resolve_device(device)
    words32 = np.ascontiguousarray(train)
    if words32.dtype == np.int32:
        words32 = words32.view(np.uint32)
    n, w = words32.shape
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.choice(w * 32, key_bits, replace=False) for _ in range(n_tables)])
    words, shifts = pos // 32, pos % 32

    buckets = np.full((n_tables, 1 << key_bits, bucket_capacity), -1, np.int64)
    rows = np.arange(n)
    for t in range(n_tables):
        b = ((words32[:, words[t]] >> shifts[t].astype(np.uint32)) & 1).astype(np.int64)
        ids = (b << np.arange(key_bits, dtype=np.int64)).sum(1)
        order = np.argsort(ids, kind="stable")
        sid = ids[order]
        first = np.searchsorted(sid, sid, side="left")
        rank = rows - first  # position within the bucket, train-index order
        keep = rank < bucket_capacity
        buckets[t, sid[keep], rank[keep]] = order[keep]
    return LSHIndex(
        train=torch.from_numpy(words32.view(np.int32).copy()).to(dev),
        buckets=torch.from_numpy(buckets).to(dev),
        bit_words=torch.from_numpy(words.astype(np.int64)).to(dev),
        bit_shifts=torch.from_numpy(shifts.astype(np.int64)).to(dev),
        key_bits=key_bits,
    )


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word of an int32 tensor, as int64 (SWAR on
    the unsigned value held in int64, so no step overflows)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def knn_match_lsh(
    index: LSHIndex,
    query: torch.Tensor,
    query_valid: torch.Tensor | None = None,
    config: MatchConfig = MatchConfig(),
) -> Matches:
    """Approximate 2-NN + ratio test against the index (FlannBasedMatcher::
    knnMatch with an LSH index). query: int32 words [M, W]. One row per
    query; a query whose buckets are all empty comes back invalid."""
    m = query.shape[0]
    dev = query.device
    if query_valid is None:
        query_valid = torch.ones((m,), dtype=torch.bool, device=dev)
    bits = query.shape[1] * 32
    qw = query[:, index.bit_words].to(torch.int64)  # [M, T, k]
    qb = (qw >> index.bit_shifts[None]) & 1
    ids = (qb << torch.arange(index.key_bits, device=dev)).sum(-1)  # [M, T]
    cand = index.buckets[torch.arange(index.buckets.shape[0], device=dev)[None, :], ids].reshape(m, -1)
    ok = cand >= 0
    cd = index.train[cand.clamp(min=0)]  # [M, T*C, W]
    dist = popcount32(cd ^ query[:, None, :]).sum(-1).to(torch.float32)
    big = float(2 * bits)
    dist = torch.where(ok, dist, big)
    d1, i1 = torch.min(dist, dim=1)
    t1 = torch.gather(cand, 1, i1[:, None])[:, 0]
    # second best among candidates that point at another train row
    d2 = torch.where(cand == t1[:, None], big, dist).amin(dim=1)
    valid = query_valid & (t1 >= 0) & (d1 <= config.max_distance) & (d1 < config.ratio * d2)
    return Matches(query_idx=torch.arange(m, device=dev), train_idx=t1, distance=d1, valid=valid)
