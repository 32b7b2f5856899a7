"""Streaming 2-NN Hamming matcher: CUDA kernel `csrc/knn2_hamming.cu` and
its plain version.

Replaces the Pallas kernel `_knn2_kernel` of opencv_tpu/ops/pallas/knn.py:30
(knn2_hamming / knn_match_streaming): a running (d1, d2, i1) per query
over the train set, lowest index first on ties, invalid train rows never
selected, then ratio and max-distance tests and no cross-check.

Descriptors are int32 [N, W] packed words: W = 8 (256 bits, ORB) or
W = 16 (512 bits, BRISK and AKAZE); the kernel is compiled for both.

Bound and design: see the note at the top of csrc/knn2_hamming.cu. The
distances are an exact int8 product on Hopper's tensor cores (wgmma, +-64
query bytes against 0 / 2^m train bytes, one more k32 step carrying each
train row's rank and validity), so the bound is the product's int8
operations: ~0.060 ms at 2000 x 115 200 valid rows x 256 bits on an H100
SXM. A producer warpgroup unpacks train tiles into a ring of shared-memory
stages, two consumer warpgroups take the tensor cores in turns and fold
each tile into a running top-2 per query without writing the distance
matrix; the train set is split over blockIdx.y, about one block per SM,
and the splits are merged in order.
"""

from __future__ import annotations

import ctypes

import torch

from opencv_tpu_torch.core.types import Matches
from opencv_tpu_torch.ops import cuda as _counts
from opencv_tpu_torch.ops.cuda import _build

FAR = 512.0  # initial d1 = d2 at every width (knn.py BIG = 2 * 256)
KERNEL_WORDS = (8, 16)  # the widths K3 is compiled for: 256 and 512 bits


def desc_bits(desc: torch.Tensor) -> int:
    """Bits of a packed descriptor: 32 per int32 word."""
    return 32 * desc.shape[1]


def signed_descriptors(desc: torch.Tensor) -> torch.Tensor:
    """int32 [N, W] packed descriptors -> +-1 f32 [N, 32 W] (bit k of word
    i is column 32*i + k, as opencv_tpu.ops.matching.unpack_bits)."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int32)
    bits = (desc[:, :, None] >> shifts) & 1
    return torch.where(bits.reshape(desc.shape[0], -1) != 0, 1.0, -1.0).to(torch.float32)


# ------------------------------------------------------------ plain version


def knn2_hamming_plain(
    query: torch.Tensor, train: torch.Tensor, train_valid: torch.Tensor | None = None,
    chunk: int = 8192,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d1 f32 [Nq], d2 f32 [Nq], i1 i64 [Nq]) over train chunks; distances
    come from the exact +-1 f32 product, the merge is the kernel's. A
    distance of FAR or more never enters (d1, d2)."""
    nq = query.shape[0]
    bits = desc_bits(query)
    dev = query.device
    sq = signed_descriptors(query)
    d1 = torch.full((nq,), FAR, dtype=torch.float32, device=dev)
    d2 = torch.full((nq,), FAR, dtype=torch.float32, device=dev)
    i1 = torch.zeros((nq,), dtype=torch.int64, device=dev)
    for s in range(0, train.shape[0], chunk):
        st = signed_descriptors(train[s : s + chunk])
        dist = (bits - sq @ st.T) * 0.5
        if train_valid is not None:
            # invalid rows lie beyond FAR and so never enter (d1, d2)
            dist = dist + torch.where(train_valid[s : s + chunk], 0.0, 2 * FAR)[None, :]
        l1, l1_idx = torch.min(dist, dim=1)  # first index of the minimum
        cols = torch.arange(dist.shape[1], device=dev)[None, :]
        l2 = torch.where(cols == l1_idx[:, None], FAR, dist).amin(dim=1)
        better = l1 < d1
        d2 = torch.where(better, torch.minimum(d1, l2), torch.minimum(d2, torch.minimum(l1, l2)))
        i1 = torch.where(better, l1_idx + s, i1)
        d1 = torch.where(better, l1, d1)
    return d1, d2, i1


# ------------------------------------------------------------ CUDA kernel


def _lib():
    lib = _build.load("knn2_hamming")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.knn2_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp]
        lib.knn2_launch.restype = ci
        lib.knn2_tile_rows.restype = ci
        lib._typed = True
    return lib


def _split_plan(nq: int, nt: int, tile: int, n_sm: int) -> tuple[int, int]:
    """(rows_per_split, splits): one wave of blocks, about one per SM (a
    block fills its SM), each split a whole number of tiles."""
    q_blocks = -(-nq // 128)
    want = max(1, min(n_sm // q_blocks, -(-nt // tile)))
    rows = -(-(-(-nt // want)) // tile) * tile
    return rows, -(-nt // rows)


def knn2_hamming_cuda(
    query: torch.Tensor, train: torch.Tensor, train_valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3: streaming 2-NN over int32 [N, W] packed descriptors, W = 8 or
    16 words (256 or 512 bits). Returns (d1 f32 [Nq], d2 f32 [Nq], i1 i64
    [Nq]). CPU tensors take the plain version."""
    if query.device.type == "cpu":
        return knn2_hamming_plain(query, train, train_valid)
    words = query.shape[1] if query.dim() == 2 else None
    for name, x in (("query", query), ("train", train)):
        if (x.device.type != "cuda" or x.dtype != torch.int32 or x.dim() != 2
                or x.shape[1] != words or words not in KERNEL_WORDS):
            raise ValueError(f"knn2 kernel: {name} must be CUDA int32 [N, 8 or 16] (256 or 512 "
                             f"bits, both sides alike), got {x.device} {x.dtype} {tuple(x.shape)}")
    nq, nt = query.shape[0], train.shape[0]
    if nq == 0 or nt == 0:
        raise ValueError("knn2 kernel: empty query or train set")
    q = query.contiguous()
    t = train.contiguous()
    if q.data_ptr() % 16 or t.data_ptr() % 16:
        q, t = q.clone(), t.clone()
    tv = None
    if train_valid is not None:
        if train_valid.shape != (nt,):
            raise ValueError("knn2 kernel: train_valid must be [Nt]")
        tv = train_valid.to(device=t.device).contiguous()
        tv = tv.view(torch.uint8) if tv.dtype == torch.bool else tv.to(torch.uint8)
    lib = _lib()
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    rows, splits = _split_plan(nq, nt, lib.knn2_tile_rows(), n_sm)
    scratch = torch.empty((3, splits, nq), dtype=torch.int32, device=q.device)
    d1 = torch.empty((nq,), dtype=torch.float32, device=q.device)
    d2 = torch.empty_like(d1)
    i1 = torch.empty((nq,), dtype=torch.int64, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.knn2_launch(
            q.data_ptr(), t.data_ptr(), None if tv is None else tv.data_ptr(),
            nq, nt, words // 4, rows, splits,
            scratch[0].data_ptr(), scratch[1].data_ptr(), scratch[2].data_ptr(),
            d1.data_ptr(), d2.data_ptr(), i1.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, "knn2", rc)
    _counts.launch_counts["knn2_hamming"] += 1
    return d1, d2, i1


def knn_match_streaming(
    query_desc: torch.Tensor, train_desc: torch.Tensor,
    query_valid: torch.Tensor | None = None, train_valid: torch.Tensor | None = None,
    ratio: float = 0.8, max_distance: float = 256.0,
) -> Matches:
    """Ratio-test matcher over the streaming 2-NN (no cross-check)."""
    nq = query_desc.shape[0]
    d1, d2, i1 = knn2_hamming_cuda(query_desc, train_desc, train_valid)
    ok = (d1 <= max_distance) & (d1 < ratio * d2)
    if train_valid is not None:
        ok &= train_valid[i1]
    if query_valid is not None:
        ok &= query_valid
    return Matches(
        query_idx=torch.arange(nq, device=query_desc.device),
        train_idx=i1, distance=d1, valid=ok,
    )
