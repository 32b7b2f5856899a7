"""FAST segment-test corner detection (port of opencv_tpu/ops/fast.py).

The score V(p) = max over arc windows of min(tap - p) (bright) or
min(p - tap) (dark) is computed by the kernels of ops/cuda/fast_kernel.py:
on a CUDA tensor the hand-written kernel (K1 with NMS, K2 score only), on
a CPU tensor their plain version, which is the XLA formulation of the
JAX package. Keypoint compaction is a masked stable top-k.
"""

from __future__ import annotations

import torch

from opencv_tpu_torch.core.types import KeyPoints, masked_top_k
from opencv_tpu_torch.ops.cuda import fast_kernel
# the Bresenham rings and {ring size: (ring, default arc, radius)}, as the
# JAX module exports them: the kernel module's own objects
from opencv_tpu_torch.ops.cuda.fast_kernel import CIRCLE8, CIRCLE12, CIRCLE16, PATTERNS  # noqa: F401


def fast_score(
    img: torch.Tensor, arc_length: int | None = None, pattern_size: int = 16
) -> torch.Tensor:
    """Per-pixel FAST score, f32 [H, W]; -1e9 within the ring radius of
    the border."""
    return fast_kernel.fast_score_cuda(img, arc_length, pattern_size)


def fast_corners(
    img: torch.Tensor,
    threshold: float,
    arc_length: int | None = None,
    pattern_size: int = 16,
    nonmax_suppression: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(score [H,W], corner_mask [H,W]): cv::FAST's and ORB's detection
    front half. With NMS this is one fused kernel launch."""
    if nonmax_suppression:
        score, nmsed = fast_kernel.fast_corners_cuda(img, threshold, arc_length, pattern_size)
        return score, nmsed > -1e8
    score = fast_score(img, arc_length, pattern_size)
    return score, score > threshold


def fast_corners_levels(
    levels, threshold: float, arc_length: int | None = None, pattern_size: int = 16,
) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """`fast_corners` with NMS on each image of `levels` (a pyramid's
    levels, one device): [(score, corner_mask)] per level. On the card the
    levels share one kernel launch."""
    return [(score, nmsed > -1e8) for score, nmsed in
            fast_kernel.fast_corners_levels(levels, threshold, arc_length, pattern_size)]


def fast_detect(
    img: torch.Tensor,
    max_keypoints: int,
    threshold: float = 20.0,
    nonmax_suppression: bool = True,
    arc_length: int | None = None,
    pattern_size: int = 16,
    border: int = 3,
) -> KeyPoints:
    """The `max_keypoints` strongest FAST corners (cv::FAST analog)."""
    h, w = img.shape
    score, corner = fast_corners(img, threshold, arc_length, pattern_size, nonmax_suppression)
    if border > 3:
        yy = torch.arange(h, device=img.device)[:, None]
        xx = torch.arange(w, device=img.device)[None, :]
        corner &= (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    flat_score = score.reshape(-1)
    idx, keep = masked_top_k(flat_score, corner.reshape(-1), max_keypoints)
    dev = img.device
    return KeyPoints(
        xy=torch.stack([(idx % w).float(), (idx // w).float()], dim=-1),
        response=torch.where(keep, flat_score[idx], -float("inf")),
        angle=torch.zeros((idx.shape[0],), dtype=torch.float32, device=dev),
        level=torch.zeros((idx.shape[0],), dtype=torch.int32, device=dev),
        size=torch.full((idx.shape[0],), 7.0, dtype=torch.float32, device=dev),
        valid=keep,
    )
