"""AGAST corner detection (port of opencv_tpu/ops/agast.py; reference
features2d/src/agast.cpp and agast_score.cpp).

AGAST's decision trees approximate the arc segment test that FAST
evaluates; the JAX package evaluates that test for every pixel at once
with FAST's shift-and-min tree, on one of four ring geometries
(agast.py:36-45). Three of them are FAST's own: OAST_9_16 is ring 16 with
arc 9, AGAST_7_12s ring 12 with arc 7, AGAST_5_8 ring 8 with arc 5, each
with FAST's taps, `_circular_window_min`, border radius and -1e9 fill
(agast.py:49-71 against fast.py:94-112). So the port's
`fast.fast_score(img, arc, ring)` computes the same function: K2 (the
score mode of csrc/fast.cu) on the card, its plain version on the CPU.
AGAST_7_12d, the diamond ring (agast.py:30-33), has no kernel in either
package and stays plain PyTorch here. NMS is `imgproc.nms_2d`, as the JAX
function takes it (agast.py:89), not K1's fused NMS, whose tie rule
differs.
"""

from __future__ import annotations

import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.core.types import KeyPoints, masked_top_k
from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.ops import fast
from opencv_tpu_torch.ops.cuda.fast_kernel import NEG, _circular_window_min, _inside

# agast.cpp's diamond: the L1 ball of radius 3, 12 taps (dx, dy), clockwise
DIAMOND12 = (
    (0, -3), (1, -2), (2, -1), (3, 0), (2, 1), (1, 2),
    (0, 3), (-1, 2), (-2, 1), (-3, 0), (-2, -1), (-1, -2),
)

AGAST_5_8 = "5_8"
AGAST_7_12d = "7_12d"
AGAST_7_12s = "7_12s"
OAST_9_16 = "9_16"
# kind -> (FAST ring size, arc) for the kinds that are FAST's rings
FAST_RINGS = {AGAST_5_8: (8, 5), AGAST_7_12s: (12, 7), OAST_9_16: (16, 9)}
KINDS = (AGAST_5_8, AGAST_7_12d, AGAST_7_12s, OAST_9_16)


def _diamond_score(img: torch.Tensor) -> torch.Tensor:
    """AGAST_7_12d score (agast.py:49-71 with the diamond ring, arc 7,
    border radius 3)."""
    taps = torch.stack([imgproc.shift2d(img, dy, dx, 0.0) for (dx, dy) in DIAMOND12])
    diff_bright = taps - img[None]
    vb = _circular_window_min(diff_bright, 7).amax(dim=0)
    vd = _circular_window_min(-diff_bright, 7).amax(dim=0)
    score = torch.maximum(vb, vd)
    h, w = img.shape
    return torch.where(_inside(h, w, 3, img.device), score, torch.full_like(score, NEG))


def agast_score(img: torch.Tensor, kind: str = OAST_9_16) -> torch.Tensor:
    """Per-pixel AGAST score f32 [H, W] (the largest t for which an arc of
    consecutive ring taps is all brighter than p + t or all darker than
    p - t); -1e9 within the ring radius of the border. Rings 16/12/8 run
    K2 on a CUDA tensor."""
    img = img.to(torch.float32)
    if kind in FAST_RINGS:
        ring, arc = FAST_RINGS[kind]
        return fast.fast_score(img, arc, ring)
    if kind != AGAST_7_12d:
        raise ValueError(f"unknown AGAST kind {kind!r}; expected one of {KINDS}")
    return _diamond_score(img)


def agast_detect(
    img,
    max_keypoints: int,
    threshold: float = 10.0,
    kind: str = OAST_9_16,
    nonmax_suppression: bool = True,
    device=None,
) -> KeyPoints:
    """The `max_keypoints` strongest AGAST corners (cv::AGAST analog;
    threshold 10 as AgastFeatureDetector::create). Runs on the card
    unless `device="cpu"`."""
    img = torch.as_tensor(img, device=resolve_device(device)).to(torch.float32)
    h, w = img.shape
    score = agast_score(img, kind)
    corner = score > threshold
    if nonmax_suppression:
        corner &= imgproc.nms_2d(torch.where(corner, score, -float("inf")))
    flat = score.reshape(-1)
    idx, keep = masked_top_k(flat, corner.reshape(-1), max_keypoints)
    n, dev = idx.shape[0], img.device
    return KeyPoints(
        xy=torch.stack([(idx % w).float(), (idx // w).float()], dim=-1),
        response=torch.where(keep, flat[idx], -float("inf")),
        angle=torch.zeros((n,), dtype=torch.float32, device=dev),
        level=torch.zeros((n,), dtype=torch.int32, device=dev),
        size=torch.full((n,), 7.0, dtype=torch.float32, device=dev),
        valid=keep,
    )
