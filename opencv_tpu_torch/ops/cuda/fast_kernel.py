"""FAST score + 3x3 NMS: CUDA kernel `csrc/fast.cu` and its plain version.

Replaces the Pallas kernels of opencv_tpu/ops/pallas/fast_kernel.py:
K1 `_fast_nms_strip_kernel` (fast_corners_pallas) and K2
`_fast_strip_kernel` (fast_score_pallas). The kernel covers rings of 16,
12 and 8 taps and any arc length; the border cut is the ring radius.

Bound and design: see the note at the top of csrc/fast.cu (one thread per
pixel over a shared-memory tile with a 4-pixel halo; about 12 MB moved for
the 8 ORB levels of a 480x640 frame).
"""

from __future__ import annotations

import ctypes

import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.ops import cuda as _counts
from opencv_tpu_torch.ops.cuda import _build

NEG = -1e9

# Bresenham rings (dx, dy), clockwise from 12 o'clock (opencv_tpu/ops/fast.py)
CIRCLE16 = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
CIRCLE12 = (
    (0, -2), (1, -2), (2, -1), (2, 0), (2, 1), (1, 2),
    (0, 2), (-1, 2), (-2, 1), (-2, 0), (-2, -1), (-1, -2),
)
CIRCLE8 = (
    (0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1),
)
PATTERNS = {16: (CIRCLE16, 9, 3), 12: (CIRCLE12, 7, 2), 8: (CIRCLE8, 5, 1)}


# ------------------------------------------------------------ plain version


def _circular_window_min(x: torch.Tensor, n: int) -> torch.Tensor:
    """out[i] = min(x[i], ..., x[i+n-1]) along dim 0, indices mod len."""
    have = {1: x}

    def get(k: int) -> torch.Tensor:
        if k in have:
            return have[k]
        half = 1 << (k.bit_length() - 1)
        if half == k:
            h = get(k // 2)
            have[k] = torch.minimum(h, torch.roll(h, -(k // 2), dims=0))
        else:
            have[k] = torch.minimum(get(half), torch.roll(get(k - half), -half, dims=0))
        return have[k]

    return get(n)


def _inside(h: int, w: int, radius: int, device) -> torch.Tensor:
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return (yy >= radius) & (yy < h - radius) & (xx >= radius) & (xx < w - radius)


def fast_score_plain(
    img: torch.Tensor, arc_length: int | None = None, pattern_size: int = 16
) -> torch.Tensor:
    """FAST score of every pixel of [H, W]; NEG within the ring radius
    of the border (the XLA path of opencv_tpu/ops/fast.py:fast_score)."""
    circle, default_arc, radius = PATTERNS[pattern_size]
    arc = default_arc if arc_length is None else arc_length
    img = img.to(torch.float32)
    taps = torch.stack([imgproc.shift2d(img, dy, dx, 0.0) for (dx, dy) in circle])
    diff_bright = taps - img[None]
    diff_dark = -diff_bright
    vb = _circular_window_min(diff_bright, arc).amax(dim=0)
    vd = _circular_window_min(diff_dark, arc).amax(dim=0)
    score = torch.maximum(vb, vd)
    h, w = img.shape
    return torch.where(_inside(h, w, radius, img.device), score, torch.full_like(score, NEG))


def fast_corners_plain(
    img: torch.Tensor, threshold: float, arc_length: int | None = None,
    pattern_size: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(score, nms_score): nms_score is the score at thresholded 3x3-NMS
    survivors and NEG elsewhere; the border is cut before NMS."""
    score = fast_score_plain(img, arc_length, pattern_size)
    h, w = score.shape
    inside = _inside(h, w, PATTERNS[pattern_size][2], score.device)
    neg = torch.full_like(score, NEG)
    masked = torch.where(inside & (score > threshold), score, neg)
    keep = masked > NEG
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nb = imgproc.shift2d(masked, dy, dx, fill=NEG)
            keep &= (masked > nb) if (dy, dx) < (0, 0) else (masked >= nb)
    return score, torch.where(keep, masked, neg)


# ------------------------------------------------------------ CUDA kernel


def _lib():
    lib = _build.load("fast")
    if not getattr(lib, "_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fast_launch.argtypes = [vp, vp, vp, ci, ci, cf, ci, ci, ci, vp]
        lib.fast_launch.restype = ci
        lib._typed = True
    return lib


def _check_image(img: torch.Tensor) -> None:
    if img.dim() != 2 or img.numel() == 0:
        raise ValueError(f"fast kernel: expected one image [H, W], got {tuple(img.shape)}")


def _launch(img: torch.Tensor, threshold: float, arc: int, pattern: int, do_nms: bool):
    if img.device.type != "cuda":
        raise ValueError(f"fast kernel: expected a CUDA tensor, got {img.device}")
    if pattern not in PATTERNS or not 1 <= arc <= pattern:
        raise ValueError(f"fast kernel: pattern {pattern}, arc {arc}")
    x = img.to(torch.float32).contiguous()
    h, w = x.shape
    score = torch.empty_like(x)
    nms = torch.empty_like(x) if do_nms else None
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.fast_launch(
            x.data_ptr(), score.data_ptr(), nms.data_ptr() if do_nms else None,
            h, w, float(threshold), int(arc), int(pattern), int(do_nms),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, "fast", rc)
    return score, nms


def fast_corners_cuda(
    img: torch.Tensor, threshold: float, arc_length: int | None = None,
    pattern_size: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: fused FAST score + threshold + border cut + 3x3 NMS on one
    image [H, W]. Returns (score, nms_score); nms_score > -1e8 exactly at
    the corners. CPU tensors take the plain version."""
    _check_image(img)
    if img.device.type == "cpu":
        return fast_corners_plain(img, threshold, arc_length, pattern_size)
    arc = PATTERNS[pattern_size][1] if arc_length is None else arc_length
    score, nms = _launch(img, threshold, arc, pattern_size, True)
    _counts.launch_counts["fast_corners"] += 1
    return score, nms


def fast_score_cuda(
    img: torch.Tensor, arc_length: int | None = None, pattern_size: int = 16
) -> torch.Tensor:
    """K2: FAST score only (no threshold, no NMS) on one image [H, W]."""
    _check_image(img)
    if img.device.type == "cpu":
        return fast_score_plain(img, arc_length, pattern_size)
    arc = PATTERNS[pattern_size][1] if arc_length is None else arc_length
    score, _ = _launch(img, 0.0, arc, pattern_size, False)
    _counts.launch_counts["fast_score"] += 1
    return score
