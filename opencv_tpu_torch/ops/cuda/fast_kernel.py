"""FAST score + 3x3 NMS: CUDA kernel `csrc/fast.cu` and its plain version.

Replaces the Pallas kernels of opencv_tpu/ops/pallas/fast_kernel.py:
K1 `_fast_nms_strip_kernel` (fast_corners_pallas) and K2
`_fast_strip_kernel` (fast_score_pallas). The kernel covers rings of 16,
12 and 8 taps and any arc length; the border cut is the ring radius.

Entry points on the card: `fast_corners_levels` (K1 over every level of
a pyramid in one launch, as ORB detects), `fast_corners_cuda` (K1 on one
image) and `fast_score_cuda` (K2), all one kernel.

Design: the default arcs (16/9, 12/7, 8/5) are compiled in and take the
window minima by doubling, at the odd starts only (two starts share a
window of arc-1 taps); other arcs a generic instantiation. The ring's
offsets are constants. A block of 256 threads scores a 32x32 tile plus
its 1-pixel NMS ring, each pixel once, from a shared-memory tile. A
table of up to MAX_LEVELS levels travels in the kernel's arguments, so a
pyramid is one launch; more levels take a further launch. Outputs are
views into one allocation.

Bound: operations and bytes about equally: the kernel's 121 f32
operations per pixel, and 12 bytes read and written per pixel, each
about 0.0034 ms for the 8 ORB levels of a 480x640 frame (0.95 M pixels)
on an H100 SXM. The first design took 0.1119 ms there (NVIDIA H100 80GB
HBM3, 700.00 W, chip_smoke.py): a runtime arc kept about 480 guarded
mins per score, its 32x8 tiles scored the NMS ring in a second, mostly
idle pass, and each level took a launch of its own. This design takes
0.0166 ms. Details in the note at the top of csrc/fast.cu; per-level times
in PERF.md.
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


MAX_LEVELS = 16  # levels per launch: the kernel's level table (kMaxLevels)


def _lib():
    lib = _build.load("fast")
    if not getattr(lib, "_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fast_launch_levels.argtypes = [ci, vp, vp, vp, vp, vp, cf, ci, ci, ci, vp]
        lib.fast_launch_levels.restype = ci
        lib._typed = True
    return lib


def _check_image(img: torch.Tensor) -> None:
    if img.dim() != 2 or img.numel() == 0:
        raise ValueError(f"fast kernel: expected one image [H, W], got {tuple(img.shape)}")


def _check_levels(levels) -> list[torch.Tensor]:
    levels = list(levels)
    if not levels:
        raise ValueError("fast kernel: expected at least one level")
    for lvl in levels:
        _check_image(lvl)
    devices = {lvl.device for lvl in levels}
    if len(devices) != 1:
        raise ValueError(f"fast kernel: levels on several devices: {devices}")
    return levels


def _launch(levels: list[torch.Tensor], threshold: float, arc_length: int | None,
            pattern: int, do_nms: bool, counter: str):
    """Score (and NMS) maps of every level, MAX_LEVELS levels per launch,
    each launch counted under `counter`. Returns (scores, nms or None),
    per-level views into one allocation."""
    dev = levels[0].device
    if dev.type != "cuda":
        raise ValueError(f"fast kernel: expected CUDA tensors, got {dev}")
    arc = PATTERNS[pattern][1] if pattern in PATTERNS and arc_length is None else arc_length
    if pattern not in PATTERNS or not 1 <= arc <= pattern:
        raise ValueError(f"fast kernel: pattern {pattern}, arc {arc}")
    xs = [lvl.to(torch.float32).contiguous() for lvl in levels]
    sizes = [x.numel() for x in xs]
    flat = torch.empty(sum(sizes) * (2 if do_nms else 1), dtype=torch.float32, device=dev)
    views = [v.view(x.shape) for v, x in zip(flat.split(sizes * (2 if do_nms else 1)), xs * 2)]
    scores, nms = views[: len(xs)], (views[len(xs):] if do_nms else None)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i in range(0, len(xs), MAX_LEVELS):
            part = slice(i, i + MAX_LEVELS)
            rc = lib.fast_launch_levels(
                len(xs[part]), _pointers(xs[part]), _pointers(scores[part]),
                _pointers(nms[part]) if do_nms else None,
                _ints([x.shape[0] for x in xs[part]]), _ints([x.shape[1] for x in xs[part]]),
                float(threshold), int(arc), int(pattern), int(do_nms), stream,
            )
            _build.check(lib, "fast", rc)
            _counts.launch_counts[counter] += 1
    return scores, nms


def _pointers(ts: list[torch.Tensor]):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _ints(vals: list[int]):
    return (ctypes.c_int * len(vals))(*vals)


def fast_corners_levels(
    levels, threshold: float, arc_length: int | None = None, pattern_size: int = 16,
) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """K1 over a list of images [H_l, W_l] (a pyramid's levels) on one
    device: [(score, nms_score)] per level, each equal to
    `fast_corners_cuda` on that level. On the card one launch covers up to
    MAX_LEVELS levels; CPU tensors take the plain version level by level."""
    levels = _check_levels(levels)
    if levels[0].device.type == "cpu":
        return [fast_corners_plain(lvl, threshold, arc_length, pattern_size) for lvl in levels]
    scores, nms = _launch(levels, threshold, arc_length, pattern_size, True, "fast_corners")
    return list(zip(scores, nms))


def fast_corners_cuda(
    img: torch.Tensor, threshold: float, arc_length: int | None = None,
    pattern_size: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: fused FAST score + threshold + border cut + 3x3 NMS on one
    image [H, W]. Returns (score, nms_score); nms_score > -1e8 exactly at
    the corners. CPU tensors take the plain version."""
    _check_image(img)
    return fast_corners_levels([img], threshold, arc_length, pattern_size)[0]


def fast_score_cuda(
    img: torch.Tensor, arc_length: int | None = None, pattern_size: int = 16
) -> torch.Tensor:
    """K2: FAST score only (no threshold, no NMS) on one image [H, W]."""
    _check_image(img)
    if img.device.type == "cpu":
        return fast_score_plain(img, arc_length, pattern_size)
    scores, _ = _launch([img], 0.0, arc_length, pattern_size, False, "fast_score")
    return scores[0]
