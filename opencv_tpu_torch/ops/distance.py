"""Distance transform, flood fill, mean-shift filtering and segmentation
(port of opencv_tpu/ops/distance.py; cv::distanceTransform, imgproc/src/
distransform.cpp; cv::floodFill, floodfill.cpp; cuda::meanShiftFiltering
and meanShiftSegmentation, cudaimgproc/src/mean_shift.cpp,
mssegmentation.cpp).

- The exact Euclidean distance transform keeps the JAX package's dense
  lower-envelope form: per axis, the minimum over an [n, n] candidate
  matrix, an [H, W, W] tensor (786 MB of f32 at 480x640). Minima of sums
  of integers: exact.
- Flood fill and the segmentation's labelling propagate to a fixed
  point. The JAX package tests for change after every sweep inside a
  `lax.while_loop`; here the host reads one flag per `_CHECK_EVERY`
  sweeps (as `ops/ccomp.py`). A sweep at the fixed point changes
  nothing, so the result is exact.
- Mean-shift filtering adds 0/1-weighted neighbours in the JAX order:
  exact. The segmentation's region means are f32 scatter sums, whose
  order the device chooses: within a few ulps.
"""

from __future__ import annotations

import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.device import on_device, true_div

_CHECK_EVERY = 8  # sweeps per host read of the convergence flag
_N4 = ((-1, 0), (1, 0), (0, -1), (0, 1))


def _edt_1d(f: torch.Tensor) -> torch.Tensor:
    """1-D squared-distance transform along the last axis:
    out[i] = min_j (i - j)^2 + f[j]. Dense candidate form."""
    n = f.shape[-1]
    i = torch.arange(n, dtype=torch.float32, device=f.device)
    d = (i[:, None] - i[None, :]) ** 2  # [n, n]
    return (f[..., None, :] + d).amin(-1)


def distance_transform(mask, device=None) -> torch.Tensor:
    """Exact Euclidean distance to the nearest zero (background) pixel
    for every nonzero pixel (cv::distanceTransform DIST_L2 with exact
    computation; the reference's 3x3/5x5 masks are approximations)."""
    mask = on_device(mask, device) != 0
    big = torch.full(mask.shape, 1e12, dtype=torch.float32, device=mask.device)
    f = torch.where(mask, big, torch.zeros_like(big))
    d = _edt_1d(f)  # along columns of each row
    d = _edt_1d(d.T).T  # then along rows of each column
    return torch.sqrt(d)


def _fixed_point(step, x: torch.Tensor) -> torch.Tensor:
    """Apply `step` until it changes nothing, reading the host flag once
    per _CHECK_EVERY sweeps."""
    while True:
        for _ in range(_CHECK_EVERY - 1):
            x = step(x)
        new = step(x)
        if torch.equal(new, x):
            return new
        x = new


def flood_fill(img, seed: tuple[int, int], new_val: float, lo_diff: float = 0.0,
               up_diff: float = 0.0, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """cv::floodFill analog (fixed-range variant): fill the 4-connected
    region around `seed` (x, y) whose values lie within [seed - lo, seed +
    up]. Returns (filled image, region mask)."""
    img = on_device(img, device)
    sy, sx = seed[1], seed[0]
    sval = img[sy, sx]
    candidate = (img >= sval - lo_diff) & (img <= sval + up_diff)
    region = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
    region[sy, sx] = True

    def grow(r):
        grown = r
        for dy, dx in _N4:
            grown = grown | imgproc.shift2d(r, dy, dx, False)
        return grown & candidate

    region = _fixed_point(grow, region)
    return torch.where(region, torch.full_like(img, new_val), img), region


def mean_shift_filter(img, spatial_radius: int = 5, range_radius: float = 20.0, iters: int = 5,
                      device=None) -> torch.Tensor:
    """Grayscale mean-shift filtering (cuda::meanShiftFiltering analog):
    every pixel's value iterates toward the mode of its joint
    spatial/range neighbourhood."""
    img = on_device(img, device).to(torch.float32)
    r = spatial_radius
    nbs = [imgproc.shift2d(img, dy, dx, fill=1e9)
           for dy in range(-r, r + 1) for dx in range(-r, r + 1) if dy * dy + dx * dx <= r * r]
    cur = img
    for _ in range(iters):
        num = torch.zeros_like(cur)
        den = torch.zeros_like(cur)
        for nb in nbs:
            w = ((nb - cur).abs() <= range_radius).to(torch.float32)
            num = num + w * nb
            den = den + w
        cur = num / torch.clamp(den, min=1.0)
    return cur


def mean_shift_segmentation(img, spatial_radius: int = 5, range_radius: float = 20.0,
                            min_size: int = 20, iters: int = 5,
                            device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean-shift segmentation (cuda::meanShiftSegmentation analog,
    cudaimgproc/src/mssegmentation.cpp): filter to modes, then merge
    pixels whose filtered values quantize to the same range_radius bin as
    their 4-neighbours into labeled regions; regions below min_size
    dissolve into a large neighbour's label by one pass per direction.

    Returns (labels i32 [H, W] — 1-based region ids, segmented image
    f32 [H, W] — per-region mean of the filtered values)."""
    f = mean_shift_filter(img, spatial_radius, range_radius, iters, device)
    dev = f.device
    h, w = f.shape
    q = torch.round(true_div(f, max(range_radius, 1e-6))).to(torch.int32)
    big = h * w + 2
    labels = torch.arange(1, h * w + 1, dtype=torch.int32, device=dev).reshape(h, w)
    same = [imgproc.shift2d(q, dy, dx, fill=-(2 ** 30)) == q for dy, dx in _N4]

    def sweep(lab):
        best = lab
        for (dy, dx), s in zip(_N4, same):
            nb = imgproc.shift2d(lab, dy, dx, fill=big)
            best = torch.minimum(best, torch.where(s, nb, torch.full_like(nb, big)))
        return best

    labels = _fixed_point(sweep, labels)

    # region means + small-region absorption
    n = h * w + 2
    flat = labels.reshape(-1).long()
    cnt = torch.zeros(n, dtype=torch.float32, device=dev).index_add_(
        0, flat, torch.ones(h * w, dtype=torch.float32, device=dev))
    ssum = torch.zeros(n, dtype=torch.float32, device=dev).index_add_(0, flat, f.reshape(-1))
    mean = ssum / torch.clamp(cnt, min=1.0)
    small = (cnt[flat] < min_size).reshape(h, w)
    # dissolve small regions: take any large 4-neighbour's label
    for dy, dx in _N4:
        nb_lab = imgproc.shift2d(labels, dy, dx, fill=0)
        nb_small = imgproc.shift2d(small, dy, dx, fill=True)
        labels = torch.where(small & ~nb_small & (nb_lab > 0), nb_lab, labels)
        small = (cnt[labels.reshape(-1).long()] < min_size).reshape(h, w)
    seg = mean[labels.reshape(-1).long()].reshape(h, w)
    return labels, seg
