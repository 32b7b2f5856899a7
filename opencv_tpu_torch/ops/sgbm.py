"""Semi-global block matching, StereoSGBM (port of opencv_tpu/ops/sgbm.py;
reference calib3d/src/stereosgbm.cpp).

Birchfield-Tomasi costs of the x-Sobel prefiltered pair plus a quarter of
the raw pair's, box-summed into a [D, H, W] volume, then Hirschmuller's
dynamic program
    Lr(p, d) = C(p, d) + min(Lr(p-r, d), Lr(p-r, d+-1) + P1, min Lr(p-r) + P2)
               - min Lr(p-r)
along 8 (or 4) paths, summed; uniqueness, subpixel parabola, left-right
check and the speckle filter (sgbm.py:60-283).

The JAX function runs each path as a `lax.scan` over rows or columns
(sgbm.py:130-153). Here one Python loop over rows carries all six
row-wise paths at once ([3 predecessor offsets, 2 directions, W, D]) and
one over columns the two column-wise paths: the same min-plus steps in
the same order (additions and minima only), and the paths are summed in
the JAX function's order. The speckle filter's `while_loop`
(sgbm.py:235-283) reads its stop flag on the host once per 16 sweeps; a
sweep at the fixed point changes nothing, so the result is exact.
"""

from __future__ import annotations

import dataclasses

import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.ops.stereo import _prefilter, shifted_planes

INF = 1e9
BIG = 3e4  # finite masked cost: keeps the normalised carry NaN-free
_CHECK_EVERY = 16  # speckle sweeps per host read of the change flag


@dataclasses.dataclass(frozen=True)
class SGBMConfig:
    """cv::StereoSGBM::create's parameters (calib3d.hpp:2476)."""

    min_disparity: int = 0
    num_disparities: int = 64
    block_size: int = 5
    p1: float | None = None  # default 8 * block_size**2
    p2: float | None = None  # default 32 * block_size**2
    prefilter_cap: float = 63.0
    uniqueness_ratio: float = 10.0  # percent
    disp12_max_diff: float = 1.0  # < 0 disables the left-right check
    speckle_window_size: int = 100  # 0 disables
    speckle_range: float = 2.0
    num_paths: int = 8  # 8 = MODE_HH; 4 = axis-aligned only

    def penalties(self) -> tuple[float, float]:
        p1 = 8.0 * self.block_size**2 if self.p1 is None else self.p1
        p2 = 32.0 * self.block_size**2 if self.p2 is None else self.p2
        return float(p1), float(max(p2, p1 + 1.0))


def _half_range(img: torch.Tensor):
    """(lo, hi) of the half-sample interpolated neighbourhood along x."""
    l = 0.5 * (img + imgproc.shift2d(img, 0, 1, fill=0.0))
    r = 0.5 * (img + imgproc.shift2d(img, 0, -1, fill=0.0))
    return torch.minimum(torch.minimum(l, r), img), torch.maximum(torch.maximum(l, r), img)


def _bt_cost(left: torch.Tensor, rs: torch.Tensor) -> torch.Tensor:
    """Birchfield-Tomasi |left(x) - right(x - d)| for the planes rs [D, H, W]
    of the right image moved by d (calcPixelCostBT semantics)."""
    lo_r, hi_r = _half_range(rs)
    lo_l, hi_l = _half_range(left)
    c_l = torch.clamp(torch.maximum(left - hi_r, lo_r - left), min=0.0)
    c_r = torch.clamp(torch.maximum(rs - hi_l, lo_l - rs), min=0.0)
    return torch.minimum(c_l, c_r)


def cost_volume(left: torch.Tensor, right: torch.Tensor, cfg: SGBMConfig) -> torch.Tensor:
    """Aggregated BT cost volume [D, H, W]; BIG where x - d leaves the
    block's reach of the left border."""
    left = left.to(torch.float32)
    right = right.to(torch.float32)
    w = left.shape[1]
    dev = left.device
    lp = _prefilter(left, cfg.prefilter_cap)
    rp = _prefilter(right, cfg.prefilter_cap)
    disparities = range(cfg.min_disparity, cfg.min_disparity + cfg.num_disparities)
    c = (_bt_cost(lp, shifted_planes(rp, disparities))
         + 0.25 * _bt_cost(left, shifted_planes(right, disparities)))
    c = imgproc.box_sum_integral(c, cfg.block_size)  # window sum, the reference's units
    ds = torch.arange(cfg.min_disparity, cfg.min_disparity + cfg.num_disparities,
                      device=dev)[:, None, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    return torch.where(xs >= ds + cfg.block_size // 2, c, BIG)


def _dp_update(l_prev: torch.Tensor, c: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """One SGM step on [..., D] slices along the path."""
    m = l_prev.amin(dim=-1, keepdim=True)
    pad = torch.full_like(l_prev[..., :1], BIG)
    up = torch.cat([l_prev[..., 1:], pad], -1)
    dn = torch.cat([pad, l_prev[..., :-1]], -1)
    best = torch.minimum(torch.minimum(l_prev, m + p2), torch.minimum(up, dn) + p1)
    return torch.clamp(c + best - m, max=BIG)


def _row_paths(v: torch.Tensor, p1: float, p2: float, dxs) -> torch.Tensor:
    """Top-down and bottom-up paths for each predecessor offset dx in dxs,
    v [H, W, D] -> [len(dxs), 2, H, W, D] (direction 0 top-down, 1
    bottom-up). The predecessor of (y, x) is (y -+ 1, x - dx)."""
    h, w, _ = v.shape
    both = torch.stack([v, v.flip(0)])  # [2, H, W, D]: row r of each scan order
    out = torch.empty((len(dxs),) + both.shape, dtype=v.dtype, device=v.device)
    out[:, :, 0] = both[None, :, 0]  # the first row has no predecessor: L = C
    for r in range(1, h):
        prev = torch.nn.functional.pad(out[:, :, r - 1], (0, 0, 1, 1), value=BIG)  # [n, 2, W+2, D]
        # dx = +1 reads x - 1, dx = 0 reads x, dx = -1 reads x + 1
        prev = torch.stack([prev[i, :, 1 - dx: 1 - dx + w] for i, dx in enumerate(dxs)])
        out[:, :, r] = _dp_update(prev, both[None, :, r], p1, p2)
    out[:, 1] = out[:, 1].flip(1)
    return out


def aggregate(cvol: torch.Tensor, cfg: SGBMConfig) -> torch.Tensor:
    """Sum of the per-path SGM costs, [D, H, W] -> [H, W, D], in the JAX
    function's order: for each dx, top-down then bottom-up; then
    left-right and right-left."""
    p1, p2 = cfg.penalties()
    v = cvol.permute(1, 2, 0).contiguous()  # [H, W, D]
    dxs = (-1, 0, 1) if cfg.num_paths >= 8 else (0,)
    rows = _row_paths(v, p1, p2, dxs)
    cols = _row_paths(v.transpose(0, 1).contiguous(), p1, p2, (0,))[0].transpose(1, 2)
    total = None
    for path in [rows[i, j] for i in range(len(dxs)) for j in (0, 1)] + [cols[0], cols[1]]:
        total = path if total is None else total + path
    return total


def _subpixel(s: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """Parabola fit around the argmin along the last axis of s [H, W, D]."""
    d = s.shape[-1]
    c0 = torch.gather(s, -1, torch.clamp(best - 1, 0, d - 1)[..., None])[..., 0]
    c1 = torch.gather(s, -1, best[..., None])[..., 0]
    c2 = torch.gather(s, -1, torch.clamp(best + 1, 0, d - 1)[..., None])[..., 0]
    denom = torch.clamp(c0 + c2 - 2 * c1, min=1e-6)
    delta = torch.clamp(0.5 * (c0 - c2) / denom, -0.5, 0.5)
    interior = (best > 0) & (best < d - 1)
    return best.to(torch.float32) + torch.where(interior, delta, 0.0)


def compute_disparity_sgbm(left, right, cfg: SGBMConfig = SGBMConfig(), device=None) -> torch.Tensor:
    """Disparity f32 [H, W]; invalid pixels = min_disparity - 1. Runs on
    the card unless `device="cpu"`."""
    dev = resolve_device(device)
    left = torch.as_tensor(left, device=dev).to(torch.float32)
    right = torch.as_tensor(right, device=dev).to(torch.float32)
    s = aggregate(cost_volume(left, right, cfg), cfg)  # [H, W, D]
    h, w, d = s.shape
    smin, best = torch.min(s, dim=-1)
    ds = torch.arange(d, device=dev)
    far = torch.abs(ds[None, None, :] - best[..., None]) > 1
    competitor = torch.where(far, s, INF).amin(dim=-1)
    ok = competitor * 100.0 >= smin * (100.0 + cfg.uniqueness_ratio)
    ok &= smin < 0.9 * cfg.num_paths * BIG  # all-masked columns at the left border
    disp = _subpixel(s, best)

    if cfg.disp12_max_diff >= 0:
        # the right image's disparity from the same volume: S(y, x + d, d)
        xs = torch.arange(w, device=dev)[None, :, None]
        cols = torch.clamp(xs + ds[None, None, :], 0, w - 1).expand(h, w, d)
        s_r = torch.where(xs + ds[None, None, :] < w, torch.gather(s, 1, cols), INF)
        best_r = torch.argmin(s_r, dim=-1).to(torch.float32)
        xr = torch.clamp((torch.arange(w, device=dev)[None, :] - torch.round(disp)).to(torch.int64),
                         0, w - 1)
        dr = torch.gather(best_r, 1, xr)
        ok &= torch.abs(disp - dr) <= cfg.disp12_max_diff

    disp = disp + float(cfg.min_disparity)
    invalid = float(cfg.min_disparity - 1)
    disp = torch.where(ok, disp, invalid)
    if cfg.speckle_window_size > 0:
        disp = filter_speckles(disp, invalid, cfg.speckle_window_size, cfg.speckle_range)
    return disp


def filter_speckles(disp: torch.Tensor, invalid: float, max_size: int, max_diff: float
                    ) -> torch.Tensor:
    """cv::filterSpeckles semantics: blobs (4-connected under |d - d'| <=
    max_diff) smaller than max_size pixels become `invalid`. Labels by
    min-label propagation over the similar-neighbour edges."""
    h, w = disp.shape
    n = h * w
    valid = disp != invalid
    ids = torch.arange(n, dtype=torch.int64, device=disp.device).reshape(h, w)
    ids = torch.where(valid, ids, n)
    offsets = ((1, 0), (-1, 0), (0, 1), (0, -1))
    similar = []
    for dy, dx in offsets:
        nb = imgproc.shift2d(disp, dy, dx, fill=invalid)
        similar.append((torch.abs(disp - nb) <= max_diff) & (nb != invalid))

    def sweep(x):
        best = x
        for sim, (dy, dx) in zip(similar, offsets):
            best = torch.minimum(best, torch.where(sim, imgproc.shift2d(x, dy, dx, fill=n), n))
        return torch.where(valid, best, n)

    while True:
        for _ in range(_CHECK_EVERY - 1):
            ids = sweep(ids)
        new = sweep(ids)
        if torch.equal(new, ids):
            break
        ids = new
    sizes = torch.bincount(ids.reshape(-1), minlength=n + 1)
    keep = valid & (sizes[ids] >= max_size)
    return torch.where(keep, disp, invalid)
