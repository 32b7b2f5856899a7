"""Histograms, equalization, CLAHE (port of opencv_tpu/ops/histogram.py;
imgproc/src/histogram.cpp calcHist and equalizeHist, imgproc/src/clahe.cpp).

Histograms are integer `bincount`s, so histograms, LUTs and equalized
images are exact on either device. The arithmetic keeps the JAX order,
with every division by a device tensor (`true_div`). CLAHE's per-tile
CDF is a prefix sum in XLA's CPU order (`imgproc._block_scan`), so a
clip limit whose redistribution leaves fractions sums as JAX's does.
"""

from __future__ import annotations

import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.device import on_device, true_div


def _image(img, device) -> torch.Tensor:
    return on_device(img, device).to(torch.float32)


def calc_hist(img, bins: int = 256, value_range=(0.0, 256.0), device=None) -> torch.Tensor:
    """i32 [bins] counts of a gray image; values outside the range land
    in the end bins."""
    lo, hi = value_range
    x = _image(img, device)
    idx = true_div((x - lo) * bins, hi - lo).to(torch.int32).clamp(0, bins - 1)
    return torch.bincount(idx.reshape(-1), minlength=bins).to(torch.int32)


def equalize_hist(img, device=None) -> torch.Tensor:
    """cv::equalizeHist analog: u8-range grayscale in, equalized f32 out."""
    x = _image(img, device)
    hist = calc_hist(x, device=x.device).to(torch.float32)
    cdf = torch.cumsum(hist, 0)  # integer counts below 2^24: exact in any order
    total = cdf[-1]
    # scale so min nonzero cdf -> 0, max -> 255 (OpenCV convention)
    cdf_min = torch.where(hist > 0, cdf, torch.full_like(cdf, float("inf"))).min()
    lut = torch.round((cdf - cdf_min) / torch.clamp(total - cdf_min, min=1.0) * 255.0).clamp(0.0, 255.0)
    return lut[x.to(torch.int32).clamp(0, 255).long()]


def clahe(img, clip_limit: float = 40.0, tile_grid: tuple[int, int] = (8, 8), bins: int = 256,
          device=None) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization (cv::createCLAHE
    analog). Image dims must divide by the tile grid (callers pad or
    crop)."""
    x = _image(img, device)
    dev = x.device
    h, w = x.shape
    ty, tx = tile_grid
    th, tw = h // ty, w // tx
    img_c = x.clamp(0.0, 255.0)
    vals = img_c[: ty * th, : tx * tw].to(torch.int32).clamp(0, bins - 1)
    tiles = vals.reshape(ty, th, tx, tw)
    tile_id = (torch.arange(ty, device=dev)[:, None, None, None] * tx
               + torch.arange(tx, device=dev)[None, None, :, None])
    flat_bin = (tile_id * bins + tiles).reshape(-1)
    hists = torch.bincount(flat_bin, minlength=ty * tx * bins).reshape(ty, tx, bins)
    hists = hists.to(torch.float32)
    # clip + uniform redistribution (clahe.cpp clipHistogram)
    excess = torch.clamp(hists - clip_limit, min=0.0).sum(-1, keepdim=True)
    hists = torch.clamp(hists, max=clip_limit) + true_div(excess, bins)
    cdf = imgproc._block_scan(hists)
    area = th * tw
    luts = torch.round(cdf * (255.0 / area)).clamp(0.0, 255.0)  # [ty, tx, bins]

    # bilinear interpolation between the 4 surrounding tile LUTs
    yy = true_div(torch.arange(h, dtype=torch.float32, device=dev) + 0.5, th) - 0.5
    xx = true_div(torch.arange(w, dtype=torch.float32, device=dev) + 0.5, tw) - 0.5
    y0 = torch.floor(yy).to(torch.int64).clamp(0, ty - 1)
    x0 = torch.floor(xx).to(torch.int64).clamp(0, tx - 1)
    y1 = (y0 + 1).clamp(0, ty - 1)
    x1 = (x0 + 1).clamp(0, tx - 1)
    fy = (yy - y0).clamp(0.0, 1.0)[:, None]
    fx = (xx - x0).clamp(0.0, 1.0)[None, :]

    pix = img_c.to(torch.int64).clamp(0, bins - 1)
    flat_luts = luts.reshape(-1)

    def sample(tyi, txi):
        return flat_luts[(tyi[:, None] * tx + txi[None, :]) * bins + pix]

    top = sample(y0, x0) * (1 - fx) + sample(y0, x1) * fx
    bot = sample(y1, x0) * (1 - fx) + sample(y1, x1) * fx
    return top * (1 - fy) + bot * fy
