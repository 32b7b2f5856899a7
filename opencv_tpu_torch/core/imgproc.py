"""Image-processing primitives: the main-path subset of
opencv_tpu/core/imgproc.py, in PyTorch on f32 [..., H, W] tensors.

The arithmetic follows the JAX functions operation for operation (tap
order of the separable filter, the two-tap form of the bilinear resize,
the tie-break of the NMS), so that the results agree bit for bit where
no summation order is left to the library.

Border convention: OpenCV's BORDER_REFLECT_101 == torch `mode="reflect"`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def shift2d(img: torch.Tensor, dy: int, dx: int, fill: float = 0.0) -> torch.Tensor:
    """shift2d(img, dy, dx)[y, x] == img[y + dy, x + dx]; `fill` outside."""
    h, w = img.shape[-2:]
    out = torch.full_like(img, fill)
    src_y = slice(max(dy, 0), h + min(dy, 0))
    dst_y = slice(max(-dy, 0), h + min(-dy, 0))
    src_x = slice(max(dx, 0), w + min(dx, 0))
    dst_x = slice(max(-dx, 0), w + min(-dx, 0))
    out[..., dst_y, dst_x] = img[..., src_y, src_x]
    return out


def _reflect_pad(img: torch.Tensor, ry: int, rx: int) -> torch.Tensor:
    lead = img.shape[:-2]
    x = img.reshape((-1,) + tuple(img.shape[-2:]))
    x = F.pad(x, (rx, rx, ry, ry), mode="reflect")
    return x.reshape(lead + tuple(x.shape[-2:]))


def sep_filter2d(img: torch.Tensor, ky, kx) -> torch.Tensor:
    """Separable 2-D correlation with BORDER_REFLECT_101 (cv::sepFilter2D).

    Shift-and-accumulate in the JAX package's order: vertical taps in
    order over the padded rows, then horizontal taps. Keeping that order
    keeps blurred levels, and so BRIEF's `t1 < t2` bits, equal.
    """
    ky = np.asarray(ky, np.float32)
    kx = np.asarray(kx, np.float32)
    kh, kw = ky.shape[0], kx.shape[0]
    h, w = img.shape[-2:]
    x = _reflect_pad(img.to(torch.float32), kh // 2, kw // 2)
    acc = None
    for i in range(kh):
        term = float(ky[i]) * x[..., i : i + h, :]
        acc = term if acc is None else acc + term
    out = None
    for j in range(kw):
        term = float(kx[j]) * acc[..., :, j : j + w]
        out = term if out is None else out + term
    return out


def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel; taps are static numpy metadata."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float32) - (ksize - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / np.sum(k)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """cv::GaussianBlur analog (ORB blurs with ksize=7, sigma=2)."""
    k = gaussian_kernel1d(ksize, sigma)
    return sep_filter2d(img, k, k)


_SCAN_BLOCK = 16  # XLA's CPU rewrite of a long cumsum scans blocks of 16


def _block_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum along the last dim in the order XLA's CPU
    backend computes jnp.cumsum: an axis longer than 16 is padded to
    blocks of 16, each block is scanned left to right, the block totals
    are scanned the same way (recursively), and each block's exclusive
    offset is added last. Only f32 adds, so either device gives the same
    bits (torch.cumsum accumulates in f64 on the CPU and by a tree on the
    card)."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        out = x.clone()
        for k in range(1, n):
            out[..., k] += out[..., k - 1]
        return out
    nb = -(-n // _SCAN_BLOCK)
    blocks = F.pad(x, (0, nb * _SCAN_BLOCK - n)).reshape(x.shape[:-1] + (nb, _SCAN_BLOCK))
    inner = _block_scan(blocks)
    offset = F.pad(_block_scan(inner[..., -1])[..., :-1], (1, 0))
    return (inner + offset[..., None]).reshape(x.shape[:-1] + (nb * _SCAN_BLOCK,))[..., :n]


def box_sum_integral(img: torch.Tensor, ksize: int, xla_order: bool = False) -> torch.Tensor:
    """(2r+1)^2 un-normalized box sum via two prefix sums; zero outside.
    `xla_order` sums in eager JAX's order (bit-equal to the JAX function;
    about 40 small launches per axis where torch.cumsum takes one)."""
    r = ksize // 2
    h, w = img.shape[-2:]
    x = F.pad(img.to(torch.float32), (r + 1, r, r + 1, r))
    if xla_order:
        ii = _block_scan(_block_scan(x).transpose(-1, -2)).transpose(-1, -2)
    else:
        ii = torch.cumsum(torch.cumsum(x, dim=-1), dim=-2)
    a = ii[..., :h, :w]
    b = ii[..., :h, ksize:]
    c = ii[..., ksize:, :w]
    d = ii[..., ksize:, ksize:]
    return d - b - c + a


def scharr_derivatives(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dy) with the 3x3 Scharr operator of the LK pyramid (smooth
    [3,10,3]/32, diff [-1,0,1])."""
    smooth = np.array([3.0, 10.0, 3.0], np.float32) / 32.0
    diff = np.array([-1.0, 0.0, 1.0], np.float32)
    return sep_filter2d(img, smooth, diff), sep_filter2d(img, diff, smooth)


def sobel_derivatives(img: torch.Tensor, ksize: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dy) Sobel, ksize 3 or 5."""
    if ksize == 3:
        smooth = np.array([1.0, 2.0, 1.0], np.float32)
        diff = np.array([-1.0, 0.0, 1.0], np.float32)
    elif ksize == 5:
        smooth = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32)
        diff = np.array([-1.0, -2.0, 0.0, 2.0, 1.0], np.float32)
    else:
        raise ValueError(f"unsupported sobel ksize {ksize}")
    return sep_filter2d(img, smooth, diff), sep_filter2d(img, diff, smooth)


def min_eig_response(img: torch.Tensor, block_size: int = 3) -> torch.Tensor:
    """cv::cornerMinEigenVal analog: the smaller eigenvalue of the
    block-summed structure tensor of 3x3 Sobel derivatives; bit-equal to
    eager JAX (the block sums in its order)."""
    ix, iy = sobel_derivatives(img)
    prods = torch.stack([ix * ix, iy * iy, ix * iy])
    a, c, b = box_sum_integral(prods, block_size, xla_order=True) * 0.5
    # f64 sqrt rounded to f32 is the correctly rounded f32 sqrt on either
    # device (torch's vectorized f32 sqrt on the CPU is not, XLA's is)
    root = torch.sqrt(((a - c) * (a - c) + b * b).double()).to(torch.float32)
    return (a + c) - root


def _interp_taps(n_out: int, n_in: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Half-pixel-centre bilinear taps: (lo, weight of lo, weight of lo+1)."""
    scale = n_in / n_out
    coords = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * scale - 0.5
    coords = coords.clamp(0.0, n_in - 1.0)
    lo = torch.floor(coords).to(torch.int64).clamp(0, max(n_in - 2, 0))
    frac = coords - lo.to(torch.float32)
    return lo, 1.0 - frac, frac


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize with half-pixel centres (cv::resize INTER_LINEAR).

    The JAX function contracts with two interpolation matrices that hold
    two non-zero taps per row; this is the same two-tap sum written as a
    gather (rows first, then columns, as the JAX einsums run)."""
    h, w = img.shape[-2:]
    x = img.to(torch.float32)
    lo, a, b = _interp_taps(out_h, h, x.device)
    x = a[:, None] * x[..., lo, :] + b[:, None] * x[..., lo + 1, :]
    lo, a, b = _interp_taps(out_w, w, x.device)
    return a * x[..., :, lo] + b * x[..., :, lo + 1]


def harris_response(
    img: torch.Tensor, block_size: int = 7, k: float = 0.04, deriv: str = "harris_orb",
    xla_order: bool = False,
) -> torch.Tensor:
    """Per-pixel Harris response det(M) - k tr(M)^2. `harris_orb`: central
    differences and an un-weighted block sum, as ORB's HarrisResponses.
    `xla_order`: block sums in eager JAX's order (see box_sum_integral)."""
    if deriv == "harris_orb":
        dfilt = np.array([-1.0, 0.0, 1.0], np.float32)
        one = np.array([1.0], np.float32)
        ix = sep_filter2d(img, one, dfilt)
        iy = sep_filter2d(img, dfilt, one)
    else:
        ix, iy = sobel_derivatives(img)
    sxx = box_sum_integral(ix * ix, block_size, xla_order)
    syy = box_sum_integral(iy * iy, block_size, xla_order)
    sxy = box_sum_integral(ix * iy, block_size, xla_order)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def nms_2d(score: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """(2r+1)^2 non-maximum suppression mask: `>` toward earlier
    (top-left) neighbours, `>=` toward later ones, so ties keep the
    earlier pixel."""
    keep = torch.ones_like(score, dtype=torch.bool)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            nb = shift2d(score, dy, dx, fill=-float("inf"))
            keep &= (score > nb) if (dy, dx) < (0, 0) else (score >= nb)
    return keep
