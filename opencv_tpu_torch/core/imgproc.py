"""Image-processing primitives of opencv_tpu/core/imgproc.py in PyTorch,
on f32 [..., H, W] tensors.

The arithmetic follows the JAX functions operation for operation (tap
order of the separable filter, the two-tap form of the bilinear resize,
the tie-break of the NMS), so that the results agree bit for bit where
no summation order is left to the library.

Border convention: OpenCV's BORDER_REFLECT_101 == torch `mode="reflect"`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


_GRAY = (0.299, 0.587, 0.114)  # Rec.601, cv::cvtColor COLOR_RGB2GRAY


def to_gray(img) -> torch.Tensor:
    """RGB [..., H, W, 3] (or gray [H, W]) -> gray f32 [..., H, W].

    XLA's CPU dot is an FMA chain: r*w0, then fma(g, w1, .), then
    fma(b, w2, .). Here the products are exact in f64 and each sum is
    rounded to f32, which gives the same bits on either device."""
    img = torch.as_tensor(img).to(torch.float32)
    if img.ndim == 2:
        return img
    w = [float(np.float32(v)) for v in _GRAY]
    x = img.double()
    acc = (x[..., 0] * w[0]).to(torch.float32)
    for c in (1, 2):
        acc = (x[..., c] * w[c] + acc.double()).to(torch.float32)
    return acc


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


def box_filter(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Normalized ksize x ksize box filter (BORDER_REFLECT_101)."""
    k = np.full((ksize,), 1.0 / ksize, np.float32)
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


def box_sum_integral(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """(2r+1)^2 un-normalized box sum via two prefix sums; zero outside.
    The prefix sums run in eager JAX's order (`_block_scan`: bit-equal to
    the JAX function; about 40 small launches per axis where one
    torch.cumsum would do, and in another order)."""
    r = ksize // 2
    h, w = img.shape[-2:]
    ii = integral(F.pad(img.to(torch.float32), (r, r, r, r)))
    a = ii[..., :h, :w]
    b = ii[..., :h, ksize:]
    c = ii[..., ksize:, :w]
    d = ii[..., ksize:, ksize:]
    return d - b - c + a


def integral(img: torch.Tensor) -> torch.Tensor:
    """cv::integral analog: [..., H+1, W+1] with a zero first row and
    column; the prefix sums in eager JAX's order (bit-equal)."""
    x = F.pad(img.to(torch.float32), (1, 0, 1, 0))
    return _block_scan(_block_scan(x).transpose(-1, -2)).transpose(-1, -2)


def threshold(img: torch.Tensor, thresh: float, maxval: float = 255.0,
              kind: str = "binary") -> torch.Tensor:
    """cv::threshold analog. kinds: binary, binary_inv, trunc, tozero,
    tozero_inv."""
    img = img.to(torch.float32)
    above = img > thresh
    zero = torch.zeros_like(img)
    full = torch.full_like(img, maxval)
    if kind == "binary":
        return torch.where(above, full, zero)
    if kind == "binary_inv":
        return torch.where(above, zero, full)
    if kind == "trunc":
        return torch.where(above, torch.full_like(img, thresh), img)
    if kind == "tozero":
        return torch.where(above, img, zero)
    if kind == "tozero_inv":
        return torch.where(above, zero, img)
    raise ValueError(f"unknown threshold kind {kind}")


def otsu_threshold(img: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """Otsu's threshold value (THRESH_OTSU analog) for u8-range images, a
    0-d f32 tensor: the split that maximizes the between-class variance
    (the first of tied maxima). The histogram counts are exact integers,
    and its prefix sums run in eager JAX's order: at 480x640 the level
    sum passes 2^24, where the order decides the bits."""
    idx = img.to(torch.int32).clamp(0, bins - 1).reshape(-1).to(torch.int64)
    hist = torch.bincount(idx, minlength=bins).to(torch.float32)
    total = hist.sum()
    levels = torch.arange(bins, dtype=torch.float32, device=img.device)
    w0 = _block_scan(hist)
    sum0 = _block_scan(hist * levels)
    sum_all = sum0[-1]
    w1 = total - w0
    mu0 = sum0 / torch.clamp(w0, min=1e-9)
    mu1 = (sum_all - sum0) / torch.clamp(w1, min=1e-9)
    d = mu0 - mu1
    between = w0 * w1 * (d * d)
    between = torch.where((w0 > 0) & (w1 > 0), between, torch.full_like(between, -1.0))
    return torch.argmax(between).to(torch.float32)


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
    a, c, b = box_sum_integral(prods, block_size) * 0.5
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
    img: torch.Tensor, block_size: int = 7, k: float = 0.04, deriv: str = "harris_orb"
) -> torch.Tensor:
    """Per-pixel Harris response det(M) - k tr(M)^2. `harris_orb`: central
    differences and an un-weighted block sum, as ORB's HarrisResponses.
    The three block sums are one stacked `box_sum_integral` (eager JAX's
    order: bit-equal to the JAX function)."""
    if deriv == "harris_orb":
        dfilt = np.array([-1.0, 0.0, 1.0], np.float32)
        one = np.array([1.0], np.float32)
        ix = sep_filter2d(img, one, dfilt)
        iy = sep_filter2d(img, dfilt, one)
    else:
        ix, iy = sobel_derivatives(img)
    sxx, syy, sxy = box_sum_integral(torch.stack([ix * ix, iy * iy, ix * iy]), block_size)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def window_max(x: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """Max of x [..., H, W] over rows y+top..y+bottom and columns
    x+left..x+right (inclusive offsets), -inf outside: one max pooling of
    the -inf-padded image (a maximum does not round; NaN propagates)."""
    h, w = x.shape[-2:]
    pt, pb, pl, pr = max(-top, 0), max(bottom, 0), max(-left, 0), max(right, 0)
    xp = F.pad(x.reshape(-1, 1, h, w), (pl, pr, pt, pb), value=-float("inf"))
    pooled = F.max_pool2d(xp, (bottom - top + 1, right - left + 1), stride=1)
    y0, x0 = top + pt, left + pl
    return pooled[..., y0: y0 + h, x0: x0 + w].reshape(x.shape)


def nms_2d(score: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """(2r+1)^2 non-maximum suppression mask: `>` toward earlier
    (top-left) neighbours, `>=` toward later ones, so ties keep the
    earlier pixel. -inf outside the image. A pixel beats every earlier
    neighbour iff it beats their maximum, so each side is two window
    maxima (the rows above or below, and its row's left or right part):
    the cost does not grow with the radius."""
    r = radius
    if r < 1:
        return torch.ones_like(score, dtype=torch.bool)
    x = score if score.is_floating_point() else score.double()
    earlier = torch.maximum(window_max(x, -r, -1, -r, r), window_max(x, 0, 0, -r, -1))
    later = torch.maximum(window_max(x, 1, r, -r, r), window_max(x, 0, 0, 1, r))
    return (x > earlier) & (x >= later)


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample img [..., H, W] at continuous (x, y) positions [..., 2],
    bilinear with edge clamping (not K4's zero-outside window sampler).
    The arithmetic is the JAX function's, op for op."""
    h, w = img.shape[-2:]
    x = xy[..., 0].clamp(0.0, w - 1.0)
    y = xy[..., 1].clamp(0.0, h - 1.0)
    x0 = torch.floor(x).to(torch.int64).clamp(0, w - 2)
    y0 = torch.floor(y).to(torch.int64).clamp(0, h - 2)
    fx = x - x0.to(torch.float32)
    fy = y - y0.to(torch.float32)
    i00 = img[..., y0, x0]
    i01 = img[..., y0, x0 + 1]
    i10 = img[..., y0 + 1, x0]
    i11 = img[..., y0 + 1, x0 + 1]
    top = i00 * (1.0 - fx) + i01 * fx
    bot = i10 * (1.0 - fx) + i11 * fx
    return top * (1.0 - fy) + bot * fy


def remap(img: torch.Tensor, map_xy: torch.Tensor) -> torch.Tensor:
    """cv::remap analog: out[y, x] = img(map_xy[y, x, 0], map_xy[y, x, 1]),
    bilinear, clamped at the edges."""
    return bilinear_sample(img, map_xy)


def _pixel_grid(out_h: int, out_w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(ys, xs) f32 [out_h, out_w] pixel coordinates."""
    ys = torch.arange(out_h, dtype=torch.float32, device=device)[:, None].expand(out_h, out_w)
    xs = torch.arange(out_w, dtype=torch.float32, device=device)[None, :].expand(out_h, out_w)
    return ys, xs


def warp_affine(img: torch.Tensor, m, out_h: int, out_w: int) -> torch.Tensor:
    """cv::warpAffine analog with WARP_INVERSE_MAP: m [2, 3] maps *output*
    coordinates to input coordinates; bilinear, clamped at the edges.
    Each product and sum is rounded as eager JAX rounds it."""
    m = torch.as_tensor(m, dtype=torch.float32, device=img.device)
    ys, xs = _pixel_grid(out_h, out_w, img.device)
    src_x = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
    src_y = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
    return bilinear_sample(img, torch.stack([src_x, src_y], dim=-1))


def warp_perspective(img: torch.Tensor, m, out_h: int, out_w: int) -> torch.Tensor:
    """cv::warpPerspective analog: m [3, 3] output->input homography."""
    m = torch.as_tensor(m, dtype=torch.float32, device=img.device)
    ys, xs = _pixel_grid(out_h, out_w, img.device)
    denom = m[2, 0] * xs + m[2, 1] * ys + m[2, 2]
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    src_x = (m[0, 0] * xs + m[0, 1] * ys + m[0, 2]) / denom
    src_y = (m[1, 0] * xs + m[1, 1] * ys + m[1, 2]) / denom
    return bilinear_sample(img, torch.stack([src_x, src_y], dim=-1))


def warp_polar(img: torch.Tensor, dsize: tuple[int, int], center: tuple[float, float],
               max_radius: float, log: bool = False, inverse: bool = False) -> torch.Tensor:
    """cv::warpPolar analog. Forward: dst[phi, rho] samples src along the
    ray of angle 2 pi phi / H at radius rho maxR / W (linear) or
    exp(rho ln(maxR) / W) - 1 (semilog); inverse maps a polar image back
    to cartesian. Samples clamp at the border (the remap convention).

    exp, log, cos, sin, sqrt and atan2 run in f64 and are rounded to f32,
    so the card gives the CPU's bits; XLA's f32 versions differ from them
    by an ulp at some pixels."""
    h, w = dsize
    cx, cy = center
    dev = img.device
    if not inverse:
        rho_i = torch.arange(w, dtype=torch.float32, device=dev)
        if log:
            kmag = math.log(max(max_radius, 1e-9)) / w
            rhos = torch.exp((rho_i * kmag).double()).to(torch.float32) - 1.0
        else:
            rhos = rho_i * (max_radius / w)
        phi = (torch.arange(h, dtype=torch.float32, device=dev) * (2.0 * math.pi / h)).double()
        cos, sin = torch.cos(phi).to(torch.float32), torch.sin(phi).to(torch.float32)
        mx = rhos[None, :] * cos[:, None] + cx
        my = rhos[None, :] * sin[:, None] + cy
        return remap(img, torch.stack([mx, my], dim=-1))
    sh, sw = img.shape[-2:]
    kangle_s = 2.0 * math.pi / sh
    kmag = math.log(max(max_radius, 1e-9)) / sw if log else max_radius / sw
    ys, xs = _pixel_grid(h, w, dev)
    dx = xs - cx
    dy = ys - cy
    mag = torch.sqrt((dx * dx + dy * dy).double()).to(torch.float32)
    if log:
        mag = torch.log((mag + 1.0).double()).to(torch.float32)
    ang = torch.atan2(dy.double(), dx.double()).to(torch.float32)
    ang = torch.where(ang < 0, ang + 2.0 * math.pi, ang)
    # divide by device tensors: CUDA divides by a Python float as a multiply
    # by its reciprocal, which rounds otherwise than the CPU's and XLA's division
    kmag_t, kangle_t = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (kmag, kangle_s))
    return remap(img, torch.stack([mag / kmag_t, ang / kangle_t], dim=-1))


def linear_polar(img: torch.Tensor, center: tuple[float, float], max_radius: float,
                 inverse: bool = False) -> torch.Tensor:
    """cv::linearPolar analog (the legacy API: dst size == src size)."""
    return warp_polar(img, img.shape[-2:], center, max_radius, log=False, inverse=inverse)


def log_polar(img: torch.Tensor, center: tuple[float, float], m: float,
              inverse: bool = False) -> torch.Tensor:
    """cv::logPolar analog; `m` is the legacy magnitude scale, maxRadius =
    exp(W / m)."""
    max_radius = math.exp(img.shape[-1] / m) if m > 0 else 1.0
    return warp_polar(img, img.shape[-2:], center, max_radius, log=True, inverse=inverse)
