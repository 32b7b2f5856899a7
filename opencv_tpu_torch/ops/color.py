"""Colour-space conversions (port of opencv_tpu/ops/color.py; cv::cvtColor,
imgproc/src/color.cpp; demosaicing as cudaimgproc/src/cuda/debayer.cu).

f32 tensors with channels last, RGB in [0, 255]. Each conversion is the
JAX function's elementwise arithmetic in its order, with every division
by a device tensor (`true_div`), so gray, HSV and YCrCb equal the JAX
package's bit for bit. Lab's sRGB curve and cube root are `pow`, whose
last ulp is the library's (XLA's `cbrt` is its own): Lab agrees to a few
ulps.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.device import on_device, true_div


def _image(img, device) -> torch.Tensor:
    return on_device(img, device).to(torch.float32)


def rgb_to_gray(img, device=None) -> torch.Tensor:
    """Rec.601 luma, as XLA's CPU dot computes it (`imgproc.to_gray`)."""
    return imgproc.to_gray(_image(img, device))


def gray_to_rgb(img, device=None) -> torch.Tensor:
    return _image(img, device)[..., None].repeat_interleave(3, dim=-1)


def rgb_to_hsv(img, device=None) -> torch.Tensor:
    """H in [0, 360), S, V in [0, 1] (input RGB in [0, 255])."""
    x = true_div(_image(img, device), 255.0)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = x.amax(-1)
    mn = x.amin(-1)
    c = v - mn
    one = torch.ones_like(c)
    small_c = c < 1e-12
    safe_c = torch.where(small_c, one, c)
    h = torch.where(v == r, (g - b) / safe_c % 6.0,
                    torch.where(v == g, (b - r) / safe_c + 2.0, (r - g) / safe_c + 4.0))
    h = torch.where(small_c, torch.zeros_like(h), h * 60.0)
    small_v = v < 1e-12
    s = torch.where(small_v, torch.zeros_like(c), c / torch.where(small_v, one, v))
    return torch.stack([h, s, v], -1)


def _select(idx: torch.Tensor, values) -> torch.Tensor:
    """jnp.select over idx == 0..5: the first matching case, else 0."""
    out = torch.zeros_like(values[0])
    for k in range(len(values) - 1, -1, -1):
        out = torch.where(idx == k, values[k], out)
    return out


def hsv_to_rgb(img, device=None) -> torch.Tensor:
    x = _image(img, device)
    h, s, v = x[..., 0], x[..., 1], x[..., 2]
    c = v * s
    hp = true_div(h, 60.0) % 6.0
    xx = c * (1.0 - torch.abs(hp % 2.0 - 1.0))
    m = v - c
    z = torch.zeros_like(c)
    idx = torch.floor(hp).to(torch.int32) % 6
    r = _select(idx, [c, xx, z, z, xx, c])
    g = _select(idx, [xx, c, c, xx, z, z])
    b = _select(idx, [z, z, xx, c, c, xx])
    return torch.stack([r + m, g + m, b + m], -1) * 255.0


def rgb_to_ycrcb(img, device=None) -> torch.Tensor:
    """OpenCV YCrCb convention (color.cpp): Y + 0.713/0.564 deltas,
    offset 128 for 8-bit ranges."""
    x = _image(img, device)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cr = (r - y) * 0.713 + 128.0
    cb = (b - y) * 0.564 + 128.0
    return torch.stack([y, cr, cb], -1)


def ycrcb_to_rgb(img, device=None) -> torch.Tensor:
    x = _image(img, device)
    y, cr, cb = x[..., 0], x[..., 1], x[..., 2]
    r = y + true_div(cr - 128.0, 0.713)
    b = y + true_div(cb - 128.0, 0.564)
    g = true_div(y - 0.299 * r - 0.114 * b, 0.587)
    return torch.stack([r, g, b], -1)


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    return torch.sign(t) * torch.abs(t) ** (1.0 / 3.0)


def rgb_to_lab(img, device=None) -> torch.Tensor:
    """CIE L*a*b* (D65), 8-bit-style ranges: L in [0,100], a/b ~ [-128,127]."""
    x = true_div(_image(img, device), 255.0)
    # sRGB linearization
    lin = torch.where(x > 0.04045, true_div(x + 0.055, 1.055) ** 2.4, true_div(x, 12.92))
    r, g, b = lin[..., 0], lin[..., 1], lin[..., 2]
    xn = true_div(0.412453 * r + 0.357580 * g + 0.180423 * b, 0.950456)
    yn = 0.212671 * r + 0.715160 * g + 0.072169 * b
    zn = true_div(0.019334 * r + 0.119193 * g + 0.950227 * b, 1.088754)

    def f(t):
        return torch.where(t > 0.008856, _cbrt(t), 7.787 * t + 16.0 / 116.0)

    fx, fy, fz = f(xn), f(yn), f(zn)
    L = torch.where(yn > 0.008856, 116.0 * _cbrt(yn) - 16.0, 903.3 * yn)
    a = 500.0 * (fx - fy)
    bb = 200.0 * (fy - fz)
    return torch.stack([L, a, bb], -1)


_MASKS = {  # (R, G, B) sites of each Bayer pattern as ((y % 2, x % 2), ...)
    "RGGB": (((0, 0),), ((0, 1), (1, 0)), ((1, 1),)),
    "BGGR": (((1, 1),), ((0, 1), (1, 0)), ((0, 0),)),
    "GRBG": (((0, 1),), ((0, 0), (1, 1)), ((1, 0),)),
    "GBRG": (((1, 0),), ((0, 0), (1, 1)), ((0, 1),)),
}


def demosaic_bilinear(raw, pattern: str = "RGGB", device=None) -> torch.Tensor:
    """Bayer -> RGB by bilinear interpolation (cuda/debayer.cu analog).
    raw: [H, W] single-channel mosaic."""
    raw = _image(raw, device)
    h, w = raw.shape
    yy = (torch.arange(h, device=raw.device) % 2)[:, None]
    xx = (torch.arange(w, device=raw.device) % 2)[None, :]
    k = np.array([1.0, 2.0, 1.0], np.float32) / 2.0

    def interp(sites):
        mask = torch.zeros((h, w), dtype=torch.bool, device=raw.device)
        for sy, sx in sites:
            mask = mask | ((yy == sy) & (xx == sx))
        num = imgproc.sep_filter2d(torch.where(mask, raw, torch.zeros_like(raw)), k, k)
        den = imgproc.sep_filter2d(mask.to(torch.float32), k, k)
        return num / torch.clamp(den, min=1e-9)

    return torch.stack([interp(s) for s in _MASKS[pattern]], -1)
