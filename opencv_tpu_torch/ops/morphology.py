"""Morphological operations (port of opencv_tpu/ops/morphology.py;
imgproc/src/morph.cpp, cudafilters createMorphologyFilter).

Rectangular structuring elements are one max pooling after an explicit
±inf pad of ((k-1)//2, k//2) rows and columns (`imgproc.window_max`),
the JAX package's `lax.reduce_window` padding (asymmetric for an even
k): min and max involve no rounding, so the values are exact. Arbitrary
elements take shifted reads with a ±inf fill, as the JAX functions do.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from opencv_tpu_torch.core import imgproc


def _window_max(img: torch.Tensor, ksize) -> torch.Tensor:
    """Max over a kh x kw window of f32 [H, W], -inf outside, with the JAX
    function's ((k-1)//2, k//2) padding."""
    kh, kw = (ksize, ksize) if isinstance(ksize, int) else ksize
    return imgproc.window_max(img, -((kh - 1) // 2), kh // 2, -((kw - 1) // 2), kw // 2)


def erode(img: torch.Tensor, ksize=3, kernel: np.ndarray | None = None) -> torch.Tensor:
    img = img.to(torch.float32)
    if kernel is None:
        return -_window_max(-img, ksize)
    out = None
    kh, kw = kernel.shape
    for dy in range(kh):
        for dx in range(kw):
            if not kernel[dy, dx]:
                continue
            s = imgproc.shift2d(img, dy - kh // 2, dx - kw // 2, float("inf"))
            out = s if out is None else torch.minimum(out, s)
    return out


def dilate(img: torch.Tensor, ksize=3, kernel: np.ndarray | None = None) -> torch.Tensor:
    img = img.to(torch.float32)
    if kernel is None:
        return _window_max(img, ksize)
    out = None
    kh, kw = kernel.shape
    for dy in range(kh):
        for dx in range(kw):
            if not kernel[dy, dx]:
                continue
            # dilation reflects the structuring element
            s = imgproc.shift2d(img, kh // 2 - dy, kw // 2 - dx, -float("inf"))
            out = s if out is None else torch.maximum(out, s)
    return out


def morphology_open(img, ksize=3):
    return dilate(erode(img, ksize), ksize)


def morphology_close(img, ksize=3):
    return erode(dilate(img, ksize), ksize)


def morphology_gradient(img, ksize=3):
    return dilate(img, ksize) - erode(img, ksize)


def top_hat(img, ksize=3):
    return img.to(torch.float32) - morphology_open(img, ksize)


def black_hat(img, ksize=3):
    return morphology_close(img, ksize) - img.to(torch.float32)


def median_blur(img: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """cv::medianBlur analog: the k^2 shifted reads of the edge-padded
    image stacked and sorted, the middle one taken (exact)."""
    r = ksize // 2
    h, w = img.shape
    pad = F.pad(img.to(torch.float32)[None, None], (r, r, r, r), mode="replicate")[0, 0]
    taps = [pad[dy: dy + h, dx: dx + w] for dy in range(ksize) for dx in range(ksize)]
    return torch.sort(torch.stack(taps), dim=0).values[(ksize * ksize) // 2]


def bilateral_filter(
    img: torch.Tensor, d: int = 9, sigma_color: float = 30.0, sigma_space: float = 3.0,
) -> torch.Tensor:
    """cv::bilateralFilter analog: one shifted read and weight per offset
    of the disc of radius d // 2, summed in the JAX function's order. The
    range weight's divisor is a device tensor (a CUDA division by a Python
    float is a multiply by its reciprocal); `exp` may differ from XLA's by
    an ulp."""
    img = img.to(torch.float32)
    r = d // 2
    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    two_sc2 = torch.tensor(2.0 * sigma_color ** 2, dtype=torch.float32, device=img.device)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy * dy + dx * dx > r * r:
                continue
            ws = float(np.exp(-(dy * dy + dx * dx) / (2.0 * sigma_space ** 2)))
            nb = imgproc.shift2d(img, dy, dx, fill=float("nan"))
            wr = torch.exp(-((nb - img) ** 2) / two_sc2)
            outside = torch.isnan(nb)
            w = torch.where(outside, 0.0, ws * wr)
            num = num + w * torch.where(outside, 0.0, nb)
            den = den + w
    return num / den.clamp(min=1e-9)
