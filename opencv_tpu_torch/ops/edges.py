"""Canny edge detection (port of opencv_tpu/ops/edges.py).

Reference: cv::Canny (imgproc/src/canny.cpp) and the CUDA version
(cudaimgproc/src/cuda/canny.cu): Sobel gradients, direction-quantized
non-maximum suppression, double threshold, hysteresis.

As in the JAX package, NMS picks the neighbour pair of each pixel with
sector masks over shifted images, and hysteresis grows the strong edges
through the weak ones by masked 8-neighbour dilations to a fixed point.
The JAX `lax.while_loop` tests for a change after every trip; here the
host reads that flag only every `_TRIPS_PER_CHECK` trips (a trip at the
fixed point changes nothing), so a long weak chain does not cost one
host synchronisation per pixel of its length.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from opencv_tpu_torch.core import imgproc

_TRIPS_PER_CHECK = 16


def _dilate8(m: torch.Tensor) -> torch.Tensor:
    """8-neighbour dilation of a 0/1 f32 mask (outside counts as 0)."""
    return F.max_pool2d(m[None, None], 3, stride=1, padding=1)[0, 0]


def canny(img: torch.Tensor, low_threshold: float, high_threshold: float,
          l2_gradient: bool = False) -> torch.Tensor:
    """Edge mask [H, W] bool (cv::Canny analog), on the image's device."""
    img = img.to(torch.float32)
    dx, dy = imgproc.sobel_derivatives(img, 3)
    mag = torch.sqrt(dx * dx + dy * dy) if l2_gradient else dx.abs() + dy.abs()

    # sector quantization (canny.cpp's tan(22.5) boundaries)
    adx, ady = dx.abs(), dy.abs()
    horiz = ady <= 0.4142135623730951 * adx  # gradient ~ horizontal: edge vertical
    vert = ady >= 2.414213562373095 * adx
    same_sign = (dx * dy) >= 0  # 45 against 135 degree diagonal

    def nb(ddy, ddx):
        return imgproc.shift2d(mag, ddy, ddx, -1.0)

    n1 = torch.where(horiz, nb(0, -1), torch.where(vert, nb(-1, 0),
                                                   torch.where(same_sign, nb(-1, -1), nb(-1, 1))))
    n2 = torch.where(horiz, nb(0, 1), torch.where(vert, nb(1, 0),
                                                  torch.where(same_sign, nb(1, 1), nb(1, -1))))
    is_max = (mag > n1) & (mag >= n2)
    weak = (is_max & (mag > low_threshold)).to(torch.float32)
    cur = (is_max & (mag > high_threshold)).to(torch.float32)

    while True:
        before = cur
        for _ in range(_TRIPS_PER_CHECK):
            cur = torch.maximum(cur, weak * _dilate8(cur))
        if torch.equal(cur, before):
            return cur > 0
