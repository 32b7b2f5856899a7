"""Image pyramids as tuples of per-level tensors with static shapes (port
of opencv_tpu/core/pyramid.py): the ORB scale pyramid and the octave
pyramid of Lucas-Kanade."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opencv_tpu_torch.core import imgproc


class Pyramid(NamedTuple):
    """levels[i]: f32 [Hi, Wi]; level-i coords * scales[i] = level-0 coords."""

    levels: tuple[torch.Tensor, ...]
    scales: tuple[float, ...]

    @property
    def num_levels(self) -> int:
        return len(self.levels)


def level_shapes(h: int, w: int, n_levels: int, scale_factor: float) -> list[tuple[int, int]]:
    """Per-level shapes, rounding like cv::resize(1/scale)."""
    shapes = []
    for lvl in range(n_levels):
        s = scale_factor ** lvl
        shapes.append((max(int(round(h / s)), 1), max(int(round(w / s)), 1)))
    return shapes


def build_pyramid(img: torch.Tensor, n_levels: int = 8, scale_factor: float = 1.2) -> Pyramid:
    """Each level is a bilinear resize of level 0 (not of the previous
    level), as in the JAX package."""
    h, w = img.shape[-2:]
    img = img.to(torch.float32)
    levels, scales = [], []
    for lvl, (lh, lw) in enumerate(level_shapes(h, w, n_levels, scale_factor)):
        levels.append(img if lvl == 0 else imgproc.resize_bilinear(img, lh, lw))
        scales.append(float(scale_factor ** lvl))
    return Pyramid(levels=tuple(levels), scales=tuple(scales))


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown analog: 5-tap Gaussian [1,4,6,4,1]/16, then 2x decimation."""
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0
    return imgproc.sep_filter2d(img, k, k)[..., ::2, ::2].contiguous()


def pyr_up(img: torch.Tensor) -> torch.Tensor:
    """cv::pyrUp analog: 2x zero-stuffing, then the same Gaussian times 4."""
    h, w = img.shape[-2:]
    up = torch.zeros(img.shape[:-2] + (h * 2, w * 2), dtype=torch.float32, device=img.device)
    up[..., ::2, ::2] = img
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 8.0  # 2x per axis
    return imgproc.sep_filter2d(up, k, k)


def build_lk_pyramid(img: torch.Tensor, n_levels: int = 3) -> Pyramid:
    """`buildOpticalFlowPyramid` analog: octave pyramid by pyrDown; level i
    has scale 2**i."""
    levels = [img.to(torch.float32)]
    for _ in range(1, n_levels):
        levels.append(pyr_down(levels[-1]))
    return Pyramid(levels=tuple(levels), scales=tuple(float(2 ** i) for i in range(n_levels)))
