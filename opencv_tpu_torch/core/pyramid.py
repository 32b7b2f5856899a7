"""ORB scale pyramid: a tuple of per-level tensors with static shapes
(port of opencv_tpu/core/pyramid.py `build_pyramid`)."""

from __future__ import annotations

from typing import NamedTuple

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
